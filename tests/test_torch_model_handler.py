"""The export half of the model handler on the port
(``train/model_handler.py``), and DeepFM's export across the two
packages, on the CPU.

(a) ``pull_full_table`` and ``export_promoted_train_state`` against the
reference's over the same PS state (numpy against numpy, native against
native: one seed, the same pushes, the same pulls), bit for bit: the
materialized tables, the bundle's arrays and its manifest; (b) a DeepFM
export written by the port loads in the reference's ``load_exported``
array for array under the reference's flax names, and the reference's
export loads in the port's ``load_exported`` and into the port's DeepFM
(``params_from_flax``), whose ``params_to_flax`` gives the same arrays
back. Small sizes (4 fields, batch 32, vocab 1000); inputs made with
numpy from a seed.
"""

import json
import os
import types

import jax
import numpy as np
import pytest
import torch

from elasticdl_tpu.train import export as ref_export
from elasticdl_tpu.train import model_handler as ref_handler
from elasticdl_tpu_torch.models import deepfm
from elasticdl_tpu_torch.train import export, model_handler
from tests.test_torch_sparse import (
    make_batches,
    port_client,
    ref_client,
    trainer_pair,
)

torch.set_num_threads(1)

TABLES = {"deepfm_emb": (1000, 8), "deepfm_linear": (1000, 1)}


def _stores_with_state(store):
    """(reference client, port client) over stores of kind ``store``
    holding the same tables, after the same pushes."""
    clients = (ref_client(store=store, opt_type="sgd", lr=0.1),
               port_client(store=store, opt_type="sgd", lr=0.1))
    rng = np.random.RandomState(0)
    pushes = []
    for _ in range(3):
        for name, (_, dim) in TABLES.items():
            ids = np.unique(rng.randint(0, 1000, size=64)).astype(np.int64)
            pushes.append((name, ids, rng.randn(ids.size, dim).astype(
                np.float32)))
    for client in clients:
        client.push_embedding_table_infos(
            [("deepfm_emb", 8, "0.05"), ("deepfm_linear", 1, "zeros")])
        for name, ids, grads in pushes:
            client.pull_embedding_vectors(name, ids)
            client.push_gradients({name: (grads, ids)})
    return clients


@pytest.mark.parametrize("store", ["numpy", "native"])
def test_pull_full_table_matches_reference(store):
    ref, port = _stores_with_state(store)
    for name, (rows, dim) in TABLES.items():
        # a chunk size that leaves a ragged last chunk
        want = ref_handler.pull_full_table(ref, name, rows, dim,
                                           chunk_size=300)
        got = model_handler.pull_full_table(port, name, rows, dim,
                                            chunk_size=300)
        assert got.shape == (rows, dim) and got.dtype == np.float32
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("store", ["numpy", "native"])
def test_export_promoted_train_state_matches_reference(tmp_path, store):
    batch = make_batches(1, seed=2)[0]
    _, _, ref_state, port_state = trainer_pair(batch)
    ref, port = _stores_with_state(store)
    plan = types.SimpleNamespace(table_shapes=TABLES)
    ref_dir, port_dir = str(tmp_path / "ref"), str(tmp_path / "port")
    ref_handler.export_promoted_train_state(ref_state, plan, ref, ref_dir)
    assert model_handler.export_promoted_train_state(
        port_state, plan, port, port_dir) == port_dir
    for name in ("model.npz", "sparse_tables.npz"):
        with np.load(os.path.join(ref_dir, name)) as want, np.load(
                os.path.join(port_dir, name)) as got:
            assert sorted(got.files) == sorted(want.files)
            for key in want.files:
                np.testing.assert_array_equal(got[key], want[key],
                                              err_msg=key)
    for path in (ref_dir, port_dir):
        with open(os.path.join(path, "manifest.json")) as f:
            assert json.load(f)["step"] == 0
    tables = model_handler.load_exported_tables(port_dir)
    assert sorted(tables) == sorted(TABLES)
    want = ref_handler.load_exported_tables(ref_dir)
    for name in TABLES:
        np.testing.assert_array_equal(tables[name], want[name])
    assert model_handler.load_exported_tables(str(tmp_path)) == {}


def test_deepfm_export_loads_in_either_package(tmp_path):
    batch = make_batches(1, seed=4)[0]
    _, port_t, ref_state, _ = trainer_pair(batch)
    # a port state of its own (trained one step), exported by the port
    port_state = port_t.ensure_state(None, batch)
    port_state, _ = port_t.train_step(port_state, batch)
    port_dir = str(tmp_path / "port")
    export.export_train_state(port_state, port_dir)
    params, model_state, step = ref_export.load_exported(port_dir)
    assert model_state == {} and step == 1
    flat = ref_export._flatten(params)
    want = deepfm.params_to_flax(port_state.params)
    assert sorted(flat) == sorted(want) == [
        "Dense_%d/%s" % (i, leaf) for i in range(3)
        for leaf in ("bias", "kernel")]
    for name in want:
        assert flat[name].dtype == np.float32
        np.testing.assert_array_equal(flat[name], want[name])
    # the reference's export, read by the port into its DeepFM
    ref_dir = str(tmp_path / "ref")
    ref_export.export_train_state(ref_state, ref_dir)
    got, model_state, step = export.load_exported(ref_dir)
    assert model_state == {} and step == 0
    want = ref_export._flatten(jax.device_get(ref_state.params))
    assert sorted(got) == sorted(want)
    model = deepfm.custom_model()
    model.load_state_dict(deepfm.params_from_flax(got), strict=True)
    back = deepfm.params_to_flax(dict(model.named_parameters()))
    for name in want:
        np.testing.assert_array_equal(got[name], want[name])
        np.testing.assert_array_equal(back[name], np.asarray(want[name]))

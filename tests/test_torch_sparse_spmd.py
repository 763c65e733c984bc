"""Sparse x SPMD (elasticdl_tpu_torch/train/sparse_spmd.py): the dense
plane over a mesh of gloo ranks while the embedding rows ride the PS,
the scenarios of the reference's tests/test_sparse_spmd.py.

- one rank: ``SparseSpmdTrainer`` on a one-rank mesh is
  ``SparseTrainer``, bit for bit, with the device tier on;
- two ranks at dp=2 (tests/torch_ranks.py) against the reference's
  ``SparseSpmdTrainer`` on a 2-device CPU mesh over the same numpy
  batches, from the reference's initial weights, the first batch ragged
  (31 rows, padded to 32 on both sides): losses within 1e-5 relative,
  dense params within rtol 1e-5 / atol 1e-6, the PS tables (rank 0's
  store: the ranks share its pulls and pushes) within rtol 1e-5 / atol
  1e-7 (tests/test_torch_sparse.py's state tolerances; adam at eps 1e-3
  on the dense params and the PS, constant-initialised rows);
- the tier at ep > 1 raises naming the ROADMAP item; the mapping
  ``sparse_trainer_for``; a worker running a sparse model with a mesh
  through the whole job.
"""

import jax
import numpy as np
import pytest
import torch

from elasticdl_tpu.models import deepfm as ref_deepfm
from elasticdl_tpu.parallel.mesh import MeshConfig as RefMeshConfig
from elasticdl_tpu.parallel.mesh import build_mesh as ref_build_mesh
from elasticdl_tpu.ps import embedding_store as ref_store
from elasticdl_tpu.ps.local_client import LocalPSClient as RefLocalPSClient
from elasticdl_tpu.train import export as ref_export
from elasticdl_tpu.train import optimizers as ref_opt
from elasticdl_tpu.train import sparse_spmd as ref_sparse_spmd
from elasticdl_tpu_torch.models import deepfm
from elasticdl_tpu_torch.parallel.multihost_trainer import (
    MultiHostSpmdTrainer,
)
from elasticdl_tpu_torch.parallel.spmd_trainer import SpmdTrainer
from elasticdl_tpu_torch.train.sparse import SparseTrainer
from elasticdl_tpu_torch.train.sparse_spmd import (
    MultiHostSparseSpmdTrainer,
    SparseSpmdTrainer,
    sparse_trainer_for,
)
from elasticdl_tpu_torch.worker.trainer import TorchTrainer
from tests.torch_ranks import SPARSE_ADAM_EPS, constant_specs, run_ranks

torch.set_num_threads(1)

FIELDS = 4
BATCH = 32
STEPS = 5
LOSS_RTOL = 1e-5
PARAM_RTOL, PARAM_ATOL = 1e-5, 1e-6
STATE_RTOL, STATE_ATOL = 1e-5, 1e-7


def _batches(n, seed=0, batch=BATCH, vocab=1000):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        ids = (rng.zipf(1.6, size=(batch, FIELDS)) % vocab).astype(np.int64)
        out.append({"features": {"ids": ids},
                    "labels": (ids.sum(1) % 2).astype(np.float32),
                    "_mask": np.ones(batch, np.float32)})
    return out


def _ragged_first(batches, rows=BATCH - 1):
    first = batches[0]
    ragged = {"features": {"ids": first["features"]["ids"][:rows]},
              "labels": first["labels"][:rows],
              "_mask": np.ones(rows, np.float32)}
    return [ragged] + batches[1:]


def _ref_client():
    store = ref_store.NumpyEmbeddingStore(seed=0)
    store.set_optimizer("adam", lr=0.01, epsilon=SPARSE_ADAM_EPS)
    return RefLocalPSClient(store=store)


def _ref_trainer(cls, client, batch=BATCH, **kwargs):
    return cls(
        model=ref_deepfm.custom_model(), loss_fn=ref_deepfm.loss,
        optimizer=ref_opt.create_optimizer(
            "Adam", learning_rate=0.001, epsilon=SPARSE_ADAM_EPS),
        specs=constant_specs(ref_deepfm.sparse_embedding_specs(
            num_features=FIELDS, batch_size=batch)),
        ps_client=client, seed=0, device_tier=False, **kwargs)


def _ref_tables(client, tables=("deepfm_emb", "deepfm_linear")):
    out = {}
    for table in tables:
        ids, rows, steps = client.store.export_table_full(table)
        order = np.argsort(ids, kind="stable")
        out[table] = (ids[order], rows[order], steps[order])
    return out


@pytest.fixture(scope="module")
def reference():
    """The reference's SparseSpmdTrainer at dp=2 over the batches (the
    first ragged): its initial weights, losses, dense params and PS
    tables."""
    batches = _ragged_first(_batches(STEPS))
    client = _ref_client()
    trainer = _ref_trainer(
        ref_sparse_spmd.SparseSpmdTrainer, client,
        mesh=ref_build_mesh(RefMeshConfig(dp=2, devices=jax.devices()[:2])))
    state = trainer.ensure_state(None, batches[0])
    flat = ref_export._flatten(jax.device_get(state.params))
    losses = []
    for b in batches:
        state, loss = trainer.train_step(state, b)
        losses.append(float(loss))
    params = ref_export._flatten(jax.device_get(state.params))
    return {"flat": flat, "batches": batches, "losses": losses,
            "params": {k: v.numpy() for k, v in
                       deepfm.params_from_flax(params).items()},
            "tables": _ref_tables(client)}


@pytest.fixture(scope="module")
def dp2(reference, tmp_path_factory):
    return run_ranks(2, "sparse_spmd_scenario",
                     tmp_path_factory.mktemp("sparse_spmd"), timeout=180,
                     flat=reference["flat"], batches=reference["batches"],
                     fields=FIELDS, batch=BATCH)


def test_one_rank_is_sparse_trainer_bit_for_bit_with_the_tier(tmp_path):
    out, = run_ranks(1, "sparse_one_rank_scenario", tmp_path, timeout=120,
                     batches=_batches(12, seed=3), fields=FIELDS,
                     batch=BATCH,
                     tier_knobs=dict(capacity=256, promote_hits=2, ttl=100,
                                     stage_budget=64, opt_type="adam",
                                     opt_args={"lr": 0.01},
                                     writeback_steps=8))
    assert out["hits"] > 0, "the tier never served a hit"
    assert out["losses_equal"] and out["params_equal"]
    assert out["tier_equal"] and out["tables_equal"]
    assert np.isfinite(out["losses"]).all()


def test_dp2_matches_reference_sparse_spmd(reference, dp2):
    for out in dp2:
        np.testing.assert_allclose(out["losses"], reference["losses"],
                                   rtol=LOSS_RTOL)
        assert out["params"].keys() == reference["params"].keys()
        for name, value in reference["params"].items():
            np.testing.assert_allclose(out["params"][name], value,
                                       rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                       err_msg=name)
    # rank 0 alone talked to its PS; rank 1's store saw nothing
    assert dp2[1]["pulls"] == 0 and dp2[0]["pulls"] > 0
    for table, (ids, rows, steps) in reference["tables"].items():
        got_ids, got_rows, got_steps = dp2[0]["tables"][table]
        np.testing.assert_array_equal(got_ids, ids)
        np.testing.assert_array_equal(got_steps, steps)
        np.testing.assert_allclose(got_rows, rows, rtol=STATE_RTOL,
                                   atol=STATE_ATOL, err_msg=table)


def test_dp2_pads_the_ragged_batch(reference, dp2):
    """The 31-row first batch is padded to the data-axes multiple (32)
    with mask 0: its loss is the reference's, scored at the same fresh
    weights, and the ranks agree bit for bit."""
    assert dp2[0]["losses"][0] == dp2[1]["losses"][0]
    np.testing.assert_allclose(dp2[0]["losses"][0], reference["losses"][0],
                               rtol=LOSS_RTOL)


def test_device_tier_over_ep_raises(dp2):
    for out in dp2:
        assert "Queue 1 item 2" in out["ep_error"], out.get("ep_error")


def test_sparse_trainer_for_mapping():
    assert sparse_trainer_for(None) is SparseTrainer
    assert sparse_trainer_for(TorchTrainer) is SparseTrainer
    assert sparse_trainer_for(SpmdTrainer) is SparseSpmdTrainer
    assert (sparse_trainer_for(MultiHostSpmdTrainer)
            is MultiHostSparseSpmdTrainer)
    # already-sparse factories pass through
    assert sparse_trainer_for(SparseTrainer) is SparseTrainer
    assert sparse_trainer_for(SparseSpmdTrainer) is SparseSpmdTrainer

    def factory(model, loss_fn, optimizer, specs, ps_client, **kw):
        return None

    assert sparse_trainer_for(factory) is factory
    with pytest.raises(ValueError, match="sparse"):
        sparse_trainer_for(object())


def test_worker_runs_sparse_model_on_mesh(tmp_path):
    """The whole job (an in-process master, two in-process PS, the
    worker given ``--mesh dp=1``): the worker composes the mesh with the
    sparse path (not a silent single-card fallback), trains every task
    and evaluates over the reference's floor."""
    out, = run_ranks(1, "sparse_worker_mesh_scenario", tmp_path,
                     timeout=180, workdir=str(tmp_path))
    assert out["trainer"] == "SparseSpmdTrainer"
    assert out["mesh"] == {"dp": 1, "fsdp": 1, "pp": 1, "tp": 1, "sp": 1,
                           "ep": 1}
    assert out["finished"] and not out["failed"]
    assert out["auc"] > 0.75, out["auc"]


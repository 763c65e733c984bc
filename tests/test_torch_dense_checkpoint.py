"""The port's dense checkpoints (``train/checkpoint.py``) on the CPU,
mirroring the single-device cases of tests/test_dense_checkpoint.py:
the roundtrip keeps the optimizer slots, keep-max GC, async save; plus
the manager's edges (``create=False`` on a missing directory, nothing
saved, a crash mid-write), a resumed run bit-equal to an uninterrupted
one (DeepFM over the PS store, and the dense TransformerLM), and the
port's resumed DeepFM dense state against the reference's resumed state
after the same batches.

Inputs are made with numpy from a seed; the reference's DeepFM params
are carried across with ``params_from_flax``. Tolerances: the port
against itself is bit for bit; the port against the reference uses
tests/test_torch_sparse.py's multi-step state tolerance (adam eps 1e-3,
1e-5 relative and 1e-7 absolute), since the two sum fp32 in other
orders.
"""

import os

import jax
import numpy as np
import pytest
import torch

from elasticdl_tpu.models import deepfm as ref_deepfm
from elasticdl_tpu.train import checkpoint as ref_checkpoint
from elasticdl_tpu.train import export as ref_export
from elasticdl_tpu.train import optimizers as ref_opt
from elasticdl_tpu.train import sparse as ref_sparse
from elasticdl_tpu_torch.models import deepfm, transformer
from elasticdl_tpu_torch.train import optimizers as port_opt
from elasticdl_tpu_torch.train import sparse
from elasticdl_tpu_torch.train.checkpoint import (
    STATE_FILE,
    DenseCheckpointManager,
)
from elasticdl_tpu_torch.worker.trainer import TorchTrainer
from tests.test_torch_sparse import (
    ADAM_EPS,
    BATCH,
    FIELDS,
    STATE_ATOL,
    STATE_RTOL,
    assert_stores_equal,
    make_batches,
    port_client,
    ref_client,
)

torch.set_num_threads(1)

TABLES = ("deepfm_emb", "deepfm_linear")
STEPS = 8
RESUME_AT = 4


def port_trainer(client, seed=0, model=None, eps=ADAM_EPS):
    return sparse.SparseTrainer(
        model=model or deepfm.custom_model(),
        loss_fn=deepfm.loss,
        optimizer=port_opt.create_optimizer(
            "Adam", learning_rate=0.001, epsilon=eps),
        specs=deepfm.sparse_embedding_specs(num_features=FIELDS,
                                            batch_size=BATCH),
        ps_client=client, seed=seed, device_tier=False, health=False,
        device="cpu")


def trained_state(steps=3):
    batches = make_batches(steps, seed=3)
    trainer = port_trainer(port_client(lr=0.01, epsilon=ADAM_EPS))
    state = None
    for batch in batches:
        state = trainer.ensure_state(state, batch)
        state, _ = trainer.train_step(state, batch)
    return trainer, state, batches


def assert_states_equal(a, b):
    assert int(a.step) == int(b.step)
    for tree_a, tree_b in ((a.params, b.params), (a.model_state,
                                                  b.model_state)):
        assert sorted(tree_a) == sorted(tree_b)
        for name in tree_a:
            torch.testing.assert_close(tree_a[name], tree_b[name],
                                       rtol=0, atol=0)
    assert sorted(a.opt_state) == sorted(b.opt_state)
    for slot, value in a.opt_state.items():
        if isinstance(value, dict):
            for name in value:
                torch.testing.assert_close(value[name],
                                           b.opt_state[slot][name],
                                           rtol=0, atol=0)
        else:
            torch.testing.assert_close(value, b.opt_state[slot], rtol=0,
                                       atol=0)


def test_roundtrip_includes_optimizer_state(tmp_path):
    trainer, state, batches = trained_state()
    mgr = DenseCheckpointManager(str(tmp_path / "ckpt"), keep_max=3)
    mgr.save(3, state)
    fresh = port_trainer(port_client(lr=0.01, epsilon=ADAM_EPS), seed=7)
    template = fresh.ensure_state(None, batches[0])
    restored = mgr.restore(template=template)
    mgr.close()
    assert int(restored.step) == 3
    # adam's slots (mu, nu, count) survive with the params
    assert set(restored.opt_state) == {"count", "mu", "nu"}
    assert_states_equal(restored, state)
    # loaded in place: the fresh module holds the restored weights
    for name, p in fresh.model.named_parameters():
        assert p.data_ptr() == restored.params[name].data_ptr()


def test_file_holds_flax_names_slots_and_step_no_pickle(tmp_path):
    _, state, _ = trained_state()
    mgr = DenseCheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(3, state)
    with np.load(str(tmp_path / "ckpt" / "3" / STATE_FILE),
                 allow_pickle=False) as data:
        names = set(data.files)
        kernel = data["params/Dense_0/kernel"]
        mu = data["opt/mu/Dense_0/kernel"]
        step = int(data["step"])
    assert step == 3
    assert "opt/count" in names and "opt/nu/Dense_2/bias" in names
    assert {n for n in names if n.startswith("params/")} == {
        "params/Dense_%d/%s" % (i, leaf) for i in range(3)
        for leaf in ("kernel", "bias")}
    # flax layout: kernels [in, out], the slots in the params' layout
    np.testing.assert_array_equal(
        kernel, state.params["dense.0.weight"].numpy().T)
    np.testing.assert_array_equal(
        mu, state.opt_state["mu"]["dense.0.weight"].numpy().T)


def test_keep_max_gc(tmp_path):
    _, state, _ = trained_state(steps=1)
    mgr = DenseCheckpointManager(str(tmp_path / "ckpt"), keep_max=2)
    for v in (1, 2, 3, 4, 5):
        mgr.save(v, state)
    assert mgr.latest_version() == 5
    kept = sorted(int(d.name) for d in (tmp_path / "ckpt").iterdir())
    mgr.close()
    assert kept == [4, 5]


def test_async_save_commits_and_restores(tmp_path):
    """async_save: the save copies the state to the host and returns;
    the next save (or wait) joins the write; latest_version reports
    committed versions only; a later step does not leak into the
    snapshot; the restore round-trips exactly."""
    trainer, state, batches = trained_state()
    mgr = DenseCheckpointManager(str(tmp_path / "ckpt"), async_save=True)
    try:
        mgr.save(1, state)
        snapshot = {k: v.clone() for k, v in state.params.items()}
        mgr.save(2, state)  # joins save 1
        # training on in place right after the save returned
        state, _ = trainer.train_step(state, batches[0])
        mgr.wait_until_finished()
        assert mgr.latest_version() == 2
        template = port_trainer(port_client()).ensure_state(None,
                                                            batches[0])
        restored = mgr.restore(template=template)
        for name, value in snapshot.items():
            torch.testing.assert_close(restored.params[name], value,
                                       rtol=0, atol=0)
        assert int(restored.step) == 3
    finally:
        mgr.close()


def test_missing_empty_and_torn_directories(tmp_path):
    with pytest.raises(FileNotFoundError):
        DenseCheckpointManager(str(tmp_path / "typo"), create=False)
    assert not (tmp_path / "typo").exists()
    mgr = DenseCheckpointManager(str(tmp_path / "ckpt"))
    _, state, _ = trained_state(steps=1)
    assert mgr.latest_version() is None
    assert mgr.restore(template=state) is None
    # a crash mid-write leaves a temporary directory, never a version
    os.makedirs(str(tmp_path / "ckpt" / ".tmp-9-1-1"))
    (tmp_path / "ckpt" / ".tmp-9-1-1" / STATE_FILE).write_bytes(b"PK")
    os.makedirs(str(tmp_path / "ckpt" / "8"))  # no state file: not saved
    assert mgr.latest_version() is None
    mgr.save(1, state)
    assert mgr.latest_version() == 1
    # a version saved again is kept as it was
    mtime = os.stat(str(tmp_path / "ckpt" / "1" / STATE_FILE)).st_mtime_ns
    mgr.save(1, state)
    assert os.stat(str(tmp_path / "ckpt" / "1" / STATE_FILE)
                   ).st_mtime_ns == mtime


def test_restore_refuses_another_model(tmp_path):
    _, state, batches = trained_state(steps=1)
    mgr = DenseCheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(1, state)
    wide = port_trainer(port_client(),
                        model=deepfm.DeepFM(hidden=(64, 16)))
    with pytest.raises(ValueError, match="shape"):
        mgr.restore(template=wide.ensure_state(None, batches[0]))


def _dense_batches(n, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        tokens = rng.randint(0, 64, size=(2, 16)).astype(np.int32)
        out.append({"features": tokens, "labels": tokens,
                    "_mask": np.ones(2, np.float32)})
    return out


def _run(model_kind, tmp_path, interrupt):
    """STEPS steps of one model, uninterrupted or saved at RESUME_AT and
    resumed by a fresh trainer (other initial weights) that restores the
    checkpoint; returns (final state, PS store or None)."""
    if model_kind == "deepfm":
        batches = make_batches(STEPS, seed=11)
        client = port_client(lr=0.01, epsilon=ADAM_EPS)

        def make(seed):
            return port_trainer(client, seed=seed)
    else:
        batches = _dense_batches(STEPS, seed=11)
        client = None

        def make(seed):
            torch.manual_seed(seed)
            model = transformer.TransformerLM(
                vocab_size=64, num_layers=2, num_heads=2, embed_dim=32)
            return TorchTrainer(model, transformer.loss,
                                port_opt.create_optimizer(
                                    "AdamW", learning_rate=1e-3),
                                health=False, device="cpu")
    trainer, state = make(0), None
    mgr = DenseCheckpointManager(str(tmp_path / model_kind / "ckpt"))
    for i, batch in enumerate(batches):
        if interrupt and i == RESUME_AT:
            mgr.save(i, state)
            trainer = make(5)
            state = mgr.restore(template=trainer.ensure_state(None, batch))
        state = trainer.ensure_state(state, batch)
        state, _ = trainer.train_step(state, batch)
    mgr.close()
    return state, client.store if client is not None else None


@pytest.mark.parametrize("model_kind", ["deepfm", "transformer"])
def test_resumed_run_bit_equal_to_uninterrupted(tmp_path, model_kind):
    whole, whole_store = _run(model_kind, tmp_path / "a", interrupt=False)
    resumed, resumed_store = _run(model_kind, tmp_path / "b",
                                  interrupt=True)
    assert int(resumed.step) == STEPS
    assert_states_equal(resumed, whole)
    if whole_store is not None:
        assert_stores_equal(whole_store, resumed_store, TABLES)


def test_resumed_deepfm_dense_state_matches_reference(tmp_path):
    """The same 8 batches through each package's SparseTrainer, saved at
    step 4 by its own DenseCheckpointManager (orbax on the reference,
    the port's npz) and resumed by a fresh trainer over the same PS
    store: the final dense params and adam slots agree."""
    batches = make_batches(STEPS, seed=5)
    dense_args = {"learning_rate": 0.001, "epsilon": ADAM_EPS}
    specs = dict(num_features=FIELDS, batch_size=BATCH)

    def ref_trainer(client, seed):
        return ref_sparse.SparseTrainer(
            model=ref_deepfm.custom_model(), loss_fn=ref_deepfm.loss,
            optimizer=ref_opt.create_optimizer("Adam", **dense_args),
            specs=ref_deepfm.sparse_embedding_specs(**specs),
            ps_client=client, seed=seed, device_tier=False, health=False)

    r_client = ref_client(lr=0.01, epsilon=ADAM_EPS)
    p_client = port_client(lr=0.01, epsilon=ADAM_EPS)
    r_trainer = ref_trainer(r_client, 0)
    r_state = r_trainer.ensure_state(None, batches[0])
    model = deepfm.custom_model()
    model.load_state_dict(deepfm.params_from_flax(
        ref_export._flatten(jax.device_get(r_state.params))))
    p_trainer, p_state = port_trainer(p_client, model=model), None
    r_mgr = ref_checkpoint.DenseCheckpointManager(str(tmp_path / "ref"))
    p_mgr = DenseCheckpointManager(str(tmp_path / "port"))
    for i, batch in enumerate(batches):
        if i == RESUME_AT:
            r_mgr.save(i, r_state)
            r_trainer = ref_trainer(r_client, 9)
            r_state = r_mgr.restore(
                template=r_trainer.ensure_state(None, batch))
            p_mgr.save(i, p_state)
            p_trainer = port_trainer(p_client, seed=9)
            p_state = p_mgr.restore(
                template=p_trainer.ensure_state(None, batch))
        r_state, _ = r_trainer.train_step(r_state, batch)
        p_state = p_trainer.ensure_state(p_state, batch)
        p_state, _ = p_trainer.train_step(p_state, batch)
    r_mgr.close()
    p_mgr.close()
    assert int(r_state.step) == int(p_state.step) == STEPS
    want = ref_export._flatten(jax.device_get(r_state.params))
    got = deepfm.params_to_flax(p_state.params)
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=STATE_RTOL,
                                   atol=STATE_ATOL, err_msg=name)
    r_opt = jax.device_get(r_state.opt_state)
    r_adam = r_opt[0] if isinstance(r_opt, tuple) else r_opt
    assert int(np.asarray(r_adam.count)) == int(p_state.opt_state["count"])
    for slot in ("mu", "nu"):
        want = ref_export._flatten(getattr(r_adam, slot))
        got = deepfm.params_to_flax(p_state.opt_state[slot])
        for name in want:
            np.testing.assert_allclose(got[name], want[name],
                                       rtol=STATE_RTOL, atol=STATE_ATOL,
                                       err_msg="%s %s" % (slot, name))
    assert_stores_equal(r_client.store, p_client.store, TABLES,
                        exact=False)

"""tests/test_serving.py's scenarios that the port's serving tests did
not mirror yet, on the port's engine, on the CPU.

- ``test_export_serve_parity_iris_dnn``: iris trained over CSV by the
  port's ``LocalExecutor``, exported, and served over real gRPC as a
  bare array; the answers bit-equal to the trainer's ``eval_step``;
- ``test_partial_batch_is_padded_not_recompiled``: a request smaller
  than ``max_batch`` is answered at its own rows;
- the two deadline budgets: an in-message ``deadline_ms`` inside the
  formation window sheds server-side under a loose RPC timeout, and the
  server's ``deadline_ms`` caps a loose RPC timeout when the message
  sets none;
- ``test_ps_restart_invalidation_survives_discarded_rebuild``: a
  rebuild whose stamp matches is discarded, and a PS relaunch still
  drops the shared serving cache (read-only preparers never take the
  PS client's hook slot).

The DeepFM run is tests/test_torch_serving_sparse.py's (6 steps over
the numpy store).
"""

import grpc
import numpy as np
import pytest
import torch

from elasticdl_tpu_torch.data.pipeline import MASK_KEY
from elasticdl_tpu_torch.serve.engine import ServingEngine
from elasticdl_tpu_torch.train.export import export_train_state
from elasticdl_tpu_torch.train.local_executor import LocalExecutor
from tests.test_torch_serving_sparse import (  # noqa: F401 (fixture)
    BATCH,
    FIELDS,
    VOCAB,
    _serve,
    deepfm_run,
)

torch.set_num_threads(1)

ZOO = "elasticdl_tpu_torch.models.deepfm"


def _deepfm_engine(deepfm_run, **kw):
    _, _, client, export_dir, _ = deepfm_run
    kw.setdefault("max_batch", BATCH)
    kw.setdefault("max_delay_ms", 2.0)
    kw.setdefault("deadline_ms", 5000.0)
    return ServingEngine(ZOO, export_dir, ps_client=client, device="cpu",
                         **kw).start(block=True)


def test_export_serve_parity_iris_dnn(tmp_path):
    rng = np.random.RandomState(0)
    lines = ["f0,f1,f2,f3,label"]  # the CSV reader reads a header row
    for _ in range(96):
        x = rng.rand(4) * 2
        label = int(x.sum() > 4)
        lines.append(",".join("%.6f" % v for v in x) + ",%d" % label)
    (tmp_path / "iris.csv").write_text("\n".join(lines) + "\n")
    executor = LocalExecutor(
        "elasticdl_tpu_torch.models.iris_dnn", training_data=str(tmp_path),
        minibatch_size=32, num_epochs=1, device="cpu",
    )
    assert len(executor.train()) == 3
    export_dir = str(tmp_path / "export")
    export_train_state(executor.state, export_dir)
    engine = ServingEngine(
        "elasticdl_tpu_torch.models.iris_dnn", export_dir,
        max_batch=32, max_delay_ms=2.0, deadline_ms=5000.0, device="cpu",
    ).start(block=True)
    server, client = _serve(engine)
    try:
        x = rng.rand(32, 4).astype(np.float32)
        outputs, step, _ = client.predict(x)  # single-input: bare array
        assert step == int(executor.state.step) == 3
        batch = {"features": x, MASK_KEY: np.ones(32, np.float32)}
        want = np.asarray(executor.trainer.eval_step(executor.state, batch))
        np.testing.assert_array_equal(outputs["output"].numpy(), want)
        assert outputs["output"].shape == (32, 3)
    finally:
        server.stop(0)
        client.close()
        engine.drain(timeout=5)


def test_partial_batch_is_padded_not_recompiled(deepfm_run):
    """A request smaller than max_batch rides the one padded shape; its
    outputs come back at its own rows, equal to the full batch's."""
    engine = _deepfm_engine(deepfm_run)
    try:
        ids = np.random.RandomState(1).randint(
            0, VOCAB, size=(3, FIELDS)).astype(np.int64)
        outputs, _, _ = engine.predict({"ids": ids}, 3)
        assert outputs["output"].shape == (3,)
        full = np.concatenate([ids, np.zeros((BATCH - 3, FIELDS), np.int64)])
        padded, _, _ = engine.predict({"ids": full}, BATCH)
        torch.testing.assert_close(outputs["output"], padded["output"][:3],
                                   rtol=0, atol=0)
    finally:
        engine.drain(timeout=5)


def test_in_message_deadline_honored_under_loose_rpc_timeout(deepfm_run):
    """deadline_ms sheds even when the transport carries a loose default
    RPC deadline: the tighter of the two budgets governs."""
    engine = _deepfm_engine(deepfm_run, max_delay_ms=200.0)
    server, client = _serve(engine)
    try:
        ids = np.random.RandomState(3).randint(
            0, VOCAB, size=(2, FIELDS)).astype(np.int64)
        # the client's 60 s default gRPC timeout; the 20 ms in-message
        # budget is inside the 200 ms formation window, so the request
        # is shed server-side, not served late
        with pytest.raises(grpc.RpcError) as err:
            client.predict({"ids": ids}, deadline_ms=20)
        assert err.value.code() == grpc.StatusCode.DEADLINE_EXCEEDED
        assert engine.batcher.shed_total == 1
    finally:
        server.stop(0)
        client.close()
        engine.drain(timeout=5)


def test_server_default_budget_caps_loose_rpc_timeout(deepfm_run):
    """With no in-message deadline_ms, the server's deadline_ms caps
    the queueing budget: a loose transport timeout is not a request to
    queue that long."""
    engine = _deepfm_engine(deepfm_run, max_delay_ms=200.0,
                            deadline_ms=20.0)
    server, client = _serve(engine)
    try:
        ids = np.random.RandomState(5).randint(
            0, VOCAB, size=(2, FIELDS)).astype(np.int64)
        with pytest.raises(grpc.RpcError) as err:
            client.predict({"ids": ids}, deadline_secs=10)
        assert err.value.code() == grpc.StatusCode.DEADLINE_EXCEEDED
        assert engine.batcher.shed_total == 1
    finally:
        server.stop(0)
        client.close()
        engine.drain(timeout=5)


def test_ps_restart_invalidation_survives_discarded_rebuild(deepfm_run):
    """The PS client's hook slot has one owner: a read-only (serving)
    preparer never takes it, so a rebuild the stamp check discards
    leaves the engine's cache-drop chain in place, and a PS relaunch
    still clears the serving cache."""
    ps = deepfm_run[2]
    had_hook = hasattr(ps, "resync_hook")
    if not had_hook:
        ps.resync_hook = None  # LocalPSClient: give it the gRPC client's
        # hook surface so the chain engages
    engine = _deepfm_engine(deepfm_run)
    try:
        assert engine._load_and_swap() is False  # same stamp: discarded
        engine.cache.put("deepfm_emb", np.array([7], np.int64),
                         np.ones((1, 8), np.float32))
        assert engine.cache._tables
        ps.resync_hook(0)  # a PS relaunch seen on any thread
        assert engine.cache._tables == {}, (
            "shared serving cache not dropped on PS restart")
        assert engine.cache_drops == 1
    finally:
        engine.drain(timeout=5)
        if not had_hook:
            del ps.resync_hook

"""N workers train one model in lockstep (elasticdl_tpu_torch/parallel/
multihost_trainer.py, train/sparse_spmd.py, the worker's lockstep
loop), over gloo ranks on the CPU (tests/torch_ranks.py).

- ``MultiHostSparseSpmdTrainer`` at dp=2, each rank its own batches and
  its own client of one sync PS (two shards, grads_to_wait 2), against
  the reference's ``SparseSpmdTrainer`` on the global batch B0 || B1:
  the same function (the global masked mean; the two pushes sum to the
  global batch's row gradients). Losses within 1e-5 relative, dense
  params within rtol 1e-5 / atol 1e-6, the PS rows within rtol 1e-5 /
  atol 1e-7 (adam at eps 1e-3, constant-initialised rows); the dense
  params bit-identical on the two ranks; no push rejected.
- ``MultiHostSpmdTrainer`` on mnist at dp=2 against the reference's
  one-device ``JaxTrainer`` on the global batch (dropout at rate 0;
  tests/test_torch_spmd_trainer.py's tolerances).
- A checkpoint saved by 2 ranks at fsdp=2 restored at world 1 and at
  dp=2: the whole params and slots bit-equal to the saved ones.
- ``pad_batch`` / ``zero_batch_like`` against the reference's;
  ``_BatchPoller``; the lockstep loop's consensus exit with one rank's
  stream dried up first; the class options on the pushes.
"""

import threading
import time

import jax
import numpy as np
import pytest
import torch

import flax.linen as nn

from elasticdl_tpu.data import pipeline as ref_pipeline
from elasticdl_tpu.models import deepfm as ref_deepfm
from elasticdl_tpu.models import mnist as ref_mnist
from elasticdl_tpu.parallel.mesh import MeshConfig as RefMeshConfig
from elasticdl_tpu.parallel.mesh import build_mesh as ref_build_mesh
from elasticdl_tpu.ps import embedding_store as ref_store
from elasticdl_tpu.ps.local_client import LocalPSClient as RefLocalPSClient
from elasticdl_tpu.train import export as ref_export
from elasticdl_tpu.train import optimizers as ref_opt
from elasticdl_tpu.train import sparse as ref_sparse
from elasticdl_tpu.train import sparse_spmd as ref_sparse_spmd
from elasticdl_tpu.worker.trainer import JaxTrainer
from elasticdl_tpu_torch.common.grpc_utils import build_server, find_free_port
from elasticdl_tpu_torch.data import pipeline
from elasticdl_tpu_torch.models import deepfm, mnist
from elasticdl_tpu_torch.proto.services import add_pserver_servicer_to_server
from elasticdl_tpu_torch.ps.embedding_store import NumpyEmbeddingStore
from elasticdl_tpu_torch.ps.servicer import PserverServicer
from elasticdl_tpu_torch.train import sparse
from elasticdl_tpu_torch.train.sparse_spmd import MultiHostSparseSpmdTrainer
from elasticdl_tpu_torch.worker.ps_client import PSClient
from elasticdl_tpu_torch.worker.worker import _BatchPoller
from tests.torch_ranks import SPARSE_ADAM_EPS, constant_specs, run_ranks

torch.set_num_threads(1)

FIELDS = 4
BATCH = 32
ROUNDS = 4
LOSS_RTOL = 1e-5
PARAM_RTOL, PARAM_ATOL = 1e-5, 1e-6
STATE_RTOL, STATE_ATOL = 1e-5, 1e-7
TABLES = ("deepfm_emb", "deepfm_linear")


def _ctr(rng, batch=BATCH, vocab=1000, offset=0):
    ids = (rng.zipf(1.6, size=(batch, FIELDS)) % vocab
           + offset).astype(np.int64)
    return {"features": {"ids": ids},
            "labels": (ids.sum(1) % 2).astype(np.float32),
            "_mask": np.ones(batch, np.float32)}


def _concat(a, b):
    return {"features": {"ids": np.concatenate([a["features"]["ids"],
                                                b["features"]["ids"]])},
            "labels": np.concatenate([a["labels"], b["labels"]]),
            "_mask": np.concatenate([a["_mask"], b["_mask"]])}


def _sorted_tables(stores):
    """Each table's (ids, rows and slots, steps) over ``stores`` (the PS
    shards), sorted by id."""
    out = {}
    for table in TABLES:
        parts = [s.export_table_full(table) for s in stores]
        ids = np.concatenate([p[0] for p in parts])
        rows = np.concatenate([p[1] for p in parts])
        steps = np.concatenate([p[2] for p in parts])
        order = np.argsort(ids, kind="stable")
        out[table] = (ids[order], rows[order], steps[order])
    return out


ADAM_PS = ("adam", {"lr": 0.01, "epsilon": SPARSE_ADAM_EPS})


def _sync_ps(shards, grads_to_wait, opt=ADAM_PS):
    """In-process sync PS shards over numpy stores: (servers, addrs,
    stores, servicers)."""
    servers, addrs, stores, servicers = [], [], [], []
    for ps_id in range(shards):
        store = NumpyEmbeddingStore(seed=ps_id)
        store.set_optimizer(opt[0], **opt[1])
        servicer = PserverServicer(store, ps_id=ps_id, use_async=False,
                                   grads_to_wait=grads_to_wait)
        server = build_server()
        add_pserver_servicer_to_server(servicer, server)
        port = find_free_port()
        server.add_insecure_port("localhost:%d" % port)
        server.start()
        servers.append(server)
        addrs.append("localhost:%d" % port)
        stores.append(store)
        servicers.append(servicer)
    return servers, addrs, stores, servicers


# ---------------------------------------------------------------------
# the sparse lockstep trainer against the reference on the global batch


@pytest.fixture(scope="module")
def sparse_run(tmp_path_factory):
    """Round r's ids lie in [1000 r, 1000 (r + 1)] on both ranks: a
    worker's pull of round r + 1 may run before its peer's round-r push
    reached the sync PS (the lockstep loop pulls before the round's
    collectives), which reads an id of round r one update stale; over
    disjoint rounds every pull reads what the reference's does."""
    rng = np.random.RandomState(7)
    local = [[_ctr(rng, offset=1000 * r) for r in range(ROUNDS)]
             for _ in range(2)]
    store = ref_store.NumpyEmbeddingStore(seed=0)
    store.set_optimizer("adam", lr=0.01, epsilon=SPARSE_ADAM_EPS)
    client = RefLocalPSClient(store=store)
    ref = ref_sparse_spmd.SparseSpmdTrainer(
        model=ref_deepfm.custom_model(), loss_fn=ref_deepfm.loss,
        optimizer=ref_opt.create_optimizer(
            "Adam", learning_rate=0.001, epsilon=SPARSE_ADAM_EPS),
        specs=constant_specs(ref_deepfm.sparse_embedding_specs(
            num_features=FIELDS, batch_size=2 * BATCH)),
        ps_client=client, seed=0, device_tier=False,
        mesh=ref_build_mesh(RefMeshConfig(dp=2, devices=jax.devices()[:2])))
    glob = [_concat(a, b) for a, b in zip(*local)]
    state = ref.ensure_state(None, glob[0])
    flat = ref_export._flatten(jax.device_get(state.params))
    losses = []
    for b in glob:
        state, loss = ref.train_step(state, b)
        losses.append(float(loss))
    reference = {
        "losses": losses,
        "params": {k: v.numpy() for k, v in deepfm.params_from_flax(
            ref_export._flatten(jax.device_get(state.params))).items()},
        "tables": _sorted_tables([store])}
    servers, addrs, stores, servicers = _sync_ps(2, grads_to_wait=2)
    try:
        ranks = run_ranks(2, "lockstep_sparse_scenario",
                          tmp_path_factory.mktemp("lockstep_sparse"),
                          timeout=180, flat=flat, local_batches=local,
                          ps_addrs=addrs, fields=FIELDS, batch=BATCH)
    finally:
        for server in servers:
            server.stop(0)
    return reference, ranks, _sorted_tables(stores), stores


def test_lockstep_sparse_matches_reference_on_the_global_batch(sparse_run):
    reference, ranks, tables, stores = sparse_run
    for out in ranks:
        np.testing.assert_allclose(out["losses"], reference["losses"],
                                   rtol=LOSS_RTOL)
        for name, value in reference["params"].items():
            np.testing.assert_allclose(out["params"][name], value,
                                       rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                       err_msg=name)
        assert out["rejections"] == 0
        assert out["step"] == ROUNDS and out["version"] >= ROUNDS - 1
        assert out["stats"]["allreduce_calls"] == ROUNDS
    # each sync shard applied once a round
    assert all(s.version == ROUNDS for s in stores)
    for table, (ids, rows, steps) in reference["tables"].items():
        got_ids, got_rows, got_steps = tables[table]
        np.testing.assert_array_equal(got_ids, ids)
        np.testing.assert_array_equal(got_steps, steps)
        np.testing.assert_allclose(got_rows, rows, rtol=STATE_RTOL,
                                   atol=STATE_ATOL, err_msg=table)


def test_lockstep_dense_params_bit_identical_across_ranks(sparse_run):
    _, (a, b), _, _ = sparse_run
    assert a["losses"] == b["losses"]
    assert a["params"].keys() == b["params"].keys()
    for name in a["params"]:
        np.testing.assert_array_equal(a["params"][name], b["params"][name],
                                      err_msg=name)


def test_lockstep_class_options_match_reference():
    for option in ("FORCE_EMPTY_PUSH", "ROUND_SCOPED_PUSH",
                   "RETRY_RECOMPUTES", "SUPPORTS_DEVICE_TIER",
                   "MAX_PUSH_RETRIES"):
        assert (getattr(MultiHostSparseSpmdTrainer, option)
                == getattr(ref_sparse_spmd.MultiHostSparseSpmdTrainer,
                           option)), option
        assert (getattr(sparse.SparseTrainer, option)
                == getattr(ref_sparse.SparseTrainer, option)), option


# ---------------------------------------------------------------------
# the dense lockstep trainer


class _NoDropout:
    """flax.linen, but its Dropout at rate 0 (the identity)."""

    def __getattr__(self, name):
        return getattr(nn, name)

    @staticmethod
    def Dropout(rate, **kwargs):
        return nn.Dropout(0.0, **kwargs)


def _mnist_batch(seed=0, batch=32):
    rng = np.random.RandomState(seed)
    return {"features": rng.rand(batch, 28, 28).astype(np.float32),
            "labels": rng.randint(0, 10, size=batch).astype(np.int32),
            "_mask": np.ones(batch, np.float32)}


def _halves(batch):
    n = batch["_mask"].shape[0] // 2
    return [{k: v[:n] for k, v in batch.items()},
            {k: v[n:] for k, v in batch.items()}]


@pytest.fixture(scope="module")
def mnist_flat():
    trainer = JaxTrainer(model=ref_mnist.custom_model(),
                         loss_fn=ref_mnist.loss,
                         optimizer=ref_mnist.optimizer(), seed=0,
                         health=False)
    state = trainer.create_state(_mnist_batch()["features"])
    return ref_export._flatten({"params": jax.device_get(state.params)})


def test_multihost_spmd_trainer_mnist_dp2_matches_reference(mnist_flat,
                                                            tmp_path):
    batches = [_mnist_batch(seed) for seed in range(3)]
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(ref_mnist, "nn", _NoDropout())
        trainer = JaxTrainer(model=ref_mnist.custom_model(),
                             loss_fn=ref_mnist.loss,
                             optimizer=ref_mnist.optimizer(), seed=0,
                             health=False)
        state, losses = None, []
        for b in batches:
            state, loss = trainer.train_step(state, b)
            losses.append(float(loss))
    params = {k: v.numpy() for k, v in mnist.params_from_flax(
        ref_export._flatten({"params": jax.device_get(state.params)})
    ).items()}
    local = [[_halves(b)[r] for b in batches] for r in (0, 1)]
    ranks = run_ranks(2, "lockstep_dense_scenario", tmp_path, timeout=180,
                      flat=mnist_flat, local_batches=local)
    for out in ranks:
        np.testing.assert_allclose(out["losses"], losses, atol=1e-4, rtol=0)
        for name, value in params.items():
            np.testing.assert_allclose(out["params"][name], value,
                                       rtol=2e-3, atol=2e-4, err_msg=name)
        # evaluation is per worker: its own batch, no collective
        assert out["eval"].shape == (16, 10)
    for name in params:
        np.testing.assert_array_equal(ranks[0]["params"][name],
                                      ranks[1]["params"][name])


def test_checkpoint_of_fsdp2_restores_at_world1_and_dp2(mnist_flat,
                                                        tmp_path):
    ckpt = str(tmp_path / "ckpt")
    batch = _mnist_batch(5, batch=16)
    saved = run_ranks(2, "lockstep_checkpoint_scenario", tmp_path / "save",
                      timeout=180, flat=mnist_flat, batch=batch,
                      ckpt_dir=ckpt, mode="save", mesh_spec="fsdp=2")
    # the fsdp blocks were halves; the saved state is whole and equal
    # on both ranks
    whole = saved[0]
    assert any(saved[0]["blocks"][k] != whole["params"][k].shape
               for k in whole["params"])
    for name, value in whole["params"].items():
        np.testing.assert_array_equal(saved[1]["params"][name], value)
    for world, spec in ((1, "dp=1"), (2, "dp=2")):
        restored = run_ranks(world, "lockstep_checkpoint_scenario",
                             tmp_path / ("restore%d" % world), timeout=180,
                             flat=mnist_flat, batch=batch, ckpt_dir=ckpt,
                             mode="restore", mesh_spec=spec)
        for out in restored:
            assert out["step"] == whole["step"] == 2
            for key in ("params", "mu"):
                assert out[key].keys() == whole[key].keys()
                for name, value in whole[key].items():
                    np.testing.assert_array_equal(out[key][name], value,
                                                  err_msg=name)
            assert out["blocks"] == {k: v.shape
                                     for k, v in whole["params"].items()}
            assert np.isfinite(out["loss_after"])


# ---------------------------------------------------------------------
# the lockstep loop's parts


def test_pad_batch_and_zero_batch_like_match_reference():
    rng = np.random.RandomState(3)
    batch = {"features": {"ids": rng.randint(0, 9, (5, 3)).astype(np.int64),
                          "x": rng.rand(5, 2).astype(np.float32)},
             "labels": rng.rand(5).astype(np.float32),
             "_mask": np.ones(5, np.float32)}
    for fn in ("pad_batch", "zero_batch_like"):
        args = (8,) if fn == "pad_batch" else ()
        got = getattr(pipeline, fn)(batch, *args)
        want = getattr(ref_pipeline, fn)(batch, *args)
        assert got.keys() == want.keys()
        for key in ("labels", "_mask"):
            np.testing.assert_array_equal(got[key], np.asarray(want[key]))
            assert got[key].dtype == np.asarray(want[key]).dtype
        for key in want["features"]:
            np.testing.assert_array_equal(
                got["features"][key], np.asarray(want["features"][key]))
    assert pipeline.pad_batch(batch, 5) is batch
    with pytest.raises(ValueError, match="exceeds pad size"):
        pipeline.pad_batch(batch, 4)


def test_batch_poller_never_blocks_and_surfaces_errors():
    gate = threading.Event()

    def slow():
        yield 1
        gate.wait(10)  # the master answered WAIT
        yield 2

    poller = _BatchPoller(slow())
    assert poller.poll(1.0) == (1, False)
    t0 = time.monotonic()
    assert poller.poll(0.05) == (None, False)  # nothing this round
    assert time.monotonic() - t0 < 2.0
    gate.set()
    assert poller.poll(5.0) == (2, False)
    assert poller.poll(5.0) == (None, True)
    assert poller.poll(0.01) == (None, True)

    def broken():
        yield 1
        raise OSError("reader failed")

    poller = _BatchPoller(broken())
    assert poller.poll(1.0) == (1, False)
    with pytest.raises(OSError, match="reader failed"):
        poller.poll(5.0)
    assert poller.poll(0.01) == (None, True)


@pytest.mark.parametrize("interval", [1, 2])
def test_consensus_exit_with_one_rank_dried_up(mnist_flat, tmp_path,
                                               interval):
    """Rank 0 holds three batches, rank 1 one partial batch: rank 1 pads
    it, then steps on zero batches until rank 0's stream ends too, and
    both leave in the same round with bit-identical params."""
    full = _mnist_batch(1, batch=16)
    partial = {k: v[:10] for k, v in _mnist_batch(2, batch=16).items()}
    local = [[full, _mnist_batch(3, batch=16), _mnist_batch(4, batch=16)],
             [partial]]
    a, b = run_ranks(2, "lockstep_loop_scenario", tmp_path, timeout=180,
                     flat=mnist_flat, local_batches=local,
                     interval=interval, minibatch=16)
    assert len(a["rounds"]) == len(b["rounds"]) >= 3
    # every round is a version (zero batches too); the real rows are
    # each stream's
    assert [r for r in a["real"] if r] == [16.0, 16.0, 16.0]
    assert [r for r in b["real"] if r] == [10.0]
    assert b["rounds"][0] == 10.0
    assert b["rounds"].count(0.0) == len(b["rounds"]) - 1
    assert a["consensus_calls"] == b["consensus_calls"]
    for name in a["params"]:
        np.testing.assert_array_equal(a["params"][name], b["params"][name])


# ---------------------------------------------------------------------
# the class options on pushes (the reference's tests/test_sync_ps.py)


def _preparer_push(client, grads, ids, version):
    preparer = sparse.SparseBatchPreparer([], client)
    return preparer.push_gradients(
        {"t": grads}, {"t": (np.asarray(ids, np.int64), len(ids))},
        model_version=version,
        force_empty=MultiHostSparseSpmdTrainer.FORCE_EMPTY_PUSH,
        round_scoped=MultiHostSparseSpmdTrainer.ROUND_SCOPED_PUSH)


def test_force_empty_push_reaches_every_shard():
    """A worker whose ids miss a shard still pushes to it (its
    FORCE_EMPTY_PUSH), so every shard's grads_to_wait round fills."""
    servers, addrs, stores, _ = _sync_ps(2, 2, opt=("sgd", {"lr": 1.0}))
    try:
        a = PSClient(addrs, worker_id=0)
        b = PSClient(addrs, worker_id=1)
        a.push_embedding_table_infos([("t", 2, "0.0")])
        grad = np.ones((1, 2), np.float32)
        # worker 0's ids are all even: shard 1 gets a table-less push
        ok, _, _ = _preparer_push(a, grad, [2], 0)
        assert ok
        ok, _, _ = _preparer_push(b, np.repeat(grad, 2, axis=0), [2, 3], 0)
        assert ok
        assert [s.version for s in stores] == [1, 1]
        np.testing.assert_allclose(stores[0].lookup("t", np.array([2])),
                                   [[-2.0, -2.0]])
        np.testing.assert_allclose(stores[1].lookup("t", np.array([3])),
                                   [[-1.0, -1.0]])
    finally:
        for server in servers:
            server.stop(0)


def test_round_scoped_pushes_pair_by_tag_not_arrival_order():
    """Worker 0 pushes rounds 0 and 1 before worker 1 pushes any: the
    PS pairs round r with round r (ROUND_SCOPED_PUSH), never worker 0's
    two rounds with each other."""
    servers, addrs, stores, _ = _sync_ps(1, 2, opt=("sgd", {"lr": 1.0}))
    try:
        # the master's incarnations (a push without one replaces the
        # worker's buffered entry, as a relaunch's would)
        a = PSClient(addrs, worker_id=0, incarnation=1)
        b = PSClient(addrs, worker_id=1, incarnation=1)
        a.push_embedding_table_infos([("t", 2, "0.0")])
        before = stores[0].lookup("t", np.array([8])).copy()
        # the store's version after each push: worker 0's two rounds
        # wait for worker 1's
        assert _preparer_push(a, np.array([[1.0, 0.0]], np.float32), [8],
                              0)[0] and stores[0].version == 0
        assert _preparer_push(a, np.array([[2.0, 0.0]], np.float32), [8],
                              1)[0] and stores[0].version == 0
        assert _preparer_push(b, np.array([[0.0, 1.0]], np.float32), [8],
                              0)[0] and stores[0].version == 1
        np.testing.assert_allclose(stores[0].lookup("t", np.array([8])),
                                   before - [[1.0, 1.0]])
        assert _preparer_push(b, np.array([[0.0, 2.0]], np.float32), [8],
                              1)[0] and stores[0].version == 2
        np.testing.assert_allclose(stores[0].lookup("t", np.array([8])),
                                   before - [[3.0, 3.0]])
    finally:
        for server in servers:
            server.stop(0)


def test_rejected_lockstep_push_is_resent_not_recomputed():
    """RETRY_RECOMPUTES=False: a version-rejected push goes out again
    with the same gradients under the corrected version, with no new
    pull and no recompute (a collective one process must not run
    alone)."""
    from elasticdl_tpu_torch.ps.local_client import LocalPSClient

    class RejectOnce(LocalPSClient):
        def __init__(self):
            super().__init__(seed=0, opt_type="sgd", lr=0.1)
            self.pushes = []

        def push_gradients(self, grads_by_table, model_version=0, **kw):
            self.pushes.append((model_version, {
                k: (v.copy(), i.copy()) for k, (v, i) in
                grads_by_table.items()}, kw))
            if len(self.pushes) == 1:
                return False, 7, (0,)
            return super().push_gradients(grads_by_table,
                                          model_version=model_version, **kw)

    class Lockstep(sparse.SparseTrainer):
        RETRY_RECOMPUTES = False
        FORCE_EMPTY_PUSH = True
        ROUND_SCOPED_PUSH = True

    client = RejectOnce()
    trainer = Lockstep(model=deepfm.custom_model(), loss_fn=deepfm.loss,
                       optimizer=deepfm.optimizer(),
                       specs=deepfm.sparse_embedding_specs(
                           num_features=FIELDS, batch_size=BATCH),
                       ps_client=client, health=False, device="cpu",
                       device_tier=False)
    prepares = []
    prepare = trainer.preparer.prepare
    trainer.preparer.prepare = lambda b: prepares.append(1) or prepare(b)
    batch = _ctr(np.random.RandomState(0))
    trainer.train_step(None, batch)
    assert len(prepares) == 1 and trainer.push_rejections == 1
    (v0, g0, kw0), (v1, g1, kw1) = client.pushes
    assert (v0, v1) == (0, 7)
    assert kw0["force_empty"] and kw0["round_scoped"]
    assert kw1["only_shards"] == (0,) and kw1["round_scoped"]
    for name in g0:
        np.testing.assert_array_equal(g0[name][0], g1[name][0])
        np.testing.assert_array_equal(g0[name][1], g1[name][1])

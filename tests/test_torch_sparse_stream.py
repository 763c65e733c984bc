"""The port's pipelined sparse path (``SparseTrainer.train_stream``, the
async push, the sync-PS retry, the ``HotRowCache``) against the JAX
package's, on the CPU.

DeepFM at small width (4 fields, batch 32; tests/test_torch_sparse.py's
``trainer_pair`` carries the reference's dense params across), inputs
made with numpy from a seed. Mirrors tests/test_sparse_pipeline.py, the
async cases of tests/test_wire_path.py and
tests/test_sync_ps.py::test_sparse_trainer_retries_stale_push.

Tolerances: runs of the port against each other are bit-equal (the same
arithmetic in the same order on the CPU). The port against the
reference runs adam at eps 1e-3 (tests/test_torch_sparse.py's
ADAM_EPS) and holds losses to 1e-5 relative and rows to 1e-5 relative,
1e-7 absolute (STATE_RTOL, STATE_ATOL): the two sum in another order.
"""

import threading

import grpc
import numpy as np
import pytest
import torch
from torch import nn

from elasticdl_tpu.embedding import client as ref_emb_client
from elasticdl_tpu.train import sparse as ref_sparse
from elasticdl_tpu_torch.common import overload
from elasticdl_tpu_torch.common.tensor_utils import deduplicate_indexed_slices
from elasticdl_tpu_torch.embedding import client as emb_client
from elasticdl_tpu_torch.models import deepfm
from elasticdl_tpu_torch.ps.local_client import LocalPSClient
from elasticdl_tpu_torch.train import sparse
from elasticdl_tpu_torch.worker.ps_client import PSClient, PushResult
from tests.test_torch_ps_grpc import live_ps
from tests.test_torch_sparse import (
    ADAM_EPS,
    BATCH,
    FIELDS,
    STATE_RTOL,
    assert_stores_equal,
    make_batches,
    port_client,
    tier_configs,
    trainer_pair,
)

torch.set_num_threads(1)

TABLES = ("deepfm_emb", "deepfm_linear")


def disjoint_batches(n, vocab=64, seed=0):
    """Batch k draws ids only from [k * vocab, (k + 1) * vocab):
    consecutive batches share no row, so one push of staleness changes
    no value and the pipelined run must match the sequential one."""
    rng = np.random.RandomState(seed)
    return [{
        "features": {"ids": (k * vocab + rng.randint(
            0, vocab, size=(BATCH, FIELDS))).astype(np.int64)},
        "labels": rng.randint(0, 2, BATCH).astype(np.float32),
        "_mask": np.ones(BATCH, np.float32),
    } for k in range(n)]


def port_trainer(client=None, **kwargs):
    """A port SparseTrainer on DeepFM (4 fields) on the CPU, health off;
    ``client`` defaults to a numpy-store LocalPSClient (adam lr 0.01)."""
    return sparse.SparseTrainer(
        model=deepfm.custom_model(), loss_fn=deepfm.loss,
        optimizer=deepfm.optimizer(),
        specs=deepfm.sparse_embedding_specs(num_features=FIELDS,
                                            batch_size=BATCH),
        ps_client=client or port_client(lr=0.01), seed=0, health=False,
        device="cpu", **kwargs)


def run_steps(trainer, state, batches):
    losses = []
    for batch in batches:
        state, loss = trainer.train_step(state, batch)
        losses.append(float(loss))
    return state, losses


def run_stream(trainer, state, batches, **kwargs):
    losses = []
    for state, loss, _ in trainer.train_stream(state, batches, **kwargs):
        losses.append(float(loss))
    return state, losses


def assert_params_equal(a, b):
    assert sorted(a.params) == sorted(b.params)
    for name in a.params:
        torch.testing.assert_close(a.params[name], b.params[name], rtol=0,
                                   atol=0, msg=name)


# ---------------------------------------------------------------------
# train_stream against train_step and the reference's train_stream


@pytest.mark.parametrize("tier", [False, True], ids=["tier_off", "tier_on"])
def test_train_stream_matches_train_step_and_reference(tier):
    """On disjoint ids: the port's train_stream equals its train_step
    sequence bit for bit (losses, dense params, PS tables, tier rows),
    and agrees with the reference's train_stream within the state
    tolerance."""
    batches = disjoint_batches(6)
    tiers = (tier_configs(opt_args={"lr": 0.01, "epsilon": ADAM_EPS},
                          capacity=256, promote_hits=1, stage_budget=64)
             if tier else None)
    ref_t, step_t, ref_state, step_state = trainer_pair(
        batches[0], tier=tiers, eps=ADAM_EPS)
    _, stream_t, _, stream_state = trainer_pair(batches[0], tier=tiers,
                                                eps=ADAM_EPS)
    step_state, step_losses = run_steps(step_t, step_state, batches)
    stream_state, stream_losses = run_stream(stream_t, stream_state, batches)
    ref_losses = [float(loss) for _, loss, _ in ref_t.train_stream(
        ref_state, batches)]
    assert stream_losses == step_losses
    np.testing.assert_allclose(stream_losses, ref_losses, rtol=STATE_RTOL)
    assert_params_equal(stream_state, step_state)
    for trainer in (step_t, stream_t, ref_t):
        trainer.close()  # the tier's final writeback
    assert_stores_equal(step_t.preparer._ps.store,
                        stream_t.preparer._ps.store, TABLES)
    assert_stores_equal(ref_t.preparer._ps.store,
                        stream_t.preparer._ps.store, TABLES, exact=False)
    if tier:
        # every id is promoted at its first sighting (promote_hits 1):
        # the tier inserts, gathers and applies on every step
        assert stream_t.device_tier.stats()["insert_chunks"] > 0
        for table in TABLES:
            for got, want in zip(stream_t.device_tier.table_rows(table),
                                 step_t.device_tier.table_rows(table)):
                np.testing.assert_array_equal(got, want)


def test_train_stream_push_interval_accumulates_like_reference():
    """5 steps at push_interval 2: pushes after steps 2, 4 and the tail
    (3 version bumps, not 5), and the PS tables and losses agree with
    the reference's train_stream at the same interval. Disjoint ids:
    with shared ids the lookahead pull races the push thread (one push
    of staleness, either way), and neither run's rows are
    reproducible."""
    batches = disjoint_batches(5, seed=2)
    ref_t, port_t, ref_state, port_state = trainer_pair(batches[0],
                                                        eps=ADAM_EPS)
    _, losses = run_stream(port_t, port_state, batches, push_interval=2)
    ref_losses = [float(loss) for _, loss, _ in ref_t.train_stream(
        ref_state, batches, push_interval=2)]
    assert len(losses) == 5 and np.isfinite(losses).all()
    assert port_t.preparer._ps.store.version == 3
    assert ref_t.preparer._ps.store.version == 3
    np.testing.assert_allclose(losses, ref_losses, rtol=STATE_RTOL)
    assert_stores_equal(ref_t.preparer._ps.store, port_t.preparer._ps.store,
                        TABLES, exact=False)
    with pytest.raises(ValueError):
        next(port_t.train_stream(None, batches, push_interval=0))


def test_train_stream_learns_with_the_cache():
    rng = np.random.RandomState(3)
    weights = np.random.RandomState(42).randn(300) * 2
    batches = []
    for _ in range(40):
        ids = rng.randint(0, 300, size=(BATCH, FIELDS)).astype(np.int64)
        score = weights[ids].sum(axis=1) / np.sqrt(FIELDS)
        batches.append({"features": {"ids": ids},
                        "labels": (score > 0).astype(np.float32),
                        "_mask": np.ones(BATCH, np.float32)})
    trainer = port_trainer(cache_staleness=4)
    _, losses = run_stream(trainer, None, batches)
    assert np.mean(losses[-5:]) < np.mean(losses[:5])
    assert trainer.preparer.cache.hits > 0


def test_train_stream_state_is_live_and_on_first_batch_restores():
    """A state returned by on_first_batch is the one the stream trains,
    and every yielded state is live: the step updates the tensors in
    place, so each step's state holds the latest values, not a
    snapshot."""
    batches = disjoint_batches(3)
    trainer = port_trainer()
    restored = trainer.ensure_state(None, batches[0])
    seen_batches, states = [], []
    for state, _, batch in trainer.train_stream(
            None, batches, on_first_batch=lambda b: (
                seen_batches.append(b), restored)[1]):
        states.append(state)
    assert seen_batches == [batches[0]]
    for state in states:
        for name, param in restored.params.items():
            assert state.params[name].data_ptr() == param.data_ptr()
            assert torch.equal(state.params[name], states[-1].params[name])


def test_train_stream_teardown_flushes_in_flight_step_and_accumulation():
    """Closing the stream after two of five steps (push_interval 3)
    folds the dispatched step and pushes the short accumulation: the PS
    ends as a full stream over those two batches leaves it."""
    batches = disjoint_batches(5)
    cut = port_trainer()
    stream = cut.train_stream(None, batches, push_interval=3)
    next(stream)
    next(stream)
    stream.close()
    whole = port_trainer()
    run_stream(whole, None, batches[:2], push_interval=3)
    assert cut.preparer._ps.store.version == 1
    assert_stores_equal(whole.preparer._ps.store, cut.preparer._ps.store,
                        TABLES)


class RecordingClient:
    """A LocalPSClient that keeps every push's ``grads_by_table`` as it
    was handed over: no copy, so an array the trainer later overwrites
    shows here."""

    def __init__(self, inner):
        self._inner = inner
        self.pushes = []

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def push_gradients(self, grads_by_table, **kwargs):
        self.pushes.append(grads_by_table)
        return self._inner.push_gradients(grads_by_table, **kwargs)


def test_pushed_gradients_do_not_alias_the_reused_host_buffers():
    """With push_interval 2 the accumulation holds step N's rows while
    step N+1's copy lands in the same host buffers, and the push thread
    reads them later still. On disjoint ids the gradients a recording
    client receives equal those of the same steps run sequentially,
    merged in pairs."""
    batches = disjoint_batches(6)
    seq_client = RecordingClient(port_client(lr=0.01))
    run_steps(port_trainer(seq_client), None, batches)
    stream_client = RecordingClient(port_client(lr=0.01))
    run_stream(port_trainer(stream_client), None, batches, push_interval=2)
    assert len(seq_client.pushes) == 6 and len(stream_client.pushes) == 3
    for k, pushed in enumerate(stream_client.pushes):
        first, second = seq_client.pushes[2 * k: 2 * k + 2]
        assert sorted(pushed) == sorted(TABLES)
        for name in TABLES:
            want = deduplicate_indexed_slices(
                np.concatenate([first[name][0], second[name][0]]),
                np.concatenate([first[name][1], second[name][1]]))
            np.testing.assert_array_equal(pushed[name][1], want[1])
            np.testing.assert_array_equal(pushed[name][0], want[0])


def test_finish_push_rejects_sync_rejection():
    trainer = port_trainer()
    with pytest.raises(RuntimeError, match="sync"):
        trainer._finish_push((False, 3))
    trainer._finish_push(PushResult(True, 4))
    assert trainer._version == 4


@pytest.mark.parametrize("result", [None, (True, 3), (False, 3),
                                    (True, 5, ()), (False, 5, (1,)),
                                    (False, 5, None),
                                    PushResult(False, 2, (0, 1))])
def test_normalize_push_result_matches_reference(result):
    assert sparse._normalize_push_result(result, 7) == \
        ref_sparse._normalize_push_result(result, 7)


def test_row_grads_fn_matches_the_steps_row_gradients():
    """make_row_grads_fn (the sync retry's recompute) gives the train
    step's row gradients at the same params, bit for bit."""
    batch = disjoint_batches(1)[0]
    trainer = port_trainer()
    state = trainer.ensure_state(None, batch)
    prepared, _ = trainer.preparer.prepare(batch)
    prepared = sparse._to_device(prepared, trainer.device)
    want = trainer._row_grads(state, prepared)
    _, _, got = trainer._train_step(state, prepared)[:3]
    assert sorted(got) == sorted(want) == sorted(TABLES)
    for name in TABLES:
        torch.testing.assert_close(got[name], want[name], rtol=0, atol=0)


# ---------------------------------------------------------------------
# the HotRowCache against the reference's


def _cache_script(seed):
    rng = np.random.RandomState(seed)
    ops = []
    for _ in range(60):
        kind = rng.choice(["advance", "split", "put", "put", "lookup_any",
                           "clear", "put_stale"], p=[.25, .25, .15, .15,
                                                     .1, .03, .07])
        table = "t%d" % rng.randint(2)
        ids = np.unique(rng.randint(0, 40, size=rng.randint(1, 12)))
        ops.append((kind, table, ids.astype(np.int64),
                    rng.randn(ids.size, 3).astype(np.float32)))
    return ops


def _run_cache(module, ops, staleness, capacity):
    cache = module.HotRowCache(staleness=staleness, capacity=capacity)
    out = []
    for kind, table, ids, rows in ops:
        if kind == "advance":
            cache.advance()
        elif kind == "clear":
            cache.clear()
        elif kind == "put":
            cache.put(table, ids[::-1], rows[::-1])  # unsorted input
        elif kind == "put_stale":
            cache.put(table, ids, rows, if_generation=cache.generation - 1)
        else:
            mask, got = getattr(cache, kind)(table, ids)
            out.append((mask.tolist(), None if got is None else got.copy()))
    out.append((cache.hits, cache.misses, cache.generation,
                cache.hit_rate()))
    return out


@pytest.mark.parametrize("staleness,capacity,seed", [
    (1, 1000, 0), (2, 3, 1), (3, 16, 2), (8, 25, 3)])
def test_hot_row_cache_matches_reference(staleness, capacity, seed):
    """The same script of advances, splits, puts (unsorted, stale
    generations), relaxed lookups and clears: every mask, row, tally
    and generation is the reference cache's, bit for bit."""
    ops = _cache_script(seed)
    got = _run_cache(emb_client, ops, staleness, capacity)
    want = _run_cache(ref_emb_client, ops, staleness, capacity)
    assert len(got) == len(want)
    for g, w in zip(got[:-1], want[:-1]):
        assert g[0] == w[0]
        if w[1] is None:
            assert g[1] is None
        else:
            np.testing.assert_array_equal(g[1], w[1])
    assert got[-1] == want[-1]


def test_hot_row_cache_staleness_and_eviction():
    cache = emb_client.HotRowCache(staleness=2, capacity=3)
    ids = np.array([1, 2], dtype=np.int64)
    rows = np.ones((2, 4), np.float32)
    cache.advance()
    assert not cache.split("t", ids)[0].any()
    cache.put("t", ids, rows)
    cache.advance()
    mask, cached = cache.split("t", ids)
    assert mask.all()
    np.testing.assert_array_equal(cached, rows)
    cache.advance()
    cache.advance()
    assert not cache.split("t", ids)[0].any()
    cache.put("t", np.arange(3, dtype=np.int64), np.zeros((3, 4), np.float32))
    cache.advance()
    cache.put("t", np.array([9], np.int64), np.ones((1, 4), np.float32))
    mask, _ = cache.split("t", np.array([0, 1, 2, 9], np.int64))
    assert mask.sum() == 3 and mask[3]
    with pytest.raises(ValueError):
        emb_client.HotRowCache(staleness=0)


def test_cache_skips_fresh_pulls():
    pulled = []

    class CountingClient(LocalPSClient):
        def pull_embedding_vectors(self, name, ids):
            pulled.append(int(np.asarray(ids).size))
            return super().pull_embedding_vectors(name, ids)

    client = CountingClient(seed=0, opt_type="sgd", lr=0.1)
    specs = deepfm.sparse_embedding_specs(num_features=FIELDS,
                                          batch_size=BATCH)
    preparer = sparse.SparseBatchPreparer(
        specs, client, cache=emb_client.HotRowCache(staleness=3))
    batch = make_batches(1)[0]
    preparer.prepare(batch)
    first = sum(pulled)
    assert first > 0
    preparer.prepare(batch)  # same ids, within staleness: no new pulls
    assert sum(pulled) == first


def test_tier_supersedes_the_cache():
    tiers = tier_configs()
    trainer = port_trainer(cache_staleness=4, device_tier=tiers[1])
    assert trainer.preparer.cache is None
    trainer.close()


def test_degraded_fill_matches_reference(monkeypatch):
    """Brownout pulls (EDL_BROWNOUT_SKIP_AFTER > 0): a PS failing with
    UNAVAILABLE is answered with fresh cached rows, stale cached rows
    and zeros for ids never cached, the same as the reference's
    EmbeddingClient; without the knob the failure raises."""
    class Flaky:
        def __init__(self, inner, rpc_error):
            self.inner, self.fail, self.error = inner, False, rpc_error

        def pull_embedding_batch(self, ids_by_table):
            if self.fail:
                raise self.error
            return self.inner.pull_embedding_batch(ids_by_table)

        def pull_embedding_vectors(self, name, ids):
            if self.fail:
                raise self.error
            return self.inner.pull_embedding_vectors(name, ids)

    class Unavailable(grpc.RpcError):
        def code(self):
            return grpc.StatusCode.UNAVAILABLE

    monkeypatch.setenv(overload.BROWNOUT_SKIP_AFTER_ENV, "1")
    outs = []
    for module in (ref_emb_client, emb_client):
        store_client = port_client(lr=0.1, opt_type="sgd")
        store_client.push_embedding_table_infos([("t", 3, "0.05")])
        flaky = Flaky(store_client, Unavailable())
        client = module.EmbeddingClient(
            flaky, cache=module.HotRowCache(staleness=1))
        out = [client.pull_tables({"t": np.arange(6)})["t"]]
        for _ in range(3):
            client.advance()
        flaky.fail = True
        out.append(client.pull_tables({"t": np.arange(3, 10)})["t"])
        out.append(client.pull("t", np.arange(2, 8)))
        outs.append(out)
    for got, want in zip(*outs[::-1]):
        np.testing.assert_array_equal(got, want)
    assert not outs[1][1][3:].any()  # ids 6..9 never cached: zeros
    monkeypatch.delenv(overload.BROWNOUT_SKIP_AFTER_ENV)
    with pytest.raises(grpc.RpcError):
        client.pull_tables({"t": np.arange(3)})


# ---------------------------------------------------------------------
# the async push (tests/test_wire_path.py's async cases)


class SlowClient:
    """LocalPSClient wrapper whose pushes block until released."""

    def __init__(self, inner):
        self._inner = inner
        self.release = threading.Event()
        self.push_started = threading.Event()
        self.pushes = 0
        self.fail_next = None  # None | "reject" | "raise"

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def push_gradients(self, *args, **kwargs):
        self.push_started.set()
        assert self.release.wait(timeout=30), "push never released"
        self.pushes += 1
        failure, self.fail_next = self.fail_next, None
        if failure == "reject":
            return PushResult(False, 7, (0,))
        if failure == "raise":
            raise ConnectionError("injected push transport failure")
        return self._inner.push_gradients(*args, **kwargs)


def test_async_push_overlaps_step_and_joins_depth_one():
    client = SlowClient(port_client(lr=0.01))
    trainer = port_trainer(client, async_push=True)
    b1, b2 = make_batches(2)
    state, _ = trainer.train_step(None, b1)
    assert client.push_started.wait(timeout=10)
    assert client.pushes == 0  # the step returned with its push blocked
    client.release.set()
    state, _ = trainer.train_step(state, b2)
    trainer.join_pushes()
    assert client.pushes == 2
    assert trainer._version == 2


def test_async_push_failure_surfaces_on_join():
    client = SlowClient(port_client(lr=0.01))
    client.release.set()
    trainer = port_trainer(client, async_push=True)
    client.fail_next = "raise"
    trainer.train_step(None, make_batches(1)[0])
    with pytest.raises(ConnectionError, match="injected push"):
        trainer.join_pushes()
    trainer.join_pushes()  # the failed future is consumed


def test_async_push_rejection_raises_with_shards_on_join():
    client = SlowClient(port_client(lr=0.01))
    client.release.set()
    trainer = port_trainer(client, async_push=True)
    client.fail_next = "reject"
    trainer.train_step(None, make_batches(1)[0])
    with pytest.raises(RuntimeError, match=r"rejected.*\[0\]"):
        trainer.join_pushes()
    assert trainer.push_rejections == 1


def test_eval_step_joins_the_in_flight_push():
    client = SlowClient(port_client(lr=0.01))
    trainer = port_trainer(client, async_push=True)
    b1, b2 = make_batches(2)
    state, _ = trainer.train_step(None, b1)
    threading.Timer(0.2, client.release.set).start()
    trainer.eval_step(state, b2)
    assert client.pushes == 1 and trainer._push_future is None


def test_async_push_env_knob(monkeypatch):
    monkeypatch.setenv(sparse.ASYNC_PUSH_ENV, "true")
    assert port_trainer()._async_push is True
    monkeypatch.setenv(sparse.ASYNC_PUSH_ENV, "no")
    assert port_trainer()._async_push is False
    monkeypatch.setenv(sparse.ASYNC_PUSH_ENV, "maybe")
    with pytest.raises(Exception):
        port_trainer()


@pytest.mark.parametrize("kind", ["numpy", "native"])
def test_async_push_and_stream_train_through_live_ps(kind):
    """Over the port's gRPC PS (two shards, async): the async push's
    version accounting adds up and the stream's losses stay finite,
    and the same batches give the same losses synchronously."""
    rng = np.random.RandomState(7)
    batches = [{"features": {"ids": (k * 100 + rng.randint(
        0, 100, size=(BATCH, FIELDS))).astype(np.int64)},
        "labels": rng.randint(0, 2, BATCH).astype(np.float32),
        "_mask": np.ones(BATCH, np.float32)} for k in range(4)]
    losses = {}
    for mode in ("sync", "async", "stream"):
        with live_ps("port", kind) as (stores, _, addrs):
            trainer = port_trainer(PSClient(addrs),
                                   async_push=mode == "async")
            if mode == "stream":
                _, losses[mode] = run_stream(trainer, None, batches,
                                             push_interval=2)
            else:
                _, losses[mode] = run_steps(trainer, None, batches)
                trainer.join_pushes()
                assert trainer._version == 4
            trainer.close()
            assert all(store.version > 0 for store in stores)
    assert np.isfinite(losses["stream"]).all()
    assert losses["sync"] == losses["async"] == losses["stream"]


# ---------------------------------------------------------------------
# brownout and the sync-PS retry


def test_brownout_absorbs_overload_pushes_then_recovers(monkeypatch):
    class Failing:
        def __init__(self, inner):
            self.inner, self.fail = inner, 0

        def __getattr__(self, name):
            return getattr(self.inner, name)

        def push_gradients(self, *args, **kwargs):
            if self.fail:
                self.fail -= 1
                raise overload.CircuitOpenError("ps-0", "write")
            return self.inner.push_gradients(*args, **kwargs)

    monkeypatch.setenv(overload.BROWNOUT_SKIP_AFTER_ENV, "2")
    client = Failing(port_client(lr=0.01))
    trainer = port_trainer(client)
    batches = make_batches(5)
    state, _ = trainer.train_step(None, batches[0])
    client.fail = 3
    for batch in batches[1:4]:
        state, _ = trainer.train_step(state, batch)
    assert trainer.brownout_skipped_pushes == 3
    assert trainer._brownout_streak == 3
    assert client.inner.store.version == 1  # the dropped pushes never ran
    trainer.train_step(state, batches[4])
    assert trainer._brownout_streak == 0 and client.inner.store.version == 2
    monkeypatch.setenv(overload.BROWNOUT_SKIP_AFTER_ENV, "0")
    client.fail = 1
    with pytest.raises(grpc.RpcError):
        trainer.train_step(state, batches[0])


class _SumModel(nn.Module):
    """embedding_lookup of table "e" summed over the fields, then one
    linear unit: tests/test_sync_ps.py's flax model."""

    def __init__(self):
        super().__init__()
        self.dense = nn.Linear(4, 1)

    def forward(self, features):
        return self.dense(sparse.embedding_lookup(features, "e", "sum"))[:, 0]


def _bce(labels, logits):
    logits = logits.float()
    return (torch.clamp(logits, min=0) - logits * labels
            + torch.log1p(torch.exp(-torch.abs(logits))))


def test_sparse_trainer_retries_stale_push():
    """Two trainers sharing one sync servicer of the port (grads_to_wait
    1, tolerance 0): the one pushing at a stale version is rejected,
    retries with fresh rows and recomputed row gradients, and both
    converge."""
    from elasticdl_tpu_torch.common.tensor_utils import (
        serialize_indexed_slices,
    )
    from elasticdl_tpu_torch.proto import elasticdl_tpu_pb2 as pb
    from elasticdl_tpu_torch.ps.embedding_store import create_store
    from elasticdl_tpu_torch.ps.servicer import PserverServicer
    from elasticdl_tpu_torch.train.optimizers import create_optimizer

    store = create_store(seed=0)
    store.set_optimizer("sgd", lr=1.0)
    servicer = PserverServicer(store, use_async=False, grads_to_wait=1)

    class SyncClient:
        ps_num = 1

        def push_embedding_table_infos(self, infos):
            request = pb.Model()
            for name, dim, init in infos:
                request.embedding_table_infos.add(name=name, dim=dim,
                                                  initializer=str(init))
            servicer.push_embedding_table_infos(request)

        def pull_embedding_vectors(self, name, ids):
            return store.lookup(name, np.asarray(ids, np.int64))

        def push_gradients(self, grads_by_table, model_version=0, **kwargs):
            for name, (values, ids) in grads_by_table.items():
                request = pb.PushGradientsRequest()
                request.gradients.version = model_version
                serialize_indexed_slices(
                    np.asarray(values, np.float32),
                    np.asarray(ids, np.int64),
                    request.gradients.embedding_tables[name])
                response = servicer.push_gradients(request)
                return response.accepted, response.version
            return True, store.version

    specs = [sparse.SparseEmbeddingSpec("e", 4, feature_key="ids")]
    trainers = [sparse.SparseTrainer(
        _SumModel(), _bce, create_optimizer("Adam", learning_rate=0.05),
        specs, SyncClient(), compute_dtype="float32", health=False,
        device="cpu") for _ in range(2)]
    rng = np.random.default_rng(0)
    planted = np.random.default_rng(999).normal(size=50)
    states, losses = [None, None], []
    for step in range(40):
        ids = rng.integers(0, 50, size=(16, 3))
        batch = {"features": {"ids": ids},
                 "labels": (planted[ids].sum(axis=1) > 0).astype(np.float32),
                 "_mask": np.ones(16, np.float32)}
        states[0], loss = trainers[0].train_step(states[0], batch)
        losses.append(float(loss))
        if step % 3 == 0:
            trainers[1]._version = 0  # force staleness
            states[1], _ = trainers[1].train_step(states[1], batch)
    assert trainers[1].push_rejections > 0
    assert np.mean(losses[-8:]) < np.mean(losses[:8])


def test_sync_rejection_with_the_tier_raises():
    """The retry would recompute the FULL row gradients with the hit
    gradients already applied on the card: with a tier a rejection
    raises instead."""
    class Rejecting(LocalPSClient):
        def push_gradients(self, *args, **kwargs):
            return PushResult(False, 9, (0,))

    trainer = port_trainer(Rejecting(), device_tier=tier_configs()[1])
    with pytest.raises(RuntimeError, match="EDL_DEVICE_TIER requires"):
        trainer.train_step(None, make_batches(1)[0])
    trainer.device_tier._writeback_pool.shutdown(wait=True)


def test_hot_row_cache_wall_clock_ttl_and_generation_guard():
    """Serving's discipline: a wall-clock TTL (staleness ignored) under
    the cache's lock, and a fill fetched before a clear() dropped."""
    import time

    for module in (emb_client, ref_emb_client):
        cache = module.HotRowCache(ttl_secs=1.0, thread_safe=True)
        ids = np.array([3, 5], np.int64)
        cache.put("t", ids, np.ones((2, 2), np.float32))
        cache.advance()  # no logical clock under a TTL
        assert cache.split("t", ids)[0].all()
        time.sleep(1.2)
        assert not cache.split("t", ids)[0].any()
        assert cache.lookup_any("t", ids)[0].all()  # stale, still held
        generation = cache.generation
        cache.clear()
        cache.put("t", ids, np.ones((2, 2), np.float32),
                  if_generation=generation)
        assert cache.lookup_any("t", ids)[1] is None
        with pytest.raises(ValueError):
            module.HotRowCache(ttl_secs=0)

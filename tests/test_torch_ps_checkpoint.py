"""The port's sparse checkpoints (ps/checkpoint.py), the stores'
incremental-checkpoint surface and the servicer's checkpoint path, on
the CPU.

(a) every scenario of tests/test_sparse_checkpoint.py and of
tests/test_checkpoint_delta.py but the stream-boundary ones (the stream
checkpoint is not ported), on the port, on both store kinds where the
scenario runs a store; (b) interop with the reference: a checkpoint
chain written by either package's saver restores in the other's store
bit for bit (numpy against numpy, native against native), the two
savers write the same arrays, both ``latest_version`` agree, and a
store's dirty export matches the reference's store after the same
operations; (c) the boot-restore stamp on every push and pull response,
byte for byte the reference servicer's. Inputs are made with numpy from
a seed; data movement is compared bit for bit.
"""

import os
import threading
import time

import numpy as np
import pytest

from elasticdl_tpu.common import tensor_utils as ref_tensor_utils
from elasticdl_tpu.proto import elasticdl_tpu_pb2 as ref_pb
from elasticdl_tpu.ps import checkpoint as ref_ckpt
from elasticdl_tpu.ps import embedding_store as ref_store
from elasticdl_tpu.ps import servicer as ref_servicer
from elasticdl_tpu_torch.common import tensor_utils
from elasticdl_tpu_torch.proto import elasticdl_tpu_pb2 as pb
from elasticdl_tpu_torch.ps import embedding_store as port_store
from elasticdl_tpu_torch.ps import servicer as port_servicer
from elasticdl_tpu_torch.ps.checkpoint import (
    AsyncCheckpointer,
    SparseCheckpointSaver,
)

BACKENDS = ["numpy", "native"]
STORE_MODULES = {"port": port_store, "ref": ref_store}
SAVERS = {"port": SparseCheckpointSaver, "ref": ref_ckpt.SparseCheckpointSaver}


def make_store(backend, opt_type="adam", seed=0, pkg="port",
               initializer="zeros", **opt_args):
    module = STORE_MODULES[pkg]
    cls = (module.NativeEmbeddingStore if backend == "native"
           else module.NumpyEmbeddingStore)
    store = cls(seed=seed)
    store.set_optimizer(opt_type, **opt_args)
    store.create_table("t", 4, init_scale=0.0 if initializer == "zeros"
                       else 0.05, initializer=initializer)
    return store


def full_state(store, name="t"):
    """(ids, rows, steps) sorted by id: an order-free comparison key."""
    ids, rows, steps = store.export_table_full(name)
    order = np.argsort(ids)
    return ids[order], rows[order], steps[order]


def assert_state_equal(a, b, name="t"):
    sa, sb = full_state(a, name), full_state(b, name)
    assert sa[0].shape == sb[0].shape
    for x, y in zip(sa, sb):
        np.testing.assert_array_equal(x, y)


# ---------------------------------------------------------------------------
# tests/test_sparse_checkpoint.py


@pytest.mark.parametrize("backend", BACKENDS)
def test_save_restore_and_gc(tmp_path, backend):
    ckpt_dir = str(tmp_path / "ckpt")
    store = make_store(backend, "sgd", lr=0.1, initializer="uniform")
    ids = np.arange(20, dtype=np.int64)
    values = np.random.RandomState(0).rand(20, 4).astype(np.float32)
    store.import_table("t", ids, values)
    # compact_every 0: every save is a full base
    saver = SparseCheckpointSaver(ckpt_dir, shard_id=0, shard_num=1,
                                  keep_max=2, compact_every=0)
    for version in (5, 10, 15):
        assert saver.save(version, store).kind == "full"
    assert sorted(os.listdir(ckpt_dir)) == ["version-10", "version-15"]
    # the newest into shard 2 of 4: ids 2, 6, 10, 14, 18
    shard_store = make_store(backend, "sgd", seed=1, lr=0.1,
                             initializer="uniform")
    shard = SparseCheckpointSaver(ckpt_dir, shard_id=2, shard_num=4)
    assert shard.restore(shard_store) == 15
    assert shard_store.table_size("t") == 5
    np.testing.assert_array_equal(
        shard_store.lookup("t", np.array([6], np.int64))[0], values[6])
    # a registration after the restore sets the initializer's scale
    shard_store.create_table("t", 4, init_scale=0.3)
    row = shard_store.lookup("t", np.array([999], np.int64))[0]
    assert (np.abs(row) <= 0.3).all()


@pytest.mark.parametrize("backend", BACKENDS)
def test_full_state_resume_is_bit_identical(tmp_path, backend):
    """Save after 4 adam pushes, restore into a fresh store, push 4 more:
    the rows equal an uninterrupted run's (slots and per-row steps are
    saved)."""
    def fresh():
        return make_store(backend, "adam", lr=0.05, initializer="uniform")

    rng = np.random.RandomState(0)
    ids = np.arange(6, dtype=np.int64)
    grads = [rng.randn(6, 4).astype(np.float32) for _ in range(8)]
    baseline = fresh()
    for g in grads:
        baseline.push_gradients("t", ids, g)
    resumed = fresh()
    for g in grads[:4]:
        resumed.push_gradients("t", ids, g)
    saver = SparseCheckpointSaver(str(tmp_path), shard_id=0, shard_num=1)
    saver.save(4, resumed)
    restored = fresh()
    assert saver.restore(restored) == 4
    for g in grads[4:]:
        restored.push_gradients("t", ids, g)
    np.testing.assert_array_equal(restored.lookup("t", ids),
                                  baseline.lookup("t", ids))
    assert_state_equal(restored, baseline)


@pytest.mark.parametrize("backend", BACKENDS)
def test_full_state_reshard_preserves_slots(tmp_path, backend):
    """Re-shard 1 -> 2: each shard holds its ids with their amsgrad slots,
    and further pushes match the unsharded run."""
    def fresh():
        return make_store(backend, "amsgrad", lr=0.05, initializer="uniform")

    rng = np.random.RandomState(1)
    ids = np.arange(8, dtype=np.int64)
    pre = [rng.randn(8, 4).astype(np.float32) for _ in range(4)]
    post = [rng.randn(8, 4).astype(np.float32) for _ in range(4)]
    baseline = fresh()
    for g in pre + post:
        baseline.push_gradients("t", ids, g)
    writer = fresh()
    for g in pre:
        writer.push_gradients("t", ids, g)
    SparseCheckpointSaver(str(tmp_path), shard_id=0, shard_num=1).save(
        4, writer)
    for shard_id in range(2):
        shard_store = fresh()
        SparseCheckpointSaver(str(tmp_path), shard_id=shard_id,
                              shard_num=2).restore(shard_store)
        mine = np.nonzero(ids % 2 == shard_id)[0]
        assert sorted(shard_store.export_table_full("t")[0]) == list(mine)
        for g in post:
            shard_store.push_gradients("t", ids[mine], g[mine])
        np.testing.assert_array_equal(shard_store.lookup("t", ids[mine]),
                                      baseline.lookup("t", ids[mine]))


@pytest.mark.parametrize("backend", BACKENDS)
def test_optimizer_swap_restores_weights_only(tmp_path, backend):
    """momentum -> adagrad (the same slot width): the foreign slots are
    not imported (negative velocities in adagrad's accumulator would
    give NaNs)."""
    writer = make_store(backend, "momentum", lr=0.1, momentum=0.9,
                        initializer="uniform")
    ids = np.arange(4, dtype=np.int64)
    for _ in range(3):
        writer.push_gradients("t", ids, -np.ones((4, 4), np.float32))
    saver = SparseCheckpointSaver(str(tmp_path), shard_id=0, shard_num=1)
    saver.save(3, writer)
    weights = writer.lookup("t", ids)
    restored = make_store(backend, "adagrad", lr=0.1, initializer="uniform")
    saver.restore(restored)
    np.testing.assert_array_equal(restored.lookup("t", ids), weights)
    restored.push_gradients("t", ids, np.ones((4, 4), np.float32))
    assert np.isfinite(restored.lookup("t", ids)).all()


def _sync_push(version, worker_id, value=1.0):
    request = pb.PushGradientsRequest()
    request.gradients.version = version
    slices = request.gradients.embedding_tables["t"]
    tensor_utils.ndarray_to_blob(np.full((2, 4), value, np.float32),
                                 slices.concat_tensors)
    slices.ids.extend([0, 1])
    request.worker_id = worker_id
    return request


@pytest.mark.parametrize("backend", BACKENDS)
def test_graceful_stop_flushes_round_and_rejects_late_pushes(tmp_path,
                                                             backend):
    """graceful_stop applies the buffered partial round and saves a final
    complete checkpoint; a push or a tier writeback after it is refused
    and changes nothing; a second stop is a no-op; the async path
    refuses too."""
    two = np.array([0, 1], np.int64)
    store = make_store(backend, "sgd", lr=0.1, initializer="uniform")
    before = store.lookup("t", two).copy()
    saver = SparseCheckpointSaver(str(tmp_path / "ckpt"), shard_id=0,
                                  shard_num=1)
    servicer = port_servicer.PserverServicer(
        store, use_async=False, grads_to_wait=2, checkpoint_saver=saver)
    assert servicer.push_gradients(_sync_push(0, worker_id=0)).accepted
    servicer.graceful_stop()
    after = store.lookup("t", two)
    assert not np.array_equal(before, after)
    restored = make_store(backend, "sgd", seed=1, lr=0.1,
                          initializer="uniform")
    assert saver.restore(restored) == store.version == 1
    np.testing.assert_array_equal(restored.lookup("t", two), after)
    assert not servicer.push_gradients(
        _sync_push(store.version, worker_id=1)).accepted
    np.testing.assert_array_equal(store.lookup("t", two), after)
    rows = pb.Model()
    slices = rows.embedding_tables["t"]
    tensor_utils.ndarray_to_blob(np.full((2, 4), 9.0, np.float32),
                                 slices.concat_tensors)
    slices.ids.extend([0, 1])
    assert not servicer.push_embedding_rows(rows).accepted
    np.testing.assert_array_equal(store.lookup("t", two), after)
    servicer.graceful_stop()
    async_store = make_store(backend, "sgd", lr=0.1, initializer="uniform")
    async_servicer = port_servicer.PserverServicer(async_store,
                                                   use_async=True)
    async_servicer.graceful_stop()
    assert not async_servicer.push_gradients(
        _sync_push(0, worker_id=0)).accepted
    np.testing.assert_array_equal(
        async_store.lookup("t", two),
        make_store(backend, "sgd", lr=0.1,
                   initializer="uniform").lookup("t", two))


# ---------------------------------------------------------------------------
# tests/test_checkpoint_delta.py: dirty-row tracking


@pytest.mark.parametrize("backend", BACKENDS)
def test_dirty_tracking_snapshot_and_clear(backend):
    store = make_store(backend)
    ids = np.arange(8, dtype=np.int64)
    store.push_gradients("t", ids, np.ones((8, 4), np.float32))
    # a lookup that materializes a row changes the state; one of a
    # resident row does not
    store.lookup("t", np.array([99, 3], np.int64))
    assert store.dirty_count("t") == 9
    d_ids, d_rows, _, dead = store.export_table_dirty("t")
    np.testing.assert_array_equal(d_ids, [0, 1, 2, 3, 4, 5, 6, 7, 99])
    assert d_rows.shape == (9, 4 * (1 + store.table_slots("t")))
    assert dead.size == 0
    assert store.dirty_count("t") == 0
    assert store.export_table_dirty("t")[0].size == 0
    store.push_gradients("t", np.array([3], np.int64),
                         np.ones((1, 4), np.float32))
    assert store.dirty_count("t") == 1


@pytest.mark.parametrize("backend", BACKENDS)
def test_drop_rows_moves_dirty_to_dead(backend):
    store = make_store(backend)
    ids = np.arange(4, dtype=np.int64)
    store.push_gradients("t", ids, np.ones((4, 4), np.float32))
    assert store.drop_rows("t", np.array([1, 2, 77], np.int64)) == 2
    d_ids, _, _, dead = store.export_table_dirty("t")
    np.testing.assert_array_equal(d_ids, [0, 3])
    # only rows that existed are tombstoned (77 never materialized)
    np.testing.assert_array_equal(dead, [1, 2])
    store.push_gradients("t", np.array([1], np.int64),
                         np.ones((1, 4), np.float32))
    d_ids, _, _, dead = store.export_table_dirty("t")
    np.testing.assert_array_equal(d_ids, [1])
    assert dead.size == 0


def _drive(stores, seed=7, steps=6):
    """The same pushes, lookups, writebacks, full imports and drops on
    every store."""
    rng = np.random.RandomState(seed)
    for step in range(steps):
        if step == 4:
            full_ids, full_rows, full_steps = full_state(stores[0])
        ids = np.unique(rng.randint(0, 40, size=12)).astype(np.int64)
        grads = rng.randn(ids.size, 4).astype(np.float32)
        looked = np.unique(rng.randint(30, 60, size=5)).astype(np.int64)
        written = np.unique(rng.randint(0, 80, size=4)).astype(np.int64)
        rows = rng.randn(written.size, 4).astype(np.float32)
        for store in stores:
            store.push_gradients("t", ids, grads)
            store.lookup("t", looked)
            store.import_table("t", written, rows)
            if step == 2:
                store.drop_rows("t", np.array([5, 6, 1000], np.int64))
            if step == 4:
                store.import_table_full("t", full_ids[:3], full_rows[:3],
                                        full_steps[:3] + 1)


def test_dirty_export_parity_numpy_native():
    stores = [make_store(b) for b in BACKENDS]
    _drive(stores)
    for a, b in zip(*[s.export_table_dirty("t") for s in stores]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("backend", BACKENDS)
def test_dirty_export_matches_reference_store(backend):
    """The port's store and the reference's of the same kind, seed and
    initializer after the same operations: the dirty export (ids, full
    rows, steps, tombstones), the full state and the weights-only
    export agree bit for bit."""
    stores = [make_store(backend, pkg=pkg, seed=3, initializer="uniform",
                         lr=0.05) for pkg in ("port", "ref")]
    for round_ in range(2):
        _drive(stores, seed=11 + round_)
        assert stores[0].dirty_count("t") == stores[1].dirty_count("t")
        for a, b in zip(*[s.export_table_dirty("t") for s in stores]):
            np.testing.assert_array_equal(a, b)
    assert_state_equal(*stores)
    # the weights-only export, in the store's own order
    (ids_p, values_p), (ids_r, values_r) = (s.export_table("t")
                                            for s in stores)
    np.testing.assert_array_equal(ids_p, ids_r)
    np.testing.assert_array_equal(values_p, values_r)
    np.testing.assert_array_equal(values_p, stores[0].lookup("t", ids_p))


# ---------------------------------------------------------------------------
# the delta chain format


@pytest.mark.parametrize("backend", BACKENDS)
def test_chain_restore_bit_identical_to_full(backend, tmp_path):
    """Base + deltas with tombstones restores bit-identically to a full
    save of the same live store, and tombstoned ids stay dead."""
    live = make_store(backend)
    rng = np.random.RandomState(0)
    saver = SparseCheckpointSaver(str(tmp_path / "chain"), compact_every=10)
    ids = np.arange(50, dtype=np.int64)
    live.push_gradients("t", ids, rng.randn(50, 4).astype(np.float32))
    assert saver.save(1, live).kind == "full"
    for v in range(2, 6):
        sub = np.unique(rng.randint(0, 60, size=8)).astype(np.int64)
        live.push_gradients("t", sub,
                            rng.randn(sub.size, 4).astype(np.float32))
        live.drop_rows("t", np.array([40 + v], np.int64))
        result = saver.save(v, live)
        assert result.kind == "delta" and result.chain_len == v - 1
    SparseCheckpointSaver(str(tmp_path / "full")).save(5, live)
    from_chain = make_store(backend, seed=1)
    from_full = make_store(backend, seed=2)
    assert SparseCheckpointSaver(str(tmp_path / "chain")).restore(
        from_chain) == 5
    assert SparseCheckpointSaver(str(tmp_path / "full")).restore(
        from_full) == 5
    assert_state_equal(from_chain, from_full)
    assert_state_equal(from_chain, live)
    resident = set(from_chain.export_table_full("t")[0].tolist())
    for v in range(2, 6):
        assert 40 + v not in resident, "tombstoned id resurrected"


def test_chain_interop_numpy_native_bit_exact(tmp_path):
    """A chain written from the numpy store restores into the native
    store bit for bit, and the reverse."""
    for writer_backend, reader_backend in (("numpy", "native"),
                                           ("native", "numpy")):
        ckpt = str(tmp_path / ("chain-" + writer_backend))
        writer = make_store(writer_backend)
        rng = np.random.RandomState(3)
        saver = SparseCheckpointSaver(ckpt, compact_every=8)
        ids = np.arange(20, dtype=np.int64)
        writer.push_gradients("t", ids, rng.randn(20, 4).astype(np.float32))
        saver.save(1, writer)
        writer.drop_rows("t", np.array([4], np.int64))
        writer.push_gradients("t", ids[:6],
                              rng.randn(6, 4).astype(np.float32))
        saver.save(2, writer)
        reader = make_store(reader_backend, seed=9)
        assert SparseCheckpointSaver(ckpt).restore(reader) == 2
        assert_state_equal(reader, writer)


@pytest.mark.parametrize("backend", BACKENDS)
def test_old_full_format_still_restores(tmp_path, backend):
    """A directory with a full base only, written by np.savez without
    the atomic rename or a chain token, is a chain of length zero."""
    store = make_store(backend)
    ids = np.arange(6, dtype=np.int64)
    store.push_gradients("t", ids, np.ones((6, 4), np.float32))
    full_ids, rows, steps = store.export_table_full("t")
    arrays = {"ids/t": full_ids, "fullrows/t": rows, "steps/t": steps,
              "dim/t": np.int64(4), "opt/t": np.str_(store.opt_type)}
    vdir = tmp_path / "version-7"
    vdir.mkdir(parents=True)
    np.savez(str(vdir / "embeddings-0-of-1.npz"), **arrays)
    restored = make_store(backend, seed=1)
    assert SparseCheckpointSaver(str(tmp_path)).restore(restored) == 7
    assert_state_equal(restored, store)


@pytest.mark.parametrize("backend", BACKENDS)
def test_compaction_bounds_chain_and_gc_retires_old_chains(tmp_path,
                                                           backend):
    store = make_store(backend)
    saver = SparseCheckpointSaver(str(tmp_path), keep_max=2,
                                  compact_every=2)
    ids = np.arange(4, dtype=np.int64)
    version = 0
    for _ in range(4):
        for _ in range(3):
            version += 1
            store.push_gradients("t", ids, np.ones((4, 4), np.float32))
            saver.save(version, store)
    # every third save compacts (a base and 2 deltas per chain)
    chains = sorted(os.listdir(str(tmp_path)))
    assert len(chains) == 2, chains
    for chain in chains:
        assert sorted(os.listdir(str(tmp_path / chain))) == [
            "delta-1-embeddings-0-of-1.npz",
            "delta-2-embeddings-0-of-1.npz",
            "embeddings-0-of-1.npz",
        ]
    restored = make_store(backend, seed=1)
    assert SparseCheckpointSaver(str(tmp_path)).restore(restored) == 12
    assert_state_equal(restored, store)


# ---------------------------------------------------------------------------
# torn files and crash windows


def _build_chain(tmp_path, backend, deltas=3):
    store = make_store(backend)
    saver = SparseCheckpointSaver(str(tmp_path), compact_every=10)
    rng = np.random.RandomState(1)
    states = []
    ids = np.arange(10, dtype=np.int64)
    store.push_gradients("t", ids, rng.randn(10, 4).astype(np.float32))
    saver.save(1, store)
    states.append(full_state(store))
    for v in range(2, 2 + deltas):
        store.push_gradients("t", ids[:3],
                             rng.randn(3, 4).astype(np.float32))
        saver.save(v, store)
        states.append(full_state(store))
    return store, states


@pytest.mark.parametrize("backend", BACKENDS)
def test_torn_delta_truncates_chain_to_newest_complete_prefix(tmp_path,
                                                              backend):
    _, states = _build_chain(tmp_path, backend, deltas=3)
    vdir = tmp_path / "version-1"
    path = vdir / "delta-3-embeddings-0-of-1.npz"
    raw = path.read_bytes()
    path.write_bytes(raw[:len(raw) // 2])  # killed mid-write
    assert SparseCheckpointSaver.latest_version(str(tmp_path)) == 3
    restored = make_store(backend, seed=1)
    assert SparseCheckpointSaver(str(tmp_path)).restore(restored) == 3
    np.testing.assert_array_equal(full_state(restored)[1], states[2][1])
    # a gap cuts everything past it: delta-3 intact again, delta-2 gone
    path.write_bytes(raw)
    os.unlink(str(vdir / "delta-2-embeddings-0-of-1.npz"))
    restored2 = make_store(backend, seed=2)
    assert SparseCheckpointSaver(str(tmp_path)).restore(restored2) == 2
    np.testing.assert_array_equal(full_state(restored2)[1], states[1][1])


@pytest.mark.parametrize("backend", BACKENDS)
def test_tmp_files_are_invisible_to_restore_and_completeness(tmp_path,
                                                             backend):
    _, states = _build_chain(tmp_path, backend, deltas=1)
    vdir = tmp_path / "version-1"
    (vdir / "delta-2-embeddings-0-of-1.npz.tmp").write_bytes(b"torn")
    (vdir / "embeddings-9-of-9.npz.tmp").write_bytes(b"torn")
    assert SparseCheckpointSaver.latest_version(str(tmp_path)) == 2
    restored = make_store(backend, seed=1)
    assert SparseCheckpointSaver(str(tmp_path)).restore(restored) == 2
    np.testing.assert_array_equal(full_state(restored)[1], states[1][1])


@pytest.mark.parametrize("backend", BACKENDS)
def test_drop_table_replays_as_table_tombstone(tmp_path, backend):
    """A table dropped after the chain's base does not come back at
    restore: it is absent from the newest delta's table set."""
    store = make_store(backend)
    store.create_table("t2", 4, init_scale=0.0, initializer="zeros")
    ids = np.arange(4, dtype=np.int64)
    store.push_gradients("t", ids, np.ones((4, 4), np.float32))
    store.push_gradients("t2", ids, np.ones((4, 4), np.float32))
    saver = SparseCheckpointSaver(str(tmp_path), compact_every=8)
    saver.save(2, store)
    store.drop_table("t2")
    store.push_gradients("t", ids[:2], np.ones((2, 4), np.float32))
    assert saver.save(3, store).kind == "delta"
    restored = make_store(backend, seed=1)
    assert SparseCheckpointSaver(str(tmp_path)).restore(restored) == 3
    assert restored.table_names() == ["t"]
    assert_state_equal(restored, store)


@pytest.mark.parametrize("backend", BACKENDS)
def test_middle_delta_corruption_latest_version_matches_restore(tmp_path,
                                                                backend):
    _, states = _build_chain(tmp_path, backend, deltas=3)
    path = tmp_path / "version-1" / "delta-2-embeddings-0-of-1.npz"
    raw = path.read_bytes()
    path.write_bytes(raw[:len(raw) // 2])  # delta-3 stays intact
    assert SparseCheckpointSaver.latest_version(str(tmp_path)) == 2
    restored = make_store(backend, seed=1)
    assert SparseCheckpointSaver(str(tmp_path)).restore(restored) == 2
    np.testing.assert_array_equal(full_state(restored)[1], states[1][1])


@pytest.mark.parametrize("backend", BACKENDS)
def test_concurrent_inline_saves_are_serialized(tmp_path, backend):
    """Four threads pushing and saving to one saver: the chain stays
    intact and restores to the live state."""
    store = make_store(backend, "sgd", lr=0.1)
    ids = np.arange(8, dtype=np.int64)
    store.push_gradients("t", ids, np.ones((8, 4), np.float32))
    saver = SparseCheckpointSaver(str(tmp_path), compact_every=100)
    saver.save(1, store)
    errors = []
    barrier = threading.Barrier(4)

    def hammer(tid):
        try:
            barrier.wait(5)
            for i in range(10):
                store.push_gradients("t", ids[:2],
                                     np.ones((2, 4), np.float32))
                saver.save(2 + tid * 10 + i, store)
        except Exception as e:  # collected and asserted below
            errors.append(e)

    threads = [threading.Thread(target=hammer, args=(t,)) for t in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
        assert not t.is_alive()
    assert not errors, errors
    saver.save(999, store)
    restored = make_store(backend, "sgd", seed=1, lr=0.1)
    assert SparseCheckpointSaver(str(tmp_path)).restore(restored) == 999
    assert_state_equal(restored, store)


@pytest.mark.parametrize("backend", BACKENDS)
def test_stale_delta_from_old_generation_never_replays(tmp_path, backend):
    """A full base saved into a version directory that still holds an
    older generation's delta: the chain token keeps that delta out."""
    old = make_store(backend)
    ids = np.arange(5, dtype=np.int64)
    old.push_gradients("t", ids, np.ones((5, 4), np.float32))
    saver1 = SparseCheckpointSaver(str(tmp_path), compact_every=8)
    saver1.save(3, old)
    old.push_gradients("t", ids, np.full((5, 4), 9.0, np.float32))
    assert saver1.save(4, old).kind == "delta"
    new = make_store(backend, seed=1)
    new.push_gradients("t", ids, np.full((5, 4), 0.5, np.float32))
    saver2 = SparseCheckpointSaver(str(tmp_path), compact_every=8)
    saver2.save(3, new, force_full=True)
    assert os.path.exists(
        str(tmp_path / "version-3" / "delta-1-embeddings-0-of-1.npz"))
    assert SparseCheckpointSaver.latest_version(str(tmp_path)) == 3
    restored = make_store(backend, seed=2)
    assert SparseCheckpointSaver(str(tmp_path)).restore(restored) == 3
    assert_state_equal(restored, new)
    new.push_gradients("t", ids[:2], np.ones((2, 4), np.float32))
    assert saver2.save(4, new).kind == "delta"
    restored2 = make_store(backend, seed=3)
    assert SparseCheckpointSaver(str(tmp_path)).restore(restored2) == 4
    assert_state_equal(restored2, new)


@pytest.mark.parametrize("backend", BACKENDS)
def test_crash_mid_compaction_falls_back_to_previous_chain(tmp_path,
                                                           backend):
    _, states = _build_chain(tmp_path, backend, deltas=2)
    vdir = tmp_path / "version-9"
    vdir.mkdir()
    raw = (tmp_path / "version-1" / "embeddings-0-of-1.npz").read_bytes()
    (vdir / "embeddings-0-of-1.npz").write_bytes(raw[:len(raw) // 3])
    restored = make_store(backend, seed=1)
    assert SparseCheckpointSaver(str(tmp_path)).restore(restored) == 3
    np.testing.assert_array_equal(full_state(restored)[1], states[2][1])


# ---------------------------------------------------------------------------
# AsyncCheckpointer


def test_async_checkpointer_coalesces_bursts():
    gate = threading.Event()
    saved = []

    def slow_save(version, kind):
        gate.wait(5.0)
        saved.append((version, kind))

    ckpt = AsyncCheckpointer(slow_save)
    assert ckpt.request(1, "sparse")
    deadline = time.time() + 5
    while not ckpt._in_flight and time.time() < deadline:
        time.sleep(0.01)
    assert ckpt._in_flight
    # 2..5 arrive while 1 saves: one trailing save at the newest
    for v in range(2, 6):
        assert ckpt.request(v, "sparse")
    gate.set()
    assert ckpt.drain(timeout=10)
    assert saved == [(1, "sparse"), (5, "sparse")]
    assert ckpt.coalesced == 3
    ckpt.stop()
    assert not ckpt.request(6, "sparse"), "request after stop"


def test_async_checkpointer_survives_save_failure():
    calls = []

    def flaky(version, kind):
        calls.append(version)
        if version == 1:
            raise RuntimeError("disk full")

    ckpt = AsyncCheckpointer(flaky)
    ckpt.request(1)
    assert ckpt.drain(timeout=10)
    ckpt.request(2)
    assert ckpt.drain(timeout=10)
    assert calls == [1, 2]
    ckpt.stop()


# ---------------------------------------------------------------------------
# the servicer's checkpoint path


def make_servicer(tmp_path, monkeypatch, backend, ckpt_async,
                  checkpoint_steps=0, restored_version=None,
                  compact_every=None):
    monkeypatch.setenv("EDL_CKPT_ASYNC", "1" if ckpt_async else "0")
    if compact_every is not None:
        monkeypatch.setenv("EDL_CKPT_COMPACT_EVERY", str(compact_every))
    store = make_store(backend, "sgd", lr=1.0)
    saver = SparseCheckpointSaver(str(tmp_path))
    servicer = port_servicer.PserverServicer(
        store, use_async=True, checkpoint_saver=saver,
        checkpoint_steps=checkpoint_steps, restored_version=restored_version)
    return servicer, store, saver


def _push_request(module_pb, tensor_mod, ids, value=1.0, version=0):
    ids = np.asarray(ids, np.int64)
    request = module_pb.PushGradientsRequest()
    request.gradients.version = version
    tensor_mod.serialize_indexed_slices(
        np.full((ids.size, 4), value, np.float32), ids,
        request.gradients.embedding_tables["t"])
    return request


def push(servicer, ids, value=1.0):
    return servicer.push_gradients(_push_request(pb, tensor_utils, ids,
                                                 value))


@pytest.mark.parametrize("backend", BACKENDS)
def test_push_path_only_enqueues_and_save_lands_async(tmp_path, monkeypatch,
                                                      backend):
    servicer, store, _ = make_servicer(tmp_path, monkeypatch, backend,
                                       ckpt_async=True, checkpoint_steps=1)
    assert push(servicer, [0, 1]).accepted
    deadline = time.time() + 20
    while (SparseCheckpointSaver.latest_version(str(tmp_path)) != 1
           and time.time() < deadline):
        time.sleep(0.05)
    assert SparseCheckpointSaver.latest_version(str(tmp_path)) == 1
    assert servicer._ckpt_async is not None
    servicer.finish_checkpoints()
    restored = make_store(backend, "sgd", seed=1, lr=1.0)
    SparseCheckpointSaver(str(tmp_path)).restore(restored)
    np.testing.assert_array_equal(
        restored.lookup("t", np.array([0], np.int64)),
        store.lookup("t", np.array([0], np.int64)))


@pytest.mark.parametrize("backend", BACKENDS)
def test_graceful_stop_final_full_save_supersedes_pending(tmp_path,
                                                          monkeypatch,
                                                          backend):
    servicer, store, _ = make_servicer(tmp_path, monkeypatch, backend,
                                       ckpt_async=True, checkpoint_steps=1,
                                       compact_every=8)
    for i in range(4):
        assert push(servicer, [i]).accepted
    servicer.graceful_stop()
    restored = make_store(backend, "sgd", seed=1, lr=1.0)
    assert SparseCheckpointSaver(str(tmp_path)).restore(
        restored) == store.version
    assert_state_equal(restored, store)
    vdir = str(tmp_path / ("version-%d" % store.version))
    assert os.path.exists(os.path.join(vdir, "embeddings-0-of-1.npz")), (
        "the final save must be a full base")


@pytest.mark.parametrize("backend", BACKENDS)
def test_inline_mode_saves_synchronously(tmp_path, monkeypatch, backend):
    servicer, _, _ = make_servicer(tmp_path, monkeypatch, backend,
                                   ckpt_async=False, checkpoint_steps=2)
    assert servicer._ckpt_async is None
    push(servicer, [0])
    assert SparseCheckpointSaver.latest_version(str(tmp_path)) is None
    push(servicer, [1])
    assert SparseCheckpointSaver.latest_version(str(tmp_path)) == 2


# ---------------------------------------------------------------------------
# interop with the reference


def _chain_ops(store, saver, rng, tombstones=True):
    """A base and three deltas: pushes, lazy lookups, writebacks, a row
    drop and a second table dropped before the last delta."""
    store.create_table("u", 2, init_scale=0.1, initializer="uniform")
    ids = np.arange(30, dtype=np.int64)
    store.push_gradients("t", ids, rng.randn(30, 4).astype(np.float32))
    store.push_gradients("u", ids[:10], rng.randn(10, 2).astype(np.float32))
    results = [saver.save(3, store)]
    for v in (4, 5, 6):
        sub = np.unique(rng.randint(0, 45, size=9)).astype(np.int64)
        store.push_gradients("t", sub,
                             rng.randn(sub.size, 4).astype(np.float32))
        store.lookup("t", np.array([100 + v], np.int64))
        store.import_table("t", np.array([200 + v], np.int64),
                           rng.randn(1, 4).astype(np.float32))
        if tombstones:
            store.drop_rows("t", np.array([v, 20 + v], np.int64))
        if v == 6:
            store.drop_table("u")
        results.append(saver.save(v, store))
    return results


def _npz_arrays(path):
    with np.load(path) as data:
        return {key: data[key] for key in data.files}


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("writer", ["port", "ref"])
def test_checkpoint_chain_interoperates_with_reference(tmp_path, writer,
                                                       backend):
    """One package's store and saver write a chain (base, deltas with
    row tombstones, a table dropped); the other package's saver restores
    it into its store of the same kind, bit for bit with the writer's
    live state, at the same version, and both packages'
    ``latest_version`` agree. Then the reader saves a full base of what
    it restored and the writer's package restores that, bit for bit."""
    reader = "ref" if writer == "port" else "port"
    rng = np.random.RandomState(5)
    live = make_store(backend, pkg=writer, seed=4, initializer="uniform",
                      lr=0.05)
    ckpt = str(tmp_path / "chain")
    results = _chain_ops(live, SAVERS[writer](ckpt, shard_id=0, shard_num=1,
                                              compact_every=8), rng)
    assert [r.kind for r in results] == ["full", "delta", "delta", "delta"]
    assert (SAVERS["port"].latest_version(ckpt)
            == SAVERS["ref"].latest_version(ckpt) == 6)
    restored = make_store(backend, pkg=reader, seed=8,
                          initializer="uniform", lr=0.05)
    assert SAVERS[reader](ckpt).restore(restored) == 6
    assert restored.table_names() == live.table_names() == ["t"]
    assert_state_equal(restored, live)
    assert restored.dirty_count("t") == 0
    back = str(tmp_path / "back")
    SAVERS[reader](back).save(6, restored)
    again = make_store(backend, pkg=writer, seed=9, initializer="uniform",
                       lr=0.05)
    assert SAVERS[writer](back).restore(again) == 6
    assert_state_equal(again, live)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("restore_shards", [1, 2])
def test_savers_write_the_reference_arrays(tmp_path, backend,
                                           restore_shards):
    """The port's saver and the reference's, each on its own package's
    store after the same operations, write the same files holding the
    same arrays (all but the random chain token, which each delta
    repeats from its base); each directory restored into
    ``restore_shards`` shards gives the same rows per shard."""
    for pkg in ("port", "ref"):
        rng = np.random.RandomState(6)
        store = make_store(backend, pkg=pkg, seed=2, initializer="uniform",
                           lr=0.05)
        _chain_ops(store, SAVERS[pkg](str(tmp_path / pkg),
                                      compact_every=8), rng)
    files = {pkg: sorted(os.path.relpath(os.path.join(d, f),
                                         str(tmp_path / pkg))
                         for d, _, fs in os.walk(str(tmp_path / pkg))
                         for f in fs)
             for pkg in ("port", "ref")}
    assert files["port"] == files["ref"] and len(files["port"]) == 4
    for rel in files["port"]:
        got = _npz_arrays(str(tmp_path / "port" / rel))
        want = _npz_arrays(str(tmp_path / "ref" / rel))
        assert sorted(got) == sorted(want), rel
        for key in want:
            if key == "__chain_token__":
                assert str(got[key]) != str(want[key])
            elif key.startswith(("ids/", "fullrows/", "steps/")):
                # a native base exports in hash-map order: compare by id
                ids_key = "ids/" + key.split("/", 1)[1]
                np.testing.assert_array_equal(
                    got[key][np.argsort(got[ids_key])],
                    want[key][np.argsort(want[ids_key])])
            else:
                np.testing.assert_array_equal(got[key], want[key])
    for shard_id in range(restore_shards):
        shards = []
        for pkg in ("port", "ref"):
            store = make_store(backend, pkg="port", seed=7)
            assert SparseCheckpointSaver(
                str(tmp_path / pkg), shard_id=shard_id,
                shard_num=restore_shards).restore(store) == 6
            shards.append(store)
        assert_state_equal(*shards)
        resident = full_state(shards[0])[0]
        assert resident.size and all(
            i % restore_shards == shard_id for i in resident)


# ---------------------------------------------------------------------------
# the boot-restore stamp


@pytest.mark.parametrize("restored_version", [None, 0, 5])
def test_restored_stamp_on_every_response_matches_reference(
        restored_version):
    """A servicer built with ``restored_version`` answers every push
    (accepted, rejected stale, and tier writeback) and every batch and
    dense pull with the stamp version + 1 (0 without a restore): the
    port's responses are byte for byte the reference servicer's on the
    same store kind, seed and requests."""
    answers = {}
    for pkg, (module_pb, tensor_mod, cls) in {
        "port": (pb, tensor_utils, port_servicer.PserverServicer),
        "ref": (ref_pb, ref_tensor_utils, ref_servicer.PserverServicer),
    }.items():
        store = make_store("numpy", "sgd", pkg=pkg, lr=0.5)
        store.set_version(restored_version or 0)
        servicer = cls(store, use_async=False, grads_to_wait=1,
                       restored_version=restored_version)
        base = restored_version or 0
        pull = module_pb.BatchedSlices()
        pull.tables["t"].ids_blob = tensor_mod.pack_ids(
            np.arange(3, dtype=np.int64))
        rows = module_pb.Model()
        tensor_mod.serialize_indexed_slices(
            np.full((2, 4), 3.0, np.float32), np.array([7, 8], np.int64),
            rows.embedding_tables["t"])
        answers[pkg] = [
            servicer.push_gradients(_push_request(
                module_pb, tensor_mod, [0, 1], version=base)),
            servicer.push_gradients(_push_request(
                module_pb, tensor_mod, [0], version=base - 1)),
            servicer.push_embedding_rows(rows),
            servicer.pull_embedding_batch(pull),
            servicer.pull_dense_parameters(
                module_pb.PullDenseParametersRequest(version=-1)),
        ]
        want = restored_version + 1 if restored_version is not None else 0
        assert [a.restored_version for a in answers[pkg]] == [want] * 5
        assert answers[pkg][0].accepted and not answers[pkg][1].accepted
    for got, want in zip(answers["port"], answers["ref"]):
        assert got.SerializeToString() == want.SerializeToString()

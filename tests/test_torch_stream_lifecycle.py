"""The port's embedding lifecycle (stream/lifecycle.py) and the PS
servicer's lifecycle hooks, held against the reference on the CPU.

(a) every lifecycle scenario of tests/test_stream.py (sketch counts,
drop_rows/drop_table, eviction through a checkpoint round trip,
admission after k sightings, cold-row pulls, TTL and LFU, import
re-admission, the re-anchor on restore, numpy-native parity, eviction
through the HotRowCache), run on both packages through a ``side``
parameter; (b) parity: the same seeded id sequences go through both
packages' servicers and lifecycles (numpy store against numpy store,
native against native), and after every push, pull and sweep the
admitted id sets, each admitted id's [frequency, last seen], the
sketch's cells, the sweep's evicted id sets and the surviving rows
(weights, slots, step counts) are equal bit for bit; (c) the port's two
differences: an import refreshes the TTL stamp but not the LFU guard,
and a writeback's sightings join its rows' LFU frequency.
"""

import importlib
import types

import numpy as np
import pytest

PACKAGES = {"ref": "elasticdl_tpu", "port": "elasticdl_tpu_torch"}
BACKENDS = ["numpy", "native"]


def modules(side):
    root = PACKAGES[side]

    def mod(name):
        return importlib.import_module("%s.%s" % (root, name))

    return types.SimpleNamespace(
        side=side,
        pb=mod("proto.elasticdl_tpu_pb2"),
        tensor_utils=mod("common.tensor_utils"),
        store=mod("ps.embedding_store"),
        servicer=mod("ps.servicer"),
        lifecycle=mod("stream.lifecycle"),
        checkpoint=mod("ps.checkpoint"),
        client=mod("embedding.client"),
    )


@pytest.fixture(params=sorted(PACKAGES))
def m(request):
    return modules(request.param)


def make_store(m, backend, seed=0, opt_type="adam", lr=0.01):
    if backend == "native":
        if m.store.native_lib() is None:
            pytest.skip("native embedding store unavailable")
        store = m.store.NativeEmbeddingStore(seed=seed)
    else:
        store = m.store.NumpyEmbeddingStore(seed=seed)
    store.set_optimizer(opt_type, lr=lr)
    return store


def make_servicer(m, backend="numpy", admit_k=2, max_rows=0, ttl_secs=0.0,
                  clock=None, lfu_decay=1.0):
    store = make_store(m, backend, opt_type="sgd", lr=1.0)
    lc = m.lifecycle.EmbeddingLifecycle(
        store, admit_k=admit_k, max_rows=max_rows, ttl_secs=ttl_secs,
        lfu_decay=lfu_decay, clock=clock or (lambda: 0.0),
    )
    servicer = m.servicer.PserverServicer(
        store, use_async=True, lifecycle=lc, staleness_modulation=False,
    )
    infos = m.pb.Model()
    infos.embedding_table_infos.add(name="t", dim=2, initializer="zeros")
    servicer.push_embedding_table_infos(infos)
    return servicer, store, lc


def push(m, servicer, ids, value=1.0):
    request = m.pb.PushGradientsRequest()
    m.tensor_utils.serialize_indexed_slices(
        np.full((len(ids), 2), value, np.float32),
        np.asarray(ids, np.int64),
        request.gradients.embedding_tables["t"],
    )
    return servicer.push_gradients(request)


def pull(m, servicer, ids):
    request = m.pb.PullEmbeddingVectorsRequest(name="t")
    request.ids_blob = np.asarray(ids, "<i8").tobytes()
    return m.tensor_utils.blob_to_ndarray(
        servicer.pull_embedding_vectors(request))


# ---------------------------------------------------------------------
# (a) the reference's scenarios, on both packages


def test_sketch_counts_and_conservative_update(m):
    sketch = m.lifecycle.CountMinSketch(width=1 << 12, depth=4)
    ids = np.arange(100, dtype=np.int64)
    est = sketch.add(ids, np.ones(100, dtype=np.int64))
    assert (est >= 1).all()
    est = sketch.add(ids[:10], np.full(10, 3, dtype=np.int64))
    assert (est >= 4).all()
    sketch.halve()
    est = sketch.add(ids[:10], np.ones(10, dtype=np.int64))
    assert (est >= 3).all()
    sketch.clear()
    est = sketch.add(np.array([7], dtype=np.int64),
                     np.array([1], dtype=np.int64))
    assert est[0] == 1


def test_sketch_cells_equal_across_packages():
    rng = np.random.RandomState(3)
    sketches = {side: modules(side).lifecycle.CountMinSketch(
        width=1 << 10, depth=4) for side in PACKAGES}
    for step in range(20):
        ids = np.unique(rng.zipf(1.3, size=200).astype(np.int64))
        counts = rng.randint(1, 5, size=ids.size).astype(np.int64)
        ests = {side: s.add(ids, counts) for side, s in sketches.items()}
        np.testing.assert_array_equal(ests["ref"], ests["port"])
        if step % 7 == 6:
            for s in sketches.values():
                s.halve()
    np.testing.assert_array_equal(sketches["ref"]._cells,
                                  sketches["port"]._cells)


@pytest.mark.parametrize("backend", BACKENDS)
def test_drop_rows_resets_full_row_state(m, backend):
    store = make_store(m, backend)
    store.create_table("t", 4, initializer="zeros")
    ids = np.arange(8, dtype=np.int64)
    for _ in range(3):
        store.push_gradients("t", ids, np.ones((8, 4), np.float32))
    assert not np.allclose(store.lookup("t", [2]), 0.0)
    assert store.drop_rows("t", [2, 5, 99]) == 2
    assert store.table_size("t") == 6
    store.push_gradients("t", np.array([2], np.int64),
                         np.ones((1, 4), np.float32))
    virgin = make_store(m, backend)
    virgin.create_table("t", 4, initializer="zeros")
    virgin.push_gradients("t", np.array([2], np.int64),
                          np.ones((1, 4), np.float32))
    np.testing.assert_array_equal(store.lookup("t", [2]),
                                  virgin.lookup("t", [2]))


@pytest.mark.parametrize("backend", BACKENDS)
def test_eviction_survives_checkpoint_roundtrip(m, backend, tmp_path):
    store = make_store(m, backend)
    store.create_table("t", 4, initializer="zeros")
    ids = np.arange(10, dtype=np.int64)
    for _ in range(2):
        store.push_gradients(
            "t", ids,
            np.random.RandomState(0).rand(10, 4).astype(np.float32))
    store.drop_rows("t", [1, 3, 5])
    m.checkpoint.SparseCheckpointSaver(str(tmp_path)).save(7, store)
    restored = make_store(m, backend)
    version = m.checkpoint.SparseCheckpointSaver(
        str(tmp_path)).restore(restored)
    assert version == 7
    assert restored.table_size("t") == 7
    want = store.export_table_full("t")
    got = restored.export_table_full("t")
    order_w, order_g = np.argsort(want[0]), np.argsort(got[0])
    for w, g in zip(want, got):
        np.testing.assert_array_equal(w[order_w], g[order_g])
    assert 3 not in set(got[0].tolist())


@pytest.mark.parametrize("backend", BACKENDS)
def test_drop_table(m, backend):
    store = make_store(m, backend)
    store.create_table("t", 4)
    store.lookup("t", [1, 2])
    store.drop_table("t")
    assert "t" not in store.table_names()
    with pytest.raises(KeyError):
        store.drop_table("t")


def test_admission_after_k_sightings_drops_preadmission_grads(m):
    servicer, store, lc = make_servicer(m, admit_k=3)
    push(m, servicer, [1, 2])
    push(m, servicer, [1, 2])
    assert store.table_size("t") == 0
    assert lc.stats()["grad_rows_dropped"] == 4
    push(m, servicer, [1, 2])
    assert store.table_size("t") == 2
    np.testing.assert_allclose(pull(m, servicer, [1]), [[-1.0, -1.0]])


def test_preadmission_pull_serves_cold_row_without_materializing(m):
    servicer, store, lc = make_servicer(m, admit_k=4)
    np.testing.assert_allclose(pull(m, servicer, [5, 6]), 0.0)
    assert store.table_size("t") == 0, "a pull must not materialize"
    infos = m.pb.Model()
    infos.embedding_table_infos.add(name="c", dim=2,
                                    initializer="constant:1.5")
    servicer.push_embedding_table_infos(infos)
    request = m.pb.PullEmbeddingVectorsRequest(name="c")
    request.ids_blob = np.asarray([9], "<i8").tobytes()
    np.testing.assert_allclose(
        m.tensor_utils.blob_to_ndarray(
            servicer.pull_embedding_vectors(request)), 1.5)


def test_pull_sightings_count_toward_admission(m):
    servicer, store, lc = make_servicer(m, admit_k=3)
    for _ in range(3):
        pull(m, servicer, [7])
    assert store.table_size("t") == 1


def test_ttl_eviction_and_clean_readmission(m):
    clock = [0.0]
    servicer, store, lc = make_servicer(m, admit_k=2, ttl_secs=10.0,
                                        clock=lambda: clock[0])
    push(m, servicer, [1])
    push(m, servicer, [1])
    assert store.table_size("t") == 1
    clock[0] = 100.0
    assert servicer.lifecycle_tick() == {"ttl": 1, "lfu": 0}
    assert store.table_size("t") == 0
    push(m, servicer, [1])
    assert store.table_size("t") == 1
    np.testing.assert_allclose(pull(m, servicer, [1]), [[-1.0, -1.0]])
    clock[0] = 200.0
    assert servicer.lifecycle_tick()["ttl"] == 1
    servicer.lifecycle_tick()
    push(m, servicer, [1])
    assert store.table_size("t") == 0
    push(m, servicer, [1])
    assert store.table_size("t") == 1
    stats = lc.stats()
    assert stats["rows_admitted"] == 3
    assert stats["rows_evicted_ttl"] == 2


def test_lfu_eviction_keeps_hot_rows_and_respects_bound(m):
    clock = [0.0]
    servicer, store, lc = make_servicer(m, admit_k=1, max_rows=3,
                                        clock=lambda: clock[0])
    for _ in range(4):
        push(m, servicer, [1, 2])
    push(m, servicer, [3, 4, 5])
    assert store.table_size("t") == 5
    assert servicer.lifecycle_tick() == {"ttl": 0, "lfu": 0}
    clock[0] = 5.0
    assert servicer.lifecycle_tick()["lfu"] == 2
    assert store.table_size("t") == 3
    assert {1, 2} <= set(store.export_table("t")[0].tolist())
    assert lc.stats()["resident_rows"] == 3


def test_import_readmits_and_refreshes_ttl(m):
    clock = [0.0]
    servicer, store, lc = make_servicer(m, admit_k=5, ttl_secs=10.0,
                                        clock=lambda: clock[0])
    request = m.pb.Model()
    m.tensor_utils.serialize_indexed_slices(
        np.full((2, 2), 7.0, np.float32), np.array([11, 12], np.int64),
        request.embedding_tables["t"],
    )
    servicer.push_embedding_rows(request)
    assert store.table_size("t") == 2
    assert lc.stats()["resident_rows"] == 2
    np.testing.assert_allclose(pull(m, servicer, [11]), 7.0)
    clock[0] = 5.0
    assert servicer.lifecycle_tick() == {"ttl": 0, "lfu": 0}
    clock[0] = 50.0
    assert servicer.lifecycle_tick()["ttl"] == 2


def _import_rows(m, servicer, ids):
    request = m.pb.Model()
    m.tensor_utils.serialize_indexed_slices(
        np.full((len(ids), 2), 3.0, np.float32), np.asarray(ids, np.int64),
        request.embedding_tables["t"])
    servicer.push_embedding_rows(request)


def test_reassert_does_not_shield_rows_from_the_bound():
    """A device-tier boundary re-asserts every resident row through
    push_embedding_rows. In the reference the import stamps the rows as
    just touched, so the next sweep may not evict them for
    EDL_EMB_LFU_PROTECT_SECS (1 s by default) and the row bound breaks
    by the re-asserted rows. In the port an import refreshes the TTL
    stamp only: the sweep right after it cuts the table to the bound,
    while an id a push touched in the same second stays protected and
    the re-asserted rows keep their TTL."""
    resident = {}
    for side in sorted(PACKAGES):
        m = modules(side)
        clock = [0.0]
        servicer, store, lc = make_servicer(m, admit_k=1, max_rows=4,
                                            ttl_secs=30.0,
                                            clock=lambda: clock[0])
        push(m, servicer, [1, 2, 3, 4, 5, 6])
        clock[0] = 10.0
        assert servicer.lifecycle_tick()["lfu"] == 2
        _import_rows(m, servicer, [1, 2, 3, 4, 7, 8])   # the re-assert
        push(m, servicer, [9])                          # in flight
        assert lc.stats()["resident_rows"] == 9
        servicer.lifecycle_tick()
        admitted = set(lc._tables["t"].admitted)
        assert 9 in admitted
        resident[side] = len(admitted)
        if side == "port":
            assert admitted == set(store.export_table("t")[0].tolist())
            # the sweep's own count: the bound, one of it in flight
            assert lc.last_sweep_rows == {"t": [4, 1]}
            # the survivors' TTL stamps are the import's
            clock[0] = 35.0
            assert servicer.lifecycle_tick()["ttl"] == 0
            clock[0] = 41.0
            assert servicer.lifecycle_tick()["ttl"] == len(admitted)
    assert resident == {"ref": 7, "port": 4}


def test_writeback_sightings_rank_reasserted_rows_under_the_bound():
    """The port's addition: a writeback's sightings (the hits a device
    tier served since it last wrote each row back, carried in the
    request's ``dense_parameters[table]``) join each row's LFU
    frequency, so the sweep after a re-assert cuts the rows the tier
    used least. Without sightings every re-asserted row weighs the
    same and the cut falls by id, here on the rows the tier used most;
    a later writeback's sightings add to a resident row's."""
    m = modules("port")
    kept = {}
    for sighted in (False, True):
        clock = [0.0]
        servicer, store, lc = make_servicer(m, admit_k=1, max_rows=3,
                                            clock=lambda: clock[0])
        request = m.pb.Model()
        m.tensor_utils.serialize_indexed_slices(
            np.full((6, 2), 3.0, np.float32),
            np.array([1, 2, 3, 4, 5, 6], np.int64),
            request.embedding_tables["t"])
        if sighted:
            m.tensor_utils.ndarray_to_blob(
                np.array([8, 6, 4, 0, 0, 0], np.int64),
                request.dense_parameters["t"])
        servicer.push_embedding_rows(request)
        clock[0] = 5.0
        assert servicer.lifecycle_tick()["lfu"] == 3
        kept[sighted] = sorted(store.export_table("t")[0].tolist())
        if sighted:
            again = m.pb.Model()
            m.tensor_utils.serialize_indexed_slices(
                np.full((1, 2), 3.0, np.float32), np.array([3], np.int64),
                again.embedding_tables["t"])
            m.tensor_utils.ndarray_to_blob(np.array([2], np.int64),
                                           again.dense_parameters["t"])
            servicer.push_embedding_rows(again)
            freq = {i: e[0] for i, e in lc._tables["t"].admitted.items()}
            assert freq == {1: 9.0, 2: 7.0, 3: 7.0}
    assert kept == {False: [4, 5, 6], True: [1, 2, 3]}


def test_restore_reanchors_conservatively(m, tmp_path):
    servicer, store, lc = make_servicer(m, admit_k=2)
    for _ in range(2):
        push(m, servicer, [1, 2, 3])
    store.drop_rows("t", [3])
    lc.filter_push("t", np.array([50], np.int64))
    m.checkpoint.SparseCheckpointSaver(str(tmp_path)).save(3, store)
    store2 = make_store(m, "numpy", opt_type="sgd", lr=1.0)
    assert m.checkpoint.SparseCheckpointSaver(
        str(tmp_path)).restore(store2) == 3
    lc2 = m.lifecycle.EmbeddingLifecycle(store2, admit_k=2,
                                         clock=lambda: 0.0)
    for name in store2.table_names():
        lc2.register_table(name, store2.table_dim(name))
    lc2.adopt_store()
    servicer2 = m.servicer.PserverServicer(store2, use_async=True,
                                           lifecycle=lc2)
    assert lc2.stats()["resident_rows"] == 2
    np.testing.assert_allclose(pull(m, servicer2, [1]), [[-1.0, -1.0]])
    np.testing.assert_allclose(pull(m, servicer2, [3]), 0.0)
    assert store2.table_size("t") == 2
    push(m, servicer2, [50])
    assert store2.table_size("t") == 2
    push(m, servicer2, [50])
    assert store2.table_size("t") == 3


def test_lifecycle_parity_numpy_native(m):
    if m.store.native_lib() is None:
        pytest.skip("native embedding store unavailable")
    clock = [0.0]
    runs = {}
    for backend in BACKENDS:
        clock[0] = 0.0
        servicer, store, lc = make_servicer(
            m, backend=backend, admit_k=2, max_rows=6, ttl_secs=100.0,
            clock=lambda: clock[0])
        rng = np.random.RandomState(7)
        for step in range(30):
            push(m, servicer, (rng.zipf(1.5, size=8) % 20).tolist(),
                 value=0.25)
            pull(m, servicer, (rng.zipf(1.5, size=4) % 25).tolist())
            clock[0] += 1.0
            if step % 10 == 9:
                servicer.lifecycle_tick()
        ids, rows, steps = store.export_table_full("t")
        order = np.argsort(ids)
        runs[backend] = (ids[order], rows[order], steps[order], lc.stats())
    for i in range(3):
        np.testing.assert_array_equal(runs["numpy"][i], runs["native"][i])
    assert runs["numpy"][3] == runs["native"][3]


def test_eviction_converges_through_hot_row_cache(m):
    clock = [0.0]
    servicer, store, lc = make_servicer(m, admit_k=1, ttl_secs=10.0,
                                        clock=lambda: clock[0])
    push(m, servicer, [1])
    cache = m.client.HotRowCache(staleness=1)
    cache.advance()
    unique = np.array([1], np.int64)
    cache.put("t", unique, pull(m, servicer, [1]))
    clock[0] = 100.0
    assert servicer.lifecycle_tick()["ttl"] == 1
    mask, _rows = cache.split("t", unique)
    assert mask.all()
    cache.advance()
    cache.advance()
    mask, _rows = cache.split("t", unique)
    assert not mask.any()
    np.testing.assert_allclose(pull(m, servicer, [1]), 0.0)


# ---------------------------------------------------------------------
# (b) parity: one seeded sequence through both packages


def _books(lc):
    """{table: {id: [frequency, last seen]}} and the sketch's cells (the
    port's entries carry a third field, the LFU guard, left out here)."""
    return ({name: {i: list(v[:2]) for i, v in state.admitted.items()}
             for name, state in lc._tables.items()},
            lc._sketch._cells.copy())


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("decay", [1.0, 0.9])
def test_lifecycle_books_equal_across_packages(backend, decay):
    """Pushes (async and through a writeback), pulls and sweeps of a
    drifting Zipf stream: after every operation both packages hold the
    same admitted ids with the same [frequency, last seen], the same
    sketch cells and the same surviving rows; every sweep evicts the
    same id set for the same reason. The writebacks land three ticks
    before a sweep, past the reference's 1 s LFU protection, which an
    import grants there and not in the port: the difference
    ``test_reassert_does_not_shield_rows_from_the_bound`` pins."""
    clock = [0.0]
    sides = {}
    for side in PACKAGES:
        m = modules(side)
        sides[side] = (m,) + make_servicer(
            m, backend=backend, admit_k=2, max_rows=40, ttl_secs=25.0,
            clock=lambda: clock[0], lfu_decay=decay)
    rng = np.random.RandomState(11)
    for step in range(60):
        drift = step * 3
        push_ids = (rng.zipf(1.3, size=24) % 50 + drift).tolist()
        pull_ids = (rng.zipf(1.3, size=12) % 60 + drift).tolist()
        rows_ids = np.unique(rng.randint(drift, drift + 30, size=4))
        values = rng.rand(rows_ids.size, 2).astype(np.float32)
        do_sweep = step % 6 == 5
        evicted = {}
        for side, (m, servicer, store, lc) in sides.items():
            push(m, servicer, push_ids, value=0.125)
            pull(m, servicer, pull_ids)
            if step % 6 == 2:
                request = m.pb.Model()
                m.tensor_utils.serialize_indexed_slices(
                    values, rows_ids, request.embedding_tables["t"])
                servicer.push_embedding_rows(request)
            if do_sweep:
                before = set(lc._tables["t"].admitted)
                swept = servicer.lifecycle_tick()
                evicted[side] = (swept, before - set(lc._tables["t"].admitted))
        clock[0] += 1.0
        if do_sweep:
            assert evicted["ref"] == evicted["port"], step
        books = {side: _books(v[3]) for side, v in sides.items()}
        assert books["ref"][0] == books["port"][0], step
        np.testing.assert_array_equal(books["ref"][1], books["port"][1])
        states = {}
        for side, (m, servicer, store, lc) in sides.items():
            ids, rows, steps = store.export_table_full("t")
            order = np.argsort(ids)
            states[side] = (ids[order], rows[order], steps[order])
        for got, want in zip(states["port"], states["ref"]):
            np.testing.assert_array_equal(got, want)
        assert sides["ref"][3].stats() == sides["port"][3].stats()
    # the regime the lifecycle exists for was reached
    stats = sides["port"][3].stats()
    assert stats["rows_evicted_lfu"] > 0
    assert stats["grad_rows_dropped"] > 0


@pytest.mark.parametrize("backend", BACKENDS)
def test_sync_round_admission_equal_across_packages(backend):
    """The sync PS merges a round first and gates the merged ids under
    the push lock: same admitted rows and dropped counts as the
    reference."""
    results = {}
    for side in PACKAGES:
        m = modules(side)
        store = make_store(m, backend, opt_type="sgd", lr=1.0)
        lc = m.lifecycle.EmbeddingLifecycle(store, admit_k=3,
                                            clock=lambda: 0.0)
        servicer = m.servicer.PserverServicer(
            store, use_async=False, grads_to_wait=2, lifecycle=lc,
            staleness_modulation=False)
        infos = m.pb.Model()
        infos.embedding_table_infos.add(name="t", dim=2,
                                        initializer="zeros")
        servicer.push_embedding_table_infos(infos)
        rng = np.random.RandomState(5)
        for _ in range(12):
            request = m.pb.PushGradientsRequest()
            ids = rng.randint(0, 15, size=6).astype(np.int64)
            m.tensor_utils.serialize_indexed_slices(
                rng.rand(6, 2).astype(np.float32), ids,
                request.gradients.embedding_tables["t"])
            request.gradients.version = store.version
            servicer.push_gradients(request)
        ids, rows, steps = store.export_table_full("t")
        order = np.argsort(ids)
        results[side] = (ids[order], rows[order], steps[order],
                         lc.stats(), _books(lc)[0])
    for i in range(3):
        np.testing.assert_array_equal(results["port"][i], results["ref"][i])
    assert results["port"][3] == results["ref"][3]
    assert results["port"][4] == results["ref"][4]


def test_maybe_create_reads_the_same_knobs(monkeypatch):
    for side in PACKAGES:
        m = modules(side)
        store = make_store(m, "numpy")
        monkeypatch.delenv("EDL_EMB_ADMIT_K", raising=False)
        monkeypatch.delenv("EDL_EMB_MAX_ROWS", raising=False)
        monkeypatch.delenv("EDL_EMB_TTL_SECS", raising=False)
        assert m.lifecycle.EmbeddingLifecycle.maybe_create(store) is None
        monkeypatch.setenv("EDL_EMB_ADMIT_K", "2")
        monkeypatch.setenv("EDL_EMB_MAX_ROWS", "100")
        monkeypatch.setenv("EDL_EMB_LFU_DECAY", "0.9")
        lc = m.lifecycle.EmbeddingLifecycle.maybe_create(store)
        assert (lc.admit_k, lc.max_rows, lc.lfu_decay, lc.ttl_secs) == (
            2, 100, 0.9, 0.0)

"""The port's native embedding store (``ps/embedding_store.py``'s
``NativeEmbeddingStore`` over ``native/embedding_store.cc``), on the CPU.

(a) against the port's numpy store, bit for bit, for every optimizer
under the deterministic initializers (a native and a numpy store draw
lazy rows from other random streams); (b) against the reference's
native store, bit for bit, under every initializer (one C++ source, one
seed); (c) import and lookup; (d) the loader: the ABI check, the logged
fallback of ``create_store``, one build shared by every process; (e)
DeepFM's PS state after several steps on the native store against the
reference's on its native store. Inputs are made with numpy from a seed.
"""

import json
import logging
import os
import subprocess
import sys

import numpy as np
import pytest

from elasticdl_tpu.ps import embedding_store as ref_store
from elasticdl_tpu_torch.ps import embedding_store as port_store
from elasticdl_tpu_torch.ps.local_client import LocalPSClient
from tests.test_torch_sparse import (
    ADAM_EPS,
    INITIALIZERS,
    STATE_RTOL,
    STEPS,
    STORE_OPTS,
    assert_stores_equal,
    make_batches,
    trainer_pair,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _stores(pairs, opt_type, initializer, seed=3):
    """One store per (module, class name) of ``pairs``, each with
    optimizer ``opt_type`` (lr 0.05) and tables "a" (d 8) and "b" (d 1)
    under ``initializer``."""
    stores = []
    for module, cls in pairs:
        store = getattr(module, cls)(seed=seed)
        store.set_optimizer(opt_type, lr=0.05)
        store.create_table("a", 8, init_scale=0.1, initializer=initializer)
        store.create_table("b", 1, init_scale=0.2, initializer=initializer)
        stores.append(store)
    return stores


def _drive(stores, seed=7, rounds=4):
    """The same lookups and pushes on every store: lookups (new and
    known ids), a push of unique ids (the numpy store's vectorized
    apply), a push with a duplicate id (its per-id apply) and one with
    ``lr_scale``. Returns each store's looked-up rows."""
    rng = np.random.RandomState(seed)
    looked = [[] for _ in stores]
    for _ in range(rounds):
        lookup_ids = rng.randint(0, 50, size=12)
        unique_ids = rng.permutation(60)[:9]
        dup_ids = rng.randint(0, 60, size=7)
        dup_ids[1] = dup_ids[0]
        grads = {name: rng.randn(n, dim).astype(np.float32)
                 for name, n, dim in (("u8", 9, 8), ("u1", 9, 1),
                                      ("d8", 7, 8), ("d1", 7, 1))}
        for store, rows in zip(stores, looked):
            rows.append(store.lookup("a", lookup_ids))
            rows.append(store.lookup("b", lookup_ids[::-1]))
            store.push_gradients("a", unique_ids, grads["u8"])
            store.push_gradients("b", unique_ids, grads["u1"],
                                 lr_scale=0.25)
            store.push_gradients("a", dup_ids, grads["d8"])
            store.push_gradients("b", dup_ids, grads["d1"], lr_scale=0.5)
            store.bump_version()
    return looked


def _sorted_state(store, table):
    ids, rows, steps = store.export_table_full(table)
    order = np.argsort(ids)
    return ids[order], rows[order], steps[order]


# ---------------------------------------------------------------------
# (a) native against numpy, (b) native against the reference's native


@pytest.mark.parametrize("initializer", ["constant", "zeros"])
@pytest.mark.parametrize("opt_type", STORE_OPTS)
def test_native_matches_numpy_store_bit_for_bit(opt_type, initializer):
    """Lookups, unique and duplicate-id pushes and an lr_scale push give
    the numpy store's rows, optimizer slots and step counts bit for bit
    (rows exported in id order: the native store's export follows its
    hash map, the numpy store's the creation order)."""
    native, numpy_store = _stores(
        [(port_store, "NativeEmbeddingStore"),
         (port_store, "NumpyEmbeddingStore")], opt_type, initializer)
    got, want = _drive([native, numpy_store])
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    for table in ("a", "b"):
        for a, b in zip(_sorted_state(native, table),
                        _sorted_state(numpy_store, table)):
            np.testing.assert_array_equal(a, b, err_msg=table)
        assert native.table_size(table) == numpy_store.table_size(table)
    assert native.version == numpy_store.version == 4


@pytest.mark.parametrize("opt_type", ["sgd", "adam"])
@pytest.mark.parametrize("initializer", INITIALIZERS)
def test_native_matches_reference_native_store(initializer, opt_type):
    """The port's copy of the C++ store and the reference's, from one
    seed, give the same rows bit for bit under every initializer, the
    random ones included, and export them in the same order."""
    port, ref = _stores([(port_store, "NativeEmbeddingStore"),
                         (ref_store, "NativeEmbeddingStore")],
                        opt_type, initializer)
    got, want = _drive([port, ref])
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert_stores_equal(ref, port, ("a", "b"))


# ---------------------------------------------------------------------
# (c) import and lookup, and the stores' shared surface


@pytest.mark.parametrize("cls", ["NativeEmbeddingStore",
                                 "NumpyEmbeddingStore"])
def test_import_table_then_lookup_round_trips(cls):
    """Imported rows read back as written, for ids seen before and ids
    never seen (materialised, then overwritten); a later import of an id
    overwrites again; the rest of the surface agrees between stores."""
    store = getattr(port_store, cls)(seed=5)
    store.set_optimizer("adam", lr=0.1)
    store.create_table("t", 4, init_scale=0.3)
    store.create_table("w", 1, initializer="zeros")
    rng = np.random.RandomState(2)
    store.lookup("t", [1, 2, 3])
    ids = np.array([2, 40, 7, 3], np.int64)
    rows = rng.randn(4, 4).astype(np.float32)
    store.import_table("t", ids, rows)
    np.testing.assert_array_equal(store.lookup("t", ids), rows)
    again = rng.randn(1, 4).astype(np.float32)
    store.import_table("t", ids[1:2], again)
    np.testing.assert_array_equal(store.lookup("t", [40]), again)
    assert store.table_size("t") == 5
    assert sorted(store.table_names()) == ["t", "w"]
    assert store.table_dim("t") == 4 and store.table_dim("w") == 1
    assert store.opt_type == "adam"
    ids_out, full, steps = store.export_table_full("t")
    assert full.shape == (5, 4 * 3) and steps.tolist() == [0] * 5
    np.testing.assert_array_equal(full[list(ids_out).index(7), :4], rows[2])
    with pytest.raises(RuntimeError, match="tables exist"):
        store.set_optimizer("sgd")
    with pytest.raises(ValueError, match="different dim"):
        store.create_table("t", 5)
    with pytest.raises(KeyError):
        store.lookup("nope", [1])
    with pytest.raises(ValueError, match="unsupported"):
        getattr(port_store, cls)(seed=0).set_optimizer("lamb")


# ---------------------------------------------------------------------
# (d) the loader


def test_abi_check_refuses_another_clock(monkeypatch):
    """The built library reports the ABI this binding targets; a library
    reporting another clock is refused with the reason, and one without
    the symbol reads as no clock."""
    lib = port_store.native_lib()
    assert lib is not None
    assert port_store._abi_of(lib) == port_store.EXPECTED_ABI == 4

    class NoClock:
        pass

    assert port_store._abi_of(NoClock()) is None
    monkeypatch.setattr(port_store, "_abi_of", lambda lib: 3)
    with pytest.raises(RuntimeError, match="ABI 3"):
        port_store.load_native()


def test_unloadable_library_is_rebuilt_once(tmp_path, caplog):
    """A file at the library's hashed name that does not load (cut
    short) is removed and built once more, with a warning; the rebuilt
    library loads and reports the ABI."""
    path = port_store.native_library_path(str(tmp_path))
    with open(path, "wb") as f:
        f.write(b"not a shared library")
    with caplog.at_level(logging.WARNING):
        lib, loaded = port_store.load_native(str(tmp_path))
    assert loaded == path and port_store._abi_of(lib) == 4
    assert "building it once more" in caplog.text


def test_create_store_returns_native_here_and_falls_back_logged(
        monkeypatch, caplog):
    """g++ is present: create_store and LocalPSClient give the native
    store, built from the port's own source under build/edl_store/;
    prefer_native=False gives numpy. When the native store cannot be
    had, create_store logs why and returns the numpy store."""
    store = port_store.create_store(seed=1)
    assert isinstance(store, port_store.NativeEmbeddingStore)
    assert store.library_path == port_store.native_library_path()
    assert os.path.dirname(store.library_path) == os.path.join(
        REPO, "build", "edl_store")
    assert isinstance(LocalPSClient(seed=1).store,
                      port_store.NativeEmbeddingStore)
    assert isinstance(port_store.create_store(prefer_native=False),
                      port_store.NumpyEmbeddingStore)

    def broken(build_dir=None):
        raise RuntimeError("no compiler")

    monkeypatch.setattr(port_store, "_native", None)
    monkeypatch.setattr(port_store, "load_native", broken)
    with caplog.at_level(logging.WARNING):
        store = port_store.create_store(seed=1)
    assert isinstance(store, port_store.NumpyEmbeddingStore)
    assert "numpy store" in caplog.text and "no compiler" in caplog.text
    with pytest.raises(RuntimeError, match="unavailable"):
        port_store.NativeEmbeddingStore()


_BUILD = (
    "import json, sys\n"
    "from elasticdl_tpu_torch.ps import embedding_store as s\n"
    "path, built = s.build_native(sys.argv[1] or None)\n"
    "print(json.dumps([path, built, s._abi_of(s.ctypes.CDLL(path))]))\n"
)


def _build_in_processes(n, build_dir=""):
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD, build_dir],
                              cwd=REPO, stdout=subprocess.PIPE, text=True,
                              env=dict(os.environ, PYTHONPATH=REPO))
             for _ in range(n)]
    outs = [proc.communicate(timeout=300)[0] for proc in procs]
    assert [proc.returncode for proc in procs] == [0] * n, outs
    return [json.loads(out) for out in outs]


def test_built_library_is_reused_by_a_second_process():
    """A second process finds the library this one built and loads it
    as it is: no build, the same file."""
    path, _ = port_store.build_native()
    before = os.stat(path)
    [[other, built, abi]] = _build_in_processes(1)
    after = os.stat(path)
    assert (other, built, abi) == (path, False, 4)
    assert (after.st_ino, after.st_mtime_ns) == (before.st_ino,
                                                 before.st_mtime_ns)


def test_processes_that_start_together_build_once(tmp_path):
    """Three processes asking at once for a library not yet built: one
    builds it (under the lock, to a temporary name renamed into place),
    the others wait and load the same file."""
    results = _build_in_processes(3, str(tmp_path))
    assert sorted(built for _, built, _ in results) == [False, False, True]
    assert {path for path, _, _ in results} == {
        port_store.native_library_path(str(tmp_path))}
    assert {abi for _, _, abi in results} == {4}
    assert sorted(os.listdir(tmp_path)) == [
        ".lock", os.path.basename(results[0][0])]


# ---------------------------------------------------------------------
# (e) the sparse trainer on the native store


def test_ps_state_after_steps_on_native_store_matches_reference():
    """With the tier off, DeepFM pulls and pushes every row through the
    PS: after STEPS steps the port's native store holds the reference's
    native-store state (rows, adam slots, step counts, the hash map's
    order) within the state tolerance, and the losses agree (ADAM_EPS,
    as test_torch_sparse's tier-off test)."""
    batches = make_batches(STEPS, seed=4)
    ref_t, port_t, ref_state, port_state = trainer_pair(
        batches[0], eps=ADAM_EPS, store="native")
    assert isinstance(ref_t.preparer._ps.store,
                      ref_store.NativeEmbeddingStore)
    assert isinstance(port_t.preparer._ps.store,
                      port_store.NativeEmbeddingStore)
    for batch in batches:
        ref_state, r_loss = ref_t.train_step(ref_state, batch)
        port_state, p_loss = port_t.train_step(port_state, batch)
        np.testing.assert_allclose(float(p_loss), float(r_loss),
                                   rtol=STATE_RTOL)
    assert_stores_equal(ref_t.preparer._ps.store, port_t.preparer._ps.store,
                        ("deepfm_emb", "deepfm_linear"), exact=False)
    ref_t.close()
    port_t.close()

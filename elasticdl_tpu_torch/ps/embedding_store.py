"""Host embedding stores: lazily initialised rows with sparse optimizers
(port of elasticdl_tpu/ps/embedding_store.py).

Two stores with one surface:

- ``NativeEmbeddingStore``, a ctypes binding of the port's own copy of
  the C++ store (``native/embedding_store.cc``, C ABI 4). It is built
  with ``make`` (g++) at first use into ``<checkout>/build/edl_store/``
  (git-ignored; ``~/.cache/elasticdl_tpu_torch/store/`` for a package
  installed outside a checkout), under a name keyed by the hash of the
  source and its Makefile, by one process at a time (a file lock) and
  to a temporary name renamed into place, so a process never loads a
  half-written library. A ctypes call releases the GIL for the whole
  batched lookup or apply.
- ``NumpyEmbeddingStore`` keeps each table as ``{id: fp32 row}``: the
  reference's numpy store line for line where values are concerned,
  so both produce the same rows bit for bit. Each table draws its lazy
  rows from its own ``RandomState`` seeded from the store seed and the
  table name (crc32), in the order the ids are first touched; a push of
  unique ids runs one vectorized apply whose adam bias corrections are
  computed in float64 and rounded to fp32, the value the per-id path's
  scalar takes inside its fp32 division.

The native store applies every optimizer bit for bit as the numpy store
does (its Makefile keeps gcc from fusing multiply-adds); its uniform,
normal and truncated-normal rows come from another random stream
(mt19937), so the two agree bit for bit only under the constant and
zeros initializers. ``create_store`` returns the native store unless it
cannot be built or loaded; then it logs why and returns the numpy store
(a PS must not crash mid-job).

The native store also binds the wire-blob entry points the PS
servicer's fast path calls (``lookup_blob``, ``push_gradients_blob``,
``import_blob``): one GIL-released call decodes a TensorBlob payload
(fp32, bf16 or fp16), dedups and applies it, or looks rows up and casts
them to the wire dtype. The numpy store has no such entry points; the
servicer serves it through ``lookup``/``push_gradients``/
``import_table`` with the same values.

Both stores keep the incremental-checkpoint bookkeeping that
``ps/checkpoint.py`` reads: per table, the ids materialised or changed
since the last dirty export (the dirty set) and the ids dropped since
then (the dead set, replayed as tombstones). A drop moves an id from
dirty to dead; a re-materialisation moves it back. ``export_table_dirty``
snapshots both sets and clears them in one step, rows in ascending id
order, bit for bit the same from either store.
"""

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
import zlib

import numpy as np

from elasticdl_tpu_torch.common.log_utils import default_logger
from elasticdl_tpu_torch.ops import _build

logger = default_logger("elasticdl_tpu_torch.ps.embedding_store")

OPTIMIZER_DEFAULTS = dict(
    lr=0.01, momentum=0.9, beta1=0.9, beta2=0.999, epsilon=1e-8
)

# optimizer -> slot rows per weight row
OPT_SLOT_COUNTS = {
    "sgd": 0, "momentum": 1, "nesterov": 1,
    "adagrad": 1, "adam": 2, "amsgrad": 3,
}

# TensorBlob wire dtype name -> WireDtype code of native/embedding_store.cc;
# the only payload dtypes the blob entry points take. BLOB_ITEMSIZE gives
# every size check its bytes per element.
BLOB_DTYPE_CODES = {"float32": 0, "bfloat16": 1, "float16": 2}
BLOB_ITEMSIZE = {"float32": 4, "bfloat16": 2, "float16": 2}

# row initializer kinds (the reference's InitKind codes; "zeros" is
# constant 0)
INIT_KINDS = {
    "uniform": 0, "constant": 1, "normal": 2, "truncated_normal": 3,
}


def parse_initializer(spec, default_scale=0.05):
    """Wire-format initializer string -> (kind, param).

    Accepts "0.05" (bare scale = uniform, the original wire format),
    "normal:0.01", "constant:1.5", "zeros", or "uniform".
    """
    if not spec:
        return "uniform", default_scale
    spec = str(spec)
    kind, _, param = spec.partition(":")
    kind = kind.strip().lower()
    try:
        # bare number: legacy uniform-scale encoding
        return "uniform", float(kind)
    except ValueError:
        pass
    if kind == "zeros":
        return "constant", 0.0
    if kind not in INIT_KINDS:
        raise ValueError("unknown embedding initializer %r" % spec)
    return kind, float(param) if param else default_scale


def _normalize_opt_type(opt_type, kwargs):
    """Fold nesterov=True / amsgrad=True kwargs into the variant opt
    type strings the apply dispatches on."""
    opt_type = opt_type.lower()
    if kwargs.pop("nesterov", False):
        if opt_type != "momentum":
            raise ValueError("nesterov requires the momentum optimizer")
        opt_type = "nesterov"
    if kwargs.pop("amsgrad", False):
        if opt_type != "adam":
            raise ValueError("amsgrad requires the adam optimizer")
        opt_type = "amsgrad"
    return opt_type


# ---------------------------------------------------------------------
# the native store: build, load, bind

NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native"
)
# what the library is built from: its name carries their hash
NATIVE_SOURCES = ("embedding_store.cc", "Makefile")
STORE_BUILD_DIR = _build.build_dir("store")
# edl_store_abi_version of native/embedding_store.cc that this binding
# targets; a library reporting anything else is not called through
EXPECTED_ABI = 4


def native_library_path(build_dir=None):
    """Where the native store's library is built: under ``build_dir``
    (STORE_BUILD_DIR), named by the hash of NATIVE_SOURCES."""
    digest = hashlib.sha256()
    for name in NATIVE_SOURCES:
        with open(os.path.join(NATIVE_DIR, name), "rb") as f:
            digest.update(f.read())
    return os.path.join(build_dir or STORE_BUILD_DIR,
                        "libedl_embedding-%s.so" % digest.hexdigest()[:16])


def build_native(build_dir=None):
    """Build the native store's library unless it is there -> (path,
    whether this call built it). One process at a time (an exclusive
    lock on a file beside it); make writes a temporary name that is
    renamed into place. Raises with make's output when the build
    fails."""
    path = native_library_path(build_dir)
    if os.path.exists(path):
        return path, False
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(os.path.join(os.path.dirname(path), ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(path):
            return path, False
        tmp = "%s.%d.tmp" % (path, os.getpid())
        try:
            proc = subprocess.run(
                ["make", "-s", "-C", NATIVE_DIR, "OUT=" + tmp],
                capture_output=True, text=True,
            )
            if proc.returncode != 0:
                raise RuntimeError("building the native store failed:\n%s%s"
                                   % (proc.stdout, proc.stderr))
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    return path, True


def _abi_of(lib):
    """The loaded library's ABI clock, or None without the symbol."""
    try:
        fn = lib.edl_store_abi_version
    except AttributeError:
        return None
    fn.restype = ctypes.c_int64
    fn.argtypes = []
    return int(fn())


_VP, _CHAR, _I64, _INT = (ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64,
                          ctypes.c_int)
_F32, _F64 = ctypes.c_float, ctypes.c_double
_I64P = ctypes.POINTER(ctypes.c_int64)
_F32P = ctypes.POINTER(ctypes.c_float)
# C function -> (argtypes, restype): what NativeEmbeddingStore calls
_NATIVE_FUNCTIONS = {
    "edl_store_create": ([ctypes.c_uint64], _VP),
    "edl_store_destroy": ([_VP], None),
    # doubles: the store rounds each hyperparameter to fp32 where
    # numpy's weak-scalar promotion does
    "edl_store_set_optimizer": ([_VP, _CHAR] + [_F64] * 5, _INT),
    "edl_store_create_table_init": ([_VP, _CHAR, _I64, _INT, _F32], _INT),
    "edl_store_lookup": ([_VP, _CHAR, _I64P, _I64, _F32P], _INT),
    "edl_store_push_gradients": ([_VP, _CHAR, _I64P, _F32P, _I64, _F64],
                                 _INT),
    "edl_store_import": ([_VP, _CHAR, _I64P, _F32P, _I64, _INT, _INT],
                         _INT),
    # the wire-blob entry points: (ids, n, payload, dtype code, ...)
    "edl_store_apply_blob": ([_VP, _CHAR, _I64P, _I64, _VP, _INT, _F64,
                              _INT], _INT),
    "edl_store_lookup_cast": ([_VP, _CHAR, _I64P, _I64, _VP, _INT], _INT),
    "edl_store_import_blob": ([_VP, _CHAR, _I64P, _I64, _VP, _INT, _INT,
                               _INT], _INT),
    "edl_store_table_size": ([_VP, _CHAR], _I64),
    "edl_store_table_slots": ([_VP, _CHAR], _INT),
    "edl_store_version": ([_VP], _I64),
    "edl_store_bump_version": ([_VP], None),
    "edl_store_export_full": ([_VP, _CHAR, _I64P, _F32P, _I64P, _I64],
                              _I64),
    # incremental checkpoints and row drops
    "edl_store_set_version": ([_VP, _I64], None),
    "edl_store_export": ([_VP, _CHAR, _I64P, _F32P, _I64], _I64),
    "edl_store_import_full": ([_VP, _CHAR, _I64P, _F32P, _I64P, _I64, _I64,
                               _INT, _INT], _INT),
    "edl_store_drop_rows": ([_VP, _CHAR, _I64P, _I64], _I64),
    "edl_store_drop_table": ([_VP, _CHAR], _INT),
    "edl_store_dirty_count": ([_VP, _CHAR], _I64),
    "edl_store_export_dirty": ([_VP, _CHAR, _I64P, _F32P, _I64P, _I64P,
                                _I64, _I64, _I64P, _INT], _I64),
    "edl_store_clear_dirty": ([_VP, _CHAR], _INT),
}


def load_native(build_dir=None):
    """Build (if needed), load and bind the native store -> (library,
    its path). Raises RuntimeError saying why it cannot: the build
    failed, the library does not load (it is removed and built once
    more first: a file cut short by something else), its ABI clock
    is not EXPECTED_ABI, or a function is missing."""
    path, built = build_native(build_dir)
    try:
        lib = ctypes.CDLL(path)
    except OSError as err:
        if built:
            raise RuntimeError("the native store does not load: %s" % err)
        logger.warning("The native store at %s does not load (%s); "
                       "building it once more", path, err)
        os.remove(path)
        path, _ = build_native(build_dir)
        lib = ctypes.CDLL(path)
    abi = _abi_of(lib)
    if abi != EXPECTED_ABI:
        raise RuntimeError("the native store at %s has ABI %s, this "
                           "binding wants %d" % (path, abi, EXPECTED_ABI))
    for name, (argtypes, restype) in _NATIVE_FUNCTIONS.items():
        try:
            fn = getattr(lib, name)
        except AttributeError:
            raise RuntimeError("the native store at %s lacks %s"
                               % (path, name)) from None
        fn.argtypes = argtypes
        fn.restype = restype
    return lib, path


_native = None  # (library, path), or False once it could not be had
_native_lock = threading.Lock()


def native_lib():
    """The bound native library, built and loaded once per process, or
    None (logged once) when it cannot be had here."""
    global _native
    with _native_lock:
        if _native is None:
            try:
                _native = load_native()
            except Exception:  # the PS boundary: degrade, never crash
                logger.warning("The native embedding store is unavailable; "
                               "using the numpy store", exc_info=True)
                _native = False
    return _native[0] if _native else None


def _as_i64(ids):
    a = ids if isinstance(ids, np.ndarray) else np.asarray(ids)
    if a.dtype == np.int64 and a.flags.c_contiguous:
        return a
    return np.ascontiguousarray(a, dtype=np.int64)


def _as_f32(values):
    a = values if isinstance(values, np.ndarray) else np.asarray(values)
    if a.dtype == np.float32 and a.flags.c_contiguous:
        return a
    return np.ascontiguousarray(a, dtype=np.float32)


def _i64_ptr(a):
    return a.ctypes.data_as(_I64P)


def _f32_ptr(a):
    return a.ctypes.data_as(_F32P)


class NativeEmbeddingStore:
    """The C++ store (``native/embedding_store.cc``) through ctypes:
    NumpyEmbeddingStore's surface and arithmetic, its own lazy-init
    random stream. ``library_path`` names the library it runs."""

    def __init__(self, seed=0):
        self._lib = native_lib()
        if self._lib is None:
            raise RuntimeError("the native embedding store is unavailable "
                               "(see the log)")
        self.library_path = _native[1]
        self._handle = ctypes.c_void_p(self._lib.edl_store_create(seed))
        self._dims = {}
        self._opt_type = "sgd"

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.edl_store_destroy(handle)
            self._handle = None

    def set_optimizer(self, opt_type, **kwargs):
        opt_type = _normalize_opt_type(opt_type, kwargs)
        args = dict(OPTIMIZER_DEFAULTS)
        args.update(kwargs)
        rc = self._lib.edl_store_set_optimizer(
            self._handle, opt_type.encode(), args["lr"], args["momentum"],
            args["beta1"], args["beta2"], args["epsilon"],
        )
        if rc == -2:
            raise RuntimeError(
                "cannot change the optimizer after tables exist (slot "
                "memory is sized at table creation)"
            )
        if rc != 0:
            raise ValueError("unsupported sparse optimizer %r" % opt_type)
        self._opt_type = opt_type

    def create_table(self, name, dim, init_scale=0.05, initializer="uniform"):
        if initializer == "zeros":
            initializer, init_scale = "constant", 0.0
        if initializer not in INIT_KINDS:
            raise ValueError("unknown embedding initializer %r" % initializer)
        rc = self._lib.edl_store_create_table_init(
            self._handle, name.encode(), dim, INIT_KINDS[initializer],
            init_scale,
        )
        if rc != 0:
            raise ValueError("table %r exists with a different dim" % name)
        self._dims[name] = dim

    def lookup(self, name, ids):
        if name not in self._dims:
            raise KeyError(name)
        ids = _as_i64(ids)
        out = np.empty((ids.size, self._dims[name]), dtype=np.float32)
        rc = self._lib.edl_store_lookup(self._handle, name.encode(),
                                        _i64_ptr(ids), ids.size,
                                        _f32_ptr(out))
        if rc != 0:
            raise KeyError(name)
        return out

    def push_gradients(self, name, ids, grads, lr_scale=1.0):
        ids = _as_i64(ids)
        grads = _as_f32(grads)
        rc = self._lib.edl_store_push_gradients(
            self._handle, name.encode(), _i64_ptr(ids), _f32_ptr(grads),
            ids.size, lr_scale,
        )
        if rc != 0:
            raise KeyError(name)

    def import_table(self, name, ids, values, shard_id=0, shard_num=0):
        """Raw row overwrite (device-tier writeback, weights-only
        restore); a row not yet materialised is initialised first, as in
        the numpy store. With ``shard_num`` > 0 only ids with id %
        shard_num == shard_id are kept."""
        ids = _as_i64(ids)
        values = _as_f32(values)
        rc = self._lib.edl_store_import(self._handle, name.encode(),
                                        _i64_ptr(ids), _f32_ptr(values),
                                        ids.size, shard_id, shard_num)
        if rc != 0:
            raise KeyError(name)

    def lookup_blob(self, name, ids, wire_dtype_name=None):
        """Batched lookup emitted at the wire dtype: one GIL-released
        call does lazy init, gather and the (bf16/fp16) down-cast, round
        to nearest even. Returns ``(payload bytes, dtype name)``."""
        if name not in self._dims:
            raise KeyError(name)
        dtype_name = wire_dtype_name or "float32"
        code = BLOB_DTYPE_CODES[dtype_name]
        ids = _as_i64(ids)
        out = np.empty(ids.size * self._dims[name] * BLOB_ITEMSIZE[dtype_name],
                       dtype=np.uint8)
        rc = self._lib.edl_store_lookup_cast(
            self._handle, name.encode(), _i64_ptr(ids), ids.size,
            out.ctypes.data_as(_VP), code,
        )
        if rc != 0:
            raise KeyError(name)
        return out.tobytes(), dtype_name

    def _blob_buffer(self, what, name, ids, content, dtype_name):
        """(dtype code, payload as uint8) after checking its size
        against ``ids`` and the table's dim."""
        if name not in self._dims:
            raise KeyError(name)
        code = BLOB_DTYPE_CODES[dtype_name]
        buf = np.frombuffer(content, dtype=np.uint8)
        expected = ids.size * self._dims[name] * BLOB_ITEMSIZE[dtype_name]
        if buf.size != expected:
            raise ValueError(
                "%s: %d payload bytes for %d ids of table %r (want %d)"
                % (what, buf.size, ids.size, name, expected)
            )
        return code, buf

    def push_gradients_blob(self, name, ids, content, dtype_name,
                            lr_scale=1.0, dedup=True):
        """Decode (with the fp32 upcast), dedup and apply one table's
        pushed payload in one GIL-released call: ``ids`` int64 (a
        read-only view of a request's ids_blob will do), ``content`` the
        TensorBlob bytes at ``dtype_name`` ([n, dim] row-major). With
        ``dedup`` the segment sum is ``deduplicate_indexed_slices``'s,
        bit for bit."""
        ids = _as_i64(ids)
        code, buf = self._blob_buffer("push_gradients_blob", name, ids,
                                      content, dtype_name)
        rc = self._lib.edl_store_apply_blob(
            self._handle, name.encode(), _i64_ptr(ids), ids.size,
            buf.ctypes.data_as(_VP), code, lr_scale, 1 if dedup else 0,
        )
        if rc == -2:
            raise ValueError("unsupported blob dtype %r" % dtype_name)
        if rc != 0:
            raise KeyError(name)

    def import_blob(self, name, ids, content, dtype_name):
        """Raw row import straight from wire bytes (device-tier
        writebacks): the payload upcast into the fp32 rows, last write
        wins on duplicate ids, in one GIL-released call."""
        ids = _as_i64(ids)
        code, buf = self._blob_buffer("import_blob", name, ids, content,
                                      dtype_name)
        rc = self._lib.edl_store_import_blob(
            self._handle, name.encode(), _i64_ptr(ids), ids.size,
            buf.ctypes.data_as(_VP), code, 0, 0,
        )
        if rc == -2:
            raise ValueError("unsupported blob dtype %r" % dtype_name)
        if rc != 0:
            raise KeyError(name)

    @property
    def version(self):
        return int(self._lib.edl_store_version(self._handle))

    def bump_version(self):
        self._lib.edl_store_bump_version(self._handle)

    def table_size(self, name):
        n = self._lib.edl_store_table_size(self._handle, name.encode())
        if n < 0:
            raise KeyError(name)
        return int(n)

    def table_names(self):
        return list(self._dims)

    def table_dim(self, name):
        return self._dims[name]

    @property
    def opt_type(self):
        return self._opt_type

    def export_table_full(self, name):
        """``(ids, rows [n, dim * (1 + slots)], steps)``: each row's
        weights followed by its optimizer slots, and its step count (in
        the hash map's order, not the numpy store's creation order)."""
        count = self._lib.edl_store_export_full(
            self._handle, name.encode(), None, None, None, 0)
        if count < 0:
            raise KeyError(name)
        slots = self._lib.edl_store_table_slots(self._handle, name.encode())
        ids = np.empty((count,), np.int64)
        rows = np.empty((count, self._dims[name] * (1 + slots)), np.float32)
        steps = np.empty((count,), np.int64)
        got = self._lib.edl_store_export_full(
            self._handle, name.encode(), _i64_ptr(ids), _f32_ptr(rows),
            _i64_ptr(steps), count,
        )
        return ids[:got], rows[:got], steps[:got]

    def table_slots(self, name):
        n = self._lib.edl_store_table_slots(self._handle, name.encode())
        if n < 0:
            raise KeyError(name)
        return int(n)

    def set_version(self, version):
        """Re-anchor the version clock (checkpoint auto-restore)."""
        self._lib.edl_store_set_version(self._handle, int(version))

    def export_table(self, name):
        """``(ids, weights [n, dim])`` in the hash map's order."""
        count = self._lib.edl_store_export(self._handle, name.encode(),
                                           None, None, 0)
        if count < 0:
            raise KeyError(name)
        ids = np.empty((count,), np.int64)
        values = np.empty((count, self._dims[name]), np.float32)
        got = self._lib.edl_store_export(self._handle, name.encode(),
                                         _i64_ptr(ids), _f32_ptr(values),
                                         count)
        return ids[:got], values[:got]

    def import_table_full(self, name, ids, rows, steps, shard_id=0,
                          shard_num=0):
        """Inverse of ``export_table_full``. Rows of another width (the
        optimizer changed between save and restore) import their
        weights only; rows narrower than the table's dim raise."""
        ids = _as_i64(ids)
        rows = _as_f32(rows)
        steps = _as_i64(steps)
        rc = self._lib.edl_store_import_full(
            self._handle, name.encode(), _i64_ptr(ids), _f32_ptr(rows),
            _i64_ptr(steps), ids.size, rows.shape[1] if rows.ndim == 2 else 0,
            shard_id, shard_num,
        )
        if rc == -2:
            raise ValueError(
                "import_table_full: rows must be [n, (1+slots)*dim] = "
                "[n, %d] for table %r"
                % (self._dims[name] * (1 + self.table_slots(name)), name))
        if rc != 0:
            raise KeyError(name)

    def drop_rows(self, name, ids):
        """Delete rows (weights, slots and step counts), so a re-admitted
        id starts from the initializer. Absent ids are not an error;
        returns the number of rows dropped."""
        ids = _as_i64(ids)
        dropped = self._lib.edl_store_drop_rows(self._handle, name.encode(),
                                                _i64_ptr(ids), ids.size)
        if dropped < 0:
            raise KeyError(name)
        return int(dropped)

    def drop_table(self, name):
        """Drop a whole table (administrative: quiesce its traffic
        first)."""
        if self._lib.edl_store_drop_table(self._handle, name.encode()) != 0:
            raise KeyError(name)
        self._dims.pop(name, None)

    def dirty_count(self, name):
        """Rows a dirty export would carry now."""
        n = self._lib.edl_store_dirty_count(self._handle, name.encode())
        if n < 0:
            raise KeyError(name)
        return int(n)

    def export_table_dirty(self, name, clear=True):
        """Snapshot-and-clear of the dirty and dead sets in one
        GIL-released call under the table's lock: ``(ids ascending,
        rows [n, dim * (1 + slots)], steps, dead ids ascending)``. Rows
        dirtied between the sizing probe and the fill beyond the slack
        make the fill return -3, and it probes again."""
        row_floats = self._dims[name] * (1 + self.table_slots(name))
        dead_count = ctypes.c_int64(0)
        while True:
            count = self._lib.edl_store_export_dirty(
                self._handle, name.encode(), None, None, None, None, 0, 0,
                ctypes.byref(dead_count), 0)
            if count < 0:
                raise KeyError(name)
            cap, dead_cap = int(count) + 1024, int(dead_count.value) + 1024
            ids = np.empty((cap,), np.int64)
            rows = np.empty((cap, row_floats), np.float32)
            steps = np.empty((cap,), np.int64)
            dead = np.empty((dead_cap,), np.int64)
            got = self._lib.edl_store_export_dirty(
                self._handle, name.encode(), _i64_ptr(ids), _f32_ptr(rows),
                _i64_ptr(steps), _i64_ptr(dead), cap, dead_cap,
                ctypes.byref(dead_count), 1 if clear else 0)
            if got == -3:
                continue
            if got < 0:
                raise KeyError(name)
            return (ids[:got], rows[:got], steps[:got],
                    dead[:int(dead_count.value)])

    def clear_dirty(self, name):
        """Forget the dirty and dead sets (before a full base export,
        which carries the complete state)."""
        if self._lib.edl_store_clear_dirty(self._handle, name.encode()) != 0:
            raise KeyError(name)


class NumpyEmbeddingStore:
    """In-process embedding tables with lazy row init and sparse
    optimizers."""

    def __init__(self, seed=0):
        self._seed = seed
        # per-table RNG: lazy-init draws are deterministic regardless of
        # the order tables are pulled in
        self._rngs = {}
        self._tables = {}  # name -> {id: weight row}
        self._slots = {}  # name -> {id: slot array [slots, dim]}
        self._steps = {}  # name -> {id: step count}
        # incremental-checkpoint bookkeeping: ids materialised or
        # changed since the last dirty export, and ids dropped since
        # then; a subset of the resident ids and its complement
        self._dirty = {}  # name -> set(id)
        self._dead = {}  # name -> set(id)
        self._meta = {}  # name -> (dim, init_scale, initializer)
        self._opt = ("sgd", dict(OPTIMIZER_DEFAULTS))
        self._lock = threading.Lock()
        self.version = 0

    def set_optimizer(self, opt_type, **kwargs):
        opt_type = _normalize_opt_type(opt_type, kwargs)
        if opt_type not in OPT_SLOT_COUNTS:
            raise ValueError("unsupported sparse optimizer %r" % opt_type)
        if self._meta:
            # the slot layout is fixed at table creation
            raise RuntimeError(
                "cannot change the optimizer after tables exist (slot "
                "memory is sized at table creation)"
            )
        args = dict(OPTIMIZER_DEFAULTS)
        args.update(kwargs)
        self._opt = (opt_type, args)

    def create_table(self, name, dim, init_scale=0.05, initializer="uniform"):
        if initializer == "zeros":
            initializer, init_scale = "constant", 0.0
        if initializer not in INIT_KINDS:
            raise ValueError("unknown embedding initializer %r" % initializer)
        with self._lock:
            if name in self._meta:
                if self._meta[name][0] != dim:
                    raise ValueError(
                        "table %r exists with a different dim" % name
                    )
                # adopt the (possibly updated) scale so restore-then-
                # register keeps the model's configured init
                self._meta[name] = (dim, init_scale, initializer)
                return
            self._meta[name] = (dim, init_scale, initializer)
            self._tables[name] = {}
            self._slots[name] = {}
            self._steps[name] = {}
            self._dirty[name] = set()
            self._dead[name] = set()

    def _table_rng_locked(self, name):
        rng = self._rngs.get(name)
        if rng is None:
            rng = np.random.RandomState(
                (self._seed * 1000003 + zlib.crc32(name.encode()))
                % (2 ** 32)
            )
            self._rngs[name] = rng
        return rng

    def _init_row_locked(self, name, dim, scale, kind):
        if kind == "constant":
            return np.full(dim, scale, dtype=np.float32)
        if scale <= 0:
            return np.zeros(dim, dtype=np.float32)
        rng = self._table_rng_locked(name)
        if kind == "uniform":
            return rng.uniform(-scale, scale, size=dim).astype(np.float32)
        if kind == "normal":
            return rng.normal(0.0, scale, size=dim).astype(np.float32)
        # truncated_normal: resample outside [-2*stddev, 2*stddev]
        row = rng.normal(0.0, scale, size=dim)
        bad = np.abs(row) > 2 * scale
        while bad.any():
            row[bad] = rng.normal(0.0, scale, size=int(bad.sum()))
            bad = np.abs(row) > 2 * scale
        return row.astype(np.float32)

    def _row_locked(self, name, id_):
        table = self._tables[name]
        if id_ not in table:
            dim, scale, kind = self._meta[name]
            table[id_] = self._init_row_locked(name, dim, scale, kind)
            n_slots = OPT_SLOT_COUNTS[self._opt[0]]
            self._slots[name][id_] = np.zeros(
                (n_slots, dim), dtype=np.float32
            )
            self._steps[name][id_] = 0
            # a lazy init is a change the next delta must carry
            self._dirty[name].add(id_)
            self._dead[name].discard(id_)
        return table[id_]

    def lookup(self, name, ids):
        if name not in self._meta:
            raise KeyError(name)
        with self._lock:
            return np.stack([
                self._row_locked(name, int(i)).copy() for i in ids
            ])

    def push_gradients(self, name, ids, grads, lr_scale=1.0):
        if name not in self._meta:
            raise KeyError(name)
        opt_type, args = self._opt
        lr = args["lr"] * lr_scale
        ids = np.asarray(ids, dtype=np.int64)
        grads = np.asarray(grads, dtype=np.float32)
        with self._lock:
            if ids.size > 1 and np.unique(ids).size == ids.size:
                # clients dedup before pushing, so a push's ids are
                # unique: one vectorized [n, dim] apply, bit-identical
                # to the per-id path below
                self._apply_unique_locked(name, ids, grads, opt_type,
                                          args, lr)
                return
            dirty = self._dirty[name]
            for i, grad in zip(ids, grads):
                i = int(i)
                dirty.add(i)
                w = self._row_locked(name, i)
                slots = self._slots[name][i]
                self._steps[name][i] += 1
                step = self._steps[name][i]
                if opt_type == "sgd":
                    w -= lr * grad
                elif opt_type in ("momentum", "nesterov"):
                    slots[0] = args["momentum"] * slots[0] + grad
                    if opt_type == "nesterov":
                        w -= lr * (grad + args["momentum"] * slots[0])
                    else:
                        w -= lr * slots[0]
                elif opt_type == "adagrad":
                    slots[0] += grad * grad
                    w -= lr * grad / (np.sqrt(slots[0]) + args["epsilon"])
                elif opt_type in ("adam", "amsgrad"):
                    slots[0] = (args["beta1"] * slots[0]
                                + (1 - args["beta1"]) * grad)
                    slots[1] = (
                        args["beta2"] * slots[1]
                        + (1 - args["beta2"]) * grad * grad
                    )
                    mhat = slots[0] / (1 - args["beta1"] ** step)
                    v = slots[1]
                    if opt_type == "amsgrad":
                        slots[2] = np.maximum(slots[2], v)
                        v = slots[2]
                    vhat = v / (1 - args["beta2"] ** step)
                    w -= lr * mhat / (np.sqrt(vhat) + args["epsilon"])

    def _apply_unique_locked(self, name, ids, grads, opt_type, args, lr):
        """Vectorized apply for a unique-id push: gather the touched
        rows and slots into dense [n, ...] arrays, run the update math
        once, scatter back. Caller holds the lock and guarantees the
        ids are unique."""
        id_list = [int(i) for i in ids]
        self._dirty[name].update(id_list)
        # gather in input order: lazy row init draws from the per-table
        # RNG stream, so creation order must match the per-id path
        rows = [self._row_locked(name, i) for i in id_list]
        w = np.stack(rows)
        slot_map = self._slots[name]
        step_map = self._steps[name]
        steps = np.empty((ids.size, 1), dtype=np.float64)
        for k, i in enumerate(id_list):
            step_map[i] += 1
            steps[k, 0] = step_map[i]
        if opt_type == "sgd":
            w -= lr * grads
        elif opt_type in ("momentum", "nesterov"):
            m = np.stack([slot_map[i][0] for i in id_list])
            m = args["momentum"] * m + grads
            if opt_type == "nesterov":
                w -= lr * (grads + args["momentum"] * m)
            else:
                w -= lr * m
            for k, i in enumerate(id_list):
                slot_map[i][0] = m[k]
        elif opt_type == "adagrad":
            s = np.stack([slot_map[i][0] for i in id_list])
            s += grads * grads
            w -= lr * grads / (np.sqrt(s) + args["epsilon"])
            for k, i in enumerate(id_list):
                slot_map[i][0] = s[k]
        elif opt_type in ("adam", "amsgrad"):
            slots = np.stack([slot_map[i] for i in id_list])
            slots[:, 0] = (
                args["beta1"] * slots[:, 0] + (1 - args["beta1"]) * grads
            )
            slots[:, 1] = (
                args["beta2"] * slots[:, 1]
                + (1 - args["beta2"]) * grads * grads
            )
            # bias corrections in float64 then rounded to float32, the
            # value the per-id path's python-float scalar takes inside
            # its float32 division
            bc1 = (1.0 - args["beta1"] ** steps).astype(np.float32)
            bc2 = (1.0 - args["beta2"] ** steps).astype(np.float32)
            mhat = slots[:, 0] / bc1
            v = slots[:, 1]
            if opt_type == "amsgrad":
                slots[:, 2] = np.maximum(slots[:, 2], v)
                v = slots[:, 2]
            vhat = v / bc2
            w -= lr * mhat / (np.sqrt(vhat) + args["epsilon"])
            for k, i in enumerate(id_list):
                slot_map[i][:] = slots[k]
        for k, row in enumerate(rows):
            row[:] = w[k]

    def drop_rows(self, name, ids):
        """Delete rows (weights, slots and step counts), so a re-admitted
        id starts from the initializer; a dropped id moves from the
        dirty set to the dead set. Returns the number of rows
        dropped."""
        if name not in self._meta:
            raise KeyError(name)
        dropped = 0
        with self._lock:
            table, dirty, dead = (self._tables[name], self._dirty[name],
                                  self._dead[name])
            for i in ids:
                i = int(i)
                if table.pop(i, None) is not None:
                    dropped += 1
                    dirty.discard(i)
                    dead.add(i)
                self._slots[name].pop(i, None)
                self._steps[name].pop(i, None)
        return dropped

    def drop_table(self, name):
        if name not in self._meta:
            raise KeyError(name)
        with self._lock:
            for per_table in (self._meta, self._tables, self._slots,
                              self._steps, self._dirty, self._dead,
                              self._rngs):
                per_table.pop(name, None)

    def bump_version(self):
        with self._lock:
            self.version += 1

    def set_version(self, version):
        """Re-anchor the version clock (checkpoint auto-restore)."""
        with self._lock:
            self.version = int(version)

    def table_size(self, name):
        with self._lock:
            return len(self._tables[name])

    def table_names(self):
        return list(self._meta)

    def table_dim(self, name):
        return self._meta[name][0]

    @property
    def opt_type(self):
        return self._opt[0]

    def table_slots(self, name):
        if name not in self._meta:
            raise KeyError(name)
        return OPT_SLOT_COUNTS[self._opt[0]]

    def export_table(self, name):
        """``(ids, weights [n, dim])`` in creation order."""
        with self._lock:
            table = self._tables[name]
            if not table:
                return (np.empty((0,), np.int64),
                        np.empty((0, self._meta[name][0]), np.float32))
            ids = np.fromiter(table.keys(), dtype=np.int64, count=len(table))
            return ids, np.stack([table[int(i)] for i in ids])

    def import_table(self, name, ids, values, shard_id=0, shard_num=0):
        """Raw row overwrite (device-tier writeback, weights-only
        restore); a row not yet materialised is initialised first, as in
        the reference. With ``shard_num`` > 0 only ids with id %
        shard_num == shard_id are kept."""
        with self._lock:
            dirty = self._dirty[name]
            for i, row in zip(ids, values):
                i = int(i)
                if shard_num > 0 and i % shard_num != shard_id:
                    continue
                self._row_locked(name, i)[:] = row
                dirty.add(i)

    def export_table_full(self, name):
        """``(ids, rows [n, dim * (1 + slots)], steps)``: each row's
        weights followed by its optimizer slots, and its step count."""
        with self._lock:
            table = self._tables[name]
            dim = self._meta[name][0]
            row_floats = dim * (1 + OPT_SLOT_COUNTS[self._opt[0]])
            if not table:
                return (
                    np.empty((0,), np.int64),
                    np.empty((0, row_floats), np.float32),
                    np.empty((0,), np.int64),
                )
            ids = np.fromiter(table.keys(), dtype=np.int64, count=len(table))
            rows = np.stack([
                np.concatenate(
                    [table[int(i)]] + list(self._slots[name][int(i)])
                )
                for i in ids
            ])
            steps = np.asarray(
                [self._steps[name][int(i)] for i in ids], np.int64
            )
            return ids, rows, steps

    def import_table_full(self, name, ids, rows, steps, shard_id=0,
                          shard_num=0):
        """Inverse of ``export_table_full``. Rows of another width (the
        optimizer changed between save and restore) import their
        weights only."""
        dim = self._meta[name][0]
        slots = self.table_slots(name)
        rows = np.asarray(rows, np.float32)
        exact = rows.ndim == 2 and rows.shape[1] == dim * (1 + slots)
        with self._lock:
            dirty = self._dirty[name]
            for idx, i in enumerate(ids):
                i = int(i)
                if shard_num > 0 and i % shard_num != shard_id:
                    continue
                self._row_locked(name, i)[:] = rows[idx][:dim]
                dirty.add(i)
                if exact:
                    self._slots[name][i][:] = rows[idx][dim:].reshape(
                        slots, dim)
                    self._steps[name][i] = int(steps[idx])

    def dirty_count(self, name):
        """Rows a dirty export would carry now."""
        if name not in self._meta:
            raise KeyError(name)
        with self._lock:
            return len(self._dirty[name])

    def export_table_dirty(self, name, clear=True):
        """Snapshot-and-clear of the dirty and dead sets under the store
        lock: ``(ids ascending, rows [n, dim * (1 + slots)], steps, dead
        ids ascending)``, bit for bit the native store's export."""
        if name not in self._meta:
            raise KeyError(name)
        with self._lock:
            dim = self._meta[name][0]
            row_floats = dim * (1 + self.table_slots(name))
            dirty = sorted(self._dirty[name])
            dead = np.asarray(sorted(self._dead[name]), np.int64)
            if dirty:
                table, slot_map = self._tables[name], self._slots[name]
                ids = np.asarray(dirty, np.int64)
                rows = np.stack([
                    np.concatenate([table[i]] + list(slot_map[i]))
                    for i in dirty
                ]).astype(np.float32, copy=False)
                steps = np.asarray([self._steps[name][i] for i in dirty],
                                   np.int64)
            else:
                ids = np.empty((0,), np.int64)
                rows = np.empty((0, row_floats), np.float32)
                steps = np.empty((0,), np.int64)
            if clear:
                self._dirty[name] = set()
                self._dead[name] = set()
            return ids, rows, steps, dead

    def clear_dirty(self, name):
        """Forget the dirty and dead sets (before a full base export,
        which carries the complete state)."""
        if name not in self._meta:
            raise KeyError(name)
        with self._lock:
            self._dirty[name] = set()
            self._dead[name] = set()


def create_store(seed=0, prefer_native=True):
    """The native store when ``prefer_native`` and it builds and loads
    here (``native_lib``), else the numpy store (the failure is logged
    once)."""
    if prefer_native and native_lib() is not None:
        return NativeEmbeddingStore(seed=seed)
    return NumpyEmbeddingStore(seed=seed)

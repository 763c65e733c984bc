"""Host embedding store: lazily initialised rows with sparse optimizers
(port of elasticdl_tpu/ps/embedding_store.py, the numpy store).

``NumpyEmbeddingStore`` keeps each table as ``{id: fp32 row}`` with its
optimizer slots and step count, initialises a row at its first touch
and applies pushed gradients with sgd, momentum, nesterov, adagrad,
adam or amsgrad. It is the reference's numpy store line for line where
values are concerned, so both produce the same rows bit for bit:

- each table draws its lazy rows from its own ``RandomState`` seeded
  from the store seed and the table name (crc32), in the order the ids
  are first touched;
- a push of unique ids runs one vectorized apply whose adam bias
  corrections are computed in float64 and rounded to fp32, the value
  the per-id path's scalar takes inside its fp32 division.

The reference's native C++ store (a different lazy-init stream) and the
incremental-checkpoint bookkeeping (dirty and dead id sets) are not
ported yet; ``create_store`` always returns the numpy store.
"""

import threading
import zlib

import numpy as np

OPTIMIZER_DEFAULTS = dict(
    lr=0.01, momentum=0.9, beta1=0.9, beta2=0.999, epsilon=1e-8
)

# optimizer -> slot rows per weight row
OPT_SLOT_COUNTS = {
    "sgd": 0, "momentum": 1, "nesterov": 1,
    "adagrad": 1, "adam": 2, "amsgrad": 3,
}

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
            for i, grad in zip(ids, grads):
                i = int(i)
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

    def bump_version(self):
        with self._lock:
            self.version += 1

    def import_table(self, name, ids, values):
        """Raw row overwrite (device-tier writeback); a row not yet
        materialised is initialised first, as in the reference."""
        with self._lock:
            for i, row in zip(ids, values):
                self._row_locked(name, int(i))[:] = row

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


def create_store(seed=0):
    """The numpy store (the native C++ store is not ported yet)."""
    return NumpyEmbeddingStore(seed=seed)

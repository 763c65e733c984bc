"""Device-tier embedding kernels (K1 gather-merge, K2 insert rows, K3
scatter-apply): their wrappers, their plain PyTorch versions and the
fused ops built on them.

Port of elasticdl_tpu/ops/embedding_tier.py. The device tier
(train/device_tier.py) keeps the Zipfian hot set of each host-PS
embedding table on the card as a slot table ``[capacity + 1, dim]``
whose last row is a scratch slot that absorbs writes addressed
"nowhere". Three fused ops keep the hit path free of host round trips:

- ``fused_insert_gather``: once per staging chunk of a table, read the
  eviction victims' current values out (K1), write the staged
  promotions into their slots and reset their optimizer slot buffers
  and step counts (K2, one launch for the whole table state), then
  gather the step's full row buffer by merging resident hits with the
  PS-pulled miss rows (K1). In that order, on one stream: an insert may
  reuse a victim's slot, and a promotion is a hit from its first step.
  On the card the second and third launch are programmatic dependent
  launches: each may start before the one before it ends, and waits
  for it before touching the tier state.
- ``fused_scatter_apply``: the sparse optimizer step applied to the
  resident slots from the step's row gradients (K3); no hit row's
  gradient leaves the card. The math mirrors the PS store's
  (ps/embedding_store.py) for sgd, momentum, nesterov, adagrad and
  adam, so a row trains the same whichever tier holds it.
- ``gather_rows``: a plain slot read (K1 with zeros for misses), for
  flush and eviction writebacks.

The kernels are CUDA C++ in ``ops/csrc/embedding_tier.cu``, built for
``sm_90a`` at first use (ops/_build.py). Each wrapper launches its
kernel for CUDA tensors and raises on what the kernel does not take; it
runs the plain version (a port of the reference's jnp functions) only
for CPU tensors. ``GATHER_LAUNCHES`` (K1), ``SET_ROWS_LAUNCHES`` (K2:
``insert_rows`` and the one-buffer ``set_rows``) and
``SCATTER_APPLY_LAUNCHES`` (K3) count kernel launches.

The reference rebinds donated JAX arrays after every op; the port
updates the state's tensors IN PLACE (no copy of a 65537-row table a
step). A caller that needs a value to survive a later launch takes a
copy first (``gather_rows`` returns one).

Uniqueness contract: ``slots`` entries are unique per call except the
scratch row, which may repeat: every op writes the scratch row with
set semantics, so duplicate writes race benignly into a row nothing
reads. K3 on the card does not write it at all (a miss touches
nothing); its plain version sends misses there, as the reference does.
"""

import threading

import numpy as np
import torch

# optimizer -> number of [rows, dim] slot-state buffers (the
# tier-supported subset of ps/embedding_store.OPT_SLOT_COUNTS)
TIER_OPT_SLOTS = {
    "sgd": 0, "momentum": 1, "nesterov": 1, "adagrad": 1, "adam": 2,
}
# optimizer -> the K3 template the C interface dispatches to
_OPT_CODES = {"sgd": 0, "momentum": 1, "nesterov": 2, "adagrad": 3, "adam": 4}

GATHER_LAUNCHES = 0
SET_ROWS_LAUNCHES = 0
SCATTER_APPLY_LAUNCHES = 0
_launch_lock = threading.Lock()


def _count(name):
    with _launch_lock:
        globals()[name] += 1


def init_table_state(capacity, dim, opt_type, device="cpu",
                     dtype=torch.float32):
    """Fresh tier state for one table: weights, optimizer slot buffers
    and per-slot int32 step counts (adam's bias correction), all zeros,
    on ``device``. ``capacity`` INCLUDES the scratch row."""
    if opt_type not in TIER_OPT_SLOTS:
        raise ValueError(
            "device tier supports %s sparse optimizers (got %r)"
            % (sorted(TIER_OPT_SLOTS), opt_type)
        )
    state = {"rows": torch.zeros((capacity, dim), dtype=dtype, device=device)}
    for k in range(TIER_OPT_SLOTS[opt_type]):
        state["slot%d" % k] = torch.zeros((capacity, dim), dtype=dtype,
                                          device=device)
    state["steps"] = torch.zeros((capacity,), dtype=torch.int32,
                                 device=device)
    return state


def _slot_keys(state):
    return sorted(k for k in state if k.startswith("slot"))


# ---------------------------------------------------------------------
# plain versions (ports of the reference's jnp functions)


def gather_merge_reference(table, slots, miss_rows=None):
    """K1's plain version: ``out[i] = table[slots[i]]`` where the slot
    is a row of the table, else ``miss_rows[i]`` (zeros when None)."""
    slots = slots.long()
    hit = (slots >= 0) & (slots < table.shape[0])
    gathered = table[torch.where(hit, slots, 0)]
    if miss_rows is None:
        miss_rows = torch.zeros_like(gathered)
    return torch.where(hit[:, None], gathered, miss_rows)


def set_rows_reference(table, slots, rows=None):
    """K2's plain version: ``table[slots[i]] = rows[i]`` (zeros when
    None) in place, skipping slots outside the table."""
    slots = slots.long()
    valid = (slots >= 0) & (slots < table.shape[0])
    table[slots[valid]] = 0.0 if rows is None else rows[valid]
    return table


def insert_rows_reference(state, slots, rows):
    """K2's plain version, in place: the reference's insert of staged
    promotions (``_jnp_insert_gather``'s three ``.at[].set``): at every
    slot inside the table, the weights' row = ``rows[i]``, each slot
    buffer's row = 0 and the step count = 0; slots outside the table
    are skipped. Returns ``state``."""
    slots = slots.long()
    valid = (slots >= 0) & (slots < state["rows"].shape[0])
    target = slots[valid]
    state["rows"][target] = rows[valid]
    for key in _slot_keys(state):
        state[key][target] = 0.0
    state["steps"][target] = 0
    return state


def scatter_apply_reference(state, slots, grads, opt_type, lr, momentum,
                            beta1, beta2, epsilon):
    """K3's plain version, in place: the reference's
    ``_jnp_scatter_apply`` (misses, slot -1, go to the scratch row,
    which the kernel leaves alone; fp32 bias corrections ``1 - beta **
    t``)."""
    rows = state["rows"]
    scratch = rows.shape[0] - 1
    slots = slots.long()
    target = torch.where(slots >= 0, slots, scratch)
    w = rows[target]
    step = state["steps"][target] + 1
    if opt_type == "sgd":
        new_w = w - lr * grads
    elif opt_type in ("momentum", "nesterov"):
        m = momentum * state["slot0"][target] + grads
        if opt_type == "nesterov":
            new_w = w - lr * (grads + momentum * m)
        else:
            new_w = w - lr * m
        state["slot0"][target] = m
    elif opt_type == "adagrad":
        s = state["slot0"][target] + grads * grads
        new_w = w - lr * grads / (torch.sqrt(s) + epsilon)
        state["slot0"][target] = s
    elif opt_type == "adam":
        m = beta1 * state["slot0"][target] + (1.0 - beta1) * grads
        v = beta2 * state["slot1"][target] + (1.0 - beta2) * grads * grads
        stepf = step.to(torch.float32)[:, None]
        mhat = m / (1.0 - torch.pow(beta1, stepf))
        vhat = v / (1.0 - torch.pow(beta2, stepf))
        new_w = w - lr * mhat / (torch.sqrt(vhat) + epsilon)
        state["slot0"][target] = m
        state["slot1"][target] = v
    else:
        raise ValueError("unsupported tier optimizer %r" % opt_type)
    rows[target] = new_w
    state["steps"][target] = step
    return state


# ---------------------------------------------------------------------
# kernel wrappers


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def _check(name, table, slots, rows=None, rows_name="rows"):
    """Raise unless the CUDA tensors are what the kernels take: an fp32
    contiguous ``[R, dim]`` table, contiguous int32 ``[n]`` slots and
    (optionally) contiguous fp32 ``[n, dim]`` rows, on one device."""
    if (table.dtype != torch.float32 or table.dim() != 2
            or not table.is_contiguous()):
        raise ValueError("%s: the table must be a contiguous 2-D fp32 "
                         "tensor; got %s %s" % (name, table.dtype,
                                                tuple(table.shape)))
    if (slots.dtype != torch.int32 or slots.dim() != 1
            or not slots.is_contiguous()):
        raise ValueError("%s: slots must be a contiguous 1-D int32 tensor; "
                         "got %s %s" % (name, slots.dtype,
                                        tuple(slots.shape)))
    tensors = [table, slots]
    if rows is not None:
        if (rows.dtype != torch.float32 or not rows.is_contiguous()
                or tuple(rows.shape) != (slots.shape[0], table.shape[1])):
            raise ValueError(
                "%s: %s must be contiguous fp32 [%d, %d]; got %s %s"
                % (name, rows_name, slots.shape[0], table.shape[1],
                   rows.dtype, tuple(rows.shape))
            )
        tensors.append(rows)
    if any(t.device != table.device for t in tensors):
        raise ValueError("%s: inputs must share one device" % name)
    if table.shape[0] >= 2 ** 31 or table.numel() >= 2 ** 40:
        raise ValueError("%s: the table is too large for int32 slots" % name)


def _lib(name, device):
    if device.type != "cuda":
        raise ValueError("%s: unsupported device %s" % (name, device))
    from elasticdl_tpu_torch.ops import _build

    return _build.load("embedding_tier")


def _raise_on(err, name, shape):
    if err != 0:
        raise RuntimeError("%s kernel launch failed: cudaError %d (shape %s)"
                           % (name, err, shape))


def gather_merge(table, slots, miss_rows=None):
    """K1: ``[n, dim]`` rows, ``table[slots[i]]`` where ``slots[i]`` is
    a row of the table, else ``miss_rows[i]`` (zeros when None). A miss
    never reads the table.

    CUDA tensors launch the kernel (fp32 contiguous table and miss rows,
    contiguous int32 slots; anything else raises); CPU tensors run
    ``gather_merge_reference``."""
    return _gather_merge(table, slots, miss_rows, pdl=False)[0]


def _gather_merge(table, slots, miss_rows, pdl):
    """``gather_merge`` -> (out, whether K1 was launched). ``pdl``
    launches K1 as the programmatic dependent of the previous kernel in
    the stream (embedding_tier.cu: launch): ``slots`` and ``miss_rows``
    must have been written before that kernel started."""
    if table.device.type == "cpu":
        return gather_merge_reference(table, slots, miss_rows), False
    _check("gather_merge", table, slots, miss_rows, "miss_rows")
    lib = _lib("gather_merge", table.device)
    n, dim = slots.shape[0], table.shape[1]
    out = torch.empty((n, dim), dtype=table.dtype, device=table.device)
    if n == 0:
        return out, False
    with torch.cuda.device(table.device):
        err = lib.edl_tier_gather(
            table.data_ptr(), slots.data_ptr(),
            None if miss_rows is None else miss_rows.data_ptr(),
            out.data_ptr(), n, dim, table.shape[0], int(pdl),
            _stream(table.device),
        )
    _raise_on(err, "gather_merge", (n, dim))
    _count("GATHER_LAUNCHES")
    return out, True


def _check_state(name, state):
    """Raise unless the state's slot buffers match its rows (contiguous
    fp32 ``[R, dim]`` on one device) and its steps are contiguous int32
    ``[R]`` there; returns the slot buffers' keys."""
    rows = state["rows"]
    keys = _slot_keys(state)
    if len(keys) > 2:
        raise ValueError("%s: at most two slot buffers, the state has %s"
                         % (name, keys))
    for key in keys:
        if (state[key].shape != rows.shape or state[key].dtype != rows.dtype
                or state[key].device != rows.device
                or not state[key].is_contiguous()):
            raise ValueError("%s: %s must match rows" % (name, key))
    steps = state["steps"]
    if (steps.dtype != torch.int32 or tuple(steps.shape) != (rows.shape[0],)
            or steps.device != rows.device or not steps.is_contiguous()):
        raise ValueError("%s: steps must be contiguous int32 [%d]"
                         % (name, rows.shape[0]))
    return keys


def _insert(name, table, slot_bufs, steps, slots, rows, pdl=False):
    """Launch K2 on CUDA tensors already checked: ``table`` at ``slots``
    = ``rows`` (zeros when None), each of ``slot_bufs`` (0-2) zeroed and
    ``steps`` (or None) reset there; ``pdl`` as in ``_gather_merge``.
    Returns whether it launched."""
    lib = _lib(name, table.device)
    n, dim = slots.shape[0], table.shape[1]
    if n == 0:
        return False
    ptrs = [b.data_ptr() for b in slot_bufs] + [None] * (2 - len(slot_bufs))
    with torch.cuda.device(table.device):
        err = lib.edl_tier_insert_rows(
            table.data_ptr(), ptrs[0], ptrs[1],
            None if steps is None else steps.data_ptr(), slots.data_ptr(),
            None if rows is None else rows.data_ptr(),
            n, dim, table.shape[0], int(pdl), _stream(table.device),
        )
    _raise_on(err, name, (n, dim))
    _count("SET_ROWS_LAUNCHES")
    return True


def set_rows(table, slots, rows=None):
    """K2 on one buffer: ``table[slots[i]] = rows[i]`` (zeros when None)
    in place; returns ``table``. Slots outside the table are skipped.

    CUDA tensors launch the kernel (as ``gather_merge`` takes them);
    CPU tensors run ``set_rows_reference``."""
    if table.device.type == "cpu":
        return set_rows_reference(table, slots, rows)
    _check("set_rows", table, slots, rows)
    _insert("set_rows", table, (), None, slots, rows)
    return table


def insert_rows(state, slots, rows):
    """K2: insert staged rows into the whole table state in one launch,
    in place: at every slot inside the table, the weights' row =
    ``rows[i]``, each slot buffer's row = 0 and the step count = 0.
    Returns ``state``.

    CUDA tensors launch the kernel (the state as ``scatter_apply`` takes
    it, int32 slots, fp32 ``[n, dim]`` rows; anything else raises); CPU
    tensors run ``insert_rows_reference``."""
    _insert_rows(state, slots, rows, pdl=False)
    return state


def _insert_rows(state, slots, rows, pdl):
    """``insert_rows`` -> whether K2 was launched; ``pdl`` as in
    ``_gather_merge``."""
    table = state["rows"]
    if table.device.type == "cpu":
        insert_rows_reference(state, slots, rows)
        return False
    _check("insert_rows", table, slots, rows)
    keys = _check_state("insert_rows", state)
    return _insert("insert_rows", table, [state[k] for k in keys],
                   state["steps"], slots, rows, pdl)


def scatter_apply(state, slots, grads, opt_type, lr, momentum, beta1,
                  beta2, epsilon):
    """K3: one ``opt_type`` step of ``grads [n, dim]`` into the state's
    rows, slot buffers and int32 step counts at ``slots``, in place;
    returns ``state``. A miss (slot -1) touches nothing on the card;
    the plain version sends it to the scratch row, as the reference
    does, which nothing reads.

    CUDA tensors launch the kernel (the state's buffers contiguous fp32
    ``[R, dim]`` and int32 ``[R]``, grads contiguous fp32; anything
    else raises); CPU tensors run ``scatter_apply_reference``."""
    if opt_type not in _OPT_CODES:
        raise ValueError("unsupported tier optimizer %r" % opt_type)
    rows = state["rows"]
    if rows.device.type == "cpu":
        return scatter_apply_reference(state, slots, grads, opt_type, lr,
                                       momentum, beta1, beta2, epsilon)
    _check("scatter_apply", rows, slots, grads, "grads")
    keys = _check_state("scatter_apply", state)
    if len(keys) != TIER_OPT_SLOTS[opt_type]:
        raise ValueError("scatter_apply: %s needs %d slot buffers, the "
                         "state has %s" % (opt_type,
                                           TIER_OPT_SLOTS[opt_type], keys))
    lib = _lib("scatter_apply", rows.device)
    n, dim = slots.shape[0], rows.shape[1]
    if n == 0:
        return state
    slot_ptrs = [state[k].data_ptr() for k in keys] + [None] * (2 - len(keys))
    # 1 - beta in double, rounded once to fp32: what the plain version's
    # (1.0 - beta) * g multiplies by
    with torch.cuda.device(rows.device):
        err = lib.edl_tier_scatter_apply(
            grads.data_ptr(), slots.data_ptr(), rows.data_ptr(),
            slot_ptrs[0], slot_ptrs[1], state["steps"].data_ptr(),
            n, dim, rows.shape[0], _OPT_CODES[opt_type],
            float(lr), float(momentum), float(beta1),
            float(np.float32(1.0 - beta1)), float(beta2),
            float(np.float32(1.0 - beta2)), float(epsilon),
            _stream(rows.device),
        )
    _raise_on(err, "scatter_apply", (n, dim))
    _count("SCATTER_APPLY_LAUNCHES")
    return state


# ---------------------------------------------------------------------
# fused ops (the reference's public surface)


def fused_insert_gather(state, ins_slots, ins_rows, evict_slots, slots,
                        miss_rows):
    """-> (state, combined_rows, evicted_rows); ``state`` is updated in
    place. Order matters: victims are read BEFORE staged inserts land
    (an insert may reuse a victim's slot this very step), and the
    combined buffer is gathered AFTER (a promotion is a hit from its
    first step). ``ins_slots``/``evict_slots`` may be empty (no launch)
    or padded with the scratch slot; ``slots`` pads misses with -1.

    On the card the three launches form one chain: the first launches
    plainly, each later one as the programmatic dependent of the one
    before (embedding_tier.cu: launch), so every slot array and row
    argument must already be written when the call is made (the tier
    copies them from the host first)."""
    evicted, chained = _gather_merge(state["rows"], evict_slots, None,
                                     pdl=False)
    chained = _insert_rows(state, ins_slots, ins_rows, pdl=chained) or \
        chained
    combined, _ = _gather_merge(state["rows"], slots, miss_rows, pdl=chained)
    return state, combined, evicted


def fused_scatter_apply(state, slots, grads, opt_type="sgd", lr=0.01,
                        momentum=0.9, beta1=0.9, beta2=0.999,
                        epsilon=1e-8):
    """Apply one step's row gradients to the resident slots in place
    (``scatter_apply``; a miss changes no row anyone reads); returns
    ``state``."""
    return scatter_apply(state, slots, grads, opt_type, lr, momentum,
                         beta1, beta2, epsilon)


def gather_rows(state, slots):
    """A copy of the resident rows at ``slots`` (flush / eviction
    writeback reads); zeros for a negative slot."""
    return gather_merge(state["rows"], slots)

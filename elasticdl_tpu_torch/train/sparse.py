"""Sparse embedding training: host PS tables + the step on the card
(port of elasticdl_tpu/train/sparse.py).

The lookup happens before the step, not inside it:

  host:  ids -> unique -> rows (device-tier hits stay on the card,
         misses are pulled from the PS through ``EmbeddingClient``)
  card:  the step takes the rows as an INPUT, gathers and combines them
         in the model, and returns d(loss)/d(rows) beside the dense
         update (``loss.backward`` through ``torch.autograd.grad``)
  host:  the miss rows' gradients go back to the PS as IndexedSlices;
         the tier's hit rows are updated on the card by K3

The unique-id buffer is padded to a fixed per-table capacity, so every
step has the same shapes.

Three ways to drive it: ``train_step`` (sequential, with the sync-PS
retry of a rejected push), ``train_step`` under ``EDL_ASYNC_PUSH`` (the
push of step N runs on a thread while step N+1 computes), and
``train_stream`` (the pipelined path: the next batch's prepare and
pull run on a lookahead thread under the current step, pushes run on a
push thread, and ``push_interval`` steps accumulate into one push). An
optional ``HotRowCache`` (``cache_staleness``) reuses pulled rows for a
bounded number of prepares; the device tier supersedes it.

The row gradients come to the host through a non-blocking copy into
host buffers the trainer reuses every step (pinned on the card),
started when the step is dispatched, with the loss and the health
scalars beside them; ``_fold`` waits for it. The buffers are reused,
so what leaves them for a push or an accumulation is copied out first.

The step's host-blocking row-gradient fetch is a ``transfer`` span
(observability/device.py), the async push keeps its step's trace
context (``trace.bind_context``), and brownout skips and recoveries are
journaled.

Not ported yet: the serving tier's read-only preparer, the SPMD and
multi-host hooks (the tier's mesh, the per-process row-gradient
shard), the fault injector's poisoned batch and the device-obs cost
counters.
"""

import concurrent.futures

import grpc
import numpy as np
import torch

from elasticdl_tpu_torch.common import overload
from elasticdl_tpu_torch.common.args import bool_flag
from elasticdl_tpu_torch.common.device import resolve_device
from elasticdl_tpu_torch.common.env_utils import env_str
from elasticdl_tpu_torch.common.log_utils import (
    default_logger as _logger_factory,
)
from elasticdl_tpu_torch.common.tensor_utils import deduplicate_indexed_slices
from elasticdl_tpu_torch.common.timing_utils import Timing
from elasticdl_tpu_torch.data.pipeline import MASK_KEY
from elasticdl_tpu_torch.observability import device as device_obs
from elasticdl_tpu_torch.observability import events, trace
from elasticdl_tpu_torch.embedding.client import (  # noqa: F401
    EmbeddingClient,
    HotRowCache,
)
from elasticdl_tpu_torch.models.layers import has_uninitialized_params
from elasticdl_tpu_torch.train.device_tier import (
    DeviceEmbeddingTier,
    resolve_tier_config,
)
from elasticdl_tpu_torch.train.health import maybe_tracker
from elasticdl_tpu_torch.train.losses import masked_mean
from elasticdl_tpu_torch.train.step_fns import (
    apply_model,
    apply_update,
    global_grad_norm,
    health_scalars,
    make_eval_step,
)
from elasticdl_tpu_torch.train.train_state import (
    cast_floating,
    create_train_state,
    resolve_dtype,
)

logger = _logger_factory("elasticdl_tpu_torch.train.sparse")

# Double-buffered async push of train_step: step N's push runs on a
# thread while step N+1 computes; the depth-1 barrier (join_pushes)
# joins it before the next push and before eval.
ASYNC_PUSH_ENV = "EDL_ASYNC_PUSH"

ROWS_SUFFIX = "__rows"
INDICES_SUFFIX = "__indices"
# planted by SparseBatchPreparer when a batch or spec has a mask: bool
# [B, F] marking real (non-padding) slots, consumed by embedding_lookup
SLOT_MASK_SUFFIX = "__slotmask"


class SparseEmbeddingSpec:
    """One host-side embedding table used by a model.

    feature_key: the feature holding int ids, shape [B] or [B, F].
    capacity: padded unique-ids buffer size (static shape); defaults to
    batch_size * F at prepare time if 0.
    """

    def __init__(self, name, dim, feature_key=None, capacity=0,
                 init_scale=0.05, initializer="uniform"):
        self.name = name
        self.dim = dim
        self.feature_key = feature_key or name
        self.capacity = capacity
        self.init_scale = init_scale
        # uniform / constant / normal / truncated_normal / zeros
        self.initializer = initializer


def _wire_initializer(spec):
    """Wire string for a table's initializer: a bare float for uniform
    (the original encoding), else "kind:param"."""
    if spec.initializer in (None, "uniform"):
        return str(float(spec.init_scale))
    return "%s:%s" % (spec.initializer, float(spec.init_scale))


def embedding_lookup(features, name, combiner=None):
    """Model side: gather pulled rows and sum them over the feature axis.

    rows: [capacity, dim]; indices: [B] or [B, F] positions into rows.
    Returns [B, dim] (summed, ``combiner="sum"``) or [B, F, dim] when
    combiner is None. Padded slots (the batch-mask slot mask) count as
    zero rows.
    """
    rows = features[name + ROWS_SUFFIX]
    indices = features[name + INDICES_SUFFIX]
    gathered = rows[indices.long()]  # [B, dim] or [B, F, dim]
    mask = features.get(name + SLOT_MASK_SUFFIX)
    if mask is not None and gathered.dim() == 3:
        # padded slots index row 0 of the pulled buffer; zero them
        gathered = gathered * mask.to(gathered.dtype)[..., None]
    if gathered.dim() == 2 or combiner is None:
        return gathered
    if combiner != "sum":
        # the reference's mean and sqrtn combiners wait for a model
        # that uses them
        raise ValueError("unsupported combiner %r" % combiner)
    return gathered.sum(dim=1)


class PullInfo(dict):
    """``{table: (push_ids, n)}`` for the gradient push, plus the
    device-tier step context as attributes (slots and push positions
    per table, and the tier epoch the lookups ran under)."""

    tier_ctx = None
    tier_epoch = None


class SparseBatchPreparer:
    """Host side: swap raw id features for (rows, indices) pairs.

    With a device tier, each table's unique ids are looked up in the
    hot set first; only the misses reach the PS pull, and ids promoted
    this step leave the PS push set (their gradients apply on the
    card). All tables' pulls ride one fused pull call, through an
    optional ``HotRowCache``.

    ``read_only=True`` is the serving consumer: it registers no table
    (the training job created them), never pushes, and leaves the PS
    client's resync hook alone (the serving engine chains its own cache
    drop there, ``serve/engine.py``).
    """

    def __init__(self, specs, ps_client, cache=None, device_tier=None,
                 read_only=False):
        self._specs = list(specs)
        self._ps = ps_client
        self._registered = False
        self._read_only = bool(read_only)
        if cache is not None and device_tier is not None:
            # The tier supersedes the cache: a cache-stale row must
            # never become a promotion's staged value, because the tier
            # makes resident values authoritative (writebacks overwrite
            # the PS), which would erase the gradients the PS applied
            # within the staleness window.
            logger.warning(
                "HotRowCache disabled: the device embedding tier owns the "
                "hot set, and stale cached rows must not be promoted as "
                "authoritative tier values"
            )
            cache = None
        self._embedding = EmbeddingClient(ps_client, cache=cache)
        self._tier = device_tier
        # set by _on_ps_restart (maybe on the push thread), consumed at
        # the top of prepare() on the pulling thread
        self._cache_dirty = False
        # the hook slot has one owner (the last writer): a read-only
        # preparer must not take it from a co-resident trainer, and the
        # serving engine drops the shared cache itself
        if not self._read_only and hasattr(ps_client, "resync_hook"):
            ps_client.resync_hook = self._on_ps_restart

    @property
    def ps_num(self):
        return getattr(self._ps, "ps_num", 1)

    @property
    def cache(self):
        return self._embedding.cache

    def _on_ps_restart(self, shard):
        """A relaunched PS shard (the PS client's resync hook):
        re-register the tables on the next prepare, drop the cache there
        (deferred: this may fire on the push thread, and the cache has
        one writer, the pulling thread), and flush-then-invalidate the
        tier."""
        del shard
        if not self._read_only:
            self._registered = False
        self._cache_dirty = True
        if self._tier is not None:
            # host maps invalidate NOW (thread-safe); the dirty rows'
            # device values flush back to the restored PS from the
            # dispatch thread before the state resets
            self._tier.mark_restart()

    def register_tables(self):
        if self._read_only:
            return
        if not self._registered:
            self._ps.push_embedding_table_infos(
                [(s.name, s.dim, _wire_initializer(s)) for s in self._specs]
            )
            self._registered = True

    def _pull_tables(self, plans):
        """{name: rows [n_unique, dim] float32} for every table with
        ids to pull."""
        return self._embedding.pull_tables({
            spec.name: unique for spec, unique, _ in plans if unique.size
        })

    def prepare(self, batch):
        """Returns (batch with rows/indices features, pull_info) where
        pull_info = {name: (push_ids, n)} for the grad push (all unique
        ids without a device tier; only the un-promoted misses with
        one). Host only: it creates no tensor on the card and launches
        nothing, so it may run on a lookahead thread."""
        self.register_tables()
        if self.cache is not None:
            if self._cache_dirty:
                # the deferred PS-relaunch invalidation
                self._cache_dirty = False
                self._embedding.invalidate()
            self._embedding.advance()
        if self._tier is not None:
            self._tier.advance()
        features = dict(batch["features"])
        # zero-padded batch rows must be invisible to the PS: their ids
        # would create and pull rows the data never asked for, and shift
        # every later lazy init of the table's RNG stream
        batch_mask = None
        if MASK_KEY in batch:
            batch_mask = np.asarray(batch[MASK_KEY]) > 0
        pull_info = PullInfo()
        if self._tier is not None:
            pull_info.tier_ctx = {}
            pull_info.tier_epoch = self._tier.epoch
        consumed = set()
        plans = []
        tier_meta = {}  # name -> (unique, slots, miss_pos)
        for spec in self._specs:
            # several tables may read one id feature (DeepFM's
            # second-order and linear tables): consume keys at the end
            ids = np.asarray(features[spec.feature_key])
            consumed.add(spec.feature_key)
            capacity = spec.capacity or int(np.prod(ids.shape))
            mask = None
            if batch_mask is not None:
                mask = np.broadcast_to(
                    batch_mask.reshape((-1,) + (1,) * (ids.ndim - 1)),
                    ids.shape,
                )
            if mask is not None:
                unique, inv_real = np.unique(ids[mask], return_inverse=True)
                # padded slots index row 0; the slot-mask feature zeroes
                # their contribution in embedding_lookup
                inverse = np.zeros(ids.shape, dtype=np.int64)
                inverse[mask] = inv_real
                features[spec.name + SLOT_MASK_SUFFIX] = mask
            else:
                unique, inverse = np.unique(ids, return_inverse=True)
            if unique.size > capacity:
                raise ValueError(
                    "Batch has %d unique ids for table %s (capacity %d); "
                    "raise SparseEmbeddingSpec.capacity"
                    % (unique.size, spec.name, capacity)
                )
            features[spec.name + INDICES_SUFFIX] = inverse.reshape(
                ids.shape
            ).astype(np.int32)
            if self._tier is not None and unique.size:
                # hot-set lookup first: only misses reach the PS
                slots = self._tier.lookup(spec.name, unique)
                miss_pos = np.nonzero(slots < 0)[0]
                if miss_pos.size:
                    # a miss id with an eviction writeback in flight is
                    # pulled only after the writeback lands
                    self._tier.wait_for_writebacks(
                        spec.name, unique[miss_pos]
                    )
                tier_meta[spec.name] = (unique, slots, miss_pos)
                plans.append((spec, unique[miss_pos], capacity))
            else:
                plans.append((spec, unique, capacity))
        pulled = self._pull_tables(plans)
        for spec, pull_ids, capacity in plans:
            padded = np.zeros((capacity, spec.dim), dtype=np.float32)
            meta = tier_meta.get(spec.name)
            if meta is None:
                if pull_ids.size:
                    padded[: pull_ids.size] = pulled[spec.name]
                features[spec.name + ROWS_SUFFIX] = padded
                pull_info[spec.name] = (pull_ids, pull_ids.size)
                continue
            unique, slots, miss_pos = meta
            fetched = (
                np.asarray(pulled[spec.name], np.float32)
                if pull_ids.size
                else np.empty((0, spec.dim), np.float32)
            )
            if miss_pos.size:
                # PS rows land at their miss positions; hit positions
                # stay zero and are filled on the card at combine time
                padded[miss_pos] = fetched
            promoted, new_slots = self._tier.admit(
                spec.name, pull_ids, fetched
            )
            if promoted.size and promoted.any():
                # promoted ids are hits from THIS step on: their
                # gradient applies on the card, so they leave the push
                # set (pushing too would apply the step twice)
                slots = slots.copy()
                slots[miss_pos[promoted]] = new_slots
            push_pos = miss_pos[~promoted] if promoted.size else miss_pos
            push_ids = pull_ids[~promoted] if promoted.size else pull_ids
            slots_padded = np.full((capacity,), -1, np.int32)
            slots_padded[: unique.size] = slots
            features[spec.name + ROWS_SUFFIX] = padded
            pull_info[spec.name] = (push_ids, int(push_ids.size))
            pull_info.tier_ctx[spec.name] = {
                "slots": slots_padded,
                "push_pos": push_pos,
            }
        for key in consumed:
            features.pop(key, None)
        out = dict(batch)
        out["features"] = features
        return out, pull_info

    def push_gradients(self, row_grads, pull_info, model_version=0,
                       only_shards=None):
        """Push each table's first n row gradients (host arrays) under
        its pull_info ids; returns ``(accepted, version,
        rejected_shards)``."""
        if self._read_only:
            raise RuntimeError("a read-only preparer never pushes")
        grads_by_table = {}
        for name, (unique, n) in pull_info.items():
            if n == 0:
                continue
            grads_by_table[name] = (np.asarray(row_grads[name])[:n], unique)
        kwargs = {"model_version": model_version}
        if only_shards is not None:
            kwargs["only_shards"] = only_shards
        return _normalize_push_result(
            self._ps.push_gradients(grads_by_table, **kwargs),
            model_version,
        )

    def close(self):
        self._embedding.close()


def _normalize_push_result(result, model_version):
    """Client push results are (accepted, version[, rejected_shards]);
    a None rejected set means unknown: every shard is retryable."""
    if result is None:
        return True, model_version, ()
    parts = tuple(result)
    if len(parts) >= 3:
        rejected = parts[2]
        return (parts[0], parts[1],
                None if rejected is None else tuple(rejected))
    accepted, version = parts
    return accepted, version, None if not accepted else ()


def _host(value):
    """A tensor (any device) or array as a numpy array; bf16 goes out
    as fp32, which holds every bf16 value exactly."""
    if isinstance(value, torch.Tensor):
        value = value.detach()
        if value.dtype == torch.bfloat16:
            value = value.float()
        return value.cpu().numpy()
    return np.asarray(value)


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    array = np.asarray(tree)
    if not array.flags.writeable:
        # a broadcast view (the batch-mask slot mask): torch takes only
        # writable memory
        array = array.copy()
    return torch.as_tensor(array).to(device)


def _forward_loss(model, loss_fn, compute_dtype, params, model_state, rows,
                  features, labels, mask):
    """The masked mean loss of the model at ``params`` on ``features``
    merged with the pulled ``rows``."""
    if compute_dtype is not None:
        params = cast_floating(params, compute_dtype)
        rows = cast_floating(rows, compute_dtype)
        features = cast_floating(features, compute_dtype)
    outputs = apply_model(model, params, model_state, {**features, **rows})
    return masked_mean(loss_fn(labels, outputs).float(), mask)


def make_sparse_train_step(model, loss_fn, tx, specs, compute_dtype=None,
                           health=False, guard_nonfinite=False):
    """Returns train_step(state, batch) -> (state, loss, row_grads) where
    row_grads = {table: d(loss)/d(rows) fp32 [capacity, dim]} and the
    dense params were updated in place.

    ``health=True`` appends a fourth output, the health scalars (the
    global grad norm over dense AND row gradients, and the nonfinite
    flag); ``guard_nonfinite`` keeps the previous dense state on a
    nonfinite batch (the caller then drops the row-gradient push and
    the tier apply, so the batch contributes nothing anywhere)."""
    row_keys = [spec.name + ROWS_SUFFIX for spec in specs]

    def train_step(state, batch):
        features = dict(batch["features"])
        labels, mask = batch["labels"], batch[MASK_KEY]
        rows = {key: features.pop(key).detach().requires_grad_()
                for key in row_keys}
        params = {n: p.detach().requires_grad_()
                  for n, p in state.params.items()}
        loss = _forward_loss(model, loss_fn, compute_dtype, params,
                             state.model_state, rows, features, labels,
                             mask)
        leaves = list(params.values()) + list(rows.values())
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g.float()
                 for x, g in zip(leaves, grads)]
        param_grads = dict(zip(params, grads[:len(params)]))
        # strip the suffix for the caller: {table_name: grad rows}
        row_grads = {key[: -len(ROWS_SUFFIX)]: g
                     for key, g in zip(rows, grads[len(params):])}
        loss = loss.detach()
        if not health:
            return apply_update(tx, state, param_grads), loss, row_grads
        scalars = health_scalars(
            loss, global_grad_norm(param_grads, row_grads)
        )
        if guard_nonfinite and bool(scalars["nonfinite"]):
            return state, loss, row_grads, scalars
        return apply_update(tx, state, param_grads), loss, row_grads, scalars

    return train_step


def make_row_grads_fn(model, loss_fn, specs, compute_dtype=None):
    """d(loss)/d(rows) at FIXED params: the sync-PS retry path. When a
    push is rejected as stale, fresh rows are pulled and only the row
    gradients are recomputed (the dense params were already updated on
    the card)."""
    row_keys = [spec.name + ROWS_SUFFIX for spec in specs]

    def row_grads(state, batch):
        features = dict(batch["features"])
        labels, mask = batch["labels"], batch[MASK_KEY]
        rows = {key: features.pop(key).detach().requires_grad_()
                for key in row_keys}
        params = {n: p.detach() for n, p in state.params.items()}
        loss = _forward_loss(model, loss_fn, compute_dtype, params,
                             state.model_state, rows, features, labels,
                             mask)
        leaves = list(rows.values())
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        return {
            key[: -len(ROWS_SUFFIX)]: (torch.zeros_like(x) if g is None
                                       else g.float())
            for key, x, g in zip(rows, leaves, grads)
        }

    return row_grads


class _HostFetch:
    """Host buffers for a step's loss, health scalars and row
    gradients, reused every step (pinned when the step runs on the
    card, so the copy can overlap the host's work), and the copy into
    them.

    ``start`` issues every copy without waiting (``non_blocking``) and
    records a CUDA event after them; ``wait`` blocks on that event. On
    the CPU the copies are done when ``start`` returns, into the same
    reused buffers, so the CPU tests see the card's aliasing.
    """

    def __init__(self, device):
        self._pin = device.type == "cuda"
        self._buffers = {}

    def _buffer(self, key, like):
        buf = self._buffers.get(key)
        if buf is None or buf.shape != like.shape or buf.dtype != like.dtype:
            buf = torch.empty(like.shape, dtype=like.dtype,
                              pin_memory=self._pin)
            self._buffers[key] = buf
        return buf

    def start(self, tensors):
        """{key: tensor} -> (the host buffers {key: tensor}, an event
        recorded after the copies or None)."""
        host = {}
        for key, value in tensors.items():
            buf = self._buffer(key, value)
            buf.copy_(value.detach(), non_blocking=self._pin)
            host[key] = buf
        event = None
        if self._pin:
            event = torch.cuda.Event()
            event.record()
        return host, event

    @staticmethod
    def wait(event):
        if event is not None:
            event.synchronize()


class _Flight:
    """A dispatched step: its device row gradients and pull info, and
    the host copy of its loss, health scalars and row gradients."""

    __slots__ = ("row_grads", "pull_info", "host", "event")

    def __init__(self, row_grads, pull_info, host, event):
        self.row_grads = row_grads
        self.pull_info = pull_info
        self.host = host
        self.event = event


class SparseTrainer:
    """Trainer surface (create_state/train_step/train_stream/eval_step)
    over dense params on ``device`` and host-PS sparse tables, with an
    optional device tier whose kernels run on the same device."""

    # the reference retried a rejected minibatch up to 64 times against
    # the sync PS
    MAX_PUSH_RETRIES = 64

    def __init__(self, model, loss_fn, optimizer, specs, ps_client,
                 compute_dtype=None, seed=0, cache_staleness=0,
                 cache_capacity=1_000_000, async_push=None, device_tier=None,
                 health=None, device="cuda"):
        """``model`` trains in place on ``device`` (``cuda`` unless the
        caller asks for the CPU; no card raises). ``cache_staleness`` >
        0 fronts the pulls with a ``HotRowCache`` of ``cache_capacity``
        rows. ``async_push``: None reads EDL_ASYNC_PUSH. ``device_tier``:
        None reads EDL_DEVICE_TIER*, False disables, True or a
        DeviceTierConfig opts in. ``health``: None reads EDL_HEALTH
        (default on), False disables, or pass a HealthTracker."""
        self.device = resolve_device(device)
        self._model = model.to(self.device)
        self._tx = optimizer
        self._seed = seed
        self._specs = list(specs)
        if health is None:
            self.health = maybe_tracker(role="worker")
        elif health is False:
            self.health = None
        else:
            self.health = health
        self._health_on = self.health is not None
        cache = (HotRowCache(cache_staleness, cache_capacity)
                 if cache_staleness > 0 else None)
        tier_config = resolve_tier_config(device_tier)
        self.device_tier = None
        if tier_config is not None:
            self.device_tier = DeviceEmbeddingTier(
                self._specs, ps_client, tier_config, device=self.device
            )
        self.preparer = SparseBatchPreparer(
            self._specs, ps_client, cache=cache,
            device_tier=self.device_tier,
        )
        compute_dtype = resolve_dtype(compute_dtype)
        self._train_step = make_sparse_train_step(
            self._model, loss_fn, optimizer, self._specs, compute_dtype,
            health=self._health_on,
            guard_nonfinite=(self._health_on
                             and self.health.action == "skip"),
        )
        self._row_grads = make_row_grads_fn(self._model, loss_fn,
                                            self._specs, compute_dtype)
        self._eval_step = make_eval_step(self._model, compute_dtype)
        self._fetch = _HostFetch(self.device)
        self._version = 0
        # sync-PS version rejections retried through so far
        self.push_rejections = 0
        # brownout: consecutive overload-class push failures absorbed,
        # and the lifetime count of pushes dropped
        self._brownout_streak = 0
        self.brownout_skipped_pushes = 0
        if async_push is None:
            raw = env_str(ASYNC_PUSH_ENV, "").strip()
            # the bool spellings of every knob; garbage fails here
            async_push = bool(bool_flag(raw)) if raw else False
        self._async_push = bool(async_push)
        self._push_future = None
        self._async_pool = None
        if self._async_push:
            self._async_pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="sparse-async-push"
            )
        # memo of the last prepared batch, so ensure_state followed by
        # eval_step/train_step on the same batch pulls rows once
        self._prep_memo = None
        # per-phase wall clock (EDL_TIMING=1): sparse_pull, sparse_push,
        # batch_process
        self.timing = Timing()

    @property
    def model(self):
        """The module being trained (its parameters are the state's)."""
        return self._model

    def create_state(self, sample_features):
        """State over the model's weights. A model with lazily sized
        layers (DeepFM's first dense layer takes fields x dim inputs) is
        run once on ``sample_features`` to size them and is then
        initialised from the trainer's seed through its
        ``reset_parameters(generator)``; a model whose weights exist
        (built or loaded) keeps them."""
        if has_uninitialized_params(self._model):
            features = _to_device(sample_features, self.device)
            devices = [self.device] if self.device.type == "cuda" else []
            # sizing draws no number from the caller's RNG streams
            with torch.random.fork_rng(devices=devices), torch.no_grad():
                self._model(features)
            reset = getattr(self._model, "reset_parameters", None)
            if reset is not None:
                reset(torch.Generator().manual_seed(self._seed))
        return create_train_state(self._model, self._tx)

    def _prepare_once(self, batch):
        if self._prep_memo is not None and self._prep_memo[0] is batch:
            return self._prep_memo[1], self._prep_memo[2]
        with self.timing.timeit("sparse_pull"):
            prepared, pull_info = self.preparer.prepare(batch)
        self._prep_memo = (batch, prepared, pull_info)
        return prepared, pull_info

    def ensure_state(self, state, batch):
        if state is None:
            prepared, _ = self._prepare_once(batch)
            return self.create_state(prepared["features"])
        return state

    def _tier_combine(self, batch, prepared, pull_info):
        """Materialize the step's row buffers of the tier's tables on
        the card (staged promotions land, eviction victims read out,
        hits gathered). If a PS relaunch invalidated the tier since this
        batch's prepare (the epoch moved), the batch is re-prepared: its
        slots point into a map that no longer exists."""
        tier = self.device_tier
        ctx = getattr(pull_info, "tier_ctx", None)
        if tier is None or not ctx:
            return prepared, pull_info
        if pull_info.tier_epoch != tier.epoch:
            prepared, pull_info = self.preparer.prepare(batch)
            ctx = getattr(pull_info, "tier_ctx", None) or {}
        features = dict(prepared["features"])
        for name, step_ctx in ctx.items():
            features[name + ROWS_SUFFIX] = tier.combine(
                name, step_ctx["slots"], features[name + ROWS_SUFFIX]
            )
        out = dict(prepared)
        out["features"] = features
        return out, pull_info

    def _dispatch_train_step(self, state, prepared, pull_info):
        """Run the step and start the host copy of its loss, health
        scalars and row gradients; returns (state, loss on the device,
        the in-flight step)."""
        outputs = self._train_step(state, _to_device(prepared, self.device))
        state, loss, row_grads = outputs[:3]
        tensors = {"loss": loss}
        if self._health_on:
            tensors.update(("health_" + k, v) for k, v in outputs[3].items())
        tensors.update(("rows_" + k, v) for k, v in row_grads.items())
        host, event = self._fetch.start(tensors)
        return state, loss, _Flight(row_grads, pull_info, host, event)

    def _fold(self, flight):
        """Finish an in-flight step on the host, in this order: wait for
        its host copy; observe its health (a skip-sentinel batch stops
        here: no K3, no push); launch the tier's in-device apply (K3)
        on the device gradients; take the push gradients from the host
        copy. Returns ``{table: host gradients aligned with pull_info's
        push ids}`` or None for a skipped batch.

        The returned arrays are copies: the host buffers take the next
        step's copy while an accumulation or an in-flight push may
        still hold these rows. (Copying out costs 8 bytes a row here;
        rotating buffers would need as many sets as steps can be held.)
        """
        host = flight.host
        # the wait is the step's host-blocking d2h fetch (no extra sync:
        # the copy was issued with the step)
        with device_obs.transfer_span(
            "d2h", sum(host[k].numel() * host[k].element_size()
                       for k in host if k.startswith("rows_"))
        ):
            self._fetch.wait(flight.event)
        if self._health_on:
            scalars = {k[len("health_"):]: v for k, v in host.items()
                       if k.startswith("health_")}
            if self._observe_health(host["loss"], scalars):
                return None
        tier = self.device_tier
        ctx = getattr(flight.pull_info, "tier_ctx", None) or {}
        if tier is not None and ctx:
            for name, grads in flight.row_grads.items():
                step_ctx = ctx.get(name)
                if step_ctx is not None:
                    tier.apply(name, step_ctx["slots"], grads)
            # after every table's apply: the periodic writeback then
            # reads post-apply values
            tier.maybe_periodic_writeback()
        out = {}
        for name, (_, n) in flight.pull_info.items():
            grads = host["rows_" + name].numpy()
            step_ctx = ctx.get(name)
            if step_ctx is None:
                out[name] = grads[:n].copy()
            else:
                # fancy indexing copies
                out[name] = grads[step_ctx["push_pos"]]
        return out

    def flush_device_tier(self):
        """Write every tier-held row update back to the PS (checkpoint
        and export boundaries); no-op without a tier."""
        if self.device_tier is not None:
            self.device_tier.flush()

    def join_pushes(self):
        """Depth-1 barrier of the async push: block until the in-flight
        push (if any) resolves and adopt its version. Its failure
        surfaces here, one step after dispatch; a sync-PS rejection
        raises (the async path cannot replay the minibatch)."""
        future, self._push_future = self._push_future, None
        if future is None:
            return
        accepted, version, rejected = _normalize_push_result(
            future.result(), self._version
        )
        if not accepted:
            self.push_rejections += 1
            raise RuntimeError(
                "async-push gradients rejected as stale by a sync-mode PS "
                "(shards %s); %s requires the async PS: use the "
                "synchronous step against --use_async=false"
                % (sorted(rejected) if rejected else "all", ASYNC_PUSH_ENV)
            )
        self._version = version

    def close(self):
        """Join the in-flight push (best effort: teardown must not mask
        the caller's own exception), stop the push thread, then the
        final writeback: tier-held updates reach the PS before the
        trainer goes. A later train_step pushes synchronously."""
        try:
            self.join_pushes()
        except Exception:
            logger.exception("in-flight async push failed at close")
        pool, self._async_pool = self._async_pool, None
        self._async_push = False
        if pool is not None:
            pool.shutdown(wait=True)
        if self.device_tier is not None:
            self.device_tier.close()
        self.preparer.close()

    def _push_with_brownout(self, row_grads, pull_info, **kwargs):
        """Gradient push with brownout degradation.

        Off (EDL_BROWNOUT_SKIP_AFTER=0, the default): a plain
        ``preparer.push_gradients``. On: an overload-class failure is
        absorbed (the batch's push is dropped and counted; the PS never
        sees the batch), and once the streak reaches the threshold each
        push runs under a deadline of one breaker reset window, its
        first success ending the streak."""
        skip_after = overload.brownout_skip_after()
        if skip_after <= 0:
            return self.preparer.push_gradients(row_grads, pull_info,
                                                **kwargs)
        degraded = self._brownout_streak >= skip_after
        try:
            with overload.budget(overload.circuit_reset_secs()
                                 if degraded else None):
                result = self.preparer.push_gradients(row_grads, pull_info,
                                                      **kwargs)
        except grpc.RpcError as e:
            code = e.code() if hasattr(e, "code") else None
            if code not in overload.BROWNOUT_CODES:
                raise
            self._brownout_streak += 1
            self.brownout_skipped_pushes += 1
            overload.note_brownout_skip()
            logger.warning(
                "brownout: dropping this batch's push (overload-class "
                "failure %s, streak %d%s)", code, self._brownout_streak,
                ", degraded pacing" if degraded else "",
            )
            if events.enabled():
                events.emit(
                    "brownout_skipped_push",
                    streak=self._brownout_streak,
                    degraded=degraded,
                    code=str(code),
                )
            # never sent: nothing to retry, no version to adopt
            return True, self._version, ()
        if self._brownout_streak:
            logger.warning("brownout recovered: push landed after %d "
                           "dropped pushes", self._brownout_streak)
            if events.enabled():
                events.emit(
                    "brownout_recovered",
                    skipped=self._brownout_streak,
                )
            self._brownout_streak = 0
        return result

    def _observe_health(self, loss, scalars):
        """Fold the step's health scalars (host tensors) into the
        tracker; True when the skip sentinel says the batch contributes
        nothing (the step already kept its dense state). Raises
        HealthSentinelError under halt."""
        if scalars is None:
            return False
        action = self.health.observe(
            float(loss),
            float(scalars["grad_norm"]),
            bool(scalars["nonfinite"]),
        )
        return action == "skip"

    def train_step(self, state, batch):
        """batch: raw (un-prepared) numpy batch with id features;
        returns ``(state, loss)`` with the loss a 0-d tensor on the
        device. Against a sync PS a rejected push is retried (fresh
        rows, recomputed row gradients) up to MAX_PUSH_RETRIES times."""
        prepared, pull_info = self._prepare_once(batch)
        if state is None:
            state = self.create_state(prepared["features"])
        self._prep_memo = None
        prepared, pull_info = self._tier_combine(batch, prepared, pull_info)
        t0 = self.timing.start()
        state, loss, flight = self._dispatch_train_step(state, prepared,
                                                        pull_info)
        row_grads = self._fold(flight)
        self.timing.end_record_sync("batch_process", t0, loss)
        if row_grads is None:
            return state, loss  # skip sentinel: no push, no tier apply
        if self._async_push:
            # join step N-1's push, then hand step N's to the thread: it
            # overlaps step N+1's pull and compute (one push of
            # staleness, the async PS's envelope)
            with self.timing.timeit("sparse_push"):
                self.join_pushes()
            # bind_context: the push runs on the executor thread after
            # this step's root span closed; binding keeps its ps_push and
            # RPC spans children of the step that made the gradients
            self._push_future = self._async_pool.submit(
                trace.bind_context(self._push_with_brownout), row_grads,
                pull_info, model_version=self._version)
            return state, loss
        with self.timing.timeit("sparse_push"):
            accepted, version, rejected = self._push_with_brownout(
                row_grads, pull_info, model_version=self._version)
        if not accepted and self.device_tier is not None:
            # the retry recomputes FULL row grads against fresh pulls,
            # with the hit grads already applied on the card
            raise RuntimeError(
                "sync-mode PS rejected a push with the device embedding "
                "tier enabled; EDL_DEVICE_TIER requires the async PS "
                "(--use_async=true)"
            )
        retries = 0
        while not accepted and retries < self.MAX_PUSH_RETRIES:
            # retry ONLY to the shards that rejected (the others
            # buffered this minibatch already)
            if rejected is None and self.preparer.ps_num > 1:
                raise RuntimeError(
                    "multi-shard PS client rejected a push without "
                    "reporting rejected_shards; cannot retry safely"
                )
            self._version = version
            # fresh rows, row grads recomputed at the updated params
            with self.timing.timeit("sparse_pull"):
                prepared, pull_info = self.preparer.prepare(batch)
            row_grads = {
                name: _host(grads) for name, grads in self._row_grads(
                    state, _to_device(prepared, self.device)).items()
            }
            with self.timing.timeit("sparse_push"):
                accepted, version, rejected = self.preparer.push_gradients(
                    row_grads, pull_info, model_version=self._version,
                    only_shards=rejected)
            retries += 1
            self.push_rejections += 1
        if not accepted:
            raise RuntimeError(
                "sync PS rejected gradients %d times in a row; check that "
                "the PS grads_to_wait matches the worker count"
                % self.MAX_PUSH_RETRIES
            )
        self._version = version
        return state, loss

    def eval_step(self, state, batch):
        """Outputs of the model on a raw batch, as numpy (tier hits are
        gathered straight from the card). The in-flight async push lands
        first, so the scored rows are not one update behind."""
        self.join_pushes()
        prepared, pull_info = self._prepare_once(batch)
        self._prep_memo = None
        prepared, _ = self._tier_combine(batch, prepared, pull_info)
        outputs = self._eval_step(
            state, _to_device(prepared["features"], self.device)
        )
        leaves = (list(outputs.values()) if isinstance(outputs, dict)
                  else [outputs])
        nbytes = sum(v.numel() * v.element_size() for v in leaves)
        with device_obs.transfer_span("d2h", nbytes):
            if isinstance(outputs, dict):
                return {k: _host(v) for k, v in outputs.items()}
            return _host(outputs)

    # ------------------------------------------------------------------
    def train_stream(self, state, batches, on_first_batch=None,
                     push_interval=1):
        """Pipelined training over an iterable of raw batches.

        Per step N:

          dispatch step N on the card   (the host copy of its row
                                         gradients starts with it)
          yield (state, loss, batch_N)  (the consumer's bookkeeping
                                         rides under the step)
          submit the prepare of N+1     (lookahead thread: unique ids,
                                         tier lookup, the PS pull)
          fold step N                   (wait for the copy, health, K3,
                                         the push gradients)
          push                          (push thread, one in flight,
                                         every push_interval steps)
          collect the prepare of N+1    (only its un-hidden remainder is
                                         on the critical path: Timing's
                                         sparse_pull)

        The yield precedes the lookahead: a consumer's record report
        may be what lets the next batch exist at all.

        Rows of batch N+1 are one push stale, and pushed gradients land
        up to one step late. Push N-1 is finished and its version
        adopted before push N is submitted, so against a sync PS with
        one worker and grads_to_wait 1 every push is accepted; a
        rejection raises (``_finish_push``). ``push_interval=k``
        accumulates row gradients over k batches into one merged push.

        Yields ``(state, loss, batch)`` per batch, in order; ``loss`` is
        a device scalar of a step that may still run. The step updates
        the model and optimizer state IN PLACE, so the yielded ``state``
        is live: its tensors are every step's tensors and hold the
        latest dispatched step's values, not a snapshot of step N.
        ``on_first_batch(batch)`` runs before the first dispatch (a
        checkpoint-restore hook); a state it returns is used.

        Thread contract: the lookahead thread runs only
        ``preparer.prepare``, which is host work (numpy under the tier's
        lock, RPCs) and creates no tensor on the card; every launch
        happens on the calling thread.
        """
        if push_interval < 1:
            raise ValueError("push_interval must be >= 1")
        # anything train_step's async push left in flight joins first
        self.join_pushes()
        it = iter(batches)
        sentinel = object()
        batch = next(it, sentinel)
        if batch is sentinel:
            return
        if on_first_batch is not None:
            restored = on_first_batch(batch)
            if restored is not None:
                state = restored
        prepared, pull_info = self._prepare_once(batch)
        self._prep_memo = None
        if state is None:
            state = self.create_state(prepared["features"])
        push_pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="sparse-push"
        )
        push_future = None
        # one lookahead thread: prepares run strictly in order (the
        # cache clock and the tier's admission assume it)
        pull_pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="sparse-lookahead"
        )
        next_prep_future = None
        acc = {}  # table -> (values, ids) accumulated since the last push
        acc_steps = 0
        push_rpc = self.preparer._ps.push_gradients
        in_flight = None  # a dispatched step not folded yet

        def fold_in_flight():
            """Fold the in-flight step's push gradients into ``acc``; a
            skip-sentinel batch folds nothing."""
            nonlocal in_flight, acc_steps
            flight, in_flight = in_flight, None
            grads = self._fold(flight)
            acc_steps += 1
            if grads is None:
                return
            for name, (unique, n) in flight.pull_info.items():
                if n == 0:
                    continue
                values, ids = grads[name][:n], unique
                if name in acc:
                    prev_v, prev_i = acc[name]
                    values, ids = deduplicate_indexed_slices(
                        np.concatenate([prev_v, values], axis=0),
                        np.concatenate([prev_i, ids], axis=0),
                    )
                acc[name] = (values, ids)

        try:
            while True:
                t0 = self.timing.start()
                # tier combine on this thread, after the previous step's
                # in-device apply (fold)
                prepared, pull_info = self._tier_combine(
                    batch, prepared, pull_info)
                state, loss, in_flight = self._dispatch_train_step(
                    state, prepared, pull_info)
                yield state, loss, batch
                next_batch = next(it, sentinel)
                next_prep_future = None
                if next_batch is not sentinel:
                    next_prep_future = pull_pool.submit(
                        self.preparer.prepare, next_batch)
                fold_in_flight()  # waits for step N's host copy
                self.timing.end_record_sync("batch_process", t0, loss)
                if acc_steps >= push_interval and acc:
                    snapshot, acc = acc, {}
                    acc_steps = 0
                    if push_future is not None:
                        with self.timing.timeit("sparse_push"):
                            self._finish_push(push_future.result())
                    push_future = push_pool.submit(
                        push_rpc, snapshot, model_version=self._version)
                if next_batch is sentinel:
                    break
                with self.timing.timeit("sparse_pull"):
                    try:
                        prepared, pull_info = next_prep_future.result()
                    finally:
                        # consumed either way: teardown must not drain
                        # it again
                        next_prep_future = None
                batch = next_batch
            if push_future is not None:
                with self.timing.timeit("sparse_push"):
                    self._finish_push(push_future.result())
                push_future = None
            if acc:  # the tail, shorter than push_interval
                with self.timing.timeit("sparse_push"):
                    self._finish_push(
                        push_rpc(acc, model_version=self._version))
                acc = {}
        finally:
            if push_future is not None:
                # only while unwinding: report the push's fate without
                # masking the original exception
                try:
                    push_future.result()
                except Exception:
                    logger.exception("in-flight gradient push failed during "
                                     "stream teardown")
            # closed mid-stream: the dispatched step's gradients and a
            # short accumulation would be dropped; flush, best effort
            try:
                if in_flight is not None:
                    fold_in_flight()
                if acc:
                    self._finish_push(
                        push_rpc(acc, model_version=self._version))
            except Exception:
                logger.exception("flushing the stream's last gradients "
                                 "failed during teardown")
            push_pool.shutdown(wait=True)
            if next_prep_future is not None:
                # unwound between submit and collect: a running prepare
                # must finish before a successor stream touches the
                # cache
                if not next_prep_future.cancel():
                    try:
                        next_prep_future.result()
                    except Exception:
                        logger.exception("abandoned lookahead pull failed")
            pull_pool.shutdown(wait=True)

    def _finish_push(self, result):
        accepted, version, _ = _normalize_push_result(result, self._version)
        if not accepted:
            raise RuntimeError(
                "train_stream pushed gradients to a sync-mode PS which "
                "rejected them as stale; pipelined training requires the "
                "async PS or one worker per sync round (grads_to_wait 1)"
            )
        self._version = version

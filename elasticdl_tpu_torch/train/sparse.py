"""Sparse embedding training: host PS tables + the step on the card
(port of elasticdl_tpu/train/sparse.py, the synchronous-push path).

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

Not ported yet: ``train_stream`` (the pipelined path) with its async
push, brownout, the sync-PS retry of a rejected push and the
``HotRowCache``.
"""

import numpy as np
import torch

from elasticdl_tpu_torch.common.device import resolve_device
from elasticdl_tpu_torch.common.log_utils import (
    default_logger as _logger_factory,
)
from elasticdl_tpu_torch.data.pipeline import MASK_KEY
from elasticdl_tpu_torch.embedding.client import EmbeddingClient
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
    card). All tables' pulls ride one fused pull call.
    """

    def __init__(self, specs, ps_client, device_tier=None):
        self._specs = list(specs)
        self._ps = ps_client
        self._registered = False
        self._embedding = EmbeddingClient(ps_client)
        self._tier = device_tier

    def _on_ps_restart(self, shard):
        """A relaunched PS shard (the PS client's resync hook):
        re-register the tables on the next prepare and
        flush-then-invalidate the tier."""
        del shard
        self._registered = False
        if self._tier is not None:
            # host maps invalidate NOW (thread-safe); the dirty rows'
            # device values flush back to the restored PS from the
            # dispatch thread before the state resets
            self._tier.mark_restart()

    def register_tables(self):
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
        one)."""
        self.register_tables()
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

    def push_gradients(self, row_grads, pull_info, model_version=0):
        """Push each table's first n row gradients (host arrays or
        tensors) under its pull_info ids; returns ``(accepted,
        version)``."""
        grads_by_table = {}
        for name, (unique, n) in pull_info.items():
            if n == 0:
                continue
            grads_by_table[name] = (_host(row_grads[name])[:n], unique)
        accepted, version = self._ps.push_gradients(
            grads_by_table, model_version=model_version)[:2]
        return accepted, version

    def close(self):
        self._embedding.close()


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


def _has_uninitialized_params(model):
    from torch.nn.parameter import UninitializedParameter

    return any(isinstance(p, UninitializedParameter)
               for p in model.parameters())


class SparseTrainer:
    """Trainer surface (create_state/train_step/eval_step) over dense
    params on ``device`` and host-PS sparse tables, with an optional
    device tier whose kernels run on the same device."""

    def __init__(self, model, loss_fn, optimizer, specs, ps_client,
                 compute_dtype=None, seed=0, device_tier=None, health=None,
                 device="cuda"):
        """``model`` trains in place on ``device`` (``cuda`` unless the
        caller asks for the CPU; no card raises). ``device_tier``: None
        reads EDL_DEVICE_TIER*, False disables, True or a
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
        tier_config = resolve_tier_config(device_tier)
        self.device_tier = None
        if tier_config is not None:
            self.device_tier = DeviceEmbeddingTier(
                self._specs, ps_client, tier_config, device=self.device
            )
        self.preparer = SparseBatchPreparer(
            self._specs, ps_client, device_tier=self.device_tier
        )
        compute_dtype = resolve_dtype(compute_dtype)
        self._train_step = make_sparse_train_step(
            self._model, loss_fn, optimizer, self._specs, compute_dtype,
            health=self._health_on,
            guard_nonfinite=(self._health_on
                             and self.health.action == "skip"),
        )
        self._eval_step = make_eval_step(self._model, compute_dtype)
        self._version = 0
        # memo of the last prepared batch, so ensure_state followed by
        # eval_step/train_step on the same batch pulls rows once
        self._prep_memo = None

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
        if _has_uninitialized_params(self._model):
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

    def _tier_apply_extract(self, row_grads, pull_info):
        """Launch the in-device scatter-apply for every tier table's hit
        gradients, then bring the miss gradients to the host, aligned
        with pull_info's push ids. The applies go first so the card
        works while the host copy waits."""
        tier = self.device_tier
        ctx = getattr(pull_info, "tier_ctx", None)
        if tier is None or not ctx:
            return row_grads
        for name, grads in row_grads.items():
            step_ctx = ctx.get(name)
            if step_ctx is not None:
                tier.apply(name, step_ctx["slots"], grads)
        # after every table's apply: the periodic writeback then reads
        # post-apply values
        tier.maybe_periodic_writeback()
        out = {}
        for name, grads in row_grads.items():
            step_ctx = ctx.get(name)
            if step_ctx is None:
                out[name] = grads
            else:
                out[name] = _host(grads)[step_ctx["push_pos"]]
        return out

    def flush_device_tier(self):
        """Write every tier-held row update back to the PS (checkpoint
        and export boundaries); no-op without a tier."""
        if self.device_tier is not None:
            self.device_tier.flush()

    def close(self):
        """Final writeback: tier-held updates reach the PS before the
        trainer goes."""
        if self.device_tier is not None:
            self.device_tier.close()
        self.preparer.close()

    def _observe_health(self, loss, scalars):
        """Fold the step's health scalars into the tracker; True when
        the skip sentinel says the batch contributes nothing (the step
        already kept its dense state; the caller drops the push and
        the tier apply). Raises HealthSentinelError under halt."""
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
        device."""
        prepared, pull_info = self._prepare_once(batch)
        if state is None:
            state = self.create_state(prepared["features"])
        self._prep_memo = None
        prepared, pull_info = self._tier_combine(batch, prepared, pull_info)
        outputs = self._train_step(state, _to_device(prepared, self.device))
        state, loss, row_grads = outputs[:3]
        if self._observe_health(loss, outputs[3] if self._health_on
                                else None):
            # skip sentinel: no push, no tier apply
            return state, loss
        row_grads = self._tier_apply_extract(row_grads, pull_info)
        accepted, version = self.preparer.push_gradients(
            row_grads, pull_info, model_version=self._version
        )
        if not accepted:
            if self.device_tier is not None:
                # a retry would recompute FULL row grads against fresh
                # pulls, with the hit grads already applied on the card
                raise RuntimeError(
                    "sync-mode PS rejected a push with the device "
                    "embedding tier enabled; EDL_DEVICE_TIER requires the "
                    "async PS (--use_async=true)"
                )
            raise RuntimeError(
                "the PS rejected a push as stale; the sync-PS retry is "
                "not ported yet (use the async PS)"
            )
        self._version = version
        return state, loss

    def eval_step(self, state, batch):
        """Outputs of the model on a raw batch, as numpy (tier hits are
        gathered straight from the card)."""
        prepared, pull_info = self._prepare_once(batch)
        self._prep_memo = None
        prepared, _ = self._tier_combine(batch, prepared, pull_info)
        outputs = self._eval_step(
            state, _to_device(prepared["features"], self.device)
        )
        if isinstance(outputs, dict):
            return {k: _host(v) for k, v in outputs.items()}
        return _host(outputs)

"""Device-resident embedding tier: the hot set of each host embedding
table kept on the card (port of elasticdl_tpu/train/device_tier.py).

A two-tier store:

- **device tier** (this module + ops/embedding_tier.py): a
  fixed-capacity slot table per embedding table on the card. Hit rows
  are gathered on the card (K1) and their gradients are applied to
  their slots by the scatter-apply kernel (K3): no host round trip, no
  PS call.
- **spillover tier**: the PS, reached only on a miss. Evicted and dirty
  rows write back as raw row values (``push_embedding_rows``) on one
  background thread.

Promotion and demotion run on the host from the per-step id stream: an
id is promoted after ``promote_hits`` sightings (misses) and demoted by
LFU pressure (a promotion needs a slot) or TTL idleness. The
bookkeeping is vectorized numpy over sorted id arrays.

Consistency contract: resident rows are authoritative; the PS copy of a
hot row is stale by at most ``writeback_steps``. ``flush()`` (checkpoint
and export boundaries) writes every dirty row back before the boundary
proceeds. A PS relaunch triggers flush-then-invalidate: the tier's rows
are written back first, then the tier drops its map and repopulates.
With ``EDL_DEVICE_TIER=0`` (the default) none of this runs and training
is bit-exact with the PS-only path.

The port differs from the reference in three ways. The state tensors
live on ``device`` and the fused ops update them IN PLACE (the
reference rebinds donated arrays), so every host read of device rows
(eviction victims, flushes, restarts) takes a copy on the dispatch
thread, which ``.cpu()`` also synchronises, before the next launch can
touch the rows; the writeback thread only ever sees numpy copies. The
steady-state gather-only combine runs K1, the function the reference
computed there with an XLA gather. One device a tier: the sparse SPMD
trainer (train/sparse_spmd.py) replicates it at ep 1, one tier a rank
on the same values, as the reference's ``P()`` layout; sharding it over
the ep ranks has no launch path in the port yet (a worker is one
process a card) and raises (ROADMAP Queue 1 item 2). The tallies feed
``stats()``
and the reference's per-table ``edl_device_tier_*`` series (no-ops
when metrics collection is off).
"""

import concurrent.futures
import threading
from dataclasses import dataclass, field

import numpy as np
import torch

from elasticdl_tpu_torch.common.device import resolve_device
from elasticdl_tpu_torch.common.env_utils import env_int, env_str
from elasticdl_tpu_torch.common.log_utils import (
    default_logger as _logger_factory,
)
from elasticdl_tpu_torch.observability import metrics as obs_metrics
from elasticdl_tpu_torch.ops import embedding_tier as tier_ops

logger = _logger_factory("elasticdl_tpu_torch.train.device_tier")

ENABLE_ENV = "EDL_DEVICE_TIER"
ROWS_ENV = "EDL_DEVICE_TIER_ROWS"
PROMOTE_ENV = "EDL_DEVICE_TIER_PROMOTE"
TTL_ENV = "EDL_DEVICE_TIER_TTL"
STAGE_ENV = "EDL_DEVICE_TIER_STAGE"
OPT_ENV = "EDL_DEVICE_TIER_OPT"
OPT_ARGS_ENV = "EDL_DEVICE_TIER_OPT_ARGS"
WRITEBACK_ENV = "EDL_DEVICE_TIER_WRITEBACK"


def _bool_flag(value):
    """The reference's bool spellings (true/yes/1, false/no/0)."""
    lowered = str(value).strip().lower()
    if lowered in ("true", "yes", "1"):
        return True
    if lowered in ("false", "no", "0"):
        return False
    raise ValueError("expected a boolean (true/false/1/0), got %r" % (value,))


@dataclass
class DeviceTierConfig:
    """Knobs, all overridable from the environment."""

    capacity: int = 65536        # resident rows per table
    promote_hits: int = 2        # sightings before an id is promoted
    ttl: int = 4096              # idle prepares before TTL demotion
    stage_budget: int = 1024     # max promotions/demotions per step
    opt_type: str = "adam"       # tier-side sparse optimizer
    opt_args: dict = field(default_factory=dict)
    writeback_steps: int = 256   # dirty-row writeback cadence (steps)

    @classmethod
    def from_env(cls):
        """None when the tier is disabled (EDL_DEVICE_TIER unset/0)."""
        raw = env_str(ENABLE_ENV, "").strip()
        if not raw or not _bool_flag(raw):
            return None
        config = cls()
        config.capacity = env_int(ROWS_ENV, config.capacity)
        config.promote_hits = env_int(PROMOTE_ENV, config.promote_hits)
        config.ttl = env_int(TTL_ENV, config.ttl)
        config.stage_budget = env_int(STAGE_ENV, config.stage_budget)
        config.opt_type = env_str(OPT_ENV, config.opt_type).lower()
        raw_args = env_str(OPT_ARGS_ENV, "")
        if raw_args:
            from elasticdl_tpu_torch.train.optimizers import parse_opt_args

            config.opt_args = {
                k: float(v) for k, v in parse_opt_args(raw_args).items()
            }
        config.writeback_steps = env_int(
            WRITEBACK_ENV, config.writeback_steps
        )
        return config


def resolve_tier_config(device_tier):
    """Normalize SparseTrainer's ``device_tier`` argument: None reads
    the environment, False disables, True takes env-tuned defaults, a
    DeviceTierConfig passes through."""
    if device_tier is None:
        return DeviceTierConfig.from_env()
    if device_tier is False:
        return None
    if device_tier is True:
        return DeviceTierConfig.from_env() or DeviceTierConfig()
    if isinstance(device_tier, DeviceTierConfig):
        return device_tier
    raise TypeError(
        "device_tier must be None/bool/DeviceTierConfig (got %r)"
        % (device_tier,)
    )


class _TableTier:
    """Host bookkeeping + device state for one table's hot set."""

    __slots__ = (
        "name", "dim", "capacity", "alloc", "state",
        "res_ids", "res_slots", "slot_id", "slot_hits", "slot_last",
        "slot_dirty", "slot_unsent", "free_slots", "cand_ids",
        "cand_counts", "cand_last", "staged_slots", "staged_ids",
        "staged_rows", "evict_ids", "evict_slots", "evict_unsent",
        "pending_flush",
    )

    def __init__(self, name, dim, capacity, opt_type, device):
        self.name = name
        self.dim = dim
        self.capacity = capacity          # usable slots
        # rows allocated: the last is K3's scratch row, where the misses'
        # updates land
        self.alloc = capacity + 1
        self.state = tier_ops.init_table_state(
            self.alloc, dim, opt_type, device=device
        )
        self.res_ids = np.empty((0,), np.int64)    # sorted
        self.res_slots = np.empty((0,), np.int32)  # aligned with ids
        self.slot_id = np.full((capacity,), -1, np.int64)
        self.slot_hits = np.zeros((capacity,), np.int64)
        self.slot_last = np.zeros((capacity,), np.int64)
        self.slot_dirty = np.zeros((capacity,), bool)
        # hits since the slot's row was last written back: the PS's
        # sightings the tier absorbed (the port's addition)
        self.slot_unsent = np.zeros((capacity,), np.int64)
        self.free_slots = list(range(capacity - 1, -1, -1))  # pop() = 0
        self.cand_ids = np.empty((0,), np.int64)   # sorted
        self.cand_counts = np.empty((0,), np.int64)
        self.cand_last = np.empty((0,), np.int64)
        # staged since the last combine: promotions in, victims out
        self.staged_slots = []
        self.staged_ids = []
        self.staged_rows = []
        self.evict_ids = []
        self.evict_slots = []
        self.evict_unsent = []
        # (ids, slots, host ids, host rows) snapshotted by mark_restart:
        # dirty rows whose device values must be written back (on the
        # dispatch thread) before the device state resets
        self.pending_flush = None


class DeviceEmbeddingTier:
    """The two-tier embedding store's device half (module docstring).

    Thread contract: ``lookup``/``admit``/``advance`` run on the prepare
    thread, ``combine``/``apply``/``flush`` on the dispatch thread; a
    lock guards the host maps, and the device state is launched on and
    read only from the dispatch thread.
    """

    def __init__(self, specs, ps_client, config, device="cuda"):
        """``device`` holds the state and runs K1-K3 (``cuda`` unless
        the caller asks for the CPU, where the plain versions run; no
        card raises)."""
        self._config = config
        self._ps = ps_client
        if not hasattr(ps_client, "push_embedding_rows"):
            raise ValueError(
                "device tier needs a PS client with push_embedding_rows"
                " (eviction/flush writeback); %r has none"
                % type(ps_client).__name__
            )
        self._opt_type = config.opt_type.lower()
        if self._opt_type not in tier_ops.TIER_OPT_SLOTS:
            raise ValueError(
                "device tier supports %s optimizers (got %r); set %s"
                % (sorted(tier_ops.TIER_OPT_SLOTS), self._opt_type,
                   OPT_ENV)
            )
        from elasticdl_tpu_torch.ps.embedding_store import OPTIMIZER_DEFAULTS

        args = dict(OPTIMIZER_DEFAULTS)
        args.update(config.opt_args or {})
        self._apply_args = dict(
            opt_type=self._opt_type,
            lr=float(args.get("lr", 0.01)),
            momentum=float(args.get("momentum", 0.9)),
            beta1=float(args.get("beta1", 0.9)),
            beta2=float(args.get("beta2", 0.999)),
            epsilon=float(args.get("epsilon", 1e-8)),
        )
        self.device = resolve_device(device)
        self._lock = threading.Lock()
        self._clock = 0
        self._last_writeback = 0
        # bumped by mark_restart: a step context whose lookups predate
        # the current epoch must be re-prepared, never combined (its
        # slots point into a map that no longer exists)
        self.epoch = 0
        self._tables = {
            spec.name: _TableTier(spec.name, spec.dim, config.capacity,
                                  self._opt_type, self.device)
            for spec in specs
        }
        # eviction/flush writebacks ride one background thread; failures
        # surface at the next drain (flush/close)
        self._writeback_pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="tier-writeback"
        )
        self._writeback_futures = []
        # name -> {id: in-flight writeback count} (see _submit_writeback)
        self._pending_writeback_ids = {}
        # set by the TTL sweep when idle-but-dirty slots exist: the
        # next maybe_periodic_writeback flushes regardless of cadence
        self._force_flush = False
        # cumulative tallies (stats()): unique-id hits and misses,
        # demotions, the combines that ran the gather-only path, the
        # staging chunks landed and of those the ones with promotions to
        # insert and with victims to read out; the host reads of resident
        # rows (one K1 each) and the rows written back to the PS
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        # flush() writes back every resident row, not only dirty ones
        self.reassert = False
        self.gather_only_combines = 0
        self.staged_chunks = 0
        self.insert_chunks = 0
        self.evict_chunks = 0
        self.row_reads = 0
        self.written_back_rows = 0
        # per-table series in the metrics registry (no-ops when
        # collection is off)
        self._m_hits = obs_metrics.counter(
            "edl_device_tier_hits_total",
            "Unique ids served from the device-resident hot set",
            ("table",),
        )
        self._m_misses = obs_metrics.counter(
            "edl_device_tier_misses_total",
            "Unique ids that fell through to the PS spillover tier",
            ("table",),
        )
        self._m_evictions = obs_metrics.counter(
            "edl_device_tier_evictions_total",
            "Hot-set rows demoted (LFU pressure or TTL idle)",
            ("table",),
        )
        self._m_hit_rate = obs_metrics.gauge(
            "edl_device_tier_hit_rate",
            "Cumulative device-tier hit rate (hits / lookups)",
            ("table",),
        )
        self._m_occupancy = obs_metrics.gauge(
            "edl_device_tier_occupancy",
            "Resident rows / capacity", ("table",),
        )
        self._t_hits = {}    # per-table cumulative (the hit-rate gauge)
        self._t_misses = {}
        logger.info(
            "device embedding tier: %d tables x %d rows on %s (%s "
            "optimizer, promote@%d, ttl=%d, writeback every %d steps)",
            len(self._tables), config.capacity, self.device,
            self._opt_type, config.promote_hits, config.ttl,
            config.writeback_steps,
        )

    def _to_device(self, array):
        return torch.from_numpy(np.ascontiguousarray(array)).to(
            self.device, non_blocking=True)

    def _read_rows(self, table, slots):
        """Host copy of the resident rows at ``slots`` (K1 on the card),
        taken now, before any later launch can change them."""
        self.row_reads += 1
        slots = self._to_device(np.asarray(slots, np.int32))
        return tier_ops.gather_rows(table.state, slots).cpu().numpy()

    # -- prepare-thread surface ----------------------------------------
    def advance(self):
        """Once per prepare: tick the clock and run the TTL sweep."""
        with self._lock:
            self._clock += 1
            if self._config.ttl <= 0 or self._clock % 64:
                return
            horizon = self._clock - self._config.ttl
            for table in self._tables.values():
                idle = np.nonzero(
                    (table.slot_id >= 0) & (table.slot_last < horizon)
                )[0]
                if not idle.size:
                    continue
                # TTL-evict only CLEAN slots: a clean row's PS copy is
                # exact. A dirty idle slot's writeback would not be
                # visible to the wait_for_writebacks barrier until the
                # next combine, so force a flush instead: the slot turns
                # clean and a later sweep evicts it.
                dirty_idle = idle[table.slot_dirty[idle]]
                idle = idle[~table.slot_dirty[idle]]
                if dirty_idle.size:
                    self._force_flush = True
                if idle.size:
                    idle = idle[: self._config.stage_budget]
                    self._evict_locked(table, idle.astype(np.int32))

    def lookup(self, name, unique):
        """unique (sorted int64) -> slots int32 [n], -1 = miss. Hit
        slots are touched (LFU count + TTL clock)."""
        table = self._tables[name]
        with self._lock:
            slots = np.full(unique.shape, -1, np.int32)
            if table.res_ids.size:
                pos = np.searchsorted(table.res_ids, unique)
                clipped = np.minimum(pos, table.res_ids.size - 1)
                found = (
                    (pos < table.res_ids.size)
                    & (table.res_ids[clipped] == unique)
                )
                slots[found] = table.res_slots[clipped[found]]
                hit_slots = slots[found]
                table.slot_hits[hit_slots] += 1
                table.slot_unsent[hit_slots] += 1
                table.slot_last[hit_slots] = self._clock
                # dirty at LOOKUP, not apply: a later prepare may stage
                # this slot's eviction before this step's apply lands,
                # and the writeback decision must already see it dirty
                table.slot_dirty[hit_slots] = True
            n_hit = int((slots >= 0).sum())
            n_miss = int(unique.size) - n_hit
            self.hits += n_hit
            self.misses += n_miss
            self._t_hits[name] = self._t_hits.get(name, 0) + n_hit
            self._t_misses[name] = self._t_misses.get(name, 0) + n_miss
            total = self._t_hits[name] + self._t_misses[name]
        if n_hit:
            self._m_hits.labels(table=name).inc(n_hit)
        if n_miss:
            self._m_misses.labels(table=name).inc(n_miss)
        if total:
            self._m_hit_rate.labels(table=name).set(
                self._t_hits[name] / total
            )
        return slots

    def admit(self, name, miss_ids, miss_rows):
        """Fold this step's misses into the promotion candidates and
        stage the ids that crossed ``promote_hits`` (their pulled rows
        become the staged insert values). Returns (mask over miss_ids
        of promoted entries, their new slots int32): promoted ids are
        hits from this very step on."""
        table = self._tables[name]
        config = self._config
        if miss_ids.size == 0:
            return np.zeros((0,), bool), np.empty((0,), np.int32)
        with self._lock:
            counts = self._bump_candidates_locked(table, miss_ids)
            ready = counts >= config.promote_hits
            budget = min(
                config.stage_budget - len(table.staged_slots),
                config.capacity,
            )
            if budget <= 0:
                ready[:] = False
            elif int(ready.sum()) > budget:
                # promote the hottest first under the stage budget
                order = np.argsort(-counts)
                keep = order[:budget]
                limited = np.zeros_like(ready)
                limited[keep] = ready[keep]
                ready = limited
            n_promote = int(ready.sum())
            if n_promote == 0:
                return ready, np.empty((0,), np.int32)
            slots = self._allocate_slots_locked(
                table, n_promote, protect=miss_ids[ready]
            )
            if slots.size < n_promote:
                # not enough evictable slots: promote what fits, keep
                # the rest as candidates
                short = np.nonzero(ready)[0][slots.size:]
                ready[short] = False
                n_promote = slots.size
            if n_promote == 0:
                return ready, np.empty((0,), np.int32)
            ids = miss_ids[ready]
            rows = np.asarray(miss_rows[ready], np.float32)
            # resident map insert (sorted merge)
            merged = np.concatenate([table.res_ids, ids])
            merged_slots = np.concatenate(
                [table.res_slots, slots.astype(np.int32)]
            )
            order = np.argsort(merged, kind="stable")
            table.res_ids = merged[order]
            table.res_slots = merged_slots[order]
            table.slot_id[slots] = ids
            table.slot_hits[slots] = config.promote_hits
            # the sightings before promotion were the PS's own
            table.slot_unsent[slots] = 0
            table.slot_last[slots] = self._clock
            # dirty from birth: a promoted id is a hit in THIS step
            table.slot_dirty[slots] = True
            table.staged_slots.extend(slots.astype(np.int64).tolist())
            table.staged_ids.extend(ids.astype(np.int64).tolist())
            table.staged_rows.append(rows)
            self._drop_candidates_locked(table, ids)
        return ready, slots.astype(np.int32)

    def _bump_candidates_locked(self, table, miss_ids):
        """Vectorized candidate-count update; returns this call's count
        per miss id (after the bump)."""
        if table.cand_ids.size:
            pos = np.searchsorted(table.cand_ids, miss_ids)
            clipped = np.minimum(pos, table.cand_ids.size - 1)
            known = (
                (pos < table.cand_ids.size)
                & (table.cand_ids[clipped] == miss_ids)
            )
        else:
            known = np.zeros(miss_ids.shape, bool)
            clipped = np.zeros(miss_ids.shape, np.int64)
        table.cand_counts[clipped[known]] += 1
        table.cand_last[clipped[known]] = self._clock
        fresh = miss_ids[~known]
        if fresh.size:
            # miss_ids arrive sorted, so a sorted insert beats a re-sort
            pos = np.searchsorted(table.cand_ids, fresh)
            table.cand_ids = np.insert(table.cand_ids, pos, fresh)
            table.cand_counts = np.insert(table.cand_counts, pos, 1)
            table.cand_last = np.insert(table.cand_last, pos, self._clock)
            cap = 8 * self._config.capacity
            if table.cand_ids.size > cap:
                # keep the hottest/most recent candidates: vocab drift
                # must not grow this set without bound
                score = table.cand_counts * (2 ** 20) + table.cand_last
                keep = np.argpartition(-score, cap - 1)[:cap]
                keep.sort()
                table.cand_ids = table.cand_ids[keep]
                table.cand_counts = table.cand_counts[keep]
                table.cand_last = table.cand_last[keep]
        pos = np.searchsorted(table.cand_ids, miss_ids)
        clipped = np.minimum(pos, max(table.cand_ids.size - 1, 0))
        found = (
            (pos < table.cand_ids.size)
            & (table.cand_ids[clipped] == miss_ids)
        )
        # an id the size cap just dropped counts as freshly seen
        return np.where(found, table.cand_counts[clipped], 1)

    def _drop_candidates_locked(self, table, ids):
        if not table.cand_ids.size:
            return
        # membership-checked: a promoted id may already be absent (the
        # size cap trimmed it)
        pos = np.searchsorted(table.cand_ids, ids)
        clipped = np.minimum(pos, table.cand_ids.size - 1)
        found = (
            (pos < table.cand_ids.size)
            & (table.cand_ids[clipped] == ids)
        )
        keep = np.ones(table.cand_ids.shape, bool)
        keep[clipped[found]] = False
        table.cand_ids = table.cand_ids[keep]
        table.cand_counts = table.cand_counts[keep]
        table.cand_last = table.cand_last[keep]

    def _allocate_slots_locked(self, table, n, protect):
        """n slots for promotions: free list first, then LFU eviction
        among slots idle this step (never an id in ``protect``, the
        current batch, nor one hit at the current clock)."""
        take = min(n, len(table.free_slots))
        slots = [table.free_slots.pop() for _ in range(take)]
        need = n - take
        if need > 0:
            evictable = np.nonzero(
                (table.slot_id >= 0)
                & (table.slot_last < self._clock)
            )[0]
            if protect.size and evictable.size:
                mask = ~np.isin(table.slot_id[evictable], protect)
                evictable = evictable[mask]
            if evictable.size:
                hits = table.slot_hits[evictable]
                take2 = min(need, evictable.size)
                order = np.argpartition(hits, take2 - 1)[:take2]
                victims = evictable[order].astype(np.int32)
                self._evict_locked(table, victims)
                # _evict_locked pushed the victims onto free_slots
                slots.extend(
                    table.free_slots.pop() for _ in range(victims.size)
                )
        return np.asarray(slots, np.int32)

    def _evict_locked(self, table, victim_slots):
        """Demote ``victim_slots`` (int32, resident): remove from the
        map now; their device values are read out and written back at
        the next combine (they stay readable until the staged inserts
        land)."""
        victim_ids = table.slot_id[victim_slots]
        keep_mask = np.ones(table.res_ids.shape, bool)
        pos = np.searchsorted(table.res_ids, victim_ids)
        keep_mask[pos] = False
        table.res_ids = table.res_ids[keep_mask]
        table.res_slots = table.res_slots[keep_mask]
        dirty = table.slot_dirty[victim_slots]
        table.slot_id[victim_slots] = -1
        table.slot_hits[victim_slots] = 0
        table.slot_dirty[victim_slots] = False
        table.free_slots.extend(victim_slots.astype(np.int64).tolist())
        # only rows a gradient ever landed on need the writeback
        dirty_slots = victim_slots[dirty]
        if dirty_slots.size:
            table.evict_ids.extend(
                victim_ids[dirty].astype(np.int64).tolist()
            )
            table.evict_slots.extend(
                dirty_slots.astype(np.int64).tolist()
            )
            table.evict_unsent.extend(
                table.slot_unsent[dirty_slots].tolist()
            )
        table.slot_unsent[victim_slots] = 0
        self.evictions += int(victim_slots.size)
        self._m_evictions.labels(table=table.name).inc(
            int(victim_slots.size)
        )
        self._m_occupancy.labels(table=table.name).set(
            table.res_ids.size / max(1, table.capacity)
        )

    def mark_restart(self):
        """PS relaunch detected (may fire on another thread): invalidate
        the HOST maps now, so from this instant every lookup misses, and
        snapshot the dirty rows' (id, slot) pairs. ``_process_restart``
        reads their device values and writes them back on the dispatch
        thread, after any in-flight step's apply, and only then resets
        the device state (flush-then-invalidate, split across
        threads)."""
        with self._lock:
            self.epoch += 1
            for table in self._tables.values():
                dirty = np.nonzero(table.slot_dirty)[0]
                ids = table.slot_id[dirty]
                live = ids >= 0
                dirty, ids = dirty[live], ids[live]
                # staged-but-not-combined promotions: their insert never
                # landed on the card, so a device read would return
                # zeros or the slot's previous tenant; their current
                # value is the staged host row. Staged eviction victims
                # still read correctly from the card.
                if table.staged_slots:
                    staged = np.isin(
                        dirty, np.asarray(table.staged_slots, np.int32)
                    )
                    dirty, ids = dirty[~staged], ids[~staged]
                if table.evict_slots:
                    ids = np.concatenate([
                        ids, np.asarray(table.evict_ids, np.int64)
                    ])
                    dirty = np.concatenate([
                        dirty.astype(np.int32),
                        np.asarray(table.evict_slots, np.int32),
                    ])
                host_ids = np.asarray(table.staged_ids, np.int64)
                host_rows = (
                    np.concatenate(table.staged_rows, axis=0)
                    if table.staged_rows
                    else np.empty((0, table.dim), np.float32)
                )
                pending = (
                    ids, dirty.astype(np.int32), host_ids, host_rows
                )
                if table.pending_flush is not None:
                    prev = table.pending_flush
                    pending = tuple(
                        np.concatenate([prev[k], pending[k]])
                        for k in range(4)
                    )
                table.pending_flush = pending
                self._reset_host_maps_locked(table)

    def _reset_host_maps_locked(self, table):
        table.res_ids = np.empty((0,), np.int64)
        table.res_slots = np.empty((0,), np.int32)
        table.slot_id[:] = -1
        table.slot_hits[:] = 0
        table.slot_last[:] = 0
        table.slot_dirty[:] = False
        table.slot_unsent[:] = 0
        table.free_slots = list(range(table.capacity - 1, -1, -1))
        table.cand_ids = np.empty((0,), np.int64)
        table.cand_counts = np.empty((0,), np.int64)
        table.cand_last = np.empty((0,), np.int64)
        table.staged_slots, table.staged_ids = [], []
        table.staged_rows = []
        table.evict_ids, table.evict_slots = [], []
        table.evict_unsent = []
        self._m_occupancy.labels(table=table.name).set(0.0)

    def _reset_state(self, table):
        table.state = tier_ops.init_table_state(
            table.alloc, table.dim, self._opt_type, device=self.device
        )

    def _process_restart(self):
        """Dispatch-thread half of mark_restart: write the snapshotted
        dirty rows back to the (restored) PS, then zero the device
        state. Runs before any combine touches the tables again."""
        for table in self._tables.values():
            with self._lock:
                pending, table.pending_flush = table.pending_flush, None
            if pending is None:
                continue
            ids, slots, host_ids, host_rows = pending
            if ids.size:
                self._submit_writeback(
                    table.name, ids, self._read_rows(table, slots)
                )
            if host_ids.size:
                # staged promotions whose insert never landed: their
                # newest known values are the staged host rows
                self._submit_writeback(table.name, host_ids, host_rows)
            self._reset_state(table)

    # -- dispatch-thread surface ---------------------------------------
    def combine(self, name, slots, rows_buffer):
        """Land staged promotions/demotions and materialize the step's
        combined row buffer on the card (one fused insert-gather per
        staging chunk, or K1 alone when nothing is staged). ``slots`` is
        the capacity-padded int32 slot array (-1 for miss/pad);
        ``rows_buffer`` the host buffer with PS-pulled rows at miss
        positions. Returns a ``[capacity, dim]`` tensor on the card."""
        self._process_restart()
        table = self._tables[name]
        budget = self._config.stage_budget
        with self._lock:
            ins_slots = table.staged_slots
            ins_rows = (
                np.concatenate(table.staged_rows, axis=0)
                if table.staged_rows
                else np.empty((0, table.dim), np.float32)
            )
            ev_ids = table.evict_ids
            ev_slots = table.evict_slots
            ev_unsent = table.evict_unsent
            table.staged_slots, table.staged_ids = [], []
            table.staged_rows = []
            table.evict_ids, table.evict_slots = [], []
            table.evict_unsent = []
            self._m_occupancy.labels(table=name).set(
                table.res_ids.size / max(1, table.capacity)
            )
        slots_dev = self._to_device(np.asarray(slots, np.int32))
        miss_dev = self._to_device(np.asarray(rows_buffer, np.float32))
        if not ins_slots and not ev_slots:
            # steady state: nothing staged, a plain gather-merge (K1)
            self.gather_only_combines += 1
            return tier_ops.gather_merge(
                table.state["rows"], slots_dev, miss_dev
            )
        combined = None
        offset = 0
        n_chunks = -(-max(len(ins_slots), len(ev_slots)) // budget)
        for _ in range(n_chunks):
            # each chunk at its real length (the reference pads to the
            # budget with the scratch slot for XLA's static shapes; a
            # launch takes any n, and n = 0 launches nothing)
            ins_chunk = ins_slots[offset: offset + budget]
            row_chunk = ins_rows[offset: offset + budget]
            ev_chunk = ev_slots[offset: offset + budget]
            ev_id_chunk = ev_ids[offset: offset + budget]
            ev_unsent_chunk = ev_unsent[offset: offset + budget]
            offset += budget
            _, combined, evicted = tier_ops.fused_insert_gather(
                table.state,
                self._to_device(np.asarray(ins_chunk, np.int32)),
                self._to_device(row_chunk),
                self._to_device(np.asarray(ev_chunk, np.int32)),
                slots_dev, miss_dev,
            )
            self.staged_chunks += 1
            self.insert_chunks += bool(ins_chunk)
            self.evict_chunks += bool(ev_chunk)
            if ev_chunk:
                # the victims' values, copied before any later launch
                self._submit_writeback(
                    name, np.asarray(ev_id_chunk, np.int64),
                    evicted.cpu().numpy(),
                    np.asarray(ev_unsent_chunk, np.int64),
                )
        return combined

    def apply(self, name, slots, grads):
        """In-device sparse optimizer step (K3) for the hit rows;
        ``grads`` is the step's ``[capacity, dim]`` row-gradient tensor
        on the card."""
        table = self._tables[name]
        tier_ops.fused_scatter_apply(
            table.state, self._to_device(np.asarray(slots, np.int32)),
            grads.detach().float().contiguous(), **self._apply_args
        )
        # re-mark dirty AFTER the apply: a flush that ran between the
        # lookup-time marking and this apply cleared the flag and read
        # the pre-apply value
        with self._lock:
            hit = slots[slots >= 0]
            table.slot_dirty[hit[hit < table.capacity]] = True

    # -- writeback / lifecycle -----------------------------------------
    def _submit_writeback(self, name, ids, values, hits=None):
        """Queue one table's writeback. ``hits`` (aligned with ``ids``)
        are each row's hits since its last writeback: each stood for a
        pull and a push the PS did not see, so they reach the PS's
        embedding lifecycle as twice as many sightings."""
        kwargs = {} if hits is None else {"sightings": {name: 2 * hits}}
        future = self._writeback_pool.submit(
            self._ps.push_embedding_rows, {name: (ids, values)}, **kwargs
        )
        with self._lock:
            self.written_back_rows += len(ids)
            self._writeback_futures.append(future)
            # ids with a writeback in flight: a later PS pull of the
            # same id must wait (wait_for_writebacks). Refcounted: two
            # overlapping writebacks of one id keep the marker until
            # the last one lands.
            pend = self._pending_writeback_ids.setdefault(name, {})
            id_list = [int(i) for i in ids]
            for i in id_list:
                pend[i] = pend.get(i, 0) + 1
            # bounded: drop futures that already resolved cleanly
            self._writeback_futures = [
                f for f in self._writeback_futures
                if not (f.done() and f.exception() is None)
            ]

        def _clear(_future, name=name, id_list=id_list):
            with self._lock:
                pend = self._pending_writeback_ids.get(name)
                if pend is None:
                    return
                for i in id_list:
                    count = pend.get(i, 0) - 1
                    if count <= 0:
                        pend.pop(i, None)
                    else:
                        pend[i] = count

        future.add_done_callback(_clear)

    def wait_for_writebacks(self, name, miss_ids):
        """Miss-path ordering barrier: if any of ``miss_ids`` has a
        writeback in flight, drain the queue before the caller pulls
        them (else the pull reads the stale value and the late
        overwrite reverts gradients pushed meanwhile)."""
        with self._lock:
            pend = self._pending_writeback_ids.get(name)
            if not pend:
                return
            hit = not set(pend).isdisjoint(
                np.asarray(miss_ids, np.int64).tolist()
            )
        if hit:
            self.drain_writebacks()

    def maybe_periodic_writeback(self):
        """Bounded-staleness writeback cadence. MUST run after the
        step's applies (a pre-apply flush would clear dirty flags on
        slots the apply is about to update). A TTL sweep that found
        idle-but-dirty slots forces the flush regardless of cadence."""
        with self._lock:
            forced, self._force_flush = self._force_flush, False
        steps = self._config.writeback_steps
        if not forced and (
            steps <= 0 or self._clock - self._last_writeback < steps
        ):
            return
        self._last_writeback = self._clock
        self._flush_dirty(wait=False)

    def _flush_dirty(self, wait):
        """Write every dirty resident row back to the PS."""
        for name, table in self._tables.items():
            with self._lock:
                dirty = np.nonzero(table.slot_dirty)[0]
                if not dirty.size:
                    continue
                ids = table.slot_id[dirty]
                live = ids >= 0
                dirty, ids = dirty[live], ids[live]
                table.slot_dirty[dirty] = False
                hits = table.slot_unsent[dirty]
                table.slot_unsent[dirty] = 0
            if not dirty.size:
                continue
            self._submit_writeback(name, ids, self._read_rows(table, dirty),
                                   hits)
        if wait:
            self.drain_writebacks()

    def drain_writebacks(self):
        """Block until queued writebacks land; the first failure raises
        (a boundary must not proceed past a lost writeback)."""
        with self._lock:
            futures = self._writeback_futures
            self._writeback_futures = []
        error = None
        for future in futures:
            try:
                future.result()
            # every future is drained before the first error surfaces
            except Exception as e:
                if error is None:
                    error = e
        if error is not None:
            raise error

    def flush(self):
        """Checkpoint/export boundary: every tier-held update reaches
        the PS before the caller proceeds. With ``reassert`` set (the
        worker sets it in a continual stream job) it writes back every
        resident row, clean ones too: a PS whose embedding lifecycle
        evicts rows may have dropped a clean row the tier holds, and the
        state a boundary snapshots must carry it."""
        self._process_restart()
        self._drain_staged()
        if self.reassert:
            with self._lock:
                for table in self._tables.values():
                    table.slot_dirty[table.slot_id >= 0] = True
        self._flush_dirty(wait=True)

    def _drain_staged(self):
        """Land staged promotions and write back staged victims without
        a combined buffer of any use (flush paths)."""
        for name, table in self._tables.items():
            with self._lock:
                pending = bool(table.staged_slots or table.evict_slots)
            if pending:
                empty_slots = np.full((1,), -1, np.int32)
                empty_rows = np.zeros((1, table.dim), np.float32)
                self.combine(name, empty_slots, empty_rows)

    def invalidate(self):
        """Drop every resident row and candidate (PS-restart resync):
        the map empties, device state zeroes, and the hot set
        repopulates from later pulls. Callers flush() first."""
        with self._lock:
            self.epoch += 1
            for table in self._tables.values():
                self._reset_host_maps_locked(table)
                self._reset_state(table)

    def close(self):
        try:
            self.flush()
        except Exception:
            logger.exception("device-tier flush failed at close")
        self._writeback_pool.shutdown(wait=True)

    # -- reporting ------------------------------------------------------
    def stats(self):
        """Cumulative tallies: unique-id hits and misses, hit rate,
        evictions, occupancy, the combines that took the gather-only
        path, the staging chunks landed (those with inserts, those with
        victims), the host reads of resident rows and the rows written
        back to the PS."""
        lookups = self.hits + self.misses
        with self._lock:
            resident = sum(
                t.res_ids.size for t in self._tables.values()
            )
            capacity = sum(
                t.capacity for t in self._tables.values()
            )
        return {
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "hit_rate": self.hits / lookups if lookups else 0.0,
            "occupancy": resident / capacity if capacity else 0.0,
            "gather_only_combines": self.gather_only_combines,
            "staged_chunks": self.staged_chunks,
            "insert_chunks": self.insert_chunks,
            "evict_chunks": self.evict_chunks,
            "row_reads": self.row_reads,
            "written_back_rows": self.written_back_rows,
        }

    def hbm_bytes(self):
        """Device bytes the tier's table state pins (rows + optimizer
        slots): the HBM-accounting side of the worker's device
        telemetry."""
        return sum(
            int(value.numel() * value.element_size())
            for table in self._tables.values()
            for value in table.state.values()
        )

    def table_rows(self, name):
        """Resident (id, row) snapshot, for tests and debugging."""
        table = self._tables[name]
        with self._lock:
            ids = table.res_ids.copy()
            slots = table.res_slots.copy()
        if not slots.size:
            return ids, np.empty((0, table.dim), np.float32)
        return ids, self._read_rows(table, slots)

"""PS-side embedding lifecycle: admission, TTL/LFU eviction, tombstones.

(Copy of elasticdl_tpu/stream/lifecycle.py for the PyTorch port.)

Production CTR vocabularies are unbounded — every novel id that touches
a lazily-initialized table materializes a row (weights + optimizer
slots) forever. Under a clickstream with vocab churn that is a slow
memory leak by design. This manager bounds it with two policies, both
run at the PS (ps/servicer.py routes push/pull ids through here when
lifecycle is enabled):

- **Frequency-based admission**: a novel id is only *tracked* — in a
  bounded count-min sketch, not a table row — until it has been sighted
  ``admit_k`` times (appearances in pull/push traffic). Until then its
  gradients are dropped and its pulls are served from the initializer's
  cold row without materializing anything. One-shot ids (crawlers,
  cookie churn, abuse traffic) therefore cost sketch bytes, not rows.
- **TTL + LFU eviction**: sweeps on the PS poll loop evict admitted
  rows untouched for ``ttl_secs`` (reason ``ttl``) and, when the
  resident-row count exceeds ``max_rows``, the least-frequently-used
  rows down to the bound (reason ``lfu``; the current sweep's survivors
  keep their frequency, optionally decayed so drift ages old hot sets
  out). Evictions delete the row outright on the store —
  ``drop_rows`` removes weights, slots, and Adam step counts, so a
  re-admitted id restarts from the initializer exactly like a
  never-seen id — and are journaled as schema'd ``row_evicted``
  tombstone events so a postmortem can explain a cold row.

Consistency with client caches (the "existing invalidation hooks"
contract, docs/STREAMING.md): an eviction never races a client into
wrongness. The HotRowCache bounds row age by its staleness/TTL clock,
so a cached copy of an evicted row expires within the window the async
PS already tolerates; the device tier holds its resident rows
*authoritatively* and re-asserts them via ``push_embedding_rows``
writebacks — ``note_import`` re-admits such rows, refreshing their
TTL and adding to their LFU frequency the hits the tier served since it
last wrote them back, so the tier's hot set can never be starved by
PS-side eviction.
An import refreshes the TTL stamp but not the LFU guard (the port's
difference from the reference, which stamps both): the guard closes the
gap between an admission filter and its store apply, and an import is
applied before it is noted. So a boundary that re-asserts the tier's
whole resident set does not shield it from the row bound's next sweep.

Crash recovery: lifecycle state is deliberately NOT checkpointed.
After a PS restore, ``adopt_store`` re-anchors conservatively — every
restored row is admitted (no lost admitted rows) with a fresh TTL
stamp and seed frequency, the sketch restarts empty (no phantom
admissions: a novel id must earn its ``admit_k`` sightings again).

Everything is guarded by one lock; sweeps and RPC handlers may race.
"""

import heapq
import threading
import time

import numpy as np

from elasticdl_tpu_torch.common.env_utils import env_float, env_int
from elasticdl_tpu_torch.common.log_utils import default_logger as _logger_factory
from elasticdl_tpu_torch.observability import events
from elasticdl_tpu_torch.observability import metrics as obs_metrics

logger = _logger_factory("elasticdl_tpu_torch.stream.lifecycle")

ADMIT_K_ENV = "EDL_EMB_ADMIT_K"
MAX_ROWS_ENV = "EDL_EMB_MAX_ROWS"
TTL_SECS_ENV = "EDL_EMB_TTL_SECS"
SWEEP_SECS_ENV = "EDL_EMB_SWEEP_SECS"
SKETCH_WIDTH_ENV = "EDL_EMB_SKETCH_WIDTH"
LFU_DECAY_ENV = "EDL_EMB_LFU_DECAY"
LFU_PROTECT_ENV = "EDL_EMB_LFU_PROTECT_SECS"

# ids listed verbatim per tombstone event before truncation: enough to
# answer "why is id X cold" for the ids a postmortem actually asks
# about, without letting one churny sweep write megabyte journal lines
_EVENT_ID_CAP = 128

# bound on the per-window novel-id set behind the tracked-ids gauge
# (cleared every sweep; the gauge saturates here rather than growing)
_TRACKED_CAP = 1 << 17


class CountMinSketch:
    """Conservative-update count-min sketch over int64 ids.

    Bounded memory (depth x width uint32 cells) is the point: this is
    the only structure pre-admission ids ever touch. Estimates
    overcount (never undercount), so admission can fire a sighting or
    two early under collisions — acceptable for a frequency-gate
    heuristic, and the bench's bounded-rows gate holds regardless.
    ``halve()`` ages all cells (sweep-time), so dead one-shot ids stop
    polluting buckets under drift.
    """

    # fixed odd multipliers (splitmix-ish constants): one hash family
    # per row, deterministic across processes
    _MULTS = (0x9E3779B97F4A7C15, 0xC2B2AE3D27D4EB4F,
              0x165667B19E3779F9, 0x27D4EB2F165667C5)

    def __init__(self, width=1 << 15, depth=4):
        self.width = int(width)
        self.depth = min(int(depth), len(self._MULTS))
        self._cells = np.zeros((self.depth, self.width), dtype=np.uint32)

    def _rows(self, ids):
        """[depth, n] bucket indices for ``ids`` (int64 array)."""
        u = ids.astype(np.uint64, copy=False)
        out = np.empty((self.depth, u.size), dtype=np.int64)
        for j in range(self.depth):
            with np.errstate(over="ignore"):
                h = u * np.uint64(self._MULTS[j])
            out[j] = (h >> np.uint64(33)).astype(np.int64) % self.width
        return out

    def add(self, ids, counts):
        """Add ``counts[i]`` sightings of ``ids[i]`` (unique ids);
        returns the post-add estimates. Conservative update: every
        cell rises only to min + count, never beyond — roughly halving
        collision inflation versus the plain per-cell increment."""
        rows = self._rows(ids)
        est = np.empty(ids.size, dtype=np.int64)
        cells = self._cells
        depth_idx = np.arange(self.depth)
        for i in range(ids.size):
            idx = rows[:, i]
            vals = cells[depth_idx, idx]
            new = min(int(vals.min()) + int(counts[i]), 0xFFFFFFFF)
            cells[depth_idx, idx] = np.maximum(vals, np.uint32(new))
            est[i] = new
        return est

    def halve(self):
        self._cells >>= 1

    def clear(self):
        self._cells[:] = 0


class _TableState:
    __slots__ = ("dim", "cold_value", "admitted")

    def __init__(self, dim, cold_value):
        self.dim = dim
        self.cold_value = cold_value
        # id -> [frequency, last_seen, guard] (plain lists: mutated in
        # place). last_seen is the TTL stamp; guard, the LFU in-flight
        # protection stamp, moves only with the admission filters
        self.admitted = {}


class EmbeddingLifecycle:
    """Admission + eviction policy over one PS shard's store.

    ``store`` needs ``drop_rows(name, ids)`` and ``table_size(name)``
    (both embedding-store backends implement them). The servicer calls
    ``filter_pull``/``filter_push``/``note_import`` on the RPC paths
    and ``sweep`` from the PS poll loop.
    """

    def __init__(self, store, admit_k=2, max_rows=0, ttl_secs=0.0,
                 sketch_width=None, lfu_decay=1.0, lfu_protect_secs=1.0,
                 clock=time.time):
        self._store = store
        self.admit_k = max(1, int(admit_k))
        self.max_rows = max(0, int(max_rows))  # 0 = no LFU bound
        self.ttl_secs = float(ttl_secs)        # <=0 = no TTL
        self.lfu_decay = float(lfu_decay)
        # In-flight protection: the admission filter refreshes an id's
        # guard (under this lock) BEFORE the RPC's store apply
        # runs, so an LFU sweep racing that window could evict the row
        # mid-apply — the lazy init would then re-materialize it with
        # fresh slots OUTSIDE the lifecycle's books (a resident row no
        # sweep ever sees again). Excluding just-touched ids from LFU
        # victims closes the race with orders of magnitude of margin
        # over an RPC's filter->apply gap; TTL is safe by construction
        # (its horizon is far behind a just-refreshed stamp).
        self.lfu_protect_secs = float(lfu_protect_secs)
        self._clock = clock
        self._lock = threading.RLock()
        self._tables = {}
        self._sketch = CountMinSketch(
            width=sketch_width or env_int(SKETCH_WIDTH_ENV, 1 << 15)
        )
        # bounded novel-id window behind the tracked-ids gauge
        self._tracked = set()
        # cumulative tallies (telemetry + /statusz)
        self.admitted_total = 0
        self.evicted_ttl_total = 0
        self.evicted_lfu_total = 0
        self.dropped_grad_rows_total = 0
        # {table: [admitted rows, of them LFU-protected in flight]} as the
        # last sweep left them, read under its lock (the port's addition:
        # a count read after the lock is released also holds whatever an
        # import admitted since)
        self.last_sweep_rows = {}
        self._m_admitted = obs_metrics.counter(
            "edl_ps_rows_admitted_total",
            "Embedding rows materialized after passing frequency "
            "admission", ("table",),
        )
        self._m_evicted = obs_metrics.counter(
            "edl_ps_rows_evicted_total",
            "Embedding rows evicted by lifecycle sweeps",
            ("table", "reason"),
        )
        self._m_dropped = obs_metrics.counter(
            "edl_ps_preadmission_grads_dropped_total",
            "Gradient rows dropped because their id had not passed "
            "admission", ("table",),
        )
        obs_metrics.gauge(
            "edl_ps_tracked_ids",
            "Distinct pre-admission ids sighted since the last sweep "
            "(saturates at the tracking cap)",
        ).set_function(lambda: len(self._tracked))
        obs_metrics.gauge(
            "edl_ps_resident_rows",
            "Materialized embedding rows across all tables (the "
            "bounded-memory contract's number)",
        ).set_function(self.resident_rows)

    @classmethod
    def maybe_create(cls, store):
        """Build from the EDL_EMB_* env knobs; None when no policy is
        enabled (the servicer then runs the pre-lifecycle fast paths
        untouched)."""
        admit_k = env_int(ADMIT_K_ENV, 0)
        max_rows = env_int(MAX_ROWS_ENV, 0)
        ttl_secs = env_float(TTL_SECS_ENV, 0.0)
        if admit_k <= 0 and max_rows <= 0 and ttl_secs <= 0:
            return None
        return cls(
            store,
            admit_k=max(1, admit_k),
            max_rows=max_rows,
            ttl_secs=ttl_secs,
            lfu_decay=env_float(LFU_DECAY_ENV, 1.0),
            lfu_protect_secs=env_float(LFU_PROTECT_ENV, 1.0),
        )

    # ------------------------------------------------------------------
    def register_table(self, name, dim, init_kind="uniform",
                       init_param=0.05):
        """Called by the servicer at table creation. The cold row
        served for pre-admission pulls is the initializer's
        deterministic value: the constant for constant/zeros
        initializers, zeros for stochastic kinds (drawing from the
        real RNG stream without materializing would desync the lazy
        init draws of rows that DO admit)."""
        cold = float(init_param) if init_kind == "constant" else 0.0
        with self._lock:
            state = self._tables.get(name)
            if state is None:
                self._tables[name] = _TableState(int(dim), cold)
            else:
                # re-register (restore-then-register-infos): adopt the
                # model's configured initializer, like the store does
                state.dim = int(dim)
                state.cold_value = cold

    def tables(self):
        with self._lock:
            return list(self._tables)

    def cold_rows(self, name, n):
        state = self._tables[name]
        return np.full((int(n), state.dim), state.cold_value,
                       dtype=np.float32)

    def resident_rows(self):
        with self._lock:
            return sum(
                len(s.admitted) for s in self._tables.values()
            )

    # ------------------------------------------------------------------
    def _observe_locked(self, state, name, ids, now):
        """Fold one request's ids into the frequency state; returns
        (admitted mask, newly-admitted ids). Ids crossing ``admit_k``
        on this request admit NOW — their mask is True, so the very
        push/pull that tipped them materializes the row through the
        store's normal lazy init. Caller journals the admissions AFTER
        releasing the lock (journal I/O never runs under a lock RPC
        handlers contend on — the task_dispatcher discipline)."""
        ids = np.asarray(ids, dtype=np.int64).reshape(-1)
        mask = np.empty(ids.size, dtype=bool)
        admitted = state.admitted
        unknown = []
        for pos, i in enumerate(ids):
            entry = admitted.get(int(i))
            if entry is not None:
                entry[0] += 1
                entry[1] = entry[2] = now
                mask[pos] = True
            else:
                mask[pos] = False
                unknown.append(pos)
        if not unknown:
            return mask, ()
        unk_ids = ids[unknown]
        unique, counts = np.unique(unk_ids, return_counts=True)
        est = self._sketch.add(unique, counts)
        if len(self._tracked) < _TRACKED_CAP:
            self._tracked.update(int(i) for i in unique)
        newly = unique[est >= self.admit_k]
        if newly.size:
            for i in newly:
                admitted[int(i)] = [float(self.admit_k), now, now]
            newly_set = set(int(i) for i in newly)
            for pos in unknown:
                if int(ids[pos]) in newly_set:
                    mask[pos] = True
            self.admitted_total += newly.size
            self._m_admitted.labels(table=name).inc(int(newly.size))
        return mask, [int(i) for i in newly]

    def _journal_admissions(self, name, newly, journal):
        """Record newly-admitted ids. ``journal`` (a list of (event,
        fields) the caller emits after releasing ITS lock) is for
        callers already holding a contended lock — the sync push path
        runs under the PS push lock, where journal I/O is forbidden."""
        if not newly:
            return
        entry = ("row_admitted", dict(
            table=name, count=len(newly),
            ids=list(newly[:_EVENT_ID_CAP]),
        ))
        if journal is not None:
            journal.append(entry)
        else:
            events.emit(entry[0], **entry[1])

    def filter_pull(self, name, ids, journal=None):
        """Admission gate for a pull: returns the boolean admitted
        mask. Non-admitted positions must be served the table's cold
        row (``cold_rows``) WITHOUT touching the store — a pull is a
        sighting, never a materialization."""
        if name not in self._tables:
            return np.ones(np.asarray(ids).size, dtype=bool)
        now = self._clock()
        with self._lock:
            mask, newly = self._observe_locked(
                self._tables[name], name, ids, now
            )
        self._journal_admissions(name, newly, journal)
        return mask

    def filter_push(self, name, ids, journal=None):
        """Admission gate for pushed gradients: non-admitted rows'
        gradients are dropped by the caller (counted here)."""
        if name not in self._tables:
            return np.ones(np.asarray(ids).size, dtype=bool)
        now = self._clock()
        with self._lock:
            mask, newly = self._observe_locked(
                self._tables[name], name, ids, now
            )
        self._journal_admissions(name, newly, journal)
        dropped = int(mask.size - mask.sum())
        if dropped:
            self.dropped_grad_rows_total += dropped
            self._m_dropped.labels(table=name).inc(dropped)
        return mask

    def note_import(self, name, ids, sightings=None):
        """Imports are authoritative writes (device-tier writebacks,
        checkpoint restores re-sharding rows in): the rows EXIST after
        the import, so they must be admitted — an unadmitted resident
        row would be invisible to the eviction bound and never age
        out. The TTL stamp moves, the LFU guard does not: the store
        already holds the rows, so no apply of theirs is in flight.

        ``sightings`` (optional, aligned with ``ids``; the port's
        addition) are the uses of each row that the writer absorbed
        since it last wrote the row back: a device tier serves its hot
        rows' pulls and applies their pushes on the card, so the PS
        never sights them. They join the row's LFU frequency as if
        sighted here; without them the row bound's sweeps after a
        re-assert take the tier's hottest rows first, their frequency
        having decayed since the tier promoted them."""
        if name not in self._tables:
            return
        now = self._clock()
        ids = np.asarray(ids, dtype=np.int64).reshape(-1)
        seen = (np.zeros(ids.size) if sightings is None
                else np.asarray(sightings, dtype=np.float64).reshape(-1))
        with self._lock:
            admitted = self._tables[name].admitted
            fresh = 0
            for i, extra in zip(ids.tolist(), seen.tolist()):
                entry = admitted.get(i)
                if entry is None:
                    admitted[i] = [float(self.admit_k) + extra, now,
                                   float("-inf")]
                    fresh += 1
                else:
                    entry[0] += extra
                    entry[1] = now
            if fresh:
                self.admitted_total += fresh
                self._m_admitted.labels(table=name).inc(fresh)

    def adopt_store(self):
        """Post-restore re-anchor (conservative): every row the store
        actually holds is admitted with a fresh TTL stamp and seed
        frequency — no lost admitted rows; everything else (sketch,
        tracked window) restarts empty — no phantom rows."""
        now = self._clock()
        with self._lock:
            self._sketch.clear()
            self._tracked.clear()
            for name, state in self._tables.items():
                state.admitted = {}
                try:
                    ids, _values = self._store.export_table(name)
                except KeyError:
                    continue
                for i in ids:
                    state.admitted[int(i)] = [float(self.admit_k), now, now]
        logger.info(
            "lifecycle re-anchored on restored store: %d resident rows "
            "admitted, sketch cleared", self.resident_rows(),
        )

    # ------------------------------------------------------------------
    def sweep(self):
        """One eviction pass (PS poll loop): TTL first, then the LFU
        bound over the survivors. Returns {"ttl": n, "lfu": n}.
        Evicted rows are dropped from the store and journaled as
        tombstones (after the lock releases); the sketch ages (halve)
        so one-shot ids stop polluting buckets under drift."""
        now = self._clock()
        totals = {"ttl": 0, "lfu": 0}
        journal, rows = [], {}
        with self._lock:
            self._sketch.halve()
            self._tracked.clear()
            for name, state in self._tables.items():
                evict = {}
                admitted = state.admitted
                if self.ttl_secs > 0:
                    horizon = now - self.ttl_secs
                    for i, (freq, last, _guard) in admitted.items():
                        if last < horizon:
                            evict[i] = "ttl"
                in_flight = 0
                if self.max_rows > 0:
                    over = (len(admitted) - len(evict)) - self.max_rows
                    if over > 0:
                        # in-flight protection: a just-touched id may
                        # have an apply between its admission filter
                        # and the store — never an LFU victim (see
                        # __init__). heapq.nsmallest: the cut is
                        # O(n log over), not a full sort under the lock
                        protect = now - self.lfu_protect_secs
                        candidates = [
                            (freq, last, i)
                            for i, (freq, last, guard) in admitted.items()
                            if i not in evict and guard < protect
                        ]
                        in_flight = (len(admitted) - len(evict)
                                     - len(candidates))
                        by_freq = heapq.nsmallest(over, candidates)
                        for _freq, _last, i in by_freq:
                            evict[i] = "lfu"
                if evict:
                    self._evict_locked(name, state, evict, journal)
                    for reason in ("ttl", "lfu"):
                        totals[reason] += sum(
                            1 for r in evict.values() if r == reason
                        )
                if self.lfu_decay < 1.0:
                    for entry in admitted.values():
                        entry[0] *= self.lfu_decay
                rows[name] = [len(admitted), in_flight]
            self.last_sweep_rows = rows
        for event, fields in journal:
            events.emit(event, **fields)
        return totals

    def _evict_locked(self, name, state, evict, journal):
        by_reason = {"ttl": [], "lfu": []}
        for i, reason in evict.items():
            by_reason[reason].append(i)
            state.admitted.pop(i, None)
        for reason, id_list in by_reason.items():
            if not id_list:
                continue
            try:
                self._store.drop_rows(name, np.asarray(id_list,
                                                       dtype=np.int64))
            except KeyError:
                pass
            if reason == "ttl":
                self.evicted_ttl_total += len(id_list)
            else:
                self.evicted_lfu_total += len(id_list)
            self._m_evicted.labels(table=name, reason=reason).inc(
                len(id_list)
            )
            journal.append((
                "row_evicted",
                dict(table=name, reason=reason, count=len(id_list),
                     ids=[int(i) for i in id_list[:_EVENT_ID_CAP]]),
            ))

    # ------------------------------------------------------------------
    def stats(self):
        with self._lock:
            return {
                "admit_k": self.admit_k,
                "max_rows": self.max_rows,
                "ttl_secs": self.ttl_secs,
                "tracked_ids": len(self._tracked),
                "resident_rows": sum(
                    len(s.admitted) for s in self._tables.values()
                ),
                "rows_admitted": self.admitted_total,
                "rows_evicted_ttl": self.evicted_ttl_total,
                "rows_evicted_lfu": self.evicted_lfu_total,
                "grad_rows_dropped": self.dropped_grad_rows_total,
            }

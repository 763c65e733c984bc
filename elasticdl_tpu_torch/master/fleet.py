"""Master-side fleet telemetry aggregation + online anomaly detectors.

(Copy of elasticdl_tpu/master/fleet.py for the PyTorch port.)

Workers and parameter servers piggyback a compact ``TelemetryBlob`` on
the Master RPCs they already make (get_task / report_task_result /
get_comm_info — proto field, no extra RPC); the servicer feeds every
sighting into this monitor, which maintains the single cluster-level
view the per-role /metrics endpoints could not give:

- ``snapshot()``  — the full fleet JSON behind ``GET /statusz``
- ``alerts()``    — currently-firing detectors behind ``GET /alerts``
- ``evaluate()``  — one cheap O(fleet) detector pass; the task
  monitor's scan thread calls it every second, and alert *transitions*
  increment ``edl_master_alerts_total{alert=...}`` in the
  registry and land in the event journal (``alert_raised`` /
  ``alert_cleared``).

Detectors (knobs are env vars so the same binary tunes per job;
constructor args override for tests):

- **straggler**     — a worker's step-time EWMA exceeds
  ``EDL_STRAGGLER_FACTOR`` (default 3.0) x the fleet median, with at
  least 3 workers reporting.
- **dead-air**      — a role previously seen reporting has been silent
  for ``EDL_DEAD_AIR_SECS`` (default 15 s).
- **stuck-round**   — a PS reports a non-empty round buffer whose fill
  has not grown and whose store version has not advanced for
  ``EDL_STUCK_ROUND_SECS`` (default 20 s).
- **version-lag**   — a PS reports version lag beyond
  ``EDL_VERSION_LAG_MAX`` (default 100).

Training-health detectors — the model-side view, fed by
the workers' health-sentinel telemetry (TelemetryBlob fields 28-35)
and the stream feeder's per-window drift stats:

- **nonfinite_loss**  — a worker reports a live nonfinite streak, or
  its cumulative nonfinite count moved within the last
  ``EDL_HEALTH_ALERT_SECS`` (default 30 s; the recency window is what
  makes raise→clear observable for a one-off NaN under ``skip``).
- **loss_spike**      — a worker's cumulative robust-z spike count
  moved within the window.
- **grad_explosion**  — a worker's cumulative grad-norm explosion
  count moved within the window.
- **label_shift**     — a stream window's label rate deviated more
  than ``EDL_LABEL_SHIFT_DELTA`` (default 0.15) from the stream's own
  label-rate EWMA, or its id-novelty rate exceeded
  ``EDL_ID_NOVELTY_MAX`` (default 0.9); the alert detail carries the
  watermark the offending window was tagged with, so drift is
  attributable to a window.

Device-runtime detectors — fed by the workers' XLA
compile ledger and HBM gauges (TelemetryBlob fields 40-51):

- **recompile_storm** — a worker's cumulative xla_recompiles counter
  moved by at least ``EDL_RECOMPILE_STORM_MIN`` (default 3) within
  ``EDL_RECOMPILE_STORM_SECS`` (default 60 s): steady-state shape
  churn, each hit a full XLA compile on the step path. Clears by
  itself as the recency window drains.
- **hbm_pressure**    — a worker's device bytes-in-use exceeds
  ``EDL_HBM_PRESSURE_MAX`` (default 0.9) of its reported device
  limit; a limit of 0 (unknown capacity) never fires.

Everything is plain dict/float work under one lock, sized for a scan
thread ticking at 1 Hz over hundreds of roles — no numpy, no RPC.
"""

import threading
import time

from elasticdl_tpu_torch.common.env_utils import env_float as _env_float
from elasticdl_tpu_torch.common.env_utils import env_str as _env_str
from elasticdl_tpu_torch.common.log_utils import (
    default_logger as _logger_factory,
)
from elasticdl_tpu_torch.observability import events
from elasticdl_tpu_torch.observability import metrics as obs_metrics

logger = _logger_factory("elasticdl_tpu_torch.master.fleet")

STRAGGLER_FACTOR_ENV = "EDL_STRAGGLER_FACTOR"
DEAD_AIR_SECS_ENV = "EDL_DEAD_AIR_SECS"
STUCK_ROUND_SECS_ENV = "EDL_STUCK_ROUND_SECS"
VERSION_LAG_MAX_ENV = "EDL_VERSION_LAG_MAX"
HEALTH_ALERT_SECS_ENV = "EDL_HEALTH_ALERT_SECS"
LABEL_SHIFT_DELTA_ENV = "EDL_LABEL_SHIFT_DELTA"
ID_NOVELTY_MAX_ENV = "EDL_ID_NOVELTY_MAX"
RECOMPILE_STORM_MIN_ENV = "EDL_RECOMPILE_STORM_MIN"
RECOMPILE_STORM_SECS_ENV = "EDL_RECOMPILE_STORM_SECS"
HBM_PRESSURE_MAX_ENV = "EDL_HBM_PRESSURE_MAX"

ALERT_KINDS = (
    "straggler", "dead_air", "stuck_round", "version_lag",
    # training health
    "nonfinite_loss", "loss_spike", "grad_explosion", "label_shift",
    # device runtime
    "recompile_storm", "hbm_pressure",
    # overload plane
    "ps_overload", "circuit_open",
)

# worker-health cumulative counters watched for recent movement:
# blob key -> the alert kind a recent delta raises
_HEALTH_COUNTER_ALERTS = (
    ("health_nonfinite_batches", "nonfinite_loss"),
    ("health_loss_spikes", "loss_spike"),
    ("health_grad_explosions", "grad_explosion"),
)

# overload-plane cumulative counters, same recency-movement
# contract: ps_overload fires while a PS shard's admission rejections
# are moving, circuit_open while a worker's breakers keep tripping —
# both clear on their own once the counters go quiet for the window,
# which is exactly the raise-AND-clear the overload drill asserts
_OVERLOAD_COUNTER_ALERTS = (
    ("ps_overload_rejections", "ps_overload"),
    ("circuit_open_count", "circuit_open"),
)




def _json_num(value, digits=6):
    """Round for the JSON views, keeping nonfinite values explicit:
    a NaN loss must read "nan" on /statusz (json.dumps would emit a
    bare NaN token no strict parser accepts)."""
    value = float(value)
    if value != value or value in (float("inf"), float("-inf")):
        return repr(value)
    return round(value, digits)


class _RoleState:
    """Last-known telemetry for one reporting role."""

    __slots__ = (
        "role", "worker_id", "last_seen", "blob",
        "stuck_since", "stuck_fill", "stuck_version",
        "health_marks", "recompile_last", "recompile_marks",
    )

    def __init__(self, role, worker_id, now):
        self.role = role
        self.worker_id = worker_id
        self.last_seen = now
        self.blob = None  # dict of the last TelemetryBlob's fields
        # stuck-round tracking: when fill/version last changed
        self.stuck_since = None
        self.stuck_fill = 0
        self.stuck_version = 0
        # health-counter recency: cumulative-counter blob
        # key -> (last seen value, ts of last observed increase) — the
        # nonfinite/spike/explosion detectors fire on movement within
        # the recency window, which is what makes raise→clear
        # observable for one-off events
        self.health_marks = {}
        # recompile-storm window: last cumulative
        # xla_recompiles plus [(ts, delta), ...] of observed INCREASES
        # — the detector fires on the in-window delta sum, so warmup
        # compiles (recompiles staying 0) never trip it and the alert
        # self-clears once shapes stabilize and the window drains
        self.recompile_last = None
        self.recompile_marks = []


class FleetMonitor:
    def __init__(
        self,
        straggler_factor=None,
        dead_air_secs=None,
        stuck_round_secs=None,
        version_lag_max=None,
        health_alert_secs=None,
        label_shift_delta=None,
        id_novelty_max=None,
        recompile_storm_min=None,
        recompile_storm_secs=None,
        hbm_pressure_max=None,
    ):
        self._straggler_factor = (
            straggler_factor
            if straggler_factor is not None
            else _env_float(STRAGGLER_FACTOR_ENV, 3.0)
        )
        self._dead_air_secs = (
            dead_air_secs
            if dead_air_secs is not None
            else _env_float(DEAD_AIR_SECS_ENV, 15.0)
        )
        self._stuck_round_secs = (
            stuck_round_secs
            if stuck_round_secs is not None
            else _env_float(STUCK_ROUND_SECS_ENV, 20.0)
        )
        self._version_lag_max = (
            version_lag_max
            if version_lag_max is not None
            else _env_float(VERSION_LAG_MAX_ENV, 100.0)
        )
        # training-health knobs
        self._health_alert_secs = (
            health_alert_secs
            if health_alert_secs is not None
            else _env_float(HEALTH_ALERT_SECS_ENV, 30.0)
        )
        self._label_shift_delta = (
            label_shift_delta
            if label_shift_delta is not None
            else _env_float(LABEL_SHIFT_DELTA_ENV, 0.15)
        )
        self._id_novelty_max = (
            id_novelty_max
            if id_novelty_max is not None
            else _env_float(ID_NOVELTY_MAX_ENV, 0.9)
        )
        # device-runtime knobs: a storm is >= min recompiles
        # observed across a worker's telemetry within the window; HBM
        # pressure is bytes-in-use over the reported device limit
        self._recompile_storm_min = (
            recompile_storm_min
            if recompile_storm_min is not None
            else _env_float(RECOMPILE_STORM_MIN_ENV, 3.0)
        )
        self._recompile_storm_secs = (
            recompile_storm_secs
            if recompile_storm_secs is not None
            else _env_float(RECOMPILE_STORM_SECS_ENV, 60.0)
        )
        self._hbm_pressure_max = (
            hbm_pressure_max
            if hbm_pressure_max is not None
            else _env_float(HBM_PRESSURE_MAX_ENV, 0.9)
        )
        # stream drift books (fed by the feeder, in-process — the
        # stream has no RPC of its own): label-rate EWMA over windows
        # plus the most recent out-of-band window, timestamped so the
        # label_shift alert clears once the stream is back in band
        self._stream_health = {
            "windows": 0,
            "label_rate_ewma": 0.0,
            "novelty_rate_ewma": 0.0,
            "last_label_rate": 0.0,
            "last_novelty_rate": 0.0,
            "watermark": 0,
            "shift_ts": 0.0,     # when the last out-of-band window landed
            "shift_detail": None,
        }
        self._lock = threading.Lock()
        self._roles = {}  # key (worker_id or role string) -> _RoleState
        # alert key (kind, target) -> {"since": ts, ...detail}
        self._firing = {}
        # drain hygiene: workers the control plane is removing
        # ON PURPOSE. A draining worker is exempt from straggler/dead-air
        # detection (it was often picked BECAUSE it is slow, and it goes
        # quiet while it flushes); a cleanly drained worker leaves a
        # silent tombstone in the snapshot's "drained" section instead
        # of a dead_air alert.
        self._draining = {}  # worker_id -> since
        self._drained = {}   # worker_id -> {since, role, reason}
        self._started_at = time.time()
        # the metrics registry: transitions-to-firing per alert kind, plus a
        # live gauge of currently-firing alerts. No-ops when metrics
        # collection is off.
        self._m_alerts = obs_metrics.counter(
            "edl_master_alerts_total",
            "Fleet detector transitions to firing", ("alert",),
        )
        for kind in ALERT_KINDS:
            self._m_alerts.labels(alert=kind)  # stable series set
        obs_metrics.gauge(
            "edl_master_alerts_firing", "Currently firing fleet alerts"
        ).set_function(lambda: len(self._firing))

    # ------------------------------------------------------------------
    # ingestion (called from servicer RPC handlers — keep it O(1))

    def observe(self, worker_id, blob=None):
        """Record a sighting of ``worker_id`` (any Master RPC), with its
        piggybacked telemetry when the request carried one. ``blob`` is
        the TelemetryBlob message or None."""
        now = time.time()
        with self._lock:
            state = self._roles.get(worker_id)
            if state is None:
                # a reused worker_id is a fresh process: its drain
                # history belongs to the predecessor
                self._drained.pop(worker_id, None)
                role = blob.role if blob is not None and blob.role else (
                    "worker-%d" % worker_id
                    if worker_id >= 0
                    else "ps-%d" % (-worker_id - 1)
                )
                state = self._roles[worker_id] = _RoleState(
                    role, worker_id, now
                )
            state.last_seen = now
            if blob is None:
                return
            if blob.role:
                state.role = blob.role
            state.blob = {
                "role": state.role,
                "step_time_ewma": blob.step_time_ewma,
                "examples_per_sec": blob.examples_per_sec,
                "last_task_seconds": blob.last_task_seconds,
                "push_rate": blob.push_rate,
                "pull_rate": blob.pull_rate,
                "version_lag": int(blob.version_lag),
                "model_version": int(blob.model_version),
                "round_buffer_fill": int(blob.round_buffer_fill),
                # cumulative wire payload bytes at the PS —
                # what packed ids / EDL_WIRE_DTYPE actually moved
                "push_bytes": int(blob.push_bytes),
                "pull_bytes": int(blob.pull_bytes),
                # device embedding tier: the worker's HBM
                # hot-set hit rate / fill — the fraction of embedding
                # traffic that never touches the PS wire
                "tier_hit_rate": round(float(blob.tier_hit_rate), 4),
                "tier_occupancy": round(float(blob.tier_occupancy), 4),
                "tier_hits": int(blob.tier_hits),
                "tier_misses": int(blob.tier_misses),
                "tier_evictions": int(blob.tier_evictions),
                # online serving tier: the serve role's
                # 5 s poll puts the inference side next to the
                # training side in /statusz
                "serve_qps": round(float(blob.serve_qps), 2),
                "serve_queue_depth": int(blob.serve_queue_depth),
                "serve_shed_total": int(blob.serve_shed_total),
                # native data plane: which embedding-store
                # backend a PS shard ran — the first thing a
                # postmortem checks on an apply-latency regression
                "ps_native_store": bool(blob.ps_native_store),
                # embedding lifecycle: admission/eviction
                # health — resident rows is the bounded-memory
                # contract's number; tracked ids is the "how many
                # novel ids are knocking" pressure signal
                "ps_rows_admitted": int(blob.ps_rows_admitted),
                "ps_rows_evicted_ttl": int(blob.ps_rows_evicted_ttl),
                "ps_rows_evicted_lfu": int(blob.ps_rows_evicted_lfu),
                "ps_tracked_ids": int(blob.ps_tracked_ids),
                "ps_resident_rows": int(blob.ps_resident_rows),
                # incremental checkpoints: what the shard's
                # last save carried and how long its delta chain is —
                # the restore replay cost a relaunch would pay
                "ps_ckpt_dirty_rows": int(blob.ps_ckpt_dirty_rows),
                "ps_ckpt_chain_len": int(blob.ps_ckpt_chain_len),
                # training health: the worker's numerics
                # sentinels — what the nonfinite_loss / loss_spike /
                # grad_explosion detectors read
                "health_loss_ewma": _json_num(blob.health_loss_ewma),
                "health_loss_last": _json_num(blob.health_loss_last),
                "health_grad_norm": _json_num(blob.health_grad_norm),
                "health_nonfinite_batches": int(
                    blob.health_nonfinite_batches
                ),
                "health_nonfinite_streak": int(
                    blob.health_nonfinite_streak
                ),
                "health_loss_spikes": int(blob.health_loss_spikes),
                "health_grad_explosions": int(
                    blob.health_grad_explosions
                ),
                "health_skipped_batches": int(
                    blob.health_skipped_batches
                ),
                # PS table-health scan
                "ps_row_norm_p50": round(
                    float(blob.ps_row_norm_p50), 6
                ),
                "ps_row_norm_p99": round(
                    float(blob.ps_row_norm_p99), 6
                ),
                "ps_dead_row_fraction": round(
                    float(blob.ps_dead_row_fraction), 4
                ),
                "ps_exploding_rows": int(blob.ps_exploding_rows),
                # device runtime: XLA compile ledger, HBM
                # gauges, and cost-model step attribution — what the
                # recompile_storm / hbm_pressure detectors and the
                # /statusz device section read
                "xla_compiles": int(blob.xla_compiles),
                "xla_recompiles": int(blob.xla_recompiles),
                "xla_compile_secs_total": round(
                    float(blob.xla_compile_secs_total), 3
                ),
                "hbm_bytes_in_use": int(blob.hbm_bytes_in_use),
                "hbm_peak_bytes": int(blob.hbm_peak_bytes),
                "hbm_limit_bytes": int(blob.hbm_limit_bytes),
                "device_live_buffers": int(blob.device_live_buffers),
                "tier_hbm_bytes": int(blob.tier_hbm_bytes),
                "cost_step_flops": float(blob.cost_step_flops),
                "cost_step_bytes": float(blob.cost_step_bytes),
                "h2d_bytes": int(blob.h2d_bytes),
                "d2h_bytes": int(blob.d2h_bytes),
                # overload plane: PS admission pushback plus
                # the client-side resilience counters — what the
                # ps_overload / circuit_open detectors and the /statusz
                # overload section read
                "ps_overload_rejections": int(
                    blob.ps_overload_rejections
                ),
                "ps_pending_applies": int(blob.ps_pending_applies),
                "circuit_open_count": int(blob.circuit_open_count),
                "degraded_pulls": int(blob.degraded_pulls),
                "brownout_skipped_pushes": int(
                    blob.brownout_skipped_pushes
                ),
                "retry_budget_exhausted": int(
                    blob.retry_budget_exhausted
                ),
                # dense data plane: the worker's GSPMD mesh
                # topology, the rendezvous epoch it trains under, and
                # the ICI traffic its dense step puts on the wire —
                # the fleet-level proof the PS carries no dense bytes
                "mesh_shape": str(blob.mesh_shape),
                "mesh_epoch": int(blob.mesh_epoch),
                "collective_bytes_per_step": float(
                    blob.collective_bytes_per_step
                ),
                "dense_step_share": round(
                    float(blob.dense_step_share), 4
                ),
            }
            # recency bookkeeping for the health-counter detectors: a
            # cumulative counter that moved since the last sighting
            # stamps "now" (a restarted worker resetting its counters
            # reads as no movement — harmless)
            for blob_key, _kind in (
                _HEALTH_COUNTER_ALERTS + _OVERLOAD_COUNTER_ALERTS
            ):
                value = state.blob[blob_key]
                prev = state.health_marks.get(blob_key)
                if prev is None:
                    state.health_marks[blob_key] = (
                        value, now if value > 0 else 0.0
                    )
                elif value > prev[0]:
                    state.health_marks[blob_key] = (value, now)
                elif value < prev[0]:
                    state.health_marks[blob_key] = (value, prev[1])
            # recompile-storm bookkeeping: stamp the DELTA
            # of the cumulative recompile counter into the recency
            # window; a counter that went backwards is a restarted
            # worker — reset the baseline, mark nothing
            recompiles = state.blob["xla_recompiles"]
            prev = state.recompile_last
            if prev is not None and recompiles > prev:
                state.recompile_marks.append((now, recompiles - prev))
            state.recompile_last = recompiles
            cutoff = now - self._recompile_storm_secs
            state.recompile_marks = [
                mark for mark in state.recompile_marks
                if mark[0] > cutoff
            ]
            # stuck-round bookkeeping: the clock restarts whenever the
            # fill grows or the store version advances
            fill = int(blob.round_buffer_fill)
            version = int(blob.model_version)
            if fill <= 0:
                state.stuck_since = None
            elif (
                state.stuck_since is None
                or fill > state.stuck_fill
                or version > state.stuck_version
            ):
                state.stuck_since = now
            state.stuck_fill = fill
            state.stuck_version = version

    def observe_stream_window(self, watermark, label_rate, novelty_rate):
        """Fold one stream window's drift stats in: called
        by the stream feeder (in-process, no RPC) as it mints each
        window, tagged with the watermark the window lands at. Label
        rate deviating from the stream's own EWMA — or a novelty rate
        above the ceiling — marks the window out-of-band; the
        label_shift detector fires while the most recent out-of-band
        window is inside the recency window and clears after."""
        now = time.time()
        with self._lock:
            books = self._stream_health
            label_rate = float(label_rate)
            novelty_rate = float(novelty_rate)
            ewma = books["label_rate_ewma"]
            deviation = abs(label_rate - ewma)
            # needs a baseline: the first windows only seed the EWMA
            warmed = books["windows"] >= 5
            shifted = warmed and deviation > self._label_shift_delta
            novel = warmed and novelty_rate > self._id_novelty_max
            if books["windows"] == 0:
                books["label_rate_ewma"] = label_rate
                books["novelty_rate_ewma"] = novelty_rate
            else:
                books["label_rate_ewma"] = (
                    0.9 * books["label_rate_ewma"] + 0.1 * label_rate
                )
                books["novelty_rate_ewma"] = (
                    0.9 * books["novelty_rate_ewma"]
                    + 0.1 * novelty_rate
                )
            books["windows"] += 1
            books["last_label_rate"] = label_rate
            books["last_novelty_rate"] = novelty_rate
            books["watermark"] = int(watermark)
            if shifted or novel:
                books["shift_ts"] = now
                books["shift_detail"] = {
                    "watermark": int(watermark),
                    "label_rate": round(label_rate, 4),
                    "label_rate_ewma": round(ewma, 4),
                    "novelty_rate": round(novelty_rate, 4),
                    "reason": "label_rate" if shifted else "id_novelty",
                }

    def forget(self, worker_id):
        """Drop a role and every alert about it (tests / explicit
        cleanup; evictions go through mark_dead below)."""
        with self._lock:
            self._roles.pop(worker_id, None)
            self._draining.pop(worker_id, None)
            self._drained.pop(worker_id, None)
            for key in [k for k in self._firing if k[1] == worker_id]:
                del self._firing[key]

    def mark_dead(self, worker_id):
        """The task monitor confirmed this worker dead (liveness or
        task-timeout eviction). Force the dead-air transition if the
        silence window hadn't elapsed yet — in a fast-task job the
        3x-average task timeout beats the dead-air window, and the
        eviction must never be QUIETER than the suspicion — and leave
        a tombstone on /alerts (detail ``evicted: true``) that clears
        when the worker re-registers. A worker that was DRAINING when
        it died (drain deadline expired mid-flush) keeps the alert —
        the drain failed, which is exactly what an operator must hear —
        but the tombstone carries ``drained: true`` so the incident
        reads as a late intentional removal, not a surprise death."""
        now = time.time()
        with self._lock:
            was_draining = self._draining.pop(worker_id, None) is not None
            state = self._roles.pop(worker_id, None)
            for key in [
                k for k in self._firing
                if k[1] == worker_id and k[0] != "dead_air"
            ]:
                del self._firing[key]
            key = ("dead_air", worker_id)
            fresh = state is not None and key not in self._firing
            if fresh:
                self._firing[key] = {
                    "since": now, "evicted": True,
                    "role": state.role,
                }
                if was_draining:
                    self._firing[key]["drained"] = True
            elif key in self._firing:
                self._firing[key]["evicted"] = True
                if was_draining:
                    self._firing[key]["drained"] = True
        if fresh:
            self._m_alerts.labels(alert="dead_air").inc()
            logger.warning(
                "fleet alert dead_air on %s: evicted%s", worker_id,
                " (drain deadline expired)" if was_draining else "",
            )
            events.emit("alert_raised", alert="dead_air",
                        target=str(worker_id), evicted=True,
                        drained=was_draining)

    # ------------------------------------------------------------------
    # graceful drain: on-purpose removals must stay silent

    def mark_draining(self, worker_id):
        """The control plane is removing this worker on purpose
        (scale-down victim / preemption notice): exempt it from the
        straggler and dead-air detectors — it is expected to slow down
        and then go quiet — and clear any straggler alert already
        firing about it (it was likely picked BECAUSE it is slow)."""
        cleared = []
        with self._lock:
            self._draining[worker_id] = time.time()
            for key in [
                k for k in self._firing
                if k[1] == worker_id and k[0] == "straggler"
            ]:
                del self._firing[key]
                cleared.append(key)
        for kind, target in cleared:
            events.emit("alert_cleared", alert=kind, target=str(target))

    def mark_drained(self, worker_id, reason=""):
        """Clean drain ack: the worker deregistered after flushing.
        Removes the role and every alert about it WITHOUT raising
        dead_air (the satellite contract: a worker removed on purpose
        must never alert) and records a ``drained: true`` tombstone in
        the snapshot's ``drained`` section, cleared if the id
        re-registers."""
        with self._lock:
            self._draining.pop(worker_id, None)
            state = self._roles.pop(worker_id, None)
            for key in [k for k in self._firing if k[1] == worker_id]:
                del self._firing[key]
            # pop-before-insert keeps dict insertion order == since
            # order even when an id re-registers and drains again
            self._drained.pop(worker_id, None)
            self._drained[worker_id] = {
                "since": time.time(),
                "role": state.role if state is not None
                else str(worker_id),
                "reason": reason,
                "drained": True,
            }
            # bounded: a long-lived autoscaled job drains thousands of
            # workers; keep the most recent tombstones only
            while len(self._drained) > 64:
                del self._drained[next(iter(self._drained))]

    # ------------------------------------------------------------------
    # detection

    def evaluate(self):
        """One detector pass; returns the currently-firing alert list.
        Edge-triggered side effects (counter bump + journal event) fire
        on transitions only, so a 1 Hz scan doesn't spam either."""
        now = time.time()
        with self._lock:
            desired = self._detect_locked(now)
            raised = [k for k in desired if k not in self._firing]
            cleared = [k for k in self._firing if k not in desired]
            for key in raised:
                self._firing[key] = desired[key]
            for key in cleared:
                del self._firing[key]
            firing = self._render_firing_locked()
        for kind, target in raised:
            self._m_alerts.labels(alert=kind).inc()
            detail = desired[(kind, target)]
            logger.warning("fleet alert %s on %s: %s", kind, target, detail)
            events.emit("alert_raised", alert=kind, target=str(target),
                        **{k: v for k, v in detail.items() if k != "since"})
        for kind, target in cleared:
            events.emit("alert_cleared", alert=kind, target=str(target))
        return firing

    def _detect_locked(self, now):
        desired = {}
        # straggler: needs a fleet to compare against
        ewmas = [
            (wid, s.blob["step_time_ewma"])
            for wid, s in self._roles.items()
            if s.blob is not None and s.blob["step_time_ewma"] > 0
            and s.worker_id >= 0 and wid not in self._draining
        ]
        if len(ewmas) >= 3:
            values = sorted(v for _, v in ewmas)
            median = values[len(values) // 2]
            threshold = self._straggler_factor * median
            for wid, ewma in ewmas:
                if median > 0 and ewma > threshold:
                    desired[("straggler", wid)] = {
                        "since": now,
                        "step_time_ewma": round(ewma, 6),
                        "fleet_median": round(median, 6),
                        "factor": round(ewma / median, 2),
                    }
        for wid, state in self._roles.items():
            silent = now - state.last_seen
            if silent > self._dead_air_secs and wid not in self._draining:
                desired[("dead_air", wid)] = {
                    "since": now,
                    "silent_secs": round(silent, 2),
                    "window_secs": self._dead_air_secs,
                }
            if (
                state.stuck_since is not None
                and now - state.stuck_since > self._stuck_round_secs
            ):
                desired[("stuck_round", wid)] = {
                    "since": now,
                    "fill": state.stuck_fill,
                    "stalled_secs": round(now - state.stuck_since, 2),
                }
            if (
                state.blob is not None
                and state.blob["version_lag"] > self._version_lag_max
            ):
                desired[("version_lag", wid)] = {
                    "since": now,
                    "version_lag": state.blob["version_lag"],
                    "max": self._version_lag_max,
                }
            # training-health detectors: a live nonfinite
            # streak always fires; otherwise each counter fires while
            # its last observed movement is inside the recency window
            # (and clears after — a one-off NaN under skip raises then
            # clears, both edges journaled)
            if state.blob is not None:
                streak = state.blob.get("health_nonfinite_streak", 0)
                for blob_key, kind in _HEALTH_COUNTER_ALERTS:
                    mark = state.health_marks.get(blob_key)
                    if mark is None:
                        continue
                    count, moved_at = mark
                    recent = (
                        moved_at > 0
                        and now - moved_at <= self._health_alert_secs
                    )
                    live = kind == "nonfinite_loss" and streak > 0
                    if not (recent or live):
                        continue
                    detail = {
                        "since": now,
                        "count": count,
                        "window_secs": self._health_alert_secs,
                    }
                    if kind == "nonfinite_loss":
                        detail["streak"] = streak
                        detail["skipped"] = state.blob.get(
                            "health_skipped_batches", 0
                        )
                        detail["loss"] = state.blob.get(
                            "health_loss_last", 0.0
                        )
                    elif kind == "loss_spike":
                        detail["loss"] = state.blob.get(
                            "health_loss_last", 0.0
                        )
                        detail["loss_ewma"] = state.blob.get(
                            "health_loss_ewma", 0.0
                        )
                    else:  # grad_explosion
                        detail["grad_norm"] = state.blob.get(
                            "health_grad_norm", 0.0
                        )
                    desired[(kind, wid)] = detail
                # device-runtime detectors. recompile_storm:
                # the in-window recompile delta sum crossed the floor —
                # steady-state shape churn (unpadded batches, dtype
                # flapping), each hit a full XLA compile on the step
                # path. Clears by itself as the window drains.
                cutoff = now - self._recompile_storm_secs
                in_window = sum(
                    delta for ts, delta in state.recompile_marks
                    if ts > cutoff
                )
                if in_window >= self._recompile_storm_min:
                    desired[("recompile_storm", wid)] = {
                        "since": now,
                        "recompiles_in_window": in_window,
                        "window_secs": self._recompile_storm_secs,
                        "xla_recompiles": state.blob["xla_recompiles"],
                        "compile_secs_total": state.blob[
                            "xla_compile_secs_total"
                        ],
                    }
                # hbm_pressure: bytes-in-use over the reported device
                # limit (limit 0 = unknown capacity, never fires)
                limit = state.blob["hbm_limit_bytes"]
                in_use = state.blob["hbm_bytes_in_use"]
                if limit > 0 and in_use / limit > self._hbm_pressure_max:
                    desired[("hbm_pressure", wid)] = {
                        "since": now,
                        "hbm_bytes_in_use": in_use,
                        "hbm_limit_bytes": limit,
                        "fraction": round(in_use / limit, 4),
                        "max_fraction": self._hbm_pressure_max,
                        "tier_hbm_bytes": state.blob["tier_hbm_bytes"],
                    }
                # overload-plane detectors: a cumulative
                # counter fires while its last observed movement is
                # inside the recency window and clears after — a PS
                # that stopped rejecting (or a worker whose breakers
                # re-closed) goes quiet and the alert self-clears
                for blob_key, kind in _OVERLOAD_COUNTER_ALERTS:
                    mark = state.health_marks.get(blob_key)
                    if mark is None:
                        continue
                    count, moved_at = mark
                    if not (
                        moved_at > 0
                        and now - moved_at <= self._health_alert_secs
                    ):
                        continue
                    detail = {
                        "since": now,
                        "count": count,
                        "window_secs": self._health_alert_secs,
                    }
                    if kind == "ps_overload":
                        detail["pending_applies"] = state.blob.get(
                            "ps_pending_applies", 0
                        )
                    else:  # circuit_open
                        detail["degraded_pulls"] = state.blob.get(
                            "degraded_pulls", 0
                        )
                        detail["brownout_skipped_pushes"] = (
                            state.blob.get("brownout_skipped_pushes", 0)
                        )
                    desired[(kind, wid)] = detail
        # label_shift: the most recent out-of-band stream
        # window is inside the recency window
        shift_ts = self._stream_health["shift_ts"]
        if (
            shift_ts > 0
            and now - shift_ts <= self._health_alert_secs
            and self._stream_health["shift_detail"] is not None
        ):
            detail = {"since": now}
            detail.update(self._stream_health["shift_detail"])
            desired[("label_shift", "stream")] = detail
        # eviction tombstones persist while their worker stays gone;
        # a re-registration re-adds the role and the normal logic
        # above then clears (or re-raises) the alert
        for key, detail in self._firing.items():
            if key[0] == "dead_air" and key[1] not in self._roles:
                desired[key] = detail
        # a firing alert keeps its original "since"
        for key, detail in desired.items():
            if key in self._firing:
                detail["since"] = self._firing[key]["since"]
        return desired

    def _render_firing_locked(self):
        firing = []
        for (kind, target), detail in sorted(
            self._firing.items(), key=lambda kv: str(kv[0])
        ):
            state = self._roles.get(target)
            entry = {
                "alert": kind,
                "worker_id": target,
                "role": state.role if state is not None else str(target),
                "firing_secs": round(time.time() - detail["since"], 2),
            }
            entry.update(
                {k: v for k, v in detail.items() if k != "since"}
            )
            firing.append(entry)
        return firing

    # ------------------------------------------------------------------
    # autoscaler inputs (master/autoscaler.py): cheap O(fleet) reads

    def worker_step_ewmas(self):
        """{worker_id: step_time_ewma} for every reporting worker —
        the autoscaler's victim-selection signal (slowest first)."""
        with self._lock:
            return {
                wid: s.blob["step_time_ewma"]
                for wid, s in self._roles.items()
                if wid >= 0 and s.blob is not None
                and s.blob["step_time_ewma"] > 0
            }

    def fleet_examples_per_sec(self):
        """Sum of worker examples/s — the throughput the autoscaler's
        marginal-gain guard tracks across resizes."""
        with self._lock:
            return sum(
                s.blob["examples_per_sec"]
                for wid, s in self._roles.items()
                if wid >= 0 and s.blob is not None
            )

    # ------------------------------------------------------------------
    # exposition

    def alerts(self):
        """Fresh detector pass + the firing list (the /alerts body)."""
        return self.evaluate()

    def snapshot(self, extra=None):
        """Full fleet view (the /statusz body): every reporting role's
        last telemetry + freshness, the firing alerts, and whatever the
        master adds (task queue stats). JSON-ready."""
        firing = self.evaluate()
        now = time.time()
        with self._lock:
            roles = {}
            for wid, state in self._roles.items():
                entry = {
                    "worker_id": wid,
                    "last_seen_secs_ago": round(now - state.last_seen, 2),
                }
                if state.blob is not None:
                    entry.update(state.blob)
                if wid in self._draining:
                    entry["draining"] = True
                roles[state.role] = entry
            drained = {
                detail["role"]: {
                    "worker_id": wid,
                    "drained_secs_ago": round(now - detail["since"], 2),
                    "reason": detail["reason"],
                    "drained": True,
                }
                for wid, detail in self._drained.items()
            }
            # training-health section: the model-side view
            # in one place — worker sentinels, PS table health, stream
            # drift — so "is the model OK" is one /statusz read
            health_workers = {}
            health_ps = {}
            for wid, state in self._roles.items():
                if state.blob is None:
                    continue
                if wid >= 0:
                    health_workers[state.role] = {
                        key: state.blob[key]
                        for key in (
                            "health_loss_ewma", "health_loss_last",
                            "health_grad_norm",
                            "health_nonfinite_batches",
                            "health_nonfinite_streak",
                            "health_loss_spikes",
                            "health_grad_explosions",
                            "health_skipped_batches",
                        )
                    }
                else:
                    health_ps[state.role] = {
                        key: state.blob[key]
                        for key in (
                            "ps_row_norm_p50", "ps_row_norm_p99",
                            "ps_dead_row_fraction",
                            "ps_exploding_rows",
                        )
                    }
            stream_health = {
                key: value
                for key, value in self._stream_health.items()
                if key != "shift_detail"
            }
            stream_health["last_shift"] = self._stream_health[
                "shift_detail"
            ]
            health = {
                "workers": health_workers,
                "ps": health_ps,
                "stream": stream_health,
            }
            # device-runtime section: every worker's XLA
            # compile ledger, HBM occupancy, and cost-model step
            # attribution in one place — "is the device OK" is one
            # /statusz read, same contract as the health section
            device = {}
            for wid, state in self._roles.items():
                if state.blob is None or wid < 0:
                    continue
                if not state.blob.get("xla_compiles"):
                    # role never compiled anything (PS-style worker
                    # ids, obs disabled): no device story to tell
                    continue
                device[state.role] = {
                    key: state.blob[key]
                    for key in (
                        "xla_compiles", "xla_recompiles",
                        "xla_compile_secs_total",
                        "hbm_bytes_in_use", "hbm_peak_bytes",
                        "hbm_limit_bytes", "device_live_buffers",
                        "tier_hbm_bytes",
                        "cost_step_flops", "cost_step_bytes",
                        "h2d_bytes", "d2h_bytes",
                    )
                }
            # overload section: PS admission pressure next
            # to the clients' resilience posture — "is the training
            # plane shedding or degrading" is one /statusz read
            overload_ps = {}
            overload_clients = {}
            for wid, state in self._roles.items():
                if state.blob is None:
                    continue
                if wid < 0:
                    overload_ps[state.role] = {
                        key: state.blob[key]
                        for key in (
                            "ps_overload_rejections",
                            "ps_pending_applies",
                        )
                    }
                else:
                    overload_clients[state.role] = {
                        key: state.blob[key]
                        for key in (
                            "circuit_open_count", "degraded_pulls",
                            "brownout_skipped_pushes",
                            "retry_budget_exhausted",
                        )
                    }
            overload_view = {
                "ps": overload_ps,
                "clients": overload_clients,
            }
            # dense data plane section: per-worker mesh
            # shape, rendezvous epoch, and collective traffic — plus
            # the dense-step share of batch time. A worker whose
            # mesh_epoch trails its peers is mid-restart; a share well
            # under 1.0 on a dense job means the PS crept back onto
            # the hot path.
            dense_plane = {}
            for wid, state in self._roles.items():
                if state.blob is None or wid < 0:
                    continue
                if not state.blob.get("mesh_shape"):
                    continue
                dense_plane[state.role] = {
                    key: state.blob[key]
                    for key in (
                        "mesh_shape", "mesh_epoch",
                        "collective_bytes_per_step",
                        "dense_step_share",
                    )
                }
        body = {
            "ts": now,
            "job": _env_str(events.JOB_NAME_ENV, ""),
            "uptime_secs": round(now - self._started_at, 2),
            "fleet": roles,
            "drained": drained,
            "alerts": firing,
            "health": health,
            "device": device,
            "overload": overload_view,
            "dense_plane": dense_plane,
            "thresholds": {
                "straggler_factor": self._straggler_factor,
                "dead_air_secs": self._dead_air_secs,
                "stuck_round_secs": self._stuck_round_secs,
                "version_lag_max": self._version_lag_max,
                "health_alert_secs": self._health_alert_secs,
                "label_shift_delta": self._label_shift_delta,
                "id_novelty_max": self._id_novelty_max,
                "recompile_storm_min": self._recompile_storm_min,
                "recompile_storm_secs": self._recompile_storm_secs,
                "hbm_pressure_max": self._hbm_pressure_max,
            },
        }
        if extra:
            body.update(extra)
        return body

"""Structured event journal: the cluster flight recorder.

(Copy of elasticdl_tpu/observability/events.py for the PyTorch port.)

Schema'd NDJSON lifecycle events per role under ``$EDL_EVENTS_DIR``:
``<role>-<pid>.events.ndjson``, one JSON object per line. Every line
carries the envelope (``ts`` wall-clock seconds, ``role``, ``pid``,
``seq`` monotonic per process, ``job`` from ``EDL_JOB_NAME``, ``event``)
plus the event's own correlation fields (``worker``, ``task``,
``version``, ...) — the keys ``scripts/postmortem.py`` threads a dead
job's artifacts together by.

Durability model (this is a black box, not a log):

- The journal is written THROUGH — every line is appended and flushed
  before ``emit`` returns. Lifecycle events are task-/round-rate, not
  step-internal-rate, so a flush per line is noise next to the RPC that
  produced the event, and it is the only discipline that survives
  SIGKILL/OOM-kill: whatever the kernel let us write is on disk.
- A bounded ring buffer (last ``_RING_SIZE`` events) additionally lives
  in memory; ``dump(reason)`` writes it with the crash reason to
  ``<role>-<pid>.dump.json``. Crash hooks (``install_crash_hooks``:
  SIGTERM + uncaught-exception hook; role mains call it) dump the ring
  so an evicted pod's last moments are one self-contained file even
  when the journal itself is on slow/contended storage.

Disabled (``EDL_EVENTS_DIR`` unset) the module is inert: ``emit`` costs
one module-global None check — the disabled-is-no-op discipline.
"""

import json
import os
import signal
import sys
import threading
import time

from elasticdl_tpu_torch.common.env_utils import env_str
from elasticdl_tpu_torch.common.log_utils import (
    default_logger as _logger_factory,
)

logger = _logger_factory("elasticdl_tpu_torch.observability.events")

EVENTS_DIR_ENV = "EDL_EVENTS_DIR"
JOB_NAME_ENV = "EDL_JOB_NAME"

_RING_SIZE = 256

# The event vocabulary: postmortem tooling and tests key off these
# names, so emitting an unknown type is a programming error (caught
# loudly in emit). Fields beyond the envelope are free-form but the
# comments document the correlation keys each type carries.
EVENT_TYPES = frozenset({
    # role lifecycle
    "role_start",            # role came up (worker: + incarnation epoch)
    "role_stop",             # orderly exit
    "crash_dump",            # ring dumped from a crash path (+ reason)
    # worker <-> master
    "worker_register",       # reset_worker served (+ worker, epoch)
    "worker_presumed_dead",  # liveness/timeout eviction (+ worker)
    "mesh_epoch_restart",    # worker exiting to rejoin a new mesh epoch
    # control-plane crash recovery
    "master_restarted",      # journal replayed (+ master_epoch, todo,
                             #   requeued, epochs_left)
    "ps_restored",           # PS auto-restored a checkpoint at boot
                             #   (+ version, ps)
    "worker_resynced",       # worker detected a PS state regression and
                             #   re-pushed its model (+ shard, version)
    "checkpoint_skipped",    # corrupt/incomplete checkpoint version
                             #   skipped during restore (+ version, why)
    # elasticity control loop
    "scale_decision",        # autoscaler resize (+direction, delta,
                             #   workers, queue_depth, reasons)
    "worker_draining",       # graceful drain begun (+worker, reason,
                             #   initiator master|worker)
    "drain_ack",             # drain completed: task reported, push
                             #   joined, tier flushed (+worker, reason)
                             #   — journaled by the MASTER on the
                             #   deregister RPC; exactly one per drain
    "drain_unacked",         # worker finished flushing but the master
                             #   never acknowledged the deregister
                             #   (old master / RPC failure); the
                             #   worker-side record of the drain
    "drain_expired",         # drain deadline passed; requeue-on-death
                             #   fallback fired (+worker)
    # task lifecycle (+ task, worker)
    "task_dispatch",
    "task_report",           # + ok, err
    "task_requeue",          # + retries, counted
    "job_failed",            # retry cap exhausted (+ task)
    # sync-PS rounds (+ version)
    "round_open",            # first push buffered for a round
    "round_fill",            # push buffered (+ fill)
    "round_close",           # round applied (+ pushes)
    "stale_push_rejected",   # + worker, version, store_version
    "dead_incarnation_dropped",  # + worker, incarnation
    # checkpoints (+ version)
    "checkpoint_saved",
    # fleet detectors (+ alert, target)
    "alert_raised",
    "alert_cleared",
    # online serving tier
    "model_loaded",          # serve role loaded its first export
                             #   (+ step, stamp, path)
    "version_swapped",       # hot swap completed; in-flight requests
                             #   finished on the old version
                             #   (+ from_step, to_step, stamp)
    "requests_shed",         # admission control shed load — RATE-
                             #   LIMITED to ~1 line/s (+ reason, count
                             #   since last line, total)
    "serve_drained",         # SIGTERM drain: admissions stopped, queue
                             #   flushed (+ reason, flushed, served,
                             #   shed)
    # serving fleet: router-side replica lifecycle + canary
    "replica_registered",    # replica joined the router's ring
                             #   (+ replica, addr, stamp)
    "replica_lost",          # heartbeats stopped; pulled from the ring
                             #   (+ replica, silent_secs)
    "replica_draining",      # router stopped routing to a shrink
                             #   victim (+ replica, reason)
    "canary_started",        # new export takes the canary slice
                             #   (+ export, members, fraction)
    "canary_promoted",       # judge passed; fleet directed to the new
                             #   export (+ export, reasons)
    "canary_rolled_back",    # judge failed; canary members directed
                             #   back to incumbent (+ export, reasons)
    # distributed tracing
    "trace_flushed",         # a drain path flushed the trace buffer to
                             #   EDL_TRACE_DIR (+ reason)
    # continuous profiling
    "profiler_started",      # the role's stack sampler came up
                             #   (+ hz, ring_secs)
    "profile_captured",      # an on-demand /profilez window capture
                             #   completed (+ seconds, samples, stacks)
    # continual streaming training
    "row_admitted",          # ids passed frequency admission and
                             #   materialized real rows (+ table,
                             #   count, ids[:128])
    "row_evicted",           # lifecycle sweep tombstone: rows deleted
                             #   from the store (+ table, reason
                             #   ttl|lfu, count, ids[:128]) — the
                             #   postmortem answer to "why is this row
                             #   cold"
    "stream_watermark",      # watermark progress marker (+ watermark,
                             #   minted, kind window|export|checkpoint
                             #   |closed) — the streaming durability
                             #   clock the checkpoint/export cadence
                             #   rides
    # training-health sentinels
    "health_nonfinite",      # nonfinite loss/grads streak OPENED
                             #   (+ loss, grad_norm, action; edge-
                             #   journaled so a NaN-wedged job can't
                             #   flood the journal)
    "health_loss_spike",     # robust-z loss spike (+ loss, ewma)
    "health_grad_explosion",  # grad-norm explosion (+ grad_norm, ewma)
    "health_halt",           # EDL_HEALTH_ON_NONFINITE=halt tripped:
                             #   the task fails loudly and the process
                             #   exits nonzero (+ loss, grad_norm,
                             #   streak)
    "health_table_exploding",  # PS table-health scan found sampled
                             #   rows beyond EDL_HEALTH_ROW_NORM_MAX
                             #   (+ ps, rows, tables, norm_max; edge-
                             #   journaled per scan transition)
    # overload plane
    "ps_overload_enter",     # PS apply backlog crossed
                             #   EDL_PS_MAX_PENDING_APPLIES; admission
                             #   now answers RESOURCE_EXHAUSTED with a
                             #   retry-after hint (+ ps_id, depth,
                             #   max_pending, method; edge-journaled)
    "ps_overload_clear",     # backlog drained below the limit
                             #   (+ ps_id, depth)
    "circuit_open",          # per-(target, method-class) breaker
                             #   tripped (+ target, method_class,
                             #   previous, consecutive_failures,
                             #   reset_secs)
    "circuit_half_open",     # probe window opened: one trial RPC
                             #   admitted (+ target, method_class)
    "circuit_closed",        # probe succeeded; normal pacing resumed
                             #   (+ target, method_class)
    "degraded_pull",         # brownout: pull served bounded-staleness
                             #   cached/cold-init rows instead of the
                             #   open-circuited PS (+ table, rows,
                             #   cached, cold)
    "brownout_skipped_push",  # trainer dropped a batch's push after
                             #   EDL_BROWNOUT_SKIP_AFTER consecutive
                             #   failures (+ skipped, version)
    "brownout_recovered",    # pushes landing again after a brownout
                             #   skip streak (+ skipped, version)
    # device-runtime observability
    "xla_recompile",         # a wrapped step fn compiled AGAIN — a new
                             #   argument signature after warmup
                             #   (+ fn, compiles, seconds, changed
                             #   [leaf: old -> new provenance],
                             #   signature) — the journal line the
                             #   recompile_storm postmortem reads
})


class EventJournal:
    """Write-through NDJSON journal + in-memory ring for one role."""

    def __init__(self, role, events_dir, pid=None):
        self.role = role
        self.dir = events_dir
        # pid override for tests emulating several roles in one process
        self.pid = os.getpid() if pid is None else pid
        self.job = env_str(JOB_NAME_ENV, "")
        self.path = os.path.join(
            events_dir, "%s-%d.events.ndjson" % (role, self.pid)
        )
        self.dump_path = os.path.join(
            events_dir, "%s-%d.dump.json" % (role, self.pid)
        )
        # RLock, not Lock: the SIGTERM crash hook runs dump()/flush()
        # on the main thread, and the signal may land while that same
        # thread is inside emit() holding this lock — a plain Lock
        # would deadlock the dying pod and lose the dump it exists to
        # produce
        self._lock = threading.RLock()
        self._seq = 0
        self._ring = []  # bounded to _RING_SIZE below
        self._file = None
        self._dumped = False

    def emit(self, event, fields):
        record = {
            "ts": time.time(),
            "role": self.role,
            "pid": self.pid,
            "event": event,
        }
        if self.job:
            record["job"] = self.job
        record.update(fields)
        with self._lock:
            self._seq += 1
            record["seq"] = self._seq
            line = json.dumps(record)
            self._ring.append(record)
            del self._ring[:-_RING_SIZE]
            try:
                if self._file is None:
                    os.makedirs(self.dir, exist_ok=True)
                    self._file = open(self.path, "a", encoding="utf-8")
                self._file.write(line + "\n")
                # write-through: the journal must survive SIGKILL, and
                # lifecycle events are rare enough that a flush per
                # line costs nothing next to the RPC that produced it
                self._file.flush()
            except (OSError, RuntimeError) as e:
                # RuntimeError: reentrant TextIOWrapper call when a
                # signal handler (SIGTERM drain hook) emits while the
                # interrupted thread is inside this same write(); the
                # record is still in the ring, and losing one journal
                # line beats crashing the drain
                logger.warning("event journal write failed: %s", e)

    def dump(self, reason):
        """Write the last-K ring (+ reason) as one self-contained JSON
        file — the crash-path black box. First reason wins: a SIGTERM
        followed by the dying interpreter's excepthook must not
        overwrite the original cause."""
        with self._lock:
            if self._dumped:
                return None
            self._dumped = True
            ring = list(self._ring)
        payload = {
            "role": self.role,
            "pid": self.pid,
            "job": self.job,
            "reason": reason,
            "dumped_at": time.time(),
            "events": ring,
        }
        try:
            os.makedirs(self.dir, exist_ok=True)
            with open(self.dump_path, "w", encoding="utf-8") as f:
                json.dump(payload, f)
        except OSError as e:
            logger.warning("ring dump to %s failed: %s", self.dump_path, e)
            return None
        return self.dump_path

    def flush(self):
        with self._lock:
            if self._file is not None:
                try:
                    self._file.flush()
                except (OSError, RuntimeError):
                    # RuntimeError: reentrant BufferedWriter call when
                    # the crash hook interrupted emit() mid-write; the
                    # torn line is tolerated by the postmortem parser
                    pass

    def close(self):
        with self._lock:
            if self._file is not None:
                try:
                    self._file.close()
                except OSError:
                    pass
                self._file = None


_journal = None
_journal_lock = threading.Lock()


def configure(role):
    """Install the per-process journal when EDL_EVENTS_DIR is set; call
    once from each role's entry point (extra calls re-bind the role).
    Returns the journal or None when journaling is disabled."""
    global _journal
    events_dir = env_str(EVENTS_DIR_ENV, "")
    with _journal_lock:
        if not events_dir:
            _journal = None
            return None
        _journal = EventJournal(role, events_dir)
        return _journal


def enabled():
    return _journal is not None


def emit(event, **fields):
    """Append one lifecycle event; inert without EDL_EVENTS_DIR."""
    journal = _journal
    if journal is None:
        return
    if event not in EVENT_TYPES:
        raise ValueError("unknown event type %r" % event)
    journal.emit(event, fields)


def flush():
    journal = _journal
    if journal is not None:
        journal.flush()


def dump(reason):
    """Force the ring buffer to disk (crash paths); returns the dump
    path or None when disabled/failed."""
    journal = _journal
    if journal is not None:
        return journal.dump(reason)
    return None


# ---------------------------------------------------------------------------
# crash hooks: the black box must outlive the pod

_hooks_installed = False


def install_crash_hooks():
    """Arrange for the flight recorder to survive this process's death:

    - SIGTERM (K8s eviction): dump the ring, flush the journal and the
      trace buffer, then chain to the previously installed handler —
      or exit 0 if there was none, matching the graceful-eviction
      contract (SystemExit unwinds through the role main's
      try/finally, so in-flight state still flushes).
    - uncaught exception: dump the ring with the exception type as the
      reason, then defer to the original excepthook.

    Call from role MAINS only (signal handlers need the main thread).
    Idempotent; the hooks re-check journal state at fire time, so a
    main may install them before deciding whether to configure()."""
    global _hooks_installed
    if _hooks_installed:
        return
    _hooks_installed = True

    from elasticdl_tpu_torch.observability import trace

    previous_term = signal.getsignal(signal.SIGTERM)

    def _on_term(signum, frame):
        dump("sigterm")
        flush()
        trace.flush()
        if callable(previous_term):
            previous_term(signum, frame)
        else:
            sys.exit(0)

    try:
        signal.signal(signal.SIGTERM, _on_term)
    except ValueError:
        # not the main thread (embedded use) — journal write-through
        # still covers the SIGKILL story; only the dump convenience
        # is lost
        logger.warning("not on main thread; SIGTERM hook not installed")

    previous_hook = sys.excepthook

    def _on_uncaught(exc_type, exc, tb):
        dump("uncaught:%s" % exc_type.__name__)
        flush()
        trace.flush()
        previous_hook(exc_type, exc, tb)

    sys.excepthook = _on_uncaught


def _reset_for_tests():
    """Drop the journal and hook state (tests only)."""
    global _journal, _hooks_installed
    with _journal_lock:
        _journal = None
    _hooks_installed = False

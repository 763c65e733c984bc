"""Serving-fleet control plane: replica registry, autoscaler, scaler
(port of elasticdl_tpu/serve/fleet.py).

The router's control-plane half; the data plane (consistent-hash
routing, failover, canary slicing) lives in ``serve/router.py``:

- ``ReplicaRegistry`` -- the authoritative replica table, fed by the
  Router gRPC surface (register/heartbeat/deregister). A replica joins
  with its addr and capacity, heartbeats its TelemetryBlob and its
  loaded / available export versions every ``EDL_ROUTER_HEARTBEAT_SECS``,
  and leaves either gracefully (``deregister_replica``, the exactly-once
  drain ack) or by silence (``EDL_ROUTER_REPLICA_TIMEOUT_SECS`` without a
  heartbeat journals ``replica_lost`` and pulls it from the ring).
  Heartbeats carry directives down to the replica: ``drain`` (shrink
  victim / shutdown) and ``target_export`` (canary / promote steering).
- ``ReplicaAutoscaler`` -- replica-reported QPS / queue depth / shed
  rate drive grow/shrink through the master's ``DecisionGate`` hold and
  cooldown; every decision is journaled as a ``scale_decision`` event
  (``tag="serve"``) with the signals that fired. Shrink victims drain
  through the registry.
- ``SubprocessReplicaScaler`` -- replicas as local
  ``elasticdl_tpu_torch.serve.main`` subprocesses (in production the
  k8s pod manager plays this role).
- ``scan_export_versions`` -- versioned-export discovery: the fleet
  export root holds one subdirectory per export bundle.

Series: ``edl_router_replicas{state}``,
``edl_serve_scale_decisions_total{direction}``.
"""

import os
import signal
import subprocess
import sys
import threading
import time

from elasticdl_tpu_torch.common.env_utils import env_float, env_int
from elasticdl_tpu_torch.common.grpc_utils import build_channel, find_free_port
from elasticdl_tpu_torch.common.log_utils import (
    default_logger as _logger_factory,
)
from elasticdl_tpu_torch.master.autoscaler import DecisionGate
from elasticdl_tpu_torch.observability import events
from elasticdl_tpu_torch.observability import metrics as obs_metrics
from elasticdl_tpu_torch.proto import services
from elasticdl_tpu_torch.serve.model import export_signature

logger = _logger_factory("elasticdl_tpu_torch.serve.fleet")

HEARTBEAT_ENV = "EDL_ROUTER_HEARTBEAT_SECS"
REPLICA_TIMEOUT_ENV = "EDL_ROUTER_REPLICA_TIMEOUT_SECS"
MIN_REPLICAS_ENV = "EDL_SERVE_MIN_REPLICAS"
MAX_REPLICAS_ENV = "EDL_SERVE_MAX_REPLICAS"
SCALE_STEP_ENV = "EDL_SERVE_SCALE_STEP"
SCALE_HOLD_ENV = "EDL_SERVE_SCALE_HOLD_SECS"
SCALE_COOLDOWN_ENV = "EDL_SERVE_SCALE_COOLDOWN_SECS"
QUEUE_PER_REPLICA_ENV = "EDL_SERVE_QUEUE_PER_REPLICA"
QPS_PER_REPLICA_ENV = "EDL_SERVE_QPS_PER_REPLICA"


def scan_export_versions(root):
    """Complete export bundles under ``root``, oldest first.

    Returns ``[(rel_name, step, stamp), ...]`` for every subdirectory
    holding a complete bundle (``export_signature`` answers None for
    half-written ones, so a publisher racing this scan is invisible
    until its manifest lands — the same torn-read guard the single-pod
    engine's watcher relies on). The root itself as a flat bundle is
    the single-pod layout and is NOT a fleet version.
    """
    out = []
    try:
        names = sorted(os.listdir(root))
    except OSError:
        return out
    for name in names:
        path = os.path.join(root, name)
        if not os.path.isdir(path):
            continue
        sig = export_signature(path)
        if sig is None:
            continue
        out.append((name, int(sig.split(":", 1)[0]), sig))
    out.sort(key=lambda t: (t[1], t[0]))
    return out


class _Replica:
    """One registered serve replica, as the router sees it."""

    __slots__ = (
        "replica_id", "addr", "channel", "stub", "max_batch",
        "registered_at", "last_heartbeat", "loaded_export",
        "loaded_stamp", "available_export", "available_stamp",
        "draining", "drain_reason", "target_export", "qps",
        "queue_depth", "shed_total", "served", "canary",
    )

    def __init__(self, replica_id, addr, channel, stub, max_batch, now):
        self.replica_id = replica_id
        self.addr = addr
        self.channel = channel
        self.stub = stub
        self.max_batch = max_batch
        self.registered_at = now
        self.last_heartbeat = now
        self.loaded_export = ""
        self.loaded_stamp = ""
        self.available_export = ""
        self.available_stamp = ""
        self.draining = False
        self.drain_reason = ""
        self.target_export = ""
        self.qps = 0.0
        self.queue_depth = 0
        self.shed_total = 0
        self.served = 0
        self.canary = False


class ReplicaRegistry:
    """Authoritative replica table behind the Router control surface.

    ``on_join(replica_id)`` / ``on_leave(replica_id)`` callbacks keep
    the data plane's hash ring in sync; draining replicas STAY on the
    ring (their keys only move when they actually leave) but stop
    being routable, so affinity is preserved for everyone else while
    the victim finishes its in-flight work.
    """

    def __init__(self, on_join=None, on_leave=None, heartbeat_secs=None,
                 timeout_secs=None):
        self._on_join = on_join or (lambda rid: None)
        self._on_leave = on_leave or (lambda rid: None)
        self._heartbeat = (
            heartbeat_secs
            if heartbeat_secs is not None
            else env_float(HEARTBEAT_ENV, 2.0)
        )
        self._timeout = (
            timeout_secs
            if timeout_secs is not None
            else env_float(REPLICA_TIMEOUT_ENV, 10.0)
        )
        self._lock = threading.Lock()
        self._replicas = {}  # replica_id -> _Replica
        self._default_target = ""  # export new joiners should load
        self._m_replicas = obs_metrics.gauge(
            "edl_router_replicas",
            "Registered serve replicas by state", ("state",),
        )
        for state in ("routable", "draining"):
            self._m_replicas.labels(state=state)  # stable series set

    @property
    def heartbeat_secs(self):
        return self._heartbeat

    # -- control surface (Router RPCs call these) ----------------------
    def register(self, request, now=None):
        """A replica announced itself; returns its register response
        fields. Re-registration under a live id replaces the old entry
        (a relaunched pod that kept its id — the stale channel is
        closed, the ring position is unchanged)."""
        now = time.time() if now is None else now
        rid = request.replica_id
        channel = build_channel(request.addr)
        stub = services.ServeStub(channel)
        entry = _Replica(
            rid, request.addr, channel, stub, int(request.max_batch), now
        )
        entry.loaded_stamp = request.model_stamp
        self._fold_telemetry(entry, request.telemetry)
        with self._lock:
            old = self._replicas.pop(rid, None)
            entry.target_export = self._default_target
            self._replicas[rid] = entry
            rejoin = old is not None
        if old is not None:
            _close_quietly(old.channel)
        if not rejoin:
            self._on_join(rid)
        self._publish_gauges()
        logger.info(
            "replica %s registered at %s (max_batch=%d%s)",
            rid, request.addr, entry.max_batch,
            ", rejoin" if rejoin else "",
        )
        events.emit(
            "replica_registered", replica=rid, addr=request.addr,
            stamp=request.model_stamp, rejoin=rejoin,
        )
        return entry.target_export

    def heartbeat(self, request, now=None):
        """Fold a heartbeat in; returns ``(known, drain, target)``.
        Unknown ids get ``known=False`` and re-register (the router
        restarted, or the replica was expired while partitioned)."""
        now = time.time() if now is None else now
        rid = request.replica_id
        with self._lock:
            entry = self._replicas.get(rid)
            if entry is None:
                return False, False, ""
            entry.last_heartbeat = now
            entry.loaded_export = request.loaded_export
            entry.loaded_stamp = request.loaded_stamp
            entry.available_export = request.available_export
            entry.available_stamp = request.available_stamp
            self._fold_telemetry(entry, request.telemetry)
            return True, entry.draining, entry.target_export

    def deregister(self, request):
        """The exactly-once drain ack (same contract as the training
        master's ``deregister_worker``): remove the replica everywhere
        with no ``replica_lost`` alert. Idempotent — a second ack (or
        an ack after heartbeat expiry) is a no-op."""
        rid = request.replica_id
        with self._lock:
            entry = self._replicas.pop(rid, None)
        if entry is None:
            return False
        _close_quietly(entry.channel)
        self._on_leave(rid)
        self._publish_gauges()
        initiator = "router" if entry.draining else "replica"
        logger.info(
            "replica %s drained cleanly (%s; served=%d shed=%d)",
            rid, request.reason or "unspecified",
            request.served, request.shed,
        )
        events.emit(
            "drain_ack", replica=rid, reason=request.reason,
            initiator=initiator, served=request.served,
            shed=request.shed,
        )
        return True

    # -- lifecycle ------------------------------------------------------
    def begin_drain(self, replica_id, reason="scale_down"):
        """Stop routing to ``replica_id``; the next heartbeat carries
        the drain directive down. Idempotent."""
        with self._lock:
            entry = self._replicas.get(replica_id)
            if entry is None or entry.draining:
                return False
            entry.draining = True
            entry.drain_reason = reason
        self._publish_gauges()
        logger.info("draining replica %s (%s)", replica_id, reason)
        events.emit("replica_draining", replica=replica_id, reason=reason)
        return True

    def expire(self, now=None):
        """Drop replicas silent past the heartbeat timeout; returns the
        expired ids. The ring loses them (their keys fail over to ring
        successors) and a relaunch re-registers from scratch."""
        now = time.time() if now is None else now
        with self._lock:
            dead = [
                rid for rid, e in self._replicas.items()
                if now - e.last_heartbeat > self._timeout
            ]
            entries = {rid: self._replicas.pop(rid) for rid in dead}
        for rid, entry in entries.items():
            _close_quietly(entry.channel)
            self._on_leave(rid)
            silent = round(now - entry.last_heartbeat, 2)
            logger.warning(
                "replica %s lost: no heartbeat for %.1fs", rid, silent
            )
            events.emit("replica_lost", replica=rid, silent_secs=silent)
        if dead:
            self._publish_gauges()
        return dead

    def forget_replica(self, replica_id):
        """Administrative removal (tests / operator): close and drop
        without journaling a loss."""
        with self._lock:
            entry = self._replicas.pop(replica_id, None)
        if entry is None:
            return False
        _close_quietly(entry.channel)
        self._on_leave(replica_id)
        self._publish_gauges()
        return True

    # -- canary / version steering -------------------------------------
    def set_target(self, replica_ids, export, canary=None):
        """Direct ``replica_ids`` to load ``export`` (delivered on
        their next heartbeat). ``canary`` marks/unmarks membership in
        the canary subset for the data plane's traffic slicing."""
        with self._lock:
            for rid in replica_ids:
                entry = self._replicas.get(rid)
                if entry is None:
                    continue
                entry.target_export = export
                if canary is not None:
                    entry.canary = canary

    def set_default_target(self, export):
        """Export new joiners are told to load at register time."""
        with self._lock:
            self._default_target = export

    # -- views ----------------------------------------------------------
    def get(self, replica_id):
        with self._lock:
            return self._replicas.get(replica_id)

    def stub(self, replica_id):
        with self._lock:
            entry = self._replicas.get(replica_id)
            return entry.stub if entry is not None else None

    def is_routable(self, replica_id):
        with self._lock:
            entry = self._replicas.get(replica_id)
            return entry is not None and not entry.draining

    def live_ids(self):
        with self._lock:
            return list(self._replicas)

    def routable_ids(self):
        with self._lock:
            return [
                rid for rid, e in self._replicas.items() if not e.draining
            ]

    def canary_ids(self):
        with self._lock:
            return [rid for rid, e in self._replicas.items() if e.canary]

    def telemetry_totals(self):
        """Fleet-wide signals for the autoscaler, routable only (a
        draining victim's backlog must not buy capacity twice — its
        replacement already did)."""
        with self._lock:
            routable = [
                e for e in self._replicas.values() if not e.draining
            ]
            return {
                "replicas": len(routable),
                "qps": sum(e.qps for e in routable),
                "queue_depth": sum(e.queue_depth for e in routable),
                "shed_total": sum(e.shed_total for e in routable),
            }

    def min_max_batch(self):
        """The fleet's answer to model_info.max_batch: the TIGHTEST
        replica cap, so a client sizing batches against the router
        never overruns any replica."""
        with self._lock:
            caps = [
                e.max_batch for e in self._replicas.values()
                if e.max_batch > 0 and not e.draining
            ]
        return min(caps) if caps else 0

    def state(self):
        """JSON-ready /statusz section."""
        now = time.time()
        with self._lock:
            return {
                rid: {
                    "addr": e.addr,
                    "heartbeat_age": round(now - e.last_heartbeat, 2),
                    "loaded_export": e.loaded_export,
                    "loaded_stamp": e.loaded_stamp,
                    "available_export": e.available_export,
                    "target_export": e.target_export,
                    "draining": e.draining,
                    "canary": e.canary,
                    "qps": round(e.qps, 2),
                    "queue_depth": e.queue_depth,
                    "shed_total": e.shed_total,
                }
                for rid, e in self._replicas.items()
            }

    # -- internals ------------------------------------------------------
    @staticmethod
    def _fold_telemetry(entry, blob):
        entry.qps = float(blob.serve_qps)
        entry.queue_depth = int(blob.serve_queue_depth)
        entry.shed_total = int(blob.serve_shed_total)

    def _publish_gauges(self):
        with self._lock:
            routable = sum(
                1 for e in self._replicas.values() if not e.draining
            )
            draining = len(self._replicas) - routable
        self._m_replicas.labels(state="routable").set(routable)
        self._m_replicas.labels(state="draining").set(draining)


def _close_quietly(channel):
    try:
        channel.close()
    except Exception:
        # a torn channel to a dead replica: the close is best-effort
        logger.debug("replica channel close failed", exc_info=True)


class ReplicaAutoscaler:
    """Telemetry-driven replica count.

    Grow when the routable tier is saturated — queue depth per replica
    over ``EDL_SERVE_QUEUE_PER_REPLICA``, shed rate above zero, or QPS
    per replica over the ``EDL_SERVE_QPS_PER_REPLICA`` nominal capacity
    — sustained through the ``DecisionGate`` hold and cooldown. Shrink
    when the fleet would still run under half capacity with one fewer
    replica and nothing queued/shedding; victims are the coldest
    (lowest-QPS) replicas, drained through the registry so the router
    stops routing before the pod dies. A tier below
    ``EDL_SERVE_MIN_REPLICAS`` (a SIGKILLed replica) is replaced
    immediately — no hold, the floor is a contract — subject only to
    the cooldown so a flapping scaler can't spawn-storm.
    """

    def __init__(self, registry, scaler, min_replicas=None,
                 max_replicas=None, step=None, hold_secs=None,
                 cooldown_secs=None, queue_per_replica=None,
                 qps_per_replica=None):
        self._registry = registry
        self._scaler = scaler
        self._min = int(
            min_replicas
            if min_replicas is not None
            else env_int(MIN_REPLICAS_ENV, 1)
        )
        self._max = int(
            max_replicas
            if max_replicas is not None
            else env_int(MAX_REPLICAS_ENV, 8)
        )
        self._step = max(1, int(
            step if step is not None else env_int(SCALE_STEP_ENV, 1)
        ))
        hold = (
            hold_secs
            if hold_secs is not None
            else env_float(SCALE_HOLD_ENV, 3.0)
        )
        cooldown = (
            cooldown_secs
            if cooldown_secs is not None
            else env_float(SCALE_COOLDOWN_ENV, 10.0)
        )
        self._queue_mark = max(0.1, (
            queue_per_replica
            if queue_per_replica is not None
            else env_float(QUEUE_PER_REPLICA_ENV, 16.0)
        ))
        self._qps_mark = max(0.1, (
            qps_per_replica
            if qps_per_replica is not None
            else env_float(QPS_PER_REPLICA_ENV, 100.0)
        ))
        self._gate = DecisionGate(hold, cooldown)
        self._last_shed = None  # (ts, shed_total) for the rate
        self._last_decision = {}
        self._m_decisions = obs_metrics.counter(
            "edl_serve_scale_decisions_total",
            "Serving-fleet resize decisions", ("direction",),
        )
        for direction in ("grow", "shrink"):
            self._m_decisions.labels(direction=direction)

    def state(self):
        return {
            "min_replicas": self._min,
            "max_replicas": self._max,
            "step": self._step,
            "last_decision": dict(self._last_decision),
        }

    def tick(self, now=None):
        """One decision pass on the router's 1 Hz tick. Never raises."""
        try:
            self._tick(time.time() if now is None else now)
        except Exception:
            logger.exception("replica autoscaler tick failed")

    def _tick(self, now):
        tel = self._registry.telemetry_totals()
        routable = tel["replicas"]
        total = len(self._registry.live_ids())  # incl. draining victims
        queue = tel["queue_depth"]
        qps = tel["qps"]
        shed_rate = self._shed_rate(now, tel["shed_total"])

        # -- floor enforcement: a lost replica is replaced NOW (modulo
        # cooldown); the hold exists to damp signals, and "the tier is
        # under its floor" is a fact, not a signal
        if routable < self._min and total < self._max:
            if not self._gate.in_cooldown(now):
                self._grow(
                    now, min(self._min - routable, self._max - total),
                    routable, queue, qps,
                    reasons=["below_floor: %d routable < min_replicas %d"
                             % (routable, self._min)],
                )
            return

        # -- grow: sustained saturation. The ceiling binds on TOTAL
        # replicas (draining victims still hold pods/ports)
        per = max(1, routable)
        reasons = []
        if queue / per > self._queue_mark:
            reasons.append(
                "queue: %d queued / %d replicas > %.1f watermark"
                % (queue, routable, self._queue_mark)
            )
        if shed_rate > 0.5:
            reasons.append("shedding: %.1f req/s shed" % shed_rate)
        if qps / per > self._qps_mark:
            reasons.append(
                "qps: %.1f/replica > %.1f nominal capacity"
                % (qps / per, self._qps_mark)
            )
        want_grow = bool(reasons) and total < self._max
        if self._gate.observe("grow", want_grow, now):
            self._grow(
                now, min(self._step, self._max - total),
                routable, queue, qps, reasons=reasons,
            )
            return

        # -- shrink: the remaining tier would still run under half its
        # nominal capacity, nothing queued, nothing shedding
        want_shrink = (
            routable > self._min
            and queue == 0
            and shed_rate <= 0.0
            and qps / max(1, routable - self._step) < 0.5 * self._qps_mark
        )
        if self._gate.observe("shrink", want_shrink, now):
            self._shrink(now, routable, queue, qps)

    # ------------------------------------------------------------------
    def _shed_rate(self, now, shed_total):
        last = self._last_shed
        self._last_shed = (now, shed_total)
        if last is None or now <= last[0]:
            return 0.0
        return max(0.0, shed_total - last[1]) / (now - last[0])

    def _grow(self, now, delta, replicas, queue, qps, reasons):
        if delta <= 0:
            return
        started = self._scaler.scale_up(delta)
        added = len(started) if started is not None else delta
        if added <= 0:
            return  # scaler couldn't place any
        self._gate.fired("grow", now)
        self._last_decision = {
            "direction": "grow", "delta": added, "replicas": replicas,
            "queue_depth": queue, "at": now, "reasons": reasons,
        }
        self._m_decisions.labels(direction="grow").inc()
        logger.info(
            "serve autoscaler grow +%d (replicas %d, queue %d): %s",
            added, replicas, queue, "; ".join(reasons),
        )
        events.emit(
            "scale_decision", direction="grow", delta=added,
            workers=replicas, queue_depth=queue, qps=round(qps, 1),
            reasons=reasons, tag="serve",
        )

    def _shrink(self, now, replicas, queue, qps):
        victims = self._pick_victims(min(self._step, replicas - self._min))
        if not victims:
            return
        self._gate.fired("shrink", now)
        reasons = [
            "idle: %.1f qps over %d replicas fits %.0f%% of %d"
            % (qps, replicas, 50, replicas - len(victims)),
        ]
        self._last_decision = {
            "direction": "shrink", "delta": len(victims),
            "replicas": replicas, "victims": victims, "at": now,
            "reasons": reasons,
        }
        self._m_decisions.labels(direction="shrink").inc()
        logger.info(
            "serve autoscaler shrink -%d (victims %s): %s",
            len(victims), victims, "; ".join(reasons),
        )
        events.emit(
            "scale_decision", direction="shrink", delta=len(victims),
            workers=replicas, queue_depth=queue, qps=round(qps, 1),
            victims=victims, reasons=reasons, tag="serve",
        )
        for rid in victims:
            self._registry.begin_drain(rid, reason="scale_down")

    def _pick_victims(self, count):
        """Coldest first: the replica whose loss moves the fewest warm
        affinity keys is the one serving the least traffic. Canary
        members are spared — shrinking the canary mid-judgment would
        starve the verdict."""
        if count <= 0:
            return []
        candidates = []
        for rid in self._registry.routable_ids():
            entry = self._registry.get(rid)
            if entry is None or entry.canary:
                continue
            candidates.append((entry.qps, rid))
        candidates.sort()
        return [rid for _, rid in candidates[:count]]


class SubprocessReplicaScaler:
    """Replicas as local ``serve.main`` subprocesses (bench / CPU CI).

    Production uses the k8s serving manifest + pod manager; this scaler
    gives tests and benches the same grow surface with nothing but
    fork/exec. Each replica gets a free port and registers
    itself with the router; ``reap()`` forgets exited pids so the
    autoscaler's floor check sees real capacity.
    """

    def __init__(self, router_addr, export_root, extra_args=(), env=None,
                 log_dir=None):
        self._router_addr = router_addr
        self._export_root = export_root
        self._extra_args = list(extra_args)
        self._env = dict(env) if env is not None else dict(os.environ)
        self._log_dir = log_dir
        self._lock = threading.Lock()
        self._procs = {}  # pid -> (Popen, log file or None)
        self._seq = 0

    def scale_up(self, n):
        started = []
        for _ in range(max(0, int(n))):
            with self._lock:
                self._seq += 1
                seq = self._seq
            port = find_free_port()
            cmd = [
                sys.executable, "-m", "elasticdl_tpu_torch.serve.main",
                "--export_dir", self._export_root,
                "--port", str(port),
                "--router_addr", self._router_addr,
            ] + self._extra_args
            logf = None
            if self._log_dir is not None:
                logf = open(
                    os.path.join(self._log_dir, "replica-%d.log" % seq),
                    "ab",
                )
            proc = subprocess.Popen(
                cmd, env=self._env,
                stdout=logf if logf is not None else None,
                stderr=subprocess.STDOUT if logf is not None else None,
            )
            with self._lock:
                self._procs[proc.pid] = (proc, logf)
            started.append(proc.pid)
            logger.info(
                "spawned serve replica pid=%d port=%d", proc.pid, port
            )
        return started

    def reap(self):
        """Forget exited replicas; returns their pids."""
        gone = []
        with self._lock:
            for pid in list(self._procs):
                proc, logf = self._procs[pid]
                if proc.poll() is not None:
                    gone.append(pid)
                    del self._procs[pid]
                    if logf is not None:
                        logf.close()
        return gone

    def replica_pids(self):
        self.reap()
        with self._lock:
            return list(self._procs)

    def kill(self, pid, sig=signal.SIGKILL):
        """Fault injection for the bench: hard-kill one replica."""
        with self._lock:
            proc, _ = self._procs.get(pid, (None, None))
        if proc is not None:
            proc.send_signal(sig)

    def stop_all(self, grace_secs=10.0):
        with self._lock:
            items = list(self._procs.items())
        for _, (proc, _) in items:
            if proc.poll() is None:
                proc.terminate()
        deadline = time.time() + grace_secs
        for _, (proc, _) in items:
            try:
                proc.wait(timeout=max(0.1, deadline - time.time()))
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=5)
        self.reap()

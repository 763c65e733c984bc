"""Serving-fleet data plane: consistent-hash affinity routing (port of
elasticdl_tpu/serve/router.py).

The router is the tier's front door: it exposes the same
``elasticdl_tpu.Serve`` surface as a single serve pod (clients point
``--serving_addr`` at it unchanged) plus the replica-facing
``elasticdl_tpu.Router`` control surface, and forwards each predict to
one of N registered replicas:

- **affinity** -- requests hash onto a consistent-hash ring
  (``HashRing``: 64 virtual nodes per replica on a sha256 u64 circle)
  by ``PredictRequest.affinity_key``, so the same user/id range keeps
  landing on the same replica and its embedding cache stays hot. One
  join/leave moves ~1/N of the key space. Requests without a key (0)
  spread by an internal sequence.
- **failover** -- on UNAVAILABLE (replica died, or is mid-drain refusing
  admissions) the router retries the ring's next distinct replica, at
  most ``EDL_ROUTER_FAILOVER_RETRIES`` extra attempts, never the same
  replica twice and never one the registry marked draining. Any other
  status propagates to the caller untouched.
- **in-flight caps** -- at most ``EDL_ROUTER_INFLIGHT_CAP`` outstanding
  forwards per replica; past the cap the request is shed
  (RESOURCE_EXHAUSTED) instead of queueing on the slow replica.
- **canary slicing** -- when ``serve/canary.py`` runs a rollout, the
  ``EDL_CANARY_FRACTION`` slice of the key space routes only to canary
  members (and the rest only to incumbents); responses feed the judge's
  per-stamp books with ``_mean_prediction``.

Series: ``edl_router_requests_total{replica,outcome}``,
``edl_router_failovers_total``; each predict is a ``router_predict``
root span.
"""

import bisect
import threading

import grpc
import numpy as np

from elasticdl_tpu_torch.common.env_utils import env_int
from elasticdl_tpu_torch.common.hash_utils import stable_u64
from elasticdl_tpu_torch.common.log_utils import (
    default_logger as _logger_factory,
)
from elasticdl_tpu_torch.common import overload
from elasticdl_tpu_torch.common.tensor_utils import (
    blob_to_f32,
    blob_to_ndarray,
)
from elasticdl_tpu_torch.observability import metrics as obs_metrics
from elasticdl_tpu_torch.observability import trace
from elasticdl_tpu_torch.proto import elasticdl_tpu_pb2 as pb
from elasticdl_tpu_torch.serve.canary import CanaryController
from elasticdl_tpu_torch.serve.fleet import ReplicaRegistry

logger = _logger_factory("elasticdl_tpu_torch.serve.router")

INFLIGHT_CAP_ENV = "EDL_ROUTER_INFLIGHT_CAP"
FAILOVER_RETRIES_ENV = "EDL_ROUTER_FAILOVER_RETRIES"

# virtual nodes per replica: enough that one join/leave rebalances
# smoothly (the stddev of the moved-key fraction shrinks ~1/sqrt(v)),
# small enough that ring rebuilds stay trivial at fleet sizes
_VNODES = 64

# forward timeout when the caller sent no deadline at all (transport
# without a timeout): the router must not hold a thread forever
_DEFAULT_FORWARD_SECS = 10.0


class HashRing:
    """Consistent-hash ring over replica ids, sha256-placed vnodes.

    Placement is process-stable (``stable_u64``), so a router restart
    rebuilds the exact same ring from the re-registered replicas and
    affinity survives the restart.
    """

    def __init__(self, vnodes=_VNODES):
        self._vnodes = max(1, int(vnodes))
        self._lock = threading.Lock()
        self._points = {}  # replica_id -> [u64 ring positions]
        self._ring = []  # sorted [(position, replica_id)]

    def add(self, replica_id):
        points = [
            stable_u64("%s#%d" % (replica_id, i))
            for i in range(self._vnodes)
        ]
        with self._lock:
            if replica_id in self._points:
                return
            self._points[replica_id] = points
            self._ring = sorted(
                self._ring + [(p, replica_id) for p in points]
            )

    def remove(self, replica_id):
        with self._lock:
            if self._points.pop(replica_id, None) is None:
                return
            self._ring = [
                (p, rid) for p, rid in self._ring if rid != replica_id
            ]

    def members(self):
        with self._lock:
            return list(self._points)

    def lookup(self, key_hash):
        """The key's primary replica, or None on an empty ring."""
        for rid in self.successors(key_hash):
            return rid
        return None

    def successors(self, key_hash):
        """Distinct replica ids in ring order from the key's position —
        element 0 is the primary, the rest is the failover order. The
        iteration walks a snapshot, so concurrent joins/leaves can't
        tear it mid-request."""
        with self._lock:
            ring = list(self._ring)
        if not ring:
            return
        idx = bisect.bisect_right(ring, (key_hash, chr(0x10FFFF)))
        seen = set()
        for i in range(len(ring)):
            rid = ring[(idx + i) % len(ring)][1]
            if rid not in seen:
                seen.add(rid)
                yield rid


class RouterServicer:
    """Both gRPC surfaces of the router role.

    Client-facing ``Serve`` (predict/model_info — drop-in for a single
    serve pod) and replica-facing ``Router`` (register/heartbeat/
    deregister). The registry/ring/canary trio is owned here so the
    three stay consistent: a replica that leaves (ack, loss, or
    administrative ``forget_replica``) is removed from the ring AND its
    in-flight book in one place.
    """

    def __init__(self, heartbeat_secs=None, replica_timeout_secs=None,
                 inflight_cap=None, failover_retries=None,
                 canary=None, ring=None):
        self._cap = max(1, int(
            inflight_cap
            if inflight_cap is not None
            else env_int(INFLIGHT_CAP_ENV, 64)
        ))
        self._retries = max(0, int(
            failover_retries
            if failover_retries is not None
            else env_int(FAILOVER_RETRIES_ENV, 2)
        ))
        self._ring = ring if ring is not None else HashRing()
        self._registry = ReplicaRegistry(
            on_join=self._ring.add,
            on_leave=self._on_replica_leave,
            heartbeat_secs=heartbeat_secs,
            timeout_secs=replica_timeout_secs,
        )
        self._canary = (
            canary if canary is not None
            else CanaryController(self._registry)
        )
        self._inflight_lock = threading.Lock()
        self._inflight = {}  # replica_id -> outstanding forwards
        self._seq_lock = threading.Lock()
        self._seq = 0
        self._m_requests = obs_metrics.counter(
            "edl_router_requests_total",
            "Routed predict RPCs by replica and outcome",
            ("replica", "outcome"),
        )
        self._m_failovers = obs_metrics.counter(
            "edl_router_failovers_total",
            "Predict forwards retried on a ring successor",
        )

    @property
    def registry(self):
        return self._registry

    @property
    def canary(self):
        return self._canary

    @property
    def ring(self):
        return self._ring

    def tick(self, now=None):
        """Control-plane pass for the role's 1 Hz loop: expire silent
        replicas, advance the canary state machine."""
        self._registry.expire(now)
        self._canary.tick(now)

    def state(self):
        """JSON-ready /statusz section."""
        with self._inflight_lock:
            inflight = dict(self._inflight)
        return {
            "replicas": self._registry.state(),
            "ring": sorted(self._ring.members()),
            "inflight": inflight,
            "canary": self._canary.state(),
        }

    # -- replica control surface (elasticdl_tpu.Router) ----------------
    def register_replica(self, request, context):
        target = self._registry.register(request)
        return pb.RegisterReplicaResponse(
            accepted=True,
            heartbeat_secs=self._registry.heartbeat_secs,
            target_export=target,
        )

    def heartbeat_replica(self, request, context):
        known, drain, target = self._registry.heartbeat(request)
        return pb.ReplicaHeartbeatResponse(
            known=known, drain=drain, target_export=target
        )

    def deregister_replica(self, request, context):
        self._registry.deregister(request)
        return pb.Empty()

    # -- client surface (elasticdl_tpu.Serve) --------------------------
    def predict(self, request, context):
        with trace.root_span("router_predict", role="router"):
            return self._predict(request, context)

    def _predict(self, request, context):
        key_hash = self._key_hash(request.affinity_key)
        arm = self._canary.assign_arm(key_hash)
        allowed = self._arm_members(arm)
        deadline = context.time_remaining()
        if deadline is None or deadline <= 0:
            deadline = _DEFAULT_FORWARD_SECS
        attempts = 0
        tried = set()
        last = None  # (code, detail) of the last forward failure
        for rid in self._ring.successors(key_hash):
            if attempts > self._retries:
                break
            if rid in tried:
                continue  # successors() already dedups; belt+braces
            if not self._registry.is_routable(rid):
                continue  # draining or already gone — never a target
            if allowed is not None and rid not in allowed:
                continue  # the other arm's replica
            stub = self._registry.stub(rid)
            if stub is None:
                continue
            if not self._acquire(rid):
                # the slow-replica guard: shed HERE rather than queue a
                # request behind a replica already at its cap
                self._count(rid, "shed")
                self._canary.note_result(
                    self._arm_stamp(arm), None, "shed"
                )
                self._abort(
                    context, grpc.StatusCode.RESOURCE_EXHAUSTED,
                    "replica %s at in-flight cap %d" % (rid, self._cap),
                )
            tried.add(rid)
            attempts += 1
            if attempts > 1:
                self._m_failovers.inc()
            try:
                response = stub.predict(request, timeout=deadline)
            except grpc.RpcError as e:
                code = e.code()
                detail = e.details() or code.name
                last = (code, detail)
                if code == grpc.StatusCode.UNAVAILABLE:
                    # dead or draining-refusing replica: fail over to
                    # the ring's next distinct replica (bounded, and
                    # `tried` guarantees never the same one twice)
                    self._count(rid, "unavailable")
                    self._canary.note_result(
                        self._arm_stamp(arm), None, "unavailable"
                    )
                    continue
                outcome = (
                    "shed"
                    if code == grpc.StatusCode.RESOURCE_EXHAUSTED
                    else "error"
                )
                self._count(rid, outcome)
                self._canary.note_result(
                    self._arm_stamp(arm), None, outcome
                )
                self._abort(context, code, detail)
            finally:
                self._release(rid)
            self._count(rid, "ok")
            self._canary.note_result(
                response.model_stamp, _mean_prediction(response), "ok"
            )
            return response
        if last is not None:
            self._abort(
                context, grpc.StatusCode.UNAVAILABLE,
                "all %d routable replicas failed; last: %s"
                % (attempts, last[1]),
            )
        self._count("none", "no_replica")
        self._abort(
            context, grpc.StatusCode.UNAVAILABLE,
            "no routable replica registered",
        )

    def model_info(self, request, context):
        """The fleet's identity: a routable replica's answer with
        ``max_batch`` tightened to the fleet minimum (a client sizing
        batches against the router must fit EVERY replica a failover
        could land on)."""
        fleet_cap = self._registry.min_max_batch()
        for rid in self._registry.routable_ids():
            stub = self._registry.stub(rid)
            if stub is None:
                continue
            try:
                info = stub.model_info(
                    pb.Empty(), timeout=overload.rpc_timeout(5.0)
                )
            except grpc.RpcError:
                continue
            if fleet_cap > 0:
                info.max_batch = min(info.max_batch, fleet_cap) \
                    if info.max_batch > 0 else fleet_cap
            return info
        return pb.ModelInfoResponse(loaded=False)

    # -- internals ------------------------------------------------------
    def _key_hash(self, affinity_key):
        if affinity_key:
            return stable_u64("k:%d" % affinity_key)
        # unkeyed requests spread round-robin-ish over the ring instead
        # of all hashing onto one point
        with self._seq_lock:
            self._seq += 1
            seq = self._seq
        return stable_u64("seq:%d" % seq)

    def _arm_members(self, arm):
        """The replica subset this arm may route to, or None for "any
        routable". Falls back to None when the arm's subset is empty —
        availability beats slicing purity."""
        if not self._canary.active():
            return None
        members = set(self._canary.canary_members())
        if arm == "canary":
            allowed = members
        else:
            allowed = {
                rid for rid in self._registry.routable_ids()
                if rid not in members
            }
        return allowed or None

    def _arm_stamp(self, arm):
        """Best-effort stamp for booking a FAILED forward (no response
        to read it from): the arm the request was sliced to."""
        state = self._canary.state()
        side = "canary" if arm == "canary" else "incumbent"
        return state[side]["stamp"]

    def _on_replica_leave(self, replica_id):
        self._ring.remove(replica_id)
        with self._inflight_lock:
            self._inflight.pop(replica_id, None)

    def _acquire(self, replica_id):
        with self._inflight_lock:
            n = self._inflight.get(replica_id, 0)
            if n >= self._cap:
                return False
            self._inflight[replica_id] = n + 1
            return True

    def _release(self, replica_id):
        with self._inflight_lock:
            n = self._inflight.get(replica_id, 0)
            if n <= 1:
                self._inflight.pop(replica_id, None)
            else:
                self._inflight[replica_id] = n - 1

    def _count(self, replica_id, outcome):
        self._m_requests.labels(replica=replica_id, outcome=outcome).inc()

    def _abort(self, context, code, detail):
        # same contract as ServeServicer._abort: stamp the status onto
        # the open router_predict span, then abort (which raises)
        trace.annotate(code=code.name)
        context.abort(code, detail)


def _mean_prediction(response):
    """Scalar summary of a response for the canary's distribution book:
    the mean of the first output tensor (a bfloat16 one decoded to
    float32, exactly). None when unreadable (the judge just skips the
    sample)."""
    for blob in response.outputs.values():
        try:
            if blob.dtype == "bfloat16":
                return float(np.mean(blob_to_f32(blob)))
            return float(np.mean(blob_to_ndarray(blob)))
        except Exception:
            logger.debug("unreadable prediction blob", exc_info=True)
            return None
    return None

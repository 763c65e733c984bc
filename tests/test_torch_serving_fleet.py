"""The port's serving fleet against the reference's, on the CPU.

Mirrors tests/test_serving_fleet.py: the consistent-hash ring, the
replica registry, the router's failover / affinity / in-flight caps,
the ``DecisionGate``, the replica autoscaler, the canary judge and
versioned-export discovery. Every scenario runs against the port (the
``pkg`` fixture); the reference runs them in its own test file.

Parity on top, on the same inputs made from a numpy seed:
- ``stable_u64`` bit for bit, and ``HashRing`` placing 10,000 keys on
  the same replica for the same member sets (joins and leaves
  included);
- a seeded sequence of register, heartbeat, expire, drain, deregister,
  export-publish, prediction-feed and tick operations on a registry,
  an autoscaler and a canary controller of each package, under one
  injected clock: the same return values, directives, decisions, states
  and journal lines after every operation;
- ``PredictionStats`` and ``total_variation`` equal on the same samples,
  and the router's ``_mean_prediction`` of one answer;
- ``scan_export_versions`` in the same order over bundles written by
  each side's own export writer, a half-written bundle skipped on both;
- the Router surface across packages over real gRPC.
"""

import importlib
import json
import os
import threading
import time

import grpc
import numpy as np
import pytest

from tests.test_utils import load_journal

PACKAGES = {"ref": "elasticdl_tpu", "port": "elasticdl_tpu_torch"}


class Pkg:
    """One package's fleet modules by their relative name."""

    def __init__(self, side):
        self.side = side
        self.root = PACKAGES[side]

    def mod(self, name):
        return importlib.import_module("%s.%s" % (self.root, name))

    @property
    def pb(self):
        return self.mod("proto.elasticdl_tpu_pb2")

    @property
    def events(self):
        return self.mod("observability.events")

    @property
    def fleet(self):
        return self.mod("serve.fleet")

    @property
    def canary(self):
        return self.mod("serve.canary")

    @property
    def router(self):
        return self.mod("serve.router")

    @property
    def stable_u64(self):
        return self.mod("common.hash_utils").stable_u64

    @property
    def DecisionGate(self):
        return self.mod("master.autoscaler").DecisionGate


@pytest.fixture
def pkg():
    side = Pkg("port")
    yield side
    side.events._reset_for_tests()


# ---------------------------------------------------------------------------
# helpers


def _register(pkg, target, rid, max_batch=32, stamp="", qps=0.0):
    """Register ``rid`` on a RouterServicer or ReplicaRegistry. The
    addr never connects (gRPC channels are lazy), so no server needed."""
    request = pkg.pb.RegisterReplicaRequest(
        replica_id=rid,
        addr="127.0.0.1:1",
        max_batch=max_batch,
        model_stamp=stamp,
        telemetry=pkg.pb.TelemetryBlob(role="serve", serve_qps=qps),
    )
    if isinstance(target, pkg.router.RouterServicer):
        return target.register_replica(request, None)
    return target.register(request)


def _heartbeat(pkg, registry, rid, qps=0.0, queue=0, shed=0,
               loaded=("", ""), available=("", ""), now=None):
    request = pkg.pb.ReplicaHeartbeatRequest(
        replica_id=rid,
        loaded_export=loaded[0],
        loaded_stamp=loaded[1],
        available_export=available[0],
        available_stamp=available[1],
        telemetry=pkg.pb.TelemetryBlob(
            role="serve", serve_qps=qps,
            serve_queue_depth=queue, serve_shed_total=shed,
        ),
    )
    return registry.heartbeat(request, now=now)


class _Abort(Exception):
    def __init__(self, code, detail):
        super().__init__(detail)
        self.code = code
        self.detail = detail


class _Ctx:
    """Just enough grpc.ServicerContext for the router's predict."""

    def __init__(self, remaining=5.0):
        self._remaining = remaining

    def time_remaining(self):
        return self._remaining

    def abort(self, code, detail):
        raise _Abort(code, detail)


class _RpcFailure(grpc.RpcError):
    def __init__(self, code, detail="injected"):
        self._code = code
        self._detail = detail

    def code(self):
        return self._code

    def details(self):
        return self._detail


class _FakeStub:
    """Replica stand-in wired into registry entries after register."""

    def __init__(self, pb, stamp="100:1:1", fail=None, max_batch=64):
        self.pb = pb
        self.stamp = stamp
        self.fail = fail
        self.max_batch = max_batch
        self.predicts = 0

    def predict(self, request, timeout=None):
        self.predicts += 1
        if self.fail is not None:
            raise self.fail
        return self.pb.PredictResponse(model_step=1, model_stamp=self.stamp)

    def model_info(self, request, timeout=None):
        if self.fail is not None:
            raise self.fail
        return self.pb.ModelInfoResponse(
            loaded=True, step=1, stamp=self.stamp,
            model_zoo="zoo", max_batch=self.max_batch,
        )


def _plant_stub(servicer, rid, stub):
    entry = servicer.registry.get(rid)
    assert entry is not None
    entry.stub = stub
    return stub


def _servicer(pkg, **kwargs):
    kwargs.setdefault("heartbeat_secs", 1.0)
    kwargs.setdefault("replica_timeout_secs", 30.0)
    return pkg.router.RouterServicer(**kwargs)


@pytest.fixture
def journal(pkg, tmp_path, monkeypatch):
    events_dir = tmp_path / "events"
    events_dir.mkdir()
    monkeypatch.setenv(pkg.events.EVENTS_DIR_ENV, str(events_dir))
    pkg.events.configure("router-0")
    yield events_dir
    pkg.events.flush()


def _journaled(pkg, events_dir, event):
    pkg.events.flush()
    return [e for e in load_journal(events_dir) if e["event"] == event]


# ---------------------------------------------------------------------------
# consistent-hash ring


def _key_owners(pkg, ring, keys):
    return {k: ring.lookup(pkg.stable_u64("key:%d" % k)) for k in keys}


@pytest.mark.parametrize("fleet", [3, 4, 8])
def test_ring_single_leave_moves_only_the_victims_keys(pkg, fleet):
    """Removing one replica moves exactly the victim's keys (~1/N of
    the space) and no one else's."""
    ring = pkg.router.HashRing()
    for i in range(fleet):
        ring.add("r%d" % i)
    keys = range(4000)
    before = _key_owners(pkg, ring, keys)
    victim = "r1"
    ring.remove(victim)
    after = _key_owners(pkg, ring, keys)
    moved = [k for k in keys if before[k] != after[k]]
    assert all(before[k] == victim for k in moved)
    assert all(after[k] is not None for k in moved)
    assert len(moved) == sum(1 for k in keys if before[k] == victim)
    assert len(moved) <= 2.0 * len(list(keys)) / fleet


@pytest.mark.parametrize("fleet", [3, 7])
def test_ring_single_join_steals_only_for_the_newcomer(pkg, fleet):
    ring = pkg.router.HashRing()
    for i in range(fleet):
        ring.add("r%d" % i)
    keys = range(4000)
    before = _key_owners(pkg, ring, keys)
    ring.add("newcomer")
    after = _key_owners(pkg, ring, keys)
    moved = [k for k in keys if before[k] != after[k]]
    assert all(after[k] == "newcomer" for k in moved)
    assert len(moved) <= 2.0 * len(list(keys)) / (fleet + 1)


def test_ring_successors_distinct_and_complete(pkg):
    ring = pkg.router.HashRing()
    members = {"a", "b", "c", "d"}
    for rid in members:
        ring.add(rid)
    for key in range(50):
        order = list(ring.successors(pkg.stable_u64("key:%d" % key)))
        assert len(order) == len(members)
        assert set(order) == members
        assert order[0] == ring.lookup(pkg.stable_u64("key:%d" % key))


def test_ring_placement_is_process_stable(pkg):
    a, b = pkg.router.HashRing(), pkg.router.HashRing()
    for rid in ("r0", "r1", "r2"):
        a.add(rid)
    for rid in ("r2", "r0", "r1"):  # registration order is irrelevant
        b.add(rid)
    for key in range(500):
        h = pkg.stable_u64("key:%d" % key)
        assert a.lookup(h) == b.lookup(h)


def test_ring_empty_and_idempotent_ops(pkg):
    ring = pkg.router.HashRing()
    assert ring.lookup(123) is None
    ring.add("only")
    ring.add("only")  # re-add is a no-op, not a double placement
    assert len(ring.members()) == 1
    ring.remove("ghost")  # unknown remove is a no-op
    assert ring.lookup(123) == "only"
    ring.remove("only")
    assert ring.lookup(123) is None


# ---------------------------------------------------------------------------
# replica registry


def test_registry_lifecycle_and_exactly_once_drain_ack(pkg, journal):
    joined, left = [], []
    registry = pkg.fleet.ReplicaRegistry(
        on_join=joined.append, on_leave=left.append,
        heartbeat_secs=1.0, timeout_secs=30.0,
    )
    _register(pkg, registry, "serve-a", stamp="100:1:1")
    assert joined == ["serve-a"]
    known, drain, _ = _heartbeat(pkg, registry, "serve-a", qps=5.0)
    assert known and not drain
    known, _, _ = _heartbeat(pkg, registry, "stranger")
    assert not known

    ack = pkg.pb.DeregisterReplicaRequest(
        replica_id="serve-a", reason="shutdown", served=42, shed=1,
    )
    assert registry.deregister(ack) is True
    assert registry.deregister(ack) is False  # exactly-once
    assert left == ["serve-a"]
    acks = _journaled(pkg, journal, "drain_ack")
    assert len(acks) == 1
    assert acks[0]["replica"] == "serve-a"
    assert acks[0]["served"] == 42
    assert _journaled(pkg, journal, "replica_registered")
    assert not _journaled(pkg, journal, "replica_lost")


def test_registry_expire_journals_replica_lost(pkg, journal):
    left = []
    registry = pkg.fleet.ReplicaRegistry(
        on_leave=left.append, heartbeat_secs=1.0, timeout_secs=5.0,
    )
    now = 1000.0
    registry.register(
        pkg.pb.RegisterReplicaRequest(replica_id="serve-a",
                                      addr="127.0.0.1:1"),
        now=now,
    )
    assert registry.expire(now=now + 4.9) == []
    assert registry.expire(now=now + 5.1) == ["serve-a"]
    assert left == ["serve-a"]
    assert registry.live_ids() == []
    lost = _journaled(pkg, journal, "replica_lost")
    assert len(lost) == 1 and lost[0]["replica"] == "serve-a"


def test_registry_draining_stays_on_ring_but_unroutable(pkg, journal):
    ring = pkg.router.HashRing()
    registry = pkg.fleet.ReplicaRegistry(
        on_join=ring.add, on_leave=ring.remove,
        heartbeat_secs=1.0, timeout_secs=30.0,
    )
    for rid in ("serve-a", "serve-b"):
        _register(pkg, registry, rid)
    assert registry.begin_drain("serve-a", reason="scale_down") is True
    assert registry.begin_drain("serve-a") is False  # idempotent
    assert not registry.is_routable("serve-a")
    assert registry.routable_ids() == ["serve-b"]
    # still on the ring: its keys move only when it leaves
    assert set(ring.members()) == {"serve-a", "serve-b"}
    _, drain, _ = _heartbeat(pkg, registry, "serve-a")
    assert drain
    draining = _journaled(pkg, journal, "replica_draining")
    assert len(draining) == 1 and draining[0]["reason"] == "scale_down"


def test_registry_rejoin_replaces_without_ring_churn(pkg):
    ring = pkg.router.HashRing()
    joins = []

    def on_join(rid):
        joins.append(rid)
        ring.add(rid)

    registry = pkg.fleet.ReplicaRegistry(
        on_join=on_join, on_leave=ring.remove,
        heartbeat_secs=1.0, timeout_secs=30.0,
    )
    _register(pkg, registry, "serve-a", stamp="100:1:1")
    _register(pkg, registry, "serve-a", stamp="200:1:1")  # relaunched pod
    assert joins == ["serve-a"]
    assert registry.get("serve-a").loaded_stamp == "200:1:1"


def test_registry_min_max_batch_is_fleet_tightest(pkg):
    registry = pkg.fleet.ReplicaRegistry(heartbeat_secs=1.0,
                                         timeout_secs=30.0)
    _register(pkg, registry, "serve-a", max_batch=64)
    _register(pkg, registry, "serve-b", max_batch=16)
    assert registry.min_max_batch() == 16
    registry.begin_drain("serve-b")
    assert registry.min_max_batch() == 64


def test_registry_telemetry_totals_exclude_draining(pkg):
    registry = pkg.fleet.ReplicaRegistry(heartbeat_secs=1.0,
                                         timeout_secs=30.0)
    for rid in ("serve-a", "serve-b"):
        _register(pkg, registry, rid)
    _heartbeat(pkg, registry, "serve-a", qps=10.0, queue=4)
    _heartbeat(pkg, registry, "serve-b", qps=30.0, queue=8)
    registry.begin_drain("serve-b")
    totals = registry.telemetry_totals()
    assert totals["replicas"] == 1
    assert totals["qps"] == pytest.approx(10.0)
    assert totals["queue_depth"] == 4


# ---------------------------------------------------------------------------
# router data plane: affinity, failover, caps


def _routing_order(pkg, servicer, affinity_key):
    key_hash = pkg.stable_u64("k:%d" % affinity_key)
    return list(servicer.ring.successors(key_hash)), affinity_key


def test_router_failover_skips_dead_never_retries_same(pkg, journal):
    servicer = _servicer(pkg, failover_retries=2)
    for rid in ("serve-a", "serve-b", "serve-c"):
        _register(pkg, servicer, rid)
    order, key = _routing_order(pkg, servicer, affinity_key=7)
    stubs = {rid: _plant_stub(servicer, rid, _FakeStub(pkg.pb))
             for rid in order}
    stubs[order[0]].fail = _RpcFailure(grpc.StatusCode.UNAVAILABLE)

    response = servicer.predict(pkg.pb.PredictRequest(affinity_key=key),
                                _Ctx())
    assert response.model_stamp == "100:1:1"
    assert stubs[order[0]].predicts == 1
    assert stubs[order[1]].predicts == 1
    assert stubs[order[2]].predicts == 0


def test_router_failover_bounded_and_distinct(pkg, journal):
    servicer = _servicer(pkg, failover_retries=1)  # at most 2 attempts
    for rid in ("serve-a", "serve-b", "serve-c"):
        _register(pkg, servicer, rid)
    order, key = _routing_order(pkg, servicer, affinity_key=7)
    stubs = {
        rid: _plant_stub(
            servicer, rid,
            _FakeStub(pkg.pb,
                      fail=_RpcFailure(grpc.StatusCode.UNAVAILABLE)),
        )
        for rid in order
    }
    with pytest.raises(_Abort) as info:
        servicer.predict(pkg.pb.PredictRequest(affinity_key=key), _Ctx())
    assert info.value.code == grpc.StatusCode.UNAVAILABLE
    assert sum(s.predicts for s in stubs.values()) == 2
    assert max(s.predicts for s in stubs.values()) == 1


def test_router_skips_draining_replica(pkg, journal):
    servicer = _servicer(pkg)
    for rid in ("serve-a", "serve-b", "serve-c"):
        _register(pkg, servicer, rid)
    order, key = _routing_order(pkg, servicer, affinity_key=7)
    stubs = {rid: _plant_stub(servicer, rid, _FakeStub(pkg.pb))
             for rid in order}
    servicer.registry.begin_drain(order[0])
    servicer.predict(pkg.pb.PredictRequest(affinity_key=key), _Ctx())
    assert stubs[order[0]].predicts == 0
    assert stubs[order[1]].predicts == 1


def test_router_affinity_is_sticky(pkg, journal):
    servicer = _servicer(pkg)
    for rid in ("serve-a", "serve-b", "serve-c"):
        _register(pkg, servicer, rid)
    for rid in ("serve-a", "serve-b", "serve-c"):
        _plant_stub(servicer, rid, _FakeStub(pkg.pb))
    order, key = _routing_order(pkg, servicer, affinity_key=99)
    for _ in range(10):
        servicer.predict(pkg.pb.PredictRequest(affinity_key=key), _Ctx())
    counts = {
        rid: servicer.registry.get(rid).stub.predicts
        for rid in ("serve-a", "serve-b", "serve-c")
    }
    assert counts[order[0]] == 10
    assert sum(counts.values()) == 10


def test_router_inflight_cap_sheds_instead_of_spilling(pkg, journal):
    servicer = _servicer(pkg, inflight_cap=1)
    for rid in ("serve-a", "serve-b"):
        _register(pkg, servicer, rid)
    order, key = _routing_order(pkg, servicer, affinity_key=7)
    stubs = {rid: _plant_stub(servicer, rid, _FakeStub(pkg.pb))
             for rid in order}
    assert servicer._acquire(order[0])  # a stuck in-flight forward
    with pytest.raises(_Abort) as info:
        servicer.predict(pkg.pb.PredictRequest(affinity_key=key), _Ctx())
    assert info.value.code == grpc.StatusCode.RESOURCE_EXHAUSTED
    assert stubs[order[0]].predicts == 0
    assert stubs[order[1]].predicts == 0


def test_router_inflight_released_after_forward(pkg, journal):
    servicer = _servicer(pkg, inflight_cap=1)
    _register(pkg, servicer, "serve-a")
    _plant_stub(servicer, "serve-a", _FakeStub(pkg.pb))
    for _ in range(5):
        servicer.predict(pkg.pb.PredictRequest(affinity_key=3), _Ctx())
    assert servicer.state()["inflight"] == {}


def test_router_no_replica_aborts_unavailable(pkg, journal):
    servicer = _servicer(pkg)
    with pytest.raises(_Abort) as info:
        servicer.predict(pkg.pb.PredictRequest(affinity_key=1), _Ctx())
    assert info.value.code == grpc.StatusCode.UNAVAILABLE


def test_router_non_unavailable_error_propagates(pkg, journal):
    servicer = _servicer(pkg, failover_retries=3)
    for rid in ("serve-a", "serve-b"):
        _register(pkg, servicer, rid)
    order, key = _routing_order(pkg, servicer, affinity_key=7)
    stubs = {
        rid: _plant_stub(
            servicer, rid,
            _FakeStub(pkg.pb, fail=_RpcFailure(
                grpc.StatusCode.INVALID_ARGUMENT, "bad")),
        )
        for rid in order
    }
    with pytest.raises(_Abort) as info:
        servicer.predict(pkg.pb.PredictRequest(affinity_key=key), _Ctx())
    assert info.value.code == grpc.StatusCode.INVALID_ARGUMENT
    assert sum(s.predicts for s in stubs.values()) == 1


def test_router_model_info_tightens_max_batch(pkg, journal):
    servicer = _servicer(pkg)
    _register(pkg, servicer, "serve-a", max_batch=64)
    _register(pkg, servicer, "serve-b", max_batch=16)
    for rid in ("serve-a", "serve-b"):
        _plant_stub(servicer, rid, _FakeStub(pkg.pb, max_batch=64))
    info = servicer.model_info(pkg.pb.Empty(), _Ctx())
    assert info.loaded
    assert info.max_batch == 16


def test_router_replica_loss_cleans_ring_and_inflight(pkg, journal):
    servicer = _servicer(pkg, replica_timeout_secs=5.0)
    now = 1000.0
    servicer.registry.register(
        pkg.pb.RegisterReplicaRequest(replica_id="serve-a",
                                      addr="127.0.0.1:1"),
        now=now,
    )
    assert servicer._acquire("serve-a")
    servicer.registry.expire(now=now + 6.0)
    assert servicer.ring.members() == []
    assert servicer.state()["inflight"] == {}


# ---------------------------------------------------------------------------
# decision gate


def test_decision_gate_hold_then_fire_then_cooldown(pkg):
    gate = pkg.DecisionGate(hold_secs=2.0, cooldown_secs=5.0)
    assert not gate.observe("grow", True, 0.0)  # hold starts
    assert not gate.observe("grow", True, 1.9)
    assert gate.observe("grow", True, 2.1)  # held through
    gate.fired("grow", 2.1)
    assert gate.in_cooldown(2.2)
    assert not gate.observe("grow", True, 4.0)
    # the hold kept accumulating through the cooldown
    assert gate.observe("grow", True, 7.2)


def test_decision_gate_reset_on_condition_drop(pkg):
    gate = pkg.DecisionGate(hold_secs=2.0, cooldown_secs=1.0)
    assert not gate.observe("grow", True, 0.0)
    gate.observe("grow", False, 1.0)  # condition dropped: hold resets
    assert not gate.observe("grow", True, 2.5)
    assert gate.observe("grow", True, 4.6)


def test_decision_gate_conditions_are_independent_holds(pkg):
    gate = pkg.DecisionGate(hold_secs=2.0, cooldown_secs=1.0)
    gate.observe("grow", True, 0.0)
    gate.observe("shrink", True, 1.0)
    assert gate.observe("grow", True, 2.1)
    gate.fired("grow", 2.1)  # cooldown is shared...
    assert not gate.observe("shrink", True, 3.05)
    # ...but shrink's own hold survived the grow firing
    assert gate.observe("shrink", True, 3.2)


# ---------------------------------------------------------------------------
# replica autoscaler


class _FakeScaler:
    def __init__(self, place=True):
        self.requests = []
        self.place = place

    def scale_up(self, n):
        self.requests.append(n)
        return list(range(n)) if self.place else []


def _fleet(pkg, n, qps_each=0.0, queue_each=0):
    registry = pkg.fleet.ReplicaRegistry(heartbeat_secs=1.0,
                                         timeout_secs=30.0)
    for i in range(n):
        rid = "serve-%d" % i
        _register(pkg, registry, rid)
        _heartbeat(pkg, registry, rid, qps=qps_each, queue=queue_each)
    return registry


def test_autoscaler_below_floor_replaces_immediately(pkg, journal):
    registry = _fleet(pkg, 1)
    scaler = _FakeScaler()
    autoscaler = pkg.fleet.ReplicaAutoscaler(
        registry, scaler, min_replicas=3, max_replicas=6,
        hold_secs=30.0, cooldown_secs=5.0,
    )
    autoscaler.tick(now=1000.0)  # no hold wait despite hold_secs=30
    assert scaler.requests == [2]
    autoscaler.tick(now=1001.0)  # the cooldown still applies
    assert scaler.requests == [2]
    decisions = _journaled(pkg, journal, "scale_decision")
    assert len(decisions) == 1
    assert decisions[0]["direction"] == "grow"
    assert decisions[0]["tag"] == "serve"
    assert "below_floor" in decisions[0]["reasons"][0]


def test_autoscaler_grow_on_sustained_queue(pkg, journal):
    registry = _fleet(pkg, 2, qps_each=10.0, queue_each=50)
    scaler = _FakeScaler()
    autoscaler = pkg.fleet.ReplicaAutoscaler(
        registry, scaler, min_replicas=1, max_replicas=4, step=1,
        hold_secs=2.0, cooldown_secs=10.0,
        queue_per_replica=16.0, qps_per_replica=100.0,
    )
    autoscaler.tick(now=1000.0)
    assert scaler.requests == []  # hold not yet satisfied
    autoscaler.tick(now=1002.5)
    assert scaler.requests == [1]
    decisions = _journaled(pkg, journal, "scale_decision")
    assert len(decisions) == 1
    assert any("queue" in r for r in decisions[0]["reasons"])


def test_autoscaler_respects_ceiling(pkg, journal):
    registry = _fleet(pkg, 2, queue_each=500)
    scaler = _FakeScaler()
    autoscaler = pkg.fleet.ReplicaAutoscaler(
        registry, scaler, min_replicas=1, max_replicas=2,
        hold_secs=0.1, cooldown_secs=0.1, queue_per_replica=1.0,
    )
    autoscaler.tick(now=1000.0)
    autoscaler.tick(now=1001.0)
    assert scaler.requests == []


def test_autoscaler_shrink_drains_coldest_spares_canary(pkg, journal):
    registry = _fleet(pkg, 3)
    _heartbeat(pkg, registry, "serve-0", qps=0.5)  # coldest, but canary
    _heartbeat(pkg, registry, "serve-1", qps=1.0)  # coldest non-canary
    _heartbeat(pkg, registry, "serve-2", qps=8.0)
    registry.set_target(["serve-0"], "v1", canary=True)
    scaler = _FakeScaler()
    autoscaler = pkg.fleet.ReplicaAutoscaler(
        registry, scaler, min_replicas=1, max_replicas=4, step=1,
        hold_secs=2.0, cooldown_secs=1.0, qps_per_replica=100.0,
    )
    autoscaler.tick(now=1000.0)
    autoscaler.tick(now=1002.5)
    entry = registry.get("serve-1")
    assert entry is not None and entry.draining
    assert not registry.get("serve-0").draining  # canary spared
    assert not registry.get("serve-2").draining  # hottest spared
    decisions = _journaled(pkg, journal, "scale_decision")
    assert len(decisions) == 1
    assert decisions[0]["direction"] == "shrink"
    assert decisions[0]["victims"] == ["serve-1"]


def test_autoscaler_never_shrinks_below_floor(pkg, journal):
    registry = _fleet(pkg, 2)
    scaler = _FakeScaler()
    autoscaler = pkg.fleet.ReplicaAutoscaler(
        registry, scaler, min_replicas=2, max_replicas=4,
        hold_secs=0.1, cooldown_secs=0.1, qps_per_replica=100.0,
    )
    for i in range(20):
        autoscaler.tick(now=1000.0 + i)
    assert all(
        not registry.get(rid).draining for rid in registry.live_ids()
    )


# ---------------------------------------------------------------------------
# canary rollout judge


def _canary_fleet(pkg, n=4, loaded=("v1", "100:1:1")):
    registry = pkg.fleet.ReplicaRegistry(heartbeat_secs=1.0,
                                         timeout_secs=30.0)
    for i in range(n):
        rid = "serve-%d" % i
        _register(pkg, registry, rid)
        _heartbeat(pkg, registry, rid, loaded=loaded, available=loaded)
    return registry


def _feed(controller, stamp, value, count, outcome="ok"):
    for _ in range(count):
        controller.note_result(stamp, value, outcome)


def _controller(pkg, registry, **kw):
    kw.setdefault("fraction", 0.5)
    kw.setdefault("min_requests", 10)
    kw.setdefault("drift_max", 0.2)
    kw.setdefault("timeout_secs", 60.0)
    return pkg.canary.CanaryController(registry, **kw)


def _publish_v2(pkg, registry):
    for rid in registry.live_ids():
        _heartbeat(pkg, registry, rid, loaded=("v1", "100:1:1"),
                   available=("v2", "200:1:1"))


def test_canary_adopts_incumbent_and_pins_fleet(pkg, journal):
    registry = _canary_fleet(pkg)
    controller = _controller(pkg, registry)
    controller.tick(now=1000.0)
    state = controller.state()
    assert state["incumbent"] == {"export": "v1", "stamp": "100:1:1"}
    for rid in registry.live_ids():
        assert registry.get(rid).target_export == "v1"


def test_canary_adopt_waits_for_first_heartbeat(pkg, journal):
    # register carries only the model stamp; the export name arrives
    # with the first heartbeat
    registry = pkg.fleet.ReplicaRegistry(heartbeat_secs=1.0,
                                         timeout_secs=30.0)
    _register(pkg, registry, "serve-0", stamp="100:1:1")
    controller = _controller(pkg, registry)
    controller.tick(now=1000.0)
    assert controller.state()["incumbent"] == {"export": "", "stamp": ""}
    _heartbeat(pkg, registry, "serve-0", loaded=("v1", "100:1:1"),
               available=("v1", "100:1:1"))
    controller.tick(now=1001.0)
    assert controller.state()["incumbent"] == {
        "export": "v1", "stamp": "100:1:1",
    }


def test_canary_full_promote_cycle(pkg, journal):
    registry = _canary_fleet(pkg)
    controller = _controller(pkg, registry)
    controller.tick(now=1000.0)  # adopt v1
    _publish_v2(pkg, registry)
    controller.tick(now=1001.0)
    assert controller.active()
    members = controller.canary_members()
    assert len(members) == 2  # fraction 0.5 of 4
    for rid in members:
        entry = registry.get(rid)
        assert entry.canary and entry.target_export == "v2"
    _feed(controller, "200:1:1", 0.5, 20)
    _feed(controller, "100:1:1", 0.5, 20)
    controller.tick(now=1002.0)
    state = controller.state()
    assert state["state"] == "idle"
    assert state["incumbent"] == {"export": "v2", "stamp": "200:1:1"}
    for rid in registry.live_ids():
        assert registry.get(rid).target_export == "v2"
    assert len(_journaled(pkg, journal, "canary_started")) == 1
    promoted = _journaled(pkg, journal, "canary_promoted")
    assert len(promoted) == 1
    assert promoted[0]["export"] == "v2"
    assert promoted[0]["reasons"]


def test_canary_rollback_on_drift_and_never_retries(pkg, journal):
    registry = _canary_fleet(pkg)
    controller = _controller(pkg, registry, fraction=0.25)
    controller.tick(now=1000.0)
    _publish_v2(pkg, registry)
    controller.tick(now=1001.0)
    members = controller.canary_members()
    assert len(members) == 1  # fraction 0.25 of 4
    _feed(controller, "200:1:1", 0.95, 20)  # disjoint: TV = 1.0
    _feed(controller, "100:1:1", 0.05, 20)
    controller.tick(now=1002.0)
    state = controller.state()
    assert state["state"] == "idle"
    assert state["incumbent"]["export"] == "v1"
    assert state["rejected"] == ["200:1:1"]
    for rid in members:
        entry = registry.get(rid)
        assert entry.target_export == "v1" and not entry.canary
    controller.tick(now=1003.0)  # still the newest, but rejected
    assert not controller.active()
    rolled = _journaled(pkg, journal, "canary_rolled_back")
    assert len(rolled) == 1
    assert any("drift" in r for r in rolled[0]["reasons"])


def test_canary_failure_regression_rolls_back(pkg, journal):
    registry = _canary_fleet(pkg)
    controller = _controller(pkg, registry, fraction=0.25, drift_max=0.5)
    controller.tick(now=1000.0)
    _publish_v2(pkg, registry)
    controller.tick(now=1001.0)
    _feed(controller, "200:1:1", 0.5, 10)
    _feed(controller, "200:1:1", None, 5, outcome="shed")
    _feed(controller, "100:1:1", 0.5, 20)
    controller.tick(now=1002.0)
    rolled = _journaled(pkg, journal, "canary_rolled_back")
    assert len(rolled) == 1
    assert any("failure regression" in r for r in rolled[0]["reasons"])


def test_canary_timeout_rolls_back(pkg, journal):
    registry = _canary_fleet(pkg)
    controller = _controller(pkg, registry, fraction=0.25,
                             min_requests=1000, timeout_secs=30.0)
    controller.tick(now=1000.0)
    _publish_v2(pkg, registry)
    controller.tick(now=1001.0)
    assert controller.active()
    controller.tick(now=1001.0 + 31.0)
    assert not controller.active()
    rolled = _journaled(pkg, journal, "canary_rolled_back")
    assert len(rolled) == 1
    assert any("timeout" in r for r in rolled[0]["reasons"])


def test_canary_slice_is_stable_and_sized(pkg):
    registry = _canary_fleet(pkg)
    controller = _controller(pkg, registry, fraction=0.25)
    assert controller.assign_arm(123) == "incumbent"  # idle: everyone
    controller.tick(now=1000.0)
    _publish_v2(pkg, registry)
    controller.tick(now=1001.0)
    arms = [controller.assign_arm(h) for h in range(20000)]
    fraction = arms.count("canary") / len(arms)
    assert fraction == pytest.approx(0.25, abs=0.01)
    assert arms[:100] == [controller.assign_arm(h) for h in range(100)]


def test_prediction_stats_and_total_variation(pkg):
    a, b = pkg.canary.PredictionStats(), pkg.canary.PredictionStats()
    for _ in range(10):
        a.observe_prediction(0.05)
        b.observe_prediction(0.95)
    tv = pkg.canary.total_variation
    assert tv(a.distribution(), b.distribution()) == 1.0
    assert tv(a.distribution(), a.distribution()) == 0.0
    a.observe_outcome("ok")
    a.observe_outcome("shed")
    assert a.failure_rate() == pytest.approx(0.5)


# ---------------------------------------------------------------------------
# versioned-export discovery


def _write_bundle(root, name, step):
    path = os.path.join(root, name)
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "model.npz"), "wb") as f:
        f.write(b"npz")
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump({"step": step}, f)


def test_scan_export_versions_orders_and_skips_incomplete(pkg, tmp_path):
    root = str(tmp_path)
    _write_bundle(root, "v2", 200)
    _write_bundle(root, "v1", 100)
    os.makedirs(os.path.join(root, "torn"))  # publisher mid-write
    with open(os.path.join(root, "torn", "model.npz"), "wb") as f:
        f.write(b"npz")  # no manifest yet: invisible
    with open(os.path.join(root, "stray.txt"), "w") as f:
        f.write("not a bundle")
    versions = pkg.fleet.scan_export_versions(root)
    assert [(name, step) for name, step, _ in versions] == [
        ("v1", 100), ("v2", 200),
    ]
    assert pkg.fleet.scan_export_versions(os.path.join(root, "missing")) \
        == []


# ---------------------------------------------------------------------------
# parity: placement


def test_stable_u64_bit_for_bit():
    ref, port = Pkg("ref").stable_u64, Pkg("port").stable_u64
    rng = np.random.default_rng(17)
    tokens = ["k:%d" % k for k in rng.integers(1, 2**62, size=2000)]
    tokens += ["seq:%d" % i for i in range(1000)]
    tokens += ["serve-%d-%d#%d" % (i, p, v) for i, p, v in
               rng.integers(0, 100000, size=(1000, 3))]
    tokens += ["", "ünïcode-replica#0"]
    assert [port(t) for t in tokens] == [ref(t) for t in tokens]
    port_hash = importlib.import_module(
        "elasticdl_tpu_torch.common.hash_utils")
    ref_hash = importlib.import_module("elasticdl_tpu.common.hash_utils")
    for name in tokens[:50]:
        assert port_hash.string_to_id(name, 7) == \
            ref_hash.string_to_id(name, 7)
    ids = rng.integers(0, 2**40, size=200)
    assert port_hash.scatter_ids(ids, 5) == ref_hash.scatter_ids(ids, 5)
    assert [port_hash.int_to_id(int(i), 3) for i in ids] == \
        [ref_hash.int_to_id(int(i), 3) for i in ids]


@pytest.mark.parametrize("seed", [0, 1])
def test_hash_ring_places_10000_keys_like_the_reference(seed):
    """The same member sets, reached through the same joins and leaves,
    put every one of 10,000 keys on the same replica with the same
    failover order on both packages."""
    rng = np.random.default_rng(seed)
    rings = {side: Pkg(side).router.HashRing() for side in PACKAGES}
    members = []
    key_hashes = [Pkg("ref").stable_u64("k:%d" % k)
                  for k in rng.integers(1, 2**62, size=10000)]
    for step in range(8):
        if members and rng.random() < 0.3:
            victim = members.pop(int(rng.integers(len(members))))
            for ring in rings.values():
                ring.remove(victim)
        else:
            rid = "serve-%d-%d" % (step, int(rng.integers(1, 1 << 20)))
            members.append(rid)
            for ring in rings.values():
                ring.add(rid)
        owners = {side: [ring.lookup(h) for h in key_hashes]
                  for side, ring in rings.items()}
        assert owners["port"] == owners["ref"]
        assert sorted(rings["port"].members()) == sorted(members)
        for h in key_hashes[:200]:
            assert list(rings["port"].successors(h)) == \
                list(rings["ref"].successors(h))


# ---------------------------------------------------------------------------
# parity: the control plane on one seeded sequence


EXPORTS = (("v1", "100:1:1"), ("v2", "200:1:1"), ("v3", "300:1:1"))
# per stamp: the served prediction's range and the share of failed
# answers; v2 fails a little more often than v1 (within reach of the
# judge's error slack), the poisoned v3 predicts high
SERVED = {"100:1:1": ((0.0, 0.09), 0.02), "200:1:1": ((0.0, 0.09), 0.05),
          "300:1:1": ((0.6, 0.9), 0.02)}
# the fleet's load regimes, as (qps, queue depth) per replica
LOADS = {"idle": (0.0, 0), "warm": (20.0, 0), "busy": (80.0, 4),
         "overload": (120.0, 40)}
_OPS = ("register", "heartbeat", "heartbeat", "heartbeat", "feed", "feed",
        "tick", "tick", "expire", "drain", "deregister", "publish",
        "silence", "load")


def _drive_control_plane(pkg, seed, events_dir, monkeypatch, n_ops=300):
    """One package's registry + autoscaler + canary through a seeded
    op sequence under an injected clock; returns what every op
    answered and left behind, and the journal."""
    monkeypatch.setenv(pkg.events.EVENTS_DIR_ENV, str(events_dir))
    pkg.events.configure("router-0")
    rng = np.random.default_rng(seed)
    ring = pkg.router.HashRing()
    registry = pkg.fleet.ReplicaRegistry(
        on_join=ring.add, on_leave=ring.remove,
        heartbeat_secs=1.0, timeout_secs=10.0,
    )
    scaler = _FakeScaler()
    autoscaler = pkg.fleet.ReplicaAutoscaler(
        registry, scaler, min_replicas=2, max_replicas=5, step=1,
        hold_secs=2.0, cooldown_secs=4.0, queue_per_replica=8.0,
        qps_per_replica=50.0,
    )
    controller = pkg.canary.CanaryController(
        registry, fraction=0.5, min_requests=12, drift_max=0.25,
        timeout_secs=40.0,
    )
    now, seq, published, load, shed = 1000.0, 0, 1, "idle", 0
    silent = set()  # replicas that stopped heartbeating (killed)
    loaded = {}  # replica -> (export, stamp) it serves
    pending = 0  # scaled-up replicas yet to register
    out = []
    for _ in range(n_ops):
        now += float(rng.choice([0.25, 0.5, 1.0, 2.0]))
        op = str(rng.choice(_OPS))
        if pending and rng.random() < 0.5:
            op = "register"
        live = sorted(registry.live_ids())
        answer = None
        if op == "register":
            pending = max(0, pending - 1)
            seq += 1
            rid = "serve-%d" % seq
            answer = registry.register(pkg.pb.RegisterReplicaRequest(
                replica_id=rid, addr="127.0.0.1:1",
                max_batch=int(rng.choice([8, 16, 32])),
                model_stamp=EXPORTS[0][1],
                telemetry=pkg.pb.TelemetryBlob(role="serve")), now=now)
            loaded[rid] = EXPORTS[0]
        elif op == "heartbeat" and live:
            qps, queue = LOADS[load]
            if load == "overload":
                shed += int(rng.integers(0, 4))
            for rid in live:
                if rid in silent:
                    continue
                target = registry.get(rid).target_export
                if target in dict(EXPORTS):
                    loaded[rid] = (target, dict(EXPORTS)[target])
                known, drain, tgt = _heartbeat(
                    pkg, registry, rid,
                    qps=qps * float(rng.uniform(0.5, 1.5)),
                    queue=queue, shed=shed,
                    loaded=loaded.get(rid, ("", "")),
                    available=EXPORTS[published - 1], now=now)
                out.append(("hb", rid, known, drain, tgt))
        elif op == "feed" and loaded:
            # answers from the versions the live replicas serve
            serving = sorted({loaded[r][1] for r in live if r in loaded})
            for _ in range(int(rng.integers(1, 20))):
                stamp = str(rng.choice(serving or [EXPORTS[0][1]]))
                (lo, hi), fail = SERVED[stamp]
                if rng.random() < fail:
                    controller.note_result(stamp, None, "shed")
                else:
                    controller.note_result(
                        stamp, float(rng.uniform(lo, hi)), "ok")
        elif op == "tick":
            controller.tick(now=now)
            before = len(scaler.requests)
            autoscaler.tick(now=now)
            pending += sum(scaler.requests[before:])
        elif op == "expire":
            answer = registry.expire(now=now)
            silent -= set(answer)
        elif op == "drain" and live and rng.random() < 0.3:
            answer = registry.begin_drain(str(rng.choice(live)))
        elif op == "deregister" and live:
            draining = [r for r in live if registry.get(r).draining]
            rid = str(rng.choice(draining or live))
            answer = registry.deregister(pkg.pb.DeregisterReplicaRequest(
                replica_id=rid, reason="sigterm", served=int(seq),
                shed=0))
        elif op == "publish" and published < len(EXPORTS):
            published += 1
        elif op == "silence" and live and rng.random() < 0.3:
            silent.add(str(rng.choice(live)))
        elif op == "load":
            load = str(rng.choice(sorted(LOADS)))
        state = registry.state()
        for entry in state.values():
            entry.pop("heartbeat_age")  # read off the wall clock
        out.append((op, answer, state, autoscaler.state(),
                    controller.state(), sorted(ring.members()),
                    list(scaler.requests), registry.telemetry_totals(),
                    registry.min_max_batch()))
    pkg.events.flush()
    journal = [{k: v for k, v in e.items() if k not in ("ts", "pid")}
               for e in load_journal(events_dir)]
    pkg.events._reset_for_tests()
    return out, journal


@pytest.mark.parametrize("seed", [0, 2, 4])
def test_control_plane_parity_on_a_seeded_sequence(seed, tmp_path,
                                                   monkeypatch):
    ref_out, ref_journal = _drive_control_plane(
        Pkg("ref"), seed, tmp_path / "ref", monkeypatch)
    port_out, port_journal = _drive_control_plane(
        Pkg("port"), seed, tmp_path / "port", monkeypatch)
    assert len(port_out) == len(ref_out)
    for i, (got, want) in enumerate(zip(port_out, ref_out)):
        assert got == want, "op %d: %r" % (i, want[0])
    assert port_journal == ref_journal
    # the sequence reached every decision the fleet makes
    kinds = {e["event"] for e in port_journal}
    directions = {e.get("direction") for e in port_journal
                  if e["event"] == "scale_decision"}
    assert {"replica_registered", "replica_lost", "replica_draining",
            "drain_ack", "scale_decision", "canary_started"} <= kinds
    assert kinds & {"canary_promoted", "canary_rolled_back"}
    assert directions == {"grow", "shrink"}


def test_prediction_stats_and_total_variation_parity():
    rng = np.random.default_rng(5)
    values = np.concatenate([rng.uniform(-0.5, 1.5, 400),
                             rng.normal(0.3, 0.2, 400), [0.0, 1.0, 0.1]])
    outcomes = rng.choice(["ok", "ok", "ok", "shed", "error",
                           "unavailable"], size=300)
    books = {}
    for side in PACKAGES:
        canary = Pkg(side).canary
        a, b = canary.PredictionStats(), canary.PredictionStats()
        for v in values:
            a.observe_prediction(float(v))
        for v in values[::3] * 0.5:
            b.observe_prediction(float(v))
        for o in outcomes:
            a.observe_outcome(str(o))
        books[side] = (a.distribution(), b.distribution(), a.mean(),
                       a.failure_rate(), a.snapshot(), b.snapshot(),
                       canary.total_variation(a.distribution(),
                                              b.distribution()))
    assert books["port"] == books["ref"]


def test_mean_prediction_parity():
    """The canary's per-answer score: the mean of the first output
    tensor, equal on an fp32 answer; on a bfloat16 answer the port
    decodes exactly to fp32 before the mean."""
    import torch

    from elasticdl_tpu.common import tensor_utils as ref_tu
    from elasticdl_tpu_torch.common import tensor_utils as port_tu

    rng = np.random.default_rng(9)
    logits = rng.standard_normal((2, 16, 64)).astype(np.float32)
    ref, port = Pkg("ref"), Pkg("port")
    ref_resp = ref.pb.PredictResponse(model_stamp="1:1:1")
    ref_tu.ndarray_to_blob(logits, ref_resp.outputs["output"])
    port_resp = port.pb.PredictResponse(model_stamp="1:1:1")
    port_tu.tensor_to_blob(torch.from_numpy(logits),
                           port_resp.outputs["output"])
    assert port.router._mean_prediction(port_resp) == \
        ref.router._mean_prediction(ref_resp)
    bf16 = torch.from_numpy(logits).to(torch.bfloat16)
    port_resp = port.pb.PredictResponse()
    port_tu.tensor_to_blob(bf16, port_resp.outputs["output"])
    want = float(np.mean(bf16.float().numpy()))
    assert port.router._mean_prediction(port_resp) == want
    assert port.router._mean_prediction(port.pb.PredictResponse()) is None


# ---------------------------------------------------------------------------
# parity: export discovery on each side's own writer


def _write_side_bundle(side, path, params_np, step):
    if side == "port":
        from elasticdl_tpu_torch.train.export import export_state_dict

        export_state_dict(params_np, path, step=step)
    else:
        import jax.numpy as jnp

        from elasticdl_tpu.train.export import export_train_state
        from elasticdl_tpu.train.train_state import TrainState

        state = TrainState(
            step=jnp.asarray(step, jnp.int32),
            params={k: jnp.asarray(v) for k, v in params_np.items()},
            model_state={}, opt_state=())
        export_train_state(state, path)


def test_scan_export_versions_parity_on_own_writers(tmp_path):
    rng = np.random.default_rng(3)
    params = {"w": rng.standard_normal((4, 3)).astype(np.float32)}
    scans = {}
    for side in PACKAGES:
        root = tmp_path / side
        for name, step in (("v10", 10), ("v2", 2), ("a7", 7), ("b7", 7)):
            _write_side_bundle(side, str(root / name), params, step)
        # a publisher mid-write: the npz landed, the manifest not yet
        torn = root / "v99"
        _write_side_bundle(side, str(torn), params, 99)
        os.remove(torn / "manifest.json")
        scans[side] = [(name, step) for name, step, _ in
                       Pkg(side).fleet.scan_export_versions(str(root))]
    assert scans["port"] == scans["ref"] == [
        ("v2", 2), ("a7", 7), ("b7", 7), ("v10", 10)]


def test_export_signature_parity_on_a_bundle_copied_manifest_first(
        tmp_path):
    """A bundle that arrived by a copy writing manifest.json first (its
    model.npz newer than the manifest) is complete on both sides: the
    same stamp, found by ``scan_export_versions``; without its manifest
    it is absent on both."""
    import shutil

    params = {"w": np.ones((2, 2), np.float32)}
    staged = str(tmp_path / "staged")
    _write_side_bundle("port", staged, params, 5)
    root = tmp_path / "root"
    bundle = root / "v5"
    os.makedirs(bundle)
    signature = {side: Pkg(side).mod("serve.model").export_signature
                 for side in PACKAGES}
    assert {side: sig(str(bundle)) for side, sig in signature.items()} == {
        "ref": None, "port": None}
    for name in ("manifest.json", "model.npz"):
        shutil.copyfile(os.path.join(staged, name), str(bundle / name))
        time.sleep(0.01)  # mtimes apart on a coarse filesystem clock
    stamps = {side: sig(str(bundle)) for side, sig in signature.items()}
    assert stamps["port"] == stamps["ref"]
    assert stamps["port"] is not None and stamps["port"].startswith("5:")
    for side in PACKAGES:
        found = Pkg(side).fleet.scan_export_versions(str(root))
        assert [(name, step) for name, step, _ in found] == [("v5", 5)]
    os.remove(str(bundle / "manifest.json"))
    assert {side: sig(str(bundle)) for side, sig in signature.items()} == {
        "ref": None, "port": None}


# ---------------------------------------------------------------------------
# parity: the Router surface across packages over real gRPC


@pytest.mark.parametrize("client_side,server_side",
                         [("ref", "port"), ("port", "ref")])
def test_router_surface_across_packages(client_side, server_side):
    """A replica of one package registers, heartbeats and deregisters
    with a router of the other over real gRPC."""
    client, server_pkg = Pkg(client_side), Pkg(server_side)
    services = server_pkg.mod("proto.services")
    grpc_utils = server_pkg.mod("common.grpc_utils")
    servicer = server_pkg.router.RouterServicer(
        heartbeat_secs=1.5, replica_timeout_secs=30.0)
    server = grpc_utils.build_server()
    services.add_router_servicer_to_server(servicer, server)
    services.add_serve_servicer_to_server(servicer, server)
    port = grpc_utils.find_free_port()
    server.add_insecure_port("127.0.0.1:%d" % port)
    server.start()
    channel = client.mod("common.grpc_utils").build_channel(
        "127.0.0.1:%d" % port)
    try:
        stub = client.mod("proto.services").RouterStub(channel)
        pb = client.pb
        resp = stub.register_replica(pb.RegisterReplicaRequest(
            replica_id="serve-0-1", addr="127.0.0.1:1", max_batch=8,
            model_stamp="100:1:1",
            telemetry=pb.TelemetryBlob(role="serve-0", serve_qps=3.0)),
            timeout=10)
        assert resp.accepted and resp.heartbeat_secs == 1.5
        servicer.registry.set_target(["serve-0-1"], "v2")
        servicer.registry.begin_drain("serve-0-1")
        hb = stub.heartbeat_replica(pb.ReplicaHeartbeatRequest(
            replica_id="serve-0-1", loaded_export="v1",
            loaded_stamp="100:1:1", available_export="v2",
            available_stamp="200:1:1",
            telemetry=pb.TelemetryBlob(serve_queue_depth=4)), timeout=10)
        assert (hb.known, hb.drain, hb.target_export) == (True, True, "v2")
        assert servicer.registry.get("serve-0-1").queue_depth == 4
        stub.deregister_replica(pb.DeregisterReplicaRequest(
            replica_id="serve-0-1", reason="router_drain", served=3),
            timeout=10)
        assert servicer.registry.live_ids() == []
        hb = stub.heartbeat_replica(pb.ReplicaHeartbeatRequest(
            replica_id="serve-0-1"), timeout=10)
        assert not hb.known
        # the router's Serve surface answers with no replica
        serve_stub = client.mod("proto.services").ServeStub(channel)
        with pytest.raises(grpc.RpcError) as info:
            serve_stub.predict(pb.PredictRequest(affinity_key=5),
                               timeout=10)
        assert info.value.code() == grpc.StatusCode.UNAVAILABLE
    finally:
        channel.close()
        server.stop(0)


def test_router_concurrent_forwards_release_every_slot():
    """Many threads through the port's router with a shortened switch
    interval: every forward is answered or failed over, and the
    in-flight book ends empty (a lost update would leave a slot)."""
    import sys

    port = Pkg("port")
    servicer = port.router.RouterServicer(
        heartbeat_secs=1.0, replica_timeout_secs=30.0, inflight_cap=64,
        failover_retries=2)
    for rid in ("serve-a", "serve-b", "serve-c"):
        _register(port, servicer, rid)
    stubs = {rid: _plant_stub(servicer, rid, _FakeStub(port.pb))
             for rid in ("serve-a", "serve-b", "serve-c")}
    stubs["serve-b"].fail = _RpcFailure(grpc.StatusCode.UNAVAILABLE)
    errors, answered = [], []
    lock = threading.Lock()

    def caller(seed):
        for k in range(200):
            try:
                servicer.predict(port.pb.PredictRequest(
                    affinity_key=seed * 1000 + k), _Ctx())
                with lock:
                    answered.append(1)
            except _Abort as e:
                with lock:
                    errors.append(e.code)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=caller, args=(s,))
                   for s in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert errors == [] and len(answered) == 16 * 200
    assert servicer.state()["inflight"] == {}

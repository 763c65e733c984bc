"""The port's ``ElasticController`` (``elasticdl_tpu_torch/master/
autoscaler.py``) against the JAX package's, on the CPU.

Every controller scenario of tests/test_autoscaler.py runs against the
port (hysteresis, cooldown, bounds, the budget order, the marginal-gain
guard, victim choice, the ack-to-DELETED lag), and seeded sequences of
300 random ticks (backlog, live, draining and departed ids, deaths,
throughput, step-time EWMAs, limit moves) drive both controllers,
through fakes of the scaler, the dispatcher and the fleet and one fake
clock: they make the same decision at every tick. The master wires the
controller to its pod manager and the task monitor's scan under
``EDL_AUTOSCALE``.
"""

import numpy as np
import pytest

from elasticdl_tpu.master import autoscaler as ref_autoscaler
from elasticdl_tpu.proto import elasticdl_tpu_pb2 as ref_pb
from elasticdl_tpu_torch.master import autoscaler
from elasticdl_tpu_torch.master.autoscaler import (
    DrainManager,
    ElasticController,
)
from elasticdl_tpu_torch.proto import elasticdl_tpu_pb2 as pb


class FakeDispatcher:
    def __init__(self, queue=0, epochs_left=0, doing=0, eval_queue=0):
        self.queue = queue
        self.epochs_left = epochs_left
        self.doing = doing
        self.eval_queue = eval_queue
        self.recovered = []

    def queue_counts(self):
        return {
            "queue_depth": {
                "training": self.queue,
                "evaluation": self.eval_queue,
            },
            "doing": self.doing,
            "epochs_left": self.epochs_left,
        }

    def recover_tasks(self, worker_id):
        self.recovered.append(worker_id)


class FakeScaler:
    def __init__(self, ids=()):
        self.ids = list(ids)
        self.grown = []
        self.removed = []
        self._next = max(self.ids, default=-1) + 1

    def worker_ids(self):
        return list(self.ids)

    def scale_up(self, count):
        started = []
        for _ in range(count):
            self.ids.append(self._next)
            started.append(self._next)
            self._next += 1
        self.grown.append(started)
        return started

    def remove_worker(self, worker_id):
        self.ids.remove(worker_id)
        self.removed.append(worker_id)
        return True


class LaggyScaler(FakeScaler):
    """``remove_worker`` deletes the pod, but the watch's DELETED event,
    which prunes ``worker_ids()``, lands later."""

    def remove_worker(self, worker_id):
        self.removed.append(worker_id)
        return True

    def deliver_deleted(self):
        self.ids = [i for i in self.ids if i not in self.removed]


class FakeFleet:
    def __init__(self, ewmas=None, throughput=0.0):
        self.ewmas = dict(ewmas or {})
        self.throughput = throughput
        self.draining = []
        self.drained = []

    def worker_step_ewmas(self):
        return dict(self.ewmas)

    def fleet_examples_per_sec(self):
        return self.throughput

    def mark_draining(self, worker_id):
        self.draining.append(worker_id)

    def mark_drained(self, worker_id, reason=""):
        self.drained.append((worker_id, reason))


def controller(dispatcher, scaler, drain=None, fleet=None, module=None,
               **kw):
    module = module or autoscaler
    kw.setdefault("min_workers", 1)
    kw.setdefault("max_workers", 8)
    kw.setdefault("step", 2)
    kw.setdefault("cooldown_secs", 10.0)
    kw.setdefault("hold_secs", 3.0)
    kw.setdefault("backlog_per_worker", 2.0)
    if drain is None:
        drain = module.DrainManager(dispatcher, fleet=fleet,
                                    deadline_secs=60)
    return module.ElasticController(dispatcher, scaler, drain, fleet=fleet,
                                    **kw)


# ---------------------------------------------------------------------------
# the scenarios of tests/test_autoscaler.py


def test_grow_needs_sustained_backlog_and_respects_cooldown():
    dispatcher = FakeDispatcher(queue=40, epochs_left=0, doing=2)
    scaler = FakeScaler(ids=[0, 1])
    ctl = controller(dispatcher, scaler)
    t0 = 1000.0
    ctl.tick(t0)  # starts the hold window, no action yet
    assert scaler.grown == []
    ctl.tick(t0 + 3.0)  # held >= hold_secs -> grow by step
    assert scaler.grown == [[2, 3]]
    # cooldown: the backlog is still deep, but no second grow yet
    ctl.tick(t0 + 6.5)
    ctl.tick(t0 + 9.5)
    assert scaler.grown == [[2, 3]]
    # cooldown over and the hold window (re-armed at the last grow)
    ctl.tick(t0 + 14.0)
    assert len(scaler.grown) == 2


def test_backlog_blip_does_not_buy_pods():
    dispatcher = FakeDispatcher(queue=40)
    scaler = FakeScaler(ids=[0, 1])
    ctl = controller(dispatcher, scaler)
    t0 = 1000.0
    ctl.tick(t0)
    dispatcher.queue = 0  # the blip clears before the hold elapses
    ctl.tick(t0 + 2.0)
    dispatcher.queue = 40
    ctl.tick(t0 + 3.5)  # hold restarted: still not held long enough
    assert scaler.grown == []


def test_grow_caps_at_max_workers():
    dispatcher = FakeDispatcher(queue=1000)
    scaler = FakeScaler(ids=[0, 1, 2])
    ctl = controller(dispatcher, scaler, max_workers=4, step=8)
    ctl.tick(1000.0)
    ctl.tick(1003.0)
    assert scaler.grown == [[3]]  # 3 live, ceiling 4 -> +1 only


def test_grow_ceiling_counts_draining_pods_as_real():
    # 2 of 6 pods are draining; their pods still exist, so a deep
    # backlog must not buy pods past EDL_MAX_WORKERS in all
    dispatcher = FakeDispatcher(queue=1000, doing=4)
    scaler = FakeScaler(ids=[0, 1, 2, 3, 4, 5])
    drain = DrainManager(dispatcher, deadline_secs=60)
    ctl = controller(
        dispatcher, scaler, drain=drain, max_workers=6, step=4
    )
    drain.begin_drain(4, reason="preemption")
    drain.begin_drain(5, reason="preemption")
    ctl.tick(1000.0)
    ctl.tick(1003.0)
    assert scaler.grown == []
    # the drains resolve and the watch prunes the pods: the freed
    # capacity buys workers again, exactly up to the ceiling
    for wid in (4, 5):
        drain.deregister(
            pb.DeregisterWorkerRequest(worker_id=wid, reason="preemption")
        )
    scaler.ids = [0, 1, 2, 3]
    ctl.tick(1010.0)
    ctl.tick(1013.0)
    assert scaler.grown == [[6, 7]]  # 4 live + 2 = ceiling, not +step


def test_shrink_idle_tail_picks_slowest_ewma_victims():
    dispatcher = FakeDispatcher(queue=0, epochs_left=0, doing=1)
    scaler = FakeScaler(ids=[0, 1, 2])
    fleet = FakeFleet(ewmas={0: 0.1, 1: 0.9, 2: 0.4})
    drain = DrainManager(dispatcher, fleet=fleet, deadline_secs=60)
    ctl = controller(
        dispatcher, scaler, drain=drain, fleet=fleet, step=2,
        min_workers=1,
    )
    t0 = 1000.0
    ctl.tick(t0)
    assert scaler.removed == []
    ctl.tick(t0 + 3.0)
    # target = max(min_workers, doing) = 1 -> shrink by 2, slowest first
    assert scaler.removed == [1, 2]
    assert drain.is_draining(1) and drain.is_draining(2)
    assert fleet.draining == [1, 2]
    state = ctl.state()
    assert state["last_decision"]["direction"] == "shrink"
    assert state["last_decision"]["victims"] == [1, 2]


def test_lowered_budget_shrinks_without_hold():
    dispatcher = FakeDispatcher(queue=50, doing=3)  # busy job
    scaler = FakeScaler(ids=[0, 1, 2, 3])
    fleet = FakeFleet(ewmas={0: 0.2, 1: 0.2, 2: 0.2, 3: 0.8})
    drain = DrainManager(dispatcher, fleet=fleet, deadline_secs=60)
    ctl = controller(
        dispatcher, scaler, drain=drain, fleet=fleet, step=4
    )
    ctl.set_limits(max_workers=2)
    ctl.tick(1000.0)  # at once: the budget is an order, not a signal
    assert len(scaler.removed) == 2
    assert scaler.removed[0] == 3  # the slowest EWMA drains first


def test_budget_below_min_floor_never_drains_whole_fleet():
    """A ceiling under the floor must not drain below min_workers: with
    zero workers the grow gate could never fire again."""
    dispatcher = FakeDispatcher(queue=50, doing=3)
    scaler = FakeScaler(ids=[0, 1, 2, 3])
    fleet = FakeFleet(ewmas={0: 0.2, 1: 0.2, 2: 0.2, 3: 0.8})
    drain = DrainManager(dispatcher, fleet=fleet, deadline_secs=60)
    ctl = controller(
        dispatcher, scaler, drain=drain, fleet=fleet, step=8,
        min_workers=2,
    )
    ctl.set_limits(max_workers=0)
    ctl.tick(1000.0)
    assert len(scaler.removed) == 2  # down to the floor, not zero
    # at the floor the controller sits quiet
    ctl.tick(1001.0)
    assert len(scaler.removed) == 2


def test_over_budget_shrink_does_not_refire_in_ack_to_deleted_lag():
    dispatcher = FakeDispatcher(queue=50, doing=4)
    scaler = LaggyScaler(ids=[0, 1, 2, 3, 4, 5])
    fleet = FakeFleet(ewmas={i: 0.2 for i in range(6)})
    drain = DrainManager(dispatcher, fleet=fleet, deadline_secs=60)
    ctl = controller(
        dispatcher, scaler, drain=drain, fleet=fleet, step=8
    )
    ctl.set_limits(max_workers=4)
    ctl.tick(1000.0)
    assert len(scaler.removed) == 2
    # both victims flush and ack; their pods still show in worker_ids()
    for wid in list(scaler.removed):
        drain.deregister(
            pb.DeregisterWorkerRequest(worker_id=wid, reason="scale_down")
        )
    assert drain.draining_ids() == set()
    # without the departed ids the over-budget branch (no hold, no
    # cooldown) would drain 2 more healthy workers
    ctl.tick(1020.0)
    assert len(scaler.removed) == 2
    # the watch catches up; the departed ids are pruned, the fleet sits
    # at the budget, and the controller stays quiet
    scaler.deliver_deleted()
    ctl.tick(1040.0)
    assert len(scaler.removed) == 2
    assert drain.departed_ids(scaler.worker_ids()) == set()


def test_eval_backlog_blocks_idle_tail_shrink_and_buys_workers():
    # no training task and no epoch left, but 50 evaluation tasks: no
    # idle-tail shrink, and the deep backlog buys workers
    dispatcher = FakeDispatcher(
        queue=0, epochs_left=0, doing=1, eval_queue=50
    )
    scaler = FakeScaler(ids=[0, 1, 2])
    ctl = controller(dispatcher, scaler)
    t0 = 1000.0
    ctl.tick(t0)
    ctl.tick(t0 + 3.0)
    ctl.tick(t0 + 6.0)
    assert scaler.removed == []
    assert scaler.grown == [[3, 4]]


def test_marginal_gain_guard_sets_ceiling():
    dispatcher = FakeDispatcher(queue=100)
    scaler = FakeScaler(ids=[0, 1])
    fleet = FakeFleet(throughput=200.0)
    ctl = controller(
        dispatcher, scaler, fleet=fleet, step=2, max_workers=16,
        gain_settle_secs=5.0, cooldown_secs=1.0,
    )
    t0 = 1000.0
    ctl.tick(t0)
    ctl.tick(t0 + 3.0)  # grow 2 -> 4; the gain measurement armed
    assert scaler.grown == [[2, 3]]
    # the grow bought nothing: throughput unchanged at measurement time
    ctl.tick(t0 + 8.5)  # settles the gain -> ceiling at 4
    assert ctl.state()["gain_ceiling"] == 4
    ctl.tick(t0 + 9.0)
    ctl.tick(t0 + 13.0)  # backlog still deep, but growth stopped paying
    assert scaler.grown == [[2, 3]]


def test_grow_never_jumps_past_the_gain_ceiling():
    """Deaths can drop the fleet below a learned ceiling with a step big
    enough to overshoot it; the regrow stops at the ceiling."""
    dispatcher = FakeDispatcher(queue=100)
    scaler = FakeScaler(ids=[0, 1])
    fleet = FakeFleet(throughput=200.0)
    ctl = controller(
        dispatcher, scaler, fleet=fleet, step=4, max_workers=16,
        gain_settle_secs=5.0, cooldown_secs=1.0,
    )
    t0 = 1000.0
    ctl.tick(t0)
    ctl.tick(t0 + 3.0)  # grow 2 -> 6
    assert scaler.grown == [[2, 3, 4, 5]]
    ctl.tick(t0 + 8.5)  # flat throughput -> ceiling at 6
    assert ctl.state()["gain_ceiling"] == 6
    # three workers die: effective 3, backlog deep, the step would add 4
    for wid in (3, 4, 5):
        scaler.ids.remove(wid)
    ctl.tick(t0 + 20.0)
    ctl.tick(t0 + 24.0)  # held and out of cooldown -> regrow
    assert scaler.grown[-1] == [6, 7, 8]


def test_maybe_create_requires_env_and_scaler(monkeypatch):
    dispatcher = FakeDispatcher()
    drain = DrainManager(dispatcher, deadline_secs=60)
    monkeypatch.delenv("EDL_AUTOSCALE", raising=False)
    assert ElasticController.maybe_create(
        dispatcher, FakeScaler(), drain
    ) is None
    monkeypatch.setenv("EDL_AUTOSCALE", "1")
    assert ElasticController.maybe_create(
        dispatcher, None, drain
    ) is None
    assert ElasticController.maybe_create(
        dispatcher, FakeScaler(), drain
    ) is not None


def test_draining_workers_do_not_count_toward_fleet_size():
    dispatcher = FakeDispatcher(queue=0, epochs_left=0, doing=0)
    scaler = FakeScaler(ids=[0, 1])
    drain = DrainManager(dispatcher, deadline_secs=60)
    ctl = controller(
        dispatcher, scaler, drain=drain, min_workers=1, step=4
    )
    drain.begin_drain(1, reason="scale_down")
    t0 = 1000.0
    ctl.tick(t0)
    ctl.tick(t0 + 3.0)
    # the effective fleet is already at min (worker 0): no second victim
    assert scaler.removed == []


# ---------------------------------------------------------------------------
# the two controllers on seeded random sequences


class _Side:
    """One package's controller with its own fakes."""

    def __init__(self, module, request_cls, knobs, ids):
        self.request_cls = request_cls
        self.decisions = []
        self.dispatcher = FakeDispatcher()
        self.scaler = LaggyScaler(ids=ids)
        self.fleet = FakeFleet()
        self.drain = module.DrainManager(self.dispatcher, fleet=self.fleet,
                                         deadline_secs=60)
        self.ctl = module.ElasticController(
            self.dispatcher, self.scaler, self.drain, fleet=self.fleet,
            **knobs)

    def view(self):
        state = self.ctl.state()
        if state["last_decision"] and (
                not self.decisions
                or self.decisions[-1] != state["last_decision"]):
            self.decisions.append(state["last_decision"])
        return {"grown": [list(g) for g in self.scaler.grown],
                "removed": list(self.scaler.removed),
                "ids": list(self.scaler.ids),
                "draining": sorted(self.drain.draining_ids()),
                "state": state}


def _draw_tick(rng, ids, draining, t, last):
    """One tick's inputs and the fleet's events before it. The queue
    readings hold for a few ticks (``last``), so conditions persist
    past the hold as a job's backlog and tail do."""
    events = []
    if ids and rng.random() < 0.05:  # a death, pruned by the watch
        events.append(("die", int(rng.choice(ids))))
    if draining and rng.random() < 0.3:  # a drain ack
        events.append(("ack", int(rng.choice(sorted(draining)))))
    if rng.random() < 0.15:  # the watch catches up on removed pods
        events.append(("deleted", None))
    if ids and rng.random() < 0.03:  # a preemption drain
        events.append(("preempt", int(rng.choice(ids))))
    if rng.random() < 0.04:
        events.append(("limits", (int(rng.integers(0, 3)),
                                  int(rng.integers(1, 8)))))
    if last is None or rng.random() < 0.15:
        tail = rng.random() < 0.5
        queue = {
            "queue": 0 if tail else int(rng.choice([1, 3, 8, 20, 60])),
            "eval_queue": 0 if tail else int(rng.choice([0, 5, 30])),
            "epochs_left": 0 if tail else int(rng.integers(0, 3)),
            "doing": int(rng.integers(0, 3 if tail else 6)),
        }
    else:
        queue = {k: last[k] for k in ("queue", "eval_queue",
                                      "epochs_left", "doing")}
    inputs = dict(
        queue,
        throughput=float(rng.choice([0.0, 100.0, 180.0, 400.0])),
        ewmas={wid: float(rng.random()) for wid in ids
               if rng.random() < 0.7},
        now=t,
    )
    return events, inputs


def _apply(side, events, inputs):
    for kind, arg in events:
        if kind == "die" and arg in side.scaler.ids:
            side.scaler.ids.remove(arg)
        elif kind == "ack":
            side.drain.deregister(side.request_cls(
                worker_id=arg, reason="scale_down"))
        elif kind == "deleted":
            side.scaler.deliver_deleted()
        elif kind == "preempt":
            side.drain.begin_drain(arg, reason="preemption")
        elif kind == "limits":
            side.ctl.set_limits(min_workers=arg[0], max_workers=arg[1])
    d = side.dispatcher
    d.queue, d.eval_queue = inputs["queue"], inputs["eval_queue"]
    d.epochs_left, d.doing = inputs["epochs_left"], inputs["doing"]
    side.fleet.throughput = inputs["throughput"]
    side.fleet.ewmas = dict(inputs["ewmas"])
    side.ctl.tick(inputs["now"])


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_controllers_decide_alike_on_random_ticks(seed):
    rng = np.random.default_rng(seed)
    knobs = dict(min_workers=1, max_workers=int(rng.integers(3, 8)),
                 step=int(rng.integers(1, 4)), cooldown_secs=4.0,
                 hold_secs=2.0, backlog_per_worker=2.0, gain_floor=0.1,
                 gain_settle_secs=6.0)
    ref = _Side(ref_autoscaler, ref_pb.DeregisterWorkerRequest, knobs,
                [0, 1])
    port = _Side(autoscaler, pb.DeregisterWorkerRequest, knobs, [0, 1])
    t, inputs = 1000.0, None
    for tick in range(300):
        t += float(rng.choice([0.5, 1.0, 1.0, 2.0, 7.0]))
        events, inputs = _draw_tick(rng, list(port.scaler.ids),
                                    port.drain.draining_ids(), t, inputs)
        _apply(ref, events, inputs)
        _apply(port, events, inputs)
        assert port.view() == ref.view(), "tick %d" % tick
    # the sequences exercise both directions (seeds 0 and 1 the
    # budget's shrink too)
    assert port.scaler.grown and port.scaler.removed
    reasons = {d["reasons"][0].split(":")[0] for d in port.decisions}
    assert {"backlog", "idle_tail"} <= reasons, reasons


def test_master_makes_the_controller_under_edl_autoscale(monkeypatch,
                                                         tmp_path):
    """``Master.prepare`` makes the controller from its pod manager and
    hooks it onto the task monitor's scan; the state serves it."""
    from elasticdl_tpu_torch.master.master import Master

    class PodManager(FakeScaler):
        started = stopped = False

        def start(self):
            self.started = True

        def stop(self):
            self.stopped = True

        def all_workers_failed(self):
            return False

        def on_worker_presumed_dead(self, worker_id):
            pass

    monkeypatch.setenv("EDL_AUTOSCALE", "1")
    monkeypatch.setenv("EDL_AUTOSCALE_HOLD_SECS", "0")
    pm = PodManager(ids=[0])
    master = Master("elasticdl_tpu_torch.models.deepfm", port=0,
                    pod_manager=pm)
    master.prepare()
    try:
        assert master.autoscaler is not None and pm.started
        assert master.task_monitor._autoscaler is master.autoscaler
        assert master.autoscaler.state()["max_workers"] == 64
    finally:
        master.stop()
    assert pm.stopped
    monkeypatch.delenv("EDL_AUTOSCALE")
    static = Master("elasticdl_tpu_torch.models.deepfm", port=0,
                    pod_manager=PodManager(ids=[0]))
    static.prepare()
    try:
        assert static.autoscaler is None
    finally:
        static.stop()

"""The port's deterministic fault injection (testing/faults.py) against
the reference's, on the CPU.

(a) all 13 cases of tests/test_faults.py (the spec grammar, the
schedules of every kind, the inert path, ``apply_delay`` and both
interceptors over a real gRPC master) on both packages, each against
its own package's ``build_server``/``build_channel``; (b) parity: for
the same spec, seed and call order the port's firing schedule equals
the reference's, kind by kind, and ``maybe_poison_batch`` returns the
same batches.
"""

import importlib
import types

import grpc
import numpy as np
import pytest

PACKAGES = {"ref": "elasticdl_tpu", "port": "elasticdl_tpu_torch"}


def modules(side):
    root = PACKAGES[side]

    def mod(name):
        return importlib.import_module("%s.%s" % (root, name))

    return types.SimpleNamespace(
        side=side,
        faults=mod("testing.faults"),
        grpc_utils=mod("common.grpc_utils"),
        servicer=mod("master.servicer"),
        dispatcher=mod("master.task_dispatcher"),
        pb=mod("proto.elasticdl_tpu_pb2"),
        services=mod("proto.services"),
    )


@pytest.fixture(params=sorted(PACKAGES))
def m(request, monkeypatch):
    side = modules(request.param)
    monkeypatch.delenv(side.faults.FAULT_SPEC_ENV, raising=False)
    side.faults._reset_for_tests()
    yield side
    side.faults._reset_for_tests()


def test_spec_parse_and_match(m):
    spec = m.faults.FaultSpec.parse("ps-*:push_gradients:unavailable:3")
    assert spec.matches("ps-0", "push_gradients")
    assert spec.matches("ps-12", "push_gradients")
    assert not spec.matches("worker-0", "push_gradients")
    assert not spec.matches("ps-0", "pull_embedding_vectors")
    assert m.faults.FaultSpec.parse("*:*:deadline:0.5:7").matches(
        "", "anything")
    with pytest.raises(ValueError):
        m.faults.FaultSpec.parse("too:few")
    with pytest.raises(ValueError):
        m.faults.FaultSpec.parse("a:b:explode:1")


def test_burst_schedule_is_deterministic(m):
    spec = m.faults.FaultSpec.parse("m:get_task:unavailable:3")
    assert [spec.fire() for _ in range(6)] == (
        ["unavailable"] * 3 + [None] * 3)


def test_probability_schedule_reproducible_per_seed(m):
    a = m.faults.FaultSpec.parse("m:x:unavailable:0.5:42")
    b = m.faults.FaultSpec.parse("m:x:unavailable:0.5:42")
    schedule_a = [a.fire() for _ in range(64)]
    assert schedule_a == [b.fire() for _ in range(64)]
    assert "unavailable" in schedule_a and None in schedule_a


def test_kill_once_fires_on_nth_call_only(m):
    spec = m.faults.FaultSpec.parse("m:x:kill-once:3")
    assert [spec.fire() for _ in range(5)] == [None, None, "kill", None,
                                               None]


def test_inert_when_env_unset(m):
    assert not m.faults.enabled()
    assert m.faults.server_interceptors() == ()
    channel = grpc.insecure_channel("localhost:1")
    try:
        assert m.faults.intercept_client_channel(channel) is channel
    finally:
        channel.close()


def test_delay_spec_returns_sleep_action(m):
    spec = m.faults.FaultSpec.parse("m:x:delay:0.25")
    assert spec.fire() == ("delay", 0.25)
    assert spec.fire() == ("delay", 0.25)


def test_overload_spec_returns_apply_latency_action(m):
    spec = m.faults.FaultSpec.parse("ps-0:push_gradients:overload:0.5")
    assert [spec.fire() for _ in range(3)] == [("overload", 0.5)] * 3


def test_overload_call_bound_limits_the_slow_window(m):
    spec = m.faults.FaultSpec.parse("ps-0:push_gradients:overload:0.5:2")
    assert [spec.fire() for _ in range(4)] == [
        ("overload", 0.5), ("overload", 0.5), None, None]


def test_flap_alternates_failing_and_passing_windows(m):
    spec = m.faults.FaultSpec.parse("ps-0:*:flap:2")
    assert [spec.fire() for _ in range(6)] == [
        "unavailable", "unavailable", None, None,
        "unavailable", "unavailable"]


def test_apply_delay_consumes_overload_specs(m, monkeypatch):
    monkeypatch.setenv(m.faults.FAULT_SPEC_ENV,
                       "ps-0:push_gradients:overload:0.25:1")
    m.faults.set_role("ps-0")
    assert m.faults.server_interceptors() == ()
    assert m.faults.apply_delay("push_gradients") == 0.25
    assert m.faults.apply_delay("push_gradients") == 0.0
    assert m.faults.apply_delay("pull_embedding_vectors") == 0.0


def test_apply_delay_inert_when_env_unset(m):
    assert m.faults.apply_delay("push_gradients") == 0.0


def _serve_master(m, dispatcher):
    server = m.grpc_utils.build_server()
    m.services.add_master_servicer_to_server(
        m.servicer.MasterServicer(dispatcher), server)
    port = m.grpc_utils.find_free_port()
    server.add_insecure_port("localhost:%d" % port)
    server.start()
    return server, port


def test_server_interceptor_injects_unavailable_burst(m, monkeypatch):
    monkeypatch.setenv(m.faults.FAULT_SPEC_ENV,
                       "master:get_task:unavailable:2")
    m.faults.set_role("master")
    dispatcher = m.dispatcher.TaskDispatcher(
        training_shards={"f0": (0, 64)}, records_per_task=64)
    server, port = _serve_master(m, dispatcher)
    try:
        channel = grpc.insecure_channel("localhost:%d" % port)
        stub = m.services.MasterStub(channel)
        request = m.pb.GetTaskRequest(worker_id=1)
        for _ in range(2):
            with pytest.raises(grpc.RpcError) as excinfo:
                stub.get_task(request, timeout=5)
            assert excinfo.value.code() == grpc.StatusCode.UNAVAILABLE
        task = stub.get_task(request, timeout=5)
        assert task.task_id != 0
        stub.report_task_result(
            m.pb.ReportTaskResultRequest(task_id=task.task_id, worker_id=1),
            timeout=5)
        channel.close()
    finally:
        server.stop(0)


def test_client_interceptor_raises_code_the_retry_path_reads(
        m, monkeypatch):
    dispatcher = m.dispatcher.TaskDispatcher(
        training_shards={"f0": (0, 64)}, records_per_task=64)
    server, port = _serve_master(m, dispatcher)
    monkeypatch.setenv(m.faults.FAULT_SPEC_ENV,
                       "worker-1:get_comm_info:unavailable:1")
    m.faults.set_role("worker-1")
    try:
        channel = m.grpc_utils.build_channel("localhost:%d" % port)
        stub = m.services.MasterStub(channel)
        with pytest.raises(grpc.RpcError) as excinfo:
            stub.get_comm_info(m.pb.GetCommInfoRequest(worker_id=1),
                               timeout=5)
        assert excinfo.value.code() == grpc.StatusCode.UNAVAILABLE
        info = stub.get_comm_info(m.pb.GetCommInfoRequest(worker_id=1),
                                  timeout=5)
        assert info.world_size == 1
        channel.close()
    finally:
        server.stop(0)


# ---------------------------------------------------------------------
# (b) the same spec, seed and call order give the same schedule

SPECS = [
    "ps-1:push_gradients:unavailable:3",
    "ps-*:push_gradients:deadline:2",
    "*:*:unavailable:0.3:0",
    "*:*:unavailable:0.7:12345",
    "*:*:deadline:0.05:9",
    "m:x:kill-once:4",
    "m:x:kill-once:0",
    "m:x:delay:0.125",
    "worker-0:train_step:nan-batch:5",
    "worker-0:train_step:shape-churn:3",
    "ps-0:push_gradients:overload:0.5",
    "ps-0:push_gradients:overload:0.5:7",
    "ps-0:*:flap:1",
    "ps-0:*:flap:3",
]


@pytest.mark.parametrize("text", SPECS)
def test_schedule_equal_across_packages(text):
    schedules = {}
    for side in PACKAGES:
        spec = modules(side).faults.FaultSpec.parse(text)
        schedules[side] = ([spec.fire() for _ in range(200)],
                           spec.describe())
    assert schedules["port"] == schedules["ref"]


@pytest.mark.parametrize("text", SPECS[:6])
def test_fired_counts_every_action(text):
    spec = modules("port").faults.FaultSpec.parse(text)
    actions = [spec.fire() for _ in range(50)]
    assert spec.fired == sum(a is not None for a in actions)


def test_burst_of_three_fires_three_times_over_grpc(monkeypatch):
    """What a chaos run reads off a PS: an ``unavailable`` burst of 3
    on its push path fires exactly 3 times, once each on the first
    three matching calls, and never on other methods."""
    m = modules("port")
    m.faults._reset_for_tests()
    monkeypatch.setenv(m.faults.FAULT_SPEC_ENV,
                       "master:get_task:unavailable:3")
    m.faults.set_role("master")
    dispatcher = m.dispatcher.TaskDispatcher(
        training_shards={"f0": (0, 640)}, records_per_task=64)
    server, port = _serve_master(m, dispatcher)
    try:
        channel = grpc.insecure_channel("localhost:%d" % port)
        stub = m.services.MasterStub(channel)
        codes = []
        for _ in range(6):
            try:
                stub.get_task(m.pb.GetTaskRequest(worker_id=1), timeout=5)
                codes.append(None)
            except grpc.RpcError as e:
                codes.append(e.code())
            stub.get_comm_info(m.pb.GetCommInfoRequest(worker_id=1),
                               timeout=5)
        assert codes == [grpc.StatusCode.UNAVAILABLE] * 3 + [None] * 3
        (spec,) = m.faults._specs()
        assert spec.fired == 3
        channel.close()
    finally:
        server.stop(0)
        m.faults._reset_for_tests()


def _batch(rng):
    return {
        "features": {"ids": rng.randint(0, 100, size=(8, 3)),
                     "dense": rng.rand(8, 2).astype(np.float32)},
        "labels": rng.randint(0, 2, size=8),
        "_mask": np.ones(8, np.float32),
    }


@pytest.mark.parametrize("text", [
    "worker-0:train_step:nan-batch:2",
    "worker-0:train_step:shape-churn:3",
    "worker-*:train_step:nan-batch:1;worker-0:train_step:shape-churn:2",
])
def test_maybe_poison_batch_equal_across_packages(text, monkeypatch):
    outputs = {}
    for side in PACKAGES:
        m = modules(side)
        m.faults._reset_for_tests()
        monkeypatch.setenv(m.faults.FAULT_SPEC_ENV, text)
        m.faults.set_role("worker-0")
        rng = np.random.RandomState(0)
        outputs[side] = [m.faults.maybe_poison_batch(_batch(rng))
                         for _ in range(5)]
        m.faults._reset_for_tests()
    for got, want in zip(outputs["port"], outputs["ref"]):
        assert got.keys() == want.keys()
        for key in want:
            if isinstance(want[key], dict):
                assert got[key].keys() == want[key].keys()
                for k in want[key]:
                    np.testing.assert_array_equal(got[key][k], want[key][k])
            else:
                np.testing.assert_array_equal(got[key], want[key])

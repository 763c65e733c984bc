"""The port's overload discipline (common/overload.py) and retry policy
(common/grpc_utils.retry_call) against the JAX package's copies.

The cases of tests/test_grpc_utils.py run against the port: deadline
budgets, retry_call's core paths and reconnect, circuit breakers, retry
budgets and server pushback. Where a piece is pure logic (the budget
arithmetic, the breaker's state machine under an explicit clock, the
token bucket, the pushback hint, the error classes, retry_call's
schedule under a deterministic RNG) the reference's copy gets the same
inputs and the outcomes are compared.
"""

import threading
import time

import grpc
import pytest

from elasticdl_tpu.common import grpc_utils as ref_grpc_utils
from elasticdl_tpu.common import overload as ref_overload
from elasticdl_tpu_torch.common import grpc_utils
from elasticdl_tpu_torch.common import overload
from elasticdl_tpu_torch.common.grpc_utils import (
    _await_reconnect,
    build_server,
    find_free_port,
    retry_call,
)

MODULES = {"ref": (ref_overload, ref_grpc_utils),
           "port": (overload, grpc_utils)}


class FakeRpcError(grpc.RpcError):
    """A transport-shaped error with just the surface retry_call reads."""

    def __init__(self, code, retry_after_ms=None):
        super().__init__("fake %s" % code)
        self._code = code
        self._retry_after_ms = retry_after_ms

    def code(self):
        return self._code

    def trailing_metadata(self):
        if self._retry_after_ms is None:
            return ()
        return ((overload.RETRY_AFTER_KEY, str(self._retry_after_ms)),)


class WorstCaseRng:
    """uniform(a, b) -> b: every jitter draw is the full ceiling."""

    def uniform(self, low, high):
        return high


class ZeroRng:
    """uniform(a, b) -> a: every jitter draw is instant."""

    def uniform(self, low, high):
        return low


def _failing(times, code=grpc.StatusCode.UNAVAILABLE, result="ok",
             **error_kwargs):
    """A callable failing ``times`` times, then returning ``result``;
    .state["calls"] counts invocations."""
    state = {"calls": 0}

    def fn():
        state["calls"] += 1
        if state["calls"] <= times:
            raise FakeRpcError(code, **error_kwargs)
        return result

    fn.state = state
    return fn


@pytest.fixture(autouse=True)
def _clean_overload(monkeypatch):
    for env in (
        overload.DEADLINE_BUDGET_ENV,
        overload.RETRY_BUDGET_TOKENS_ENV,
        overload.RETRY_BUDGET_RATIO_ENV,
        overload.CIRCUIT_FAILURES_ENV,
        overload.CIRCUIT_RESET_SECS_ENV,
        overload.BROWNOUT_SKIP_AFTER_ENV,
    ):
        monkeypatch.delenv(env, raising=False)
    overload._reset_for_tests()
    ref_overload._reset_for_tests()
    yield
    overload._reset_for_tests()
    ref_overload._reset_for_tests()


def test_knob_names_and_wire_keys_are_the_references():
    for name in ("METADATA_KEY", "RETRY_AFTER_KEY", "DEADLINE_BUDGET_ENV",
                 "RETRY_BUDGET_TOKENS_ENV", "RETRY_BUDGET_RATIO_ENV",
                 "CIRCUIT_FAILURES_ENV", "CIRCUIT_RESET_SECS_ENV",
                 "BROWNOUT_SKIP_AFTER_ENV", "BROWNOUT_CODES", "CLOSED",
                 "OPEN", "HALF_OPEN"):
        assert getattr(overload, name) == getattr(ref_overload, name), name
    assert grpc_utils.RETRYABLE_CODES == ref_grpc_utils.RETRYABLE_CODES
    assert grpc_utils.UDS_DIR_ENV == ref_grpc_utils.UDS_DIR_ENV


# ---------------------------------------------------------------------------
# deadline-budget arithmetic


@pytest.mark.parametrize("impl", ["ref", "port"])
def test_nested_budgets_tighten_never_loosen(impl):
    mod = MODULES[impl][0]
    assert mod.remaining() is None
    with mod.budget(5.0):
        outer = mod.remaining()
        assert 4.5 < outer <= 5.0
        with mod.budget(60.0):
            assert mod.remaining() <= outer
        with mod.budget(0.5):
            assert mod.remaining() <= 0.5
        assert mod.remaining() > 0.5
    assert mod.remaining() is None


def test_budget_none_is_a_noop_scope():
    with overload.budget(None):
        assert overload.remaining() is None


def test_rpc_timeout_matches_reference():
    """No budget, a 1 s budget and an expired one: the port's timeouts
    are the reference's (each capped by the remainder, floored at 0)."""
    for secs in (None, 1.0, 0.0):
        got = []
        for mod in (ref_overload, overload):
            with mod.budget(secs):
                got.append([mod.rpc_timeout(d) is None
                            or round(mod.rpc_timeout(d), 1)
                            for d in (60.0, 0.2, None)])
        assert got[0] == got[1], (secs, got)
    assert overload.rpc_timeout(60.0) == 60.0
    with overload.budget(0.0):
        assert overload.remaining() == 0.0
        assert overload.rpc_timeout(60.0) == 0.0


def test_bind_budget_rehomes_into_another_thread():
    seen = {}

    def probe():
        seen["remaining"] = overload.remaining()

    with overload.budget(5.0):
        bound = overload.bind_budget(probe)
    thread = threading.Thread(target=bound)
    thread.start()
    thread.join(timeout=10)
    assert not thread.is_alive()
    assert seen["remaining"] is not None and seen["remaining"] <= 5.0
    assert overload.bind_budget(probe) is probe


# ---------------------------------------------------------------------------
# retry_call core paths


@pytest.mark.parametrize("times,code,budget,rng,outcome,calls", [
    (2, grpc.StatusCode.UNAVAILABLE, 30, ZeroRng, "ok", 3),
    (5, grpc.StatusCode.INTERNAL, 30, ZeroRng, "raise", 1),
    (2, grpc.StatusCode.DEADLINE_EXCEEDED, 30, ZeroRng, "ok", 3),
    # the drawn backoff would cross the deadline: raise the original
    (10, grpc.StatusCode.UNAVAILABLE, 0.2, WorstCaseRng, "raise", 1),
    # plain RESOURCE_EXHAUSTED (no hint) is not retryable
    (5, grpc.StatusCode.RESOURCE_EXHAUSTED, 30, ZeroRng, "raise", 1),
])
def test_retry_call_schedule_matches_reference(times, code, budget, rng,
                                               outcome, calls):
    """The same failing callable under the same deterministic RNG: the
    port and the reference make the same number of attempts and end
    the same way."""
    results = []
    for _, utils in MODULES.values():
        fn = _failing(times=times, code=code)
        started = time.monotonic()
        try:
            got = utils.retry_call(fn, "x", budget_secs=budget, rng=rng())
        except FakeRpcError:
            got = "raise"
        results.append((got, fn.state["calls"]))
        if rng is WorstCaseRng:
            assert time.monotonic() - started < 0.15
    assert results[0] == results[1] == (outcome, calls)


def test_retry_call_honors_callers_thread_budget():
    fn = _failing(times=10)
    with overload.budget(0.2):
        with pytest.raises(FakeRpcError):
            retry_call(fn, "x", budget_secs=60, rng=WorstCaseRng())
    assert fn.state["calls"] == 1


# ---------------------------------------------------------------------------
# channel-ready reconnect path


def test_await_reconnect_false_when_peer_never_comes_up():
    channel = grpc.insecure_channel("localhost:1")
    try:
        started = time.monotonic()
        assert _await_reconnect(channel, 0.2) is False
        assert time.monotonic() - started < 2.0
    finally:
        channel.close()


def test_retry_call_with_channel_beats_the_drawn_backoff():
    server = build_server(max_workers=2)
    port = find_free_port()
    server.add_insecure_port("localhost:%d" % port)
    server.start()
    channel = grpc.insecure_channel("localhost:%d" % port)
    try:
        fn = _failing(times=1)
        started = time.monotonic()
        result = retry_call(fn, "x", budget_secs=30, base_delay=5.0,
                            rng=WorstCaseRng(), channel=channel)
        assert result == "ok"
        assert fn.state["calls"] == 2
        assert time.monotonic() - started < 2.0
    finally:
        channel.close()
        server.stop(0)


# ---------------------------------------------------------------------------
# circuit breaker


def test_breaker_opens_then_fail_fast_then_probe_recloses(monkeypatch):
    monkeypatch.setenv(overload.CIRCUIT_FAILURES_ENV, "2")
    monkeypatch.setenv(overload.CIRCUIT_RESET_SECS_ENV, "0.2")
    fn = _failing(times=100)
    with pytest.raises(grpc.RpcError):
        retry_call(fn, "push", budget_secs=0.25, rng=ZeroRng(),
                   target="ps-0")
    breaker = overload.breaker_for("ps-0", "write")
    assert breaker.state() == overload.OPEN
    assert breaker.open_count >= 1
    probe = _failing(times=0)
    with pytest.raises(overload.CircuitOpenError) as excinfo:
        retry_call(probe, "push", budget_secs=5, rng=ZeroRng(),
                   target="ps-0", fail_fast_when_open=True)
    assert probe.state["calls"] == 0
    assert excinfo.value.code() == grpc.StatusCode.UNAVAILABLE
    time.sleep(0.25)
    healthy = _failing(times=0)
    assert retry_call(healthy, "push", budget_secs=5, rng=ZeroRng(),
                      target="ps-0") == "ok"
    assert breaker.state() == overload.CLOSED
    assert overload.client_stats()["circuits_not_closed"] == []


def test_breaker_paces_within_budget_without_fail_fast(monkeypatch):
    monkeypatch.setenv(overload.CIRCUIT_FAILURES_ENV, "1")
    monkeypatch.setenv(overload.CIRCUIT_RESET_SECS_ENV, "0.1")
    with pytest.raises(grpc.RpcError):
        retry_call(_failing(times=100), "push", budget_secs=0.05,
                   rng=ZeroRng(), target="ps-1")
    assert overload.breaker_for("ps-1", "write").state() == overload.OPEN
    healthy = _failing(times=0)
    started = time.monotonic()
    assert retry_call(healthy, "push", budget_secs=5, rng=ZeroRng(),
                      target="ps-1") == "ok"
    assert healthy.state["calls"] == 1
    assert time.monotonic() - started < 2.0


def test_breaker_state_machine_matches_reference():
    """One script of failures, successes and admission probes under an
    explicit clock: every admit delay, state and open count is the
    reference breaker's."""
    script = [("fail", 0.0), ("fail", 0.1), ("admit", 0.2), ("fail", 0.3),
              ("admit", 0.4), ("admit", 1.4), ("admit", 1.5),
              ("fail", 1.6), ("admit", 1.7), ("admit", 2.7),
              ("ok", 2.8), ("admit", 2.9), ("fail", 3.0)]
    trails = []
    for mod in (ref_overload, overload):
        breaker = mod.CircuitBreaker("ps", "write", failures=3,
                                     reset_secs=1.0)
        trail = []
        for op, now in script:
            if op == "fail":
                breaker.record_failure(now=now)
                trail.append(breaker.state())
            elif op == "ok":
                breaker.record_success(now=now)
                trail.append(breaker.state())
            else:
                trail.append((round(breaker.admit_delay(now=now), 6),
                              breaker.state()))
        trail.append(breaker.open_count)
        trails.append(trail)
    assert trails[0] == trails[1]
    states = [t[1] if isinstance(t, tuple) else t for t in trails[1][:-1]]
    assert {overload.OPEN, overload.HALF_OPEN, overload.CLOSED} <= set(states)


@pytest.mark.parametrize("what", ["pull_embedding_batch", "push_gradients",
                                  "push_embedding_table_infos", "get_task",
                                  "push_embedding_rows", "", None])
def test_method_class_matches_reference(what):
    assert overload.method_class(what) == ref_overload.method_class(what)


# ---------------------------------------------------------------------------
# retry budget


def test_retry_budget_exhaustion_fails_fast(monkeypatch):
    monkeypatch.setenv(overload.RETRY_BUDGET_TOKENS_ENV, "1")
    fn = _failing(times=100)
    with pytest.raises(overload.RetryBudgetExhausted) as excinfo:
        retry_call(fn, "push", budget_secs=30, rng=ZeroRng(), target="ps-2")
    assert fn.state["calls"] == 2
    assert excinfo.value.target == "ps-2"
    assert overload.client_stats()["retry_budget_exhausted"] == 1


def test_retry_budget_bucket_matches_reference():
    """Spend and refill sequences: the same grants, refusals and
    token counts as the reference's bucket."""
    ops = ["spend"] * 3 + ["ok"] * 3 + ["spend"] * 3 + ["ok"] * 50 + \
        ["spend"] * 4
    trails = []
    for mod in (ref_overload, overload):
        bucket = mod.RetryBudget(max_tokens=2, ratio=0.5)
        trail = []
        for op in ops:
            if op == "spend":
                trail.append(bucket.spend())
            else:
                bucket.record_success()
            trail.append(bucket.tokens())
        trail.append(bucket.exhausted)
        trails.append(trail)
    assert trails[0] == trails[1]


# ---------------------------------------------------------------------------
# server pushback


def test_pushback_paces_at_hint_without_penalizing_breaker():
    fn = _failing(times=1, code=grpc.StatusCode.RESOURCE_EXHAUSTED,
                  retry_after_ms=50)
    started = time.monotonic()
    assert retry_call(fn, "push", budget_secs=30, rng=WorstCaseRng(),
                      target="ps-4") == "ok"
    elapsed = time.monotonic() - started
    assert 0.05 <= elapsed < 1.0, elapsed
    assert overload.client_stats()["pushback_waits"] == 1
    assert overload.breaker_for("ps-4", "write").state() == overload.CLOSED


def test_retry_after_hint_matches_reference():
    cases = [FakeRpcError(grpc.StatusCode.RESOURCE_EXHAUSTED,
                          retry_after_ms=250),
             FakeRpcError(grpc.StatusCode.RESOURCE_EXHAUSTED),
             grpc.RpcError()]
    junk = FakeRpcError(grpc.StatusCode.RESOURCE_EXHAUSTED)
    junk._retry_after_ms = "not-a-number"
    cases.append(junk)
    got = [overload.retry_after_hint(e) for e in cases]
    assert got == [ref_overload.retry_after_hint(e) for e in cases]
    assert got == [0.25, None, None, None]


# ---------------------------------------------------------------------------
# interceptor inertness and the error surface


def test_budget_interceptor_identity_when_disabled(monkeypatch):
    monkeypatch.setenv(overload.DEADLINE_BUDGET_ENV, "0")
    channel = grpc.insecure_channel("localhost:1")
    try:
        assert overload.intercept_budget_channel(channel) is channel
    finally:
        channel.close()
    assert overload.server_budget_interceptors() == ()


def test_overload_errors_walk_like_rpc_errors():
    err = overload.CircuitOpenError("ps-0", "write")
    assert isinstance(err, grpc.RpcError)
    assert err.code() == grpc.StatusCode.UNAVAILABLE
    assert "ps-0" in err.details()
    budget_err = overload.RetryBudgetExhausted(
        "ps-1", grpc.StatusCode.UNAVAILABLE)
    assert budget_err.code() == grpc.StatusCode.UNAVAILABLE
    assert "ps-1" in budget_err.details()


def test_is_overload_failure_matches_reference():
    errors = [FakeRpcError(code) for code in grpc.StatusCode] + [
        overload.CircuitOpenError("t", "read"), ValueError("x")]
    for err in errors:
        ref_err = err
        if isinstance(err, overload.OverloadError):
            ref_err = ref_overload.CircuitOpenError("t", "read")
        assert overload.is_overload_failure(err) == \
            ref_overload.is_overload_failure(ref_err), err


def test_budget_rides_the_wire_to_the_handler():
    """A client budget crosses the channel interceptor as metadata and
    the server interceptor re-opens it around the handler; a port
    client against a reference server and the other way round."""
    from elasticdl_tpu.proto import elasticdl_tpu_pb2 as pb

    seen = []

    def handler(request, context):
        seen.append(overload.remaining() or ref_overload.remaining())
        return pb.Empty()

    for server_utils, client_utils in ((grpc_utils, ref_grpc_utils),
                                       (ref_grpc_utils, grpc_utils)):
        server = (server_utils.build_server(max_workers=2)
                  if server_utils is grpc_utils
                  else server_utils.build_server(max_workers=2,
                                                 instrument=False))
        server.add_generic_rpc_handlers((grpc.method_handlers_generic_handler(
            "probe.Probe", {"call": grpc.unary_unary_rpc_method_handler(
                handler, request_deserializer=pb.Empty.FromString,
                response_serializer=pb.Empty.SerializeToString)}),))
        port = find_free_port()
        server.add_insecure_port("localhost:%d" % port)
        server.start()
        channel = client_utils.build_channel("localhost:%d" % port)
        try:
            call = channel.unary_unary(
                "/probe.Probe/call",
                request_serializer=pb.Empty.SerializeToString,
                response_deserializer=pb.Empty.FromString)
            mod = (overload if client_utils is grpc_utils else ref_overload)
            with mod.budget(7.0):
                call(pb.Empty(), timeout=30)
            call(pb.Empty(), timeout=30)  # no budget: no header
        finally:
            channel.close()
            server.stop(0)
    assert len(seen) == 4
    for with_budget in (seen[0], seen[2]):
        assert with_budget is not None and 5.0 < with_budget <= 7.0
    assert seen[1] is None and seen[3] is None

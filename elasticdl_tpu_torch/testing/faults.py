"""Deterministic gRPC fault injection, driven by ``EDL_FAULT_SPEC``.

(Copy of elasticdl_tpu/testing/faults.py for the PyTorch port.)

Chaos tests must exercise the recovery paths (master relaunch, PS
restore, retry budgets) the same way on every run, on CPU, with no
cluster — so faults are injected at the gRPC boundary by interceptors
whose firing schedule is a pure function of the spec:

    EDL_FAULT_SPEC = spec[;spec...]
    spec           = role:method:kind:rate[:seed]

- ``role``   — fnmatch pattern against this process's role as set by
  ``set_role`` ("master", "ps-0", "worker-3"; ``ps-*`` matches any PS).
- ``method`` — fnmatch pattern against the bare RPC method name
  (``get_task``, ``push_gradients``, ``*``).
- ``kind``   — what happens when the spec fires:
    - ``unavailable`` / ``deadline``: the call fails with that gRPC
      status (server side aborts; client side raises before sending).
    - ``delay``: the call sleeps ``rate`` seconds, then proceeds.
    - ``kill-once``: the PROCESS dies by SIGKILL on the ``rate``-th
      matching call (once per process lifetime; relaunch with the spec
      cleared or it dies again).
    - ``nan-batch`` / ``shape-churn``: data-plane faults applied at
      ``maybe_poison_batch`` call sites on the train-batch path, not
      at the gRPC boundary (see that function's docstring).
    - ``overload``: server-side APPLY-PATH latency,
      consulted by the PS inside its gradient-apply path via
      ``apply_delay`` — NOT an interceptor fault. The request is
      already admitted when the latency lands, so pending-apply depth
      genuinely builds and the admission-control/pushback machinery is
      exercised for real instead of being handed a synthetic status
      code. ``rate`` = seconds per apply; the 5th field (normally the
      seed, unused here) optionally bounds the fault to the first N
      matching calls — the "slow window, then recovery" shape the
      overload bench drives.
    - ``flap``: periodic UNAVAILABLE windows — calls fail
      in alternating windows of ``int(rate)`` calls (first window
      fails), forever. The repeating fail/pass cadence is what drives
      a circuit breaker through full open -> half-open -> closed
      cycles, where a one-shot burst only exercises open.
- ``rate``   — for unavailable/deadline: values >= 1 are a
  deterministic BURST (the first ``int(rate)`` matching calls fail,
  later ones pass — the "PS comes back after N retries" shape);
  values < 1 are a per-call probability drawn from a ``Random(seed)``
  sequence (seed defaults to 0), so a given (spec, call order) always
  yields the same schedule. For delay: seconds. For kill-once: which
  matching call dies (default 1).

**Provably inert when unset**: ``server_interceptors()`` returns ``()``
and ``intercept_client_channel`` returns the channel object it was
given — no wrapper, no per-call branch. The only steady-state cost is
one ``os.environ.get`` + string compare per channel/server BUILD (never
per call).
"""

import fnmatch
import os
import signal
import threading
import time

import grpc

from elasticdl_tpu_torch.common.env_utils import env_str
from elasticdl_tpu_torch.common.log_utils import default_logger as _logger_factory

logger = _logger_factory("elasticdl_tpu_torch.testing.faults")

FAULT_SPEC_ENV = "EDL_FAULT_SPEC"

KINDS = (
    "unavailable", "deadline", "delay", "kill-once", "nan-batch",
    "shape-churn", "overload", "flap",
)

_role = ""
_role_lock = threading.Lock()

# (env string, [FaultSpec]) parse cache: re-reads the env var on every
# build call so tests can monkeypatch it, but parses only on change
_cache = ("", [])
_cache_lock = threading.Lock()


def set_role(role):
    """Declare this process's role for spec matching; call from role
    entry points before any channel/server is built."""
    global _role
    with _role_lock:
        _role = role or ""


def current_role():
    return _role


class FaultSpec:
    """One parsed spec with its deterministic firing schedule."""

    def __init__(self, role_pat, method_pat, kind, rate, seed=0):
        if kind not in KINDS:
            raise ValueError("unknown fault kind %r" % kind)
        self.role_pat = role_pat
        self.method_pat = method_pat
        self.kind = kind
        self.rate = float(rate)
        self.seed = int(seed)
        self._lock = threading.Lock()
        self._calls = 0
        # matching calls whose action was not None
        self.fired = 0
        self._fired_kill = False
        import random

        self._rng = random.Random(self.seed)

    @classmethod
    def parse(cls, text):
        parts = text.strip().split(":")
        if len(parts) not in (4, 5):
            raise ValueError(
                "bad fault spec %r (want role:method:kind:rate[:seed])"
                % text
            )
        return cls(*parts)

    def matches(self, role, method):
        return fnmatch.fnmatch(role, self.role_pat) and fnmatch.fnmatch(
            method, self.method_pat
        )

    def fire(self):
        """Advance this spec's schedule by one matching call; returns
        the action to apply now: None | "unavailable" | "deadline" |
        ("delay", secs) | "kill"."""
        action = self._next_action()
        if action is not None:
            with self._lock:
                self.fired += 1
        return action

    def _next_action(self):
        with self._lock:
            self._calls += 1
            calls = self._calls
            if self.kind == "delay":
                return ("delay", self.rate)
            if self.kind == "kill-once":
                nth = max(1, int(self.rate))
                if calls == nth and not self._fired_kill:
                    self._fired_kill = True
                    return "kill"
                return None
            if self.kind == "nan-batch":
                # deterministic numerics fault: poison the
                # rate-th matching train batch, once per process —
                # kill-once semantics, applied to data instead of the
                # process
                nth = max(1, int(self.rate))
                if calls == nth and not self._fired_kill:
                    self._fired_kill = True
                    return "poison"
                return None
            if self.kind == "overload":
                # server-side apply-path latency: consumed
                # only by apply_delay, never by the interceptors. The
                # seed field, meaningless for a non-random schedule,
                # doubles as an optional call-count bound so a bench
                # can script "slow for the first N applies, then
                # healthy again" in one spec.
                if self.seed > 0 and calls > self.seed:
                    return None
                return ("overload", self.rate)
            if self.kind == "flap":
                # periodic UNAVAILABLE windows of int(rate) calls,
                # first window failing: calls 1..N fail, N+1..2N pass,
                # and so on — deterministic, so breaker-cycle tests
                # can assert exact transition counts
                period = max(1, int(self.rate))
                if ((calls - 1) // period) % 2 == 0:
                    return "unavailable"
                return None
            if self.kind == "shape-churn":
                # deterministic shape fault: the first
                # int(rate) matching batches each lose a DIFFERENT
                # number of trailing rows (call 1 loses 1, call 2
                # loses 2, ...) — every churned batch is a fresh
                # shape to compile: the recompile storm the sentinel
                # exists to catch
                if calls <= max(1, int(self.rate)):
                    return ("churn", calls)
                return None
            # unavailable / deadline
            if self.rate >= 1.0:
                return self.kind if calls <= int(self.rate) else None
            return self.kind if self._rng.random() < self.rate else None

    def describe(self):
        return "%s:%s:%s:%g:%d" % (
            self.role_pat, self.method_pat, self.kind, self.rate,
            self.seed,
        )


def _specs():
    """Parsed specs for the current env value (cached per value)."""
    global _cache
    raw = env_str(FAULT_SPEC_ENV, "")
    with _cache_lock:
        if raw == _cache[0]:
            return _cache[1]
        specs = []
        for chunk in raw.split(";"):
            chunk = chunk.strip()
            if not chunk:
                continue
            try:
                specs.append(FaultSpec.parse(chunk))
            except ValueError as e:
                logger.warning("ignoring bad fault spec: %s", e)
        if specs:
            logger.warning(
                "FAULT INJECTION ARMED (%s): %s", FAULT_SPEC_ENV,
                ", ".join(s.describe() for s in specs),
            )
        _cache = (raw, specs)
        return specs


def enabled():
    return bool(_specs())


def _reset_for_tests():
    global _cache, _role
    with _cache_lock:
        _cache = ("", [])
    _role = ""


def _bare_method(full_method):
    # "/elasticdl_tpu.Master/get_task" -> "get_task"
    return full_method.rsplit("/", 1)[-1]


def _kill_self(method):
    logger.warning("fault injection: SIGKILL self on %s", method)
    # stderr may be buffered; the log line above is best-effort only
    os.kill(os.getpid(), signal.SIGKILL)


class FaultInjectedError(grpc.RpcError):
    """Client-side injected failure; quacks like a real RpcError for
    every caller in this repo (code()/details())."""

    def __init__(self, code, method):
        super().__init__()
        self._code = code
        self._method = method

    def code(self):
        return self._code

    def details(self):
        return "injected fault on %s" % self._method

    def __str__(self):
        return "FaultInjectedError(%s, %s)" % (self._code, self._method)


_STATUS = {
    "unavailable": grpc.StatusCode.UNAVAILABLE,
    "deadline": grpc.StatusCode.DEADLINE_EXCEEDED,
}


class _FaultServerInterceptor(grpc.ServerInterceptor):
    """Wraps matching unary-unary handlers; the wrapped behavior runs
    the spec schedule before delegating."""

    def __init__(self, specs):
        self._specs = specs

    def intercept_service(self, continuation, handler_call_details):
        handler = continuation(handler_call_details)
        if handler is None or not handler.unary_unary:
            return handler
        method = _bare_method(handler_call_details.method)
        # overload specs are consumed exclusively by apply_delay inside
        # the PS apply path; matching them here too would double-advance
        # their schedule (and sleep in the handler, where no backlog
        # can build)
        specs = [
            s for s in self._specs
            if s.kind != "overload" and s.matches(current_role(), method)
        ]
        if not specs:
            return handler
        inner = handler.unary_unary

        def faulted(request, context):
            for spec in specs:
                action = spec.fire()
                if action is None:
                    continue
                logger.warning(
                    "fault injection: %s fired on %s (%s, fire %d)",
                    action if isinstance(action, str) else action[0],
                    method, spec.describe(), spec.fired,
                )
                if action == "kill":
                    _kill_self(method)
                elif isinstance(action, tuple):  # ("delay", secs)
                    time.sleep(action[1])
                elif action in _STATUS:
                    context.abort(
                        _STATUS[action], "injected fault on %s" % method
                    )
                # "poison" (nan-batch) is a data-plane action: it only
                # means something at maybe_poison_batch call sites
            return inner(request, context)

        return grpc.unary_unary_rpc_method_handler(
            faulted,
            request_deserializer=handler.request_deserializer,
            response_serializer=handler.response_serializer,
        )


class _FaultClientInterceptor(grpc.UnaryUnaryClientInterceptor):
    def __init__(self, specs):
        self._specs = specs

    def intercept_unary_unary(self, continuation, client_call_details,
                              request):
        method = _bare_method(client_call_details.method)
        for spec in self._specs:
            if spec.kind == "overload":
                continue  # server-apply-path only; see apply_delay
            if not spec.matches(current_role(), method):
                continue
            action = spec.fire()
            if action is None:
                continue
            if action == "kill":
                _kill_self(method)
            elif isinstance(action, tuple):
                time.sleep(action[1])
            elif action in _STATUS:
                raise FaultInjectedError(_STATUS[action], method)
        return continuation(client_call_details, request)


def server_interceptors():
    """() when EDL_FAULT_SPEC is unset — build_server's call path is
    then byte-identical to an uninstrumented server. Overload specs
    are apply-path faults (consumed by ``apply_delay``, never by an
    interceptor): a spec set that is ALL overload builds no
    interceptor either."""
    specs = [s for s in _specs() if s.kind != "overload"]
    if not specs:
        return ()
    return (_FaultServerInterceptor(specs),)


def intercept_client_channel(channel):
    """The channel itself when EDL_FAULT_SPEC is unset (or all specs
    are apply-path overload kinds); a fault-intercepted wrapper
    otherwise."""
    specs = [s for s in _specs() if s.kind != "overload"]
    if not specs:
        return channel
    return grpc.intercept_channel(channel, _FaultClientInterceptor(specs))


def apply_delay(method="push_gradients"):
    """Seconds of injected apply-path latency for one call — the
    server-side ``overload`` kind.

    Consulted by the PS INSIDE its gradient-apply path, after the
    request has been admitted, rather than at the interceptor: the
    latency then occupies a real apply slot, so pending-apply depth
    genuinely builds and admission control rejects for the same reason
    it would in production — backlog — not because a status code was
    conjured at the boundary.

    Provably inert unset: one ``_specs()`` cache check, returns 0.0."""
    specs = _specs()
    if not specs:
        return 0.0
    delay = 0.0
    for spec in specs:
        if spec.kind != "overload":
            continue
        if not spec.matches(current_role(), method):
            continue
        action = spec.fire()
        if isinstance(action, tuple) and action[0] == "overload":
            delay = max(delay, action[1])
    return delay


def _churn_batch(batch, drop_rows):
    """Truncate ``drop_rows`` trailing rows off every batch-leading
    array (features, labels, mask) — the deterministic stand-in for
    "somebody turned padding off mid-run"."""
    import numpy as np

    raw = batch.get("features")
    leaves = raw.values() if isinstance(raw, dict) else (raw,)
    sizes = [
        np.asarray(leaf).shape[0]
        for leaf in leaves
        if getattr(np.asarray(leaf), "ndim", 0)
    ]
    if not sizes:
        return batch
    batch_size = max(sizes)
    if batch_size <= drop_rows:
        logger.warning(
            "shape-churn fired but the batch has only %d rows "
            "(wanted to drop %d); leaving it alone",
            batch_size, drop_rows,
        )
        return batch
    keep = batch_size - drop_rows

    def cut(value):
        arr = np.asarray(value)
        if arr.ndim and arr.shape[0] == batch_size:
            return arr[:keep]
        return value

    out = {}
    for key, value in batch.items():
        if isinstance(value, dict):
            out[key] = {k: cut(v) for k, v in value.items()}
        else:
            out[key] = cut(value)
    logger.warning(
        "fault injection: shape-churn truncated batch %d -> %d rows",
        batch_size, keep,
    )
    return out


def maybe_poison_batch(batch, method="train_step"):
    """Deterministic data-plane injection, applied right before the
    train step. Two kinds:

    - ``nan-batch``: every float feature of this batch is
      replaced with NaN — the forward pass then yields a nonfinite
      loss/gradients, exactly the corruption the health sentinels
      exist to catch. Shapes and dtypes — and so the compiled step —
      never change.
    - ``shape-churn``: the batch loses its trailing rows
      (the padding the pipeline added to keep shapes stable), a
      DIFFERENT count per firing — every churned batch hands the step
      a shape it has never seen, which is the recompile storm the
      device-runtime sentinel exists to catch. Numerics untouched.

    Provably inert unset: one ``_specs()`` cache check, the batch
    object returned as-is."""
    specs = _specs()
    if not specs:
        return batch
    fired = False
    churn_rows = 0
    for spec in specs:
        if spec.kind not in ("nan-batch", "shape-churn"):
            continue
        if not spec.matches(current_role(), method):
            continue
        action = spec.fire()
        if action == "poison":
            fired = True
        elif isinstance(action, tuple) and action[0] == "churn":
            churn_rows = max(churn_rows, action[1])
    if churn_rows:
        batch = _churn_batch(batch, churn_rows)
    if not fired:
        return batch
    import numpy as np

    raw = batch.get("features")
    poisoned = []
    if isinstance(raw, dict):
        features = dict(raw)
        for key in sorted(features):
            arr = np.asarray(features[key])
            if arr.dtype.kind == "f":
                features[key] = np.full_like(arr, np.nan)
                poisoned.append(key)
    else:
        # single-input models carry features as one bare array
        features = raw
        arr = np.asarray(raw)
        if arr.dtype.kind == "f":
            features = np.full_like(arr, np.nan)
            poisoned.append("features")
    if not poisoned:
        shape = (
            sorted(raw) if isinstance(raw, dict)
            else "array%r" % (getattr(raw, "shape", None),)
        )
        logger.warning(
            "nan-batch fired but the batch has no float features to "
            "poison (features: %s)", shape,
        )
        return batch
    logger.warning(
        "fault injection: poisoned batch features %s with NaN",
        poisoned,
    )
    out = dict(batch)
    out["features"] = features
    return out

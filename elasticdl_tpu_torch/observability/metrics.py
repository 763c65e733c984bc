"""Thread-safe metrics core with Prometheus text exposition.

(Copy of elasticdl_tpu/observability/metrics.py for the PyTorch port.)

Pure stdlib (no prometheus_client): a process-global ``Registry`` of
``Counter`` / ``Gauge`` / ``Histogram`` instruments with label support,
rendered in Prometheus text format 0.0.4 by
``observability/http_server.py``.

Hot-path discipline: collection is OFF unless requested — on when
``EDL_METRICS`` is set nonzero or an exposition port
(``EDL_METRICS_PORT``/``--metrics_port``) is configured, and
``EDL_METRICS=0`` forces off. Disabled, every constructor returns a
shared no-op instrument whose ``inc``/``set``/``observe``/``labels``
are empty methods — instrumented code pays one attribute call and
nothing else, and the registry renders empty (see
``metrics_enabled``). The knob must be in the environment before the
first instrument is constructed: role entry points publish
``--metrics_port`` into ``EDL_METRICS_PORT`` first thing for exactly
this reason.
"""

import threading
import time
from elasticdl_tpu_torch.common.env_utils import env_int, env_str

ENABLE_ENV = "EDL_METRICS"
PORT_ENV = "EDL_METRICS_PORT"
EXEMPLARS_ENV = "EDL_METRICS_EXEMPLARS"

# a histogram series' exemplar is the SLOWEST recent observation that
# happened inside a sampled trace; "recent" is this window — past it
# any traced observation replaces the stale exemplar, so the linked
# trace_id always points at a trace an operator can still find
EXEMPLAR_WINDOW_SECS = 60.0

# exponential latency buckets (seconds), prometheus client defaults —
# spans sub-ms in-process RPCs up to the 120 s PS retry budget
DEFAULT_LATENCY_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0,
)

_INF = float("inf")


def metrics_enabled():
    """Metrics collection master switch.

    On when EDL_METRICS is set nonzero, or implicitly when an
    exposition port (EDL_METRICS_PORT) is configured; EDL_METRICS=0
    forces off. With neither knob the registry is the shared no-op —
    instrumented hot paths pay a single empty method call, which is
    what keeps benchmark step time identical to the uninstrumented
    build."""
    flag = env_str(ENABLE_ENV, "")
    if flag == "0":
        return False
    if flag:
        return True
    return env_int(PORT_ENV, 0) > 0


def _escape_label_value(value):
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def _format_labels(labelnames, labelvalues, extra=()):
    pairs = [
        '%s="%s"' % (n, _escape_label_value(v))
        for n, v in zip(labelnames, labelvalues)
    ]
    pairs.extend('%s="%s"' % (n, _escape_label_value(v)) for n, v in extra)
    return "{%s}" % ",".join(pairs) if pairs else ""


def _format_value(value):
    if value != value:  # NaN (the render path's own substitute for a
        return "NaN"    # failing callback gauge must itself render)
    if value == _INF:
        return "+Inf"
    if value == -_INF:
        return "-Inf"
    if value == int(value):
        return str(int(value))
    return repr(float(value))


class _NoopInstrument:
    """Shared do-nothing stand-in for every instrument type."""

    def labels(self, *values, **kv):
        return self

    def inc(self, amount=1):
        pass

    def dec(self, amount=1):
        pass

    def set(self, value):
        pass

    def set_function(self, fn):
        pass

    def observe(self, value):
        pass

    def get(self, *labelvalues):
        return 0.0


NOOP = _NoopInstrument()


def _label_key(name, labelnames, values, kv):
    """Validated labelvalues tuple from positional or keyword form."""
    if kv:
        if values or set(kv) != set(labelnames):
            raise ValueError(
                "%s expects labels %r, got %r"
                % (name, labelnames, tuple(kv))
            )
        values = tuple(kv[n] for n in labelnames)
    elif len(values) != len(labelnames):
        raise ValueError(
            "%s expects labels %r, got %r" % (name, labelnames, values)
        )
    return tuple(str(v) for v in values)


class _Child:
    """One labeled series of a Counter/Gauge."""

    __slots__ = ("_metric", "_key")

    def __init__(self, metric, key):
        self._metric = metric
        self._key = key

    def inc(self, amount=1):
        self._metric._add(self._key, amount)

    def dec(self, amount=1):
        self._metric._add(self._key, -amount)

    def set(self, value):
        self._metric._set(self._key, value)

    def set_function(self, fn):
        self._metric._set_function(self._key, fn)


class _Metric:
    kind = "untyped"

    def __init__(self, name, help_text, labelnames=()):
        self.name = name
        self.help = help_text
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._values = {}     # labelvalues tuple -> float
        self._functions = {}  # labelvalues tuple -> callable

    def labels(self, *values, **kv):
        key = _label_key(self.name, self.labelnames, values, kv)
        with self._lock:
            # touch so the series is exposed at zero before first use
            self._values.setdefault(key, 0.0)
        return _Child(self, key)

    # unlabeled conveniences ------------------------------------------
    def inc(self, amount=1):
        self._add((), amount)

    def dec(self, amount=1):
        self._add((), -amount)

    def set(self, value):
        self._set((), value)

    def set_function(self, fn):
        self._set_function((), fn)

    def get(self, *labelvalues):
        key = tuple(str(v) for v in labelvalues)
        with self._lock:
            fn = self._functions.get(key)
            if fn is not None:
                return float(fn())
            return self._values.get(key, 0.0)

    # internals --------------------------------------------------------
    def _add(self, key, amount):
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def _set(self, key, value):
        with self._lock:
            self._values[key] = float(value)

    def _set_function(self, key, fn):
        with self._lock:
            self._values.setdefault(key, 0.0)
            self._functions[key] = fn

    def render(self):
        lines = [
            "# HELP %s %s" % (self.name, self.help),
            "# TYPE %s %s" % (self.name, self.kind),
        ]
        with self._lock:
            snapshot = dict(self._values)
            functions = dict(self._functions)
        for key, fn in functions.items():
            try:
                snapshot[key] = float(fn())
            except Exception as e:  # pragma: no cover - defensive
                # a broken callback gauge must not take /metrics down
                snapshot[key] = float("nan")
                _logger().warning(
                    "callback gauge %s%r failed: %s", self.name, key, e
                )
        for key in sorted(snapshot):
            lines.append(
                "%s%s %s"
                % (
                    self.name,
                    _format_labels(self.labelnames, key),
                    _format_value(snapshot[key]),
                )
            )
        return lines


class Counter(_Metric):
    kind = "counter"

    def dec(self, amount=1):
        raise TypeError("counters only go up")

    def _add(self, key, amount):
        if amount < 0:
            raise ValueError("counters only go up")
        _Metric._add(self, key, amount)


class Gauge(_Metric):
    kind = "gauge"


class _HistogramChild:
    __slots__ = ("_metric", "_key")

    def __init__(self, metric, key):
        self._metric = metric
        self._key = key

    def observe(self, value):
        self._metric._observe(self._key, value)


class Histogram:
    """Fixed-bucket histogram (cumulative counts, Prometheus shape)."""

    kind = "histogram"

    def __init__(
        self, name, help_text, labelnames=(),
        buckets=DEFAULT_LATENCY_BUCKETS,
    ):
        self.name = name
        self.help = help_text
        self.labelnames = tuple(labelnames)
        self.buckets = tuple(sorted(float(b) for b in buckets)) + (_INF,)
        self._lock = threading.Lock()
        # labelvalues tuple -> [per-bucket counts, sum, count]
        self._series = {}
        # labelvalues tuple -> (value, trace_id, unix ts): the slowest
        # recent observation made under a sampled span context
        self._exemplars = {}

    def labels(self, *values, **kv):
        key = _label_key(self.name, self.labelnames, values, kv)
        with self._lock:
            self._touch_locked(key)
        return _HistogramChild(self, key)

    def observe(self, value):
        self._observe((), value)

    def get_count(self, *labelvalues):
        key = tuple(str(v) for v in labelvalues)
        with self._lock:
            series = self._series.get(key)
            return int(series[2]) if series else 0

    def _touch_locked(self, key):
        if key not in self._series:
            self._series[key] = [[0] * len(self.buckets), 0.0, 0]
        return self._series[key]

    def _observe(self, key, value):
        value = float(value)
        # exemplar candidacy costs one thread-local read when no trace
        # is active (the overwhelmingly common case)
        ctx = _trace_context()
        with self._lock:
            counts, _sum, _n = series = self._touch_locked(key)
            for i, bound in enumerate(self.buckets):
                if value <= bound:
                    counts[i] += 1
            series[1] = _sum + value
            series[2] = _n + 1
            if ctx is not None and ctx.sampled:
                now = time.time()
                exemplar = self._exemplars.get(key)
                if (
                    exemplar is None
                    or value >= exemplar[0]
                    or now - exemplar[2] > EXEMPLAR_WINDOW_SECS
                ):
                    self._exemplars[key] = (value, ctx.trace_id, now)

    def render(self, exemplars=False):
        """Prometheus 0.0.4 lines; with ``exemplars`` each series'
        exemplar rides its bucket line in OpenMetrics syntax
        (``... # {trace_id="..."} value ts``). Exemplars are OFF on the
        default path on purpose: the ``#`` suffix is an OpenMetrics
        construct some 0.0.4 consumers reject, so only the
        content-negotiated/env-gated exposition carries them."""
        lines = [
            "# HELP %s %s" % (self.name, self.help),
            "# TYPE %s histogram" % self.name,
        ]
        with self._lock:
            snapshot = {
                key: (list(counts), s, n)
                for key, (counts, s, n) in self._series.items()
            }
            exemplar_snapshot = dict(self._exemplars) if exemplars else {}
        for key in sorted(snapshot):
            counts, total, n = snapshot[key]
            exemplar = exemplar_snapshot.get(key)
            for bound, count in zip(self.buckets, counts):
                line = "%s_bucket%s %d" % (
                    self.name,
                    _format_labels(
                        self.labelnames, key,
                        extra=(("le", _format_value(bound)),),
                    ),
                    count,
                )
                # the exemplar attaches to the FIRST bucket containing
                # its value (OpenMetrics: an exemplar must lie within
                # its bucket's range)
                if exemplar is not None and exemplar[0] <= bound:
                    line += ' # {trace_id="%s"} %s %.3f' % (
                        exemplar[1],
                        _format_value(exemplar[0]),
                        exemplar[2],
                    )
                    exemplar = None
                lines.append(line)
            labels = _format_labels(self.labelnames, key)
            lines.append("%s_sum%s %s" % (self.name, labels,
                                          _format_value(total)))
            lines.append("%s_count%s %d" % (self.name, labels, n))
        return lines


class Registry:
    """Named instrument collection; get-or-create semantics so wiring
    code can declare its instruments idempotently (roles are
    constructed repeatedly inside one test process)."""

    def __init__(self, enabled=None):
        if enabled is None:
            enabled = metrics_enabled()
        self.enabled = enabled
        self._lock = threading.Lock()
        self._metrics = {}  # name -> instrument

    def _get_or_create(self, cls, name, help_text, labelnames, **kwargs):
        if not self.enabled:
            return NOOP
        with self._lock:
            metric = self._metrics.get(name)
            if metric is None:
                metric = cls(name, help_text, labelnames, **kwargs)
                self._metrics[name] = metric
            elif tuple(labelnames) != metric.labelnames:
                raise ValueError(
                    "metric %s re-declared with labels %r (was %r)"
                    % (name, tuple(labelnames), metric.labelnames)
                )
            return metric

    def counter(self, name, help_text, labelnames=()):
        return self._get_or_create(Counter, name, help_text, labelnames)

    def gauge(self, name, help_text, labelnames=()):
        return self._get_or_create(Gauge, name, help_text, labelnames)

    def histogram(self, name, help_text, labelnames=(),
                  buckets=DEFAULT_LATENCY_BUCKETS):
        return self._get_or_create(
            Histogram, name, help_text, labelnames, buckets=buckets
        )

    def get(self, name):
        with self._lock:
            return self._metrics.get(name)

    def render(self, exemplars=False):
        """Prometheus text exposition format 0.0.4; ``exemplars=True``
        adds OpenMetrics exemplar suffixes to histogram bucket lines
        (the /metrics content-negotiated path, http_server.py)."""
        with self._lock:
            metrics = sorted(self._metrics.values(), key=lambda m: m.name)
        lines = []
        for metric in metrics:
            if isinstance(metric, Histogram):
                lines.extend(metric.render(exemplars=exemplars))
            else:
                lines.extend(metric.render())
        return "\n".join(lines) + ("\n" if lines else "")


# ---------------------------------------------------------------------------
# process-global default registry

_default_lock = threading.Lock()
_default_registry = None


def default_registry():
    global _default_registry
    with _default_lock:
        if _default_registry is None:
            _default_registry = Registry()
        return _default_registry


def reset_default_registry():
    """Drop the process-global registry so the next use re-evaluates
    the env knobs; tests use it to flip collection on/off within one
    process. (Role entry points don't need it: they publish
    --metrics_port into the environment before the first instrument is
    constructed.)"""
    global _default_registry
    with _default_lock:
        _default_registry = None


def counter(name, help_text, labelnames=()):
    return default_registry().counter(name, help_text, labelnames)


def gauge(name, help_text, labelnames=()):
    return default_registry().gauge(name, help_text, labelnames)


def histogram(name, help_text, labelnames=(),
              buckets=DEFAULT_LATENCY_BUCKETS):
    return default_registry().histogram(
        name, help_text, labelnames, buckets=buckets
    )


class _LazyInstrument:
    """Module-scope instrument declaration whose registry resolution is
    deferred to the first recording call.

    Library modules that role entry points import before ``main()``
    publishes EDL_METRICS_PORT (common.overload via common.grpc_utils,
    observability.device via the trainers) must not touch
    ``default_registry()`` at import time: the registry snapshots
    ``metrics_enabled()`` once, so an import-time construction freezes
    the whole process's /metrics exposition disabled — every role's
    scrape comes back empty. The proxy keeps the declaration at module
    scope (obs-hot-path: no per-call construction) while resolving the
    real instrument on first use, after the role has set its env."""

    __slots__ = ("_factory", "_real")

    def __init__(self, factory):
        self._factory = factory
        self._real = None

    def _resolve(self):
        real = self._real
        if real is None:
            real = self._real = self._factory()
        return real

    def labels(self, *values, **kv):
        return self._resolve().labels(*values, **kv)

    def inc(self, amount=1):
        self._resolve().inc(amount)

    def dec(self, amount=1):
        self._resolve().dec(amount)

    def set(self, value):
        self._resolve().set(value)

    def set_function(self, fn):
        self._resolve().set_function(fn)

    def observe(self, value):
        self._resolve().observe(value)

    def get(self, *labelvalues):
        return self._resolve().get(*labelvalues)


def lazy_counter(name, help_text, labelnames=()):
    return _LazyInstrument(lambda: counter(name, help_text, labelnames))


def lazy_gauge(name, help_text, labelnames=()):
    return _LazyInstrument(lambda: gauge(name, help_text, labelnames))


def lazy_histogram(name, help_text, labelnames=(),
                   buckets=DEFAULT_LATENCY_BUCKETS):
    return _LazyInstrument(
        lambda: histogram(name, help_text, labelnames, buckets=buckets)
    )


def _logger():
    from elasticdl_tpu_torch.common.log_utils import default_logger

    return default_logger("elasticdl_tpu_torch.observability.metrics")


# trace.current_context bound once on first observation: metrics must
# stay importable before (and without) the trace module, but the
# per-observe cost must be one global read + the thread-local lookup,
# not import machinery on every histogram observation
_current_context = None


def _trace_context():
    """Active sampled-trace context, for exemplar candidacy."""
    global _current_context
    read = _current_context
    if read is None:
        from elasticdl_tpu_torch.observability import trace

        read = _current_context = trace.current_context
    return read()

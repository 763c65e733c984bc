"""Continuous profiling: an always-on sampling stack profiler per role.

(Copy of elasticdl_tpu/observability/profiler.py for the PyTorch port.)

The fourth observability pillar (after metrics, the flight recorder,
and distributed tracing): when ``scripts/critical_path.py`` says a step
spent 40% of its time in ``apply`` or ``other``, this module answers
*which Python frames* burned it — without hand-instrumenting suspects.

A single daemon thread walks ``sys._current_frames()`` at
``EDL_PROF_HZ`` and aggregates each thread's stack into collapsed form
(root-first ``module:function`` frames). Aggregates live in a bounded
ring of time buckets, so memory stays constant no matter how long the
role runs or how much the code paths churn:

- one in-progress bucket aggregates the last ``_BUCKET_SECS`` of
  samples; full buckets rotate into a ``deque`` bounded to
  ``EDL_PROF_RING_SECS`` worth of history;
- each bucket holds at most ``EDL_PROF_MAX_STACKS`` distinct collapsed
  stacks — overflow samples land in a counted ``(overflow)`` entry
  instead of growing the dict (zero heap growth under stack churn).

**Span correlation.** A sample landing while a *sampled* trace span is
open on that thread (``observability/trace.py`` publishes the
innermost open *mapped* span per thread while the profiler is
attached) is tagged with the span's ``trace_id`` and the critical-path
segment its span name maps to (``train_batch`` → ``compute``,
``ps_apply_push`` → ``apply``, ...). Spans whose names map to no
segment (``rpc_attempt``, ``ps_apply_round``, future names) do not
publish: their samples keep the nearest mapped ancestor's tag, exactly
mirroring how ``scripts/critical_path.py`` attributes an unmapped
span's self time to its nearest mapped ancestor's segment.
``critical_path.py --frames`` then breaks its per-segment attribution
down into the top frame stacks that actually ran inside each segment.

**Exposure.** Every role's HTTP daemon serves the sampler as
``GET /profilez`` (observability/http_server.py):

- no query → the rolling ring snapshot (the last ``EDL_PROF_RING_SECS``
  of aggregated stacks);
- ``?seconds=N`` → an on-demand window capture: only samples landing
  during the next N seconds (capped at ``_MAX_CAPTURE_SECS``);
- ``&format=collapsed`` → flamegraph-ready collapsed text
  (``frame;frame;... count`` lines, segment folded in as a leading
  ``[segment]`` frame) instead of the default JSON.

**Inert when disabled.** With ``EDL_PROF_HZ`` unset/0 (the default)
``maybe_start`` returns None without constructing anything: no thread,
no trace hook, and ``/profilez`` answers 404. The sampler skips its own
thread (and capture threads while they sleep), so the profiler never
profiles itself.

**Overhead contract.** At the default 29 Hz the measured steps/s cost
on the deepfm local-executor bench must stay within 3%
(``scripts/bench_profiler_overhead.py``, gated in CI tier 1f). 29 is
deliberately not a divisor of common 10/50/100 ms periods, so the
sampler does not alias against periodic work. The sampler exports its
own cost as ``edl_prof_overhead_ratio`` (fraction of wall time spent
walking stacks) next to ``edl_prof_samples_total``.
"""

import collections
import os
import sys
import threading
import time

from elasticdl_tpu_torch.common.env_utils import env_float, env_int
from elasticdl_tpu_torch.common.log_utils import (
    default_logger as _logger_factory,
)
from elasticdl_tpu_torch.observability import events
from elasticdl_tpu_torch.observability import metrics as metrics_mod
from elasticdl_tpu_torch.observability import trace

logger = _logger_factory("elasticdl_tpu_torch.observability.profiler")

HZ_ENV = "EDL_PROF_HZ"
RING_SECS_ENV = "EDL_PROF_RING_SECS"
MAX_STACKS_ENV = "EDL_PROF_MAX_STACKS"

DEFAULT_HZ = 29.0  # documented default; see module docstring
DEFAULT_RING_SECS = 120.0
DEFAULT_MAX_STACKS = 512

_BUCKET_SECS = 5.0
_MAX_DEPTH = 64
_MAX_CAPTURE_SECS = 60.0
OVERFLOW_STACK = ("(overflow)",)

# span name -> critical-path segment, mirroring the exact-name map in
# scripts/critical_path.py (segment_of) so a tagged sample lands in the
# same bucket the trace's self-time attribution lands in
_SEGMENT_BY_SPAN = {
    "train_batch": "compute",
    "serve_batch_run": "compute",
    "dispatch": "queue_wait",
    "serve_predict": "queue_wait",
    "ps_pull": "pull",
    "ps_pull_batch": "pull",
    "ps_push": "push",
    "ps_push_rows": "push",
    "ps_apply_push": "apply",
    # device runtime: the recompile sentinel's compile
    # spans and explicit host<->device transfer spans
    "compile": "compile",
    "transfer": "transfer",
}


def segment_of_span(name):
    """Critical-path segment for an open span name. Never None —
    ``other`` for unmapped names; note unmapped names never PUBLISH
    (``_mapped_span``), so ``other`` tags only reach samples via an
    unmapped root, same as critical_path's root attribution."""
    seg = _SEGMENT_BY_SPAN.get(name)
    if seg is not None:
        return seg
    if name.startswith("Pserver/pull"):
        return "pull"
    if name.startswith("Pserver/push"):
        return "apply"
    if name.startswith("Master/"):
        return "queue_wait"
    return "other"


def configured_hz():
    """Sampling rate from EDL_PROF_HZ; 0 (disabled) when unset, empty,
    non-positive, or non-numeric."""
    hz = env_float(HZ_ENV, 0.0)
    return hz if hz > 0 else 0.0


class _Agg:
    """One bounded aggregation bucket: collapsed stack -> tally.

    ``stacks`` maps ``(segment, stack_tuple)`` to ``[count,
    last_trace_id]`` — the trace_id is an exemplar (the most recent
    sampled trace that ran this stack), not a per-sample record, which
    is what keeps aggregation O(distinct stacks) instead of O(samples).
    """

    __slots__ = ("stacks", "samples", "overflow", "started")

    def __init__(self):
        self.stacks = {}
        self.samples = 0
        self.overflow = 0
        self.started = time.time()

    def add(self, key, trace_id, max_stacks):
        self.samples += 1
        entry = self.stacks.get(key)
        if entry is not None:
            entry[0] += 1
            if trace_id is not None:
                entry[1] = trace_id
        elif len(self.stacks) < max_stacks:
            self.stacks[key] = [1, trace_id]
        else:
            # bounded under churn: past the cap, samples still count
            # but land in one shared overflow entry
            self.overflow += 1


class StackSampler:
    """Daemon-thread sampling profiler for one role's process."""

    def __init__(self, role, hz, ring_secs=None, max_stacks=None,
                 registry=None):
        self.role = role
        self.hz = float(hz)
        if ring_secs is None:
            ring_secs = env_float(RING_SECS_ENV, DEFAULT_RING_SECS)
        if max_stacks is None:
            max_stacks = env_int(MAX_STACKS_ENV, DEFAULT_MAX_STACKS)
        self.ring_secs = float(ring_secs)
        self.max_stacks = max(1, int(max_stacks))
        buckets = max(1, int(round(self.ring_secs / _BUCKET_SECS)))
        self._ring = collections.deque(maxlen=buckets)
        self._current = _Agg()
        self._captures = []  # window-capture buckets being fed live
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = None
        # thread idents never sampled: the sampler itself, plus any
        # thread currently sleeping inside capture() — the profiler
        # must not profile itself
        self._skip = set()
        self._walk_secs = 0.0
        self._started_at = None
        self._stopped_at = None
        registry = registry or metrics_mod.default_registry()
        self._samples_metric = registry.counter(
            "edl_prof_samples_total",
            "stack samples taken by the continuous profiler",
            ("role",),
        ).labels(role=role)
        self._overhead_gauge = registry.gauge(
            "edl_prof_overhead_ratio",
            "fraction of wall time the profiler spends walking stacks",
            ("role",),
        ).labels(role=role)
        self._overhead_gauge.set_function(self.overhead_ratio)

    # ------------------------------------------------------------------
    @staticmethod
    def _mapped_span(name):
        """Publication predicate for trace.py: only span names that map
        to a real segment publish; an unmapped nested span (rpc_attempt,
        ps_apply_round) keeps its enclosing span's publication, so its
        samples inherit the ancestor's segment exactly the way
        critical_path.py inherits its self time."""
        return segment_of_span(name) != "other"

    def start(self):
        self._started_at = time.monotonic()
        self._stopped_at = None
        self._overhead_gauge.set_function(self.overhead_ratio)
        self._thread = threading.Thread(
            target=self._run,
            name="edl-prof-%s" % self.role,
            daemon=True,
        )
        self._thread.start()
        # from here on, span enter/exit publishes the innermost open
        # MAPPED sampled span per thread for the sampler to read
        trace._profiler_attach(self._mapped_span)
        logger.info(
            "continuous profiler on: %s at %.1f Hz (ring %ds, "
            "max %d stacks/bucket)",
            self.role, self.hz, int(self.ring_secs), self.max_stacks,
        )
        return self

    def stop(self):
        self._stop.set()
        thread = self._thread
        if thread is not None:
            thread.join(timeout=2.0)
            self._thread = None
        trace._profiler_detach()
        self._stopped_at = time.monotonic()
        # freeze the exported ratio at its final running value and drop
        # the gauge's reference to this sampler: a stopped sampler must
        # neither read as a silently-decaying live ratio nor pin its
        # ring in memory for the rest of the process
        final = self.overhead_ratio()
        self._overhead_gauge.set_function(lambda final=final: final)

    def running(self):
        thread = self._thread
        return thread is not None and thread.is_alive()

    def overhead_ratio(self):
        """Measured duty cycle: seconds spent walking stacks over wall
        seconds while RUNNING (the clock stops with the sampler). The
        self-reported half of the <=3% contract (the other half is the
        A/B bench)."""
        if self._started_at is None:
            return 0.0
        end = self._stopped_at
        if end is None:
            end = time.monotonic()
        wall = end - self._started_at
        if wall <= 0:
            return 0.0
        with self._lock:
            walk = self._walk_secs
        return walk / wall

    # ------------------------------------------------------------------
    def _run(self):
        self._skip.add(threading.get_ident())
        interval = 1.0 / self.hz
        next_at = time.monotonic() + interval
        while not self._stop.wait(max(0.0, next_at - time.monotonic())):
            next_at += interval
            now = time.monotonic()
            if next_at < now:
                # fell behind (suspend/GIL stall): re-anchor instead of
                # bursting to catch up
                next_at = now + interval
            t0 = time.perf_counter()
            try:
                self._sample_once()
            except Exception as e:
                # a torn frame walk must never kill the sampler; one
                # missed tick is noise
                logger.warning("profiler sample failed: %s", e)
            walked = time.perf_counter() - t0
            with self._lock:
                self._walk_secs += walked

    def _sample_once(self):
        frames = sys._current_frames()
        spans = trace.profiled_spans()
        tallies = []
        for ident, frame in frames.items():
            if ident in self._skip:
                continue
            stack = self._collapse(frame)
            if not stack:
                continue
            published = spans.get(ident)
            if published is not None:
                trace_id, span_name = published
                key = (segment_of_span(span_name), stack)
            else:
                trace_id = None
                key = (None, stack)
            tallies.append((key, trace_id))
        del frames  # drop live-frame refs before taking the lock
        if not tallies:
            return
        with self._lock:
            self._rotate_locked()
            for key, trace_id in tallies:
                self._current.add(key, trace_id, self.max_stacks)
                for capture_agg in self._captures:
                    capture_agg.add(key, trace_id, self.max_stacks)
        self._samples_metric.inc(len(tallies))

    @staticmethod
    def _collapse(frame):
        """Collapsed stack for one thread: root-first
        ``module:function`` tuple, depth-capped at _MAX_DEPTH."""
        parts = []
        depth = 0
        while frame is not None and depth < _MAX_DEPTH:
            code = frame.f_code
            module = frame.f_globals.get("__name__", "?")
            name = getattr(code, "co_qualname", None) or code.co_name
            parts.append("%s:%s" % (module, name))
            frame = frame.f_back
            depth += 1
        parts.reverse()
        return tuple(parts)

    def _rotate_locked(self, now=None):
        if (now or time.time()) - self._current.started >= _BUCKET_SECS:
            if self._current.samples:
                self._ring.append(self._current)
            self._current = _Agg()

    # ------------------------------------------------------------------
    def snapshot(self):
        """The rolling-ring view: every aggregated stack from the last
        ``ring_secs`` (bounded), merged across buckets."""
        with self._lock:
            aggs = list(self._ring) + [self._current]
            merged = {}
            samples = 0
            overflow = 0
            oldest = aggs[0].started if aggs else time.time()
            for agg in aggs:
                samples += agg.samples
                overflow += agg.overflow
                for key, (count, trace_id) in agg.stacks.items():
                    entry = merged.get(key)
                    if entry is None:
                        merged[key] = [count, trace_id]
                    else:
                        entry[0] += count
                        if trace_id is not None:
                            entry[1] = trace_id
        window = max(0.0, time.time() - oldest)
        return self._render(merged, samples, overflow, window)

    def capture(self, seconds):
        """On-demand window capture: only samples landing during the
        next ``seconds`` (capped). Blocks the calling thread — which is
        skipped by the sampler while it sleeps here, so the capture
        never profiles its own wait."""
        seconds = min(max(float(seconds), 0.05), _MAX_CAPTURE_SECS)
        agg = _Agg()
        ident = threading.get_ident()
        own = ident not in self._skip
        if own:
            self._skip.add(ident)
        with self._lock:
            self._captures.append(agg)
        try:
            time.sleep(seconds)
        finally:
            with self._lock:
                self._captures.remove(agg)
            if own:
                self._skip.discard(ident)
        result = self._render(
            agg.stacks, agg.samples, agg.overflow, seconds
        )
        events.emit(
            "profile_captured", seconds=round(seconds, 3),
            samples=agg.samples, stacks=len(agg.stacks),
        )
        return result

    def _render(self, merged, samples, overflow, window_secs):
        stacks = [
            {
                "stack": list(stack),
                "count": entry[0],
                "segment": segment,
                "trace_id": entry[1],
            }
            for (segment, stack), entry in merged.items()
        ]
        stacks.sort(key=lambda s: (-s["count"], s["stack"]))
        return {
            "role": self.role,
            "hz": self.hz,
            "samples": samples,
            "overflow": overflow,
            "window_secs": round(window_secs, 3),
            "stacks": stacks,
        }


def collapsed(snapshot):
    """Flamegraph-ready collapsed text for a snapshot/capture dict:
    one ``frame;frame;... count`` line per aggregated stack, the
    segment (when tagged) folded in as a leading ``[segment]`` frame so
    a flamegraph groups by critical-path segment at the root."""
    lines = []
    for entry in snapshot.get("stacks", ()):
        frames = list(entry["stack"])
        if entry.get("segment"):
            frames.insert(0, "[%s]" % entry["segment"])
        lines.append("%s %d" % (";".join(frames), entry["count"]))
    overflow = snapshot.get("overflow", 0)
    if overflow:
        lines.append("%s %d" % (OVERFLOW_STACK[0], overflow))
    return "\n".join(lines) + ("\n" if lines else "")


# ---------------------------------------------------------------------------
# per-process singleton (the role entry points' single call)

_sampler = None
_sampler_lock = threading.Lock()


def maybe_start(role, registry=None):
    """Start the role's sampler when EDL_PROF_HZ is configured; None
    otherwise — and then PROVABLY inert: nothing constructed, no
    thread, no trace hook (extra calls re-bind the role)."""
    global _sampler
    hz = configured_hz()
    with _sampler_lock:
        if _sampler is not None:
            _sampler.stop()
            _sampler = None
        if hz <= 0:
            return None
        _sampler = StackSampler(role, hz, registry=registry).start()
        sampler_started = _sampler
    events.emit(
        "profiler_started", hz=hz,
        ring_secs=sampler_started.ring_secs,
    )
    return sampler_started


def sampler():
    """The process's live sampler, or None when profiling is off."""
    return _sampler


def enabled():
    return _sampler is not None


def stop():
    """Stop and drop the singleton (drain paths and benches)."""
    global _sampler
    with _sampler_lock:
        if _sampler is not None:
            _sampler.stop()
            _sampler = None


def _reset_for_tests():
    stop()

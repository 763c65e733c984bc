"""Cross-role distributed trace: Chrome trace-event JSON per role,
threaded by a W3C-traceparent-style span context.

(Copy of elasticdl_tpu/observability/trace.py for the PyTorch port.)

``with span("train_batch", task_id=...)`` buffers a complete ("X")
trace event; each role's buffer flushes to
``$EDL_TRACE_DIR/<role>-<pid>.trace.json`` (atomic rename) on a size
threshold, on ``flush()``, and at interpreter exit. Timestamps are
wall-clock microseconds, so per-role files line up on one timeline when
``scripts/merge_trace.py`` merges them.

Two correlation layers stitch the roles together:

- ``task_id`` (thread-local ``task_context``): the coarse key —
  dispatch (master) → pull/train/push (worker) → apply (PS) spans of
  one task share it without parameter plumbing.
- **span context**: a ``trace_id``/``span_id``/``sampled``
  triple carried on a thread-local stack. ``root_span`` opens a trace
  (one per worker train step / serve predict request); nested ``span``
  blocks become children with explicit ``parent_id``; the context
  crosses gRPC hops as ``edl-traceparent`` metadata (W3C traceparent
  format, ``observability/trace_propagation.py`` client-side,
  ``traced_handler`` server-side), so a remote handler's span is a
  child of the exact RPC attempt that reached it.

Sampling (``EDL_TRACE_SAMPLE``):

- unset / ``1`` — every root span starts a sampled trace
  (EDL_TRACE_DIR alone traces everything);
- ``0`` — provably inert: ``root_span`` yields None without touching
  an RNG, no context exists, and ``trace_propagation`` adds NO gRPC
  metadata (the interceptor is not even installed);
- ``0 < p < 1`` — head-based: the root draws once; an unsampled trace
  records nothing anywhere (the ``sampled=0`` flag propagates, so
  remote roles skip their spans too) unless tail-keep retains it.

Tail-keep (``EDL_TRACE_TAIL_KEEP_MS``): with head sampling below 1, an
unsampled root still buffers its LOCAL spans in memory; if the root
runs at least this many milliseconds, the buffer is flushed (root arg
``tail_kept: true``) — the slow outliers survive even at aggressive
sampling rates. Remote children of a tail-kept trace are absent by
construction (the remote saw ``sampled=0`` and recorded nothing).

Disabled (EDL_TRACE_DIR unset) the module is inert: ``span`` costs one
module-global None check.
"""

import atexit
import contextlib
import json
import os
import threading
import time

from elasticdl_tpu_torch.common.env_utils import env_str
from elasticdl_tpu_torch.common.log_utils import (
    default_logger as _logger_factory,
)

logger = _logger_factory("elasticdl_tpu_torch.observability.trace")

TRACE_DIR_ENV = "EDL_TRACE_DIR"
SAMPLE_ENV = "EDL_TRACE_SAMPLE"
TAIL_KEEP_ENV = "EDL_TRACE_TAIL_KEEP_MS"

# gRPC metadata key carrying the serialized span context; the value is
# the W3C traceparent wire format ("00-<trace_id>-<span_id>-<flags>")
# so any standard tracing sidecar can read it off the wire
METADATA_KEY = "edl-traceparent"

_FLUSH_EVERY = 2048  # events buffered before an incremental flush

_writer = None
_writer_lock = threading.Lock()
_tls = threading.local()

# (env string, parsed) caches: re-read the env var on every use so
# tests can monkeypatch it, but parse only on change (faults.py's
# discipline — the hot path pays a dict-free string compare)
_sample_cache = (None, 1.0)
_tail_cache = (None, 0.0)

# sampling decisions only — span/trace ids come from os.urandom so a
# test seeding this RNG for a deterministic sampling schedule cannot
# collide ids across processes
import random as _random_mod  # noqa: E402

_rng = _random_mod.Random()


def sample_rate():
    """Head-sampling probability for new root spans: EDL_TRACE_SAMPLE,
    default 1.0 (EDL_TRACE_DIR alone keeps tracing everything)."""
    global _sample_cache
    raw = env_str(SAMPLE_ENV, "")
    if raw == _sample_cache[0]:
        return _sample_cache[1]
    try:
        rate = float(raw) if raw else 1.0
    except ValueError:
        logger.warning("ignoring non-numeric %s=%r", SAMPLE_ENV, raw)
        rate = 1.0
    _sample_cache = (raw, rate)
    return rate


def tail_keep_ms():
    """Tail-keep threshold (ms): an UNSAMPLED root span at least this
    slow flushes its locally buffered spans anyway. 0 (default) = off."""
    global _tail_cache
    raw = env_str(TAIL_KEEP_ENV, "")
    if raw == _tail_cache[0]:
        return _tail_cache[1]
    try:
        ms = float(raw) if raw else 0.0
    except ValueError:
        logger.warning("ignoring non-numeric %s=%r", TAIL_KEEP_ENV, raw)
        ms = 0.0
    _tail_cache = (raw, ms)
    return ms


class SpanContext:
    """One span's identity within a trace; immutable by convention."""

    __slots__ = ("trace_id", "span_id", "sampled")

    def __init__(self, trace_id, span_id, sampled):
        self.trace_id = trace_id
        self.span_id = span_id
        self.sampled = bool(sampled)

    def child(self):
        return SpanContext(self.trace_id, _new_span_id(), self.sampled)

    def to_traceparent(self):
        return "00-%s-%s-%s" % (
            self.trace_id, self.span_id, "01" if self.sampled else "00"
        )

    def __repr__(self):  # pragma: no cover - debugging aid
        return "SpanContext(%s, %s, sampled=%s)" % (
            self.trace_id, self.span_id, self.sampled
        )


def parse_traceparent(text):
    """SpanContext from a traceparent string; None when malformed (a
    peer speaking a future version or garbage must not break the RPC)."""
    try:
        parts = text.strip().split("-")
        if len(parts) != 4:
            return None
        _version, trace_id, span_id, flags = parts
        if len(trace_id) != 32 or len(span_id) != 16:
            return None
        int(trace_id, 16)
        int(span_id, 16)
        return SpanContext(trace_id, span_id, int(flags, 16) & 1 == 1)
    except (ValueError, AttributeError):
        return None


def extract_context(metadata):
    """SpanContext from gRPC invocation metadata; None when absent."""
    if not metadata:
        return None
    for key, value in metadata:
        if key == METADATA_KEY:
            return parse_traceparent(value)
    return None


class _EntropyPool:
    """Buffered span/trace-id entropy: the
    profiler measured the per-span ``os.urandom`` syscall at ~5-7% of
    traced-run host samples. One 4 KiB refill amortizes the syscall
    over ~512 span ids; ``take`` under the lock is a slice + index
    bump. Fork safety: ``os.register_at_fork`` empties the child's
    buffer, so a forked process can never re-deal its parent's bytes
    (duplicate ids across processes would corrupt trace threading)."""

    __slots__ = ("_lock", "_buf", "_pos", "_size")

    def __init__(self, size=4096):
        self._lock = threading.Lock()
        self._buf = b""
        self._pos = 0
        self._size = int(size)

    def take(self, n):
        with self._lock:
            if self._pos + n > len(self._buf):
                self._buf = os.urandom(self._size)
                self._pos = 0
            out = self._buf[self._pos:self._pos + n]
            self._pos += n
            return out

    def reset(self):
        with self._lock:
            self._buf = b""
            self._pos = 0


_entropy = _EntropyPool()
if hasattr(os, "register_at_fork"):  # pragma: no branch
    os.register_at_fork(after_in_child=_entropy.reset)


def _new_trace_id():
    return _entropy.take(16).hex()


def _new_span_id():
    return _entropy.take(8).hex()


class TraceWriter:
    """Buffers events and APPENDS them to the role file on flush.

    The file is the Chrome trace-event "JSON Array Format": a ``[``
    followed by one event object per line, each with a trailing comma,
    and — per the format spec — the closing ``]`` is optional, so the
    file is Perfetto-loadable at any point, including after a crash
    mid-run. Appending the delta (instead of rewriting the history)
    keeps memory bounded and flush cost O(events since last flush) on
    whatever hot-path thread crossed the buffer threshold; a
    multi-million-step traced job would otherwise hold every event in
    RAM and rewrite the whole file each flush."""

    def __init__(self, role, trace_dir, pid=None):
        self.role = role
        self.dir = trace_dir
        # pid override for tests that emulate several roles in one
        # process (real roles are separate processes)
        self.pid = os.getpid() if pid is None else pid
        self.path = os.path.join(
            trace_dir, "%s-%d.trace.json" % (role, self.pid)
        )
        # RLock: the SIGTERM crash hook (observability/events.py) calls
        # trace.flush() on the main thread, which may have been
        # interrupted inside add()/flush() while holding this lock
        self._lock = threading.RLock()
        self._file_started = False
        self._events = [
            {
                "name": "process_name",
                "ph": "M",
                "pid": self.pid,
                "tid": 0,
                "args": {"name": role},
            }
        ]

    def add(self, event):
        flush_now = False
        with self._lock:
            self._events.append(event)
            flush_now = len(self._events) >= _FLUSH_EVERY
        if flush_now:
            self.flush()

    def add_all(self, events):
        """Batch append (the tail-keep flush path)."""
        flush_now = False
        with self._lock:
            self._events.extend(events)
            flush_now = len(self._events) >= _FLUSH_EVERY
        if flush_now:
            self.flush()

    def flush(self):
        with self._lock:
            events, self._events = self._events, []
        if not events:
            return
        try:
            os.makedirs(self.dir, exist_ok=True)
            with self._lock:  # serialize appends across threads
                with open(self.path, "a", encoding="utf-8") as f:
                    if not self._file_started:
                        f.write("[\n")
                        self._file_started = True
                    f.write(
                        "".join(json.dumps(e) + ",\n" for e in events)
                    )
        except OSError as e:
            logger.warning("trace flush to %s failed: %s", self.path, e)


def configure(role):
    """Install the per-process writer when EDL_TRACE_DIR is set; call
    once from each role's entry point (extra calls re-bind the role).
    Returns the writer or None when tracing is disabled."""
    global _writer
    trace_dir = env_str(TRACE_DIR_ENV, "")
    with _writer_lock:
        if not trace_dir:
            _writer = None
            return None
        _writer = TraceWriter(role, trace_dir)
        return _writer


def enabled():
    return _writer is not None


def flush():
    writer = _writer
    if writer is not None:
        writer.flush()


atexit.register(flush)


# ---------------------------------------------------------------------------
# span context plumbing

def current_context():
    """The thread's active SpanContext, or None outside any trace."""
    return getattr(_tls, "ctx", None)


# ---------------------------------------------------------------------------
# continuous-profiler correlation
#
# The sampling profiler's thread cannot read another thread's
# thread-local span stack, so while a sampler is attached each thread
# publishes its innermost open sampled span that the profiler can MAP
# to a critical-path segment, as {thread_ident: (trace_id, span_name)}.
# "Mapped" matters: critical_path.py attributes an unmapped span's
# time (rpc_attempt, ps_apply_round, future names) to its nearest
# mapped ANCESTOR's segment, so an unmapped span must keep the
# enclosing publication instead of overwriting it — otherwise the
# profiler files the same wall time under "other" that the trace
# analyzer files under pull/push/apply. The profiler passes its
# mapped-name predicate at attach time (None = publish everything).
# Guarded by one module-global bool check per span enter/exit, so the
# tracing hot path pays nothing when no profiler runs; plain-dict
# get/set under the GIL is safe for the single-writer-per-key access
# pattern (each thread writes only its own ident; the sampler only
# reads).

_prof_spans = {}
_prof_active = False
_prof_mapped = None  # predicate(name) -> bool, or None = all names


def _profiler_attach(mapped=None):
    global _prof_active, _prof_mapped
    _prof_mapped = mapped
    _prof_active = True


def _profiler_detach():
    global _prof_active, _prof_mapped
    _prof_active = False
    _prof_mapped = None
    _prof_spans.clear()


def profiled_spans():
    """The live {thread_ident: (trace_id, span_name)} map (read by the
    sampler thread; empty whenever no profiler is attached)."""
    return _prof_spans


def _current_sink():
    return getattr(_tls, "sink", None)


@contextlib.contextmanager
def adopt_context(ctx, sink=None):
    """Run a block under ``ctx`` (and, for tail-keep traces, its span
    buffer): server handlers adopt the propagated remote context, and
    ``bind_context``/``capture_context`` re-adopt a caller's context on
    worker-pool threads."""
    prev_ctx = getattr(_tls, "ctx", None)
    prev_sink = getattr(_tls, "sink", None)
    _tls.ctx = ctx
    _tls.sink = sink
    try:
        yield ctx
    finally:
        _tls.ctx = prev_ctx
        _tls.sink = prev_sink


def bind_context(fn):
    """Capture the calling thread's span context and return a callable
    that re-adopts it wherever it runs — the bridge for thread-pool
    fan-out (PS client per-shard futures, the async-push executor):
    without it the pool thread has no context and the RPC leaves the
    trace. Identity when no context is active."""
    ctx = getattr(_tls, "ctx", None)
    if ctx is None:
        return fn
    sink = getattr(_tls, "sink", None)

    def bound(*args, **kwargs):
        with adopt_context(ctx, sink):
            return fn(*args, **kwargs)

    return bound


# a single reusable do-nothing adoption for context-less captures:
# nullcontext is stateless, so one instance serves every caller — the
# serve admission path allocates nothing per request when tracing is
# off or the request arrived untraced
_NULL_ADOPTION = contextlib.nullcontext()


def _null_capture():
    return _NULL_ADOPTION


def capture_context():
    """Snapshot the caller's context as a zero-arg context-manager
    factory (the serve batcher stores one per request at admission and
    the formation thread adopts the batch head's). Returns a shared
    no-op factory when no context is active — zero per-request
    allocation on the untraced serving hot path."""
    ctx = getattr(_tls, "ctx", None)
    if ctx is None:
        return _null_capture
    sink = getattr(_tls, "sink", None)

    def factory():
        return adopt_context(ctx, sink)

    return factory


class _TailSink:
    """Span buffer for an unsampled tail-keep candidate trace. Events
    buffer until the root closes and the keep/drop decision is FINAL;
    after that, a kept sink forwards late arrivals (async-push spans
    bound to the step's context outlive the root) straight to the
    writer, and a dropped sink discards them — either way nothing
    lands in a list nobody will ever flush. The lock closes the race
    between a pool thread's append and the root's close."""

    __slots__ = ("_writer", "_events", "_decided", "_kept", "_lock")

    def __init__(self, writer):
        self._writer = writer
        self._events = []
        self._decided = False
        self._kept = False
        self._lock = threading.Lock()

    def append(self, event):
        with self._lock:
            if not self._decided:
                self._events.append(event)
                return
            kept = self._kept
        if kept:
            self._writer.add(event)

    def close(self, kept):
        with self._lock:
            self._decided = True
            self._kept = kept
            events, self._events = self._events, []
        if kept and events:
            self._writer.add_all(events)


def _suppressed(ctx):
    """True for an UNSAMPLED context with no tail-keep buffer — the
    one state in which span/complete/instant record nothing: the whole
    point of sampled=0 propagation is that such a request records
    nothing anywhere. The single definition every recording primitive
    consults (drift here would make span() disagree with complete())."""
    return (
        ctx is not None
        and not ctx.sampled
        and getattr(_tls, "sink", None) is None
    )


def _recording():
    return not _suppressed(getattr(_tls, "ctx", None))


def _write(writer, event):
    sink = getattr(_tls, "sink", None)
    if sink is not None:
        sink.append(event)
    else:
        writer.add(event)


def annotate(**args):
    """Merge args into the innermost OPEN recording span — for facts
    only known mid-block. The load-bearing user is the serve abort
    path: grpc's ``context.abort`` raises a bare ``Exception`` that
    carries no status, so without this the shed root span would never
    record the code critical_path.py classifies sheds by."""
    stack = getattr(_tls, "open_args", None)
    if stack:
        stack[-1].update(args)


def _push_open(args):
    stack = getattr(_tls, "open_args", None)
    if stack is None:
        stack = _tls.open_args = []
    stack.append(args)


def _pop_open():
    stack = getattr(_tls, "open_args", None)
    if stack:
        stack.pop()


# ---------------------------------------------------------------------------
# span API

def task_context(task_id):
    """Thread-local task id merged into every span's args (the PS
    client's pull/push spans inherit the worker loop's current task
    without parameter plumbing). Use as a context manager."""
    return _TaskContext(task_id)


class _TaskContext:
    __slots__ = ("task_id", "_previous")

    def __init__(self, task_id):
        self.task_id = task_id
        self._previous = None

    def __enter__(self):
        self._previous = getattr(_tls, "task_id", None)
        _tls.task_id = self.task_id
        return self

    def __exit__(self, *exc):
        _tls.task_id = self._previous
        return False


def current_task_id():
    return getattr(_tls, "task_id", None)


@contextlib.contextmanager
def root_span(name, **args):
    """Open a trace: one per worker train step / serve predict request.
    Yields the new SpanContext (None when tracing is off or sampling is
    0 — the caller can branch on it, but needn't). If a context is
    ALREADY active (a propagated parent adopted by the server handler),
    the "root" degrades to a child span so the caller's trace stays
    whole instead of forking a second trace_id."""
    writer = _writer
    if writer is None:
        yield None
        return
    existing = getattr(_tls, "ctx", None)
    if existing is not None:
        with span(name, **args):
            yield existing
        return
    rate = sample_rate()
    if rate <= 0.0:
        # the provably inert fast path: no ids, no RNG draw, no
        # context for the propagation interceptor to serialize
        yield None
        return
    sampled = rate >= 1.0 or _rng.random() < rate
    tail_ms = tail_keep_ms()
    ctx = SpanContext(_new_trace_id(), _new_span_id(), sampled)
    sink = _TailSink(writer) if (not sampled and tail_ms > 0) else None
    prev_sink = getattr(_tls, "sink", None)
    _tls.ctx = ctx
    _tls.sink = sink
    published = _prof_active and sampled
    if published:
        _prof_spans[threading.get_ident()] = (ctx.trace_id, name)
    _push_open(args)
    start = time.time()
    error = None
    try:
        yield ctx
    except BaseException as e:
        error = e
        raise
    finally:
        end = time.time()
        _pop_open()
        _tls.ctx = None
        _tls.sink = prev_sink
        if published:
            _prof_spans.pop(threading.get_ident(), None)
        keep_tail = (
            sink is not None and (end - start) * 1e3 >= tail_ms
        )
        if sampled or keep_tail:
            if error is not None:
                _note_error(args, error)
            if keep_tail:
                args["tail_kept"] = True
            args["trace_id"] = ctx.trace_id
            args["span_id"] = ctx.span_id
            task_id = args.pop("task_id", current_task_id())
            if task_id is not None:
                args["task_id"] = task_id
            event = {
                "name": name,
                "ph": "X",
                "ts": start * 1e6,
                "dur": max(0.0, (end - start) * 1e6),
                "pid": writer.pid,
                "tid": threading.get_ident() & 0xFFFFFF,
                "args": args,
            }
            if sink is not None:
                sink.append(event)
            else:
                writer.add(event)
        if sink is not None:
            # decision is final: flush-or-drop the buffer, and route
            # LATE spans (a bound async push finishing after the root)
            # to the writer or the void accordingly
            sink.close(keep_tail)


def _note_error(args, error):
    """Fold an exception into span args: failed RPC attempts and shed
    requests must be visible as failed spans, not silent gaps."""
    args.setdefault("error", type(error).__name__)
    code = getattr(error, "code", None)
    if callable(code):
        try:
            status = code()
            args.setdefault(
                "code", getattr(status, "name", None) or str(status)
            )
        except Exception:  # edlint: disable=ft-swallowed-except
            pass  # a half-built RpcError's code() must not mask it


@contextlib.contextmanager
def span(name, **args):
    """Time a block as a complete ("X") trace event. Under an active
    span context the event becomes a CHILD span (fresh span_id, parent
    = the enclosing span) and nested spans chain below it; with no
    context it is the standalone task_id-correlated span."""
    writer = _writer
    if writer is None:
        yield
        return
    ctx = getattr(_tls, "ctx", None)
    if _suppressed(ctx):
        yield  # unsampled trace: record nothing, anywhere
        return
    child = ctx.child() if ctx is not None else None
    if child is not None:
        _tls.ctx = child
    published = (
        _prof_active
        and child is not None
        and ctx.sampled
        and (_prof_mapped is None or _prof_mapped(name))
    )
    if published:
        ident = threading.get_ident()
        prev_published = _prof_spans.get(ident)
        _prof_spans[ident] = (ctx.trace_id, name)
    _push_open(args)
    start = time.time()
    error = None
    try:
        yield
    except BaseException as e:
        error = e
        raise
    finally:
        _pop_open()
        if child is not None:
            _tls.ctx = ctx
        if published:
            # restore the enclosing span's publication (unless the
            # profiler detached mid-span — then leave nothing behind)
            if prev_published is not None and _prof_active:
                _prof_spans[ident] = prev_published
            else:
                _prof_spans.pop(ident, None)
        if error is not None:
            _note_error(args, error)
        _emit(writer, name, start, time.time(), args,
              ctx=child, parent=ctx)


def complete(name, start, **args):
    """Emit a complete event for a block timed by the caller (``start``
    from ``time.time()``); for sites where the span name/args are only
    known at the end — e.g. the dispatcher learns the task_id when the
    pop returns. Under an active context the event is a child of the
    current span."""
    writer = _writer
    if writer is None:
        return
    if not _recording():
        return
    ctx = getattr(_tls, "ctx", None)
    child = ctx.child() if ctx is not None else None
    _emit(writer, name, start, time.time(), args, ctx=child, parent=ctx)


def instant(name, **args):
    """A zero-duration marker event."""
    writer = _writer
    if writer is None:
        return
    if not _recording():
        return
    ctx = getattr(_tls, "ctx", None)
    if ctx is not None:
        args["trace_id"] = ctx.trace_id
        args["parent_id"] = ctx.span_id
    task_id = args.pop("task_id", current_task_id())
    if task_id is not None:
        args["task_id"] = task_id
    _write(
        writer,
        {
            "name": name,
            "ph": "i",
            "s": "p",
            "ts": time.time() * 1e6,
            "pid": writer.pid,
            "tid": threading.get_ident() & 0xFFFFFF,
            "args": args,
        },
    )


def _emit(writer, name, start, end, args, ctx=None, parent=None):
    if ctx is not None:
        args["trace_id"] = ctx.trace_id
        args["span_id"] = ctx.span_id
        if parent is not None:
            args["parent_id"] = parent.span_id
    task_id = args.pop("task_id", None)
    if task_id is None:
        task_id = current_task_id()
    if task_id is not None:
        args["task_id"] = task_id
    _write(
        writer,
        {
            "name": name,
            "ph": "X",
            "ts": start * 1e6,
            "dur": max(0.0, (end - start) * 1e6),
            "pid": writer.pid,
            "tid": threading.get_ident() & 0xFFFFFF,
            "args": args,
        },
    )


def traced_handler(handler, service, method):
    """Wrap a gRPC handler so each invocation is a span (used by the
    server metrics interceptor; separate so tracing works with metrics
    disabled and vice versa).

    When the request carries ``edl-traceparent`` metadata, the
    handler runs UNDER the propagated context — its span is a child of
    the exact client-side RPC attempt, and spans opened inside the
    handler (PS apply, dispatch) chain below it. A propagated
    ``sampled=0`` suppresses recording for the whole handler."""

    name = "%s/%s" % (service, method)

    def wrapped(request, context):
        writer = _writer
        if writer is None:
            return handler(request, context)
        remote = None
        if context is not None:
            try:
                remote = extract_context(context.invocation_metadata())
            except Exception:  # edlint: disable=ft-swallowed-except
                remote = None  # metadata must never break the RPC
        if remote is None:
            # no propagated parent: the standalone server span
            start = time.time()
            try:
                return handler(request, context)
            finally:
                _emit(writer, name, start, time.time(),
                      {"kind": "grpc_server"})
        with adopt_context(remote):
            if not remote.sampled:
                return handler(request, context)
            with span(name, kind="grpc_server"):
                return handler(request, context)

    return wrapped


def _reset_for_tests():
    """Drop the writer and thread-local state (tests only)."""
    global _writer, _sample_cache, _tail_cache
    with _writer_lock:
        _writer = None
    _sample_cache = (None, 1.0)
    _tail_cache = (None, 0.0)
    _profiler_detach()
    for attr in ("ctx", "sink", "task_id", "open_args"):
        if hasattr(_tls, attr):
            delattr(_tls, attr)

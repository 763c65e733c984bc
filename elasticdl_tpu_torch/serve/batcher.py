"""Admission-controlled micro-batcher (port of
elasticdl_tpu/serve/batcher.py).

Requests enter a BOUNDED queue (``EDL_SERVE_QUEUE_DEPTH``); beyond the
bound they are SHED immediately (``QueueFull`` -> RESOURCE_EXHAUSTED on
the wire). A single formation thread drains the queue into batches by
max-size-or-max-delay (``EDL_SERVE_MAX_BATCH`` rows /
``EDL_SERVE_MAX_DELAY_MS``), drops any request whose deadline expired
while it queued (``DeadlineExpired`` -> DEADLINE_EXCEEDED: a late
answer is a wrong answer to a caller that already gave up),
concatenates the survivors along the batch dim, runs them through the
runner in ONE forward, and splits the outputs back per request.
Features are tensors or arrays; batches concatenate as tensors.

Each request snapshots its admitting thread's trace context; the
formation thread adopts the batch head's, so the batch's
``serve_batch_assemble`` (the concatenation) and ``serve_batch_run``
(the forward) spans land in the head request's trace. Both carry the
batch's number, which every request of the batch also stamps onto its
admitting span (``batch``), so a request's queue wait, assembly,
forward and reply can be read from the trace. The
``edl_serve_queue_depth``, ``edl_serve_requests_shed_total`` and
``edl_serve_batch_size`` series mirror the admission counters.
"""

import collections
import threading
import time

import torch

from elasticdl_tpu_torch.common.env_utils import env_float, env_int
from elasticdl_tpu_torch.common.log_utils import (
    default_logger as _logger_factory,
)
from elasticdl_tpu_torch.common.tensor_utils import as_tensor
from elasticdl_tpu_torch.observability import metrics, trace

_BATCH_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256)

logger = _logger_factory("elasticdl_tpu_torch.serve.batcher")

MAX_BATCH_ENV = "EDL_SERVE_MAX_BATCH"
MAX_DELAY_MS_ENV = "EDL_SERVE_MAX_DELAY_MS"
QUEUE_DEPTH_ENV = "EDL_SERVE_QUEUE_DEPTH"
DEADLINE_MS_ENV = "EDL_SERVE_DEADLINE_MS"


def _env_num(name, default, cast):
    if cast is int:
        return env_int(name, default)
    return env_float(name, default)


class QueueFull(Exception):
    """Admission queue at depth: the request was shed, not queued."""


class DeadlineExpired(Exception):
    """The request's latency budget passed while it queued: shed, not
    served late."""


class Draining(Exception):
    """The role is in its SIGTERM drain: no new admissions."""


def _leaf_schema(value):
    value = as_tensor(value)
    return (tuple(value.shape[1:]), str(value.dtype))


def _schema(features):
    """Co-batch key: feature names AND per-feature trailing shape +
    dtype. Concatenation along the batch dim is only defined within
    such a group -- without it one malformed request makes the whole
    batch's concatenate raise and poisons every co-batched request."""
    if isinstance(features, dict):
        return tuple(
            (name,) + _leaf_schema(features[name])
            for name in sorted(features)
        )
    return _leaf_schema(features)


class _Request:
    __slots__ = (
        "features", "rows", "deadline", "enqueued", "done",
        "outputs", "error", "keys", "adopt_trace", "batch",
    )

    def __init__(self, features, rows, deadline):
        self.features = features
        self.rows = int(rows)
        self.deadline = deadline  # monotonic seconds, or None
        self.enqueued = time.monotonic()
        self.done = threading.Event()
        self.outputs = None
        self.error = None
        self.keys = _schema(features)
        self.batch = None  # the number of the batch that served it
        # span-context snapshot from the admitting RPC thread: the
        # formation thread adopts the batch head's, so batch-level work
        # lands in the trace of the request that opened the window
        self.adopt_trace = trace.capture_context()

    def resolve(self, outputs):
        self.outputs = outputs
        self.done.set()

    def fail(self, error):
        self.error = error
        self.done.set()


class MicroBatcher:
    """``runner(features, rows) -> (outputs, step, stamp)`` executes one
    batch; everything else -- admission, shedding, deadlines,
    formation, response splitting -- lives here."""

    def __init__(self, runner, max_batch=None, max_delay_ms=None,
                 queue_depth=None, default_deadline_ms=None,
                 on_shed=None, registry=None):
        self._runner = runner
        self._on_shed = on_shed
        self.max_batch = int(
            max_batch if max_batch is not None
            else _env_num(MAX_BATCH_ENV, 32, int)
        )
        self.max_delay_secs = (
            max_delay_ms if max_delay_ms is not None
            else _env_num(MAX_DELAY_MS_ENV, 5.0, float)
        ) / 1e3
        self.queue_depth = int(
            queue_depth if queue_depth is not None
            else _env_num(QUEUE_DEPTH_ENV, 256, int)
        )
        self.default_deadline_secs = (
            default_deadline_ms if default_deadline_ms is not None
            else _env_num(DEADLINE_MS_ENV, 1000.0, float)
        ) / 1e3
        if self.max_batch < 1 or self.queue_depth < 1:
            raise ValueError("max_batch and queue_depth must be >= 1")
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._pending = collections.deque(maxlen=self.queue_depth)
        self._draining = False
        self._stopped = False
        # counters move from RPC threads AND the formation thread: a
        # dedicated lock, not self._lock (_shed runs both under the
        # admission condition and lock-free from the formation thread)
        self._count_lock = threading.Lock()
        self.shed_total = 0
        self.served_total = 0
        self.batches_total = 0  # formed batches that ran the runner
        self._batches_formed = 0  # the formation thread's alone
        reg = registry or metrics.default_registry()
        self._m_queue_depth = reg.gauge(
            "edl_serve_queue_depth",
            "Instantaneous admission-queue depth of the micro-batcher",
        )
        self._m_shed = reg.counter(
            "edl_serve_requests_shed_total",
            "Requests shed (queue at depth, or deadline expired while "
            "queued), by reason",
            ("reason",),
        )
        self._m_batch_size = reg.histogram(
            "edl_serve_batch_size",
            "Rows per formed inference batch",
            buckets=_BATCH_BUCKETS,
        )
        # pre-register so /metrics shows the series at zero
        self._m_shed.labels(reason="queue_full")
        self._m_shed.labels(reason="deadline")
        self._thread = threading.Thread(
            target=self._loop, name="edl-serve-batcher", daemon=True
        )
        self._thread.start()

    # ------------------------------------------------------------------
    def _shed(self, reason):
        with self._count_lock:
            self.shed_total += 1
            total = self.shed_total
        self._m_shed.labels(reason=reason).inc()
        if self._on_shed is not None:
            try:
                self._on_shed(reason, total)
            except Exception:
                logger.exception("on_shed callback failed")

    def submit(self, features, rows, deadline_secs=None):
        """Blocks until served; returns ``(outputs, step, stamp)``.
        Raises QueueFull / DeadlineExpired / Draining (each maps to one
        gRPC status in the servicer)."""
        if deadline_secs is None:
            deadline_secs = self.default_deadline_secs
        deadline = (
            time.monotonic() + deadline_secs if deadline_secs > 0 else None
        )
        request = _Request(features, rows, deadline)
        with self._cond:
            if self._draining:
                raise Draining("serve role is draining; not admitting")
            if len(self._pending) >= self.queue_depth:
                self._shed("queue_full")
                raise QueueFull(
                    "admission queue at depth %d" % self.queue_depth
                )
            self._pending.append(request)
            self._m_queue_depth.set(len(self._pending))
            self._cond.notify()
        # the formation thread resolves every admitted request; the pad
        # is defense against a wedged runner -- surface it as an error
        # rather than hanging the RPC thread forever
        wait = (
            deadline - time.monotonic() + 30.0
            if deadline is not None
            else 600.0
        )
        if not request.done.wait(timeout=wait):
            with self._cond:
                try:
                    self._pending.remove(request)
                except ValueError:
                    pass  # already popped into a forming batch
                else:
                    self._m_queue_depth.set(len(self._pending))
            self._shed("deadline")
            raise DeadlineExpired("request timed out awaiting the batcher")
        if request.batch is not None:
            trace.annotate(batch=request.batch)
        if request.error is not None:
            raise request.error
        with self._count_lock:
            self.served_total += 1
        return request.outputs

    # ------------------------------------------------------------------
    def _take_batch(self):
        """Under the condition: wait for work, then pop one batch --
        same-schema requests up to max_batch rows, closing when the
        head has waited max_delay. Returns [] only at stop."""
        with self._cond:
            while not self._pending and not self._stopped:
                self._cond.wait(timeout=0.1)
            if self._stopped and not self._pending:
                return []
            head = self._pending[0]
            close_at = head.enqueued + self.max_delay_secs
            # wait out the formation window while under-filled; only the
            # head's contiguous same-schema run counts, and the scan
            # stops at max_batch rows
            while not self._stopped:
                rows = 0
                for request in self._pending:
                    if request.keys != head.keys:
                        break
                    rows += request.rows
                    if rows >= self.max_batch:
                        break
                remaining = close_at - time.monotonic()
                if rows >= self.max_batch or remaining <= 0:
                    break
                self._cond.wait(timeout=remaining)
            batch = []
            rows = 0
            while self._pending:
                nxt = self._pending[0]
                if nxt.keys != head.keys:
                    break  # schema boundary: next batch takes it
                if rows + nxt.rows > self.max_batch and batch:
                    break
                batch.append(self._pending.popleft())
                rows += nxt.rows
            self._m_queue_depth.set(len(self._pending))
            return batch

    def _run(self, batch):
        """Shed the expired, concatenate the live, run, split."""
        now = time.monotonic()
        live = []
        for request in batch:
            if request.deadline is not None and now > request.deadline:
                self._shed("deadline")
                request.fail(DeadlineExpired(
                    "deadline expired after %.1f ms in queue"
                    % ((now - request.enqueued) * 1e3)
                ))
            else:
                live.append(request)
        if not live:
            return
        number = self._batches_formed
        self._batches_formed += 1
        for request in live:
            request.batch = number
        try:
            total = sum(r.rows for r in live)
            with live[0].adopt_trace():
                with trace.span("serve_batch_assemble", requests=len(live),
                                rows=total, batch=number):
                    features = self._assemble(live)
                self._m_batch_size.observe(total)
                with trace.span("serve_batch_run", requests=len(live),
                                rows=total, batch=number):
                    outputs, step, stamp = self._runner(features, total)
            with self._count_lock:
                self.batches_total += 1
            offset = 0
            for request in live:
                request.resolve((
                    {
                        k: v[offset:offset + request.rows]
                        for k, v in outputs.items()
                    },
                    step,
                    stamp,
                ))
                offset += request.rows
        except BaseException as e:  # noqa: BLE001 - every request must resolve
            logger.exception("inference batch failed")
            for request in live:
                if not request.done.is_set():
                    request.fail(e)

    @staticmethod
    def _assemble(live):
        """The live requests' features concatenated along the batch
        dim."""
        if len(live) == 1:
            return live[0].features
        if not isinstance(live[0].features, dict):
            return torch.cat([as_tensor(r.features) for r in live], dim=0)
        return {
            key: torch.cat(
                [as_tensor(r.features[key]) for r in live], dim=0
            )
            for key in live[0].features
        }

    def _loop(self):
        while True:
            batch = self._take_batch()
            if not batch:
                if self._stopped:
                    return
                continue
            self._run(batch)

    # ------------------------------------------------------------------
    def pending_count(self):
        """Instantaneous admission-queue depth."""
        return len(self._pending)

    def drain(self, timeout=30.0):
        """SIGTERM path: stop admitting (submit raises Draining), serve
        everything already queued, stop the formation thread. Returns
        the number of requests flushed."""
        with self._cond:
            self._draining = True
            flushed = len(self._pending)
            self._cond.notify_all()
        deadline = time.monotonic() + timeout
        while self._pending and time.monotonic() < deadline:
            time.sleep(0.01)
        with self._cond:
            self._stopped = True
            self._cond.notify_all()
        self._thread.join(timeout=max(0.0, deadline - time.monotonic()))
        return flushed

    def stop(self):
        """Test/teardown convenience: drain with a short flush window."""
        return self.drain(timeout=5.0)

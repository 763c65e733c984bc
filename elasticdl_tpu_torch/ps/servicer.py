"""Pserver gRPC service over an embedding store (port of
elasticdl_tpu/ps/servicer.py).

What it serves, host side:

- table registration and lazily created rows: ``push_embedding_table_infos``,
  ``pull_embedding_vectors`` and the fused ``pull_embedding_batch``;
- gradient pushes in two modes. Async (``use_async``): apply at once,
  bump the version, optionally scale the learning rate by staleness
  (``lr /= max(1, version diff)``). Sync (the flag default, and what
  ``bench.py``'s PS runs): buffer ``grads_to_wait`` pushes, reject one
  older than ``version - sync_version_tolerance``, merge and apply them
  once, bump the version;
- ``push_embedding_rows``, the device tier's writeback of raw rows;
- the cold-start dense init (``push_model``, first writer wins, and
  ``pull_dense_parameters``);
- admission control: past ``EDL_PS_MAX_PENDING_APPLIES`` in-flight
  applies an RPC is answered RESOURCE_EXHAUSTED with a retry-after
  hint;
- sparse checkpoints: with a ``checkpoint_saver`` (ps/checkpoint.py),
  every ``checkpoint_steps``-th version bump requests a save, which a
  checkpoint thread takes off the push path (``EDL_CKPT_ASYNC=0``: the
  push handler saves inline); ``finish_checkpoints`` drains that thread
  on an orderly exit;
- the boot-restore stamp: a PS that restored checkpoint version ``v``
  answers pushes and pulls with ``restored_version = v + 1`` (0: it
  restored nothing), so a worker sees the relaunch;
- ``graceful_stop``, the SIGTERM drain: apply a buffered partial round,
  refuse later pushes and save a final full checkpoint, which
  supersedes any pending delta.

With a native store (one that has ``lookup_blob``,
``push_gradients_blob`` and ``import_blob``) a packed payload goes
through one GIL-released C call per table; anything else (the numpy
store, legacy repeated ids, another dtype) goes through numpy with the
same values, bit for bit.

Telemetry: plain-int tallies (pushes, pulls, their payload bytes, the
last pushed version, the last checkpoint's rows and chain length) feed
``telemetry_blob``, which the PS's master poll carries to the fleet
monitor; the reference's ``edl_ps_*`` series, the ``ps_apply_push`` /
``ps_apply_round`` spans and the events (overload edges, stale and dead
pushes, rounds, checkpoints) mirror them when metrics, tracing or the
journal are on.

The embedding lifecycle (``lifecycle``, stream/lifecycle.py) gates the
RPC paths when the PS runs one: a pull of an id not yet admitted is
served the initializer's cold row without touching the store, its
pushed gradients are dropped, and a ``push_embedding_rows`` writeback
admits its rows. ``lifecycle_tick`` (the eviction sweep),
``table_health_scan`` (sampled row norms, the dead-row fraction) and
``maybe_stream_checkpoint`` (a save each time the master's record
watermark crosses a boundary) run on the PS's poll loop, never on an
RPC handler. With a ``master_client`` every version the store reaches
is reported to the master. The ``overload`` fault kind
(testing/faults.py) lands inside the push's admission slot.
"""

import concurrent.futures
import json
import sys
import threading
import time

import grpc
import numpy as np

from elasticdl_tpu_torch.common import overload
from elasticdl_tpu_torch.common.env_utils import env_float, env_int
from elasticdl_tpu_torch.common.log_utils import (
    default_logger as _logger_factory,
)
from elasticdl_tpu_torch.common.tensor_utils import (
    blob_to_ndarray,
    deduplicate_indexed_slices,
    deserialize_indexed_slices,
    ndarray_to_blob,
    unpack_ids,
    wire_dtype,
    wire_dtype_name,
)
from elasticdl_tpu_torch.observability import events
from elasticdl_tpu_torch.observability import metrics as obs_metrics
from elasticdl_tpu_torch.observability import trace
from elasticdl_tpu_torch.proto import elasticdl_tpu_pb2 as pb
from elasticdl_tpu_torch.ps.checkpoint import AsyncCheckpointer
from elasticdl_tpu_torch.ps.embedding_store import (
    BLOB_DTYPE_CODES,
    BLOB_ITEMSIZE,
    parse_initializer,
)
from elasticdl_tpu_torch.testing import faults
from elasticdl_tpu_torch.train.health import health_enabled

logger = _logger_factory("elasticdl_tpu_torch.ps.servicer")

# per-table apply fan-out width of the async push path; pays only with
# the native store, whose blob applies release the GIL and lock per table
APPLY_THREADS_ENV = "EDL_PS_APPLY_THREADS"
# admission control: apply-backlog depth past which push/pull RPCs are
# answered RESOURCE_EXHAUSTED with a retry-after hint; 0 disables
MAX_PENDING_APPLIES_ENV = "EDL_PS_MAX_PENDING_APPLIES"
# 1 (default): a push handler only enqueues a checkpoint request and a
# checkpoint thread saves; 0: the handler saves inline
CKPT_ASYNC_ENV = "EDL_CKPT_ASYNC"
# table-health scan: the row-norm ceiling past which a sampled row
# counts as exploding, the rows sampled per table, the seconds between
# scans and the table size past which a table is skipped (the scan's
# full-table export would stall pushes)
ROW_NORM_MAX_ENV = "EDL_HEALTH_ROW_NORM_MAX"
HEALTH_SCAN_SAMPLE_ENV = "EDL_HEALTH_SCAN_SAMPLE"
HEALTH_SCAN_SECS_ENV = "EDL_HEALTH_SCAN_SECS"
HEALTH_SCAN_MAX_ROWS_ENV = "EDL_HEALTH_SCAN_MAX_ROWS"

# packed-id blobs are little-endian; the native fast paths read them as
# host int64, so they are only taken on little-endian hosts
_LITTLE_ENDIAN = sys.byteorder == "little"


def _deserialize_gradients(slices):
    """One table's pushed gradients off the wire, as fp32: a reduced
    wire dtype covers the payload only, never the PS's master rows."""
    values, ids = deserialize_indexed_slices(slices)
    if values.dtype != np.float32:
        values = values.astype(np.float32)
    return values, ids


def _blob_fast_path_ok(store, name, slices):
    """True when one table's slices can go through the native store's
    single call: packed ids, a payload dtype the C side decodes and a
    size that matches the table."""
    if not _LITTLE_ENDIAN or not slices.ids_blob:
        return False
    blob = slices.concat_tensors
    if blob.dtype not in BLOB_DTYPE_CODES:
        return False
    try:
        dim = store.table_dim(name)
    except KeyError:
        return False
    n = len(slices.ids_blob) // 8
    return len(blob.content) == n * dim * BLOB_ITEMSIZE[blob.dtype]


class _VersionReporter:
    """Sends the store's newest version to the master off the push
    handlers: a push records its version and wakes one thread, which
    reports the newest version not yet sent. The reference reports every
    version synchronously inside the handler, one master RPC on every
    push's path; the master's evaluation trigger only needs each crossing
    of ``eval_steps``, which any later version carries. The thread is a
    daemon: a PS that exits leaves nothing the master still needs."""

    def __init__(self, client, name):
        self._client = client
        self._cond = threading.Condition()
        self._latest = self._sent = -1
        self._thread = threading.Thread(target=self._run, name=name,
                                        daemon=True)
        self._thread.start()

    def offer(self, version):
        with self._cond:
            if version > self._latest:
                self._latest = version
                self._cond.notify()

    def _run(self):
        while True:
            with self._cond:
                while self._latest <= self._sent:
                    self._cond.wait()
                version = self._sent = self._latest
            try:
                self._client.report_version(version)
            except Exception as e:  # the next version reports again
                logger.warning("version report %d failed: %s", version, e)


class PserverServicer:
    def __init__(self, store, ps_id=0, staleness_modulation=True,
                 checkpoint_saver=None, checkpoint_steps=0, use_async=True,
                 grads_to_wait=1, sync_version_tolerance=0,
                 restored_version=None, master_client=None,
                 lifecycle=None):
        """``use_async`` defaults to True for the bare constructor;
        the server entry point passes its flag (default sync).
        ``restored_version`` is the checkpoint version the PS restored
        at boot (None: none). ``lifecycle`` (None: tables grow
        unbounded) is the admission/eviction policy over this shard."""
        self._store = store
        self._ps_id = ps_id
        self._lifecycle = lifecycle
        self._master_client = master_client
        self._reporter = (
            _VersionReporter(master_client, "ps-%d-report" % ps_id)
            if master_client is not None else None)
        self._stream_ckpt_boundary = None
        # wire encoding of the boot restore: version + 1, 0 = none
        self._restored_wire = (int(restored_version) + 1
                               if restored_version is not None else 0)
        self._checkpoint_saver = checkpoint_saver
        self._checkpoint_steps = checkpoint_steps
        self._ckpt_async = None
        if checkpoint_saver is not None and env_int(CKPT_ASYNC_ENV, 1):
            self._ckpt_async = AsyncCheckpointer(
                self._save_checkpoint_now, name="ps-%d-ckpt" % ps_id)
        # a misconfigured EDL_WIRE_DTYPE fails at boot, not per pull
        wire_dtype()
        self._native_store = all(
            callable(getattr(store, method, None))
            for method in ("push_gradients_blob", "lookup_blob",
                           "import_blob")
        )
        apply_threads = env_int(APPLY_THREADS_ENV, 1)
        self._apply_pool = None
        if apply_threads > 1:
            self._apply_pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=apply_threads, thread_name_prefix="ps-apply"
            )
        # admission control: in-flight push handlers counted under a
        # small lock; _overloaded tracks the edge for the log
        self._max_pending = env_int(MAX_PENDING_APPLIES_ENV, 64)
        self._pending_lock = threading.Lock()
        self._pending_applies = 0
        self._t_overload_rejections = 0
        self._overloaded = False
        # EWMA of admitted apply seconds: calibrates the retry-after hint
        self._apply_ewma_secs = 0.0
        self._staleness_modulation = staleness_modulation
        self._lock = threading.Lock()
        self._dense = {}
        self._dense_version = 0
        self._dense_initialized = False
        self._use_async = use_async
        self._grads_to_wait = max(1, grads_to_wait)
        self._sync_tolerance = max(0, sync_version_tolerance)
        self._push_lock = threading.Lock()
        self._stopped = False
        # Round buffer: buffered pushes, each tagged (worker_id,
        # incarnation) when identified. A push whose worker_id matches
        # a buffered entry of an OLDER incarnation evicts it (the dead
        # predecessor's orphaned half-round); same-incarnation and
        # anonymous pushes always append (the reference's counting).
        self._round_buffer = []  # [(worker_key, {name: (vals, ids)}, scale)]
        # round-scoped pairing (lockstep pushers): tag -> entries
        self._round_groups = {}
        self._backend = "native" if self._native_store else "numpy"
        self._register_metrics()
        # fleet-telemetry source: plain-int tallies kept independently
        # of the metrics registry (telemetry works with /metrics off),
        # read by telemetry_blob() on the PS's master poll. Unlocked
        # increments: a GIL-level race costs at most one count in a
        # rate estimate
        self._t_push_count = 0
        self._t_pull_count = 0
        self._t_push_bytes = 0
        self._t_push_dense_bytes = 0
        self._t_pull_bytes = 0
        self._t_last_push_version = 0
        self._t_ckpt_dirty_rows = 0
        self._t_ckpt_chain_len = 0
        self._t_prev = None  # (timestamp, push_count, pull_count)
        # the table-health scan's books: shard-level aggregates the
        # telemetry blob carries between scans, and its rate limit
        self._health_scan_on = health_enabled()
        self._row_norm_max = env_float(ROW_NORM_MAX_ENV, 1e3)
        self._health_sample = max(8, env_int(HEALTH_SCAN_SAMPLE_ENV, 256))
        self._health_scan_max_rows = env_int(HEALTH_SCAN_MAX_ROWS_ENV,
                                             262_144)
        self._health_scan_skipped = set()
        self._health_scan_secs = env_float(HEALTH_SCAN_SECS_ENV, 30.0)
        self._health_scan_at = 0.0
        self._t_row_norm_p50 = 0.0
        self._t_row_norm_p99 = 0.0
        self._t_dead_row_fraction = 0.0
        self._t_exploding_rows = 0

    def _register_metrics(self):
        """PS-side series: push/pull rates and bytes, the round-buffer
        fill, the version lag, the apply latency and the checkpoints.
        No-op instruments when metrics collection is off."""
        self._m_pull_requests = obs_metrics.counter(
            "edl_ps_pull_requests_total",
            "pull_embedding_vectors RPCs served", ("table",),
        )
        self._m_pull_rows = obs_metrics.counter(
            "edl_ps_pulled_rows_total",
            "Embedding rows served to workers", ("table",),
        )
        self._m_push_requests = obs_metrics.counter(
            "edl_ps_push_requests_total", "push_gradients RPCs received"
        )
        self._m_push_rejected = obs_metrics.counter(
            "edl_ps_push_rejected_total",
            "Pushes rejected as stale (sync mode version check)",
        )
        self._m_overload_rejected = obs_metrics.counter(
            "edl_ps_overload_rejected_total",
            "RPCs rejected by admission control (RESOURCE_EXHAUSTED + "
            "retry-after pushback) once the apply backlog crossed "
            "EDL_PS_MAX_PENDING_APPLIES, by method", ("method",),
        )
        obs_metrics.gauge(
            "edl_ps_pending_applies",
            "Admission-control depth: in-flight push handlers plus "
            "round-buffer entries beyond one full sync round",
        ).set_function(self._pending_depth)
        self._m_push_dropped_dead = obs_metrics.counter(
            "edl_ps_push_dropped_dead_incarnation_total",
            "Pushes dropped as a dead incarnation's delayed delivery "
            "(a sustained nonzero rate on a live worker means its "
            "incarnation ordering is wrong — alert on it)",
        )
        self._m_version_lag = obs_metrics.gauge(
            "edl_ps_version_lag",
            "store version minus the last push's gradient version",
        )
        obs_metrics.gauge(
            "edl_ps_round_buffer_fill",
            "Buffered pushes awaiting a sync round (counting + scoped)",
        ).set_function(self._buffered_count)
        obs_metrics.gauge(
            "edl_ps_store_version", "Embedding store version"
        ).set_function(lambda: self._store.version)
        self._m_table_rows = obs_metrics.gauge(
            "edl_ps_embedding_rows",
            "Materialized rows per embedding table", ("table",),
        )
        self._m_push_bytes = obs_metrics.counter(
            "edl_ps_push_bytes_total",
            "Gradient payload bytes received (tensor content + ids), "
            "by wire dtype", ("dtype",),
        )
        self._m_pull_bytes = obs_metrics.counter(
            "edl_ps_pull_bytes_total",
            "Embedding-row payload bytes served, by wire dtype",
            ("dtype",),
        )
        self._m_push_dense_bytes = obs_metrics.counter(
            "edl_ps_push_dense_bytes_total",
            "Dense-gradient payload bytes received over push_gradients "
            "(0 under the GSPMD dense data plane: only embedding rows "
            "ride the PS)",
        )
        # an explicit 0 on /metrics: the contract is "provably zero"
        self._m_push_dense_bytes.inc(0)
        self._m_rows_written = obs_metrics.counter(
            "edl_ps_rows_written_total",
            "Embedding rows overwritten by device-tier writebacks",
        )
        self._m_apply_seconds = obs_metrics.histogram(
            "edl_ps_apply_seconds",
            "Wall seconds per push's gradient deserialize+apply, by "
            "store backend", ("backend",),
        )
        obs_metrics.gauge(
            "edl_ps_native_active",
            "1 when this PS runs the native (C++) embedding store, "
            "0 on the numpy fallback",
        ).set(1 if self._native_store else 0)
        self._m_ckpt_seconds = obs_metrics.histogram(
            "edl_ps_checkpoint_seconds",
            "Wall seconds per sparse checkpoint save, by kind",
            ("kind",),
        )
        self._m_ckpt_dirty_rows = obs_metrics.gauge(
            "edl_ps_ckpt_dirty_rows",
            "Rows carried by the most recent checkpoint save "
            "(all resident rows for a full base, dirty rows for a "
            "delta)",
        )
        self._m_ckpt_chain_len = obs_metrics.gauge(
            "edl_ps_ckpt_chain_len",
            "Deltas in the live checkpoint chain since its full base",
        )
        self._m_row_norm = obs_metrics.gauge(
            "edl_ps_row_norm",
            "Sampled row-norm percentile per table",
            ("table", "quantile"),
        )
        self._m_exploding = obs_metrics.gauge(
            "edl_ps_exploding_rows",
            "Sampled rows with norm beyond EDL_HEALTH_ROW_NORM_MAX",
            ("table",),
        )
        self._m_dead_fraction = obs_metrics.gauge(
            "edl_ps_dead_row_fraction",
            "Evicted rows / (evicted + resident), from the lifecycle "
            "books (0 without a lifecycle)",
        )

    def telemetry_blob(self):
        """Piggyback payload of the PS's get_comm_info master poll:
        push/pull rates over the window since the previous blob, the
        store/pusher version lag, and the round-buffer fill the
        stuck-round detector watches."""
        now = time.time()
        push_count, pull_count = self._t_push_count, self._t_pull_count
        push_rate = pull_rate = 0.0
        if self._t_prev is not None:
            since, prev_push, prev_pull = self._t_prev
            window = max(1e-6, now - since)
            push_rate = (push_count - prev_push) / window
            pull_rate = (pull_count - prev_pull) / window
        self._t_prev = (now, push_count, pull_count)
        blob = pb.TelemetryBlob(
            role="ps-%d" % self._ps_id,
            push_rate=push_rate,
            pull_rate=pull_rate,
            version_lag=max(
                0, self._store.version - self._t_last_push_version
            ),
            model_version=self._store.version,
            round_buffer_fill=self._buffered_count(),
            push_bytes=self._t_push_bytes,
            pull_bytes=self._t_pull_bytes,
            ps_native_store=self._native_store,
            ps_ckpt_dirty_rows=self._t_ckpt_dirty_rows,
            ps_ckpt_chain_len=self._t_ckpt_chain_len,
            # the last table-health scan's shard-level aggregates
            ps_row_norm_p50=self._t_row_norm_p50,
            ps_row_norm_p99=self._t_row_norm_p99,
            ps_dead_row_fraction=self._t_dead_row_fraction,
            ps_exploding_rows=self._t_exploding_rows,
            ps_overload_rejections=self._t_overload_rejections,
            ps_pending_applies=self._pending_depth(),
        )
        if self._lifecycle is not None:
            # the admission/eviction tallies and the resident-row count
            # the bounded-memory contract is about
            stats = self._lifecycle.stats()
            blob.ps_rows_admitted = stats["rows_admitted"]
            blob.ps_rows_evicted_ttl = stats["rows_evicted_ttl"]
            blob.ps_rows_evicted_lfu = stats["rows_evicted_lfu"]
            blob.ps_tracked_ids = stats["tracked_ids"]
            blob.ps_resident_rows = stats["resident_rows"]
        return blob

    def model_initialized(self):
        """This PS's /readyz milestone: cold-start dense parameters
        arrived, or at least one embedding table exists to serve."""
        with self._lock:
            if self._dense_initialized:
                return True
        return bool(self._store.table_names())

    # ------------------------------------------------------------------
    def push_model(self, request, context=None):
        """First writer wins: later pushes are ignored."""
        with self._lock:
            if not self._dense_initialized:
                self._dense = {
                    name: blob_to_ndarray(blob).copy()
                    for name, blob in request.dense_parameters.items()
                }
                self._dense_version = request.version
                self._dense_initialized = True
                logger.info("Initialized %d dense parameters at version %d",
                            len(self._dense), request.version)
        self._create_tables(request.embedding_table_infos)
        return pb.Empty()

    def push_embedding_table_infos(self, request, context=None):
        self._create_tables(request.embedding_table_infos)
        return pb.Empty()

    def _create_tables(self, infos):
        for info in infos:
            try:
                kind, param = parse_initializer(info.initializer)
            except ValueError:
                logger.warning(
                    "unknown initializer %r for table %s; using uniform",
                    info.initializer, info.name,
                )
                kind, param = "uniform", 0.05
            self._store.create_table(
                info.name, info.dim, init_scale=param, initializer=kind
            )
            if self._lifecycle is not None:
                # pre-admission pulls get the initializer's
                # deterministic cold row
                self._lifecycle.register_table(
                    info.name, info.dim, init_kind=kind, init_param=param
                )
            self._m_table_rows.labels(table=info.name).set_function(
                lambda name=info.name: self._store.table_size(name)
            )

    def _stamp(self, response):
        """Stamp the boot-restore marker on a push or pull response."""
        response.restored_version = self._restored_wire
        return response

    def _buffered_count(self):
        # racy read: list lengths are snapshots
        return len(self._round_buffer) + sum(
            len(group) for group in self._round_groups.values()
        )

    # ------------------------------------------------------------------
    def pull_dense_parameters(self, request, context=None):
        response = self._stamp(pb.PullDenseParametersResponse())
        with self._lock:
            response.initialized = self._dense_initialized
            response.version = self._dense_version
            if (self._dense_initialized
                    and request.version < self._dense_version):
                for name, array in self._dense.items():
                    ndarray_to_blob(array, response.dense_parameters[name])
        return response

    def _pull_table(self, name, ids, blob=None, reduced_ok=True):
        """Look one table's rows up and serialize them at the wire
        dtype; ``reduced_ok=False`` pins fp32 for legacy clients, which
        cannot decode extension dtype names."""
        wd_name = wire_dtype_name() if reduced_ok else None
        if self._lifecycle is not None:
            mask = self._lifecycle.filter_pull(name, ids)
            if not mask.all():
                # a mixed pull: admitted rows come from the store, ids
                # not yet admitted get the cold row and never touch it
                # (a pull is a sighting, not a materialization)
                values = self._lifecycle.cold_rows(name, ids.size)
                if mask.any():
                    values[mask] = self._store.lookup(name, ids[mask])
                blob = ndarray_to_blob(
                    values, blob,
                    wire_dtype=wire_dtype() if reduced_ok else None)
                payload = len(blob.content)
                self._t_pull_bytes += payload
                self._m_pull_bytes.labels(dtype=blob.dtype).inc(payload)
                self._m_pull_requests.labels(table=name).inc()
                self._m_pull_rows.labels(table=name).inc(int(ids.size))
                return blob
        if self._native_store and _LITTLE_ENDIAN:
            # lazy init + gather + wire cast in one GIL-released call,
            # straight into the response blob
            content, dtype_name = self._store.lookup_blob(name, ids, wd_name)
            if blob is None:
                blob = pb.TensorBlob()
            blob.dtype = dtype_name
            del blob.dims[:]
            blob.dims.extend((int(ids.size), self._store.table_dim(name)))
            blob.content = content
        else:
            values = self._store.lookup(name, ids)
            blob = ndarray_to_blob(
                values, blob, wire_dtype=wire_dtype() if reduced_ok else None)
        payload = len(blob.content)
        self._t_pull_bytes += payload
        self._m_pull_bytes.labels(dtype=blob.dtype).inc(payload)
        self._m_pull_requests.labels(table=name).inc()
        self._m_pull_rows.labels(table=name).inc(int(ids.size))
        return blob

    def pull_embedding_vectors(self, request, context=None):
        self._admit_or_abort(context, "pull_embedding_vectors")
        self._t_pull_count += 1
        # repeated ids without a packed blob: a pre-ids_blob client,
        # which also predates EDL_WIRE_DTYPE; serve it fp32
        legacy_peer = bool(request.ids) and not request.ids_blob
        return self._pull_table(request.name, unpack_ids(request),
                                reduced_ok=not legacy_peer)

    def pull_embedding_batch(self, request, context=None):
        """Fused multi-table pull: one RPC serves every table's rows for
        this shard, each aligned with its request's id order."""
        self._admit_or_abort(context, "pull_embedding_batch")
        response = self._stamp(pb.PullEmbeddingBatchResponse())
        self._t_pull_count += 1
        for name, slices in request.tables.items():
            self._pull_table(name, unpack_ids(slices), response.tables[name])
        return response

    # ------------------------------------------------------------------
    def _pending_depth(self):
        """In-flight push handlers plus the round buffer's overflow
        beyond one full sync round."""
        with self._pending_lock:
            depth = self._pending_applies
        return depth + max(0, self._buffered_count() - self._grads_to_wait)

    def _admit_or_abort(self, context, method):
        """Once the apply backlog crosses EDL_PS_MAX_PENDING_APPLIES,
        answer RESOURCE_EXHAUSTED with an ``edl-retry-after-ms`` trailer:
        the clients' pushback pacing (common/overload.py) then spreads
        their retries at the server's own hint. In-process calls
        (context=None) are never refused."""
        if context is None or self._max_pending <= 0:
            return
        depth = self._pending_depth()
        if depth < self._max_pending:
            if self._overloaded:
                self._overloaded = False
                logger.warning("PS %d overload cleared (depth %d < %d)",
                               self._ps_id, depth, self._max_pending)
                if events.enabled():
                    events.emit(
                        "ps_overload_clear", ps_id=self._ps_id,
                        depth=depth,
                    )
            return
        self._t_overload_rejections += 1
        self._m_overload_rejected.labels(method=method).inc()
        # hint = (how far past the limit) x (observed seconds per
        # apply), floored at 50 ms and capped at 2 s
        excess = max(1, depth - self._max_pending + 1)
        retry_ms = int(min(2000, max(
            50, 1000.0 * self._apply_ewma_secs * excess)))
        if not self._overloaded:
            self._overloaded = True
            logger.warning(
                "PS %d overloaded: apply backlog %d >= %d, pushing back "
                "(retry-after %dms)", self._ps_id, depth, self._max_pending,
                retry_ms,
            )
            if events.enabled():
                events.emit(
                    "ps_overload_enter", ps_id=self._ps_id,
                    depth=depth, max_pending=self._max_pending,
                    method=method,
                )
        context.set_trailing_metadata(
            ((overload.RETRY_AFTER_KEY, str(retry_ms)),)
        )
        context.abort(
            grpc.StatusCode.RESOURCE_EXHAUSTED,
            "apply backlog %d >= %d on ps-%d; retry after %dms"
            % (depth, self._max_pending, self._ps_id, retry_ms),
        )

    def push_gradients(self, request, context=None):
        self._admit_or_abort(context, "push_gradients")
        with self._pending_lock:
            self._pending_applies += 1
        started = time.monotonic()
        try:
            # the overload fault lands here, inside an occupied
            # admission slot, so its latency builds the backlog real
            # slow applies would
            injected = faults.apply_delay("push_gradients")
            if injected:
                time.sleep(injected)
            return self._push_gradients_admitted(request)
        finally:
            elapsed = time.monotonic() - started
            with self._pending_lock:
                self._pending_applies -= 1
                if self._apply_ewma_secs:
                    self._apply_ewma_secs += 0.2 * (
                        elapsed - self._apply_ewma_secs)
                else:
                    self._apply_ewma_secs = elapsed

    def _count_push_bytes(self, request):
        """Fold one push's gradient payload bytes (tensor content +
        ids, either encoding) into the counters."""
        payload = 0
        dtype = "none"
        for slices in request.gradients.embedding_tables.values():
            payload += len(slices.concat_tensors.content)
            payload += len(slices.ids_blob) or 8 * len(slices.ids)
            dtype = slices.concat_tensors.dtype or dtype
        self._t_push_bytes += payload
        if payload:
            self._m_push_bytes.labels(dtype=dtype).inc(payload)
        dense_payload = sum(
            len(blob.content)
            for blob in request.gradients.dense_parameters.values()
        )
        if dense_payload:
            self._t_push_dense_bytes += dense_payload
            self._m_push_dense_bytes.inc(dense_payload)

    def _push_gradients_admitted(self, request):
        self._t_push_count += 1
        self._t_last_push_version = request.gradients.version
        self._m_push_requests.inc()
        self._count_push_bytes(request)
        self._m_version_lag.set(
            self._store.version - request.gradients.version
        )
        if self._stopped:
            # the SIGTERM drain flushed the round buffer and saves the
            # final checkpoint: an update admitted now would be
            # acknowledged yet missing from what the successor restores
            return self._stamp(pb.PushGradientsResponse(
                accepted=False, version=self._store.version))
        if not self._use_async:
            return self._push_gradients_sync(request)
        grad_version = request.gradients.version
        lr_scale = 1.0
        if self._staleness_modulation:
            diff = self._store.version - grad_version
            lr_scale = 1.0 / max(1, diff) if diff > 0 else 1.0
        if request.lr_scale > 0:
            lr_scale *= request.lr_scale
        apply_start = time.time()
        self._apply_tables(request.gradients.embedding_tables.items(),
                           lr_scale)
        self._m_apply_seconds.labels(backend=self._backend).observe(
            time.time() - apply_start
        )
        trace.complete("ps_apply_push", apply_start, version=grad_version)
        self._store.bump_version()
        version = self._store.version
        self._maybe_checkpoint(version)
        self._maybe_report_version(version)
        return self._stamp(pb.PushGradientsResponse(accepted=True,
                                                    version=version))

    def _apply_tables(self, items, lr_scale):
        """Apply every table's pushed gradients, across the
        EDL_PS_APPLY_THREADS pool when there is one (tables are disjoint
        row spaces, and each table's apply is atomic)."""
        items = list(items)
        if self._apply_pool is not None and len(items) > 1:
            apply_one = trace.bind_context(self._apply_one)
            list(self._apply_pool.map(
                lambda pair: apply_one(pair[0], pair[1], lr_scale),
                items,
            ))
            return
        for name, slices in items:
            self._apply_one(name, slices, lr_scale)

    def _apply_one(self, name, slices, lr_scale):
        """One table's deserialize + dedup + apply: the native single
        call for a packed payload, else numpy with the same values."""
        if self._lifecycle is not None:
            mask = self._lifecycle.filter_push(name, unpack_ids(slices))
            if not mask.all():
                # gradients of ids not yet admitted are dropped: the
                # admitted subset applies through numpy (the single
                # native call has no row filter)
                if not mask.any():
                    return
                values, ids = _deserialize_gradients(slices)
                values, ids = deduplicate_indexed_slices(values[mask],
                                                         ids[mask])
                self._store.push_gradients(name, ids, values,
                                           lr_scale=lr_scale)
                return
        if self._native_store and _blob_fast_path_ok(
            self._store, name, slices
        ):
            self._store.push_gradients_blob(
                name,
                np.frombuffer(slices.ids_blob, dtype="<i8"),
                slices.concat_tensors.content,
                slices.concat_tensors.dtype,
                lr_scale=lr_scale,
            )
            return
        values, ids = _deserialize_gradients(slices)
        values, ids = deduplicate_indexed_slices(values, ids)
        self._store.push_gradients(name, ids, values, lr_scale=lr_scale)

    def push_embedding_rows(self, request, context=None):
        """Device-tier writeback: raw row values overwrite the store, no
        optimizer math and no version bump (the values carry every
        update the tier applied on the card). Existing rows keep their
        optimizer slots; unseen rows materialize fresh."""
        if self._stopped:
            # SIGTERM drain: the final checkpoint would not hold these
            # rows; refuse, so the client reports the loss
            return self._stamp(pb.PushGradientsResponse(
                accepted=False, version=self._store.version))
        self._m_rows_written.inc(
            sum(
                len(slices.ids) or len(slices.ids_blob) // 8
                for slices in request.embedding_tables.values()
            )
        )
        for name, slices in request.embedding_tables.items():
            if self._native_store and _blob_fast_path_ok(
                self._store, name, slices
            ):
                self._store.import_blob(
                    name,
                    np.frombuffer(slices.ids_blob, dtype="<i8"),
                    slices.concat_tensors.content,
                    slices.concat_tensors.dtype,
                )
                continue
            values, ids = _deserialize_gradients(slices)
            self._store.import_table(name, ids, values)
        if self._lifecycle is not None:
            # writebacks are authoritative: the rows exist now, so they
            # are admitted (and their TTL refreshed), or the eviction
            # bound would never see them age out. A device tier's
            # writeback carries in ``dense_parameters[table]`` the
            # sightings it absorbed, aligned with the table's ids
            for name, slices in request.embedding_tables.items():
                sightings = (blob_to_ndarray(request.dense_parameters[name])
                             if name in request.dense_parameters else None)
                self._lifecycle.note_import(name, unpack_ids(slices),
                                            sightings)
        return self._stamp(pb.PushGradientsResponse(
            accepted=True, version=self._store.version))

    def _push_gradients_sync(self, request):
        """Sync SGD: accumulate grads_to_wait pushes, reject stale ones,
        merge and apply once, bump the version. Deserialization runs
        before the lock: it is per-request work.

        Two pairing disciplines:

        - counting (the default, the reference's semantics): the first
          grads_to_wait accepted pushes form a round, whoever sent them;
        - round-scoped (``request.round_scoped``, lockstep trainers whose
          tags are global round counters): pushes group BY TAG and a
          round applies only when its own tag's group fills.
        """
        tables = {
            name: _deserialize_gradients(slices)
            for name, slices in request.gradients.embedding_tables.items()
        }
        # events decided under the push lock, written after it (a slow
        # journal flush must not serialize every worker's push)
        journal = []
        try:
            return self._push_gradients_sync_locked(request, tables,
                                                    journal)
        finally:
            for event, fields in journal:
                events.emit(event, **fields)

    def _push_gradients_sync_locked(self, request, tables, journal):
        grad_version = request.gradients.version
        with self._push_lock:
            version = self._store.version
            if self._stopped:
                # lost the race against graceful_stop: the buffer this
                # push would join was already flushed
                self._m_push_rejected.inc()
                return self._stamp(pb.PushGradientsResponse(
                    accepted=False, version=version))
            if grad_version < version - self._sync_tolerance:
                self._m_push_rejected.inc()
                journal.append((
                    "stale_push_rejected",
                    dict(
                        worker=(
                            request.worker_id
                            if request.HasField("worker_id") else -1
                        ),
                        version=grad_version, store_version=version,
                    ),
                ))
                return self._stamp(pb.PushGradientsResponse(
                    accepted=False, version=version))
            # lr_scale rides beside the raw grads to the apply (folding
            # it into adam's gradients would be a no-op): the round
            # applies at the mean of its pushes' scales
            push_scale = request.lr_scale if request.lr_scale > 0 else 1.0
            key = None
            if request.HasField("worker_id"):
                # incarnations are monotonic: evict buffered entries of
                # OLDER incarnations of this worker; a delayed push of a
                # dead incarnation arriving after its successor's is
                # itself the orphan and is dropped (accepted=True keeps
                # the dead sender happy). No incarnation: replace by
                # worker_id.
                incarnation = (request.incarnation
                               if request.HasField("incarnation") else None)
                key = (request.worker_id, incarnation)
                same_worker = [
                    entry for entry in self._buffered_entries()
                    if entry[0] is not None
                    and entry[0][0] == request.worker_id
                    and (incarnation is None or entry[0][1] != incarnation)
                ]
                if incarnation is not None and any(
                    e[0][1] is not None and e[0][1] > incarnation
                    for e in same_worker
                ):
                    logger.warning(
                        "sync PS: dropping a delayed push from worker %d's "
                        "dead incarnation %d (a newer incarnation already "
                        "holds this round)", request.worker_id, incarnation,
                    )
                    self._m_push_dropped_dead.inc()
                    journal.append((
                        "dead_incarnation_dropped",
                        dict(worker=request.worker_id,
                             incarnation=incarnation, version=version),
                    ))
                    return self._stamp(pb.PushGradientsResponse(
                        accepted=True, version=version))
                for entry in same_worker:
                    self._remove_buffered_locked(entry)
                    logger.warning(
                        "sync PS: worker %d re-pushed at version %d under "
                        "a new incarnation; dropping its dead "
                        "predecessor's buffered half-round",
                        request.worker_id, version,
                    )
            entry = (key, tables, push_scale)
            if events.enabled():
                # round_open on the first push buffered toward this
                # round (per tag for scoped pushers), round_fill on
                # every buffered push: the journal's answer to "why did
                # the sync round stop filling"
                if request.round_scoped:
                    opened = not self._round_groups.get(grad_version)
                else:
                    opened = not self._round_buffer
                if opened:
                    journal.append(
                        ("round_open", dict(version=grad_version))
                    )
                journal.append((
                    "round_fill",
                    dict(
                        version=grad_version,
                        fill=self._buffered_count() + 1,
                        worker=(
                            request.worker_id
                            if request.HasField("worker_id") else -1
                        ),
                    ),
                ))
            if request.round_scoped:
                group = self._round_groups.setdefault(grad_version, [])
                if key is not None:
                    # tag + identity name one logical push: a transport
                    # re-send replaces it, never counts twice
                    group[:] = [e for e in group if e[0] != key]
                group.append(entry)
                if len(group) < self._grads_to_wait:
                    return self._stamp(pb.PushGradientsResponse(
                        accepted=True, version=version))
                del self._round_groups[grad_version]
                self._apply_round_locked(group, journal)
            else:
                self._round_buffer.append(entry)
                if len(self._round_buffer) < self._grads_to_wait:
                    return self._stamp(pb.PushGradientsResponse(
                        accepted=True, version=version))
                self._apply_round_locked(self._round_buffer, journal)
                self._round_buffer = []
            self._store.bump_version()
            version = self._store.version
        self._maybe_checkpoint(version)
        self._maybe_report_version(version)
        return self._stamp(pb.PushGradientsResponse(accepted=True,
                                                    version=version))

    def _buffered_entries(self):
        yield from self._round_buffer
        for group in self._round_groups.values():
            yield from group

    def _remove_buffered_locked(self, entry):
        # by IDENTITY: entries hold numpy arrays, and list equality
        # would compare a key-equal neighbour's arrays on the way
        kept = [e for e in self._round_buffer if e is not entry]
        if len(kept) != len(self._round_buffer):
            self._round_buffer[:] = kept
            return
        for tag, group in list(self._round_groups.items()):
            kept = [e for e in group if e is not entry]
            if len(kept) != len(group):
                if kept:
                    group[:] = kept
                else:
                    del self._round_groups[tag]
                return

    def _apply_round_locked(self, entries, journal):
        """Merge and apply one completed round (the caller holds the
        push lock and bumps the version), then drop scoped groups whose
        tag can no longer fill. ``journal`` collects the events the
        caller writes after the lock."""
        with trace.span(
            "ps_apply_round", version=self._store.version,
            pushes=len(entries),
        ):
            self._merge_apply_locked(entries, journal)
        journal.append((
            "round_close",
            dict(version=self._store.version, pushes=len(entries)),
        ))
        floor = self._store.version - self._sync_tolerance
        for tag in [t for t in self._round_groups if t < floor]:
            logger.warning(
                "sync PS: dropping %d unfillable buffered push(es) at "
                "stale round tag %d", len(self._round_groups[tag]), tag,
            )
            del self._round_groups[tag]

    def _merge_apply_locked(self, entries, journal=None):
        scales = [s for _, _, s in entries]
        apply_scale = sum(scales) / len(scales)
        merged = {}  # name -> ([values...], [ids...])
        for _, tables, scale in entries:
            for name, (values, ids) in tables.items():
                # unequal scales: re-weight each push by
                # scale / apply_scale (exact for SGD; the ratio is 1 in
                # the equal-schedule case)
                if scale != apply_scale:
                    values = values * (scale / apply_scale)
                bucket = merged.setdefault(name, ([], []))
                bucket[0].append(values)
                bucket[1].append(ids)
        for name, (values_list, ids_list) in merged.items():
            values, ids = deduplicate_indexed_slices(
                np.concatenate(values_list, axis=0),
                np.concatenate(ids_list, axis=0),
            )
            if self._lifecycle is not None:
                # the admission gate under the push lock: its events
                # ride the round's journal, written after the lock
                mask = self._lifecycle.filter_push(name, ids,
                                                   journal=journal)
                if not mask.any():
                    continue
                values, ids = values[mask], ids[mask]
            self._store.push_gradients(name, ids, values,
                                       lr_scale=apply_scale)

    def graceful_stop(self):
        """SIGTERM drain: apply whatever the round buffer holds (an
        under-filled round applied beats losing its pushes), refuse every
        later push, then save a final full checkpoint so the successor
        restores the newest state. Idempotent; a failed flush or save
        does not stop the exit."""
        journal = []
        with self._push_lock:
            if self._stopped:
                return
            self._stopped = True
            entries = list(self._buffered_entries())
            if entries:
                logger.warning("SIGTERM with %d buffered push(es); applying "
                               "the partial round before exit", len(entries))
                try:
                    self._apply_round_locked(entries, journal)
                    self._round_buffer = []
                    self._round_groups = {}
                    self._store.bump_version()
                except Exception:
                    logger.exception("partial-round flush failed at SIGTERM")
            version = self._store.version
        for event, fields in journal:
            events.emit(event, **fields)
        if self._ckpt_async is not None:
            # abandon what is pending: the final full save below
            # supersedes every enqueued delta
            self._ckpt_async.stop(drain=False)
        if self._checkpoint_saver is not None:
            try:
                self._save_checkpoint_now(version, "sparse_final",
                                          force_full=True)
                logger.info("final sparse checkpoint saved at version %d",
                            version)
            except Exception:  # the exit goes on
                logger.exception("final sparse checkpoint failed")

    # ------------------------------------------------------------------
    # the poll loop's work (ps/server.py), never on an RPC handler

    def lifecycle_tick(self):
        """One TTL/LFU eviction sweep; None without a lifecycle, else
        the sweep's {"ttl": n, "lfu": n} eviction counts."""
        if self._lifecycle is None:
            return None
        t0 = time.monotonic()
        swept = self._lifecycle.sweep()
        stats = self._lifecycle.stats()
        logger.info(
            "lifecycle sweep: evicted ttl %d lfu %d in %.4f s; resident "
            "rows %s; in flight %s; totals admitted %d evicted ttl %d lfu "
            "%d, grad rows dropped %d", swept["ttl"], swept["lfu"],
            time.monotonic() - t0,
            json.dumps({name: rows for name, (rows, _) in
                        self._lifecycle.last_sweep_rows.items()},
                       sort_keys=True),
            json.dumps({name: flying for name, (_, flying) in
                        self._lifecycle.last_sweep_rows.items()},
                       sort_keys=True),
            stats["rows_admitted"], stats["rows_evicted_ttl"],
            stats["rows_evicted_lfu"], stats["grad_rows_dropped"])
        return swept

    def table_health_scan(self, force=False):
        """Sampled per-table row-norm percentiles, the shard's dead-row
        fraction from the lifecycle books and the count of sampled rows
        whose norm exceeds EDL_HEALTH_ROW_NORM_MAX. Rate-limited by
        EDL_HEALTH_SCAN_SECS; exports each table once a scan and samples
        at most EDL_HEALTH_SCAN_SAMPLE rows of it. Returns the scan, or
        None when skipped (rate limit, EDL_HEALTH=0)."""
        if not self._health_scan_on:
            return None
        now = time.time()
        if not force and now - self._health_scan_at < self._health_scan_secs:
            return None
        self._health_scan_at = now
        pooled = []
        exploding_total = 0
        per_table = {}
        for name in self._store.table_names():
            try:
                size = self._store.table_size(name)
            except KeyError:
                continue
            if size > self._health_scan_max_rows:
                # the export copies the whole table under its lock:
                # past the cap that copy stalls the data plane
                if name not in self._health_scan_skipped:
                    self._health_scan_skipped.add(name)
                    logger.warning(
                        "table-health scan skipping %s: %d resident rows "
                        "> %s=%d (the scan's full-table export would "
                        "stall pushes)", name, size,
                        HEALTH_SCAN_MAX_ROWS_ENV, self._health_scan_max_rows,
                    )
                continue
            try:
                _ids, values = self._store.export_table(name)
            except KeyError:
                continue
            if values.shape[0] == 0:
                continue
            if values.shape[0] > self._health_sample:
                stride = values.shape[0] // self._health_sample
                values = values[::stride][: self._health_sample]
            norms = np.sqrt(
                np.sum(np.square(values.astype(np.float32)), axis=1))
            p50 = float(np.percentile(norms, 50))
            p99 = float(np.percentile(norms, 99))
            exploding = int(np.sum(norms > self._row_norm_max))
            self._m_row_norm.labels(table=name, quantile="p50").set(p50)
            self._m_row_norm.labels(table=name, quantile="p99").set(p99)
            self._m_exploding.labels(table=name).set(exploding)
            pooled.append(norms)
            exploding_total += exploding
            per_table[name] = {"p50": p50, "p99": p99,
                               "exploding": exploding,
                               "sampled": int(norms.size)}
        if pooled:
            norms = np.concatenate(pooled)
            self._t_row_norm_p50 = float(np.percentile(norms, 50))
            self._t_row_norm_p99 = float(np.percentile(norms, 99))
        dead_fraction = 0.0
        if self._lifecycle is not None:
            stats = self._lifecycle.stats()
            evicted = stats["rows_evicted_ttl"] + stats["rows_evicted_lfu"]
            alive = stats["resident_rows"]
            if evicted + alive > 0:
                dead_fraction = evicted / float(evicted + alive)
        self._m_dead_fraction.set(dead_fraction)
        self._t_dead_row_fraction = dead_fraction
        if exploding_total > 0 and self._t_exploding_rows == 0:
            # the edge only: a chronically hot table must not flood the
            # journal once a scan
            events.emit(
                "health_table_exploding", ps=self._ps_id,
                rows=exploding_total,
                tables=sorted(t for t, d in per_table.items()
                              if d["exploding"]),
                norm_max=self._row_norm_max,
            )
        self._t_exploding_rows = exploding_total
        return {"tables": per_table, "dead_row_fraction": dead_fraction,
                "exploding_rows": exploding_total}

    def maybe_stream_checkpoint(self, watermark, every):
        """The streaming checkpoint cadence: with no epoch boundaries,
        durability rides the master's record watermark, one sparse
        checkpoint each time it crosses a boundary of ``every`` records.
        A fresh PS saves from the first boundary crossed; a PS that
        restored a checkpoint anchors at its first observed watermark
        (its predecessor covered those boundaries). True when a save
        was requested."""
        if self._checkpoint_saver is None or every <= 0 or watermark <= 0:
            return False
        boundary = int(watermark) // int(every)
        last = self._stream_ckpt_boundary
        if last is None:
            last = boundary if self._restored_wire else 0
            self._stream_ckpt_boundary = last
        if boundary <= last:
            return False
        self._stream_ckpt_boundary = boundary
        version = self._store.version
        events.emit("stream_watermark", watermark=int(watermark),
                    kind="checkpoint")
        logger.info("stream checkpoint at watermark %d (version %d)",
                    watermark, version)
        return self._request_checkpoint(version, "sparse_stream")

    def _save_checkpoint_now(self, version, kind, force_full=False):
        """One synchronous save, shared by the inline path, the
        checkpoint thread and the SIGTERM final save; raises on
        failure."""
        start = time.monotonic()
        result = self._checkpoint_saver.save(version, self._store,
                                             force_full=force_full)
        elapsed = time.monotonic() - start
        logger.info("checkpoint %s at version %d: %s, %d rows, %d "
                    "tombstones, chain %d, %.3f s", kind, version,
                    result.kind, result.rows, result.tombstones,
                    result.chain_len, elapsed)
        self._m_ckpt_seconds.labels(kind=result.kind).observe(elapsed)
        self._m_ckpt_dirty_rows.set(result.rows)
        self._m_ckpt_chain_len.set(result.chain_len)
        self._t_ckpt_dirty_rows = result.rows
        self._t_ckpt_chain_len = result.chain_len
        events.emit(
            "checkpoint_saved", version=version, kind=kind,
            mode=result.kind, rows=result.rows,
            tombstones=result.tombstones, chain_len=result.chain_len,
        )

    def _request_checkpoint(self, version, kind):
        """Trigger a save at ``version``: enqueue it on the checkpoint
        thread (bursts coalesce into the newest version), or save inline
        under EDL_CKPT_ASYNC=0. True when enqueued or saved; a failed
        inline save logs and returns False (it must never fail the push
        that tripped the cadence)."""
        if self._ckpt_async is not None:
            return self._ckpt_async.request(version, kind)
        try:
            self._save_checkpoint_now(version, kind)
            return True
        except Exception:
            logger.exception("sparse checkpoint failed")
            return False

    def finish_checkpoints(self, timeout=30.0):
        """Drain the checkpoint thread (orderly exits: an enqueued save
        must land before the process ends)."""
        if self._ckpt_async is not None:
            self._ckpt_async.stop(drain=True, timeout=timeout)

    def _maybe_checkpoint(self, version):
        if (self._checkpoint_saver is not None
                and self._checkpoint_steps > 0
                and version % self._checkpoint_steps == 0):
            self._request_checkpoint(version, "sparse")

    def _maybe_report_version(self, version):
        """The store's newest version goes to the master (the evaluation
        service's version trigger), off this handler's thread."""
        if self._reporter is not None:
            self._reporter.offer(version)


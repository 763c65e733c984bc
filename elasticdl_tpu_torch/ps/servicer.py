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

Not ported (ROADMAP): the stream checkpoint
(``maybe_stream_checkpoint``), the checkpoint metrics series and
events, the embedding lifecycle, the table-health scan,
``telemetry_blob``, the other metrics series and the events journal,
the master's version reports and fault injection.
"""

import concurrent.futures
import sys
import threading
import time

import grpc
import numpy as np

from elasticdl_tpu_torch.common import overload
from elasticdl_tpu_torch.common.env_utils import env_int
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
from elasticdl_tpu_torch.proto import elasticdl_tpu_pb2 as pb
from elasticdl_tpu_torch.ps.checkpoint import AsyncCheckpointer
from elasticdl_tpu_torch.ps.embedding_store import (
    BLOB_DTYPE_CODES,
    BLOB_ITEMSIZE,
    parse_initializer,
)

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


class PserverServicer:
    def __init__(self, store, ps_id=0, staleness_modulation=True,
                 checkpoint_saver=None, checkpoint_steps=0, use_async=True,
                 grads_to_wait=1, sync_version_tolerance=0,
                 restored_version=None):
        """``use_async`` defaults to True for the bare constructor;
        the server entry point passes its flag (default sync).
        ``restored_version`` is the checkpoint version the PS restored
        at boot (None: none)."""
        self._store = store
        self._ps_id = ps_id
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
            return blob
        values = self._store.lookup(name, ids)
        return ndarray_to_blob(values, blob,
                               wire_dtype=wire_dtype() if reduced_ok else None)

    def pull_embedding_vectors(self, request, context=None):
        self._admit_or_abort(context, "pull_embedding_vectors")
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
            return
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

    def _push_gradients_admitted(self, request):
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
        self._apply_tables(request.gradients.embedding_tables.items(),
                           lr_scale)
        self._store.bump_version()
        version = self._store.version
        self._maybe_checkpoint(version)
        return self._stamp(pb.PushGradientsResponse(accepted=True,
                                                    version=version))

    def _apply_tables(self, items, lr_scale):
        """Apply every table's pushed gradients, across the
        EDL_PS_APPLY_THREADS pool when there is one (tables are disjoint
        row spaces, and each table's apply is atomic)."""
        items = list(items)
        if self._apply_pool is not None and len(items) > 1:
            list(self._apply_pool.map(
                lambda pair: self._apply_one(pair[0], pair[1], lr_scale),
                items,
            ))
            return
        for name, slices in items:
            self._apply_one(name, slices, lr_scale)

    def _apply_one(self, name, slices, lr_scale):
        """One table's deserialize + dedup + apply: the native single
        call for a packed payload, else numpy with the same values."""
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
        grad_version = request.gradients.version
        with self._push_lock:
            version = self._store.version
            if self._stopped:
                # lost the race against graceful_stop: the buffer this
                # push would join was already flushed
                return self._stamp(pb.PushGradientsResponse(
                    accepted=False, version=version))
            if grad_version < version - self._sync_tolerance:
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
                self._apply_round_locked(group)
            else:
                self._round_buffer.append(entry)
                if len(self._round_buffer) < self._grads_to_wait:
                    return self._stamp(pb.PushGradientsResponse(
                        accepted=True, version=version))
                self._apply_round_locked(self._round_buffer)
                self._round_buffer = []
            self._store.bump_version()
            version = self._store.version
        self._maybe_checkpoint(version)
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

    def _apply_round_locked(self, entries):
        """Merge and apply one completed round (the caller holds the
        push lock and bumps the version), then drop scoped groups whose
        tag can no longer fill."""
        self._merge_apply_locked(entries)
        floor = self._store.version - self._sync_tolerance
        for tag in [t for t in self._round_groups if t < floor]:
            logger.warning(
                "sync PS: dropping %d unfillable buffered push(es) at "
                "stale round tag %d", len(self._round_groups[tag]), tag,
            )
            del self._round_groups[tag]

    def _merge_apply_locked(self, entries):
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
            self._store.push_gradients(name, ids, values,
                                       lr_scale=apply_scale)

    def graceful_stop(self):
        """SIGTERM drain: apply whatever the round buffer holds (an
        under-filled round applied beats losing its pushes), refuse every
        later push, then save a final full checkpoint so the successor
        restores the newest state. Idempotent; a failed flush or save
        does not stop the exit."""
        with self._push_lock:
            if self._stopped:
                return
            self._stopped = True
            entries = list(self._buffered_entries())
            if entries:
                logger.warning("SIGTERM with %d buffered push(es); applying "
                               "the partial round before exit", len(entries))
                try:
                    self._apply_round_locked(entries)
                    self._round_buffer = []
                    self._round_groups = {}
                    self._store.bump_version()
                except Exception:
                    logger.exception("partial-round flush failed at SIGTERM")
            version = self._store.version
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

    def _save_checkpoint_now(self, version, kind, force_full=False):
        """One synchronous save, shared by the inline path, the
        checkpoint thread and the SIGTERM final save; raises on
        failure."""
        start = time.monotonic()
        result = self._checkpoint_saver.save(version, self._store,
                                             force_full=force_full)
        logger.info("checkpoint %s at version %d: %s, %d rows, %d "
                    "tombstones, chain %d, %.3f s", kind, version,
                    result.kind, result.rows, result.tombstones,
                    result.chain_len, time.monotonic() - start)

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

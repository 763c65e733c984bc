"""Worker-side PS client: id-mod sharding and per-shard fan-out (port of
elasticdl_tpu/worker/ps_client.py).

Embedding rows live on PS shard ``id % ps_num``. Pulls and pushes fan
out over the shards concurrently and reassemble in input order;
gradients are deduplicated before they are split. Every RPC retries
connection-shaped failures with full-jitter backoff inside a budget
(``common/grpc_utils.retry_call``) behind a per-shard circuit breaker
and retry budget (``common/overload.py``).

A client talks to the PS of either package: the service, its methods
and the messages are the same.

Each pull and push is a span (``ps_pull``, ``ps_pull_batch``,
``ps_push_rows``, ``ps_push``) whose context rides the per-shard pool
threads (``trace.bind_context``) onto the wire; the channels carry the
client metrics interceptor when metrics are on, and a shard's relaunch
journals ``worker_resynced``.
"""

import concurrent.futures
import threading
from typing import NamedTuple, Tuple

import grpc
import numpy as np

from elasticdl_tpu_torch.common import overload
from elasticdl_tpu_torch.common.constants import GRPC
from elasticdl_tpu_torch.common.grpc_utils import build_channel, retry_call
from elasticdl_tpu_torch.common.log_utils import (
    default_logger as _logger_factory,
)
from elasticdl_tpu_torch.observability import events, trace
from elasticdl_tpu_torch.observability.grpc_metrics import instrument_channel
from elasticdl_tpu_torch.common.tensor_utils import (
    blob_to_f32,
    blob_to_ndarray,
    deduplicate_indexed_slices,
    ndarray_to_blob,
    normalize_id_tables,
    pack_ids,
    serialize_indexed_slices,
    wire_dtype,
)
from elasticdl_tpu_torch.proto import elasticdl_tpu_pb2 as pb
from elasticdl_tpu_torch.proto.services import PserverStub

logger = _logger_factory("elasticdl_tpu_torch.worker.ps_client")

# A PS relaunch takes tens of seconds: UNAVAILABLE / DEADLINE_EXCEEDED
# retry with backoff up to this budget; anything else surfaces at once.
PS_RETRY_BUDGET_SECS = 120.0


def _call_with_retry(fn, what, budget_secs=None, channel=None, target=None,
                     fail_fast_when_open=False):
    return retry_call(
        fn,
        "PS %s" % what,
        PS_RETRY_BUDGET_SECS if budget_secs is None else budget_secs,
        # the backoff drives this shard's channel reconnection
        channel=channel,
        # target arms the per-shard breaker, retry budget and pushback
        target=target,
        fail_fast_when_open=fail_fast_when_open,
    )


def _timeout():
    return overload.rpc_timeout(GRPC.DEFAULT_RPC_TIMEOUT_SECS)


class PushResult(NamedTuple):
    """Outcome of a gradient push; a 2-tuple (accepted, version) also
    satisfies consumers that do not retry per shard."""

    accepted: bool
    version: int
    rejected_shards: Tuple[int, ...] = ()


class PSClient:
    def __init__(self, ps_addrs, worker_id=None, incarnation=None):
        if isinstance(ps_addrs, str):
            ps_addrs = [a for a in ps_addrs.split(",") if a]
        self._addrs = list(ps_addrs)
        self._channels = [instrument_channel(build_channel(a))
                          for a in self._addrs]
        self._stubs = [PserverStub(ch) for ch in self._channels]
        # identity stamped onto pushes so the sync PS can clean its
        # round buffer per worker; None = anonymous. The incarnation
        # must be monotonic per worker_id across relaunches (the PS
        # orders them), so only a master-assigned one is used: without
        # it pushes carry none, and the PS replaces by worker_id.
        self._worker_id = worker_id
        self._incarnation = (int(incarnation) if incarnation is not None
                             else None)
        if incarnation is None and worker_id is not None:
            logger.warning(
                "PSClient for worker %s has no master-assigned relaunch "
                "epoch; pushing without an incarnation", worker_id,
            )
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=max(4, len(self._stubs))
        )
        # PS-restart detection: a shard's store version only grows in
        # one process lifetime, so a push response BELOW the highest
        # seen from that shard means it relaunched. Then the client
        # re-pushes the cached dense init, fires ``resync_hook`` (the
        # sparse preparer re-registers its tables) and reports the
        # shard's version so the trainer rolls back to it.
        self._version_lock = threading.Lock()
        self._shard_versions = {}  # shard -> highest seen store version
        # shard -> last seen restored_version stamp; a change means a
        # relaunch even when the version did not regress
        self._shard_restored = {}
        self._dense_init = None  # (params, version) last pushed
        self.resync_hook = None  # callable(shard); the preparer installs
        # per-shard push requests reused across steps (Clear() keeps
        # the arena): sound because a client pushes one step at a time
        # (the trainers' depth-1 barrier) and _push_gradients collects
        # every shard's future before returning
        self._push_requests = [pb.PushGradientsRequest()
                               for _ in self._stubs]
        # an old server answers the fused pull with UNIMPLEMENTED once;
        # from then on pulls go per table and every id travels in the
        # legacy repeated field (a pre-ids_blob server reads only `ids`)
        self._batch_pull_supported = True
        self._legacy_ids = False
        # table-level pool of the legacy fallback, never self._pool: a
        # per-table task there blocks on per-shard sub-tasks queued in
        # the same pool, which deadlocks with >= max_workers tables
        self._table_pool = None

    @property
    def ps_num(self):
        return len(self._stubs)

    # ------------------------------------------------------------------
    def push_embedding_table_infos(self, infos):
        """infos: [(name, dim, initializer)] broadcast to every PS."""
        request = pb.Model()
        for name, dim, init_spec in infos:
            request.embedding_table_infos.add(
                name=name, dim=dim, initializer=str(init_spec)
            )
        list(self._pool.map(
            lambda shard: _call_with_retry(
                lambda stub=shard[0]: stub.push_embedding_table_infos(
                    request, timeout=_timeout()),
                "push_embedding_table_infos",
                channel=shard[1], target=shard[2],
            ),
            zip(self._stubs, self._channels, self._addrs),
        ))

    def _note_version(self, shard, version, restored_wire):
        """Fold one push response's version into the shard's monotonic
        expectation; on a regression resync that shard. True when a
        regression was handled."""
        with self._version_lock:
            last = self._shard_versions.get(shard)
            regressed = last is not None and version < last
            last_restored = self._shard_restored.get(shard)
            restarted = (last_restored is not None
                         and restored_wire != last_restored)
            self._shard_versions[shard] = version
            self._shard_restored[shard] = restored_wire
        if not regressed and not restarted:
            return False
        self._resync_shard(shard, version, restored_wire, last)
        return True

    def _note_restored(self, shard, restored_wire):
        """A pull response carries only the boot-restore stamp: a
        changed stamp still means a relaunch, caught one pull earlier
        than the next push's version regression."""
        with self._version_lock:
            last_restored = self._shard_restored.get(shard)
            restarted = (last_restored is not None
                         and restored_wire != last_restored)
            self._shard_restored[shard] = restored_wire
            if restarted:
                # the next push's restored version must not read as a
                # second regression
                self._shard_versions.pop(shard, None)
        if not restarted:
            return False
        self._resync_shard(shard, None, restored_wire, None)
        return True

    def _resync_shard(self, shard, version, restored_wire, last):
        restored = restored_wire - 1 if restored_wire > 0 else None
        logger.warning(
            "PS shard %d relaunched (version %s, %s seen; restored "
            "checkpoint: %s); resyncing%s", shard,
            version if version is not None else "n/a",
            last if last is not None else "n/a",
            restored if restored is not None else "none",
            " and adopting its version" if version is not None else "",
        )
        if self._dense_init is not None:
            params, dense_version = self._dense_init
            request = pb.Model(version=dense_version)
            for name, array in params.items():
                ndarray_to_blob(np.asarray(array),
                                request.dense_parameters[name])
            try:
                # first writer wins on the PS: the relaunched process
                # has no dense state, so this lands
                _call_with_retry(
                    lambda: self._stubs[shard].push_model(
                        request, timeout=_timeout()),
                    "push_model (resync)",
                    channel=self._channels[shard],
                    target=self._addrs[shard],
                )
            except grpc.RpcError:
                logger.warning("dense re-init to PS %d failed", shard)
        hook = self.resync_hook
        if hook is not None:
            hook(shard)
        events.emit(
            "worker_resynced", shard=shard,
            version=version if version is not None else -1,
            restored=restored if restored is not None else -1,
            worker=self._worker_id if self._worker_id is not None else -1,
        )

    def push_dense_init(self, params, version=0):
        self._dense_init = (dict(params), version)
        request = pb.Model(version=version)
        for name, array in params.items():
            ndarray_to_blob(np.asarray(array), request.dense_parameters[name])
        list(self._pool.map(
            lambda stub: stub.push_model(request, timeout=_timeout()),
            self._stubs,
        ))

    def pull_dense_init(self, version=-1):
        """Returns (initialized, version, params) from PS 0."""
        response = self._stubs[0].pull_dense_parameters(
            pb.PullDenseParametersRequest(version=version),
            timeout=_timeout(),
        )
        params = {
            name: blob_to_ndarray(blob)
            for name, blob in response.dense_parameters.items()
        }
        return response.initialized, response.version, params

    def _pull_request(self, name, ids):
        if self._legacy_ids:
            return pb.PullEmbeddingVectorsRequest(name=name, ids=ids.tolist())
        return pb.PullEmbeddingVectorsRequest(name=name,
                                              ids_blob=pack_ids(ids))

    # ------------------------------------------------------------------
    def pull_embedding_vectors(self, name, ids):
        """ids: int64 array; returns fp32 rows aligned with input
        order."""
        with trace.span("ps_pull", table=name):
            return self._pull_embedding_vectors(name, ids)

    def _pull_embedding_vectors(self, name, ids):
        ids = np.asarray(ids, dtype=np.int64)
        if ids.size == 0:
            return np.empty((0, 0), dtype=np.float32)
        fail_fast = overload.brownout_enabled()
        if self.ps_num == 1:
            request = self._pull_request(name, ids)
            blob = _call_with_retry(
                lambda: self._stubs[0].pull_embedding_vectors(
                    request, timeout=_timeout()),
                "pull_embedding_vectors",
                channel=self._channels[0], target=self._addrs[0],
                fail_fast_when_open=fail_fast,
            )
            return blob_to_f32(blob)
        shard_of = ids % self.ps_num
        futures, positions = {}, {}
        # bind_budget: a caller's deadline budget rides into the pool
        call = overload.bind_budget(trace.bind_context(_call_with_retry))
        for shard in np.unique(shard_of):
            shard = int(shard)
            pos = np.nonzero(shard_of == shard)[0]
            positions[shard] = pos
            request = self._pull_request(name, ids[pos])
            stub = self._stubs[shard]
            futures[shard] = self._pool.submit(
                call,
                lambda stub=stub, request=request:
                    stub.pull_embedding_vectors(request, timeout=_timeout()),
                "pull_embedding_vectors",
                channel=self._channels[shard], target=self._addrs[shard],
                fail_fast_when_open=fail_fast,
            )
        rows = None
        for shard, future in futures.items():
            values = blob_to_f32(future.result())
            if rows is None:
                rows = np.empty((ids.size, values.shape[1]), np.float32)
            rows[positions[shard]] = values
        return rows

    # ------------------------------------------------------------------
    def _pull_per_table(self, ids_by_table):
        """Legacy fallback: per-table pulls fanned out on their own
        pool (see __init__'s _table_pool)."""
        if self._table_pool is None:
            self._table_pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=max(4, len(ids_by_table)),
                thread_name_prefix="ps-table-pull",
            )
        pull = overload.bind_budget(
            trace.bind_context(self._pull_embedding_vectors)
        )
        futures = {
            name: self._table_pool.submit(pull, name, ids)
            for name, ids in ids_by_table.items()
        }
        return {name: future.result() for name, future in futures.items()}

    def pull_embedding_batch(self, ids_by_table):
        """Fused multi-table pull: ``{table: int64 ids}`` in, ``{table:
        fp32 rows aligned with that table's ids}`` out, one RPC per PS
        shard for the whole step. Falls back to per-table pulls against
        an old server (UNIMPLEMENTED, remembered)."""
        with trace.span("ps_pull_batch", tables=len(ids_by_table)):
            return self._pull_embedding_batch(ids_by_table)

    def _pull_embedding_batch(self, ids_by_table):
        ids_by_table = normalize_id_tables(ids_by_table)
        if not ids_by_table:
            return {}
        if not self._batch_pull_supported:
            return self._pull_per_table(ids_by_table)
        # per-shard request holding every table's id slice for it
        requests = [pb.BatchedSlices() for _ in self._stubs]
        positions = {}  # (name, shard) -> input positions
        for name, ids in ids_by_table.items():
            if self.ps_num == 1:
                requests[0].tables[name].ids_blob = pack_ids(ids)
                continue
            shard_of = ids % self.ps_num
            for shard in np.unique(shard_of):
                shard = int(shard)
                pos = np.nonzero(shard_of == shard)[0]
                positions[(name, shard)] = pos
                requests[shard].tables[name].ids_blob = pack_ids(ids[pos])
        futures = {}
        call = overload.bind_budget(trace.bind_context(_call_with_retry))
        fail_fast = overload.brownout_enabled()
        for shard, request in enumerate(requests):
            if not request.tables:
                continue
            stub = self._stubs[shard]
            futures[shard] = self._pool.submit(
                call,
                lambda stub=stub, request=request:
                    stub.pull_embedding_batch(request, timeout=_timeout()),
                "pull_embedding_batch",
                channel=self._channels[shard], target=self._addrs[shard],
                fail_fast_when_open=fail_fast,
            )
        out = {}
        try:
            for shard, future in futures.items():
                response = future.result()
                self._note_restored(shard, response.restored_version)
                for name, blob in response.tables.items():
                    values = blob_to_f32(blob)
                    if self.ps_num == 1:
                        out[name] = values
                        continue
                    rows = out.get(name)
                    if rows is None:
                        rows = np.empty(
                            (ids_by_table[name].size, values.shape[1]),
                            np.float32)
                        out[name] = rows
                    rows[positions[(name, shard)]] = values
        except grpc.RpcError as e:
            if e.code() != grpc.StatusCode.UNIMPLEMENTED:
                raise
            # old server: remember, and serve this pull per table (pulls
            # are read-only, so re-pulling answered shards is harmless)
            logger.warning(
                "PS does not serve pull_embedding_batch; falling back to "
                "per-table pulls and the legacy repeated-id encoding"
            )
            self._batch_pull_supported = False
            self._legacy_ids = True
            return self._pull_per_table(ids_by_table)
        return out

    def push_embedding_rows(self, rows_by_table, sightings=None):
        """Device-tier writeback: ``{table: (ids, values)}`` raw row
        values overwriting the PS store. Always fp32 on the wire,
        whatever EDL_WIRE_DTYPE says: these are master copies, and a
        reduced payload would round them for good. ``sightings``
        (optional, ``{table: int64 counts aligned with its ids}``) are
        the PS sightings the tier absorbed since it last wrote each row
        back; each shard's share rides in its request's
        ``dense_parameters[table]``, which a writeback has no other use
        for, and which a PS without an embedding lifecycle ignores."""
        with trace.span("ps_push_rows", tables=len(rows_by_table)):
            return self._push_embedding_rows(rows_by_table, sightings or {})

    def _push_embedding_rows(self, rows_by_table, sightings):
        requests = [pb.Model() for _ in self._stubs]
        for name, (ids, values) in rows_by_table.items():
            ids = np.asarray(ids, dtype=np.int64)
            values = np.asarray(values, dtype=np.float32)
            if not ids.size:
                continue
            seen = sightings.get(name)
            if seen is not None:
                seen = np.asarray(seen, dtype=np.int64)
            if self.ps_num == 1:
                parts = [(0, slice(None))]
            else:
                shard_of = ids % self.ps_num
                parts = [(int(shard), np.nonzero(shard_of == shard)[0])
                         for shard in np.unique(shard_of)]
            for shard, pos in parts:
                request = requests[shard]
                serialize_indexed_slices(
                    values[pos], ids[pos], request.embedding_tables[name],
                    packed=not self._legacy_ids,
                )
                if seen is not None:
                    ndarray_to_blob(seen[pos],
                                    request.dense_parameters[name])
        futures = []
        call = overload.bind_budget(trace.bind_context(_call_with_retry))
        for shard, (stub, request) in enumerate(zip(self._stubs, requests)):
            if not request.embedding_tables:
                continue
            futures.append((shard, self._pool.submit(
                call,
                lambda stub=stub, request=request: stub.push_embedding_rows(
                    request,
                    timeout=overload.rpc_timeout(PS_RETRY_BUDGET_SECS)),
                "push_embedding_rows",
                channel=self._channels[shard], target=self._addrs[shard],
            )))
        for shard, future in futures:
            response = future.result()
            # the stamp only, never _note_version: the writeback thread
            # races the push thread, so its version may arrive older
            # than a push's and would fake a relaunch
            self._note_restored(shard, response.restored_version)
            if not response.accepted:
                # the PS is draining: the rows were NOT imported
                raise RuntimeError(
                    "ps-%d rejected an embedding-row writeback (draining); "
                    "rows not applied" % shard
                )

    def push_gradients(self, grads_by_table, model_version=0, lr_scale=0.0,
                       only_shards=None, force_empty=False,
                       round_scoped=False):
        """grads_by_table: {name: (values [n, dim], ids [n])}; dedups,
        then scatters per PS. Returns ``PushResult(accepted, max version,
        rejected shards)``: a sync PS may reject a stale push per shard,
        and a retry must target only the rejecting shards or the others
        would apply the minibatch twice.

        ``lr_scale`` multiplies the PS optimizer's learning rate (0 = no
        scaling). ``only_shards``: the shards to push to (None = all; the
        retry passes the rejected set). ``force_empty``: send table-less
        pushes too, to every shard, so a lockstep worker counts toward
        each shard's sync round. ``round_scoped``: ask the sync PS to
        pair pushes by version tag, not arrival order.
        """
        with trace.span("ps_push", version=model_version):
            return self._push_gradients(
                grads_by_table, model_version, lr_scale, only_shards,
                force_empty, round_scoped,
            )

    def _push_gradients(self, grads_by_table, model_version, lr_scale,
                        only_shards, force_empty, round_scoped):
        shard_filter = (None if only_shards is None
                        else set(int(s) for s in only_shards))
        per_ps = self._push_requests
        # a pre-ids_blob peer predates the wire-dtype contract too
        payload_dtype = None if self._legacy_ids else wire_dtype()
        for request in per_ps:
            request.Clear()  # reused across steps; see __init__
            request.gradients.version = model_version
            request.lr_scale = lr_scale
            if self._worker_id is not None:
                request.worker_id = self._worker_id
                if self._incarnation is not None:
                    request.incarnation = self._incarnation
            if round_scoped:
                request.round_scoped = True
        for name, (values, ids) in grads_by_table.items():
            values, ids = deduplicate_indexed_slices(
                np.asarray(values), np.asarray(ids, dtype=np.int64)
            )
            if self.ps_num == 1:
                serialize_indexed_slices(
                    values, ids, per_ps[0].gradients.embedding_tables[name],
                    wire_dtype=payload_dtype, packed=not self._legacy_ids,
                )
                continue
            shard_of = ids % self.ps_num
            for shard in np.unique(shard_of):
                shard = int(shard)
                if shard_filter is not None and shard not in shard_filter:
                    continue
                pos = np.nonzero(shard_of == shard)[0]
                serialize_indexed_slices(
                    values[pos], ids[pos],
                    per_ps[shard].gradients.embedding_tables[name],
                    wire_dtype=payload_dtype, packed=not self._legacy_ids,
                )
        futures = []
        call = overload.bind_budget(trace.bind_context(_call_with_retry))
        for shard, (stub, request) in enumerate(zip(self._stubs, per_ps)):
            if not request.gradients.embedding_tables and not force_empty:
                continue
            if shard_filter is not None and shard not in shard_filter:
                continue
            # at-least-once on connection loss: a push the server
            # applied before the connection died is re-sent. Its
            # deadline is the whole retry budget, so DEADLINE_EXCEEDED
            # never re-sends a push a stalled server may still apply.
            futures.append((shard, self._pool.submit(
                call,
                lambda stub=stub, request=request: stub.push_gradients(
                    request,
                    timeout=overload.rpc_timeout(PS_RETRY_BUDGET_SECS)),
                "push_gradients",
                channel=self._channels[shard], target=self._addrs[shard],
            )))
        # an empty push keeps the caller's version
        version = model_version
        rejected, regressed_versions, responses = [], [], []
        error = None
        for shard, future in futures:
            # drain EVERY future before raising: the reused requests
            # must not be Clear()ed while a retry still holds one
            try:
                responses.append((shard, future.result()))
            except BaseException as e:  # re-raised after the drain
                if error is None:
                    error = e
        if error is not None:
            raise error
        for shard, response in responses:
            if self._note_version(shard, response.version,
                                  response.restored_version):
                regressed_versions.append(response.version)
            version = max(version, response.version)
            if not response.accepted:
                rejected.append(shard)
        if regressed_versions:
            # a relaunched shard: report its (lowest) version so the
            # trainer rolls back to it
            version = min(regressed_versions)
        return PushResult(not rejected, version, tuple(rejected))

    def close(self):
        """Close the channels and stop the pools."""
        for channel in self._channels:
            channel.close()
        self._pool.shutdown(wait=False)
        if self._table_pool is not None:
            self._table_pool.shutdown(wait=False)

"""The port's gRPC PS (ps/servicer.py, ps/server.py) and its client
(worker/ps_client.py) against the JAX package's, on the CPU.

In-process servers with two shards, each case on both store kinds:
numpy against numpy, native against native (the two C++ stores are one
source and one seed). The reference's client against the reference's
servicer is the baseline; the port's client against the port's
servicer, and each cross pair, must give its pulls, push results and
exported tables bit for bit, at fp32 and under EDL_WIRE_DTYPE=bfloat16.
Then the legacy per-table fallback, push-request reuse, the sync PS's
scenarios of tests/test_sync_ps.py that need no master (each against
the reference servicer on the same pushes), a PS relaunch that fires
``resync_hook``, and ``python -m elasticdl_tpu_torch.ps.server`` as a
process with bench.py's flags.
"""

import contextlib
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from elasticdl_tpu.common import grpc_utils as ref_grpc_utils
from elasticdl_tpu.common import tensor_utils as ref_tensor_utils
from elasticdl_tpu.proto import elasticdl_tpu_pb2 as ref_pb
from elasticdl_tpu.proto import services as ref_services
from elasticdl_tpu.ps import embedding_store as ref_store
from elasticdl_tpu.ps import servicer as ref_servicer
from elasticdl_tpu.worker import ps_client as ref_ps_client
from elasticdl_tpu_torch.common import grpc_utils
from elasticdl_tpu_torch.common import tensor_utils
from elasticdl_tpu_torch.embedding.client import HotRowCache
from elasticdl_tpu_torch.proto import elasticdl_tpu_pb2 as pb
from elasticdl_tpu_torch.proto import services
from elasticdl_tpu_torch.ps import embedding_store as port_store
from elasticdl_tpu_torch.ps import servicer as port_servicer
from elasticdl_tpu_torch.worker import ps_client as port_ps_client

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

torch.set_num_threads(1)

PKGS = {
    "ref": dict(store=ref_store, servicer=ref_servicer.PserverServicer,
                client=ref_ps_client.PSClient, services=ref_services,
                build_server=lambda: ref_grpc_utils.build_server(
                    max_workers=8)),
    "port": dict(store=port_store, servicer=port_servicer.PserverServicer,
                 client=port_ps_client.PSClient, services=services,
                 build_server=lambda: grpc_utils.build_server(max_workers=8)),
}
STORES = ["numpy", "native"]
TABLES = [("e", 4, "0.05"), ("w", 1, "zeros"), ("n", 2, "normal:0.3")]
# (client, servicer): the pairs held against the reference's own
PAIRS = [("port", "port"), ("port", "ref"), ("ref", "port")]


def _store(pkg, kind, seed, opt_type="adam", **opt_args):
    mod = PKGS[pkg]["store"]
    cls = (mod.NumpyEmbeddingStore if kind == "numpy"
           else mod.NativeEmbeddingStore)
    store = cls(seed=seed)
    store.set_optimizer(opt_type, **(opt_args or {"lr": 0.01}))
    return store


class _Recorder:
    """Wraps a servicer: records each push's table set and id encoding
    and counts the pulls by method."""

    def __init__(self, inner):
        self.inner = inner
        self.pushed_tables = []
        self.push_encodings = []
        self.pull_vector_calls = 0
        self.pull_batch_calls = 0

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def push_gradients(self, request, context=None):
        self.pushed_tables.append(sorted(request.gradients.embedding_tables))
        for slices in request.gradients.embedding_tables.values():
            self.push_encodings.append("packed" if slices.ids_blob
                                       else "legacy")
        return self.inner.push_gradients(request, context)

    def pull_embedding_vectors(self, request, context=None):
        self.pull_vector_calls += 1
        return self.inner.pull_embedding_vectors(request, context)

    def pull_embedding_batch(self, request, context=None):
        self.pull_batch_calls += 1
        return self.inner.pull_embedding_batch(request, context)


@contextlib.contextmanager
def live_ps(pkg, kind, n_shards=2, legacy=False, port=None, lifecycle=None,
            **servicer_kwargs):
    """``n_shards`` in-process servers of package ``pkg`` over ``kind``
    stores (seed = shard id, adam lr 0.01); ``legacy`` serves the method
    set without pull_embedding_batch, as an old binary; ``lifecycle``
    (store -> embedding lifecycle) gives each shard one. Yields (stores,
    recorders, addrs)."""
    spec = PKGS[pkg]
    servers, stores, recorders, addrs = [], [], [], []
    try:
        for ps_id in range(n_shards):
            store = _store(pkg, kind, ps_id)
            if lifecycle is not None:
                servicer_kwargs["lifecycle"] = lifecycle(store)
            recorder = _Recorder(spec["servicer"](store, ps_id=ps_id,
                                                  **servicer_kwargs))
            server = spec["build_server"]()
            svc = spec["services"]
            methods = {name: pair
                       for name, pair in svc._PSERVER_METHODS.items()
                       if not (legacy and name == "pull_embedding_batch")}
            svc._add_service(server, recorder, svc._PSERVER_SERVICE, methods)
            bound = port or grpc_utils.find_free_port()
            server.add_insecure_port("localhost:%d" % bound)
            server.start()
            servers.append(server)
            stores.append(store)
            recorders.append(recorder)
            addrs.append("localhost:%d" % bound)
        yield stores, recorders, addrs
    finally:
        for server in servers:
            server.stop(None)


def _exchange(client_pkg, server_pkg, kind, rounds=3):
    """Register TABLES, then per round: a fused pull (three tables,
    unique ids), a per-table pull with duplicate ids, a push with
    duplicate ids to every table and a row writeback. Returns (pulls,
    push results, exported tables per shard)."""
    rng = np.random.RandomState(5)
    with live_ps(server_pkg, kind) as (stores, _, addrs):
        client = PKGS[client_pkg]["client"](addrs)
        client.push_embedding_table_infos(TABLES)
        pulls, results = [], []
        for _ in range(rounds):
            ids = rng.randint(0, 60, size=24).astype(np.int64)
            unique = np.unique(ids)
            pulls.append(client.pull_embedding_batch(
                {"e": unique, "w": unique, "n": unique[:5]}))
            pulls.append({"e_dup": client.pull_embedding_vectors(
                "e", ids[:9])})
            grads = {name: rng.randn(ids.size, dim).astype(np.float32)
                     for name, dim, _ in TABLES}
            results.append(tuple(client.push_gradients(
                {name: (grads[name], ids) for name in grads})))
            client.push_embedding_rows({"e": (
                unique[:3], rng.randn(3, 4).astype(np.float32))})
        exports = [[store.export_table_full(name) for name, _, _ in TABLES]
                   for store in stores]
        versions = [store.version for store in stores]
    return pulls, results, exports, versions


def _assert_exchanges_equal(got, want):
    (g_pulls, g_results, g_exports, g_versions) = got
    (w_pulls, w_results, w_exports, w_versions) = want
    assert g_results == w_results
    assert g_versions == w_versions
    assert len(g_pulls) == len(w_pulls)
    for g, w in zip(g_pulls, w_pulls):
        assert sorted(g) == sorted(w)
        for name in w:
            assert g[name].dtype == np.float32
            np.testing.assert_array_equal(g[name], w[name], err_msg=name)
    for g_shard, w_shard in zip(g_exports, w_exports):
        for (g_ids, g_rows, g_steps), (w_ids, w_rows, w_steps) in zip(
                g_shard, w_shard):
            np.testing.assert_array_equal(g_ids, w_ids)
            np.testing.assert_array_equal(g_steps, w_steps)
            np.testing.assert_array_equal(g_rows, w_rows)


@pytest.mark.parametrize("client_pkg,server_pkg", PAIRS,
                         ids=["%s-client-%s-ps" % p for p in PAIRS])
@pytest.mark.parametrize("kind", STORES)
@pytest.mark.parametrize("wire", ["float32", "bfloat16"])
def test_pulls_pushes_and_tables_match_reference(client_pkg, server_pkg,
                                                 kind, wire, monkeypatch):
    """Against the reference's client and servicer on the same store
    kind: the same pulled rows, push results and exported tables (ids,
    rows with optimizer slots, step counts), bit for bit."""
    monkeypatch.setenv(tensor_utils.WIRE_DTYPE_ENV, wire)
    want = _exchange("ref", "ref", kind)
    got = _exchange(client_pkg, server_pkg, kind)
    _assert_exchanges_equal(got, want)
    if wire == "bfloat16":
        # the rows really travelled as bf16: every pulled value has a
        # zero low half
        for pull in got[0]:
            for rows in pull.values():
                assert not (rows.view(np.uint32) & 0xFFFF).any()


@pytest.mark.parametrize("kind", STORES)
def test_bfloat16_wire_payload_is_half_and_masters_stay_fp32(kind,
                                                             monkeypatch):
    """Under EDL_WIRE_DTYPE=bfloat16 the port's push carries bf16
    payloads labelled "bfloat16", the PS applies them to fp32 master
    rows, and a pull with the knob off decodes fp32 again."""
    monkeypatch.setenv(tensor_utils.WIRE_DTYPE_ENV, "bfloat16")
    with live_ps("port", kind) as (stores, recorders, addrs):
        client = port_ps_client.PSClient(addrs)
        client.push_embedding_table_infos([("t1", 4, "0.05")])
        ids = np.arange(16, dtype=np.int64)
        rows = client.pull_embedding_batch({"t1": ids})["t1"]
        assert rows.dtype == np.float32
        request = pb.PushGradientsRequest()
        tensor_utils.serialize_indexed_slices(
            np.full((16, 4), 0.125, np.float32), ids,
            request.gradients.embedding_tables["t1"],
            wire_dtype=tensor_utils.wire_dtype())
        blob = request.gradients.embedding_tables["t1"].concat_tensors
        assert blob.dtype == "bfloat16" and len(blob.content) == 16 * 4 * 2
        result = client.push_gradients(
            {"t1": (np.full((16, 4), 0.125, np.float32), ids)})
        assert result.accepted
        assert sum(s.table_size("t1") for s in stores) == 16
        monkeypatch.delenv(tensor_utils.WIRE_DTYPE_ENV)
        again = client.pull_embedding_batch({"t1": ids})["t1"]
        assert again.dtype == np.float32
        assert not np.array_equal(again, rows)  # the push landed
        assert (again.view(np.uint32) & 0xFFFF).any()  # fp32 masters


def test_wire_codec_matches_reference_bit_for_bit():
    """ndarray_to_blob's bf16/fp16 down-cast (the port casts through
    torch, the reference through ml_dtypes/numpy), the packed ids and
    the IndexedSlices codec give the same bytes, and each side decodes
    the other's payload to the same fp32 values."""
    import ml_dtypes

    rng = np.random.RandomState(0)
    values = np.concatenate([
        rng.randn(64, 3).astype(np.float32) * 1e3,
        np.array([[0.0, -0.0, 1e-40], [np.inf, -np.inf, 65504.0],
                  [3.0e38, -1.0e-8, 0.1]], np.float32)])
    ids = rng.randint(-5, 1 << 40, size=values.shape[0]).astype(np.int64)
    for name, torch_dtype in (("bfloat16", torch.bfloat16),
                              ("float16", torch.float16)):
        port_slices = tensor_utils.serialize_indexed_slices(
            values, ids, wire_dtype=torch_dtype)
        ref_dtype = (np.dtype(ml_dtypes.bfloat16) if name == "bfloat16"
                     else np.dtype(np.float16))
        ref_slices = ref_tensor_utils.serialize_indexed_slices(
            values, ids, wire_dtype=ref_dtype)
        assert port_slices.SerializeToString() == \
            ref_slices.SerializeToString(), name
        got_v, got_i = tensor_utils.deserialize_indexed_slices(ref_slices)
        want_v, want_i = ref_tensor_utils.deserialize_indexed_slices(
            port_slices)
        np.testing.assert_array_equal(got_i, want_i)
        np.testing.assert_array_equal(got_v, want_v.astype(np.float32))
    legacy = tensor_utils.serialize_indexed_slices(values, ids, packed=False)
    assert legacy.SerializeToString() == ref_tensor_utils.\
        serialize_indexed_slices(values, ids, packed=False).SerializeToString()
    np.testing.assert_array_equal(tensor_utils.unpack_ids(legacy), ids)
    merged = tensor_utils.merge_indexed_slices(values, ids, values[:2],
                                               ids[:2])
    want = ref_tensor_utils.merge_indexed_slices(values, ids, values[:2],
                                                 ids[:2])
    for g, w in zip(merged, want):
        np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# legacy peers, request reuse




def test_writeback_sightings_travel_with_each_shards_rows():
    """The port's addition: a device tier's writeback sightings split by
    shard as its rows do and join each port PS's LFU frequency for the
    rows; a reference PS, which has no use for them, imports the rows
    as it would without them."""
    from elasticdl_tpu_torch.stream.lifecycle import EmbeddingLifecycle

    ids = np.arange(10, 18, dtype=np.int64)
    rows = np.random.RandomState(3).randn(8, 4).astype(np.float32)
    seen = np.arange(8, dtype=np.int64) * 3
    with live_ps("port", "numpy", lifecycle=lambda store: EmbeddingLifecycle(
            store, admit_k=2, max_rows=100)) as (stores, recorders, addrs):
        client = port_ps_client.PSClient(addrs)
        client.push_embedding_table_infos(TABLES)
        client.push_embedding_rows({"e": (ids, rows)}, sightings={"e": seen})
        freq = {}
        for recorder in recorders:
            freq.update({i: e[0] for i, e in
                         recorder.inner._lifecycle._tables["e"]
                         .admitted.items()})
    assert freq == {int(i): 2.0 + n for i, n in zip(ids, seen)}
    exports = {}
    for sighted in (False, True):
        with live_ps("ref", "numpy") as (stores, _, addrs):
            client = port_ps_client.PSClient(addrs)
            client.push_embedding_table_infos(TABLES)
            client.push_embedding_rows(
                {"e": (ids, rows)},
                sightings={"e": seen} if sighted else None)
            exports[sighted] = [store.export_table_full("e")
                                for store in stores]
    for without, with_ in zip(exports[False], exports[True]):
        for a, b in zip(without, with_):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("server_pkg", ["port", "ref"])
def test_batched_pull_falls_back_against_legacy_server(server_pkg):
    """An old PS answers pull_embedding_batch with UNIMPLEMENTED: the
    port's client remembers, serves every pull per table, and pushes
    in the legacy repeated-id encoding from then on."""
    with live_ps(server_pkg, "numpy", legacy=True) as (_, recorders, addrs):
        client = port_ps_client.PSClient(addrs)
        client.push_embedding_table_infos(TABLES)
        ids = np.arange(40, dtype=np.int64)
        out = client.pull_embedding_batch({"e": ids, "w": ids[:7]})
        assert client._batch_pull_supported is False
        assert out["e"].shape == (40, 4) and out["w"].shape == (7, 1)
        np.testing.assert_array_equal(
            out["e"], client.pull_embedding_vectors("e", ids))
        assert client.pull_embedding_batch({"n": ids[:3]})["n"].shape == (
            3, 2)
        client.push_gradients({"e": (np.ones((4, 4), np.float32),
                                     np.arange(4, dtype=np.int64))})
        encodings = [e for r in recorders for e in r.push_encodings]
        assert encodings and set(encodings) == {"legacy"}, encodings
        assert sum(r.pull_batch_calls for r in recorders) == 0


def test_legacy_fallback_many_tables_does_not_deadlock():
    """The per-table fallback fans out on its own pool: nested on the
    shard pool, >= max_workers blocked table tasks would starve their
    own shard sub-tasks."""
    tables = tuple("t%d" % i for i in range(6))
    with live_ps("port", "numpy", legacy=True) as (_, _, addrs):
        client = port_ps_client.PSClient(addrs)
        client.push_embedding_table_infos([(t, 4, "0.05") for t in tables])
        ids = np.arange(20, dtype=np.int64)
        done = {}
        thread = threading.Thread(target=lambda: done.setdefault(
            "out", client.pull_embedding_batch({t: ids for t in tables})),
            daemon=True)
        thread.start()
        thread.join(timeout=30)
        assert not thread.is_alive(), "legacy per-table fallback deadlocked"
        assert sorted(done["out"]) == sorted(tables)


@pytest.mark.parametrize("kind", STORES)
def test_legacy_repeated_ids_request_served_fp32(kind, monkeypatch):
    """A legacy client's repeated-id pull is served, and plain fp32
    even under a reduced wire dtype (it cannot decode bfloat16)."""
    import grpc

    with live_ps("port", kind) as (_, _, addrs):
        client = port_ps_client.PSClient(addrs)
        client.push_embedding_table_infos(TABLES)
        monkeypatch.setenv(tensor_utils.WIRE_DTYPE_ENV, "bfloat16")
        stub = ref_services.PserverStub(grpc.insecure_channel(addrs[0]))
        blob = stub.pull_embedding_vectors(
            ref_pb.PullEmbeddingVectorsRequest(name="e", ids=[1, 2, 3]),
            timeout=10)
        assert blob.dtype == "float32"
        assert ref_tensor_utils.blob_to_ndarray(blob).shape == (3, 4)
        packed = stub.pull_embedding_vectors(
            ref_pb.PullEmbeddingVectorsRequest(
                name="e", ids_blob=ref_tensor_utils.pack_ids([1, 2, 3])),
            timeout=10)
        assert packed.dtype == "bfloat16"


def test_push_requests_reused_without_cross_step_leftovers():
    with live_ps("port", "numpy") as (stores, recorders, addrs):
        client = port_ps_client.PSClient(addrs)
        client.push_embedding_table_infos(
            [(t, 4, "0.05") for t in ("t1", "t2", "t3")])
        rng = np.random.RandomState(1)

        def grads(n):
            return (rng.randn(n, 4).astype(np.float32),
                    rng.permutation(1000)[:n].astype(np.int64))

        first = dict(t1=grads(8), t2=grads(5))
        client.push_gradients(first)
        client.push_gradients({"t3": grads(6)})
        # each shard saw both steps, the second without step 1's tables
        for recorder in recorders:
            first_step, second_step = recorder.pushed_tables
            assert set(first_step) <= {"t1", "t2"}
            assert second_step == ["t3"], recorder.pushed_tables
        # the first step's rows were applied once, no more
        for name, (_, ids) in first.items():
            total = sum(s.table_size(name) for s in stores)
            assert total == ids.size


# ---------------------------------------------------------------------------
# the sync PS: tests/test_sync_ps.py's scenarios that need no master,
# each run against the reference servicer on the same pushes


def _push_request(module_pb, tensor_mod, push):
    request = module_pb.PushGradientsRequest()
    request.gradients.version = push["version"]
    tensor_mod.serialize_indexed_slices(
        np.asarray(push["values"], np.float32),
        np.asarray(push["ids"], np.int64),
        request.gradients.embedding_tables["t"])
    if push.get("worker") is not None:
        request.worker_id = push["worker"]
        if push.get("inc") is not None:
            request.incarnation = push["inc"]
    if push.get("scoped"):
        request.round_scoped = True
    if push.get("lr_scale"):
        request.lr_scale = push["lr_scale"]
    return request


def _p(values, ids, version, worker=None, inc=None, scoped=False,
       lr_scale=0.0):
    return dict(values=values, ids=ids, version=version, worker=worker,
                inc=inc, scoped=scoped, lr_scale=lr_scale)


# name -> (servicer kwargs, optimizer, pushes ("stop" = graceful_stop),
# the reference test's (accepted, version) answers)
SYNC_SCENARIOS = {
    "grads_to_wait_accumulates_then_applies_once": (
        dict(grads_to_wait=2), ("sgd", 1.0),
        [_p([[1, 0]], [5], 0), _p([[0, 1]], [5], 0)],
        [(True, 0), (True, 1)]),
    "stale_push_rejected_until_refreshed": (
        dict(grads_to_wait=1), ("sgd", 1.0),
        [_p([[1, 1]], [3], 0), _p([[1, 1]], [3], 0), _p([[1, 1]], [3], 1)],
        [(True, 1), (False, 1), (True, 2)]),
    "version_tolerance_accepts_slightly_stale": (
        dict(grads_to_wait=1, sync_version_tolerance=2), ("sgd", 1.0),
        [_p([[0.1, 0.1]], [1], 0)] * 4,
        [(True, 1), (True, 2), (True, 3), (False, 3)]),
    "sync_lr_scale_reaches_optimizer_lr": (
        dict(grads_to_wait=2), ("sgd", 1.0),
        [_p([[1, 0]], [7], 0, lr_scale=0.5),
         _p([[0, 1]], [7], 0, lr_scale=0.5)],
        [(True, 0), (True, 1)]),
    "sync_lr_scale_adam_not_a_noop": (
        dict(grads_to_wait=1), ("adam", 0.1),
        [_p([[1, 2]], [1], 0, lr_scale=0.25), _p([[1, 2]], [2], 1)],
        [(True, 1), (True, 2)]),
    "sync_unequal_scales_preserve_relative_weighting": (
        dict(grads_to_wait=2), ("sgd", 1.0),
        [_p([[1, 0]], [9], 0, lr_scale=1.0),
         _p([[0, 1]], [9], 0, lr_scale=0.1)],
        [(True, 0), (True, 1)]),
    "orphaned_half_round_dropped_on_worker_relaunch": (
        dict(grads_to_wait=2), ("sgd", 1.0),
        [_p([[9, 9]], [7], 0, 0, 1), _p([[1, 0]], [7], 0, 0, 2),
         _p([[0, 1]], [7], 1, 1, 1), _p([[1, 0]], [7], 1, 0, 2),
         _p([[0, 1]], [7], 1, 1, 1)],
        [(True, 0), (True, 0), (True, 1), (True, 1), (True, 2)]),
    "straggler_double_push_keeps_both_gradients": (
        dict(grads_to_wait=2), ("sgd", 1.0),
        [_p([[1, 0]], [3], 0, 0, 5), _p([[10, 0]], [3], 0, 0, 5)],
        [(True, 0), (True, 1)]),
    "lone_survivor_completes_round_without_livelock": (
        dict(grads_to_wait=2), ("sgd", 1.0),
        [_p([[1, 1]], [9], step // 2, 0, 7) for step in range(4)],
        [(True, 0), (True, 1), (True, 1), (True, 2)]),
    "anonymous_pushes_keep_counting_semantics": (
        dict(grads_to_wait=2), ("sgd", 1.0),
        [_p([[1, 0]], [2], 0), _p([[0, 1]], [2], 0)],
        [(True, 0), (True, 1)]),
    "delayed_dead_incarnation_push_cannot_evict_live_entry": (
        dict(grads_to_wait=2), ("sgd", 1.0),
        [_p([[1, 0]], [4], 0, 0, 20), _p([[9, 9]], [4], 0, 0, 10),
         _p([[0, 1]], [4], 1, 1, 1)],
        [(True, 0), (True, 0), (True, 1)]),
    "identified_push_without_incarnation_replaces_by_worker_id": (
        dict(grads_to_wait=2), ("sgd", 1.0),
        [_p([[9, 9]], [6], 0, 0), _p([[1, 0]], [6], 0, 0),
         _p([[0, 1]], [6], 1, 1, 1)],
        [(True, 0), (True, 0), (True, 1)]),
    "round_scoped_pushes_pair_by_tag_not_arrival_order": (
        dict(grads_to_wait=2), ("sgd", 1.0),
        [_p([[1, 0]], [8], 0, 0, 1, True), _p([[2, 0]], [8], 1, 0, 1, True),
         _p([[0, 1]], [8], 0, 1, 1, True), _p([[0, 2]], [8], 1, 1, 1, True)],
        [(True, 0), (True, 0), (True, 1), (True, 2)]),
    "round_scoped_orphan_eviction_spans_groups": (
        dict(grads_to_wait=2), ("sgd", 1.0),
        [_p([[9, 9]], [2], 5, 0, 1, True), _p([[1, 0]], [2], 5, 0, 2, True),
         _p([[0, 1]], [2], 5, 1, 1, True)],
        [(True, 0), (True, 0), (True, 1)]),
    "round_scoped_transport_resend_is_idempotent": (
        dict(grads_to_wait=2), ("sgd", 1.0),
        [_p([[1, 0]], [1], 0, 0, 9, True)] * 3
        + [_p([[0, 1]], [1], 0, 1, 1, True)],
        [(True, 0)] * 3 + [(True, 1)]),
    "relaunch_eviction_with_straggler_neighbor_applies_cleanly": (
        dict(grads_to_wait=4), ("sgd", 1.0),
        [_p([[1, 0]], [2], 0, 0, 5), _p([[2, 0]], [2], 0, 0, 5),
         _p([[0.5, 0]], [2], 0, 0, 6)]
        + [_p([[0, 0.5]], [2], 0, w) for w in (1, 2, 3)],
        [(True, 0)] * 5 + [(True, 1)]),
    "graceful_stop_applies_the_partial_round_then_refuses": (
        dict(grads_to_wait=3), ("sgd", 1.0),
        [_p([[1, 0]], [4], 0), _p([[0, 2]], [4], 0), "stop",
         _p([[5, 5]], [4], 1)],
        [(True, 0), (True, 0), (False, 1)]),
}


def _run_sync(pkg, kind, kwargs, opt, pushes):
    """The pushes against a sync servicer of ``pkg`` over a ``kind``
    store (table "t", dim 2, constant 0 rows): each answer, and the
    touched rows after every push."""
    store = _store(pkg, kind, 0, opt[0], lr=opt[1])
    servicer = PKGS[pkg]["servicer"](store, use_async=False, **kwargs)
    module_pb, tensor_mod = ((ref_pb, ref_tensor_utils) if pkg == "ref"
                             else (pb, tensor_utils))
    infos = module_pb.Model()
    infos.embedding_table_infos.add(name="t", dim=2, initializer="0.0")
    servicer.push_embedding_table_infos(infos)
    touched = np.arange(10, dtype=np.int64)
    answers, rows = [], []
    for push in pushes:
        if push == "stop":
            servicer.graceful_stop()
        else:
            response = servicer.push_gradients(
                _push_request(module_pb, tensor_mod, push))
            answers.append((response.accepted, response.version))
        rows.append(store.lookup("t", touched).copy())
    return answers, rows, store.version


@pytest.mark.parametrize("kind", STORES)
@pytest.mark.parametrize("scenario", sorted(SYNC_SCENARIOS))
def test_sync_scenario_matches_reference(scenario, kind):
    kwargs, opt, pushes, want = SYNC_SCENARIOS[scenario]
    ref = _run_sync("ref", kind, kwargs, opt, pushes)
    port = _run_sync("port", kind, kwargs, opt, pushes)
    assert port[0] == ref[0] == want
    assert port[2] == ref[2]
    for got, expect in zip(port[1], ref[1]):
        np.testing.assert_array_equal(got, expect)


def test_sync_scenario_values_are_the_reference_tests():
    """Spot checks of the scenarios' rows as tests/test_sync_ps.py
    states them (sgd lr 1 from zero rows)."""
    def final(name):
        kwargs, opt, pushes, _ = SYNC_SCENARIOS[name]
        return _run_sync("port", "numpy", kwargs, opt, pushes)[1][-1]

    np.testing.assert_allclose(final(
        "grads_to_wait_accumulates_then_applies_once")[5], [-1, -1])
    np.testing.assert_allclose(final(
        "sync_lr_scale_reaches_optimizer_lr")[7], [-0.5, -0.5])
    np.testing.assert_allclose(final(
        "sync_unequal_scales_preserve_relative_weighting")[9], [-1, -0.1],
        rtol=1e-6)
    np.testing.assert_allclose(final(
        "relaunch_eviction_with_straggler_neighbor_applies_cleanly")[2],
        [-0.5, -1.5])
    np.testing.assert_allclose(final(
        "round_scoped_transport_resend_is_idempotent")[1], [-1, -1])
    np.testing.assert_allclose(final(
        "graceful_stop_applies_the_partial_round_then_refuses")[4], [-1, -2])


def test_remove_buffered_is_identity_based_past_key_equal_neighbor():
    servicer = port_servicer.PserverServicer(
        _store("port", "numpy", 0), use_async=False, grads_to_wait=8)
    entry_a = ((0, 5), {"t": (np.ones((1, 2), np.float32),
                              np.array([2], np.int64))}, 1.0)
    entry_b = ((0, 5), {"t": (np.full((1, 2), 2.0, np.float32),
                              np.array([2], np.int64))}, 1.0)
    servicer._round_buffer[:] = [entry_a, entry_b]
    servicer._remove_buffered_locked(entry_b)
    assert servicer._round_buffer == [entry_a]
    group_a = ((1, 3), {"t": (np.ones((1, 2), np.float32),
                              np.array([4], np.int64))}, 1.0)
    group_b = ((1, 3), {"t": (np.zeros((1, 2), np.float32),
                              np.array([4], np.int64))}, 1.0)
    servicer._round_groups[0] = [group_a, group_b]
    servicer._remove_buffered_locked(group_b)
    assert servicer._round_groups[0] == [group_a]
    servicer._remove_buffered_locked(group_a)
    assert 0 not in servicer._round_groups


def _sync_shards_run(pkg, scenario):
    """Two sync shards over gRPC and that package's client: the
    scenario's push results and each shard's version and rows."""
    kwargs = dict(grads_to_wait=2 if scenario == "force_empty" else 1)
    with live_ps(pkg, "native", use_async=False, **kwargs) as (
            stores, recorders, addrs):
        client = PKGS[pkg]["client"](addrs)
        client.push_embedding_table_infos([("t", 2, "0.0")])
        grad = np.ones((1, 2), np.float32)
        results = []
        if scenario == "force_empty":
            results.append(tuple(client.push_gradients(
                {"t": (grad, np.array([2], np.int64))},
                model_version=0, force_empty=True)))
            results.append(tuple(client.push_gradients(
                {"t": (np.repeat(grad, 2, axis=0),
                       np.array([2, 3], np.int64))},
                model_version=0, force_empty=True)))
        else:
            # advance shard 0 only, then a version-0 push to both: shard
            # 0 rejects, shard 1 accepts; retry only the rejecting one
            results.append(tuple(client.push_gradients(
                {"t": (grad, np.array([4], np.int64))}, model_version=0)))
            pushes = [r.pushed_tables for r in recorders]
            first = tuple(client.push_gradients(
                {"t": (np.ones((2, 2), np.float32),
                       np.array([2, 3], np.int64))}, model_version=0))
            results.append(first)
            shard1_pushes = len(pushes[1])
            results.append(tuple(client.push_gradients(
                {"t": (np.ones((2, 2), np.float32),
                       np.array([2, 3], np.int64))},
                model_version=first[1], only_shards=first[2])))
            results.append(len(pushes[1]) == shard1_pushes)
        state = [(s.version, s.lookup("t", np.arange(6))) for s in stores]
    return results, state


@pytest.mark.parametrize("scenario", ["force_empty", "retry_only_rejecting"])
def test_multi_shard_sync_push_matches_reference(scenario):
    """force_empty reaches every shard (each counts the worker toward
    its own round), and a retry targets only the rejecting shard: the
    port's client and servicers give the reference's results."""
    want = _sync_shards_run("ref", scenario)
    got = _sync_shards_run("port", scenario)
    assert got[0] == want[0]
    for (gv, grows), (wv, wrows) in zip(got[1], want[1]):
        assert gv == wv
        np.testing.assert_array_equal(grows, wrows)
    if scenario == "force_empty":
        assert [v for v, _ in got[1]] == [1, 1]
    else:
        assert got[0][1][0] is False and got[0][1][2] == (0,)
        assert got[0][2][0] is True and got[0][3] is True


# ---------------------------------------------------------------------------
# PS relaunch, and the server process


def test_ps_relaunch_fires_resync_hook_and_reregisters():
    """A shard relaunched on the same port (a fresh store, so its
    version restarts): the next push's answer regresses, the client
    fires ``resync_hook`` (installed by the preparer), and the next
    prepare re-registers the tables and drops the cache."""
    from elasticdl_tpu_torch.models import deepfm
    from elasticdl_tpu_torch.train.sparse import SparseBatchPreparer

    port = grpc_utils.find_free_port()
    specs = deepfm.sparse_embedding_specs(num_features=3, batch_size=4)
    rng = np.random.RandomState(0)
    batch = {"features": {"ids": rng.randint(0, 50, (4, 3)).astype(
        np.int64)}, "labels": np.ones(4, np.float32),
        "_mask": np.ones(4, np.float32)}
    with live_ps("port", "numpy", n_shards=1, port=port) as (_, _, addrs):
        client = port_ps_client.PSClient(addrs)
        fired = []
        preparer = SparseBatchPreparer(specs, client,
                                       cache=HotRowCache(staleness=4))
        assert client.resync_hook == preparer._on_ps_restart
        hook = client.resync_hook
        client.resync_hook = lambda shard: (fired.append(shard), hook(shard))
        _, info = preparer.prepare(batch)
        grads = {name: np.ones((n, spec.dim), np.float32)
                 for spec, (name, (ids, n)) in zip(specs, info.items())}
        for _ in range(3):
            assert preparer.push_gradients(grads, info)[0]
    generation = preparer.cache.generation
    with live_ps("port", "numpy", n_shards=1, port=port):
        # another worker re-created the tables on the relaunched shard
        port_ps_client.PSClient(addrs).push_embedding_table_infos(
            [(s.name, s.dim, "0.05") for s in specs])
        accepted, version, _ = preparer.push_gradients(grads, info)
        assert accepted and version == 1
        assert fired == [0]
        assert preparer._registered is False
        preparer.prepare(batch)
        assert preparer._registered is True
        assert preparer.cache.generation == generation + 1


def test_ps_server_process_serves_with_bench_flags_and_drains_on_sigterm():
    """``python -m elasticdl_tpu_torch.ps.server`` with bench.py's flags
    (two shards, adam lr 0.001, sync) and an injected RPC delay: it
    serves a pull no faster than the delay, and exits 0 within 10 s of
    SIGTERM."""
    port = grpc_utils.find_free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "elasticdl_tpu_torch.ps.server",
         "--ps_id", "1", "--num_ps_pods", "2", "--port", str(port),
         "--opt_type", "adam", "--opt_args", "lr=0.001",
         "--inject_rpc_delay_ms", "50"],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        client = port_ps_client.PSClient(["localhost:%d" % port])
        deadline = time.monotonic() + 120
        while True:  # a fresh client per probe: a channel that dialed
            try:  # before the bind sits out the reconnect backoff
                port_ps_client.PSClient(
                    ["localhost:%d" % port]).push_embedding_table_infos(
                    [("t", 3, "zeros")])
                break
            except Exception:
                assert proc.poll() is None and time.monotonic() < deadline
                time.sleep(0.2)
        started = time.monotonic()
        rows = client.pull_embedding_batch({"t": np.arange(5)})["t"]
        assert time.monotonic() - started >= 0.05
        np.testing.assert_array_equal(rows, np.zeros((5, 3), np.float32))
        result = client.push_gradients(
            {"t": (np.ones((5, 3), np.float32), np.arange(5))})
        assert tuple(result) == (True, 1, ())
        stopped = time.monotonic()
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=10) == 0
        assert time.monotonic() - stopped < 10
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    out = proc.stdout.read()
    assert "serving on :%d (NativeEmbeddingStore store, sync, " \
           "grads_to_wait 1)" % port in out, out
    assert "stopped on SIGTERM" in out


@pytest.mark.parametrize("client_pkg,server_pkg", PAIRS + [("ref", "ref")],
                         ids=["%s-client-%s-ps" % p
                              for p in PAIRS + [("ref", "ref")]])
def test_dense_init_first_writer_wins(client_pkg, server_pkg):
    """push_model / pull_dense_parameters through either client: the
    first dense init wins on every shard, a late one is ignored, and a
    pull at the current version carries no parameters."""
    with live_ps(server_pkg, "numpy") as (_, _, addrs):
        client = PKGS[client_pkg]["client"](addrs)
        first = {"w": np.arange(6, dtype=np.float32).reshape(2, 3),
                 "b": np.array([1, 2], np.int32)}
        client.push_dense_init(first, version=3)
        client.push_dense_init({"w": np.zeros((2, 3), np.float32)},
                               version=9)
        initialized, version, params = client.pull_dense_init()
        assert initialized and version == 3
        assert sorted(params) == ["b", "w"]
        for name, value in first.items():
            np.testing.assert_array_equal(params[name], value)
            assert params[name].dtype == value.dtype
        assert client.pull_dense_init(version=3)[2] == {}


def test_native_blob_entry_points_match_reference():
    """lookup_blob (fp32, bf16, fp16), push_gradients_blob (duplicate
    ids, each payload dtype) and import_blob called directly on the
    two packages' native stores: the same bytes and the same tables;
    a payload of the wrong size or an unknown table is refused."""
    rng = np.random.RandomState(3)
    stores = [_store(pkg, "native", 0, "adagrad", lr=0.1)
              for pkg in ("ref", "port")]
    for store in stores:
        store.create_table("a", 3, init_scale=0.2, initializer="normal")
    ids = np.array([4, 9, 4, 17, 2], np.int64)
    for dtype in ("float32", "bfloat16", "float16"):
        grads = rng.randn(ids.size, 3).astype(np.float32)
        blob = tensor_utils.ndarray_to_blob(
            grads, wire_dtype=None if dtype == "float32"
            else getattr(torch, dtype))
        assert blob.dtype == dtype
        looked = [store.lookup_blob("a", ids[::-1],
                                    None if dtype == "float32" else dtype)
                  for store in stores]
        assert looked[0] == looked[1]
        for store in stores:
            store.push_gradients_blob("a", ids, blob.content, dtype,
                                      lr_scale=0.5)
            store.import_blob("a", ids[3:], blob.content[-2 * len(
                blob.content) // 5:], dtype)
    exports = [store.export_table_full("a") for store in stores]
    for got, want in zip(exports[1], exports[0]):
        np.testing.assert_array_equal(got, want)
    port = stores[1]
    with pytest.raises(ValueError, match="payload bytes"):
        port.push_gradients_blob("a", ids, b"\0" * 8, "float32")
    with pytest.raises(KeyError):
        port.lookup_blob("missing", ids)

"""The port's serving of a sparse model (DeepFM) over the PS, on the CPU:
tests/test_serving.py's ``test_export_serve_parity_deepfm`` and its PS
restart invalidation on the port.

(a) a DeepFM trained by the port's ``SparseTrainer`` and exported by
``export_train_state`` is served over real gRPC through the engine, the
read-only preparer and the shared cache: the answers are bit-equal to
the trainer's own ``eval_step`` on the same batch (the same module, the
same PS rows, the same padded shapes); (b) the reference's
``ServingModel`` on the same export, over a store of the same kind
holding the same rows, answers within fp32 tolerance (the two packages
sum in other orders: 1e-5 relative, 1e-6 absolute); (c) a sparse model
without a PS client is refused as the reference refuses it; (d) a PS
relaunched from a checkpoint (the stamp on its answers changes) drops
the engine's cache exactly once (at the first pull that reaches it:
a batch whose rows are all cached sees no PS), and the answers then
equal a fresh ``ServingModel`` over the relaunched PS, not the rows
cached before.
Small sizes (10 id fields, vocab 1000, batch 32); inputs made with
numpy from a seed.
"""

import os
import tempfile

import numpy as np
import pytest
import torch

from elasticdl_tpu.models.registry import get_model_spec as ref_get_spec
from elasticdl_tpu.serve.model import ServingModel as RefServingModel
from elasticdl_tpu_torch.common.grpc_utils import build_server, reserve_port
from elasticdl_tpu_torch.data.pipeline import MASK_KEY
from elasticdl_tpu_torch.models import deepfm
from elasticdl_tpu_torch.models.registry import get_model_spec
from elasticdl_tpu_torch.proto.services import (
    add_pserver_servicer_to_server,
    add_serve_servicer_to_server,
)
from elasticdl_tpu_torch.ps import embedding_store as port_store
from elasticdl_tpu_torch.ps.checkpoint import SparseCheckpointSaver
from elasticdl_tpu_torch.ps.servicer import PserverServicer
from elasticdl_tpu_torch.serve.client import ServeClient
from elasticdl_tpu_torch.serve.engine import ServingEngine
from elasticdl_tpu_torch.serve.model import ServingModel
from elasticdl_tpu_torch.serve.servicer import ServeServicer
from elasticdl_tpu_torch.train.export import export_train_state
from elasticdl_tpu_torch.train.sparse import SparseTrainer
from elasticdl_tpu_torch.worker.ps_client import PSClient
from tests.test_torch_sparse import port_client, ref_client

torch.set_num_threads(1)

BATCH = 32
FIELDS = 10
VOCAB = 1000
TABLES = ("deepfm_emb", "deepfm_linear")
# (b): one forward in fp32 on each package
REF_RTOL, REF_ATOL = 1e-5, 1e-6


def _batches(n, seed):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        ids = (rng.zipf(1.3, size=(BATCH, FIELDS)) % VOCAB).astype(np.int64)
        out.append({"features": {"ids": ids},
                    "labels": (ids.sum(1) % 2).astype(np.float32),
                    MASK_KEY: np.ones(BATCH, np.float32)})
    return out


def _trainer(client):
    return SparseTrainer(
        model=deepfm.custom_model(), loss_fn=deepfm.loss,
        optimizer=deepfm.optimizer(),
        specs=deepfm.sparse_embedding_specs(num_features=FIELDS,
                                            batch_size=BATCH),
        ps_client=client, seed=0, device_tier=False, health=False,
        device="cpu")


@pytest.fixture(scope="module")
def deepfm_run():
    """One trained DeepFM (6 steps over the numpy store) and its
    export, shared by the module's tests."""
    tmp = tempfile.mkdtemp(prefix="edl-torch-serving-")
    client = port_client(lr=0.01)
    trainer = _trainer(client)
    state = None
    batches = _batches(6, seed=0)
    for batch in batches:
        state = trainer.ensure_state(state, batch)
        state, _ = trainer.train_step(state, batch)
    export_dir = os.path.join(tmp, "export")
    export_train_state(state, export_dir)
    return trainer, state, client, export_dir, batches


def _serve(engine):
    server = build_server()
    add_serve_servicer_to_server(ServeServicer(engine), server)
    sock, port = reserve_port()
    server.add_insecure_port("localhost:%d" % port)
    server.start()
    sock.close()
    return server, ServeClient("localhost:%d" % port)


def _seen_ids(batches, n_rows, seed):
    """[n_rows, FIELDS] ids drawn from those the training batches
    created on the PS (a pull of a new id would create a row, from a
    random stream that differs across stores)."""
    seen = np.unique(np.concatenate(
        [b["features"]["ids"].reshape(-1) for b in batches]))
    rng = np.random.RandomState(seed)
    return seen[rng.randint(0, seen.size, size=(n_rows, FIELDS))]


def test_export_serve_parity_deepfm(deepfm_run):
    trainer, state, client, export_dir, batches = deepfm_run
    engine = ServingEngine(
        "elasticdl_tpu_torch.models.deepfm", export_dir, ps_client=client,
        max_batch=BATCH, max_delay_ms=2.0, deadline_ms=5000.0,
        device="cpu").start(block=True)
    server, serve_client = _serve(engine)
    try:
        assert engine.model.sparse and engine.cache is not None
        ids = np.random.RandomState(7).randint(
            0, VOCAB, size=(BATCH, FIELDS)).astype(np.int64)
        outputs, step, stamp = serve_client.predict({"ids": ids})
        assert step == int(state.step) == 6
        batch = {"features": {"ids": ids},
                 MASK_KEY: np.ones(BATCH, np.float32)}
        want = np.asarray(trainer.eval_step(state, batch))
        # bit for bit: the same module, rows and shapes
        np.testing.assert_array_equal(outputs["output"].numpy(), want)
        # a partial batch rides the padding mask: its rows are answered
        # alike, and the padding's zero ids reach no PS pull
        part, _, _ = serve_client.predict({"ids": ids[:3]})
        np.testing.assert_array_equal(part["output"].numpy(), want[:3])
        assert engine.model.embedding_hit_rate > 0.0
    finally:
        server.stop(0)
        serve_client.close()
        engine.drain(timeout=5)


def test_served_answers_match_reference_serving_model(deepfm_run):
    """The port's export served by both packages over stores of one kind
    holding the same rows."""
    _, _, client, export_dir, batches = deepfm_run
    ref = ref_client(lr=0.01)
    specs = deepfm.sparse_embedding_specs(num_features=FIELDS,
                                          batch_size=BATCH)
    ref.push_embedding_table_infos(
        [(s.name, s.dim, "zeros") for s in specs])
    for name in TABLES:
        ids, _, _ = client.store.export_table_full(name)
        ref.store.import_table(name, ids, client.store.lookup(name, ids))
    port_model = ServingModel(get_model_spec(
        "elasticdl_tpu_torch.models.deepfm"), export_dir, max_batch=BATCH,
        ps_client=client, device="cpu")
    ref_model = RefServingModel(ref_get_spec("elasticdl_tpu.models.deepfm"),
                                export_dir, max_batch=BATCH, ps_client=ref)
    assert port_model.step == ref_model.step == 6
    for rows in (BATCH, 5):
        ids = _seen_ids(batches, rows, seed=rows)
        got = port_model.predict({"ids": ids}, rows)["output"].numpy()
        want = np.asarray(ref_model.predict({"ids": ids}, rows)["output"])
        assert got.shape == want.shape == (rows,)
        np.testing.assert_allclose(got, want, rtol=REF_RTOL, atol=REF_ATOL)


def test_sparse_model_without_ps_client_is_refused(deepfm_run):
    export_dir = deepfm_run[3]
    with pytest.raises(ValueError, match="needs a PS client"):
        ServingModel(get_model_spec("elasticdl_tpu_torch.models.deepfm"),
                     export_dir, max_batch=BATCH, device="cpu")


def test_cache_dropped_once_on_stamped_ps_relaunch(deepfm_run, tmp_path):
    _, _, trained, export_dir, batches = deepfm_run
    reservation, port = reserve_port()
    addr = "localhost:%d" % port
    store = port_store.NumpyEmbeddingStore(seed=0)
    store.set_optimizer("sgd", lr=0.1)
    specs = deepfm.sparse_embedding_specs(num_features=FIELDS,
                                          batch_size=BATCH)
    for spec in specs:
        store.create_table(spec.name, spec.dim, initializer="zeros")
        ids, _, _ = trained.store.export_table_full(spec.name)
        store.import_table(spec.name, ids, trained.store.lookup(spec.name,
                                                                ids))
    store.set_version(7)
    ckpt = SparseCheckpointSaver(str(tmp_path / "ckpt"))
    ckpt.save(7, store)
    ids = _seen_ids(batches, 8, seed=3)
    # the rows move after the checkpoint: a relaunch restores older ones
    for spec in specs:
        unique = np.unique(ids)
        store.push_gradients(spec.name, unique, np.ones(
            (unique.size, spec.dim), np.float32))
    servers = []

    def serve_ps(ps_store, restored):
        server = build_server()
        add_pserver_servicer_to_server(
            PserverServicer(ps_store, ps_id=0, restored_version=restored),
            server)
        server.add_insecure_port(addr)
        server.start()
        servers.append(server)

    serve_ps(store, None)
    client = PSClient([addr])
    engine = ServingEngine(
        "elasticdl_tpu_torch.models.deepfm", export_dir, ps_client=client,
        max_batch=8, max_delay_ms=2.0, deadline_ms=30000.0,
        cache_ttl_secs=600.0, device="cpu").start(block=True)
    try:
        # the read-only preparer left the hook slot to the engine's chain
        assert client.resync_hook is not None
        assert engine.cache_drops == 0
        before, _, _ = engine.predict({"ids": ids}, 8)
        cached = engine.predict({"ids": ids}, 8)[0]["output"]
        torch.testing.assert_close(cached, before["output"], rtol=0,
                                   atol=0)
        servers.pop().stop(None).wait()
        relaunched = port_store.NumpyEmbeddingStore(seed=0)
        relaunched.set_optimizer("sgd", lr=0.1)
        assert SparseCheckpointSaver(str(tmp_path / "ckpt")).restore(
            relaunched) == 7
        serve_ps(relaunched, 7)
        # rows all cached reach no PS: the relaunch shows on the next
        # pull, of a batch with ids the cache does not hold
        assert engine.cache_drops == 0
        other = _seen_ids(batches, 8, seed=4)
        assert np.setdiff1d(other, ids).size
        engine.predict({"ids": other}, 8)
        assert engine.cache_drops == 1
        after, _, _ = engine.predict({"ids": ids}, 8)
        fresh = ServingModel(get_model_spec(
            "elasticdl_tpu_torch.models.deepfm"), export_dir, max_batch=8,
            ps_client=PSClient([addr]), device="cpu")
        want = fresh.predict({"ids": ids}, 8)["output"]
        torch.testing.assert_close(after["output"], want, rtol=0, atol=0)
        # the cached rows were the pre-relaunch ones: they would differ
        assert not torch.equal(after["output"], before["output"])
        engine.predict({"ids": ids}, 8)
        assert engine.cache_drops == 1
    finally:
        engine.drain(timeout=5)
        client.close()
        for server in servers:
            server.stop(None)
        reservation.close()

"""The port's sparse CTR path against the JAX package's, on the CPU.

(a) the host embedding store, bit for bit; (b) one DeepFM step (loss,
dense gradients, row gradients) from the same dense params, carried
across by ``params_from_flax``; (c) the PS table state and the device
tier's state after several steps; (d) ``LocalExecutor`` on DeepFM end
to end. Small sizes (4 fields, batch 32, vocab 1000, tier capacity
256), inputs made with numpy from a seed. Both sides name their store:
numpy against numpy, or native against native (the two C++ stores are
one source and one seed). A native store draws its lazy rows from
another random stream (mt19937) than a numpy store, so across the two
kinds only deterministic initializers agree bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticdl_tpu.models import deepfm as ref_deepfm
from elasticdl_tpu.ps import embedding_store as ref_store
from elasticdl_tpu.ps.local_client import LocalPSClient as RefLocalPSClient
from elasticdl_tpu.train import device_tier as ref_tier
from elasticdl_tpu.train import export as ref_export
from elasticdl_tpu.train import optimizers as ref_opt
from elasticdl_tpu.train import sparse as ref_sparse
from elasticdl_tpu_torch.models import deepfm
from elasticdl_tpu_torch.ps import embedding_store as port_store
from elasticdl_tpu_torch.ps.local_client import LocalPSClient
from elasticdl_tpu_torch.train import device_tier as port_tier
from elasticdl_tpu_torch.train import optimizers as port_opt
from elasticdl_tpu_torch.train import sparse

torch.set_num_threads(1)

FIELDS = 4
BATCH = 32
VOCAB = 1000

# (b) one step in fp32 from identical inputs and weights: the same
# operations, summed in another order (the FM sums over 4 fields, the
# 32 x 64 and 64 x 32 products, the mean over 32 rows, the scatter-add
# of a row's gradient over its occurrences). The loss agrees to an fp32
# ulp or two; each gradient leaf to 1e-5 of its largest entry.
LOSS_RTOL = 1e-6
GRAD_RTOL = 1e-5
# (c) state after several steps: each step's gradients carry the (b)
# differences into adam, whose update lr * m / (sqrt(v) + eps) divides
# by sqrt(v): for an entry whose gradient is near eps that amplifies a
# 1e-5 relative difference up to 1 / eps (the step-parity finding of
# the dense slice). The multi-step comparisons therefore run adam with
# eps 1e-3 on the dense params, the PS and the tier (ADAM_EPS): the
# noise then moves a value by far less than 1e-6 a step, and the rows
# agree to 1e-5 relative, 1e-7 absolute after the steps below.
ADAM_EPS = 1e-3
STATE_RTOL, STATE_ATOL = 1e-5, 1e-7
STEPS = 12

INITIALIZERS = ["uniform", "normal", "truncated_normal", "constant", "zeros"]
STORE_OPTS = ["sgd", "momentum", "nesterov", "adagrad", "adam", "amsgrad"]


def make_batches(n, seed=0, zipf=1.6, vocab=VOCAB, offset=0):
    """The reference tier tests' batches (tests/test_device_tier.py)."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        ids = (rng.zipf(zipf, size=(BATCH, FIELDS)) % vocab + offset)
        out.append({
            "features": {"ids": ids.astype(np.int64)},
            "labels": (ids.sum(1) % 2).astype(np.float32),
            "_mask": np.ones(BATCH, np.float32),
        })
    return out


def ref_client(seed=0, opt_type="adam", store="numpy", **opt_args):
    """The reference's in-process client over its numpy (or native)
    store."""
    cls = (ref_store.NumpyEmbeddingStore if store == "numpy"
           else ref_store.NativeEmbeddingStore)
    ps_store = cls(seed=seed)
    ps_store.set_optimizer(opt_type, **opt_args)
    return RefLocalPSClient(store=ps_store)


def port_client(seed=0, opt_type="adam", store="numpy", **opt_args):
    """The port's in-process client over its numpy store, or (``store=
    "native"``) as a user builds it: ``create_store``'s choice, which
    must be the native store here."""
    if store == "native":
        client = LocalPSClient(seed=seed, opt_type=opt_type, **opt_args)
        assert isinstance(client.store, port_store.NativeEmbeddingStore)
        return client
    ps_store = port_store.NumpyEmbeddingStore(seed=seed)
    ps_store.set_optimizer(opt_type, **opt_args)
    return LocalPSClient(store=ps_store)


def tier_configs(**overrides):
    """(reference, port) DeviceTierConfig pair from one set of knobs."""
    base = dict(
        capacity=256, promote_hits=2, ttl=100, stage_budget=64,
        opt_type="adam", opt_args={"lr": 0.01}, writeback_steps=8,
    )
    base.update(overrides)
    return (ref_tier.DeviceTierConfig(**base),
            port_tier.DeviceTierConfig(**base))


def trainer_pair(first_batch, tier=None, eps=None, lr=0.01, seed=0,
                 store="numpy", **trainer_kwargs):
    """A reference and a port SparseTrainer on DeepFM (4 fields), the
    port's dense params carried across from the reference's state on
    ``first_batch``, both with the PS adam at ``lr`` (and ``eps``) on
    their ``store`` ("numpy" or "native"); ``tier`` is a (reference,
    port) config pair or None. Returns (ref_trainer, port_trainer,
    ref_state, port_state)."""
    ps_args = {"lr": lr}
    dense_args = {"learning_rate": 0.001}
    if eps is not None:
        ps_args["epsilon"] = eps
        dense_args["epsilon"] = eps
    ref_t = ref_sparse.SparseTrainer(
        model=ref_deepfm.custom_model(),
        loss_fn=ref_deepfm.loss,
        optimizer=ref_opt.create_optimizer("Adam", **dense_args),
        specs=ref_deepfm.sparse_embedding_specs(
            num_features=FIELDS, batch_size=BATCH),
        ps_client=ref_client(seed=seed, store=store, **ps_args),
        seed=seed,
        device_tier=False if tier is None else tier[0],
        health=False,
        **trainer_kwargs,
    )
    ref_state = ref_t.ensure_state(None, first_batch)
    model = deepfm.custom_model()
    model.load_state_dict(deepfm.params_from_flax(
        ref_export._flatten(jax.device_get(ref_state.params))))
    port_t = sparse.SparseTrainer(
        model=model,
        loss_fn=deepfm.loss,
        optimizer=port_opt.create_optimizer("Adam", **dense_args),
        specs=deepfm.sparse_embedding_specs(
            num_features=FIELDS, batch_size=BATCH),
        ps_client=port_client(seed=seed, store=store, **ps_args),
        seed=seed,
        device_tier=False if tier is None else tier[1],
        health=False,
        device="cpu",
        **trainer_kwargs,
    )
    port_state = port_t.ensure_state(None, first_batch)
    return ref_t, port_t, ref_state, port_state


def assert_stores_equal(ref, port, tables, exact=True):
    """The two stores hold the same ids in the same order, with the
    same rows, optimizer slots and step counts."""
    for table in tables:
        r_ids, r_rows, r_steps = ref.export_table_full(table)
        p_ids, p_rows, p_steps = port.export_table_full(table)
        np.testing.assert_array_equal(p_ids, r_ids)
        np.testing.assert_array_equal(p_steps, r_steps)
        if exact:
            np.testing.assert_array_equal(p_rows, r_rows, err_msg=table)
        else:
            np.testing.assert_allclose(p_rows, r_rows, rtol=STATE_RTOL,
                                       atol=STATE_ATOL, err_msg=table)


# ---------------------------------------------------------------------
# (a) the host store, bit for bit


@pytest.mark.parametrize("initializer", INITIALIZERS)
@pytest.mark.parametrize("opt_type", STORE_OPTS)
def test_store_matches_reference_bit_for_bit(opt_type, initializer):
    """Lazy init (per-table RandomState seeding), lookups, and pushes of
    unique ids (the vectorized apply) and of duplicate ids (the per-id
    apply) give the reference numpy store's state bit for bit."""
    rng = np.random.RandomState(7)
    stores = []
    for module in (ref_store, port_store):
        store = module.NumpyEmbeddingStore(seed=3)
        store.set_optimizer(opt_type, lr=0.05)
        store.create_table("a", 8, init_scale=0.1, initializer=initializer)
        store.create_table("b", 1, init_scale=0.2, initializer=initializer)
        stores.append(store)
    for _ in range(4):
        lookup_ids = rng.randint(0, 50, size=12)
        unique_ids = rng.permutation(60)[:9]
        dup_ids = rng.randint(0, 60, size=7)
        dup_ids[1] = dup_ids[0]
        grads = {name: rng.randn(n, dim).astype(np.float32)
                 for name, n, dim in (("u8", 9, 8), ("u1", 9, 1),
                                      ("d8", 7, 8), ("d1", 7, 1))}
        looked = []
        for store in stores:
            looked.append((store.lookup("a", lookup_ids),
                           store.lookup("b", lookup_ids[::-1])))
            store.push_gradients("a", unique_ids, grads["u8"])
            store.push_gradients("b", unique_ids, grads["u1"])
            store.push_gradients("a", dup_ids, grads["d8"])
            store.push_gradients("b", dup_ids, grads["d1"], lr_scale=0.5)
        for ref_rows, port_rows in zip(*looked):
            np.testing.assert_array_equal(port_rows, ref_rows)
    assert_stores_equal(stores[0], stores[1], ("a", "b"))


@pytest.mark.parametrize("wire", ["", "float16", "bfloat16"])
def test_local_client_matches_reference(wire, monkeypatch):
    """LocalPSClient: table registration from wire initializer strings,
    pulls and deduplicated pushes (with EDL_WIRE_DTYPE's rounding,
    which the port applies through torch) and the tier's raw-row
    writeback land the reference's state bit for bit (numpy stores)."""
    _local_clients_agree(wire, "numpy", monkeypatch)


@pytest.mark.parametrize("wire", ["", "float16", "bfloat16"])
def test_local_client_on_native_store_matches_reference(wire, monkeypatch):
    """The same on the native stores: the port's LocalPSClient as a user
    builds it (create_store's native store) against the reference's
    client over its native store, bit for bit under the uniform and
    normal initializers too (one C++ source, one seed)."""
    _local_clients_agree(wire, "native", monkeypatch)


def _local_clients_agree(wire, store, monkeypatch):
    monkeypatch.setenv("EDL_WIRE_DTYPE", wire)
    rng = np.random.RandomState(11)
    clients = [ref_client(seed=1, opt_type="adam", store=store, lr=0.02),
               port_client(seed=1, opt_type="adam", store=store, lr=0.02)]
    infos = [("e", 4, "0.05"), ("w", 1, "zeros"), ("n", 2, "normal:0.3")]
    pulled = []
    for client in clients:
        client.push_embedding_table_infos(infos)
    for _ in range(3):
        ids = rng.randint(0, 40, size=10)
        grads = {name: rng.randn(10, dim).astype(np.float32)
                 for name, dim, _ in infos}
        rows = rng.randn(3, 4).astype(np.float32)
        for client in clients:
            pulled.append(client.pull_embedding_batch(
                {"e": ids, "w": ids, "n": ids[:4], "empty": []}))
            accepted, _ = client.push_gradients(
                {name: (grads[name], ids) for name, _, _ in infos})
            assert accepted
            client.push_embedding_rows({"e": (ids[:3], rows)})
    for ref_pull, port_pull in zip(pulled[::2], pulled[1::2]):
        assert sorted(port_pull) == sorted(ref_pull) == ["e", "n", "w"]
        for name in ref_pull:
            np.testing.assert_array_equal(port_pull[name], ref_pull[name])
    assert_stores_equal(clients[0].store, clients[1].store, ("e", "w", "n"))
    assert clients[0].store.version == clients[1].store.version == 3


def test_wire_dtype_rejects_unknown(monkeypatch):
    from elasticdl_tpu_torch.common.tensor_utils import wire_dtype

    monkeypatch.setenv("EDL_WIRE_DTYPE", "int8")
    with pytest.raises(ValueError, match="EDL_WIRE_DTYPE"):
        wire_dtype()


def test_deduplicate_indexed_slices_matches_reference():
    from elasticdl_tpu.common.tensor_utils import (
        deduplicate_indexed_slices as ref_dedup,
    )
    from elasticdl_tpu_torch.common.tensor_utils import (
        deduplicate_indexed_slices,
    )

    rng = np.random.RandomState(5)
    for ids in (rng.permutation(30)[:12], rng.randint(0, 9, size=40)):
        values = rng.randn(ids.size, 8).astype(np.float32)
        got = deduplicate_indexed_slices(values, ids)
        want = ref_dedup(values, ids)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------
# (b) one step


def _ref_loss_and_grads(trainer, state, prepared):
    """The reference's loss, dense gradients and row gradients at
    ``state`` on a prepared batch (its own forward, jax.grad)."""
    row_keys = [s.name + sparse.ROWS_SUFFIX for s in trainer._specs]
    features, labels, mask, rows = ref_sparse._split_batch(
        jax.tree_util.tree_map(jnp.asarray, prepared), row_keys)

    def loss_fn(params, rows):
        return ref_sparse._forward_loss(
            trainer._model, ref_deepfm.loss, None, params, {}, rows,
            features, labels, mask, {},
        )

    (loss, _), (dense, row) = jax.value_and_grad(
        loss_fn, argnums=(0, 1), has_aux=True)(state.params, rows)
    return (float(loss), ref_export._flatten(jax.device_get(dense)),
            {k: np.asarray(v) for k, v in row.items()})


def _port_loss_and_grads(trainer, state, prepared):
    batch = sparse._to_device(prepared, "cpu")
    features = dict(batch["features"])
    rows = {s.name + sparse.ROWS_SUFFIX:
            features.pop(s.name + sparse.ROWS_SUFFIX).requires_grad_()
            for s in trainer._specs}
    params = {n: p.detach().requires_grad_()
              for n, p in state.params.items()}
    loss = sparse._forward_loss(
        trainer.model, deepfm.loss, None, params, state.model_state, rows,
        features, batch["labels"], batch["_mask"],
    )
    leaves = list(params.values()) + list(rows.values())
    grads = torch.autograd.grad(loss, leaves)
    dense = dict(zip(params, grads[:len(params)]))
    row = dict(zip(rows, grads[len(params):]))
    return float(loss.detach()), dense, {k: v.numpy() for k, v in row.items()}


def _assert_close_to_max(got, want, rtol, name):
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale,
                               err_msg=name)


@pytest.mark.parametrize("masked", [False, True])
def test_one_step_matches_reference(masked):
    """From the same dense params and the same prepared batch (the
    preparers must agree bit for bit: rows, indices, slot masks), the
    loss, every dense gradient and every row gradient agree with the
    reference before any optimizer runs. ``masked`` pads the batch's
    last 5 rows out (the padded-tail-batch path)."""
    batch = make_batches(1, seed=3)[0]
    if masked:
        batch["_mask"][-5:] = 0.0
    ref_t, port_t, ref_state, port_state = trainer_pair(batch)
    ref_prep, ref_info = ref_t._prepare_once(batch)
    port_prep, port_info = port_t._prepare_once(batch)
    assert sorted(port_prep["features"]) == sorted(ref_prep["features"])
    for key, value in ref_prep["features"].items():
        np.testing.assert_array_equal(port_prep["features"][key], value,
                                      err_msg=key)
    for name, (ids, n) in ref_info.items():
        np.testing.assert_array_equal(port_info[name][0], ids)
        assert port_info[name][1] == n
    r_loss, r_dense, r_rows = _ref_loss_and_grads(ref_t, ref_state, ref_prep)
    p_loss, p_dense, p_rows = _port_loss_and_grads(port_t, port_state,
                                                   port_prep)
    np.testing.assert_allclose(p_loss, r_loss, rtol=LOSS_RTOL)
    flax_of = {"dense.%d.%s" % (i, leaf): "Dense_%d/%s" % (i, flax_leaf)
               for i in range(3)
               for leaf, flax_leaf in (("weight", "kernel"),
                                       ("bias", "bias"))}
    assert sorted(flax_of.values()) == sorted(r_dense)
    for name, grad in p_dense.items():
        want = r_dense[flax_of[name]]
        got = grad.numpy().T if name.endswith("weight") else grad.numpy()
        _assert_close_to_max(got, want, GRAD_RTOL, name)
    for key, want in r_rows.items():
        _assert_close_to_max(p_rows[key], want, GRAD_RTOL, key)


# ---------------------------------------------------------------------
# (c) state after several steps


def test_ps_state_after_steps_matches_reference_tier_off():
    """With the tier off, every deepfm step pulls and pushes through
    the PS: after STEPS steps the PS tables (rows, adam slots, step
    counts, row creation order) and the losses agree with the
    reference's (ADAM_EPS: see the tolerance note)."""
    batches = make_batches(STEPS, seed=4)
    ref_t, port_t, ref_state, port_state = trainer_pair(batches[0],
                                                        eps=ADAM_EPS)
    for batch in batches:
        ref_state, r_loss = ref_t.train_step(ref_state, batch)
        port_state, p_loss = port_t.train_step(port_state, batch)
        np.testing.assert_allclose(float(p_loss), float(r_loss),
                                   rtol=STATE_RTOL)
    assert_stores_equal(ref_t.preparer._ps.store, port_t.preparer._ps.store,
                        ("deepfm_emb", "deepfm_linear"), exact=False)
    ref_t.close()
    port_t.close()


def test_tier_state_after_steps_matches_reference():
    """With the tier on (adam on the tier, ADAM_EPS), the tier's
    bookkeeping follows the id stream alone and matches exactly (hits,
    misses, evictions, resident ids); the resident rows and, after a
    flush, the PS tables agree within the state tolerance."""
    batches = make_batches(STEPS + 8, seed=5)
    tiers = tier_configs(opt_args={"lr": 0.01, "epsilon": ADAM_EPS},
                         capacity=48, promote_hits=1, stage_budget=16)
    ref_t, port_t, ref_state, port_state = trainer_pair(
        batches[0], tier=tiers, eps=ADAM_EPS)
    for batch in batches:
        ref_state, r_loss = ref_t.train_step(ref_state, batch)
        port_state, p_loss = port_t.train_step(port_state, batch)
        np.testing.assert_allclose(float(p_loss), float(r_loss),
                                   rtol=STATE_RTOL)
    r_stats, p_stats = ref_t.device_tier.stats(), port_t.device_tier.stats()
    assert p_stats["evictions"] > 0  # the small tier cycled rows
    for key in ("hits", "misses", "evictions", "hit_rate", "occupancy"):
        assert p_stats[key] == r_stats[key], key
    for table in ("deepfm_emb", "deepfm_linear"):
        r_ids, r_rows = ref_t.device_tier.table_rows(table)
        p_ids, p_rows = port_t.device_tier.table_rows(table)
        np.testing.assert_array_equal(p_ids, r_ids)
        np.testing.assert_allclose(p_rows, r_rows, rtol=STATE_RTOL,
                                   atol=STATE_ATOL, err_msg=table)
    ref_t.flush_device_tier()
    port_t.flush_device_tier()
    assert_stores_equal(ref_t.preparer._ps.store, port_t.preparer._ps.store,
                        ("deepfm_emb", "deepfm_linear"), exact=False)
    ref_t.close()
    port_t.close()


@pytest.mark.parametrize("from_logits", [False, True])
def test_eval_metrics_match_reference(from_logits):
    """DeepFM's eval metrics (AUC, BinaryAccuracy) against the
    reference's on the same streamed batches, with tied scores (AUC
    ranks a tie at its average rank): equal, since both sum the same
    float64 ranks in the same order; a one-class stream reads 0.0 on
    both sides."""
    from elasticdl_tpu.train import metrics as ref_metrics
    from elasticdl_tpu_torch.train import metrics as port_metrics

    rng = np.random.RandomState(3)
    pairs = [(getattr(port_metrics, name)(from_logits=from_logits),
              getattr(ref_metrics, name)(from_logits=from_logits))
             for name in ("AUC", "BinaryAccuracy")]
    for _ in range(4):
        labels = rng.randint(0, 2, 50).astype(np.float32)
        logits = np.round(rng.randn(50), 1).astype(np.float32)
        scores = logits if from_logits else 1.0 / (1.0 + np.exp(-logits))
        for port, ref in pairs:
            port.update_state(labels, scores)
            ref.update_state(labels, scores)
    for port, ref in pairs:
        assert 0.0 < port.result() == ref.result()
        port.reset_states()
        ref.reset_states()
        port.update_state(np.ones(4), np.arange(4.0))
        ref.update_state(np.ones(4), np.arange(4.0))
        assert port.result() == ref.result()
    assert pairs[0][0].result() == 0.0


def test_fan_out_pull_matches_batch_pull():
    """A PS client without the fused multi-table pull is served by the
    per-table fan-out: the same rows, per table and in id order, as the
    fused pull of an identical store."""
    from elasticdl_tpu_torch.embedding.client import EmbeddingClient

    class PerTableClient:
        def __init__(self, inner):
            self.pull_embedding_vectors = inner.pull_embedding_vectors

    clients = [LocalPSClient(seed=4) for _ in range(2)]
    for client in clients:
        client.push_embedding_table_infos([("a", 8, "0.1"), ("b", 1, "0.2")])
    fused = EmbeddingClient(clients[0])
    fanned = EmbeddingClient(PerTableClient(clients[1]))
    ids = {"a": np.array([7, 2, 99]), "b": np.array([5, 7]),
           "empty": np.array([], np.int64)}
    got, want = fanned.pull_tables(ids), fused.pull_tables(ids)
    assert sorted(got) == sorted(want) == ["a", "b"]
    for name in want:
        assert got[name].dtype == np.float32
        np.testing.assert_array_equal(got[name], want[name])
    one = {"a": np.array([3])}
    np.testing.assert_array_equal(fanned.pull_tables(one)["a"],
                                  fused.pull_tables(one)["a"])
    fanned.close()
    fused.close()


# ---------------------------------------------------------------------
# (d) end to end


def test_local_executor_trains_deepfm_end_to_end(tmp_path):
    """LocalExecutor on DeepFM over CTR records (10 fields, planted
    signal), on the CPU: the losses fall and the eval summary carries
    auc and accuracy. The AUC is held against the reference executor's
    on the same data rather than a fixed bar (the reference itself
    reads 0.80-0.81 here): the port's dense init is drawn from a torch
    generator, so the two runs start from other weights, and 128
    held-out rows give the AUC a spread of a few hundredths."""
    from elasticdl_tpu.train.local_executor import (
        LocalExecutor as RefLocalExecutor,
    )
    from elasticdl_tpu_torch.train.local_executor import LocalExecutor
    from tests.test_utils import create_ctr_recordio

    train_dir, valid_dir = tmp_path / "train", tmp_path / "valid"
    train_dir.mkdir()
    valid_dir.mkdir()
    create_ctr_recordio(str(train_dir / "f0.rec"), num_records=512, seed=0)
    create_ctr_recordio(str(valid_dir / "f0.rec"), num_records=128, seed=1)
    kwargs = dict(training_data=str(train_dir),
                  validation_data=str(valid_dir), minibatch_size=64,
                  num_epochs=3)
    executor = LocalExecutor("elasticdl_tpu_torch.models.deepfm",
                             device="cpu", **kwargs)
    assert isinstance(executor.trainer, sparse.SparseTrainer)
    losses = executor.train()
    assert len(losses) == 24 and np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    summary = executor.evaluate()
    assert sorted(summary) == ["accuracy", "auc"]
    reference = RefLocalExecutor("elasticdl_tpu.models.deepfm", **kwargs)
    ref_losses = reference.train()
    ref_summary = reference.evaluate()
    assert summary["auc"] > ref_summary["auc"] - 0.05, (summary, ref_summary)
    assert summary["accuracy"] > ref_summary["accuracy"] - 0.1
    np.testing.assert_allclose(losses[0], ref_losses[0], rtol=1e-2)
    predictions = executor.predict()
    assert sum(p.shape[0] for p in predictions) == 128

"""The promotion half of the model handler on the port
(``train/model_handler.py``): big embedding columns move to the host PS
and train through ``SparseTrainer``, on the CPU.

(a) tests/test_model_handler.py's four scenarios on the port; (b)
against the reference, bit for bit: the plan's specs and shapes,
``materialize_ids`` on fixed-length, variable-length (with weights) and
string-hashed columns, and what ``SparseBatchPreparer.prepare`` plants
from them (indices, slot masks, pulled rows) and the PS rows it
touches, over a numpy store on each side from one seed; (c) one step of
a promoted model (a variable-length column under the ``mean`` combiner
beside a device table) over a numpy store on each side from the
reference's initial weights: the loss, every dense gradient leaf and
every pushed row gradient within a relative L2 of 1e-5 (fp32, other
summation orders), the pushed ids equal, and no PS row or tier slot for
an id that appears only in padded slots, with and without the tier.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from elasticdl_tpu.preprocessing import feature_column as ref_fc
from elasticdl_tpu.preprocessing import sparse as ref_sparse
from elasticdl_tpu.train import model_handler as ref_mh
from elasticdl_tpu.train import sparse as ref_train_sparse
from elasticdl_tpu_torch.data.pipeline import MASK_KEY
from elasticdl_tpu_torch.models.layers import (
    Dense,
    FlaxNamed,
    params_from_flax,
)
from elasticdl_tpu_torch.preprocessing import feature_column as fc
from elasticdl_tpu_torch.preprocessing.sparse import (
    PaddedSparse,
    from_row_lists,
)
from elasticdl_tpu_torch.ps.local_client import LocalPSClient
from elasticdl_tpu_torch.train import model_handler as mh
from elasticdl_tpu_torch.train.losses import sigmoid_binary_cross_entropy
from elasticdl_tpu_torch.train.optimizers import create_optimizer
from elasticdl_tpu_torch.train.sparse import (
    INDICES_SUFFIX,
    ROWS_SUFFIX,
    SLOT_MASK_SUFFIX,
    SparseBatchPreparer,
    SparseTrainer,
)
from tests.test_torch_sparse import port_client, ref_client, tier_configs

torch.set_num_threads(1)

GRAD_RTOL = 1e-5


def build_columns(fc_mod, vocab=1000, hashed=False):
    big = fc_mod.embedding_column(
        fc_mod.categorical_column_with_identity("cat_big", vocab),
        dimension=8, combiner="mean")
    small = fc_mod.embedding_column(
        fc_mod.categorical_column_with_identity("cat_small", 10),
        dimension=4)
    cols = [big, small, fc_mod.numeric_column("x")]
    if hashed:
        cols.append(fc_mod.embedding_column(
            fc_mod.categorical_column_with_hash_bucket("word", 5000),
            dimension=4, combiner="sqrtn"))
    return cols


class PortModel(FlaxNamed):
    """The reference test's ``_Model``: DenseFeatures, Dense 16 + ReLU,
    Dense 1."""

    def __init__(self, features_layer):
        super().__init__()
        self.features_layer = features_layer
        self.Dense_0 = Dense(features_layer.output_dim, 16)
        self.Dense_1 = Dense(16, 1)
        self.reset_parameters()

    def forward(self, features):
        x = torch.relu(self.Dense_0(self.features_layer(features)))
        return self.Dense_1(x)[:, 0]


class RefModel(nn.Module):
    features_layer: nn.Module

    @nn.compact
    def __call__(self, features, training: bool = False):
        x = self.features_layer(features)
        x = nn.relu(nn.Dense(16)(x))
        return nn.Dense(1)(x)[:, 0]


def _make_batch(rng, batch_size=64):
    cat_big = rng.integers(0, 1000, size=(batch_size, 1))
    cat_small = rng.integers(0, 10, size=(batch_size, 1))
    x = rng.normal(size=(batch_size,)).astype(np.float32)
    labels = (cat_big[:, 0] < 500).astype(np.float32)
    return {
        "features": {"cat_big": cat_big, "cat_small": cat_small, "x": x},
        "labels": labels,
        MASK_KEY: np.ones(batch_size, dtype=bool),
    }


def _trainer(plan, ps, **kwargs):
    return SparseTrainer(
        PortModel(mh.dense_features(plan)), sigmoid_binary_cross_entropy,
        create_optimizer("Adam", learning_rate=0.05), plan.sparse_specs, ps,
        device="cpu", **kwargs)


# -------------------------------------------------------------- (a) mirrors
def test_promotion_split_by_size():
    plan = mh.promote_large_embeddings(build_columns(fc), threshold_bytes=1024)
    assert [c.table_name for c in plan.promoted] == ["cat_big_embedding"]
    assert len(plan.kept) == 2
    assert plan.table_shapes == {"cat_big_embedding": (1000, 8)}
    spec = plan.sparse_specs[0]
    assert spec.dim == 8
    assert spec.feature_key == mh.IDS_PREFIX + "cat_big_embedding"


def test_default_threshold_matches_reference():
    assert mh.EMBEDDING_PROMOTION_THRESHOLD_BYTES == 2 * 1024 * 1024
    plan = mh.promote_large_embeddings(build_columns(fc))
    assert not plan.promoted  # 32 KB stays on the device by default
    # 1,000,000 x 8 fp32 is 32 MB: promoted at the default threshold
    plan = mh.promote_large_embeddings(build_columns(fc, vocab=1_000_000))
    assert plan.table_shapes == {"cat_big_embedding": (1_000_000, 8)}


def test_promoted_model_trains_and_exports(tmp_path):
    plan = mh.promote_large_embeddings(build_columns(fc), threshold_bytes=1024)
    ps = LocalPSClient(opt_type="adam", learning_rate=0.05)
    trainer = _trainer(plan, ps)
    rng = np.random.default_rng(0)
    state, losses = None, []
    for _ in range(60):
        batch = _make_batch(rng)
        batch["features"] = plan.materialize_ids(batch["features"])
        state = trainer.ensure_state(state, batch)
        state, loss = trainer.train_step(state, batch)
        losses.append(float(loss))
    assert np.mean(losses[-10:]) < np.mean(losses[:10]) * 0.7
    # the promoted table owns no device parameter; the kept one does
    names = set(state.params)
    assert "features_layer.cat_small_embedding" in names
    assert not any("cat_big" in name for name in names)
    # the inverse rewrite: the bundle carries the whole PS table
    path = mh.export_promoted_train_state(state, plan, ps,
                                          str(tmp_path / "export"))
    tables = mh.load_exported_tables(path)
    assert tables["cat_big_embedding"].shape == (1000, 8)
    some_ids = np.arange(0, 1000, 37, dtype=np.int64)
    np.testing.assert_array_equal(
        tables["cat_big_embedding"][some_ids],
        ps.pull_embedding_vectors("cat_big_embedding", some_ids))


def _tags_batches(seed, n=3):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        rows = [list(rng.integers(100, 200, size=rng.integers(1, 4)))
                for _ in range(16)]
        out.append(from_row_lists(rows, max_len=4))
    return out


@pytest.mark.parametrize("tier", [False, True])
def test_padded_slots_never_touch_ps_rows(tier):
    """A variable-length feature: masked padding slots pull and update
    no PS row (id 0 would take a spurious optimizer step every padded
    batch) and take no tier slot."""
    big = fc.embedding_column(
        fc.categorical_column_with_identity("tags", 1000), dimension=8)
    plan = mh.promote_large_embeddings([big], threshold_bytes=1024)
    ps = LocalPSClient(opt_type="adam", learning_rate=0.05)
    trainer = _trainer(plan, ps, device_tier=(
        tier_configs(capacity=64, promote_hits=1)[1] if tier else False))
    state = None
    for sp in _tags_batches(1):
        batch = {"features": plan.materialize_ids({"tags": sp}),
                 "labels": np.ones(16, dtype=np.float32),
                 MASK_KEY: np.ones(16, dtype=bool)}
        # the padded slots hold id 0 after materialize_ids
        assert (batch["features"][mh.IDS_PREFIX + "tags_embedding"][
            ~batch["features"]["tags_embedding" + mh.MASK_SUFFIX]] == 0).all()
        state = trainer.ensure_state(state, batch)
        state, _ = trainer.train_step(state, batch)
    if tier:
        resident, _ = trainer.device_tier.table_rows("tags_embedding")
        candidates = trainer.device_tier._tables["tags_embedding"].cand_ids
        assert resident.size > 0 and resident.min() >= 100
        assert candidates.size == 0 or candidates.min() >= 100
        trainer.close()  # every resident row written back
    ids, _ = ps.store.export_table("tags_embedding")
    assert ids.size > 0
    assert ids.min() >= 100, "padding slot created PS row %d" % ids.min()


# ---------------------------------------------------- (b) against reference
def _features(seed, batch=12):
    rng = np.random.RandomState(seed)
    rows = [list(rng.randint(-1, 1000, size=rng.randint(0, 5)))
            for _ in range(batch)]  # -1 and empty rows: padding only
    weights = [list(rng.rand(len(r)).astype(np.float32)) for r in rows]
    words = np.array(["w%d" % v for v in rng.randint(0, 50, size=batch)])
    return {
        "cat_big": (rows, weights),
        "cat_small": rng.randint(0, 10, size=(batch, 1)),
        "x": rng.normal(size=batch).astype(np.float32),
        "word": words[:, None],
    }


def _split(features, pkg):
    """The package's own PaddedSparse for the variable-length column."""
    out = dict(features)
    rows, weights = out["cat_big"]
    make = from_row_lists if pkg == "port" else ref_sparse.from_row_lists
    out["cat_big"] = make(rows, max_len=4, weights=weights)
    return out


def test_plan_and_materialize_ids_match_reference():
    port = mh.promote_large_embeddings(build_columns(fc, hashed=True),
                                       threshold_bytes=1024)
    ref = ref_mh.promote_large_embeddings(build_columns(ref_fc, hashed=True),
                                          threshold_bytes=1024)
    assert port.table_shapes == ref.table_shapes
    for got, want in zip(port.sparse_specs, ref.sparse_specs):
        for key in ("name", "dim", "feature_key", "combiner",
                    "mask_feature_key", "capacity", "init_scale",
                    "initializer"):
            assert getattr(got, key) == getattr(want, key), key
    for seed in range(3):
        features = _features(seed)
        got = port.materialize_ids(_split(features, "port"))
        want = ref.materialize_ids(_split(features, "ref"))
        assert set(got) == set(want)
        assert "word" not in got  # consumed only by a promoted column
        for key, value in want.items():
            if isinstance(value, ref_sparse.PaddedSparse):
                for g, w in zip(got[key], value):
                    np.testing.assert_array_equal(g, w)
                continue
            assert got[key].dtype == np.asarray(value).dtype, key
            np.testing.assert_array_equal(got[key], value, err_msg=key)


def test_prepare_plants_and_touches_what_the_reference_does():
    """Each side's preparer over a numpy store from one seed: the same
    indices, slot masks and pulled rows, bit for bit, and afterwards the
    same PS rows (ids and values)."""
    plan = mh.promote_large_embeddings(build_columns(fc), threshold_bytes=1024)
    ref_plan = ref_mh.promote_large_embeddings(build_columns(ref_fc),
                                               threshold_bytes=1024)
    port_ps, ref_ps = port_client(seed=3), ref_client(seed=3)
    port_prep = SparseBatchPreparer(plan.sparse_specs, port_ps)
    ref_prep = ref_train_sparse.SparseBatchPreparer(ref_plan.sparse_specs,
                                                    ref_ps)
    name = "cat_big_embedding"
    for seed in range(4):
        features = _features(seed)
        mask = np.ones(12, np.float32)
        mask[-2:] = 0  # padded batch rows too
        got, got_info = port_prep.prepare({
            "features": plan.materialize_ids(_split(features, "port")),
            "labels": np.zeros(12, np.float32), MASK_KEY: mask})
        want, want_info = ref_prep.prepare({
            "features": ref_plan.materialize_ids(_split(features, "ref")),
            "labels": np.zeros(12, np.float32), MASK_KEY: mask})
        for suffix in (INDICES_SUFFIX, SLOT_MASK_SUFFIX, ROWS_SUFFIX):
            np.testing.assert_array_equal(
                got["features"][name + suffix],
                np.asarray(want["features"][name + suffix]), err_msg=suffix)
        np.testing.assert_array_equal(got_info[name][0], want_info[name][0])
        assert got_info[name][1] == want_info[name][1]
    got_ids, got_rows = port_ps.store.export_table(name)
    want_ids, want_rows = ref_ps.store.export_table(name)
    np.testing.assert_array_equal(got_ids, want_ids)
    np.testing.assert_array_equal(got_rows, want_rows)
    assert got_ids.min() >= 0


# ------------------------------------------------------ (c) one step, PS each
def _rel_l2(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


class _RecordGrads:
    def __init__(self, tx):
        self.tx, self.grads = tx, None

    def __getattr__(self, name):
        return getattr(self.tx, name)

    def update(self, grads, opt_state, params):
        self.grads = {n: g.detach().clone() for n, g in grads.items()}
        return self.tx.update(grads, opt_state, params)


def test_promoted_step_matches_reference_over_a_ps_each():
    plan = mh.promote_large_embeddings(build_columns(fc), threshold_bytes=1024)
    ref_plan = ref_mh.promote_large_embeddings(build_columns(ref_fc),
                                               threshold_bytes=1024)
    name = "cat_big_embedding"
    features = _features(7, batch=32)
    del features["word"]  # no column of this model reads it
    labels = (np.random.RandomState(8).rand(32) > 0.5).astype(np.float32)
    mask = np.ones(32, np.float32)
    # the reference: its preparer over its numpy store, then the step's
    # loss and gradients in fp32 from its initial weights
    ref_ps = ref_client(seed=5, lr=0.05)
    ref_prep = ref_train_sparse.SparseBatchPreparer(ref_plan.sparse_specs,
                                                    ref_ps)
    prepared, info = ref_prep.prepare({
        "features": ref_plan.materialize_ids(_split(features, "ref")),
        "labels": labels, MASK_KEY: mask})
    ref_model = RefModel(features_layer=ref_mh.dense_features(ref_plan))
    feats = {k: (jax.tree_util.tree_map(jnp.asarray, v)) for k, v in
             prepared["features"].items()}
    params = ref_model.init(jax.random.PRNGKey(0), feats)["params"]
    rows = feats.pop(name + ROWS_SUFFIX)

    def ref_loss(p, r):
        logits = ref_model.apply({"params": p},
                                 {**feats, name + ROWS_SUFFIX: r})
        per = jnp.maximum(logits, 0) - logits * labels + jnp.log1p(
            jnp.exp(-jnp.abs(logits)))
        return jnp.sum(per * mask) / jnp.sum(mask)

    want_loss, (want_dense, want_rows) = jax.jit(jax.value_and_grad(
        ref_loss, argnums=(0, 1)))(params, rows)
    n = info[name][1]
    # the port: SparseTrainer over its numpy store, the same weights
    port_ps = port_client(seed=5, lr=0.05)
    pushed = {}
    push = port_ps.push_gradients

    def record_push(grads_by_table, **kwargs):
        pushed.update({k: (np.array(g), np.array(i))
                       for k, (g, i) in grads_by_table.items()})
        return push(grads_by_table, **kwargs)

    port_ps.push_gradients = record_push
    model = PortModel(mh.dense_features(plan))
    flat = {k: np.array(v) for k, v in
            traverse_util.flatten_dict(params, sep="/").items()}
    model.load_state_dict(params_from_flax(flat), strict=True)
    tx = _RecordGrads(create_optimizer("Adam", learning_rate=0.05))
    trainer = SparseTrainer(model, sigmoid_binary_cross_entropy, tx,
                            plan.sparse_specs, port_ps, device="cpu",
                            health=False, device_tier=False)
    batch = {"features": plan.materialize_ids(_split(features, "port")),
             "labels": labels, MASK_KEY: mask}
    state = trainer.ensure_state(None, batch)
    _, loss = trainer.train_step(state, batch)
    assert abs(float(loss) - float(want_loss)) <= 1e-6 * abs(
        float(want_loss))
    want_flat = {k: np.array(v) for k, v in traverse_util.flatten_dict(
        want_dense, sep="/").items()}
    got_flat = model.flax_params(tx.grads)
    assert set(got_flat) == set(want_flat)
    worst = {k: _rel_l2(got_flat[k], want_flat[k]) for k in want_flat}
    assert max(worst.values()) <= GRAD_RTOL, worst
    grads, ids = pushed[name]
    np.testing.assert_array_equal(ids, info[name][0])
    assert _rel_l2(grads, np.asarray(want_rows)[:n]) <= GRAD_RTOL
    # no row for an id seen only in padded slots (-1 rows, empty rows)
    real = np.unique(np.concatenate(
        [np.asarray(r, np.int64) for r in features["cat_big"][0]]))
    real = real[(real >= 0) & (real < 1000)]
    np.testing.assert_array_equal(np.sort(ids), real)
    store_ids, _ = port_ps.store.export_table(name)
    np.testing.assert_array_equal(np.sort(store_ids), real)


def test_embedding_lookup_takes_every_combiner():
    from elasticdl_tpu.train import sparse as ref_lookup_mod
    from elasticdl_tpu_torch.train import sparse as lookup_mod

    rng = np.random.RandomState(9)
    rows = rng.normal(size=(10, 3)).astype(np.float32)
    indices = rng.randint(0, 10, size=(6, 4)).astype(np.int32)
    slot_mask = rng.rand(6, 4) > 0.3
    for combiner in ("sum", "mean", "sqrtn", None):
        for with_mask in (False, True):
            features = {"t__rows": rows, "t__indices": indices}
            if with_mask:
                features["t__slotmask"] = slot_mask
            got = lookup_mod.embedding_lookup(
                {k: torch.from_numpy(np.asarray(v)) for k, v in
                 features.items()}, "t", combiner)
            want = ref_lookup_mod.embedding_lookup(
                {k: jnp.asarray(v) for k, v in features.items()}, "t",
                combiner)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError):
        lookup_mod.embedding_lookup(
            {"t__rows": torch.zeros(2, 2),
             "t__indices": torch.zeros(2, 2, dtype=torch.int32)}, "t", "max")


def test_port_padded_sparse_rides_the_step():
    """A PaddedSparse feature left in the batch (the identity column's
    raw key, which materialize_ids keeps) moves to the device and
    through the step as a tuple of tensors."""
    big = fc.embedding_column(
        fc.categorical_column_with_identity("tags", 1000), dimension=8)
    plan = mh.promote_large_embeddings([big], threshold_bytes=1024)
    trainer = _trainer(plan, LocalPSClient(opt_type="adam",
                                           learning_rate=0.05))
    (sp,) = _tags_batches(4, n=1)
    batch = {"features": plan.materialize_ids({"tags": sp}),
             "labels": np.ones(16, dtype=np.float32),
             MASK_KEY: np.ones(16, dtype=bool)}
    assert isinstance(batch["features"]["tags"], PaddedSparse)
    state, loss = trainer.train_step(trainer.ensure_state(None, batch), batch)
    assert np.isfinite(float(loss)) and int(state.step) == 1

"""The port's preprocessing layers and feature columns
(elasticdl_tpu_torch/preprocessing/) against the JAX package's.

Two parts: (a) each of tests/test_preprocessing.py's 20 scenarios run
on the port, and (b) the same numpy inputs, made from a seed, through
the reference and the port, compared with the tolerance each test
states: bit for bit for PaddedSparse construction, both Hashing paths
(md5 over numpy ``S``, ``U`` and object arrays and host ints; the
uint32 mixer over integer tensors), IndexLookup, Discretization,
LogRound, RoundIdentity, ToNumber, ToSparse and every column's ids and
mask; fp32 within 1e-6 relative an element for Normalizer,
``combine_gathered``, SparseEmbedding and DenseFeatures outputs and
gradients, from parameters carried across. The reference runs without
x64, so its ids are int32; the port's are int64 and the values agree
below 2**31.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticdl_tpu import preprocessing as ref_pp
from elasticdl_tpu.preprocessing import feature_column as ref_fc
from elasticdl_tpu_torch.preprocessing import (
    ConcatenateWithOffset,
    Discretization,
    Hashing,
    IndexLookup,
    LogRound,
    Normalizer,
    PaddedSparse,
    RoundIdentity,
    SparseEmbedding,
    ToNumber,
    ToSparse,
    analyzer_utils,
    dense_rows,
    from_row_lists,
    to_padded_sparse,
)
from elasticdl_tpu_torch.preprocessing import feature_column as fc

torch.set_num_threads(1)

# fp32 on both sides, the same operations in another summation order
RTOL = 1e-6
ATOL = 1e-7


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _same_ids(got, want):
    """Bit-equal values; the reference's int32 ids against the port's
    int64."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    if got.dtype.kind in "iu" and want.dtype.kind in "iu":
        np.testing.assert_array_equal(got.astype(np.int64),
                                      want.astype(np.int64))
    else:
        assert got.dtype == want.dtype, (got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want)


def _port(sp):
    """A reference PaddedSparse as the port's (the same three fields)."""
    return PaddedSparse(*sp)


def _same_sparse(got, want):
    _same_ids(got.values, want.values)
    _same_ids(got.mask, want.mask)
    assert (got.weights is None) == (want.weights is None)
    if got.weights is not None:
        _same_ids(got.weights, want.weights)


# ------------------------------------------------------------ (a) mirrors
def test_padded_sparse_roundtrip():
    rows = [[1, 2, 3], [4], []]
    sp = from_row_lists(rows)
    assert sp.values.shape == (3, 3)
    assert dense_rows(sp) == rows
    assert list(np.asarray(sp.row_lengths())) == [3, 1, 0]


def test_to_padded_sparse_ignores_sentinels():
    sp = to_padded_sparse(np.array([[1, -1], [-1, 8]]))
    assert dense_rows(sp) == [[1], [8]]
    sp = to_padded_sparse(np.array([["a", ""], ["", "b"]]))
    assert dense_rows(sp) == [["a"], ["b"]]


def test_hashing_strings_and_ints_deterministic():
    layer = Hashing(num_bins=3)
    out1 = layer(np.array([["A"], ["B"], ["C"]]))
    out2 = layer(np.array([["A"], ["B"], ["C"]]))
    np.testing.assert_array_equal(out1, out2)
    assert out1.shape == (3, 1)
    assert ((out1 >= 0) & (out1 < 3)).all()
    # host ints hash like their string form (the two paths agree)
    ints = layer(np.array([[7], [8]]))
    strs = layer(np.array([["7"], ["8"]]))
    np.testing.assert_array_equal(ints, strs)


def test_hashing_tensor_path():
    layer = Hashing(num_bins=16)
    out = layer(torch.arange(32).reshape(4, 8))
    assert out.shape == (4, 8)
    assert bool(((out >= 0) & (out < 16)).all())


def test_index_lookup():
    layer = IndexLookup(vocabulary=["A", "B", "C"])
    out = layer(np.array([["A"], ["B"], ["C"], ["D"], ["E"]]))
    np.testing.assert_array_equal(out[:3], [[0], [1], [2]])
    assert (out[3:] == 3).all()  # single OOV bucket
    assert layer.vocab_size() == 4


def test_index_lookup_from_file(tmp_path):
    vocab_file = tmp_path / "vocab.txt"
    vocab_file.write_text("A\nB\nC\n")
    layer = IndexLookup(vocabulary=str(vocab_file), num_oov_tokens=2)
    out = layer(np.array([["C"], ["Z"]]))
    assert out[0, 0] == 2
    assert out[1, 0] in (3, 4)
    ref = ref_pp.IndexLookup(vocabulary=str(vocab_file), num_oov_tokens=2)
    _same_ids(out, ref(np.array([["C"], ["Z"]])))


def test_index_lookup_rejects_duplicates():
    with pytest.raises(ValueError):
        IndexLookup(vocabulary=["A", "A"])


def test_discretization():
    layer = Discretization(bins=[0.0, 1.0, 2.0])
    out = layer(torch.tensor([[-1.0], [0.0], [0.5], [1.0], [5.0]]))
    np.testing.assert_array_equal(_np(out), [[0], [1], [1], [2], [3]])
    assert layer.num_bins() == 4


def test_log_round():
    layer = LogRound(num_bins=16, base=2)
    out = layer(torch.tensor([[1.2], [1.6], [0.2], [3.1], [100.0]]))
    np.testing.assert_array_equal(_np(out), [[0], [1], [0], [2], [7]])


def test_round_identity():
    layer = RoundIdentity(num_buckets=5)
    out = layer(torch.tensor([[1.2], [1.6], [0.2], [3.1], [4.9]]))
    np.testing.assert_array_equal(_np(out), [[1], [2], [0], [3], [5]])


def test_normalizer():
    layer = Normalizer(subtractor=1.0, divisor=2.0)
    out = layer(torch.tensor([[3.0], [5.0], [7.0]]))
    np.testing.assert_allclose(_np(out), [[1.0], [2.0], [3.0]])
    with pytest.raises(ValueError):
        Normalizer(subtractor=0.0, divisor=0.0)


def test_to_number():
    layer = ToNumber(np.float32, default_value=-1)
    out = layer(np.array([["12.5"], [""], ["3"]]))
    np.testing.assert_allclose(out, [[12.5], [-1.0], [3.0]])
    int_layer = ToNumber(np.int64, default_value=0)
    out = int_layer(np.array([["7"], [""]]))
    np.testing.assert_array_equal(out, [[7], [0]])


def test_layers_map_over_padded_sparse():
    sp = from_row_lists([[3.0, 5.0], [7.0]], dtype=np.float32)
    out = Normalizer(subtractor=1.0, divisor=2.0)(sp)
    assert isinstance(out, PaddedSparse)
    assert dense_rows(out) == [[1.0, 2.0], [3.0]]


def test_concatenate_with_offset_dense_and_sparse():
    a1 = torch.tensor([[1], [1], [1]])
    a2 = torch.tensor([[2], [2], [2]])
    out = ConcatenateWithOffset(offsets=[0, 10], axis=1)([a1, a2])
    np.testing.assert_array_equal(_np(out), [[1, 12], [1, 12], [1, 12]])
    s1 = from_row_lists([[1], [1, 2]])
    s2 = from_row_lists([[0, 1], [0]])
    sp = ConcatenateWithOffset(offsets=[0, 5], axis=1)([s1, s2])
    assert dense_rows(sp) == [[1, 5, 6], [1, 2, 5]]
    with pytest.raises(ValueError):
        ConcatenateWithOffset(offsets=[0])([a1, a2])


def test_sparse_embedding_combiners():
    table_ids = from_row_lists([[0, 1], [2]])
    for combiner, reduce_fn in [
        ("sum", lambda r: r.sum(0)),
        ("mean", lambda r: r.mean(0)),
        ("sqrtn", lambda r: r.sum(0) / np.sqrt(r.shape[0])),
    ]:
        layer = SparseEmbedding(input_dim=4, output_dim=8, combiner=combiner)
        out = _np(layer(table_ids))
        table = _np(layer.embeddings)
        np.testing.assert_allclose(out[0], reduce_fn(table[[0, 1]]),
                                   rtol=1e-5)
        np.testing.assert_allclose(out[1], reduce_fn(table[[2]]), rtol=1e-5)


def test_sparse_embedding_on_tensors():
    layer = SparseEmbedding(input_dim=10, output_dim=4)
    sp = from_row_lists([[1, 2], [3]])
    tensors = PaddedSparse(torch.from_numpy(sp.values),
                           torch.from_numpy(sp.mask))
    out = layer(tensors)
    assert out.shape == (2, 4)
    np.testing.assert_array_equal(_np(out), _np(layer(sp)))


def _census_like_columns(fc_mod):
    age = fc_mod.numeric_column("age")
    age_buckets = fc_mod.bucketized_column(age, [25.0, 45.0, 65.0])
    work = fc_mod.categorical_column_with_vocabulary_list(
        "work_class", ["Private", "Self-emp", "Gov"]
    )
    edu = fc_mod.categorical_column_with_hash_bucket("education", 8)
    group = fc_mod.concatenated_categorical_column([age_buckets, work, edu])
    return [
        age,
        fc_mod.embedding_column(group, dimension=6, combiner="sum"),
        fc_mod.indicator_column(
            fc_mod.categorical_column_with_identity("marital", 3)
        ),
    ]


def _census_features():
    return {
        "age": np.array([23.0, 50.0], np.float32),
        "work_class": np.array([["Private"], ["Gov"]]),
        "education": np.array([["BA"], ["PhD"]]),
        "marital": np.array([[0], [2]]),
    }


def test_dense_features_end_to_end():
    df = fc.DenseFeatures(columns=tuple(_census_like_columns(fc)))
    features = df.preprocess(_census_features())
    assert "work_class" not in features and "education" not in features
    out = df(features)
    # 1 numeric + 6 embedding + 3 indicator
    assert out.shape == (2, 10)
    np.testing.assert_array_equal(_np(out[:, -3:]), [[1, 0, 0], [0, 0, 1]])
    # the forward takes the preprocessed features as tensors too
    tensors = {k: (PaddedSparse(*(None if x is None else torch.as_tensor(x)
                                  for x in v))
                   if isinstance(v, PaddedSparse) else torch.as_tensor(v))
               for k, v in features.items()}
    np.testing.assert_array_equal(_np(df(tensors)), _np(out))


def test_concatenated_column_offsets():
    c1 = fc.categorical_column_with_identity("a", num_buckets=4)
    c2 = fc.categorical_column_with_identity("b", num_buckets=6)
    concat = fc.concatenated_categorical_column([c1, c2])
    assert concat.num_buckets == 10
    sp = concat.ids({"a": np.array([[1], [3]]), "b": np.array([[0], [5]])})
    assert dense_rows(sp) == [[1, 4], [3, 9]]


def test_identity_column_out_of_range():
    col = fc.categorical_column_with_identity("x", num_buckets=4)
    sp = col.ids({"x": np.array([[1], [-1], [8]])})
    assert dense_rows(sp) == [[1], [], []]
    col_def = fc.categorical_column_with_identity(
        "x", num_buckets=4, default_value=0
    )
    sp = col_def.ids({"x": np.array([[1], [-1], [8]])})
    # -1 is the pad sentinel (absent); 8 re-routes to default
    assert dense_rows(sp) == [[1], [], [0]]


def test_analyzer_utils_env_roundtrip(monkeypatch):
    monkeypatch.setenv("_edl_analysis_min_age", "17")
    monkeypatch.setenv("_edl_analysis_max_age", "90")
    monkeypatch.setenv("_edl_analysis_vocab_work", "a,b,c")
    assert analyzer_utils.get_min("age", 0) == 17.0
    assert analyzer_utils.get_max("age", 0) == 90.0
    assert analyzer_utils.get_min("missing", 5.0) == 5.0
    assert analyzer_utils.get_vocabulary("work") == ["a", "b", "c"]
    assert analyzer_utils.get_vocabulary("missing") is None


# ------------------------------------------------ (b) against the reference
def test_padded_sparse_construction_matches_reference():
    rng = np.random.RandomState(0)
    rows = [list(rng.randint(0, 100, size=rng.randint(0, 6)))
            for _ in range(20)]
    weights = [list(rng.rand(len(r)).astype(np.float32)) for r in rows]
    for kwargs in ({}, {"max_len": 3}, {"weights": weights}):
        _same_sparse(from_row_lists(rows, **kwargs),
                     ref_pp.from_row_lists(rows, **kwargs))
    floats = [list(rng.rand(len(r))) for r in rows]
    _same_sparse(from_row_lists(floats, dtype=np.float32),
                 ref_pp.from_row_lists(floats, dtype=np.float32))
    dense = rng.randint(-1, 5, size=(8, 4))
    _same_sparse(to_padded_sparse(dense), ref_pp.to_padded_sparse(dense))
    _same_sparse(ToSparse()(dense), ref_pp.ToSparse()(dense))
    _same_sparse(ToSparse(ignore_value=0)(dense),
                 ref_pp.ToSparse(ignore_value=0)(dense))
    strings = np.array([["a", ""], ["", "b"], ["c", "d"]])
    _same_sparse(to_padded_sparse(strings), ref_pp.to_padded_sparse(strings))
    sp = from_row_lists(rows)
    assert dense_rows(sp) == ref_pp.dense_rows(ref_pp.from_row_lists(rows))
    np.testing.assert_array_equal(
        sp.row_lengths(), np.asarray(ref_pp.from_row_lists(rows).row_lengths()))


@pytest.mark.parametrize("kind", ["U", "S", "O"])
@pytest.mark.parametrize("num_bins", [1, 7, 64, 1000, 2**31 - 1])
def test_string_hashing_matches_reference_bit_for_bit(kind, num_bins):
    rng = np.random.RandomState(num_bins % 1000)
    words = ["w%d" % v for v in rng.randint(0, 10**6, size=24)] + ["", "é"]
    values = np.array(words, dtype=object if kind == "O" else None)
    if kind == "S":
        values = np.array([w.encode("utf-8") for w in words], dtype="S")
    values = values.reshape(2, 13)
    got = Hashing(num_bins)(values)
    want = ref_pp.Hashing(num_bins)(values)
    assert isinstance(got, np.ndarray) and got.dtype == np.int64
    _same_ids(got, want)


@pytest.mark.parametrize("num_bins", [1, 7, 64, 1000, 2**31 - 1])
def test_host_int_hashing_matches_reference_bit_for_bit(num_bins):
    rng = np.random.RandomState(1)
    values = np.concatenate([
        np.array([0, -1, -7, 2**31 - 1, -(2**31), 2**40]),
        rng.randint(-(2**62), 2**62, size=26, dtype=np.int64)]).reshape(4, 8)
    _same_ids(Hashing(num_bins)(values), ref_pp.Hashing(num_bins)(values))


@pytest.mark.parametrize("num_bins", [1, 7, 64, 1000, 2**31 - 1])
def test_tensor_int_hashing_matches_reference_mixer(num_bins):
    """The uint32 mixer: the reference casts its (int32, no x64) ids to
    uint32, the port masks the int64 ids to their low 32 bits; both
    start from the same word for negative ints, 0, 2**31-1 and random
    int64s (whose low 32 bits the reference's int32 cast keeps)."""
    rng = np.random.RandomState(2)
    values = np.concatenate([
        np.array([0, 1, -1, -2, 2**31 - 1, -(2**31), 123456789]),
        rng.randint(-(2**63), 2**63 - 1, size=57, dtype=np.int64)])
    values = values.reshape(8, 8)
    got = Hashing(num_bins)(torch.from_numpy(values))
    assert isinstance(got, torch.Tensor) and got.dtype == torch.int64
    want = ref_pp.Hashing(num_bins)(
        jnp.asarray(values.astype(np.int32)))  # what x64-off jnp holds
    _same_ids(got, want)
    sp = ref_pp.from_row_lists([[3, -5, 2**31 - 1], [0]])
    port_sp = PaddedSparse(torch.from_numpy(sp.values),
                           torch.from_numpy(sp.mask))
    ref_out = ref_pp.Hashing(num_bins)(
        ref_pp.PaddedSparse(jnp.asarray(sp.values), jnp.asarray(sp.mask)))
    _same_sparse(Hashing(num_bins)(port_sp), ref_out)


def test_index_lookup_matches_reference():
    rng = np.random.RandomState(3)
    vocab = ["t%d" % i for i in range(20)]
    values = np.array(["t%d" % v for v in rng.randint(0, 40, size=30)])
    values = values.reshape(5, 6)
    for oov in (1, 3):
        _same_ids(IndexLookup(vocab, oov)(values),
                  ref_pp.IndexLookup(vocab, oov)(values))
    sp = ref_pp.to_padded_sparse(values)
    _same_sparse(IndexLookup(vocab)(_port(sp)),
                 ref_pp.IndexLookup(vocab)(sp))
    assert IndexLookup(vocab, 3).vocab_size() == ref_pp.IndexLookup(
        vocab, 3).vocab_size()


def test_numeric_layers_match_reference_bit_for_bit():
    rng = np.random.RandomState(4)
    x = np.concatenate([
        rng.normal(scale=50, size=60).astype(np.float32),
        np.array([0.0, -0.0, 1.0, 2.0, 2.5, 3.5, 1e-30, -1.0],
                 np.float32)]).reshape(4, 17)
    bins = [-30.0, -1.0, 0.0, 1.0, 2.5, 10.0, 40.0]
    layers = [
        (Discretization(bins), ref_pp.Discretization(bins)),
        (LogRound(16), ref_pp.LogRound(16)),
        (LogRound(8, default_value=3, base=2),
         ref_pp.LogRound(8, default_value=3, base=2)),
        (RoundIdentity(20), ref_pp.RoundIdentity(20)),
        (ToNumber(np.int64), ref_pp.ToNumber(np.int64)),
        (ToNumber(np.float32), ref_pp.ToNumber(np.float32)),
    ]
    for port, ref in layers:
        _same_ids(port(torch.from_numpy(x)), ref(jnp.asarray(x)))
        # a numpy input becomes a tensor on the port's side
        _same_ids(port(x), ref(x))
    strings = np.array([["12.5", "", "3"], ["-7", "0.25", "1e3"]])
    for dtype, default in ((np.float32, -1), (np.int64, 0)):
        _same_ids(ToNumber(dtype, default)(strings),
                  ref_pp.ToNumber(dtype, default)(strings))
    sp = ref_pp.from_row_lists([[1.5, 7.0], [30.0]], dtype=np.float32)
    _same_sparse(Discretization(bins)(_port(sp)),
                 ref_pp.Discretization(bins)(sp))


def test_normalizer_matches_reference():
    x = np.random.RandomState(5).normal(size=(6, 9)).astype(np.float32) * 40
    got = _np(Normalizer(3.25, 7.5)(torch.from_numpy(x)))
    want = np.asarray(ref_pp.Normalizer(3.25, 7.5)(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_concatenate_with_offset_matches_reference():
    rng = np.random.RandomState(6)
    parts = [ref_pp.from_row_lists(
        [list(rng.randint(0, 9, size=rng.randint(0, 4))) for _ in range(5)],
        max_len=3, weights=[[1.0, 2.0, 3.0]] * 5) for _ in range(3)]
    _same_sparse(ConcatenateWithOffset([0, 9, 18], axis=1)(
        [_port(sp) for sp in parts]),
                 ref_pp.ConcatenateWithOffset([0, 9, 18], axis=1)(parts))
    dense = [rng.randint(0, 5, size=(4, 2)) for _ in range(2)]
    _same_ids(ConcatenateWithOffset([0, 5], axis=1)(dense),
              ref_pp.ConcatenateWithOffset([0, 5], axis=1)(dense))


@pytest.mark.parametrize("combiner", ["sum", "mean", "sqrtn"])
def test_combine_gathered_matches_reference(combiner):
    rng = np.random.RandomState(7)
    gathered = rng.normal(size=(6, 5, 4)).astype(np.float32)
    w = (rng.rand(6, 5) > 0.4).astype(np.float32) * rng.rand(6, 5).astype(
        np.float32)
    w[0] = 0.0  # an empty row divides by the floor, not by zero
    got = fc.combine_gathered(torch.from_numpy(gathered),
                              torch.from_numpy(w), combiner)
    want = ref_fc.combine_gathered(jnp.asarray(gathered), jnp.asarray(w),
                                   combiner)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("combiner", ["sum", "mean", "sqrtn"])
def test_sparse_embedding_and_its_gradient_match_reference(combiner):
    rng = np.random.RandomState(8)
    rows = [list(rng.randint(-2, 14, size=rng.randint(0, 5)))
            for _ in range(9)]  # ids past the table clip to its last row
    weights = [list(rng.rand(len(r)).astype(np.float32)) for r in rows]
    sp = ref_pp.from_row_lists(rows, max_len=4, weights=weights)
    ref = ref_pp.SparseEmbedding(input_dim=12, output_dim=4,
                                 combiner=combiner)
    params = ref.init(jax.random.PRNGKey(0), sp)
    table = np.array(params["params"]["embeddings"])
    cot = rng.normal(size=(9, 4)).astype(np.float32)

    def ref_loss(t):
        out = ref.apply({"params": {"embeddings": t}}, sp)
        return jnp.sum(out * cot), out

    (_, want), want_grad = jax.value_and_grad(ref_loss, has_aux=True)(
        jnp.asarray(table))
    port = SparseEmbedding(input_dim=12, output_dim=4, combiner=combiner)
    port.load_state_dict({"embeddings": torch.from_numpy(table)})
    got = port(_port(sp))
    (got * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(_np(port.embeddings.grad),
                               np.asarray(want_grad), rtol=RTOL, atol=ATOL)


def _column_features(rng, n=12):
    return {
        "age": rng.uniform(10, 80, size=n).astype(np.float32),
        "work_class": np.array([["Private", "Gov", "Self-emp", "None"][i]
                                for i in rng.randint(0, 4, size=n)])[:, None],
        "education": np.array(["e%d" % i for i in rng.randint(0, 30, size=n)]
                              )[:, None],
        "marital": rng.randint(-1, 5, size=(n, 1)),
        "tags": ref_pp.from_row_lists(
            [list(rng.randint(-1, 40, size=rng.randint(0, 4)))
             for _ in range(n)], max_len=3),
        "hashed": rng.randint(0, 10**6, size=(n, 2)),
    }


def _columns(fc_mod):
    age = fc_mod.numeric_column("age")
    return {
        "bucketized": fc_mod.bucketized_column(age, [25.0, 45.0, 65.0]),
        "identity": fc_mod.categorical_column_with_identity("marital", 3),
        "identity_default": fc_mod.categorical_column_with_identity(
            "marital", 3, default_value=1),
        "identity_sparse": fc_mod.categorical_column_with_identity(
            "tags", 32),
        "vocab": fc_mod.categorical_column_with_vocabulary_list(
            "work_class", ["Private", "Self-emp", "Gov"]),
        "vocab_oov": fc_mod.categorical_column_with_vocabulary_list(
            "work_class", ["Private", "Self-emp", "Gov"], num_oov_buckets=2),
        "hash": fc_mod.categorical_column_with_hash_bucket("education", 8),
        "hash_ints": fc_mod.categorical_column_with_hash_bucket("hashed", 50),
        "concat": fc_mod.concatenated_categorical_column([
            fc_mod.bucketized_column(age, [30.0]),
            fc_mod.categorical_column_with_vocabulary_list(
                "work_class", ["Private", "Gov"]),
            fc_mod.categorical_column_with_identity("tags", 32),
        ]),
    }


def _port_features(features):
    return {k: _port(v) if isinstance(v, ref_pp.PaddedSparse) else v
            for k, v in features.items()}


def test_column_ids_and_masks_match_reference_bit_for_bit():
    features = _column_features(np.random.RandomState(9))
    port_features = _port_features(features)
    port_cols, ref_cols = _columns(fc), _columns(ref_fc)
    for name in port_cols:
        got = port_cols[name].ids(port_features)
        want = ref_cols[name].ids(features)
        _same_sparse(got, want)
        assert port_cols[name].num_buckets == ref_cols[name].num_buckets
        assert port_cols[name].name == ref_cols[name].name
    for name in ("identity", "vocab", "concat"):
        _same_ids(fc.indicator_column(port_cols[name])(port_features),
                  ref_fc.indicator_column(ref_cols[name])(features))


def test_dense_features_and_gradients_match_reference():
    """DenseFeatures over numeric, embedding (all three combiners) and
    indicator columns: ``preprocess`` drops the same string keys, the
    tables carry the reference's flax names, and the outputs and the
    tables' gradients agree from the reference's initial tables."""
    rng = np.random.RandomState(10)
    features = _column_features(rng)

    def columns(fc_mod):
        cols = _columns(fc_mod)
        return (
            fc_mod.numeric_column("age"),
            fc_mod.embedding_column(cols["concat"], 6, combiner="sum"),
            fc_mod.embedding_column(cols["identity_sparse"], 4,
                                    combiner="mean"),
            fc_mod.embedding_column(cols["hash"], 3, combiner="sqrtn"),
            fc_mod.indicator_column(cols["vocab_oov"]),
        )

    ref = ref_fc.DenseFeatures(columns=columns(ref_fc))
    port = fc.DenseFeatures(columns=columns(fc))
    ref_features = ref.preprocess(features)
    port_features = port.preprocess(_port_features(features))
    assert set(ref_features) == set(port_features)
    assert "work_class" not in port_features
    for key, value in ref_features.items():
        if isinstance(value, ref_pp.PaddedSparse):
            _same_sparse(port_features[key], value)
    params = ref.init(jax.random.PRNGKey(1), ref_features)["params"]
    assert set(params) == {n for n, _ in port.named_parameters()}
    port.load_state_dict({n: torch.from_numpy(np.array(v))
                          for n, v in params.items()})
    assert port.output_dim == 1 + 6 + 4 + 3 + 5
    cot = rng.normal(size=(12, port.output_dim)).astype(np.float32)

    def ref_loss(p):
        out = ref.apply({"params": p}, ref_features)
        return jnp.sum(out * cot), out

    (_, want), grads = jax.value_and_grad(ref_loss, has_aux=True)(params)
    got = port(port_features)
    (got * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    for name, param in port.named_parameters():
        np.testing.assert_allclose(_np(param.grad), np.asarray(grads[name]),
                                   rtol=RTOL, atol=ATOL, err_msg=name)


def test_analyzer_utils_match_reference(monkeypatch):
    from elasticdl_tpu.preprocessing import analyzer_utils as ref_au

    monkeypatch.setenv("_edl_analysis_mean_x", "2.5")
    monkeypatch.setenv("_edl_analysis_stddev_x", "0.5")
    monkeypatch.setenv("_edl_analysis_distinct_count_x", "11")
    monkeypatch.setenv("_edl_analysis_vocab_x", "a,,b")
    for fn in ("get_mean", "get_stddev", "get_distinct_count"):
        assert getattr(analyzer_utils, fn)("x", 1) == getattr(ref_au, fn)(
            "x", 1)
        assert getattr(analyzer_utils, fn)("y", 1) == 1
    assert analyzer_utils.get_vocabulary("x") == ref_au.get_vocabulary("x")
    assert os.environ["_edl_analysis_mean_x"] == "2.5"

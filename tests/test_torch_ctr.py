"""The port's CTR zoo (Wide&Deep, DCN, xDeepFM) against the reference.

Each variant of ``elasticdl_tpu_torch.models.ctr`` takes the flax
module's weights through ``params_from_flax`` (every leaf, by the
reference's scope names) and gives its logits, loss and gradients;
CrossNet and CIN are held alone too. ``custom_model`` reads the
reference's environment knobs, and the three zoo modules resolve
through the port's registry. tests/test_torch_ctr_learns.py trains
them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from elasticdl_tpu.models import ctr as jax_ctr
from elasticdl_tpu_torch.models import ctr
from elasticdl_tpu_torch.models.layers import params_to_flax
from elasticdl_tpu_torch.models.registry import get_model_spec

# the suite runs in several worker processes at once: one intra-op
# thread per process keeps these small-shape tests from oversubscribing
# the host's cores under other files' timing-sensitive tests
torch.set_num_threads(1)

VOCAB = 500
FIELDS = 10
# fp32 on both sides, the same products in another summation order:
# measured 7.5e-9 on logits of ~0.1 and 1.5e-8 on gradients of ~0.06
ATOL = 1e-6
RTOL = 1e-5
ZOO = ("wide_deep", "dcn", "xdeepfm")


def _batch(seed=0, batch=16):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, VOCAB, size=(batch, FIELDS)).astype(np.int64)
    labels = rng.randint(0, 2, size=batch).astype(np.float32)
    return ids, labels


def _flat(tree):
    return {name: np.array(value) for name, value in
            traverse_util.flatten_dict(tree, sep="/").items()}


def _carried(variant, ids):
    """(flax module, its params, the port model holding them)."""
    reference = jax_ctr._VARIANTS[variant](vocab=VOCAB, embed_dim=8)
    params = reference.init(jax.random.PRNGKey(1),
                            {"ids": jnp.asarray(ids)})["params"]
    model = ctr.VARIANTS[variant](vocab=VOCAB, embed_dim=8)
    with torch.no_grad():
        model({"ids": torch.from_numpy(ids)})  # sizes the lazy layers
    state = model.params_from_flax(_flat(params))
    assert set(state) == set(dict(model.named_parameters()))
    model.load_state_dict(state, strict=True)
    return reference, params, model


@pytest.mark.parametrize("variant", ZOO)
def test_forward_loss_and_grads_match_the_reference(variant):
    ids, labels = _batch()
    reference, params, model = _carried(variant, ids)

    def jax_loss(p):
        logits = reference.apply({"params": p}, {"ids": jnp.asarray(ids)})
        return jax_ctr.loss(jnp.asarray(labels), logits).mean(), logits

    (expected_loss, expected), jax_grads = jax.value_and_grad(
        jax_loss, has_aux=True)(params)
    logits = model({"ids": torch.from_numpy(ids)})
    loss = ctr.loss(torch.from_numpy(labels), logits).mean()
    loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(expected),
                               atol=ATOL, rtol=RTOL)
    assert abs(loss.item() - float(expected_loss)) <= ATOL
    got = params_to_flax({n: p.grad for n, p in model.named_parameters()})
    reference_grads = _flat(jax_grads)
    assert set(got) == set(reference_grads)
    for name, value in reference_grads.items():
        np.testing.assert_allclose(got[name], value, atol=ATOL, rtol=RTOL,
                                   err_msg=name)
    # the tables' gradients are dense, as jnp.take's: every row is
    # there, the rows no id touched are zero
    table = dict(model.named_parameters())[
        "FieldEmbeddings_0.embeddings" if variant == "dcn"
        else "deep.embeddings"]
    assert table.grad.layout == torch.strided
    untouched = np.setdiff1d(np.arange(VOCAB), ids)
    assert not table.grad[torch.from_numpy(untouched)].any()


def test_crossnet_matches_the_reference():
    rng = np.random.RandomState(3)
    x0 = rng.normal(size=(6, 24)).astype(np.float32)
    reference = jax_ctr.CrossNet(num_layers=2)
    params = reference.init(jax.random.PRNGKey(2), jnp.asarray(x0))["params"]
    module = ctr.CrossNet(num_layers=2)
    module(torch.from_numpy(x0))
    module.load_state_dict({k: torch.from_numpy(v)
                            for k, v in _flat(params).items()})
    expected = reference.apply({"params": params}, jnp.asarray(x0))
    got = module(torch.from_numpy(x0))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(expected),
                               atol=ATOL, rtol=RTOL)


def test_cin_matches_the_reference():
    rng = np.random.RandomState(4)
    x0 = rng.normal(size=(5, 7, 8)).astype(np.float32)
    reference = jax_ctr.CIN(layer_sizes=(16, 16))
    params = reference.init(jax.random.PRNGKey(3), jnp.asarray(x0))["params"]
    module = ctr.CIN(layer_sizes=(16, 16))
    module(torch.from_numpy(x0))
    assert module.cin0.shape == (7 * 7, 16) and module.cin1.shape == (16 * 7,
                                                                        16)
    module.load_state_dict({k: torch.from_numpy(v)
                            for k, v in _flat(params).items()})
    expected = reference.apply({"params": params}, jnp.asarray(x0))
    got = module(torch.from_numpy(x0))
    assert got.shape == (5, 32)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(expected),
                               atol=ATOL, rtol=RTOL)


def test_init_draws_flax_initializers():
    """reset_parameters after the sizing batch: truncated normal 0.01
    tables, 0.02 cross vectors and CIN projections (cut at two
    stddevs), lecun-normal Dense kernels, zero biases."""
    ids, _ = _batch(batch=4)
    model = ctr.VARIANTS["xdeepfm"](vocab=VOCAB, embed_dim=8)
    with torch.no_grad():
        model({"ids": torch.from_numpy(ids)})
    model.reset_parameters(torch.Generator().manual_seed(0))
    params = dict(model.named_parameters())
    for name, stddev in (("deep.embeddings", 0.01), ("CIN_0.cin0", 0.02)):
        value = params[name]
        assert value.abs().max() <= 2 * stddev, name
        assert 0.8 * stddev < float(value.std()) < stddev, name
    assert not params["DNN_0.Dense_0.bias"].any()
    fan_in = FIELDS * 8
    assert params["DNN_0.Dense_0.weight"].abs().max() <= 2 * (
        1 / fan_in) ** 0.5 / 0.87962566103423978 + 1e-6


def test_custom_model_reads_the_reference_knobs(monkeypatch):
    model = ctr.custom_model()
    assert isinstance(model, ctr.DCN)
    assert model.FieldEmbeddings_0.embeddings.shape == (ctr.VOCAB,
                                                        ctr.EMBED_DIM)
    assert (ctr.VOCAB, ctr.EMBED_DIM, ctr.NUM_FIELDS) == (1_000_000, 8, 39)
    model = ctr.custom_model("wide_deep", vocab=100, embed_dim=4)
    assert model.deep.embeddings.shape == (100, 4)
    monkeypatch.setenv("EDL_CTR_VARIANT", "xdeepfm")
    monkeypatch.setenv("EDL_CTR_VOCAB", "64")
    monkeypatch.setenv("EDL_CTR_EMBED_DIM", "2")
    model = ctr.custom_model("wide_deep", vocab=100, embed_dim=4)
    assert isinstance(model, ctr.XDeepFM)
    assert model.deep.embeddings.shape == (64, 2)
    assert model.linear.embeddings.shape == (64, 1)


@pytest.mark.parametrize("variant", ZOO)
def test_zoo_modules_resolve_through_the_registry(variant):
    spec = get_model_spec("elasticdl_tpu_torch.models." + variant)
    model = spec.custom_model()
    assert isinstance(model, ctr.VARIANTS[variant])
    assert spec.loss is ctr.loss and spec.dataset_fn is ctr.dataset_fn
    assert spec.params_from_flax is ctr.params_from_flax
    assert spec.sparse_embedding_specs is None
    assert set(spec.eval_metrics_fn()) == {"auc", "accuracy"}


def test_the_zoo_contract_matches_the_reference():
    """loss and metrics on the same logits, the optimizer's first
    update (Adam, lr 0.01) and dataset_fn's parse of one record."""
    from elasticdl_tpu.data.example import encode_example
    from elasticdl_tpu_torch.data.pipeline import Dataset

    rng = np.random.RandomState(5)
    labels = rng.randint(0, 2, size=32).astype(np.float32)
    logits = rng.normal(size=32).astype(np.float32)
    np.testing.assert_allclose(
        ctr.loss(torch.from_numpy(labels), torch.from_numpy(logits)).numpy(),
        np.asarray(jax_ctr.loss(jnp.asarray(labels), jnp.asarray(logits))),
        rtol=1e-6, atol=1e-7)
    for name, metric in ctr.eval_metrics_fn().items():
        reference = jax_ctr.eval_metrics_fn()[name]
        metric.update_state(labels, logits)
        reference.update_state(labels, logits)
        assert abs(metric.result() - reference.result()) <= 1e-6, name
    params = {"w": rng.normal(size=(6,)).astype(np.float32)}
    grads = {"w": rng.normal(size=(6,)).astype(np.float32)}
    jtx, ptx = jax_ctr.optimizer(), ctr.optimizer()
    expected, _ = jtx.update({"w": jnp.asarray(grads["w"])},
                             jtx.init({"w": jnp.asarray(params["w"])}),
                             {"w": jnp.asarray(params["w"])})
    pparams = {"w": torch.from_numpy(params["w"])}
    got, _ = ptx.update({"w": torch.from_numpy(grads["w"])},
                        ptx.init(pparams), pparams)
    np.testing.assert_allclose(got["w"].numpy(), np.asarray(expected["w"]),
                               rtol=1e-6)
    ids = np.arange(FIELDS, dtype=np.int64)
    record = encode_example({"ids": ids, "label": np.int64(1)})
    ((features, label),) = list(ctr.dataset_fn(Dataset.from_list([record])))
    np.testing.assert_array_equal(features["ids"], ids)
    assert features["ids"].dtype == np.int64
    assert label.dtype == np.float32 and label.shape == () and label == 1

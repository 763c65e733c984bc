"""Port TransformerLM against the JAX TransformerLM on carried-over weights.

A small flax TransformerLM (2 layers, d=128, 2 heads of 64, vocab 512,
S=128) is initialised by flax; its params go through
``params_from_flax`` into the port, and the logits are compared in fp32
and under a bf16 compute dtype. The weight mapping round-trips through
``params_to_flax`` and the export bundle both ways.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticdl_tpu.models.transformer import TransformerLM as JaxLM
from elasticdl_tpu.models.transformer import rotary_embedding as jax_rope
from elasticdl_tpu.train import export as jax_export
from elasticdl_tpu.train.train_state import cast_floating
from elasticdl_tpu_torch.models import transformer as port
from elasticdl_tpu_torch.train import export as port_export

WIDTHS = dict(vocab_size=512, num_layers=2, num_heads=2, embed_dim=128)

# the suite runs in several worker processes at once: one intra-op
# thread per process keeps these small-shape tests from oversubscribing
# the host's cores under other files' timing-sensitive tests
torch.set_num_threads(1)

# fp32: same math, other summation order in the matmuls (K <= 512) and
# other libm for exp/tanh/pow; measured max 4.3e-6 on logits of
# magnitude ~4.5. 5e-5 leaves 10x margin and still catches any layout
# or epsilon slip (a LayerNorm eps of 1e-5 instead of 1e-6 alone moves
# logits by ~1e-4).
FP32_ATOL = 5e-5
# bf16: both frameworks round every activation to bf16 (8 significant
# bits), at slightly different places; one bf16 ulp at |logit| in [4, 8)
# is 2^-5 = 0.031. Allow 3 ulps at the max and a mean well under one.
BF16_ATOL = 0.1
BF16_MEAN_ATOL = 0.01


@pytest.fixture(scope="module")
def jax_lm():
    model = JaxLM(**WIDTHS)
    rng = np.random.RandomState(0)
    tokens = rng.randint(0, WIDTHS["vocab_size"], size=(2, 128)).astype(
        np.int32
    )
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(tokens))["params"]
    return model, params, tokens


def _port_model(params):
    flat = jax_export._flatten(jax.device_get(params))
    model = port.TransformerLM(**WIDTHS)
    model.load_state_dict(port.params_from_flax(flat), strict=True)
    return model.eval()


def test_logits_match_jax_fp32(jax_lm):
    model, params, tokens = jax_lm
    expected = np.asarray(model.apply({"params": params}, jnp.asarray(tokens)))
    with torch.inference_mode():
        got = _port_model(params)(torch.from_numpy(tokens)).numpy()
    assert got.shape == expected.shape == (2, 128, 512)
    np.testing.assert_allclose(got, expected, atol=FP32_ATOL, rtol=1e-5)


def test_logits_match_jax_bf16_compute(jax_lm):
    model, params, tokens = jax_lm
    expected = np.asarray(model.apply(
        {"params": cast_floating(params, jnp.bfloat16)}, jnp.asarray(tokens)
    )).astype(np.float32)
    port_model = _port_model(params).to(torch.bfloat16)
    with torch.inference_mode():
        got = port_model(torch.from_numpy(tokens))
    assert got.dtype == torch.bfloat16
    diff = np.abs(got.float().numpy() - expected)
    assert diff.max() <= BF16_ATOL, diff.max()
    assert diff.mean() <= BF16_MEAN_ATOL, diff.mean()


def test_pallas_name_runs_the_flash_path(jax_lm, monkeypatch):
    """``attention_impl="pallas"``, the reference's name for its kernel
    path, runs the port's flash path: the same logits as ``"flash"`` bit
    for bit, and the reference's own "pallas" model (its Pallas kernel
    in interpret mode, as the reference's tests run it on the CPU)
    within FP32_ATOL."""
    from elasticdl_tpu.models import transformer as jax_transformer

    monkeypatch.setattr(
        jax_transformer, "dot_product_attention",
        functools.partial(jax_transformer.dot_product_attention,
                          interpret=True))
    _, params, tokens = jax_lm
    expected = np.asarray(JaxLM(**WIDTHS, attention_impl="pallas").apply(
        {"params": params}, jnp.asarray(tokens)))
    flat = jax_export._flatten(jax.device_get(params))
    logits = {}
    for impl in ("pallas", "flash"):
        model = port.TransformerLM(**WIDTHS, attention_impl=impl)
        model.load_state_dict(port.params_from_flax(flat), strict=True)
        with torch.inference_mode():
            logits[impl] = model.eval()(torch.from_numpy(tokens)).numpy()
    np.testing.assert_array_equal(logits["pallas"], logits["flash"])
    np.testing.assert_allclose(logits["pallas"], expected, atol=FP32_ATOL,
                               rtol=1e-5)


@pytest.mark.parametrize("impl", ["ring", "ulysses", "triton"])
def test_unknown_attention_impl_raises(impl):
    """A name neither package knows is refused: it raises, never falls
    back to another path. The reference's sequence-parallel names are
    known (ops/ring_attention.py): without a mesh, sp is 1, and each is
    the default attention, bit for bit (their runs over sp are
    tests/test_torch_ring_attention.py's)."""
    model = port.TransformerLM(vocab_size=64, num_layers=1, num_heads=2,
                               embed_dim=64, attention_impl=impl)
    tokens = torch.zeros((1, 8), dtype=torch.int64)
    if impl == "triton":
        with pytest.raises(ValueError, match="attention impl"):
            model(tokens)
        return
    default = port.TransformerLM(vocab_size=64, num_layers=1, num_heads=2,
                                 embed_dim=64)
    default.load_state_dict(model.state_dict())
    with torch.no_grad():
        torch.testing.assert_close(model(tokens), default(tokens), rtol=0,
                                   atol=0)


@pytest.mark.parametrize("seq_axis", [1, 2])
def test_rotary_matches_jax(seq_axis):
    rng = np.random.RandomState(1)
    shape = (2, 16, 3, 64) if seq_axis == 1 else (2, 3, 16, 64)
    x = rng.normal(size=shape).astype(np.float32)
    expected = np.asarray(jax_rope(jnp.asarray(x), seq_axis=seq_axis))
    got = port.rotary_embedding(torch.from_numpy(x), seq_axis=seq_axis)
    np.testing.assert_allclose(got.numpy(), expected, atol=1e-5, rtol=1e-5)


def test_weight_names_round_trip_both_ways(jax_lm, tmp_path):
    _, params, _ = jax_lm
    flat = jax_export._flatten(jax.device_get(params))
    back = port.params_to_flax(port.params_from_flax(flat), num_heads=2)
    assert set(back) == set(flat)
    for name in flat:
        assert back[name].shape == flat[name].shape, name
        np.testing.assert_array_equal(back[name], flat[name])
    # a bundle the port writes loads in the JAX package as the same tree
    port_export.export_state_dict(back, str(tmp_path), step=7)
    jparams, jstate, step = jax_export.load_exported(str(tmp_path))
    assert step == 7 and jstate == {}
    jflat = jax_export._flatten(jparams)
    assert set(jflat) == set(flat)
    for name in flat:
        np.testing.assert_array_equal(jflat[name], flat[name])


def test_zoo_widths_match_the_jax_zoo():
    """custom_model() builds the zoo TransformerLM: vocab 32000, 12
    layers, 12 heads, d 768 -- 134,125,056 parameters, as the flax
    module counts them."""
    from elasticdl_tpu.models import transformer as jax_zoo

    abstract = jax.eval_shape(
        lambda: jax_zoo.custom_model().init(
            jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32)
        )
    )
    jax_count = sum(x.size for x in jax.tree_util.tree_leaves(abstract))
    with torch.device("meta"):
        model = port.custom_model()
    assert sum(p.numel() for p in model.parameters()) == jax_count
    assert jax_count == 134_125_056


def test_registry_binds_model_params_and_model_def():
    """--model_params binds widths onto custom_model; --model_def picks
    a module (and factory) inside a zoo directory, as in the JAX
    registry."""
    import os

    from elasticdl_tpu_torch.models import registry

    spec = registry.get_model_spec(
        "elasticdl_tpu_torch.models.transformer",
        model_params="num_layers=1;num_heads=2;embed_dim=128;"
        "vocab_size=64;attention_impl=xla",
    )
    model = spec.custom_model()
    assert len(model.blocks) == 1 and model.lm_head.out_features == 64
    assert model.blocks[0].attn.attention_impl == "xla"
    assert spec.params_from_flax is port.params_from_flax
    zoo_dir = os.path.dirname(port.__file__)
    by_def = registry.get_model_spec(
        zoo_dir, model_def="transformer.custom_model",
        model_params="num_layers=1;embed_dim=64;num_heads=1;vocab_size=32",
    )
    assert len(by_def.custom_model().blocks) == 1
    with pytest.raises(ValueError):
        registry.get_model_spec(zoo_dir, model_def="missing")


# bench.py's transformer configuration has heads of 256 (d 2048, 8
# heads); this one keeps the head width at 2 heads of 256 and cuts
# everything else down
D256_WIDTHS = dict(vocab_size=512, num_layers=2, num_heads=2, embed_dim=512)
# fp32 gradients: the same math in another summation order (the flash
# path's plain version against the reference's xla attention); measured
# worst leaf 2.6e-6 relative L2
GRAD_LEAF_RTOL = 1e-4


def test_head_dim_256_logits_and_grads_match_jax():
    """A TransformerLM with heads of 256 through the port's default
    attention (the flash path; its plain versions on the CPU) against
    the reference from the same weights: logits, loss and every
    parameter's gradient (relative L2 per leaf)."""
    from elasticdl_tpu.models import transformer as jax_zoo

    model = JaxLM(**D256_WIDTHS)
    tokens = np.random.RandomState(2).randint(
        0, D256_WIDTHS["vocab_size"], size=(2, 128)).astype(np.int32)
    params = model.init(jax.random.PRNGKey(4), jnp.asarray(tokens))["params"]

    def jax_loss(p):
        logits = model.apply({"params": p}, jnp.asarray(tokens))
        return jax_zoo.loss(jnp.asarray(tokens), logits).mean(), logits

    (expected_loss, expected), jax_grads = jax.value_and_grad(
        jax_loss, has_aux=True)(params)
    port_lm = port.TransformerLM(**D256_WIDTHS)
    port_lm.load_state_dict(port.params_from_flax(
        jax_export._flatten(jax.device_get(params))), strict=True)
    assert port_lm.blocks[0].attn.attention_impl == "auto"
    logits = port_lm(torch.from_numpy(tokens))
    loss = port.loss(torch.from_numpy(tokens), logits).mean()
    loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(expected),
                               atol=FP32_ATOL, rtol=1e-5)
    assert abs(float(loss) - float(expected_loss)) <= 1e-5
    got = port.params_to_flax(
        {n: p.grad for n, p in port_lm.named_parameters()}, num_heads=2)
    reference = jax_export._flatten(jax.device_get(jax_grads))
    assert set(got) == set(reference)
    for name, value in reference.items():
        err = np.linalg.norm(got[name] - value) / np.linalg.norm(value)
        assert err <= GRAD_LEAF_RTOL, (name, err)

"""The port's BatchNorm (elasticdl_tpu_torch/ops/batch_norm.py) against
the reference's ``TpuBatchNorm`` (elasticdl_tpu/ops/batch_norm.py): the
six cases of tests/test_batch_norm.py, on the same numpy inputs, with
the parameters and statistics carried across. The reference takes
channels-last tensors, the port's layer NCHW ones (its models' stream):
the tests permute on the way in and out.

Tolerances (fp32): the same one-pass formulas, so outputs and
statistics agree to 2e-5 (the reference's own tolerances against flax);
gradients to 1e-4, a sum over 200 elements a channel in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticdl_tpu.ops.batch_norm import TpuBatchNorm as JaxBatchNorm
from elasticdl_tpu_torch.ops.batch_norm import BatchNorm, TpuBatchNorm

torch.set_num_threads(1)

FEATURES = 6


def _jax_bn(training, **kw):
    return JaxBatchNorm(use_running_average=not training, momentum=0.9,
                        epsilon=1e-5, **kw)


def _port_bn(training, variables=None, **kw):
    bn = TpuBatchNorm(FEATURES, momentum=0.9, epsilon=1e-5, **kw)
    if variables is not None:
        with torch.no_grad():
            for name in ("scale", "bias"):
                getattr(bn, name).copy_(torch.from_numpy(
                    np.asarray(variables["params"][name])))
            for name in ("mean", "var"):
                getattr(bn, name).copy_(torch.from_numpy(
                    np.asarray(variables["batch_stats"][name])))
    return bn.train(training)


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


@pytest.fixture
def x():
    rng = np.random.default_rng(0)
    return rng.normal(loc=0.7, scale=2.0, size=(8, 5, 5, FEATURES)).astype(
        np.float32)


@pytest.fixture
def variables(x):
    """Non-trivial affine params and running statistics."""
    return {
        "params": {"scale": np.linspace(0.5, 1.5, FEATURES, dtype=np.float32),
                   "bias": np.linspace(-0.2, 0.2, FEATURES,
                                       dtype=np.float32)},
        "batch_stats": {"mean": np.linspace(-1.0, 1.0, FEATURES,
                                            dtype=np.float32),
                        "var": np.linspace(0.5, 2.0, FEATURES,
                                           dtype=np.float32)},
    }


def test_train_forward_and_stats_match_reference(x, variables):
    ref = _jax_bn(True)
    yref, mref = ref.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
    bn = _port_bn(True, variables)
    with torch.no_grad():
        y = _nhwc(bn(_nchw(x)))
    np.testing.assert_allclose(y, yref, rtol=2e-5, atol=2e-5)
    for key in ("mean", "var"):
        np.testing.assert_allclose(getattr(bn, key).numpy(),
                                   mref["batch_stats"][key],
                                   rtol=2e-5, atol=2e-6)


def test_eval_forward_matches_reference(x, variables):
    yref = _jax_bn(False).apply(variables, jnp.asarray(x))
    bn = _port_bn(False, variables)
    with torch.no_grad():
        y = _nhwc(bn(_nchw(x)))
    np.testing.assert_allclose(y, yref, rtol=2e-5, atol=2e-5)
    # eval mode reads the running averages and leaves them alone
    np.testing.assert_array_equal(bn.mean.numpy(),
                                  variables["batch_stats"]["mean"])


def test_gradients_match_reference(x, variables):
    ref = _jax_bn(True)

    def loss(params, x):
        y, _ = ref.apply({"params": params,
                          "batch_stats": variables["batch_stats"]},
                         x, mutable=["batch_stats"])
        return jnp.sum(jnp.tanh(y))

    gref_p, gref_x = jax.grad(loss, argnums=(0, 1))(
        variables["params"], jnp.asarray(x))
    bn = _port_bn(True, variables)
    xt = torch.from_numpy(x).requires_grad_()
    torch.sum(torch.tanh(bn(xt.permute(0, 3, 1, 2)))).backward()
    np.testing.assert_allclose(xt.grad.numpy(), gref_x, rtol=1e-4, atol=1e-4)
    for name in ("scale", "bias"):
        np.testing.assert_allclose(getattr(bn, name).grad.numpy(),
                                   gref_p[name], rtol=1e-4, atol=1e-4)


def test_scale_init_passthrough(x):
    bn = _port_bn(True, scale_init=0.0)
    np.testing.assert_array_equal(bn.scale.detach().numpy(),
                                  np.zeros(FEATURES))
    with torch.no_grad():
        y = _nhwc(bn(_nchw(x)))
    # zero scale -> output is just the bias (zeros)
    np.testing.assert_allclose(y, np.zeros_like(x), atol=1e-6)


def test_stats_samples_subsampling(x):
    """stats_samples=k: statistics come from the first k rows only,
    every row is normalized, the running stats track the k-row stats,
    and the port agrees with the reference's subsampled layer."""
    bn = _port_bn(True, stats_samples=4)
    with torch.no_grad():
        y = _nhwc(bn(_nchw(x)))
    xs = np.asarray(x[:4], np.float64)
    mean = xs.mean(axis=(0, 1, 2))
    var = (xs ** 2).mean(axis=(0, 1, 2)) - mean ** 2
    expect = (np.asarray(x) - mean) / np.sqrt(var + 1e-5)
    np.testing.assert_allclose(y, expect, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(bn.mean.numpy(), 0.1 * mean, rtol=2e-5,
                               atol=1e-6)
    ref = _jax_bn(True, stats_samples=4)
    variables = ref.init(jax.random.PRNGKey(0), jnp.asarray(x))
    yref, mref = ref.apply(variables, jnp.asarray(x),
                           mutable=["batch_stats"])
    np.testing.assert_allclose(y, yref, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(bn.var.numpy(), mref["batch_stats"]["var"],
                               rtol=2e-5, atol=2e-6)


def test_bf16_stream_keeps_dtype(x):
    bn = _port_bn(True)
    with torch.no_grad():
        y = bn(_nchw(x).bfloat16())
    assert y.dtype == torch.bfloat16
    # params/stats stay f32
    assert bn.scale.dtype == torch.float32
    assert bn.mean.dtype == torch.float32 and bn.var.dtype == torch.float32
    # dtype=float32 (flax's stock nn.BatchNorm(dtype=float32)) outputs f32
    stock = BatchNorm(FEATURES, dtype=torch.float32)
    with torch.no_grad():
        assert stock(_nchw(x).bfloat16()).dtype == torch.float32


def test_running_update_is_flax_momentum_not_torch_batchnorm(x):
    """ra = 0.9 ra + 0.1 batch, with the BIASED batch variance:
    torch's BatchNorm2d would weight the batch by 0.9 (momentum=0.1 is
    its complement) and use the unbiased variance."""
    bn = _port_bn(True)
    with torch.no_grad():
        bn(_nchw(x))
    xs = np.asarray(x, np.float64).reshape(-1, FEATURES)
    np.testing.assert_allclose(bn.var.numpy(),
                               0.9 * 1.0 + 0.1 * xs.var(axis=0),
                               rtol=1e-5)

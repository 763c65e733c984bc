"""The vision zoo on the port (models/{resnet,mobilenet,cifar10,mnist}.py)
against the reference's flax models, with the parameters and BatchNorm
statistics carried from flax (``params_from_flax``), on the same numpy
inputs (tests/test_torch_vision_state.py takes ``model_state`` through
the step, the checkpoints, the export and serving).

Tolerances, on the CPU: in fp32 the same convolutions summed in another
order (XLA's against oneDNN's), so outputs and the updated batch
statistics agree to 1e-4 relative to the largest entry, and parameters
after a step, which move by lr * grad, to 1e-5 absolute. Training mode
is compared in float64, statistics too (``float64_statistics`` says
why): the running statistics to 1e-8; outputs and gradients to 1e-5
(of the largest entry, of the largest gradient entry of the model),
the fp32 head's rounding (``Dense(dtype=float32)`` on both sides) being
what is left of the difference (measured: under 1e-6). cifar10's BatchNorm is flax's stock one against the
port's one-pass layer with ``dtype=float32``: flax's fast variance is
the same ``E[x^2] - E[x]^2``, and its normalize ``(x - mean) * mul +
bias`` against the port's ``x * mul + add`` differs by a rounding, well
inside 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticdl_tpu.models import cifar10 as jax_cifar10
from elasticdl_tpu.models import mnist as jax_mnist
from elasticdl_tpu.models import mobilenet as jax_mobilenet
from elasticdl_tpu.models import resnet as jax_resnet
from elasticdl_tpu.ops import batch_norm as jax_batch_norm
from elasticdl_tpu.train import export as jax_export
from elasticdl_tpu_torch.models import cifar10, mnist, mobilenet, resnet
from elasticdl_tpu_torch.ops.batch_norm import BatchNorm
from elasticdl_tpu_torch.train import optimizers as port_opt
from elasticdl_tpu_torch.train import step_fns
from elasticdl_tpu_torch.train import train_state

torch.set_num_threads(1)

OUT_RTOL = 1e-4
PARAM_ATOL = 1e-5
F64_RTOL = 1e-5
F64_STATS_RTOL = 1e-8


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _images(shape, seed=0):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def _labels(n, classes, seed=1):
    return np.random.RandomState(seed).randint(0, classes, n).astype(
        np.int32)


def _init(jmodel, x, seed=0):
    """The flax model's variables with every BatchNorm's scale, bias and
    running statistics drawn at random (a zero-init scale would zero
    the gradient of its branch, and fresh statistics test nothing)."""
    variables = jax.device_get(jmodel.init(
        jax.random.PRNGKey(0), jnp.asarray(x), training=False))
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        name = str(path[-1].key)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        if name in ("bias", "mean"):
            return rng.uniform(-0.3, 0.3, leaf.shape).astype(np.float32)
        return np.asarray(leaf)

    return jax.tree_util.tree_map_with_path(draw, variables)


def _flat(variables):
    """The export bundle's flat names of flax variables."""
    return jax_export._flatten({
        "params": variables["params"],
        "model_state": {k: v for k, v in variables.items()
                        if k != "params"},
    })


def _port(pmodel, variables):
    pmodel.load_state_dict(pmodel.params_from_flax(_flat(variables)),
                           strict=True)
    return pmodel


def _close(got, expected, rtol, what=""):
    got, expected = np.asarray(got), np.asarray(expected)
    assert got.shape == expected.shape, (what, got.shape, expected.shape)
    scale = max(float(np.abs(expected).max()), 1e-6)
    err = float(np.abs(got - expected).max())
    assert err <= rtol * scale, (what, err, scale)


def _jax_train_forward(jmodel, variables, x, labels):
    """Outputs, new batch_stats and param gradients of the summed CE in
    training mode."""

    def loss(params):
        out, updates = jmodel.apply(
            {**variables, "params": params}, jnp.asarray(x), training=True,
            mutable=["batch_stats"])
        ce = jax_resnet.loss(jnp.asarray(labels), out)
        return jnp.sum(ce), (out, updates["batch_stats"])

    (_, (out, stats)), grads = jax.jit(
        jax.value_and_grad(loss, has_aux=True))(variables["params"])
    return np.asarray(out), jax.device_get(stats), jax.device_get(grads)


def _port_train_forward(pmodel, x, labels):
    state = train_state.create_train_state(
        pmodel, port_opt.create_optimizer("SGD"))
    params = {n: p.detach().clone().requires_grad_()
              for n, p in state.params.items()}
    model_state = step_fns._fresh_model_state(state.model_state)
    pmodel.train()
    out = step_fns.apply_model(pmodel, params, model_state,
                               torch.from_numpy(x))
    torch.sum(resnet.loss(torch.from_numpy(labels), out)).backward()
    grads = {n: p.grad for n, p in params.items()}
    return (out.detach().numpy(),
            train_state.flat_model_state(model_state),
            pmodel.flax_params(grads), state)


class _WideJnp:
    """``jax.numpy`` with ``float32`` meaning float64, for the
    reference's BatchNorm module alone."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


@pytest.fixture
def float64_statistics(monkeypatch):
    """Both BatchNorms take their statistics in float64 for the
    training-mode comparison: with float32 statistics the two programs'
    forwards differ by ~1e-6, and a ReLU whose input lies that close to
    0 takes another branch in one than in the other; one such element
    moves its channel's gradients by percents (a few in every ResNet-50
    pass at these sizes). In float64 the comparison holds the algorithm
    itself to F64_RTOL."""
    monkeypatch.setattr(jax_batch_norm, "jnp", _WideJnp())
    monkeypatch.setattr(BatchNorm, "stats_dtype", torch.float64)


def _assert_train_parity(jmodel, pmodel, x, classes):
    """Training mode in float64 (``float64_statistics``): outputs,
    updated batch_stats and gradients, each leaf's error against the
    largest gradient entry of the model (a BatchNorm bias followed by
    another BatchNorm has a gradient that is 0 but for rounding). Then
    eval mode in float32 on the carried running averages."""
    labels = _labels(x.shape[0], classes)
    variables = _init(jmodel, x)
    pmodel = _port(pmodel, variables)
    with jax.enable_x64(True):
        wide = jax.tree_util.tree_map(
            lambda v: np.asarray(v, np.float64), variables)
        out, stats, grads = _jax_train_forward(
            jmodel, wide, x.astype(np.float64), labels)
    pout, pstats, pgrads, state = _port_train_forward(
        pmodel.double(), x.astype(np.float64), labels)
    _close(pout, out, F64_RTOL, "train outputs")
    expected_stats = jax_export._flatten({"batch_stats": stats})
    assert set(pstats) == set(expected_stats)
    for name, value in expected_stats.items():
        _close(pstats[name].numpy(), value, F64_STATS_RTOL, name)
    expected_grads = jax_export._flatten(grads)
    assert set(pgrads) == set(expected_grads)
    scale = max(float(np.abs(g).max()) for g in expected_grads.values())
    for name, value in expected_grads.items():
        err = float(np.abs(pgrads[name] - value).max())
        assert err <= F64_RTOL * scale, (name, err, scale)
    # the forward wrote into the step's copies, not the state
    for name, value in jax_export._flatten(
            {"batch_stats": variables["batch_stats"]}).items():
        np.testing.assert_array_equal(
            train_state.flat_model_state(state.model_state)[name].numpy(),
            value)
    # eval mode, float32: the running averages
    pmodel.float()
    eval_out = jmodel.apply(variables, jnp.asarray(x), training=False)
    pmodel.eval()
    with torch.no_grad():
        _close(pmodel(torch.from_numpy(x)).numpy(), eval_out, OUT_RTOL,
               "eval outputs")


# ---------------------------------------------------------------------------
# models against the reference
# ---------------------------------------------------------------------------

STEMS = [dict(), dict(stem="space_to_depth"), dict(small_inputs=True)]


@pytest.mark.parametrize("stem", STEMS, ids=["conv7", "space_to_depth",
                                             "small_inputs"])
@pytest.mark.parametrize("depth", ["resnet18", "resnet50"])
def test_resnet_matches_reference(depth, stem, float64_statistics):
    """Outputs, gradients and updated batch_stats in training mode, and
    outputs in eval mode, at 32x32 and 8 filters."""
    x = _images((4, 32, 32, 3))
    kw = dict(num_classes=5, num_filters=8, **stem)
    _assert_train_parity(getattr(jax_resnet, depth)(**kw),
                         getattr(resnet, depth)(**kw), x, 5)


@pytest.mark.parametrize("size", [16, 17], ids=["even", "odd"])
def test_mobilenet_matches_reference(size, float64_statistics):
    """Even and odd spatial sizes: a stride-2 "SAME" 3x3 conv pads (0, 1)
    on an even size and (1, 1) on an odd one."""
    x = _images((2, size, size, 3))
    kw = dict(num_classes=5, width_multiplier=0.5)
    _assert_train_parity(jax_mobilenet.MobileNetV2(**kw),
                         mobilenet.MobileNetV2(**kw), x, 5)
    _assert_train_parity(
        jax_mobilenet.MobileNetV2(small_inputs=True, **kw),
        mobilenet.MobileNetV2(small_inputs=True, **kw), x, 5)


def test_cifar10_matches_reference_in_eval_mode():
    x = _images((4, 16, 16, 3))
    jmodel = jax_cifar10.custom_model()
    variables = _init(jmodel, x)
    pmodel = _port(cifar10.custom_model(), variables).eval()
    with torch.no_grad():
        got = pmodel(torch.from_numpy(x))
    assert got.dtype == torch.float32
    _close(got.numpy(), jmodel.apply(variables, jnp.asarray(x)), OUT_RTOL)


def test_mnist_matches_reference_in_eval_mode():
    x = _images((4, 28, 28))
    jmodel = jax_mnist.custom_model()
    variables = _init(jmodel, x)
    pmodel = _port(mnist.custom_model(), variables).eval()
    with torch.no_grad():
        got = pmodel(torch.from_numpy(x)).numpy()
    _close(got, jmodel.apply(variables, jnp.asarray(x)), OUT_RTOL)


def test_flax_names_cover_every_leaf_both_ways():
    """Every flax leaf maps to one state_dict entry and back."""
    x = _images((2, 32, 32, 3))
    for jmodel, pmodel in (
            (jax_resnet.resnet50(num_classes=7, num_filters=8),
             resnet.resnet50(num_classes=7, num_filters=8)),
            (jax_mobilenet.MobileNetV2(num_classes=5, width_multiplier=0.5,
                                       small_inputs=True),
             mobilenet.MobileNetV2(num_classes=5, width_multiplier=0.5,
                                   small_inputs=True))):
        flat = _flat(_init(jmodel, x))
        state = pmodel.params_from_flax(flat)
        assert set(state) == set(pmodel.state_dict())
        pmodel.load_state_dict(state, strict=True)
        back = pmodel.flax_params(dict(pmodel.named_parameters()))
        back.update({"model_state/batch_stats/" + k.split("/", 1)[1]: v
                     for k, v in train_state.flat_model_state(
                         {"batch_stats": dict(pmodel.named_buffers())}
                     ).items()})
        back = {("params/" + k if not k.startswith("model_state/") else k):
                v for k, v in back.items()}
        assert set(back) == set(flat)
        for name, value in flat.items():
            np.testing.assert_array_equal(back[name], value, err_msg=name)


# ---------------------------------------------------------------------------
# mixed precision (tests/test_resnet_dtypes.py)
# ---------------------------------------------------------------------------


def test_bf16_stream_f32_stats():
    """Under bf16 params and features: logits fp32 (the Dense head),
    running statistics fp32, and every BatchNorm output in the trunk
    bf16 (none promotes the stream)."""
    model = resnet.resnet18(num_classes=8, small_inputs=True)
    state = train_state.create_train_state(
        model, port_opt.create_optimizer("SGD"))
    params = train_state.cast_floating(state.params, torch.bfloat16)
    model_state = step_fns._fresh_model_state(state.model_state)
    bn_dtypes = []
    hooks = [m.register_forward_hook(
        lambda mod, inp, out: bn_dtypes.append(out.dtype))
        for name, m in model.named_modules() if "BatchNorm" in name]
    model.train()
    out = step_fns.apply_model(model, params, model_state,
                               torch.ones(2, 16, 16, 3, dtype=torch.bfloat16))
    for hook in hooks:
        hook.remove()
    assert out.dtype == torch.float32
    assert {t.dtype for t in model_state["batch_stats"].values()} == {
        torch.float32}
    assert bn_dtypes and set(bn_dtypes) == {torch.bfloat16}


def test_space_to_depth_packing():
    """Exact 2x2-block packing semantics, as the reference's."""
    x = np.arange(2 * 4 * 4 * 3).reshape(2, 4, 4, 3)
    packed = resnet.space_to_depth(torch.from_numpy(x), 2).numpy()
    assert packed.shape == (2, 2, 2, 12)
    np.testing.assert_array_equal(packed[0, 0, 0], np.concatenate(
        [x[0, 0, 0], x[0, 0, 1], x[0, 1, 0], x[0, 1, 1]]))
    np.testing.assert_array_equal(
        packed, np.asarray(jax_resnet.space_to_depth(jnp.asarray(x), 2)))


def test_space_to_depth_stem_forward():
    model = resnet.resnet18(num_classes=4, stem="space_to_depth").eval()
    with torch.no_grad():
        out = model(torch.ones(2, 32, 32, 3))
    assert out.shape == (2, 4)
    # the flax kernel (4, 4, 12, 64) is the (64, 12, 4, 4) weight
    assert tuple(model.Conv_0.weight.shape) == (64, 12, 4, 4)
    flat = model.flax_params({"Conv_0.weight": model.Conv_0.weight})
    assert flat["Conv_0/kernel"].shape == (4, 4, 12, 64)

"""Port's dense training core against the JAX package's.

Losses and optimizers against optax on the same inputs; the port's
``make_train_step`` against the JAX ``make_train_step`` on a small
TransformerLM (vocab 256, 2 layers, 2 heads, d 128, S 128, batch 4)
from the same weights, which cross from flax through
``params_from_flax``. The JAX model runs ``attention_impl="xla"`` (what
``auto`` resolves to on the CPU); the port's runs its flash path, whose
wrappers take their plain versions on CPU tensors. Inputs come from
numpy with a seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn

from elasticdl_tpu.models import transformer as jax_zoo
from elasticdl_tpu.train import export as jax_export
from elasticdl_tpu.train import health as jax_health
from elasticdl_tpu.train import losses as jax_losses
from elasticdl_tpu.train import optimizers as jax_opt
from elasticdl_tpu.train import step_fns as jax_steps
from elasticdl_tpu.train import train_state as jax_ts
from elasticdl_tpu_torch.models import transformer as port_zoo
from elasticdl_tpu_torch.train import health as port_health
from elasticdl_tpu_torch.train import losses as port_losses
from elasticdl_tpu_torch.train import optimizers as port_opt
from elasticdl_tpu_torch.train import step_fns as port_steps
from elasticdl_tpu_torch.train import train_state as port_ts

# the suite runs in several worker processes at once: one intra-op
# thread per process keeps these small-shape tests from oversubscribing
# the host's cores under other files' timing-sensitive tests
torch.set_num_threads(1)

WIDTHS = dict(vocab_size=256, num_layers=2, num_heads=2, embed_dim=128)
SEQ, BATCH = 128, 4

# fp32 losses and optimizer updates: the same formulas in the same
# order, so agreement to an fp32 ulp or two (relative 1e-6).
FP32_RTOL = 1e-6
# fp32 train step: the same program up to summation order in the
# matmuls (K <= 512) and libm (exp, tanh); the loss and the grad norm
# to 1e-5 relative. Parameters after Adam(W) steps move by
# lr * m/(sqrt(v) + eps); with lr 1e-3 a 1e-5 relative gradient
# difference moves them by far less than 1e-6, so params agree to 1e-6
# absolute. That holds where |g| >> eps: Adam divides each entry by
# sqrt(v) + eps, so for an entry whose gradient is near eps it
# amplifies the gradient's summation-order noise (up to 3e-8 absolute
# here, with entries as small as 4e-9) by up to 1 / eps. The step tests
# therefore use eps = 1e-3 (ADAM_EPS): the noise then moves a parameter
# by at most lr * 3e-5 a step. The optimizer tests above hold optax's
# default eps 1e-8 on exact gradients.
STEP_RTOL = 1e-5
PARAM_ATOL = 1e-6
ADAM_EPS = 1e-3
# gradients of the fp32 step, per leaf, relative to the leaf's largest
# entry: the same summation-order bound as the loss.
GRAD_RTOL = 1e-4
# bf16 compute: both programs round every activation to bf16 (8
# significant bits) at slightly different places (matmul accumulation,
# the fused vs unfused softmax and CE). The loss, a mean over 508
# tokens a row, agrees to 1e-2 relative; gradients, each a sum over
# bf16-rounded products, to a flattened cosine of at least 0.999 and a
# relative L2 error under 5e-2.
BF16_LOSS_RTOL = 1e-2
BF16_GRAD_COS = 0.999
BF16_GRAD_REL_L2 = 5e-2


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _tokens(seed, batch=BATCH):
    rng = np.random.RandomState(seed)
    return rng.randint(0, WIDTHS["vocab_size"], size=(batch, SEQ)).astype(
        np.int32)


def _batch(seed, mask=None):
    tokens = _tokens(seed)
    if mask is None:
        mask = np.ones(BATCH, np.float32)
    return {"features": tokens, "labels": tokens,
            "_mask": np.asarray(mask, np.float32)}


def _torch_batch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


@pytest.fixture(scope="module")
def jax_lm():
    model = jax_zoo.TransformerLM(attention_impl="xla", **WIDTHS)
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(_tokens(0)))[
        "params"]
    return model, params


def _jax_flat(params):
    return jax_export._flatten(jax.device_get(params))


def _port_model(params):
    model = port_zoo.TransformerLM(**WIDTHS)
    model.load_state_dict(port_zoo.params_from_flax(_jax_flat(params)),
                          strict=True)
    return model


def _port_flat(tree):
    return port_zoo.params_to_flax(tree, WIDTHS["num_heads"])


def _both(opt_type, **opt_args):
    return (jax_opt.create_optimizer(opt_type, **dict(opt_args)),
            port_opt.create_optimizer(opt_type, **dict(opt_args)))


def _states(jax_lm, opt_type="AdamW", **opt_args):
    model, params = jax_lm
    jtx, ptx = _both(opt_type, **opt_args)
    jstate = jax_ts.TrainState(
        step=jnp.zeros((), jnp.int32), params=params, model_state={},
        opt_state=jtx.init(params))
    pmodel = _port_model(params)
    pstate = port_ts.create_train_state(pmodel, ptx)
    return (model, jtx, jstate), (pmodel, ptx, pstate)


def _assert_params_close(pstate, jstate, atol):
    got, expected = _port_flat(pstate.params), _jax_flat(jstate.params)
    assert set(got) == set(expected)
    for name in expected:
        np.testing.assert_allclose(got[name], expected[name], atol=atol,
                                   rtol=0, err_msg=name)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["sparse_softmax_cross_entropy",
                                  "sigmoid_binary_cross_entropy",
                                  "mean_squared_error"])
def test_losses_match_jax(name):
    rng = np.random.RandomState(0)
    if name == "sparse_softmax_cross_entropy":
        labels = rng.randint(0, 10, size=(6, 5)).astype(np.int32)
        preds = (rng.normal(size=(6, 5, 10)) * 3).astype(np.float32)
    elif name == "sigmoid_binary_cross_entropy":
        labels = rng.randint(0, 2, size=(8,)).astype(np.float32)
        preds = (rng.normal(size=(8, 1)) * 3).astype(np.float32)
    else:
        labels = rng.normal(size=(8,)).astype(np.float32)
        preds = rng.normal(size=(8, 1)).astype(np.float32)
    expected = getattr(jax_losses, name)(jnp.asarray(labels),
                                         jnp.asarray(preds))
    got = getattr(port_losses, name)(torch.from_numpy(labels),
                                     torch.from_numpy(preds))
    assert tuple(got.shape) == expected.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(expected),
                               rtol=FP32_RTOL, atol=1e-6)


def test_masked_mean_matches_jax():
    rng = np.random.RandomState(1)
    per_sample = rng.normal(size=(6, 3)).astype(np.float32)
    mask = np.array([1, 1, 0, 1, 0, 1], np.float32)
    expected = jax_losses.masked_mean(jnp.asarray(per_sample),
                                      jnp.asarray(mask))
    got = port_losses.masked_mean(torch.from_numpy(per_sample),
                                  torch.from_numpy(mask))
    np.testing.assert_allclose(got.item(), float(expected), rtol=FP32_RTOL)
    zero = port_losses.masked_mean(torch.from_numpy(per_sample),
                                   torch.zeros(6))
    assert zero.item() == 0.0  # an all-padding batch divides by 1


def test_bf16_cross_entropy_matches_optax_in_bf16():
    """optax computes the CE in the logits' dtype; so does the port.
    Both round logsumexp's exp, sum and log to bf16 at the same points:
    agreement to one bf16 ulp of the O(5) losses (2^-5)."""
    rng = np.random.RandomState(2)
    labels = rng.randint(0, 256, size=(4, 16)).astype(np.int32)
    logits = (rng.normal(size=(4, 16, 256)) * 2).astype(np.float32)
    expected = jax_losses.sparse_softmax_cross_entropy(
        jnp.asarray(labels), jnp.asarray(logits, jnp.bfloat16))
    got = port_losses.sparse_softmax_cross_entropy(
        torch.from_numpy(labels), torch.from_numpy(logits).bfloat16())
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(expected, np.float32),
                               atol=2.0 ** -5, rtol=0)


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------


OPTIMIZERS = [
    ("SGD", {"learning_rate": 0.1}),
    ("SGD", {"learning_rate": 0.1, "momentum": 0.5}),
    ("Momentum", {"learning_rate": 0.05}),
    ("Momentum", {"learning_rate": 0.05, "nesterov": "true"}),
    ("Adam", {"learning_rate": 0.01}),
    ("Adam", {"learning_rate": 0.01, "beta_1": 0.8, "epsilon": 1e-6}),
    ("AdamW", {"learning_rate": 0.01}),
    ("AdamW", {"learning_rate": 3e-4, "weight_decay": 0.01}),
]


@pytest.mark.parametrize("opt_type,opt_args", OPTIMIZERS)
def test_optimizer_updates_match_optax(opt_type, opt_args):
    """Three updates on the same params and gradients, fp32."""
    rng = np.random.RandomState(3)
    params = {"w": rng.normal(size=(5, 4)).astype(np.float32),
              "b": rng.normal(size=(4,)).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32)
              for k, v in params.items()} for _ in range(3)]
    jtx, ptx = _both(opt_type, **opt_args)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jtx.init(jparams)
    pparams = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    pstate = ptx.init(pparams)
    for g in grads:
        jupdates, jstate = jtx.update({k: jnp.asarray(v) for k, v in
                                       g.items()}, jstate, jparams)
        jparams = optax.apply_updates(jparams, jupdates)
        pupdates, pstate = ptx.update({k: torch.from_numpy(v) for k, v in
                                       g.items()}, pstate, pparams)
        for name, p in pparams.items():
            p.add_(pupdates[name])
    for name in params:
        np.testing.assert_allclose(pparams[name].numpy(),
                                   np.asarray(jparams[name]),
                                   rtol=FP32_RTOL, atol=1e-7, err_msg=name)


def test_create_optimizer_rejects_what_it_does_not_take():
    with pytest.raises(ValueError):
        port_opt.create_optimizer("Lion")
    with pytest.raises(ValueError):
        port_opt.create_optimizer("Adam", momentum=0.9)
    for name in port_opt.NOT_PORTED:
        jax_opt.create_optimizer(name)  # the reference takes it
        with pytest.raises(NotImplementedError):
            port_opt.create_optimizer(name)
    spec = "learning_rate=0.1; momentum=0.9;nesterov=true"
    assert port_opt.parse_opt_args(spec) == jax_opt.parse_opt_args(spec)
    with pytest.raises(ValueError):
        port_opt.parse_opt_args("learning_rate")


# ---------------------------------------------------------------------------
# the train step on the small TransformerLM
# ---------------------------------------------------------------------------


def _jax_grads(model, params, batch, compute_dtype=None):
    def loss(params):
        compute = params
        features = jnp.asarray(batch["features"])
        if compute_dtype is not None:
            compute = jax_ts.cast_floating(params, compute_dtype)
        out = model.apply({"params": compute}, features, training=True)
        per_sample = jax_zoo.loss(jnp.asarray(batch["labels"]),
                                  out).astype(jnp.float32)
        mask = jnp.asarray(batch["_mask"])
        return jnp.sum(per_sample * mask) / jnp.maximum(jnp.sum(mask), 1.0)

    value, grads = jax.value_and_grad(loss)(params)
    return float(value), _jax_flat(grads)


def test_step_gradients_match_jax_fp32(jax_lm):
    model, params = jax_lm
    batch = _batch(1, mask=[1, 1, 1, 0])
    expected_loss, expected = _jax_grads(model, params, batch)
    pmodel = _port_model(params)
    state = port_ts.create_train_state(pmodel, port_opt.sgd(0.1))
    loss, grads = port_steps.make_loss_and_grads(pmodel, port_zoo.loss)(
        state, _torch_batch(batch))
    np.testing.assert_allclose(loss.item(), expected_loss, rtol=STEP_RTOL)
    got = _port_flat(grads)
    for name, e in expected.items():
        scale = np.abs(e).max()
        np.testing.assert_allclose(got[name], e, rtol=0,
                                   atol=GRAD_RTOL * scale + 1e-9,
                                   err_msg=name)


@pytest.mark.parametrize("grad_accum_steps", [1, 2])
def test_train_step_matches_jax_adamw(jax_lm, grad_accum_steps):
    """Three AdamW steps (the zoo's optimizer, lr raised to 1e-3 to
    move the weights measurably, eps ADAM_EPS) with health on: losses, grad norms,
    nonfinite flags and the updated params after every step. The third
    batch is ragged, unevenly across the two microbatches."""
    (jmodel, jtx, jstate), (pmodel, ptx, pstate) = _states(
        jax_lm, "AdamW", learning_rate=1e-3, weight_decay=0.01,
        epsilon=ADAM_EPS)
    jstep = jax.jit(jax_steps.make_train_step(
        jmodel, jax_zoo.loss, jtx, grad_accum_steps=grad_accum_steps,
        health=True))
    pstep = port_steps.make_train_step(
        pmodel, port_zoo.loss, ptx, grad_accum_steps=grad_accum_steps,
        health=True)
    masks = [None, None, [1, 0, 1, 1]]
    for i, mask in enumerate(masks):
        batch = _batch(10 + i, mask=mask)
        jstate, jloss, jscalars = jstep(jstate, batch)
        pstate, ploss, pscalars = pstep(pstate, _torch_batch(batch))
        np.testing.assert_allclose(ploss.item(), float(jloss),
                                   rtol=STEP_RTOL)
        np.testing.assert_allclose(pscalars["grad_norm"].item(),
                                   float(jscalars["grad_norm"]),
                                   rtol=STEP_RTOL)
        assert bool(pscalars["nonfinite"]) is bool(jscalars["nonfinite"])
        assert pstate.step == int(jstate.step) == i + 1
        _assert_params_close(pstate, jstate, PARAM_ATOL)
    np.testing.assert_array_equal(
        int(pstate.opt_state["count"]), int(jstate.opt_state[0].count))


def test_grad_accum_matches_single_shot_ragged(jax_lm):
    """grad_accum_steps=2 over strided microbatches with mask-weighted
    sums gives the single-shot step's loss and params (as
    tests/test_grad_accum.py holds the reference to)."""
    batch = _torch_batch(_batch(20, mask=[1, 1, 0, 1]))
    results = []
    for k in (1, 2):
        _, (pmodel, ptx, pstate) = _states(jax_lm, "Adam",
                                           learning_rate=0.01,
                                           epsilon=ADAM_EPS)
        step = port_steps.make_train_step(pmodel, port_zoo.loss, ptx,
                                          grad_accum_steps=k)
        pstate, loss = step(pstate, batch)
        results.append((loss.item(), _port_flat(pstate.params)))
    (loss1, params1), (loss2, params2) = results
    assert np.isclose(loss1, loss2, rtol=1e-6)
    for name in params1:
        np.testing.assert_allclose(params1[name], params2[name], rtol=2e-5,
                                   atol=1e-6, err_msg=name)
    _, (pmodel, ptx, pstate) = _states(jax_lm)
    step = port_steps.make_train_step(pmodel, port_zoo.loss, ptx,
                                      grad_accum_steps=3)
    with pytest.raises(ValueError):
        step(pstate, batch)  # 4 rows do not split in 3


def test_bf16_step_matches_jax_bf16(jax_lm):
    """bf16 compute with fp32 masters on both sides: the loss and the
    fp32 gradients of the masters, at the tolerances stated above."""
    model, params = jax_lm
    batch = _batch(30)
    expected_loss, expected = _jax_grads(model, params, batch,
                                         compute_dtype=jnp.bfloat16)
    pmodel = _port_model(params)
    state = port_ts.create_train_state(pmodel, port_opt.sgd(0.1))
    loss, grads = port_steps.make_loss_and_grads(
        pmodel, port_zoo.loss, compute_dtype=torch.bfloat16)(
        state, _torch_batch(batch))
    assert all(g.dtype == torch.float32 for g in grads.values())
    assert all(p.dtype == torch.float32 for p in state.params.values())
    np.testing.assert_allclose(loss.item(), expected_loss,
                               rtol=BF16_LOSS_RTOL)
    got = _port_flat(grads)
    a = np.concatenate([got[n].ravel() for n in sorted(expected)])
    b = np.concatenate([expected[n].ravel() for n in sorted(expected)])
    cosine = float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))
    rel_l2 = float(np.linalg.norm(a - b) / np.linalg.norm(b))
    assert cosine >= BF16_GRAD_COS, cosine
    assert rel_l2 <= BF16_GRAD_REL_L2, rel_l2


def test_health_off_returns_exactly_state_and_loss(jax_lm):
    _, (pmodel, ptx, pstate) = _states(jax_lm, "SGD", learning_rate=0.1)
    out = port_steps.make_train_step(pmodel, port_zoo.loss, ptx)(
        pstate, _torch_batch(_batch(40)))
    assert len(out) == 2 and out[0].step == 1


# ---------------------------------------------------------------------------
# the nonfinite guard, on a float-feature model (tokens cannot carry NaN)
# ---------------------------------------------------------------------------


class _FlaxMlp(fnn.Module):
    @fnn.compact
    def __call__(self, x, training=False):
        h = fnn.relu(fnn.Dense(16)(x))
        return fnn.Dense(3)(h)


class _TorchMlp(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.Dense_0 = torch.nn.Linear(8, 16)
        self.Dense_1 = torch.nn.Linear(16, 3)

    def forward(self, x):
        return self.Dense_1(torch.relu(self.Dense_0(x)))


def _mlp_pair():
    jmodel = _FlaxMlp()
    x = np.zeros((4, 8), np.float32)
    params = jmodel.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    pmodel = _TorchMlp()
    with torch.no_grad():
        for name in ("Dense_0", "Dense_1"):
            layer = getattr(pmodel, name)
            layer.weight.copy_(torch.from_numpy(
                np.asarray(params[name]["kernel"]).T.copy()))
            layer.bias.copy_(torch.from_numpy(
                np.asarray(params[name]["bias"]).copy()))
    return jmodel, params, pmodel


def test_guard_nonfinite_keeps_the_whole_state():
    """A NaN-poisoned batch under guard_nonfinite: both packages flag
    it and keep params, optimizer state and step; then a clean batch
    trains both to the same params."""
    jmodel, params, pmodel = _mlp_pair()
    jtx, ptx = _both("Adam", learning_rate=0.01)
    jstate = jax_ts.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                               model_state={}, opt_state=jtx.init(params))
    pstate = port_ts.create_train_state(pmodel, ptx)
    jstep = jax.jit(jax_steps.make_train_step(
        jmodel, jax_losses.sparse_softmax_cross_entropy, jtx, health=True,
        guard_nonfinite=True))
    pstep = port_steps.make_train_step(
        pmodel, port_losses.sparse_softmax_cross_entropy, ptx, health=True,
        guard_nonfinite=True)
    rng = np.random.RandomState(5)
    clean = {"features": rng.normal(size=(4, 8)).astype(np.float32),
             "labels": rng.randint(0, 3, size=4).astype(np.int32),
             "_mask": np.ones(4, np.float32)}
    poisoned = dict(clean, features=clean["features"].copy())
    poisoned["features"][2, 3] = np.nan

    before = {n: p.clone() for n, p in pstate.params.items()}
    before_opt = {n: t.clone() for n, t in pstate.opt_state["mu"].items()}
    jstate2, jloss, jscalars = jstep(jstate, poisoned)
    pstate2, ploss, pscalars = pstep(pstate, _torch_batch(poisoned))
    assert bool(jscalars["nonfinite"]) and bool(pscalars["nonfinite"])
    assert not np.isfinite(float(jloss)) and not np.isfinite(ploss.item())
    assert int(jstate2.step) == 0 and pstate2.step == 0
    assert int(pstate2.opt_state["count"]) == 0
    for name, p in pstate2.params.items():
        assert torch.equal(p, before[name]), name
    for name, t in pstate2.opt_state["mu"].items():
        assert torch.equal(t, before_opt[name]), name

    jstate3, jloss3, _ = jstep(jstate2, clean)
    pstate3, ploss3, _ = pstep(pstate2, _torch_batch(clean))
    np.testing.assert_allclose(ploss3.item(), float(jloss3), rtol=STEP_RTOL)
    for name in ("Dense_0", "Dense_1"):
        np.testing.assert_allclose(
            pstate3.params[name + ".weight"].numpy().T,
            np.asarray(jstate3.params[name]["kernel"]), atol=PARAM_ATOL)


def test_guard_nonfinite_state_selects_per_leaf():
    old = port_ts.TrainState(step=3, params={"w": torch.zeros(2)},
                             model_state={}, opt_state={"m": torch.ones(2)})
    new = port_ts.TrainState(step=4, params={"w": torch.ones(2)},
                             model_state={}, opt_state={"m": torch.zeros(2)})
    kept = port_steps.guard_nonfinite_state(old, new, torch.tensor(True))
    assert kept.step == 3 and torch.equal(kept.params["w"], torch.zeros(2))
    assert torch.equal(kept.opt_state["m"], torch.ones(2))
    moved = port_steps.guard_nonfinite_state(old, new, torch.tensor(False))
    assert moved.step == 4 and torch.equal(moved.params["w"], torch.ones(2))


def test_global_grad_norm_and_health_scalars_match_jax():
    rng = np.random.RandomState(6)
    trees = [{"a": rng.normal(size=(3, 4)).astype(np.float32)},
             {"b": rng.normal(size=(5,)).astype(np.float32)}]
    expected = jax_steps.global_grad_norm(
        *[{k: jnp.asarray(v) for k, v in t.items()} for t in trees])
    got = port_steps.global_grad_norm(
        *[{k: torch.from_numpy(v) for k, v in t.items()} for t in trees])
    np.testing.assert_allclose(got.item(), float(expected), rtol=FP32_RTOL)
    for loss in (1.0, float("nan")):
        j = jax_steps.health_scalars(jnp.float32(loss), expected)
        p = port_steps.health_scalars(torch.tensor(loss), got)
        assert bool(p["nonfinite"]) is bool(j["nonfinite"])


# ---------------------------------------------------------------------------
# state helpers and the health tracker
# ---------------------------------------------------------------------------


def test_train_state_helpers_match_jax(jax_lm):
    _, params = jax_lm
    pmodel = _port_model(params)
    assert port_ts.num_params(dict(pmodel.named_parameters())) == \
        jax_ts.num_params(params)
    cast = port_ts.cast_floating(
        {"x": torch.ones(2), "i": torch.ones(2, dtype=torch.int32)},
        torch.bfloat16)
    assert cast["x"].dtype == torch.bfloat16
    assert cast["i"].dtype == torch.int32
    assert port_ts.resolve_dtype("bfloat16") is torch.bfloat16
    assert port_ts.resolve_dtype(None) is None
    with pytest.raises(ValueError):
        port_ts.resolve_dtype("int32")


def test_health_tracker_decides_as_jax():
    """The same stream of health scalars through both trackers: the
    same spikes, explosions, streaks, skips and EWMAs."""
    rng = np.random.RandomState(7)
    stream = [(1.0 + rng.uniform(-0.01, 0.01), 1.0, False)
              for _ in range(25)]
    stream += [(50.0, 1.0, False), (1.0, 200.0, False),
               (float("nan"), float("nan"), True),
               (float("nan"), 1.0, True), (1.0, 1.0, False)]
    kwargs = dict(action="skip", spike_z=4.0, grad_norm_max=100.0,
                  grad_factor=10.0, warmup_steps=5)
    trackers = (jax_health.HealthTracker(**kwargs),
                port_health.HealthTracker(**kwargs))
    for loss, norm, nonfinite in stream:
        actions = [t.observe(loss, norm, nonfinite) for t in trackers]
        assert actions[0] == actions[1]
    jstats, pstats = (t.stats() for t in trackers)
    assert set(jstats) == set(pstats)
    for key, value in jstats.items():
        np.testing.assert_allclose(pstats[key], value, rtol=1e-12,
                                   err_msg=key)
    halt = port_health.HealthTracker(action="halt")
    with pytest.raises(port_health.HealthSentinelError):
        halt.observe(float("nan"), 1.0, True)


def test_health_env_knobs(monkeypatch):
    monkeypatch.delenv("EDL_HEALTH", raising=False)
    monkeypatch.delenv("EDL_HEALTH_ON_NONFINITE", raising=False)
    assert port_health.maybe_tracker() is not None
    assert port_health.nonfinite_action() == "alert"
    monkeypatch.setenv("EDL_HEALTH", "0")
    assert port_health.maybe_tracker() is None
    monkeypatch.setenv("EDL_HEALTH_ON_NONFINITE", "explode")
    with pytest.raises(ValueError):
        port_health.nonfinite_action()

"""The port's optimizers (elasticdl_tpu_torch/train/optimizers.py)
against the reference's optax ones (tests/test_optimizers.py's cases):
every optimizer of ``SUPPORTED`` for several steps on the same params
and gradients, Ftrl's L1 sparsity and schedule, a schedule-valued
learning rate, the host-schedulable learning rate and the
``LearningRateScheduler`` callback.

Tolerance: fp32, the same formulas in the same order up to optax's
``rsqrt`` against torch's (a last-bit difference); six updates of
unit-scale gradients keep params within 1e-6 relative (2e-6 absolute
near 0).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from elasticdl_tpu.train import optimizers as jax_opt
from elasticdl_tpu_torch.train import optimizers as port_opt
from elasticdl_tpu_torch.train.callbacks import LearningRateScheduler
from elasticdl_tpu_torch.train.train_state import TrainState

torch.set_num_threads(1)

RTOL, ATOL = 1e-6, 2e-6
STEPS = 6

CASES = [
    ("SGD", {}),
    ("SGD", {"momentum": 0.5, "nesterov": "true"}),
    ("Momentum", {}),
    ("Adam", {}),
    ("AdamW", {"weight_decay": 0.01}),
    ("Adagrad", {}),
    ("Adagrad", {"initial_accumulator_value": 0.5, "epsilon": 1e-5}),
    ("RMSprop", {}),
    ("RMSprop", {"momentum": 0.9, "rho": 0.8}),
    ("Adamax", {}),
    ("Nadam", {}),
    ("Nadam", {"beta_1": 0.8, "beta_2": 0.99, "epsilon": 1e-6}),
    ("Adadelta", {"learning_rate": 1.0}),
    ("Adadelta", {"learning_rate": 1.0, "rho": 0.9, "epsilon": 1e-6}),
    ("Ftrl", {}),
    ("Ftrl", {"l1_regularization_strength": 0.01,
              "l2_regularization_strength": 0.1,
              "learning_rate_power": -0.3}),
]


def _run(jtx, ptx, seed=0, steps=STEPS):
    rng = np.random.RandomState(seed)
    params = {"w": rng.normal(size=(5, 4)).astype(np.float32),
              "b": rng.normal(size=(4,)).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32)
              for k, v in params.items()} for _ in range(steps)]
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jtx.init(jparams)
    pparams = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    pstate = ptx.init(pparams)
    for g in grads:
        jupdates, jstate = jtx.update(
            {k: jnp.asarray(v) for k, v in g.items()}, jstate, jparams)
        jparams = optax.apply_updates(jparams, jupdates)
        pupdates, pstate = ptx.update(
            {k: torch.from_numpy(v) for k, v in g.items()}, pstate, pparams)
        for name, p in pparams.items():
            p.add_(pupdates[name])
    return pparams, jparams, pstate


def _assert_close(pparams, jparams, what):
    for name in jparams:
        np.testing.assert_allclose(pparams[name].numpy(),
                                   np.asarray(jparams[name]), rtol=RTOL,
                                   atol=ATOL, err_msg="%s %s" % (what, name))


@pytest.mark.parametrize("opt_type,opt_args", CASES)
def test_optimizer_matches_optax_over_steps(opt_type, opt_args):
    args = {"learning_rate": 0.05, **opt_args}
    pparams, jparams, _ = _run(
        jax_opt.create_optimizer(opt_type, **dict(args)),
        port_opt.create_optimizer(opt_type, **dict(args)))
    _assert_close(pparams, jparams, opt_type)


def test_supported_is_the_reference_list():
    assert port_opt.SUPPORTED == jax_opt.SUPPORTED
    assert not hasattr(port_opt, "NOT_PORTED")


@pytest.mark.parametrize("opt_type", port_opt.SUPPORTED)
def test_every_optimizer_descends_quadratic(opt_type):
    """tests/test_optimizers.py's quadratic on the port: every factory
    product reduces |w - target|^2."""
    lr = 10.0 if opt_type == "Adadelta" else 0.1
    tx = port_opt.create_optimizer(opt_type, learning_rate=lr)
    target = torch.tensor([1.0, -2.0, 3.0])
    params = {"w": torch.zeros(3)}
    state = tx.init(params)
    first = None
    for _ in range(300 if opt_type == "Adadelta" else 100):
        loss = float(torch.sum((params["w"] - target) ** 2))
        first = loss if first is None else first
        updates, state = tx.update({"w": 2 * (params["w"] - target)}, state,
                                   params)
        params["w"].add_(updates["w"])
    assert loss < first * 0.3, (opt_type, first, loss)


@pytest.mark.parametrize("opt_type", ["SGD", "Momentum", "Adam", "Adagrad",
                                      "RMSprop", "Nadam", "Ftrl"])
def test_schedule_learning_rate_matches_optax(opt_type):
    """A learning rate given as a schedule (a callable of the update
    count): the port's torch schedule and optax's agree step by step."""
    jtx = jax_opt.create_optimizer(
        opt_type, learning_rate=optax.exponential_decay(0.1, 1, 0.5))
    ptx = port_opt.create_optimizer(
        opt_type, learning_rate=lambda count: 0.1 * 0.5 ** count.float())
    pparams, jparams, pstate = _run(jtx, ptx, seed=3)
    _assert_close(pparams, jparams, opt_type)
    count = pstate.get("schedule_count", pstate.get("count"))
    assert int(count) == STEPS


def test_ftrl_matches_numpy_transcription():
    """tests/test_optimizers.py's independent numpy model of the
    FTRL-proximal rule, on the port."""
    lr, l1, l2, power, init_acc = 0.5, 0.1, 0.2, -0.5, 0.1
    tx = port_opt.ftrl(lr, learning_rate_power=power,
                       initial_accumulator_value=init_acc,
                       l1_regularization_strength=l1,
                       l2_regularization_strength=l2)
    rng = np.random.RandomState(0)
    w = rng.randn(5).astype(np.float32)
    params = {"w": torch.from_numpy(w.copy())}
    state = tx.init(params)
    n = np.full(5, init_acc, np.float32)
    z = np.zeros(5, np.float32)
    w_ref = w.copy()
    for _ in range(5):
        g = rng.randn(5).astype(np.float32)
        updates, state = tx.update({"w": torch.from_numpy(g)}, state, params)
        params["w"].add_(updates["w"])
        new_n = n + g * g
        sigma = (new_n ** -power - n ** -power) / lr
        z = z + g - sigma * w_ref
        n = new_n
        quad = n ** -power / lr + 2 * l2
        w_ref = np.where(np.abs(z) > l1, (np.sign(z) * l1 - z) / quad,
                         0.0).astype(np.float32)
        np.testing.assert_allclose(params["w"].numpy(), w_ref, rtol=1e-5,
                                   atol=1e-6)


def test_ftrl_l1_produces_sparsity():
    assert port_opt.create_optimizer("Ftrl", learning_rate=0.1,
                                     l1_regularization_strength=2.0)
    tx = port_opt.ftrl(0.1, l1_regularization_strength=2.0)
    params = {"w": torch.tensor([0.5, -0.5, 0.0])}
    state = tx.init(params)
    # tiny gradients: |z| never exceeds l1 -> weights snap to exactly 0
    for _ in range(3):
        updates, state = tx.update({"w": torch.tensor([0.01, -0.01, 0.01])},
                                   state, params)
        params["w"].add_(updates["w"])
    np.testing.assert_array_equal(params["w"].numpy(), 0.0)


def test_ftrl_accepts_schedule():
    tx = port_opt.ftrl(lambda count: 0.1)
    params = {"w": torch.zeros(3)}
    state = tx.init(params)
    updates, state = tx.update({"w": torch.ones(3)}, state, params)
    assert int(state["count"]) == 1
    assert torch.isfinite(updates["w"]).all()


def test_unknown_optimizer_and_kwarg_rejected():
    with pytest.raises(ValueError, match="Unsupported optimizer"):
        port_opt.create_optimizer("Lion")
    with pytest.raises(ValueError):
        port_opt.create_optimizer("Adam", learning_rate=0.1, blah=3)
    with pytest.raises(ValueError):
        port_opt.create_host_schedulable_optimizer("RMSprop", beta_1=0.9)


@pytest.mark.parametrize("opt_type", ["Adam", "Momentum", "Ftrl"])
def test_host_schedulable_matches_inject_hyperparams(opt_type):
    """The learning rate lives in the state: rewritten between steps, it
    moves the updates as optax.inject_hyperparams's rewrite does."""
    jtx = jax_opt.create_host_schedulable_optimizer(opt_type,
                                                    learning_rate=0.1)
    ptx = port_opt.create_host_schedulable_optimizer(opt_type,
                                                     learning_rate=0.1)
    rng = np.random.RandomState(1)
    w = rng.normal(size=(4,)).astype(np.float32)
    jparams, pparams = {"w": jnp.asarray(w)}, {"w": torch.from_numpy(w)}
    jstate, pstate = jtx.init(jparams), ptx.init(pparams)
    for lr in (0.1, 0.05, 0.2, 0.01):
        jstate = jax_opt.set_learning_rate(jstate, lr)
        pstate = port_opt.set_learning_rate(pstate, lr)
        g = rng.normal(size=(4,)).astype(np.float32)
        ju, jstate = jtx.update({"w": jnp.asarray(g)}, jstate, jparams)
        jparams = optax.apply_updates(jparams, ju)
        pu, pstate = ptx.update({"w": torch.from_numpy(g)}, pstate, pparams)
        pparams["w"].add_(pu["w"])
        assert float(pstate["learning_rate"]) == pytest.approx(lr)
    _assert_close(pparams, jparams, opt_type)
    # a plain optimizer's state holds no learning rate
    assert port_opt.set_learning_rate(
        port_opt.create_optimizer("Adam").init(pparams), 0.1) is None


def test_lr_scheduler_rewrites_injected_lr():
    """tests/test_model_zoo.py::test_lr_scheduler_rewrites_injected_lr on
    the port: the host-set learning rate lands in the optimizer state
    and rides through the update; the callback rewrites the worker's
    state from the schedule."""
    tx = port_opt.create_host_schedulable_optimizer("Adam",
                                                    learning_rate=0.5)
    params = {"w": torch.ones(3)}
    opt_state = tx.init(params)
    new_state = port_opt.set_learning_rate(opt_state, 0.125)
    assert new_state is not None
    _, after = tx.update({"w": torch.ones(3)}, new_state, params)
    assert float(after["learning_rate"]) == 0.125

    class FakeWorker:
        pass

    worker = FakeWorker()
    worker.state = TrainState(step=0, params=params, model_state={},
                              opt_state=opt_state)
    cb = LearningRateScheduler(lambda step: 0.25 if step > 10 else 0.5)
    cb.set_worker(worker)
    cb.on_batch_end(20, 0.0)
    assert float(worker.state.opt_state["learning_rate"]) == 0.25
    cb.on_batch_end(3, 0.0)
    assert float(worker.state.opt_state["learning_rate"]) == 0.5
    assert dataclasses.is_dataclass(worker.state)


def test_lr_scheduler_warns_once_on_a_plain_optimizer(caplog):
    class FakeWorker:
        pass

    worker = FakeWorker()
    params = {"w": torch.ones(3)}
    worker.state = TrainState(
        step=0, params=params, model_state={},
        opt_state=port_opt.create_optimizer("Adam").init(params))
    before = worker.state
    cb = LearningRateScheduler(lambda step: 0.1)
    cb.set_worker(worker)
    with caplog.at_level("WARNING"):
        cb.on_batch_end(1, 0.0)
        cb.on_batch_end(2, 0.0)
    assert worker.state is before
    assert sum("schedule ignored" in r.message for r in caplog.records) == 1

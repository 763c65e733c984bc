"""``model_state`` (BatchNorm's running averages) through the port's
train step, grad accumulation, the nonfinite guard, the eval step, the
dense checkpoints, the export bundle (both ways with the reference) and
serving; and the vision zoo trained through ``LocalExecutor``. Helpers
and tolerances are tests/test_torch_vision.py's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticdl_tpu.models import resnet as jax_resnet
from elasticdl_tpu.serve.model import ServingModel as JaxServingModel
from elasticdl_tpu.train import export as jax_export
from elasticdl_tpu.train import optimizers as jax_opt
from elasticdl_tpu.train import step_fns as jax_steps
from elasticdl_tpu.train import train_state as jax_ts
from elasticdl_tpu_torch.models import cifar10, mnist, resnet
from elasticdl_tpu_torch.models.registry import get_model_spec
from elasticdl_tpu_torch.serve.model import ServingModel
from elasticdl_tpu_torch.train import export
from elasticdl_tpu_torch.train import optimizers as port_opt
from elasticdl_tpu_torch.train import step_fns
from elasticdl_tpu_torch.train import train_state
from elasticdl_tpu_torch.train.checkpoint import DenseCheckpointManager
from elasticdl_tpu_torch.worker.trainer import TorchTrainer
from tests.test_torch_vision import (
    OUT_RTOL,
    PARAM_ATOL,
    _close,
    _images,
    _init,
    _labels,
    _port,
)

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# model_state through the step
# ---------------------------------------------------------------------------


def _step_pair(k=1, steps=2, batch=8, opt=("Momentum", dict(
        learning_rate=0.05, momentum=0.9, nesterov=True))):
    """ResNet-18 (8 filters, 16x16, cifar stem) trained ``steps`` steps
    by both packages' ``make_train_step`` from the same variables."""
    kw = dict(num_classes=5, num_filters=8, small_inputs=True)
    jmodel, pmodel = jax_resnet.resnet18(**kw), resnet.resnet18(**kw)
    x = _images((batch, 16, 16, 3))
    variables = _init(jmodel, x)
    pmodel = _port(pmodel, variables)
    jtx = jax_opt.create_optimizer(opt[0], **dict(opt[1]))
    ptx = port_opt.create_optimizer(opt[0], **dict(opt[1]))
    jstate = jax_ts.TrainState(
        step=jnp.zeros((), jnp.int32), params=variables["params"],
        model_state={"batch_stats": variables["batch_stats"]},
        opt_state=jtx.init(variables["params"]))
    pstate = train_state.create_train_state(pmodel, ptx)
    jstep = jax.jit(jax_steps.make_train_step(jmodel, jax_resnet.loss, jtx,
                                              grad_accum_steps=k))
    pstep = step_fns.make_train_step(pmodel, resnet.loss, ptx,
                                     grad_accum_steps=k)
    for s in range(steps):
        images = _images((batch, 16, 16, 3), seed=10 + s)
        labels = _labels(batch, 5, seed=20 + s)
        mask = np.ones(batch, np.float32)
        jstate, jloss = jstep(jstate, {"features": images, "labels": labels,
                                       "_mask": mask})
        pstate, ploss = pstep(pstate, {
            "features": torch.from_numpy(images),
            "labels": torch.from_numpy(labels),
            "_mask": torch.from_numpy(mask)})
        np.testing.assert_allclose(float(ploss), float(jloss), rtol=1e-5)
    return jstate, pstate, pmodel


def _assert_states_close(jstate, pstate, pmodel):
    expected = jax_export._flatten(jax.device_get(jstate.params))
    got = pmodel.flax_params(pstate.params)
    assert set(got) == set(expected)
    for name, value in expected.items():
        np.testing.assert_allclose(got[name], value, rtol=0,
                                   atol=PARAM_ATOL, err_msg=name)
    expected = jax_export._flatten(jax.device_get(jstate.model_state))
    got = train_state.flat_model_state(pstate.model_state)
    assert set(got) == set(expected)
    for name, value in expected.items():
        _close(got[name].numpy(), value, OUT_RTOL, name)


def test_train_step_carries_batch_stats_like_reference():
    """Two Momentum(nesterov) steps of the whole step: loss, params and
    the running statistics after each, against the reference's step."""
    jstate, pstate, pmodel = _step_pair()
    assert pstate.step == 2
    _assert_states_close(jstate, pstate, pmodel)
    # the module holds the newest statistics (the state shares its
    # buffers)
    buffers = dict(pmodel.named_buffers())
    for name, t in pstate.model_state["batch_stats"].items():
        assert t.data_ptr() == buffers[name].data_ptr()


@pytest.mark.parametrize("k", [2, 4])
def test_grad_accum_carries_batch_stats_through_microbatches(k):
    """Each microbatch normalizes with its own statistics and updates
    the running averages in order, as the reference's scan carries
    them (tests/test_grad_accum.py's accumulation with model state)."""
    jstate, pstate, pmodel = _step_pair(k=k, steps=1)
    _assert_states_close(jstate, pstate, pmodel)


def test_nonfinite_batch_leaves_model_state_untouched():
    """The guard skips the update: params, slots, step AND the running
    statistics stay as they were (the forward wrote into copies)."""
    model = resnet.resnet18(num_classes=5, num_filters=8, small_inputs=True)
    tx = port_opt.create_optimizer("Momentum", learning_rate=0.1)
    step = step_fns.make_train_step(model, resnet.loss, tx, health=True,
                                    guard_nonfinite=True)
    state = train_state.create_train_state(model, tx)
    before = {n: t.clone() for n, t in train_state.flat_model_state(
        state.model_state).items()}
    params = {n: t.clone() for n, t in state.params.items()}
    images = _images((4, 16, 16, 3))
    images[0, 0, 0, 0] = np.nan
    batch = {"features": torch.from_numpy(images),
             "labels": torch.from_numpy(_labels(4, 5)),
             "_mask": torch.ones(4)}
    new, _, scalars = step(state, batch)
    assert bool(scalars["nonfinite"]) and new.step == 0
    for name, t in train_state.flat_model_state(new.model_state).items():
        torch.testing.assert_close(t, before[name], rtol=0, atol=0)
    for name, t in new.params.items():
        torch.testing.assert_close(t, params[name], rtol=0, atol=0)
    # a finite batch moves them
    batch["features"] = torch.from_numpy(_images((4, 16, 16, 3)))
    new, _, scalars = step(state, batch)
    assert not bool(scalars["nonfinite"]) and new.step == 1
    moved = train_state.flat_model_state(new.model_state)
    assert any(not torch.equal(moved[n], before[n]) for n in before)


def test_eval_step_uses_running_averages():
    model = resnet.resnet18(num_classes=5, num_filters=8, small_inputs=True)
    tx = port_opt.create_optimizer("SGD")
    state = train_state.create_train_state(model, tx)
    x = torch.from_numpy(_images((2, 16, 16, 3)))
    with torch.no_grad():
        for t in state.model_state["batch_stats"].values():
            t.add_(0.25)
    out = step_fns.make_eval_step(model)(state, x)
    assert not model.training
    model.eval()
    with torch.no_grad():
        torch.testing.assert_close(out, model(x), rtol=0, atol=0)


# ---------------------------------------------------------------------------
# checkpoints, export and serving with batch_stats
# ---------------------------------------------------------------------------


def _trained_resnet(steps=2):
    _, pstate, pmodel = _step_pair(steps=steps)
    return pstate, pmodel


def test_dense_checkpoint_round_trips_batch_stats(tmp_path):
    state, model = _trained_resnet()
    mgr = DenseCheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(2, state)
    kw = dict(num_classes=5, num_filters=8, small_inputs=True)
    fresh = resnet.resnet18(**kw)
    tx = port_opt.create_optimizer("Momentum", learning_rate=0.05,
                                   momentum=0.9, nesterov=True)
    template = train_state.create_train_state(fresh, tx)
    restored = mgr.restore(template=template)
    assert restored.step == 2
    saved = train_state.flat_model_state(state.model_state)
    got = train_state.flat_model_state(restored.model_state)
    assert set(got) == set(saved) and any(
        "batch_stats/BasicBlock_0/BatchNorm_1/var" == n for n in got)
    for name in saved:
        torch.testing.assert_close(got[name], saved[name], rtol=0, atol=0)
    # restored in place: the fresh module serves the restored statistics
    fresh.eval()
    model.eval()
    x = torch.from_numpy(_images((2, 16, 16, 3)))
    with torch.no_grad():
        torch.testing.assert_close(fresh(x), model(x), rtol=0, atol=0)


def test_port_export_loads_in_reference(tmp_path):
    """A ResNet bundle written by the port: the reference's
    load_exported reads the same flat names and values, and its
    ServingModel answers as the port's eval step."""
    state, model = _trained_resnet()
    path = str(tmp_path / "export")
    export.export_train_state(state, path)
    params, model_state, step = jax_export.load_exported(path)
    assert step == 2
    flat = jax_export._flatten({"params": params,
                                "model_state": model_state})
    expected = {"params/" + k: v for k, v in
                model.flax_params(state.params).items()}
    expected.update({"model_state/" + k: v.numpy() for k, v in
                     train_state.flat_model_state(state.model_state).items()})
    assert set(flat) == set(expected)
    for name, value in expected.items():
        np.testing.assert_array_equal(flat[name], value, err_msg=name)
    assert "batch_stats" in model_state

    class Spec:
        custom_model = staticmethod(lambda: jax_resnet.resnet18(
            num_classes=5, num_filters=8, small_inputs=True))
        sparse_embedding_specs = None

    x = _images((3, 16, 16, 3))
    served = JaxServingModel(Spec, path, max_batch=4).predict(x, 3)
    ours = step_fns.make_eval_step(model)(state, torch.from_numpy(x))
    _close(ours.numpy(), served["output"], OUT_RTOL)


def test_reference_export_serves_in_port(tmp_path):
    """A bundle written by the reference (params + batch_stats) loads
    into the port's ServingModel and answers as the reference's eval
    step, fp32 and bf16 (whose running statistics stay fp32)."""
    kw = dict(num_classes=5, num_filters=8, small_inputs=True)
    jmodel = jax_resnet.resnet50(**kw)
    x = _images((3, 16, 16, 3))
    variables = _init(jmodel, x)
    jstate = jax_ts.TrainState(
        step=jnp.asarray(7, jnp.int32), params=variables["params"],
        model_state={"batch_stats": variables["batch_stats"]}, opt_state=())
    path = str(tmp_path / "export")
    jax_export.export_train_state(jstate, path)
    spec = get_model_spec("elasticdl_tpu_torch.models.resnet",
                          model_params="num_classes=5;num_filters=8;"
                                       "small_inputs=True")
    for dtype, rtol in ((None, OUT_RTOL), ("bfloat16", 3e-2)):
        served = ServingModel(spec, path, max_batch=4, device="cpu",
                              compute_dtype=dtype)
        assert served.step == 7
        assert {b.dtype for b in served.model.buffers()} == {torch.float32}
        got = served.predict(x, 3)["output"]
        expected = jax.jit(jax_steps.make_eval_step(
            jmodel, None if dtype is None else jnp.bfloat16))(jstate, x)
        _close(got.float().numpy(), np.asarray(expected, np.float32), rtol,
               dtype)


# ---------------------------------------------------------------------------
# training through the zoo contract
# ---------------------------------------------------------------------------


def _dirs(tmp_path, maker, **kwargs):
    train_dir, valid_dir = tmp_path / "train", tmp_path / "valid"
    train_dir.mkdir()
    valid_dir.mkdir()
    maker(str(train_dir / "f0.rec"), seed=0, **kwargs)
    maker(str(valid_dir / "f0.rec"), seed=1, **kwargs)
    return str(train_dir), str(valid_dir)


@pytest.mark.parametrize("module", [
    "elasticdl_tpu_torch.models.cifar10",
    "elasticdl_tpu_torch.models.mobilenet",
    "elasticdl_tpu_torch.models.mnist",
])
def test_vision_family_learns(tmp_path, module):
    """tests/test_model_zoo.py::test_vision_family_learns on the port,
    plus mnist: three epochs on separable images and the loss falls."""
    from elasticdl_tpu_torch.train.local_executor import LocalExecutor
    from tests.test_model_zoo import create_cifar_recordio
    from tests.test_utils import create_mnist_recordio

    if module.endswith("mnist"):
        train_dir, valid_dir = _dirs(tmp_path, create_mnist_recordio,
                                     num_records=192)
    else:
        train_dir, valid_dir = _dirs(tmp_path, create_cifar_recordio,
                                     num_records=192)
    executor = LocalExecutor(module, training_data=train_dir,
                             validation_data=valid_dir, minibatch_size=32,
                             num_epochs=3, device="cpu")
    losses = executor.train()
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    summary = executor.evaluate()
    assert 0.0 <= summary["accuracy"] <= 1.0


def test_lazy_dense_is_sized_from_the_seed():
    """mnist's first Dense is sized by the first batch and then drawn
    from the trainer's seed: two trainers with one seed agree, another
    seed differs, and no running average moved while sizing."""
    features = _images((2, 8, 8))

    def weights(seed):
        trainer = TorchTrainer(mnist.custom_model(), mnist.loss,
                               mnist.optimizer(), health=False,
                               device="cpu", seed=seed)
        state = trainer.create_state(features)
        return state.params["Dense_0.weight"]

    a, b, c = weights(0), weights(0), weights(1)
    assert tuple(a.shape) == (128, 4 * 4 * 64)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)
    model = cifar10.custom_model()
    trainer = TorchTrainer(model, cifar10.loss, cifar10.optimizer(),
                           health=False, device="cpu")
    state = trainer.create_state(_images((2, 16, 16, 3)))
    for t in state.model_state["batch_stats"].values():
        assert float(t.abs().sum()) in (0.0, float(t.numel()))


def test_resnet_local_executor_exports_batch_stats(tmp_path):
    """The zoo contract end to end: a tiny ResNet trains through
    LocalExecutor, its state exports with model_state/batch_stats and
    serves back as the trainer's eval step."""
    from elasticdl_tpu_torch.train.local_executor import LocalExecutor
    from tests.test_model_zoo import create_cifar_recordio

    train_dir, valid_dir = _dirs(tmp_path, create_cifar_recordio,
                                 num_records=64)
    params = "num_classes=6;num_filters=8;small_inputs=True"
    executor = LocalExecutor("elasticdl_tpu_torch.models.resnet",
                             training_data=train_dir,
                             validation_data=valid_dir, minibatch_size=16,
                             num_epochs=1, model_params=params, device="cpu")
    losses = executor.train()
    assert len(losses) == 4 and all(np.isfinite(losses))
    path = str(tmp_path / "export")
    export.export_train_state(executor.state, path)
    _, model_state, step = export.load_exported(path)
    assert step == 4
    assert any(n.startswith("batch_stats/BottleneckBlock_0/BatchNorm_0/")
               for n in model_state)
    served = ServingModel(executor.spec, path, max_batch=4, device="cpu")
    x = _images((4, 16, 16, 3))
    expected = executor.trainer.eval_step(executor.state, {"features": x})
    np.testing.assert_allclose(served.predict(x, 4)["output"].numpy(),
                               expected, rtol=1e-5, atol=1e-6)


def test_state_names_follow_flax_collections():
    model = resnet.resnet18(num_classes=5, num_filters=8, small_inputs=True)
    state = train_state.create_train_state(model,
                                           port_opt.create_optimizer("SGD"))
    assert list(state.model_state) == ["batch_stats"]
    flat = train_state.flat_model_state(state.model_state)
    assert "batch_stats/BatchNorm_0/mean" in flat
    assert "batch_stats/BasicBlock_7/BatchNorm_1/var" in flat
    # a model without buffers keeps an empty model state
    from elasticdl_tpu_torch.models import transformer

    lm = transformer.TransformerLM(vocab_size=16, num_layers=1, num_heads=2,
                                   embed_dim=16)
    assert train_state.create_train_state(
        lm, port_opt.create_optimizer("SGD")).model_state == {}
    assert dataclasses.is_dataclass(state)

"""BatchNorm under data parallelism: the statistics of the whole batch.

The reference's SPMD step is one program, so ``jnp.mean`` over a batch
sharded on the data axes is the global batch's mean. The port's ranks
each hold their rows, so its BatchNorm (ops/batch_norm.py) averages the
mean and the mean of squares over the data ranks of the ambient mesh.
cifar10 (flax's stock BatchNorm in fp32) at dp=2 over two gloo ranks
(tests/torch_ranks.py) is held against the reference's ``SpmdTrainer``
on a 2-device CPU mesh over the same numpy batch, from the reference's
initial weights, with both models' dropout at rate 0 and plain SGD
(lr 0.1: Adam's first steps move an element whose gradient is near 0
by about the learning rate in either direction, which would hide the
statistics' effect): 3 steps' losses within 1e-4, parameters within
rtol 2e-3 / atol 2e-5 and the running averages within rtol 1e-4 / atol
1e-5 (fp32 reduction order).
"""

import jax
import numpy as np
import pytest

import flax.linen as nn

from elasticdl_tpu.models import cifar10 as ref_cifar10
from elasticdl_tpu.parallel.mesh import MeshConfig, build_mesh
from elasticdl_tpu.parallel.spmd_trainer import SpmdTrainer
from elasticdl_tpu.train import export as jax_export
from elasticdl_tpu.train.optimizers import create_optimizer
from elasticdl_tpu_torch.models import cifar10
from tests.torch_ranks import run_ranks

STEPS = 3
LR = 0.1


def _batch(seed=0, batch=8, size=16):
    rng = np.random.RandomState(seed)
    return {
        "features": rng.rand(batch, size, size, 3).astype(np.float32),
        "labels": rng.randint(0, 10, size=batch).astype(np.int32),
        "_mask": np.ones(batch, np.float32),
    }


class _NoDropout:
    """flax.linen, but its Dropout at rate 0 (the identity)."""

    def __getattr__(self, name):
        return getattr(nn, name)

    @staticmethod
    def Dropout(rate, **kwargs):
        return nn.Dropout(0.0, **kwargs)


@pytest.fixture(scope="module")
def reference():
    """The reference's SpmdTrainer at dp=2: the initial weights, then
    3 steps' losses, params and batch_stats by the port's names."""
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(ref_cifar10, "nn", _NoDropout())
        trainer = SpmdTrainer(
            model=ref_cifar10.custom_model(), loss_fn=ref_cifar10.loss,
            optimizer=create_optimizer("SGD", learning_rate=LR), seed=0,
            mesh=build_mesh(MeshConfig(dp=2, devices=jax.devices()[:2])))
        state = trainer.create_state(_batch()["features"])
        flat = jax_export._flatten(
            {"params": jax.device_get(state.params)})
        losses = []
        for _ in range(STEPS):
            state, loss = trainer.train_step(state, _batch())
            losses.append(float(loss))
    params = jax_export._flatten({"params": jax.device_get(state.params)})
    stats = jax_export._flatten(jax.device_get(state.model_state))
    return flat, losses, cifar10.params_from_flax(params), \
        cifar10.params_from_flax(stats)


@pytest.fixture(scope="module")
def ranks(reference, tmp_path_factory):
    return run_ranks(2, "cifar10_bn_scenario",
                     tmp_path_factory.mktemp("bn_mesh"), timeout=180,
                     flat=reference[0], batch=_batch(), steps=STEPS, lr=LR)


def test_dp2_batch_norm_matches_reference_spmd(reference, ranks):
    _, losses, params, stats = reference
    for out in ranks:
        np.testing.assert_allclose(out["losses"], losses, atol=1e-4,
                                   rtol=0)
        assert out["params"].keys() == params.keys()
        for name, value in params.items():
            np.testing.assert_allclose(out["params"][name], value.numpy(),
                                       rtol=2e-3, atol=2e-5, err_msg=name)
        assert out["batch_stats"].keys() == stats.keys()
        for name, value in stats.items():
            np.testing.assert_allclose(out["batch_stats"][name],
                                       value.numpy(), rtol=1e-4, atol=1e-5,
                                       err_msg=name)

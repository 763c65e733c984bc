"""The port's SPMD trainer (elasticdl_tpu_torch/parallel/
spmd_trainer.py) over 8 gloo ranks (tests/torch_ranks.py): the
scenarios of the reference's tests/test_spmd_trainer.py.

The mnist runs start from the weights of the reference's single-device
``JaxTrainer`` (carried across by ``params_from_flax``). With mnist's
dropout at rate 0 on both sides, the dp8 and dp4*fsdp2 runs are held
against that reference trainer's three steps on the same numpy batch,
run here. As mnist trains, with dropout, they are also held against the
port's single-card ``TorchTrainer``: the port's masks come from another
generator than flax's, and the SPMD trainer draws each mask over the
global batch and keeps its rows, as one card draws it. Tolerances are
the reference test's: losses within 1e-4 over 3 steps, parameters
within rtol 2e-3 / atol 2e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flax.linen as nn

from elasticdl_tpu.models import mnist as ref_mnist
from elasticdl_tpu.train import export as jax_export
from elasticdl_tpu.worker.trainer import JaxTrainer
from elasticdl_tpu_torch.models import mnist
from elasticdl_tpu_torch.worker.trainer import TorchTrainer
from tests.torch_ranks import run_ranks

torch.set_num_threads(1)


def _batch(seed=0, batch=32):
    rng = np.random.RandomState(seed)
    return {
        "features": rng.rand(batch, 28, 28).astype(np.float32),
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


def _ref_trainer():
    return JaxTrainer(model=ref_mnist.custom_model(), loss_fn=ref_mnist.loss,
                      optimizer=ref_mnist.optimizer(), seed=0, health=False)


@pytest.fixture(scope="module")
def flat():
    state = _ref_trainer().create_state(_batch()["features"])
    return jax_export._flatten({"params": jax.device_get(state.params)})


@pytest.fixture(scope="module")
def results(flat, tmp_path_factory):
    return run_ranks(8, "spmd_scenario", tmp_path_factory.mktemp("spmd"),
                     timeout=180, flat=flat, batch=_batch())


@pytest.fixture(scope="module")
def reference():
    """The reference's single-device JaxTrainer, 3 steps, dropout at
    rate 0: its losses and params by the port's names."""
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(ref_mnist, "nn", _NoDropout())
        trainer = _ref_trainer()
        state, losses = None, []
        for _ in range(3):
            state, loss = trainer.train_step(state, _batch())
            losses.append(float(loss))
    flat = jax_export._flatten({"params": jax.device_get(state.params)})
    return losses, {k: v.numpy() for k, v in
                    mnist.params_from_flax(flat).items()}


@pytest.fixture(scope="module")
def single(flat):
    """The port's single-card TorchTrainer, 3 steps, with dropout."""
    model = mnist.custom_model()
    model.load_state_dict(mnist.params_from_flax(flat), strict=True)
    trainer = TorchTrainer(model=model, loss_fn=mnist.loss,
                           optimizer=mnist.optimizer(), health=False,
                           device="cpu", seed=0)
    state, losses = None, []
    for _ in range(3):
        state, loss = trainer.train_step(state, _batch())
        losses.append(float(loss))
    return losses, {k: v.detach().numpy() for k, v in state.params.items()}


def _hold(out, key, expected):
    losses, params = expected
    np.testing.assert_allclose(out[key + "_losses"], losses, atol=1e-4,
                               rtol=0)
    got = out[key + "_params"]
    assert got.keys() == params.keys()
    for name, value in params.items():
        np.testing.assert_allclose(got[name], value, rtol=2e-3, atol=2e-4,
                                   err_msg=name)


@pytest.mark.parametrize("arm", ["dp8", "zero"])
def test_data_parallel_matches_single_device(results, reference, arm):
    for out in results:
        _hold(out, arm + "_plain", reference)


@pytest.mark.parametrize("arm", ["dp8", "zero"])
def test_data_parallel_dropout_matches_torch_trainer(results, single, arm):
    for out in results:
        _hold(out, arm + "_dropout", single)


def test_fsdp_shards_params_and_opt_state(results):
    for out in results:
        leaves = out["fsdp_leaves"]
        assert leaves, "no parameter picked up an fsdp sharding"
        for name, (local, full, mu, nu, spec) in leaves.items():
            # a block, never the whole leaf; the slots follow it
            assert np.prod(local) * 2 == np.prod(full), name
            assert mu == nu == local, name
            assert "fsdp" in spec, name
        np.testing.assert_allclose(out["norm_blocks"], out["norm_full"],
                                   rtol=1e-5)


def test_batch_not_divisible_raises(results):
    for out in results:
        assert "not divisible by data-parallel size 8" in out[
            "not_divisible"]


def test_sharded_init_never_materializes_full_state_per_rank(results):
    for out in results:
        mine, total = out["mlp_bytes"]
        assert mine < total / 3, (mine, total)
        local, whole = out["mlp_kernel"]
        assert local * 8 == whole
        assert out["mlp_losses"][-1] < out["mlp_losses"][0]

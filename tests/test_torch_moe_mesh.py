"""The port's MoE LM trained through its mesh (8 gloo ranks,
tests/torch_ranks.py) against the reference's single-device losses:
tests/test_moe.py's test_expert_parallel_matches_single_device
(dp2*tp2*ep2) and test_compact_dispatch_under_dp_mesh_matches_single_
device (dp8, compact dispatch). The reference trains here, on one
device, with xla attention; the port's ranks start from its weights
(``params_from_flax``) and run the default attention (the plain
versions of K4-K6 on the CPU) on each rank's own heads. Tolerances are
the reference tests': atol and rtol 1e-4 on the losses.
"""

import jax
import numpy as np
import pytest

from elasticdl_tpu.models import moe_transformer as ref_moe
from elasticdl_tpu.train import export as jax_export
from elasticdl_tpu.train.optimizers import create_optimizer
from elasticdl_tpu.train.step_fns import make_train_step
from elasticdl_tpu.train.train_state import create_train_state
from tests.torch_ranks import SMALL_MOE, run_ranks


def _batch(batch=4, seq=32, vocab=128, seed=0):
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, vocab, size=(batch, seq)).astype(np.int32)
    return {"features": tokens, "labels": tokens,
            "_mask": np.ones((batch,), np.float32)}


def _reference(batch, steps=3):
    """The reference's single-device run (tests/test_moe.py's
    _single_device_losses) and its initial weights, flat."""
    model = ref_moe.MoeTransformerLM(**SMALL_MOE, attention_impl="xla")
    tx = create_optimizer("Adam", learning_rate=0.01)
    init_rng, _ = jax.random.split(jax.random.PRNGKey(0))
    state = create_train_state(model, tx, init_rng, batch["features"])
    flat = jax_export._flatten(jax.device_get(state.params))
    step = jax.jit(make_train_step(model, ref_moe.loss, tx))
    losses = []
    for _ in range(steps):
        state, loss = step(state, batch)
        losses.append(float(loss))
    return flat, losses


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    batch, compact_batch = _batch(), _batch(batch=8)
    flat, want = _reference(batch)
    flat8, want8 = _reference(compact_batch)
    np.testing.assert_equal(flat, flat8)  # the init draws no batch rows
    results = run_ranks(8, "moe_mesh_scenario",
                        tmp_path_factory.mktemp("moe_mesh"), timeout=180,
                        flat=flat, batch=batch, compact_batch=compact_batch)
    return results, {"ep": want, "compact": want8}


@pytest.mark.parametrize("arm", ["ep", "compact"])
def test_mesh_matches_single_device_losses(runs, arm):
    results, want = runs
    for out in results:
        np.testing.assert_allclose(out[arm]["losses"], want[arm], atol=1e-4,
                                   rtol=1e-4)


def test_expert_and_tensor_parallel_blocks(runs):
    """At dp2*tp2*ep2 each rank holds its experts' (ep) and its FFN
    columns' (tp) block of w_up and w_down, its heads of q/k/v, and its
    vocabulary rows of wte and lm_head; the plan reduces every gradient
    over dp."""
    results, _ = runs
    shapes = results[0]["ep"]["shapes"]
    assert shapes["blocks.1.moe_mlp.w_up"] == (2, 32, 64)
    assert shapes["blocks.1.moe_mlp.w_down"] == (2, 64, 32)
    assert shapes["blocks.0.attn.query.weight"] == (16, 32)
    assert shapes["blocks.0.attn.out_proj.weight"] == (32, 16)
    assert shapes["blocks.0.mlp_up.weight"] == (64, 32)
    assert shapes["wte.weight"] == (64, 32)
    assert shapes["lm_head.weight"] == (64, 32)
    assert shapes["blocks.1.moe_mlp.router.weight"] == (4, 32)
    summary = results[0]["ep"]["summary"]
    assert summary["mesh_shape"] == "dp=2,tp=2,ep=2"
    # every gradient reduces over dp (the rules' fsdp entries count as
    # reduce-scatters of size 1, as the reference's plan counts them:
    # tests/test_torch_dense_plane.py holds the plans leaf by leaf)
    assert summary["local_params"] == 0
    assert summary["psum_params"] + summary["reduce_scatter_params"] == len(
        shapes)
    for out in results:
        assert out["ep"]["moved"] > 0 and out["compact"]["moved"] > 0

"""The port's TransformerLM trained over dp2*tp2*sp2 (8 gloo ranks,
tests/torch_ranks.py) with ring and with Ulysses attention against the
reference's single-device losses: tests/test_transformer_spmd.py's
test_spmd_tp_sp_matches_single_device. The reference trains on one
device with plain attention; the port's ranks start from its weights
(``params_from_flax``), each holding its rows, its heads (tp) and its
block of every sequence (sp). Rotary positions, the label shift across
the block boundary and the per-sample mean over the global S - 1
targets are what sp changes (models/transformer.py); the losses hold
them to the reference with the reference test's tolerance (atol and
rtol 1e-4). The first state's logits, gathered over sp by the trainer's
``eval_step``, hold to the reference's forward within 1e-4.
"""

import jax
import numpy as np
import pytest
import torch

from elasticdl_tpu.models import transformer as ref_transformer
from elasticdl_tpu.train import export as jax_export
from elasticdl_tpu.train.optimizers import create_optimizer
from elasticdl_tpu.train.step_fns import make_train_step
from elasticdl_tpu.train.train_state import create_train_state
from elasticdl_tpu_torch.models import transformer as port
from elasticdl_tpu_torch.parallel.mesh import MeshConfig, abstract_mesh
from tests.torch_ranks import run_ranks
from tests.torch_ranks_longctx import SMALL_LM

STEPS = 3


def _batch(batch=4, seq=32, vocab=128, seed=0):
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, vocab, size=(batch, seq)).astype(np.int32)
    return {"features": tokens, "labels": tokens,
            "_mask": np.ones((batch,), np.float32)}


def _reference(batch):
    """The reference test's single-device run: its initial weights
    (flat), their logits and the losses of STEPS Adam steps."""
    model = ref_transformer.TransformerLM(**SMALL_LM, attention_impl="xla")
    tx = create_optimizer("Adam", learning_rate=0.01)
    init_rng, _ = jax.random.split(jax.random.PRNGKey(0))
    state = create_train_state(model, tx, init_rng, batch["features"])
    flat = jax_export._flatten(jax.device_get(state.params))
    logits = np.asarray(model.apply({"params": state.params},
                                    batch["features"]))
    step = jax.jit(make_train_step(model, ref_transformer.loss, tx))
    losses = []
    for _ in range(STEPS):
        state, loss = step(state, batch)
        losses.append(float(loss))
    return flat, logits, losses


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    batch = _batch()
    flat, logits, losses = _reference(batch)
    results = run_ranks(8, "tests.torch_ranks_longctx:transformer_sp_"
                        "scenario", tmp_path_factory.mktemp("lm_sp"),
                        timeout=180, flat=flat, batch=batch, steps=STEPS)
    return results, logits, losses


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_spmd_tp_sp_matches_single_device(runs, impl):
    results, _, want = runs
    for out in results:
        np.testing.assert_allclose(out[impl]["losses"], want, atol=1e-4,
                                   rtol=1e-4)


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_sp_eval_logits_match_reference(runs, impl):
    """Every rank's eval logits: the whole batch's, each rank computing
    its block of the sequence and gathering the blocks over sp."""
    results, logits, _ = runs
    for out in results:
        np.testing.assert_allclose(out[impl]["logits"], logits, atol=1e-4,
                                   rtol=1e-4)


def test_sp_ranks_hold_their_heads(runs):
    """At dp2*tp2*sp2 a rank holds its two heads of q/k/v (tp) and every
    parameter whole over sp: the sequence splits, the weights do not."""
    results, _, _ = runs
    shapes = results[0]["ring"]["shapes"]
    assert shapes["blocks.0.attn.query.weight"] == (16, 32)
    assert shapes["blocks.0.attn.out_proj.weight"] == (32, 16)
    assert shapes["wte.weight"] == (64, 32)
    assert shapes["ln_f.weight"] == (32,)
    assert sorted(out["sp_index"] for out in results) == [0] * 4 + [1] * 4


def test_rotary_offset_is_the_global_position():
    """A block's rotary positions start at its offset: rotating the
    second half of a sequence with offset S/2 gives the whole sequence's
    second half."""
    x = torch.from_numpy(np.random.RandomState(3).normal(
        size=(2, 3, 16, 64)).astype(np.float32))
    whole = port.rotary_embedding(x)
    half = port.rotary_embedding(x[:, :, 8:], offset=8)
    torch.testing.assert_close(half, whole[:, :, 8:], rtol=0, atol=0)


@pytest.mark.parametrize("impl", ["auto", "xla", "flash"])
def test_sp_needs_a_sequence_parallel_attention(impl):
    """Over sp > 1 each rank holds a block of the sequence: an attention
    that is not ring or Ulysses would attend within the block, so the
    model refuses it."""
    mesh = abstract_mesh(MeshConfig(sp=2), 2)
    with pytest.raises(ValueError, match="ring' or 'ulysses"):
        port.TransformerLM(**SMALL_LM, attention_impl=impl, mesh=mesh)


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_flash_remat_refuses_sequence_parallel_attention(impl):
    """remat_policy="flash" saves the flash op's outputs, which the ring
    and Ulysses do not produce: refused, as the reference refuses every
    attention but "auto" and "pallas" (models/transformer.py:188-205)."""
    with pytest.raises(ValueError, match="flash"):
        port.TransformerLM(**SMALL_LM, attention_impl=impl, remat=True,
                           remat_policy="flash")
    with pytest.raises(ValueError, match="flash"):
        ref_transformer.TransformerLM(
            **SMALL_LM, attention_impl=impl, remat=True,
            remat_policy="flash").init(jax.random.PRNGKey(0),
                                       np.zeros((1, 8), np.int32))

"""Remat and dropout on the port's TransformerLM (models/transformer.py,
models/layers.py), on the flash path: K4's custom op and K5/K6's plain
versions on the CPU.

Mirrors tests/test_transformer_spmd.py's ``test_remat_policies_match_
no_remat`` and ``test_remat_policy_validated``, and counts the forward
kernel's calls per policy: once a layer under no remat, "dots" and
"flash" (their policies save K4's (o, lse)), twice under "full" (the
recompute runs it again); the backward's once a layer under every
policy. Remat recomputes the same ops on the same inputs, so its loss
and gradients equal no remat's to the reference test's tolerances
(loss 1e-6 relative; gradients 1e-5 relative, 1e-7 absolute).
"""

import numpy as np
import pytest
import torch

from elasticdl_tpu_torch.models import layers, mnist, transformer
from elasticdl_tpu_torch.models.registry import get_model_spec
from elasticdl_tpu_torch.ops import flash_attention as flash
from elasticdl_tpu_torch.train import optimizers as port_opt
from elasticdl_tpu_torch.train import step_fns
from elasticdl_tpu_torch.train.train_state import create_train_state

torch.set_num_threads(1)

LAYERS = 3
WIDTHS = dict(vocab_size=64, num_layers=LAYERS, num_heads=2, embed_dim=64)


@pytest.fixture
def counted(monkeypatch):
    """Count the plain K4 and K5/K6 calls (the CPU path launches nothing;
    the custom op and the Function look both up on the module)."""
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = flash.flash_attention_fwd, flash.flash_attention_bwd

    def counted_fwd(*args, **kwargs):
        calls["fwd"] += 1
        return fwd(*args, **kwargs)

    def counted_bwd(*args, **kwargs):
        calls["bwd"] += 1
        return bwd(*args, **kwargs)

    monkeypatch.setattr(flash, "flash_attention_fwd", counted_fwd)
    monkeypatch.setattr(flash, "flash_attention_bwd", counted_bwd)
    return calls


def _tokens(seed=1, batch=2, seq=16):
    return torch.from_numpy(np.random.RandomState(seed).randint(
        0, WIDTHS["vocab_size"], (batch, seq)))


def _model(remat=False, policy="full", dropout=0.0, seed=0):
    torch.manual_seed(seed)
    return transformer.TransformerLM(remat=remat, remat_policy=policy,
                                     dropout=dropout, **WIDTHS)


def _loss_and_grads(model, tokens):
    loss = transformer.loss(tokens, model(tokens)).mean()
    grads = torch.autograd.grad(loss, list(model.parameters()))
    return float(loss), [g.numpy() for g in grads]


@pytest.mark.parametrize("policy", ["full", "dots", "flash"])
def test_remat_policies_match_no_remat(policy, counted):
    tokens = _tokens()
    v0, g0 = _loss_and_grads(_model(), tokens)
    assert counted == {"fwd": LAYERS, "bwd": LAYERS}
    counted.update(fwd=0, bwd=0)
    v1, g1 = _loss_and_grads(_model(True, policy), tokens)
    # K4 once a layer, but twice under "full"; K5/K6 once a layer
    assert counted == {"fwd": LAYERS * (2 if policy == "full" else 1),
                       "bwd": LAYERS}
    assert np.isclose(v0, v1, rtol=1e-6)
    for a, b in zip(g0, g1):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7)


def test_remat_policy_validated():
    with pytest.raises(ValueError, match="remat_policy"):
        transformer.TransformerLM(remat=True, remat_policy="Dots",
                                  attention_impl="xla", **WIDTHS)
    # "flash" saves the flash kernel's outputs; under xla attention it
    # would match nothing and silently run as "full"
    with pytest.raises(ValueError, match="flash"):
        transformer.TransformerLM(remat=True, remat_policy="flash",
                                  attention_impl="xla", **WIDTHS)
    # without remat the policy is not read, as in the reference
    transformer.TransformerLM(remat=False, remat_policy="Dots", **WIDTHS)


def test_dots_policy_saves_the_projections(monkeypatch):
    """"dots" saves every projection's matmul (6 a block) and K4's op;
    "flash" only K4's op."""
    from torch.utils import checkpoint as ckpt

    decisions = []
    real = ckpt.create_selective_checkpoint_contexts

    def spy(policy_fn, *args, **kwargs):
        def wrapped(ctx, op, *a, **k):
            result = policy_fn(ctx, op, *a, **k)
            if not ctx.is_recompute:
                decisions.append((str(op), result))
            return result
        return real(wrapped, *args, **kwargs)

    monkeypatch.setattr(ckpt, "create_selective_checkpoint_contexts", spy)
    tokens = _tokens()
    for policy, saved in (("dots", 6 * LAYERS + LAYERS), ("flash", LAYERS)):
        decisions.clear()
        _loss_and_grads(_model(True, policy), tokens)
        kept = [op for op, d in decisions
                if d == ckpt.CheckpointPolicy.MUST_SAVE]
        assert len(kept) == saved, (policy, kept)
        assert kept.count("edl.flash_attention_fwd.default") == LAYERS


def test_train_step_launch_counts_per_policy(counted):
    """The K4 contract through make_train_step (the path chip_smoke's
    phase 15 counts on the card): per step, K4 L, L, L and 2L under no
    remat, "dots", "flash" and "full"; K5/K6 L under each."""
    batch = {"features": _tokens(seed=2, batch=4), "labels": None,
             "_mask": torch.ones(4)}
    batch["labels"] = batch["features"]
    for remat, policy, fwd in ((False, "full", 1), (True, "dots", 1),
                               (True, "flash", 1), (True, "full", 2)):
        model = _model(remat, policy)
        tx = port_opt.create_optimizer("AdamW", learning_rate=1e-3)
        step = step_fns.make_train_step(model, transformer.loss, tx)
        state = create_train_state(model, tx)
        counted.update(fwd=0, bwd=0)
        step(state, batch)
        assert counted == {"fwd": fwd * LAYERS, "bwd": LAYERS}, policy


def _dropout_step(model, seed_step, tokens):
    """The train step's loss and gradients at ``step``."""
    tx = port_opt.create_optimizer("SGD", learning_rate=0.0)
    state = create_train_state(model, tx)
    state.step = seed_step
    batch = {"features": tokens, "labels": tokens,
             "_mask": torch.ones(tokens.shape[0])}
    return step_fns.make_loss_and_grads(model, transformer.loss)(state,
                                                                 batch)


def test_dropout_is_deterministic_per_step_and_off_in_eval():
    tokens = _tokens(batch=4)
    model = _model(dropout=0.1)
    a_loss, a_grads = _dropout_step(model, 5, tokens)
    b_loss, b_grads = _dropout_step(model, 5, tokens)
    c_loss, _ = _dropout_step(model, 6, tokens)
    plain_loss, _ = _dropout_step(_model(), 5, tokens)
    assert float(a_loss) == float(b_loss)
    for name in a_grads:
        torch.testing.assert_close(a_grads[name], b_grads[name], rtol=0,
                                   atol=0)
    assert float(a_loss) != float(c_loss)
    assert float(a_loss) != float(plain_loss)
    # eval mode: no dropout, the same outputs as a dropout-free model
    out = step_fns.make_eval_step(model)(create_train_state(
        model, port_opt.create_optimizer("SGD")), tokens)
    plain = _model()
    plain.eval()
    with torch.no_grad():
        torch.testing.assert_close(out, plain(tokens), rtol=0, atol=0)


def test_dropout_needs_a_seed_in_training_mode():
    model = _model(dropout=0.1)
    model.train()
    with pytest.raises(RuntimeError, match="seed"):
        model(_tokens())
    model.eval()
    model(_tokens())


def test_dropout_keeps_one_minus_rate_and_rescales():
    drop = layers.Dropout(0.25).train()
    x = torch.ones(200, 500)
    with layers.dropout_seed(drop, layers.dropout_key(3)):
        y = drop(x)
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.75) < 0.01
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / 0.75))
    with layers.dropout_seed(drop, layers.dropout_key(3)):
        torch.testing.assert_close(drop(x), y, rtol=0, atol=0)
    with layers.dropout_seed(drop, layers.dropout_key(3, 1)):
        assert not torch.equal(drop(x), y)
    assert drop.seed is None  # the seed does not outlive the block


@pytest.mark.parametrize("policy", ["full", "dots", "flash"])
def test_dropout_under_remat_equals_no_remat(policy):
    """The recompute redraws the forward's masks: remat with dropout
    gives no remat's loss and gradients."""
    tokens = _tokens(batch=4)
    loss0, g0 = _dropout_step(_model(dropout=0.1), 7, tokens)
    loss1, g1 = _dropout_step(_model(True, policy, dropout=0.1), 7, tokens)
    assert np.isclose(float(loss0), float(loss1), rtol=1e-6)
    for name in g0:
        np.testing.assert_allclose(g1[name].numpy(), g0[name].numpy(),
                                   rtol=1e-5, atol=1e-7, err_msg=name)


def test_accum_with_dropout_still_trains():
    """tests/test_grad_accum.py::test_accum_with_dropout_still_trains on
    the port: per-microbatch masks differ from single-shot, but the
    step runs and learns."""
    rng = np.random.RandomState(0)
    features = torch.from_numpy(rng.rand(32, 8, 8).astype(np.float32))
    batch = {"features": features,
             "labels": torch.from_numpy(rng.randint(0, 4, 32)),
             "_mask": torch.ones(32)}
    torch.manual_seed(0)
    model = mnist.custom_model()
    tx = port_opt.create_optimizer("Adam", learning_rate=0.01)
    from elasticdl_tpu_torch.worker.trainer import TorchTrainer

    state = TorchTrainer(model, mnist.loss, tx, health=False,
                         device="cpu").create_state(features)
    step = step_fns.make_train_step(model, mnist.loss, tx,
                                    grad_accum_steps=4)
    losses = []
    for _ in range(5):
        state, loss = step(state, batch)
        losses.append(float(loss))
    assert np.isfinite(losses[-1]) and losses[-1] < losses[0]


def test_zoo_contract_takes_dropout_and_remat():
    spec = get_model_spec(
        "elasticdl_tpu_torch.models.transformer",
        model_params="vocab_size=64;num_layers=2;num_heads=2;embed_dim=64;"
                     "dropout=0.1;remat=True;remat_policy='flash'")
    model = spec.custom_model()
    assert model.remat and model.remat_policy == "flash"
    assert [m.rate for m in model.modules()
            if isinstance(m, layers.Dropout)] == [0.1] * 4


@pytest.mark.parametrize("policy", ["full", "dots", "flash"])
def test_remat_under_bf16_compute_matches_no_remat(policy, counted):
    """Under bf16 compute the step hands the model bf16 casts of its
    weights through functional_call; the recompute runs in the backward,
    after those are swapped out, and must use them all the same: its
    gradients equal no remat's, and K4 launches as the policy says."""
    tokens = _tokens(batch=4)
    batch = {"features": tokens, "labels": tokens, "_mask": torch.ones(4)}
    grads = {}
    for remat in (False, True):
        model = _model(remat, policy)
        state = create_train_state(model, port_opt.create_optimizer("SGD"))
        counted.update(fwd=0, bwd=0)
        loss, grads[remat] = step_fns.make_loss_and_grads(
            model, transformer.loss, compute_dtype=torch.bfloat16)(state,
                                                                   batch)
        fwd = LAYERS * (2 if remat and policy == "full" else 1)
        assert counted == {"fwd": fwd, "bwd": LAYERS}
    for name in grads[False]:
        np.testing.assert_allclose(grads[True][name].numpy(),
                                   grads[False][name].numpy(), rtol=1e-5,
                                   atol=1e-7, err_msg=name)

"""The port's MoE routing and MoE LM against the JAX package's.

Routing (one-hot and compact), the compact gathers and their gather-only
backwards, and the whole MoeTransformerLM are fed the same numpy inputs
on both sides. The scenarios of tests/test_moe.py that run on one
device are mirrored on the port; its two mesh tests
(``test_expert_parallel_matches_single_device``,
``test_compact_dispatch_under_dp_mesh_matches_single_device``) wait for
the port of ``parallel/``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticdl_tpu.models import moe_transformer as jax_moe_lm
from elasticdl_tpu.ops import moe as jax_moe
from elasticdl_tpu.train import export as jax_export
from elasticdl_tpu_torch.data import pipeline
from elasticdl_tpu_torch.data.example import encode_example
from elasticdl_tpu_torch.models import moe_transformer as port_lm
from elasticdl_tpu_torch.models.registry import get_model_spec
from elasticdl_tpu_torch.ops import moe as port_moe
from elasticdl_tpu_torch.train.optimizers import create_optimizer
from elasticdl_tpu_torch.train.step_fns import make_train_step
from elasticdl_tpu_torch.train.train_state import create_train_state

# the suite runs in several worker processes at once: one intra-op
# thread per process keeps these small-shape tests from oversubscribing
# the host's cores under other files' timing-sensitive tests
torch.set_num_threads(1)

# routing's float outputs (combine weights, gates, aux) come from an
# fp32 softmax on both sides: libm's exp differs by an ulp or so, and
# the renormalized gates by a few ulps of 1 (1.2e-7 each)
ROUTE_ATOL = 1e-6
# the compact gathers move rows and multiply by gates: the same fp32
# products on both sides, summed over k = 2 ranks
GATHER_ATOL = 1e-6
# one-hot einsums: fp32 contractions over E*C = up to 128 terms in
# another order than XLA's
EINSUM_ATOL = 1e-5
# the whole LM in float64 but for the fp32 routing softmax and the fp32
# rotary angles both sides keep: their ulps (6e-8 relative) reach the
# loss and the gradients; a wrong route or a wrong leaf moves them by
# percents
LM_RTOL = 1e-5


def _j(a):
    return jnp.asarray(a)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _logits(kind, g=2, s=16, e=4, seed=0):
    rng = np.random.RandomState(seed)
    if kind == "random":
        return rng.randn(g, s, e).astype(np.float32)
    if kind == "collapsed":
        # every token's first choice expert 0; experts 1-3 tie
        logits = np.zeros((g, s, e), np.float32)
        logits[..., 0] = 3.0
        return logits
    if kind == "ties":
        # whole-number logits over 3 values: most tokens tie two or
        # more experts, at both ranks
        return rng.randint(0, 3, size=(g, s, e)).astype(np.float32)
    raise ValueError(kind)


@pytest.mark.parametrize("seq,experts,k,factor", [
    (64, 8, 2, 1.0), (4, 8, 1, 1.25), (1024, 8, 2, 1.25), (32, 4, 2, 2.0),
    (17, 3, 1, 0.5), (1, 8, 2, 1.25),
])
def test_expert_capacity_matches_reference(seq, experts, k, factor):
    assert port_moe.expert_capacity(seq, experts, k, factor) == (
        jax_moe.expert_capacity(seq, experts, k, factor))


def test_expert_capacity_static():
    """tests/test_moe.py::test_expert_capacity_static on the port; bench
    .py's MoE (S 1024, 8 experts, top-2, 1.25) gets 320 slots."""
    assert port_moe.expert_capacity(64, 8, k=2, capacity_factor=1.0) == 16
    assert port_moe.expert_capacity(4, 8, k=1, capacity_factor=1.25) == 1
    assert port_moe.expert_capacity(1024, 8, k=2, capacity_factor=1.25) == 320


ROUTING_CASES = [
    # (logits, k, capacity): ample, dropping, ties, collapsed
    ("random", 2, 32), ("random", 1, 16), ("random", 2, 3),
    ("random", 1, 2), ("ties", 2, 32), ("ties", 2, 4), ("ties", 1, 3),
    ("collapsed", 2, 8), ("collapsed", 2, 3), ("collapsed", 1, 5),
]


@pytest.mark.parametrize("kind,k,capacity", ROUTING_CASES)
def test_onehot_routing_matches_reference(kind, k, capacity):
    """Dispatch bit-equal (which tokens are dropped, which slot each
    kept one takes), combine and aux within ROUTE_ATOL."""
    logits = _logits(kind)
    combine, dispatch, aux = jax_moe.top_k_routing(_j(logits), k, capacity)
    p_combine, p_dispatch, p_aux = port_moe.top_k_routing(_t(logits), k,
                                                          capacity)
    assert p_dispatch.dtype == torch.bool
    np.testing.assert_array_equal(_np(p_dispatch), np.asarray(dispatch))
    assert p_combine.dtype == torch.float32
    np.testing.assert_allclose(_np(p_combine), np.asarray(combine),
                               rtol=0, atol=ROUTE_ATOL)
    assert abs(float(p_aux) - float(aux)) <= ROUTE_ATOL


@pytest.mark.parametrize("kind,k,capacity", ROUTING_CASES)
def test_compact_routing_matches_reference(kind, k, capacity):
    """Slot ids bit-equal (dropped tokens at E*C), gates and aux within
    ROUTE_ATOL; the inverted index bit-equal too."""
    logits = _logits(kind)
    e = logits.shape[-1]
    gates, slot, aux = jax_moe.top_k_routing_compact(_j(logits), k, capacity)
    p_gates, p_slot, p_aux = port_moe.top_k_routing_compact(
        _t(logits), k, capacity)
    np.testing.assert_array_equal(_np(p_slot), np.asarray(slot))
    np.testing.assert_allclose(_np(p_gates), np.asarray(gates), rtol=0,
                               atol=ROUTE_ATOL)
    assert abs(float(p_aux) - float(aux)) <= ROUTE_ATOL
    np.testing.assert_array_equal(
        _np(port_moe.invert_slots(p_slot, e * capacity)),
        np.asarray(jax_moe.invert_slots(slot, e * capacity)))


def test_ties_take_the_lower_expert_first():
    """jax.lax.top_k's order among equal probabilities: the collapsed
    logits' second choice is expert 1 for every token, on both sides."""
    logits = _logits("collapsed")
    _, slot, _ = port_moe.top_k_routing_compact(_t(logits), 2, 64)
    second = _np(slot)[:, 16:] // 64
    assert (second == 1).all()
    _, j_slot, _ = jax_moe.top_k_routing_compact(_j(logits), 2, 64)
    assert (np.asarray(j_slot)[:, 16:] // 64 == 1).all()


def test_top1_routing_matches_argmax():
    logits = np.random.RandomState(0).randn(2, 16, 4).astype(np.float32)
    combine, dispatch, aux = port_moe.top_k_routing(_t(logits), k=1,
                                                    capacity=16)
    chosen = _np(dispatch.sum(dim=-1).int().argmax(dim=-1))
    np.testing.assert_array_equal(chosen, logits.argmax(axis=-1))
    np.testing.assert_allclose(_np(combine.sum(dim=(2, 3))), 1.0, atol=1e-6)
    assert float(aux) > 0


def test_capacity_drops_overflow_tokens():
    """All 8 tokens pick expert 0; capacity 3 keeps the first 3, and
    each (expert, slot) holds at most one token."""
    logits = torch.tensor([[10.0, 0.0, 0.0, 0.0]]).repeat(8, 1)[None]
    combine, dispatch, _ = port_moe.top_k_routing(logits, k=1, capacity=3)
    per_token = _np(dispatch.sum(dim=(2, 3)))
    assert per_token[0, :3].sum() == 3 and per_token[0, 3:].sum() == 0
    assert _np(dispatch.sum(dim=1)).max() == 1


def _compact_inputs(capacity, g=2, s=16, e=4, m=6, k=2, seed=7):
    rng = np.random.RandomState(seed)
    x = rng.randn(g, s, m).astype(np.float32)
    logits = rng.randn(g, s, e).astype(np.float32)
    w = rng.randn(e, m, m).astype(np.float32)
    dy = rng.randn(g, s, m).astype(np.float32)
    return x, logits, w, dy


@pytest.mark.parametrize("capacity", [3, 32])
def test_compact_gathers_match_reference_custom_vjps(capacity):
    """The compact dispatch and combine, forward and gradients (x, the
    expert outputs, the gates), against jax.grad through the
    reference's custom VJPs on the same slots. capacity 3 drops tokens;
    32 = S*k drops none."""
    x, logits, w, dy = _compact_inputs(capacity)
    e, k = logits.shape[-1], 2
    gates, slot, _ = jax_moe.top_k_routing_compact(_j(logits), k, capacity)
    eo = np.random.RandomState(3).randn(
        e, x.shape[0], capacity, x.shape[2]).astype(np.float32)

    def jax_f(x, eo, gates):
        expert_in = jax_moe.moe_dispatch_compact(x, slot, e, capacity)
        y = jax_moe.moe_combine_compact(eo, slot, gates)
        return (expert_in * 0.5).sum() + (y * _j(dy)).sum(), (expert_in, y)

    (_, (j_in, j_y)), j_grads = jax.value_and_grad(
        jax_f, argnums=(0, 1, 2), has_aux=True)(_j(x), _j(eo), gates)

    px, peo, pgates = (_t(a).clone().requires_grad_()
                       for a in (x, eo, np.asarray(gates)))
    pslot = _t(np.asarray(slot)).long()
    p_in = port_moe.moe_dispatch_compact(px, pslot, e, capacity)
    p_y = port_moe.moe_combine_compact(peo, pslot, pgates)
    ((p_in * 0.5).sum() + (p_y * _t(dy)).sum()).backward()
    np.testing.assert_array_equal(_np(p_in), np.asarray(j_in))
    np.testing.assert_allclose(_np(p_y), np.asarray(j_y), rtol=0,
                               atol=GATHER_ATOL)
    for got, want in zip((px.grad, peo.grad, pgates.grad), j_grads):
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0,
                                   atol=GATHER_ATOL)


def test_compact_backwards_are_gathers():
    """The compact path's backward runs no scatter: autograd's node for
    each gather is the port's own Function, not GatherBackward
    (whose backward is a scatter-add)."""
    x, logits, w, dy = _compact_inputs(3)
    gates, slot, _ = port_moe.top_k_routing_compact(_t(logits), 2, 3)
    px = _t(x).requires_grad_()
    expert_in = port_moe.moe_dispatch_compact(px, slot, 4, 3)
    y = port_moe.moe_combine_compact(expert_in * 2.0, slot, gates)
    names, seen, stack = set(), set(), [y.grad_fn]
    while stack:
        node = stack.pop()
        if node is None or id(node) in seen:
            continue
        seen.add(id(node))
        names.add(type(node).__name__)
        stack.extend(n for n, _ in node.next_functions)
    assert "_DispatchGatherBackward" in names
    assert "_CombineGatherBackward" in names
    assert not any(n.startswith("GatherBackward") for n in names), names


@pytest.mark.parametrize("capacity", [3, 32])
def test_onehot_dispatch_combine_match_reference(capacity):
    """moe_dispatch / moe_combine on the reference's routing tensors:
    forward and gradients (x, expert outputs, combine) against
    jax.grad."""
    x, logits, w, dy = _compact_inputs(capacity, seed=11)
    combine, dispatch, _ = jax_moe.top_k_routing(_j(logits), 2, capacity)
    eo = np.random.RandomState(5).randn(
        4, x.shape[0], capacity, x.shape[2]).astype(np.float32)

    def jax_f(x, eo, combine):
        expert_in = jax_moe.moe_dispatch(x, dispatch)
        y = jax_moe.moe_combine(eo, combine)
        return (expert_in * 0.5).sum() + (y * _j(dy)).sum(), (expert_in, y)

    (_, (j_in, j_y)), j_grads = jax.value_and_grad(
        jax_f, argnums=(0, 1, 2), has_aux=True)(_j(x), _j(eo), combine)
    px, peo, pcombine = (_t(a).clone().requires_grad_()
                         for a in (x, eo, np.asarray(combine)))
    p_in = port_moe.moe_dispatch(px, _t(np.asarray(dispatch)))
    p_y = port_moe.moe_combine(peo, pcombine)
    ((p_in * 0.5).sum() + (p_y * _t(dy)).sum()).backward()
    np.testing.assert_allclose(_np(p_in), np.asarray(j_in), rtol=0,
                               atol=EINSUM_ATOL)
    np.testing.assert_allclose(_np(p_y), np.asarray(j_y), rtol=0,
                               atol=EINSUM_ATOL)
    for got, want in zip((px.grad, peo.grad, pcombine.grad), j_grads):
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0,
                                   atol=EINSUM_ATOL)


def test_dispatch_combine_matches_bruteforce():
    """tests/test_moe.py's brute force on the port: per token, the
    gate-weighted sum of its top-k experts' outputs."""
    rng = np.random.RandomState(1)
    g, s, e, m, k = 2, 8, 4, 6, 2
    x = rng.randn(g, s, m).astype(np.float32)
    logits = rng.randn(g, s, e).astype(np.float32)
    w = rng.randn(e, m, m).astype(np.float32)
    combine, dispatch, _ = port_moe.top_k_routing(_t(logits), k, s * k)
    expert_out = torch.einsum("egcm,emn->egcn",
                              port_moe.moe_dispatch(_t(x), dispatch), _t(w))
    y = _np(port_moe.moe_combine(expert_out, combine))
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    expected = np.zeros((g, s, m), np.float32)
    for gi in range(g):
        for si in range(s):
            top = np.argsort(-probs[gi, si], kind="stable")[:k]
            weights = probs[gi, si, top] / probs[gi, si, top].sum()
            for ei, wt in zip(top, weights):
                expected[gi, si] += wt * (x[gi, si] @ w[ei])
    np.testing.assert_allclose(y, expected, atol=1e-4)


@pytest.mark.parametrize("capacity", [3, 32])
def test_compact_dispatch_matches_onehot(capacity):
    """tests/test_moe.py::test_compact_dispatch_matches_onehot on the
    port: outputs and gradients (x and the router logits), with and
    without dropped tokens."""
    x, logits, w, _ = _compact_inputs(capacity)
    k, e = 2, logits.shape[-1]

    def run(compact):
        px = _t(x).clone().requires_grad_()
        pl = _t(logits).clone().requires_grad_()
        if compact:
            gates, slot, aux = port_moe.top_k_routing_compact(pl, k, capacity)
            eo = torch.einsum("egcm,emn->egcn", port_moe.moe_dispatch_compact(
                px, slot, e, capacity), _t(w))
            y = port_moe.moe_combine_compact(eo, slot, gates)
        else:
            combine, dispatch, aux = port_moe.top_k_routing(pl, k, capacity)
            eo = torch.einsum("egcm,emn->egcn",
                              port_moe.moe_dispatch(px, dispatch), _t(w))
            y = port_moe.moe_combine(eo, combine)
        ((y ** 2).sum() + aux).backward()
        return _np(y), aux.item(), _np(px.grad), _np(pl.grad)

    y1, aux1, gx1, gl1 = run(False)
    y2, aux2, gx2, gl2 = run(True)
    np.testing.assert_allclose(y1, y2, atol=1e-5)
    assert abs(aux1 - aux2) <= 1e-6 * abs(aux1)
    np.testing.assert_allclose(gx1, gx2, atol=1e-4)
    np.testing.assert_allclose(gl1, gl2, atol=1e-4)


def test_aux_loss_gradient_pushes_toward_uniform():
    """At a collapsed router (every first choice expert 0, experts 1-3
    tied), d(aux)/d(logits) is positive on expert 0 and negative on the
    rest, and equals jax.grad of the reference's aux within
    ROUTE_ATOL."""
    logits = _logits("collapsed", g=2, s=16, e=4)

    def jax_aux(lg):
        return jax_moe.top_k_routing(lg, k=2, capacity=8)[2]

    want = np.asarray(jax.grad(jax_aux)(_j(logits)))
    pl = _t(logits).requires_grad_()
    port_moe.top_k_routing(pl, k=2, capacity=8)[2].backward()
    got = _np(pl.grad)
    assert float(got[..., 0].mean()) > 0
    assert float(got[..., 1:].mean()) < 0
    np.testing.assert_allclose(got, want, rtol=0, atol=ROUTE_ATOL)


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------

SMALL = dict(vocab_size=128, num_layers=2, num_heads=4, embed_dim=32,
             num_experts=4, top_k=2, capacity_factor=2.0)


def _batch(batch=4, seq=32, vocab=128, seed=0):
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, vocab, size=(batch, seq)).astype(np.int32)
    return {"features": tokens, "labels": tokens,
            "_mask": np.ones((batch,), np.float32)}


@pytest.fixture(scope="module")
def flax_small():
    """The reference's _small_moe at its init, and the same weights in
    the port's names."""
    model = jax_moe_lm.MoeTransformerLM(attention_impl="xla", **SMALL)
    tokens = _batch()["features"]
    params = model.init(jax.random.PRNGKey(0), _j(tokens))["params"]
    flat = jax_export._flatten(jax.device_get(params))
    return model, params, flat


def _port_small(flat, **kwargs):
    model = port_lm.MoeTransformerLM(attention_impl="xla", **SMALL, **kwargs)
    model.load_state_dict(port_lm.params_from_flax(flat), strict=True)
    return model


def test_flax_names_cross_both_ways(flax_small):
    """Every flax leaf of the reference's model has a place in the port
    (strict load above), and ``flax_params`` gives the same names and
    values back."""
    _, _, flat = flax_small
    model = _port_small(flat)
    back = model.flax_params(model.state_dict())
    assert set(back) == set(flat)
    assert "block_1/moe_mlp/router/kernel" in back
    assert back["block_1/moe_mlp/w_up"].shape == (4, 32, 128)
    assert back["block_1/moe_mlp/w_down"].shape == (4, 128, 32)
    for name, value in flat.items():
        np.testing.assert_array_equal(back[name], value)


def test_eval_logits_match_flax_fp32(flax_small):
    model, params, flat = flax_small
    tokens = _batch()["features"]
    want = np.asarray(model.apply({"params": params}, _j(tokens),
                                  training=False))
    pmodel = _port_small(flat).eval()
    with torch.no_grad():
        got = pmodel(_t(tokens))
    assert isinstance(got, torch.Tensor) and got.shape == (4, 32, 128)
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=5e-5)


def test_moe_eval_returns_bare_logits(flax_small):
    _, _, flat = flax_small
    model = _port_small(flat)
    tokens = _t(_batch()["features"])
    with torch.no_grad():
        assert model.eval()(tokens).shape == (4, 32, 128)
        out = model.train()(tokens)
    assert set(out) == {"logits", "aux_loss"}
    assert out["aux_loss"].dtype == torch.float32 and out["aux_loss"].dim() == 0


@pytest.mark.parametrize("impl", ["onehot", "compact"])
def test_moe_lm_loss_and_grads_match_flax_float64(flax_small, impl):
    """The whole model in float64 on both sides (routing's softmax stays
    fp32 on both, as the reference casts it): the training loss, aux
    included, and every parameter's gradient within LM_RTOL of the
    largest gradient entry."""
    model, params, flat = flax_small
    batch = _batch()
    tokens, labels = batch["features"], batch["labels"]
    jmodel = jax_moe_lm.MoeTransformerLM(attention_impl="xla",
                                         dispatch_impl=impl, **SMALL)
    with jax.enable_x64(True):
        wide = jax.tree_util.tree_map(lambda v: np.asarray(v, np.float64),
                                      params)

        def jax_loss(p):
            out = jmodel.apply({"params": p}, _j(tokens), training=True,
                               rngs={"dropout": jax.random.PRNGKey(1)})
            return jax_moe_lm.loss(_j(labels), out).mean(), out["aux_loss"]

        (j_loss, j_aux), j_grads = jax.value_and_grad(
            jax_loss, has_aux=True)(wide)
        j_loss, j_aux = float(j_loss), float(j_aux)
        j_grads = jax_export._flatten(jax.device_get(j_grads))
    pmodel = _port_small(flat, dispatch_impl=impl).double().train()
    out = pmodel(_t(tokens))
    p_loss = port_lm.loss(_t(labels), out).mean()
    p_loss.backward()
    assert abs(out["aux_loss"].item() - j_aux) <= LM_RTOL * abs(j_aux)
    assert abs(float(p_loss) - j_loss) <= LM_RTOL * abs(j_loss)
    p_grads = pmodel.flax_params(
        {n: p.grad for n, p in pmodel.named_parameters()})
    assert set(p_grads) == set(j_grads)
    scale = max(float(np.abs(g).max()) for g in j_grads.values())
    for name, want in j_grads.items():
        err = float(np.abs(p_grads[name] - want).max())
        assert err <= LM_RTOL * scale, (name, err, scale)


def test_moe_lm_compact_matches_onehot_losses(flax_small):
    """tests/test_moe.py::test_moe_lm_compact_matches_onehot_losses on
    the port: three Adam steps through make_train_step from the same
    weights, losses within rtol 1e-4."""
    _, _, flat = flax_small
    batch = {k: _t(v) for k, v in _batch().items()}
    losses = {}
    for impl in ("onehot", "compact"):
        model = _port_small(flat, dispatch_impl=impl)
        tx = create_optimizer("Adam", learning_rate=0.01)
        step = make_train_step(model, port_lm.loss, tx)
        state = create_train_state(model, tx)
        arm = []
        for _ in range(3):
            state, loss = step(state, batch)
            arm.append(float(loss))
        losses[impl] = arm
    assert losses["onehot"][2] < losses["onehot"][0]
    np.testing.assert_allclose(losses["compact"], losses["onehot"],
                               rtol=1e-4)


def test_loss_promotes_as_the_reference():
    """bf16 per-sample losses plus the fp32 aux come out fp32 (the
    reference's ``bf16 + f32`` array promotion); bare logits stay in
    their dtype and add nothing."""
    rng = np.random.RandomState(0)
    logits = rng.randn(2, 8, 16).astype(np.float32)
    labels = rng.randint(0, 16, size=(2, 8)).astype(np.int32)
    aux = np.float32(0.25)
    want = np.asarray(jax_moe_lm.loss(
        _j(labels), {"logits": _j(logits).astype(jnp.bfloat16),
                     "aux_loss": _j(aux)}))
    got = port_lm.loss(_t(labels), {"logits": _t(logits).bfloat16(),
                                    "aux_loss": torch.tensor(aux)})
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=0.02)
    bare = port_lm.loss(_t(labels), _t(logits).bfloat16())
    assert bare.dtype == torch.bfloat16


def test_unknown_dispatch_impl_raises():
    with pytest.raises(ValueError, match="dispatch_impl"):
        port_lm.MoeMlp(16, 4, dispatch_impl="gather")


def test_model_contract_loads():
    """The zoo contract through the port's registry: the reference's
    custom_model widths, AdamW, the token dataset_fn and the loss over
    the training outputs."""
    spec = get_model_spec("elasticdl_tpu_torch.models.moe_transformer")
    spec.require_training()
    with torch.device("meta"):  # the widths only: no 300M draws here
        model = spec.custom_model()
    assert isinstance(model, port_lm.MoeTransformerLM)
    assert len(model.blocks) == 12 and model.num_heads == 12
    assert model.wte.weight.shape == (32000, 768)
    assert model.blocks[1].moe_mlp.w_up.shape == (8, 768, 3072)
    assert isinstance(model.blocks[0], port_lm.Block)
    small = get_model_spec("elasticdl_tpu_torch.models.moe_transformer",
                           model_params="vocab_size=64;num_layers=2;"
                                        "num_heads=2;embed_dim=16;"
                                        "num_experts=2;attention_impl='xla'")
    net = small.custom_model().train()
    tokens = np.arange(12, dtype=np.int32).reshape(1, 12) % 64
    records = [encode_example({"tokens": tokens[0]})]
    examples = list(spec.dataset_fn(pipeline.Dataset.from_list(records)))
    np.testing.assert_array_equal(examples[0][0], tokens[0])
    np.testing.assert_array_equal(examples[0][1], tokens[0])
    out = net(_t(tokens))
    per_sample = small.loss(_t(tokens), out)
    assert per_sample.shape == (1,) and bool(torch.isfinite(per_sample).all())
    assert set(small.eval_metrics_fn()) == {"accuracy"}
    assert small.optimizer() is not None

"""The port's default attention at seq_q != seq_k against the reference.

q holds another number of positions than k and v; under the causal
mask query row i sees keys j <= i, both counted from 0 (the reference's
``_causal_mask`` and ``xla_attention``). On the CPU the port's
``dot_product_attention`` ("auto": ``FlashAttention``, the plain
versions of K4-K6) is held, forward and gradients, against the
reference's ``dot_product_attention`` ("auto", plain on the CPU) and
against its Pallas kernels in interpret mode (``flash_attention(...,
interpret=True)`` with blocks that divide both lengths). Inputs come
from a numpy seed. The kernels themselves run only on the card:
tests/test_torch_cuda_kernels.py holds K4-K6 against these plain
versions there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticdl_tpu.ops import attention as jax_attention
from elasticdl_tpu.ops import flash_attention as jax_flash
from elasticdl_tpu_torch.ops import attention as port_attention
from elasticdl_tpu_torch.ops import flash_attention as port_flash

torch.set_num_threads(1)

# fp32: the same function up to summation order (blockwise online
# softmax against a full softmax), a few fp32 ulps of O(1) values: the
# repo's flash-vs-xla tolerance (tests/test_attention_ops.py). The
# gradients sum seq_q or seq_k products a row: 1e-4.
F32_TOL = {"o": 2e-5, "grad": 1e-4}
# bf16: both sides cast p to bf16 before the PV product and the
# gradients round to bf16 once; the rounding points of the two programs
# differ by an ulp of O(1) values (2^-8 = 0.004), so 2e-2 as the kernel
# checks use (chip_smoke.O_TOL).
BF16_TOL = {"o": 2e-2, "grad": 3e-2}

# (seq_q, seq_k): fewer queries than keys (the causal mask leaves keys
# past seq_q unseen: their dk and dv are zero), more queries than keys
# (rows past seq_k see every key), ragged against each other
SHAPES = [(48, 160), (160, 48), (1, 37), (37, 1), (96, 96 + 33)]


def _inputs(seq_q, seq_k, dim=32, batch=2, heads=2, seed=0):
    rng = np.random.RandomState(seed)
    q = rng.normal(size=(batch, heads, seq_q, dim)).astype(np.float32)
    k, v = (rng.normal(size=(batch, heads, seq_k, dim)).astype(np.float32)
            for _ in range(2))
    do = rng.normal(size=q.shape).astype(np.float32)
    return q, k, v, do


def _port(q, k, v, do, causal, dtype):
    tq, tk, tv = (torch.from_numpy(a).to(dtype).requires_grad_()
                  for a in (q, k, v))
    o = port_attention.dot_product_attention(tq, tk, tv, causal=causal)
    o.backward(torch.from_numpy(do).to(dtype))
    return [t.detach().float().numpy() for t in (o, tq.grad, tk.grad,
                                                 tv.grad)]


def _reference(fn, q, k, v, do, dtype):
    jq, jk, jv = (jnp.asarray(a).astype(dtype) for a in (q, k, v))
    o, vjp = jax.vjp(fn, jq, jk, jv)
    grads = vjp(jnp.asarray(do).astype(dtype))
    return [np.asarray(t.astype(jnp.float32)) for t in (o, *grads)]


def _hold(got, want, tol):
    for name, g, w in zip(("o", "dq", "dk", "dv"), got, want):
        assert g.shape == w.shape, name
        kind = "o" if name == "o" else "grad"
        scale = max(1.0, float(np.abs(w).max(initial=0.0)))
        np.testing.assert_allclose(g, w, atol=tol[kind] * scale,
                                   rtol=tol[kind], err_msg=name)


@pytest.mark.parametrize("seq_q,seq_k", SHAPES)
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_default_attention_matches_reference_auto(dtype, causal, seq_q,
                                                  seq_k):
    q, k, v, do = _inputs(seq_q, seq_k)
    want = _reference(
        lambda a, b, c: jax_attention.dot_product_attention(
            a, b, c, causal=causal), q, k, v, do, getattr(jnp, dtype))
    got = _port(q, k, v, do, causal, getattr(torch, dtype))
    _hold(got, want, F32_TOL if dtype == "float32" else BF16_TOL)


# blocks dividing both lengths, several blocks on each side
@pytest.mark.parametrize("seq_q,seq_k,block", [(64, 192, 32), (192, 64, 32),
                                               (128, 64, 64)])
@pytest.mark.parametrize("causal", [False, True])
def test_default_attention_matches_pallas_interpret(causal, seq_q, seq_k,
                                                    block):
    q, k, v, do = _inputs(seq_q, seq_k, seed=1)
    want = _reference(
        lambda a, b, c: jax_flash.flash_attention(
            a, b, c, causal=causal, block_q=block, block_k=block,
            interpret=True), q, k, v, do, jnp.float32)
    got = _port(q, k, v, do, causal, torch.float32)
    _hold(got, want, F32_TOL)


def test_unseen_keys_get_zero_gradients():
    """Under the causal mask keys at or past seq_q are seen by no query:
    their dk and dv are exactly zero, as the reference's."""
    q, k, v, do = _inputs(40, 100, seed=2)
    _, _, dk, dv = _port(q, k, v, do, True, torch.float32)
    assert not dk[:, :, 40:].any() and not dv[:, :, 40:].any()
    assert np.abs(dk[:, :, :40]).max() > 0 and np.abs(dv[:, :, :40]).max() > 0


def test_wrappers_take_unequal_lengths_and_check_them():
    q, k, v, do = (torch.from_numpy(a).flatten(0, 1)
                   for a in _inputs(24, 56, seed=3))
    o, lse = port_flash.flash_attention_fwd(q, k, v, causal=True)
    assert o.shape == q.shape and lse.shape == (4, 1, 24)
    dq, dk, dv = port_flash.flash_attention_bwd(q, k, v, o, lse, do,
                                                causal=True)
    assert dq.shape == q.shape and dk.shape == k.shape == dv.shape
    # k and v must agree with each other, and heads and width with q
    for bad in ((q, k, v[:, :50]), (q, k[:2], v[:2]), (q, k[..., :16],
                                                       v[..., :16])):
        with pytest.raises(ValueError):
            port_flash.flash_attention_fwd(*bad)
    with pytest.raises(ValueError):
        port_flash.flash_attention_bwd(q, k, v, o, lse, do[:, :20])


def test_no_keys_matches_the_reference():
    """seq_k 0: the reference's "auto" gives o = 0; the port's plain
    version too, with lse -inf and zero gradients."""
    q, k, v, do = _inputs(8, 0, seed=4)
    want = _reference(
        lambda a, b, c: jax_attention.dot_product_attention(a, b, c),
        q, k, v, do, jnp.float32)
    got = _port(q, k, v, do, False, torch.float32)
    _hold(got, want, F32_TOL)
    _, lse = port_flash.flash_attention_fwd(
        *(torch.from_numpy(a).flatten(0, 1) for a in (q, k, v)))
    assert bool(torch.isneginf(lse).all())


def test_chip_smoke_bound_counts_unequal_lengths():
    """chip_smoke.bound counts sum over query rows i < seq_q of min(i +
    1, seq_k) causal pairs, and each tensor at its own length."""
    import chip_smoke

    assert chip_smoke.causal_pairs(3, 5) == 1 + 2 + 3
    assert chip_smoke.causal_pairs(5, 3) == 1 + 2 + 3 + 3 + 3
    assert chip_smoke.causal_pairs(7, 7) == 7 * 8 // 2
    # equal lengths: what the single-length bound counted
    for kernel in ("fwd", "dq", "dkv"):
        assert (chip_smoke.bound(16, 1000, 64, "bfloat16", True, kernel)
                == chip_smoke.bound(16, 1000, 64, "bfloat16", True, kernel,
                                    seq_k=1000))
    # fp32 K4 non-causal at seq_q 520, seq_k 1000, d 128, bh 16: 2
    # products over 520 000 pairs, q and o at 520 rows, k and v at 1000,
    # lse at 520
    ms, by = chip_smoke.bound(16, 520, 128, "float32", False, "fwd", 1000)
    flops = 2.0 * 2 * 16 * 128 * 520 * 1000
    nbytes = (2 * 520 + 2 * 1000) * 16 * 128 * 4 + 4.0 * 16 * 520
    assert by == "operations"
    assert ms == pytest.approx(max(flops / 67e12, nbytes / 3.35e12) * 1e3)
    for case in chip_smoke.UNEQUAL_CASES:
        name, bh, seq_q, seq_k, dim, dtype, causal = case
        assert chip_smoke.case_lengths(case) == case and seq_q != seq_k

"""Port's flash-attention backward (K5 dq, K6 dk/dv) and its autograd
Function against the JAX reference.

On the CPU the port's wrapper runs the plain versions of K5 and K6; they
are held against the JAX package's Pallas ``_bwd`` in interpret mode,
and ``FlashAttention``'s gradients against ``jax.grad`` through the JAX
``flash_attention`` (interpret mode, as tests/test_attention_ops.py
runs it). The CUDA kernels themselves run only on the card:
tests/test_torch_cuda_kernels.py compares them with the plain versions
there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticdl_tpu.ops import flash_attention as jax_flash
from elasticdl_tpu_torch.ops import attention as port_attention
from elasticdl_tpu_torch.ops import flash_attention as port_flash

# the suite runs in several worker processes at once: one intra-op
# thread per process keeps these small-shape tests from oversubscribing
# the host's cores under other files' timing-sensitive tests
torch.set_num_threads(1)

# fp32 on both sides, same arithmetic up to summation order (blockwise
# over 64/128-row tiles vs one full product): a few fp32 ulps of the
# O(1)-O(10) gradients. 2e-5 is the repo's flash-vs-xla figure
# (tests/test_attention_ops.py); gradients sum over up to 256 rows, so
# the relative part carries it on the larger entries.
GRAD_TOL = 2e-5
# gradients through a whole attention (autograd over softmax vs the
# kernels' p / ds algebra): the repo's own flash-vs-xla gradient
# tolerance, tests/test_attention_ops.py::test_flash_grads_match_xla.
AUTOGRAD_TOL = 3e-4


def _arrays(bh=4, seq=256, dim=64, seed=0, n=4):
    rng = np.random.RandomState(seed)
    return [
        (rng.normal(size=(bh, seq, dim)) * 0.5).astype(np.float32)
        for _ in range(n)
    ]


@pytest.mark.parametrize("blocks", [(64, 64), (128, 128), (64, 128)])
@pytest.mark.parametrize("dim", [64, 128, 256])
@pytest.mark.parametrize("causal", [False, True])
def test_plain_bwd_matches_jax_pallas_interpret(causal, dim, blocks):
    q, k, v, do = _arrays(dim=dim)
    scale = 1.0 / np.sqrt(dim)
    jq, jk, jv, jdo = (jnp.asarray(a) for a in (q, k, v, do))
    jo, jlse = jax_flash._fwd(jq, jk, jv, scale, causal, 128, 128, True)
    expected = jax_flash._bwd(jq, jk, jv, jo, jlse, jdo, scale, causal,
                              blocks[0], blocks[1], True)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    o, lse = port_flash.flash_attention_fwd(tq, tk, tv, causal=causal)
    before = (port_flash.DQ_LAUNCHES, port_flash.DKV_LAUNCHES)
    got = port_flash.flash_attention_bwd(tq, tk, tv, o, lse, tdo,
                                         causal=causal)
    # CPU tensors take the plain version: no kernel launch is counted
    assert (port_flash.DQ_LAUNCHES, port_flash.DKV_LAUNCHES) == before
    for name, g, e in zip(("dq", "dk", "dv"), got, expected):
        assert g.dtype == torch.float32 and g.shape == q.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(e), atol=GRAD_TOL,
                                   rtol=GRAD_TOL, err_msg=name)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_grads_match_jax_grad(causal):
    """FlashAttention (forward K4, backward K5/K6 plain versions here)
    against jax.grad of the JAX flash_attention, on (B, H, S, d)."""
    rng = np.random.RandomState(3)
    q, k, v = (rng.normal(size=(2, 2, 128, 64)).astype(np.float32)
               for _ in range(3))

    def loss_jax(q, k, v):
        out = jax_flash.flash_attention(q, k, v, causal=causal, block_q=64,
                                        block_k=64, interpret=True)
        return jnp.sum(out * jnp.cos(out))

    expected = jax.grad(loss_jax, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = port_flash.flash_attention(*leaves, causal=causal)
    got = torch.autograd.grad(torch.sum(out * torch.cos(out)), leaves)
    for g, e in zip(got, expected):
        np.testing.assert_allclose(g.numpy(), np.asarray(e),
                                   atol=AUTOGRAD_TOL, rtol=AUTOGRAD_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_dot_product_attention_has_flash_grad_fn(causal):
    """The detached-gradient repair: under autograd the flash path's
    output carries FlashAttention's grad_fn, and its gradients equal
    autograd through the plain attention (fp32, AUTOGRAD_TOL), with
    the transposed output gradient the model hands over."""
    rng = np.random.RandomState(4)
    arrays = [rng.normal(size=(2, 3, 96, 64)).astype(np.float32)
              for _ in range(3)]
    weight = torch.from_numpy(
        rng.normal(size=(2, 96, 3, 64)).astype(np.float32))
    leaves = [torch.from_numpy(a).requires_grad_() for a in arrays]
    out = port_attention.dot_product_attention(*leaves, causal=causal)
    assert isinstance(out.grad_fn, port_flash.FlashAttention._backward_cls)
    got = torch.autograd.grad((out.transpose(1, 2) * weight).sum(), leaves)
    plain = port_attention.xla_attention(*leaves, causal=causal)
    expected = torch.autograd.grad(
        (plain.transpose(1, 2) * weight).sum(), leaves)
    for g, e in zip(got, expected):
        assert g.shape == e.shape
        torch.testing.assert_close(g, e, atol=AUTOGRAD_TOL,
                                   rtol=AUTOGRAD_TOL)


def test_ragged_seq_grads_match_plain_attention():
    """S = 200 divides by no block size; the port takes it (the TPU
    kernel does not) and its gradients equal autograd through the
    port's xla_attention."""
    rng = np.random.RandomState(5)
    leaves = [torch.from_numpy(
        rng.normal(size=(1, 2, 200, 128)).astype(np.float32)
    ).requires_grad_() for _ in range(3)]
    out = port_flash.flash_attention(*leaves, causal=True)
    got = torch.autograd.grad(torch.sum(out * torch.sin(out)), leaves)
    plain = port_attention.xla_attention(*leaves, causal=True)
    expected = torch.autograd.grad(torch.sum(plain * torch.sin(plain)),
                                   leaves)
    for g, e in zip(got, expected):
        torch.testing.assert_close(g, e, atol=AUTOGRAD_TOL,
                                   rtol=AUTOGRAD_TOL)


def test_inference_mode_runs_the_forward_only():
    """Serving runs under inference_mode: the Function is a plain
    forward there, with the same output as under autograd."""
    q, k, v = (torch.from_numpy(a).view(2, 2, 256, 64)
               for a in _arrays(n=3))
    with torch.inference_mode():
        served = port_attention.dot_product_attention(q, k, v, causal=True)
    assert served.grad_fn is None
    trained = port_attention.dot_product_attention(
        q.clone().requires_grad_(), k, v, causal=True)
    torch.testing.assert_close(served, trained.detach(), atol=0, rtol=0)


def test_bwd_wrapper_rejects_mismatched_and_foreign_inputs():
    q = torch.zeros(2, 8, 64)
    lse = torch.zeros(2, 1, 8)
    with pytest.raises(ValueError):
        port_flash.flash_attention_bwd(q, torch.zeros(2, 9, 64), q, q, lse, q)
    meta = torch.zeros(2, 8, 64, device="meta")
    with pytest.raises(ValueError):
        port_flash.flash_attention_bwd(meta, meta, meta, meta,
                                       torch.zeros(2, 1, 8, device="meta"),
                                       meta)
    with pytest.raises(ValueError):
        port_flash.flash_attention(q, q, q)  # 3-D: not (B, H, S, d)


def _late_tile_off(grads, p, ds, k, q, do):
    dq, dk, dv = (g.clone() for g in grads)
    dv[:, -64:] *= 1.1
    return dq, dk, dv


def _late_tile_zeroed(grads, p, ds, k, q, do):
    dq, dk, dv = (g.clone() for g in grads)
    dv[:, 14 * 64:15 * 64] = 0
    return dq, dk, dv


def _diagonal_tiles_skipped(grads, p, ds, k, q, do):
    """K5 and K6 skipping the diagonal tile of every block past the
    ninth, computed through the plain version's casts."""
    keep = torch.ones(p.shape[-1], p.shape[-1])
    for t in range(9, p.shape[-1] // 64):
        keep[t * 64:(t + 1) * 64, t * 64:(t + 1) * 64] = 0
    ds, p = (ds * keep).to(q.dtype).float(), (p * keep).to(q.dtype).float()
    return ((ds @ k.float()).to(q.dtype),
            (ds.transpose(1, 2) @ q.float()).to(q.dtype),
            (p.transpose(1, 2) @ do.float()).to(q.dtype))


def _sound_tiled(grads, p, ds, k, q, do):
    """What a right kernel computes: the same casts, fp32 sums taken
    tile by tile over 64 rows in another order than one product."""
    def tiled(a, b):
        acc = torch.zeros(b.shape[0], a.shape[1], b.shape[-1])
        for t in range(0, a.shape[-1], 64):
            acc += a[..., t:t + 64] @ b[:, t:t + 64].float()
        return acc.to(q.dtype)

    ds16, p16 = ds.to(q.dtype).float(), p.to(q.dtype).float()
    return (tiled(ds16, k), tiled(ds16.transpose(1, 2), q),
            tiled(p16.transpose(1, 2), do))


@pytest.mark.parametrize("fault", [None, _late_tile_off, _late_tile_zeroed,
                                   _diagonal_tiles_skipped])
def test_chip_smoke_row_rule_sees_planted_faults(fault):
    """chip_smoke.py's K5/K6 check at the main shape's sequence (bf16,
    causal, S 1024, d 64): a right kernel (the plain version summed tile
    by tile) passes it, and each planted fault fails it. The rule the
    check replaced (max error within 2e-2 of the tensor's largest entry)
    misses the last tile of dv 10% off: under the causal mask late rows
    are ~1/sqrt(S) the size of the first."""
    import chip_smoke

    gen = torch.Generator().manual_seed(1)
    q, k, v, do = (torch.randn(2, 1024, 64, generator=gen).bfloat16()
                   for _ in range(4))
    o, lse = port_flash.flash_attention_fwd_reference(q, k, v, True)
    refs = port_flash.flash_attention_bwd_reference(q, k, v, o, lse, do, True)
    p, ds = port_flash._probs_and_ds(q, k, v, o, lse, do, True, None)
    rtol = chip_smoke.GRAD_ROW_RTOL["bfloat16"]
    got = (_sound_tiled if fault is None else fault)(refs, p, ds, k, q, do)
    errs = [chip_smoke.worst_row_error(g, r, 64)[0]
            for g, r in zip(got, refs)]
    if fault is None:
        assert max(errs) <= rtol / 4, errs
    else:
        assert max(errs) > rtol, errs
    if fault is _late_tile_off:
        old = [(g.float() - r.float()).abs().max() / r.float().abs().max()
               for g, r in zip(got, refs)]
        assert max(old) < 2e-2

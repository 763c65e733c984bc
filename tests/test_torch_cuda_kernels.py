"""The port's CUDA kernels on the card, against their plain versions.

These tests need an NVIDIA GPU and nvcc: they carry the ``cuda`` marker
and skip without a card. The file imports neither JAX nor the JAX
package, so it also runs on a machine that has only PyTorch (the
repo's tests/conftest.py imports JAX, hence ``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda_kernels.py
"""

import pytest
import torch

import chip_smoke
from elasticdl_tpu_torch.ops import attention
from elasticdl_tpu_torch.ops import flash_attention as flash

pytestmark = pytest.mark.cuda

# bf16: p and o round to bf16 at other points than in the plain version
# (one bf16 ulp of O(1) values is 2^-8); fp32: summation order only
O_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
LSE_TOL = 1e-3


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _qkv(card, bh, seq, dim, dtype, seed=0):
    gen = torch.Generator(device=card).manual_seed(seed)
    return [
        torch.randn(bh, seq, dim, device=card, generator=gen).to(dtype)
        for _ in range(3)
    ]


@pytest.mark.parametrize("seq", [1, 63, 200, 256])
@pytest.mark.parametrize("dim", [64, 128])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_fwd_matches_plain_version(card, dtype, causal, dim, seq):
    q, k, v = _qkv(card, 6, seq, dim, dtype)
    before = flash.LAUNCHES
    o, lse = flash.flash_attention_fwd(q, k, v, causal=causal)
    ro, rlse = flash.flash_attention_fwd_reference(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash.LAUNCHES == before + 1
    assert o.dtype == dtype and lse.shape == (6, 1, seq)
    tol = O_TOL[dtype]
    torch.testing.assert_close(o.float(), ro.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(lse, rlse, atol=LSE_TOL, rtol=1e-5)


def test_flash_fwd_rejects_what_the_kernel_does_not_take(card):
    q, k, v = _qkv(card, 2, 64, 96, torch.bfloat16)  # head_dim 96
    with pytest.raises(ValueError):
        flash.flash_attention_fwd(q, k, v)
    q, k, v = _qkv(card, 2, 64, 64, torch.float16)
    with pytest.raises(ValueError):
        flash.flash_attention_fwd(q, k, v)
    q, k, v = _qkv(card, 2, 64, 128, torch.bfloat16)
    strided = q[..., :64]  # not contiguous
    with pytest.raises(ValueError):
        flash.flash_attention_fwd(strided, k[..., :64], v[..., :64])


@pytest.mark.parametrize("seq", [1, 63, 200, 256])
@pytest.mark.parametrize("dim", [64, 128])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_bwd_matches_plain_version(card, dtype, causal, dim, seq):
    q, k, v = _qkv(card, 6, seq, dim, dtype)
    (do,) = _qkv(card, 6, seq, dim, dtype, seed=1)[:1]
    o, lse = flash.flash_attention_fwd_reference(q, k, v, causal=causal)
    before = (flash.DQ_LAUNCHES, flash.DKV_LAUNCHES)
    grads = flash.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    refs = flash.flash_attention_bwd_reference(q, k, v, o, lse, do,
                                               causal=causal)
    torch.cuda.synchronize()
    assert (flash.DQ_LAUNCHES, flash.DKV_LAUNCHES) == (before[0] + 1,
                                                       before[1] + 1)
    for name, got, ref in zip(("dq", "dk", "dv"), grads, refs):
        assert got.dtype == dtype and got.shape == q.shape, name
        # chip_smoke.py's row rule: each row's error against its own size
        err, _ = chip_smoke.worst_row_error(got, ref, dim)
        assert err <= chip_smoke.GRAD_ROW_RTOL[str(dtype)[6:]], (name, err)
        if dtype == torch.float32:
            torch.testing.assert_close(got, ref, atol=1e-4, rtol=1e-4)


def test_flash_bwd_rejects_what_the_kernel_does_not_take(card):
    def args(dim, dtype):
        q, k, v = _qkv(card, 2, 64, dim, dtype)
        lse = torch.zeros(2, 1, 64, device=card)
        return q, k, v, q, lse, v

    with pytest.raises(ValueError):
        flash.flash_attention_bwd(*args(96, torch.bfloat16))
    with pytest.raises(ValueError):
        flash.flash_attention_bwd(*args(64, torch.float16))
    q, k, v, o, lse, do = args(128, torch.bfloat16)
    strided = [t[..., :64] for t in (q, k, v, o, do)]  # not contiguous
    with pytest.raises(ValueError):
        flash.flash_attention_bwd(*strided[:4], lse, strided[4])


def test_flash_attention_grads_match_plain_attention(card):
    """FlashAttention's gradient (K5, K6) against autograd through the
    plain attention, both in fp32 on the card, with a non-contiguous
    output gradient as the model hands it over."""
    gen = torch.Generator(device=card).manual_seed(2)
    shape = (2, 3, 200, 64)
    leaves = [torch.randn(shape, device=card, generator=gen).requires_grad_()
              for _ in range(3)]
    weight = torch.randn(2, 200, 3, 64, device=card, generator=gen)
    before = (flash.LAUNCHES, flash.DQ_LAUNCHES, flash.DKV_LAUNCHES)
    out = attention.dot_product_attention(*leaves, causal=True)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    loss = (out.transpose(1, 2) * weight).sum()
    got = torch.autograd.grad(loss, leaves)
    plain = attention.xla_attention(*leaves, causal=True)
    expected = torch.autograd.grad(
        (plain.transpose(1, 2) * weight).sum(), leaves)
    torch.cuda.synchronize()
    assert (flash.LAUNCHES, flash.DQ_LAUNCHES, flash.DKV_LAUNCHES) == tuple(
        n + 1 for n in before)
    for a, b in zip(got, expected):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


def test_trainer_step_launches_the_kernels(card):
    """One bf16 TorchTrainer step at a small width: K4, K5 and K6 once
    per layer each, and a finite loss."""
    import numpy as np

    from elasticdl_tpu_torch.models import transformer
    from elasticdl_tpu_torch.train.optimizers import create_optimizer
    from elasticdl_tpu_torch.worker.trainer import TorchTrainer

    torch.manual_seed(0)
    model = transformer.TransformerLM(vocab_size=256, num_layers=2,
                                      num_heads=2, embed_dim=128)
    trainer = TorchTrainer(
        model, transformer.loss,
        create_optimizer("AdamW", learning_rate=1e-3),
        compute_dtype="bfloat16", health=False, device="cuda",
    )
    tokens = np.random.RandomState(0).randint(0, 256, size=(4, 128))
    batch = {"features": tokens.astype(np.int32),
             "labels": tokens.astype(np.int32),
             "_mask": np.ones(4, np.float32)}
    before = (flash.LAUNCHES, flash.DQ_LAUNCHES, flash.DKV_LAUNCHES)
    state, loss = trainer.train_step(None, batch)
    torch.cuda.synchronize()
    assert (flash.LAUNCHES, flash.DQ_LAUNCHES, flash.DKV_LAUNCHES) == tuple(
        n + 2 for n in before)
    assert state.step == 1 and bool(torch.isfinite(loss))


def test_auto_dispatch_launches_the_kernel_on_the_card(card):
    q, k, v = (t.view(2, 3, 128, 64) for t in _qkv(card, 6, 128, 64,
                                                    torch.bfloat16))
    before = flash.LAUNCHES
    out = attention.dot_product_attention(q, k, v, causal=True)
    assert flash.LAUNCHES == before + 1
    plain = attention.xla_attention(q, k, v, causal=True)
    torch.testing.assert_close(out.float(), plain.float(), atol=2e-2,
                               rtol=2e-2)
    # a head_dim the kernel does not take raises: the plain attention
    # runs on the card only when asked for by name
    q96 = torch.randn(2, 3, 128, 96, device=card, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        attention.dot_product_attention(q96, q96, q96, causal=True)
    attention.dot_product_attention(q96, q96, q96, causal=True, impl="xla")
    assert flash.LAUNCHES == before + 1

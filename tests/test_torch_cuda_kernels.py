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

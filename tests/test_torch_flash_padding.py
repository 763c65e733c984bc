"""Head dims the flash kernels are not built for go through them padded.

The kernels K4-K6 are built for head_dim 64, 128 and 256; the wrappers
zero-pad any other head_dim up to 256 to the next of those
(``kernel_head_dim``, ``pad_head_dim``), pass the true head_dim's
scale, and slice the outputs back. Here, on the CPU, the plain versions
on padded inputs equal the plain versions on the unpadded ones: o, lse,
dq, dk and dv, and the padded columns of o, dq, dk and dv are zeros.
The kernels themselves run padded on the card in
tests/test_torch_cuda_kernels.py and chip_smoke.py.
"""

import math

import numpy as np
import pytest
import torch

from elasticdl_tpu_torch.ops import flash_attention as flash

# the suite runs in several worker processes at once: one intra-op
# thread per process keeps these small-shape tests from oversubscribing
# the host's cores under other files' timing-sensitive tests
torch.set_num_threads(1)

# fp32 on both sides: the zero columns add exact zeros to every dot
# product, so the two differ only where the matmuls block the longer
# inner dimension in another order, a few fp32 ulps of O(1) values
TOL = 1e-6


@pytest.mark.parametrize("head_dim, width", [
    (1, 64), (32, 64), (64, 64), (65, 128), (96, 128), (128, 128),
    (129, 256), (200, 256), (256, 256),
])
def test_kernel_head_dim_is_the_next_instantiation(head_dim, width):
    assert flash.kernel_head_dim(head_dim) == width


@pytest.mark.parametrize("head_dim", [257, 320, 512])
def test_kernel_head_dim_refuses_over_256(head_dim):
    with pytest.raises(ValueError, match="up to 256"):
        flash.kernel_head_dim(head_dim)


def test_pad_head_dim_appends_zero_columns():
    t = torch.arange(24, dtype=torch.float32).reshape(2, 3, 4)
    assert flash.pad_head_dim(t, 4) is t
    padded = flash.pad_head_dim(t[..., :3], 8)
    assert padded.shape == (2, 3, 8) and padded.is_contiguous()
    assert torch.equal(padded[..., :3], t[..., :3])
    assert not padded[..., 3:].any()


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("head_dim", [32, 96, 200])
def test_padded_plain_versions_equal_the_unpadded(head_dim, causal):
    rng = np.random.RandomState(head_dim)
    q, k, v, do = (torch.from_numpy(
        (rng.normal(size=(3, 70, head_dim)) * 0.5).astype(np.float32))
        for _ in range(4))
    scale = 1.0 / math.sqrt(head_dim)
    width = flash.kernel_head_dim(head_dim)
    pq, pk, pv, pdo = (flash.pad_head_dim(t, width) for t in (q, k, v, do))

    o, lse = flash.flash_attention_fwd_reference(q, k, v, causal, scale)
    po, plse = flash.flash_attention_fwd_reference(pq, pk, pv, causal, scale)
    assert po.shape[-1] == width and not po[..., head_dim:].any()
    torch.testing.assert_close(po[..., :head_dim], o, atol=TOL, rtol=TOL)
    torch.testing.assert_close(plse, lse, atol=TOL, rtol=TOL)

    grads = flash.flash_attention_bwd_reference(q, k, v, o, lse, do, causal,
                                                scale)
    padded = flash.flash_attention_bwd_reference(
        pq, pk, pv, flash.pad_head_dim(o, width), lse, pdo, causal, scale)
    for name, got, expected in zip(("dq", "dk", "dv"), padded, grads):
        assert got.shape[-1] == width, name
        assert not got[..., head_dim:].any(), name
        torch.testing.assert_close(got[..., :head_dim], expected, atol=TOL,
                                   rtol=TOL, msg=name)


def test_cpu_wrappers_run_any_head_dim_unpadded():
    """The plain versions take every head_dim on the CPU (the padding
    is the kernels' route): head_dim 320 runs, with no launch counted."""
    q = torch.randn(2, 16, 320)
    before = (flash.LAUNCHES, flash.DQ_LAUNCHES, flash.DKV_LAUNCHES)
    o, lse = flash.flash_attention_fwd(q, q, q, causal=True)
    grads = flash.flash_attention_bwd(q, q, q, o, lse, q, causal=True)
    assert o.shape == q.shape and all(g.shape == q.shape for g in grads)
    assert (flash.LAUNCHES, flash.DQ_LAUNCHES, flash.DKV_LAUNCHES) == before

"""Flash-attention forward (K4): the CUDA kernel's wrapper and its plain
PyTorch version.

Port of elasticdl_tpu/ops/flash_attention.py ``_fwd`` (the Pallas
``_fwd_kernel``): ``(o, lse)`` of causal or full softmax attention over
merged ``(batch * heads, seq, head_dim)`` inputs. The kernel source is
``ops/csrc/flash_fwd.cu``; its note gives the bound at the serving
shape.

``flash_attention_fwd`` launches the kernel for CUDA tensors and raises
on anything the kernel does not take. It runs the plain version only
for CPU tensors. ``LAUNCHES`` counts kernel launches, so a run can show
that its path went through the kernel.
"""

import math
import threading

import torch

NEG_INF = -1e30

LAUNCHES = 0
_launch_lock = threading.Lock()

KERNEL_HEAD_DIMS = (64, 128)
KERNEL_DTYPES = (torch.bfloat16, torch.float32)


def _check_shapes(q, k, v):
    if q.dim() != 3 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(
            "q, k, v must share one (batch*heads, seq, head_dim) shape; "
            "got %s, %s, %s" % (tuple(q.shape), tuple(k.shape), tuple(v.shape))
        )


def flash_attention_fwd_reference(q, k, v, causal=False, sm_scale=None):
    """Plain version: full scores, the same -1e30 mask and dtype casts.

    Scores are taken in fp32 (for bf16 inputs the products are exact in
    fp32, as in the kernel's fp32 accumulation), p is cast to the input
    dtype before the PV product, and lse = logsumexp of the masked
    scores, ``(bh, 1, seq)`` fp32.
    """
    _check_shapes(q, k, v)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    if causal:
        seq = q.shape[1]
        pos = torch.arange(seq, device=q.device)
        s = torch.where(pos[:, None] >= pos[None, :], s, NEG_INF)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.matmul(p, v).to(q.dtype), lse.unsqueeze(1)


def flash_attention_fwd(q, k, v, causal=False, sm_scale=None):
    """``(o, lse)``: o like q, lse ``(bh, 1, seq)`` fp32.

    CUDA tensors go to the kernel, which takes contiguous bf16 or fp32
    inputs with head_dim 64 or 128; anything else raises. CPU tensors
    go to ``flash_attention_fwd_reference``.
    """
    global LAUNCHES
    _check_shapes(q, k, v)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return flash_attention_fwd_reference(q, k, v, causal, sm_scale)
    if q.device.type != "cuda":
        raise ValueError("flash_attention_fwd: unsupported device %s" % q.device)
    bh, seq, head_dim = q.shape
    for t in (k, v):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError("q, k, v must share one device and dtype")
    if q.dtype not in KERNEL_DTYPES or head_dim not in KERNEL_HEAD_DIMS:
        raise ValueError(
            "flash kernel takes bf16/fp32 with head_dim in %s; got %s, %d"
            % (KERNEL_HEAD_DIMS, q.dtype, head_dim)
        )
    for t in (q, k, v):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("flash kernel needs contiguous 16-byte-aligned "
                             "q, k, v")
    from elasticdl_tpu_torch.ops import _build

    lib = _build.load("flash_fwd")
    o = torch.empty_like(q)
    lse = torch.empty((bh, 1, seq), dtype=torch.float32, device=q.device)
    if seq == 0:
        return o, lse
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.edl_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), bh, seq, head_dim,
            int(q.dtype == torch.bfloat16), int(bool(causal)),
            float(sm_scale), stream,
        )
    if err != 0:
        raise RuntimeError(
            "flash kernel launch failed: cudaError %d (shape %s, %s)"
            % (err, tuple(q.shape), q.dtype)
        )
    with _launch_lock:
        LAUNCHES += 1
    return o, lse

"""Flash attention (K4 forward, K5 dq and K6 dk/dv backward): the CUDA
kernels' wrappers, their plain PyTorch versions, and the autograd
Function that joins them.

Port of elasticdl_tpu/ops/flash_attention.py: ``_fwd`` (the Pallas
``_fwd_kernel``), ``_bwd`` (``_dq_kernel`` and ``_dkv_kernel``) and the
``_attach``/``_flash`` custom_vjp pair, over merged
``(batch * heads, seq, head_dim)`` inputs. The kernel sources are
``ops/csrc/flash_fwd.cu`` and ``ops/csrc/flash_bwd.cu``; their notes
give the bounds at the serving and training shapes.

``flash_attention_fwd`` and ``flash_attention_bwd`` launch the kernels
for CUDA tensors and raise on anything the kernels do not take. They
run the plain versions only for CPU tensors. ``LAUNCHES`` (K4),
``DQ_LAUNCHES`` (K5) and ``DKV_LAUNCHES`` (K6) count kernel launches, so
a run can show that its path went through the kernels.
``flash_attention_fwd_op`` (``torch.ops.edl.flash_attention_fwd``)
wraps the forward as a custom op, so a remat policy can save K4's
outputs.
"""

import math
import threading

import torch

NEG_INF = -1e30

LAUNCHES = 0
DQ_LAUNCHES = 0
DKV_LAUNCHES = 0
_launch_lock = threading.Lock()

KERNEL_HEAD_DIMS = (64, 128)
KERNEL_DTYPES = (torch.bfloat16, torch.float32)


def _check_shapes(*tensors):
    shape = tensors[0].shape
    if len(shape) != 3 or any(t.shape != shape for t in tensors):
        raise ValueError(
            "inputs must share one (batch*heads, seq, head_dim) shape; "
            "got %s" % ", ".join(str(tuple(t.shape)) for t in tensors)
        )


def _default_scale(q, sm_scale):
    return 1.0 / math.sqrt(q.shape[-1]) if sm_scale is None else sm_scale


def _kernel_inputs(name, *tensors):
    """Raise unless the CUDA tensors are what the kernels take: one
    device and dtype, bf16 or fp32, head_dim 64 or 128, contiguous and
    16-byte aligned."""
    q = tensors[0]
    for t in tensors:
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError("%s: inputs must share one device and dtype"
                             % name)
    if q.dtype not in KERNEL_DTYPES or q.shape[-1] not in KERNEL_HEAD_DIMS:
        raise ValueError(
            "%s: the kernel takes bf16/fp32 with head_dim in %s; got %s, %d"
            % (name, KERNEL_HEAD_DIMS, q.dtype, q.shape[-1])
        )
    for t in tensors:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("%s: the kernel needs contiguous 16-byte-"
                             "aligned inputs" % name)


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def _causal_scores(q, k, causal, sm_scale):
    """fp32 scores q k^T * scale with the -1e30 causal mask (for bf16
    inputs the products are exact in fp32, as in the kernels' fp32
    accumulation)."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    if causal:
        pos = torch.arange(q.shape[1], device=q.device)
        s = torch.where(pos[:, None] >= pos[None, :], s, NEG_INF)
    return s


# ---------------------------------------------------------------------------
# Forward (K4)
# ---------------------------------------------------------------------------


def flash_attention_fwd_reference(q, k, v, causal=False, sm_scale=None):
    """Plain version: full scores, the same -1e30 mask and dtype casts.

    p is cast to the input dtype before the PV product, and lse =
    logsumexp of the masked scores, ``(bh, 1, seq)`` fp32.
    """
    _check_shapes(q, k, v)
    s = _causal_scores(q, k, causal, _default_scale(q, sm_scale))
    lse = torch.logsumexp(s, dim=-1)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.matmul(p, v).to(q.dtype), lse.unsqueeze(1)


def flash_attention_fwd(q, k, v, causal=False, sm_scale=None, out=None):
    """``(o, lse)``: o like q, lse ``(bh, 1, seq)`` fp32. ``out``, if
    given, is a tensor like q that receives o (and is returned as o).

    CUDA tensors go to the kernel, which takes contiguous bf16 or fp32
    inputs with head_dim 64 or 128; anything else raises. CPU tensors
    go to ``flash_attention_fwd_reference``.
    """
    global LAUNCHES
    _check_shapes(q, k, v, *(() if out is None else (out,)))
    sm_scale = _default_scale(q, sm_scale)
    if q.device.type == "cpu":
        o, lse = flash_attention_fwd_reference(q, k, v, causal, sm_scale)
        return (o, lse) if out is None else (out.copy_(o), lse)
    if q.device.type != "cuda":
        raise ValueError("flash_attention_fwd: unsupported device %s" % q.device)
    o = torch.empty_like(q) if out is None else out
    _kernel_inputs("flash_attention_fwd", q, k, v, o)
    from elasticdl_tpu_torch.ops import _build

    lib = _build.load("flash_fwd")
    bh, seq, head_dim = q.shape
    lse = torch.empty((bh, 1, seq), dtype=torch.float32, device=q.device)
    if seq == 0:
        return o, lse
    with torch.cuda.device(q.device):
        err = lib.edl_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), bh, seq, head_dim,
            int(q.dtype == torch.bfloat16), int(bool(causal)),
            float(sm_scale), _stream(q.device),
        )
    if err != 0:
        raise RuntimeError(
            "flash kernel launch failed: cudaError %d (shape %s, %s)"
            % (err, tuple(q.shape), q.dtype)
        )
    with _launch_lock:
        LAUNCHES += 1
    return o, lse


# ---------------------------------------------------------------------------
# Backward (K5, K6)
# ---------------------------------------------------------------------------


def _delta(o, do):
    """rowsum(o * do) in fp32, ``(bh, 1, seq)``: computed outside the
    kernels, as ``_bwd`` does (flash_attention.py:379-381)."""
    return (o.float() * do.float()).sum(-1).unsqueeze(1)


def _probs_and_ds(q, k, v, o, lse, do, causal, sm_scale):
    """fp32 ``(p, ds)`` over the full score matrix: p = exp(s - lse),
    ds = p * (do v^T - delta) * scale."""
    _check_shapes(q, k, v, o, do)
    sm_scale = _default_scale(q, sm_scale)
    s = _causal_scores(q, k, causal, sm_scale)
    p = torch.exp(s - lse.transpose(1, 2))
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    return p, p * (dp - _delta(o, do).transpose(1, 2)) * sm_scale


def flash_attention_bwd_dq_reference(q, k, v, o, lse, do, causal=False,
                                     sm_scale=None):
    """Plain version of K5 alone: dq = ds k with ds cast to k's dtype,
    accumulated in fp32 and cast to q's dtype once."""
    _, ds = _probs_and_ds(q, k, v, o, lse, do, causal, sm_scale)
    return torch.matmul(ds.to(k.dtype).float(), k.float()).to(q.dtype)


def flash_attention_bwd_dkv_reference(q, k, v, o, lse, do, causal=False,
                                      sm_scale=None):
    """Plain version of K6 alone: ``(dk, dv)`` with dk = ds^T q (ds cast
    to q's dtype) and dv = p^T do (p cast to do's dtype), accumulated in
    fp32 and cast to k's and v's dtype once."""
    p, ds = _probs_and_ds(q, k, v, o, lse, do, causal, sm_scale)
    dk = torch.matmul(ds.to(q.dtype).float().transpose(-1, -2),
                      q.float()).to(k.dtype)
    dv = torch.matmul(p.to(do.dtype).float().transpose(-1, -2),
                      do.float()).to(v.dtype)
    return dk, dv


def flash_attention_bwd_reference(q, k, v, o, lse, do, causal=False,
                                  sm_scale=None):
    """Plain version of K5 and K6: the full fp32 score matrix and the
    kernels' casts (ds to k's dtype before ds k and ds^T q, p to do's
    dtype before p^T do), each product accumulated in fp32 and cast to
    its input's dtype once. Returns ``(dq, dk, dv)``."""
    args = (q, k, v, o, lse, do, causal, sm_scale)
    return (flash_attention_bwd_dq_reference(*args),
            *flash_attention_bwd_dkv_reference(*args))


def flash_attention_bwd(q, k, v, o, lse, do, causal=False, sm_scale=None):
    """``(dq, dk, dv)`` of attention at ``(q, k, v)`` given the forward's
    ``(o, lse)`` and the output gradient ``do``, each like its input.

    CUDA tensors go to K5 (dq) and K6 (dk, dv), which take what K4 takes
    (contiguous 16-byte-aligned bf16 or fp32, head_dim 64 or 128; lse
    fp32); anything else raises. CPU tensors go to
    ``flash_attention_bwd_reference``.
    """
    global DQ_LAUNCHES, DKV_LAUNCHES
    _check_shapes(q, k, v, o, do)
    sm_scale = _default_scale(q, sm_scale)
    if q.device.type == "cpu":
        return flash_attention_bwd_reference(
            q, k, v, o, lse, do, causal, sm_scale)
    if q.device.type != "cuda":
        raise ValueError("flash_attention_bwd: unsupported device %s" % q.device)
    _kernel_inputs("flash_attention_bwd", q, k, v, o, do)
    bh, seq, head_dim = q.shape
    if (lse.shape != (bh, 1, seq) or lse.dtype != torch.float32
            or lse.device != q.device or not lse.is_contiguous()):
        raise ValueError("flash_attention_bwd: lse must be a contiguous "
                         "(bh, 1, seq) fp32 tensor on q's device")
    from elasticdl_tpu_torch.ops import _build

    lib = _build.load("flash_bwd")
    delta = _delta(o, do)
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    if seq == 0:
        return dq, dk, dv
    common = (bh, seq, head_dim, int(q.dtype == torch.bfloat16),
              int(bool(causal)), float(sm_scale))
    inputs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
              lse.data_ptr(), delta.data_ptr())
    with torch.cuda.device(q.device):
        stream = _stream(q.device)
        err = lib.edl_flash_bwd_dq(*inputs, dq.data_ptr(), *common, stream)
        if err == 0:
            with _launch_lock:
                DQ_LAUNCHES += 1
            err = lib.edl_flash_bwd_dkv(
                *inputs, dk.data_ptr(), dv.data_ptr(), *common, stream)
            if err == 0:
                with _launch_lock:
                    DKV_LAUNCHES += 1
    if err != 0:
        raise RuntimeError(
            "flash backward kernel launch failed: cudaError %d (shape %s, "
            "%s)" % (err, tuple(q.shape), q.dtype)
        )
    return dq, dk, dv


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------


def _merge(t):
    """(batch, heads, seq, head_dim) -> contiguous 16-byte-aligned
    (batch * heads, seq, head_dim), as the kernels take it (the model
    hands over transposed views, and autograd a transposed gradient)."""
    t = t.reshape(-1, t.shape[-2], t.shape[-1])
    if t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t
    return t.clone(memory_format=torch.contiguous_format)


@torch.library.custom_op("edl::flash_attention_fwd", mutates_args=())
def flash_attention_fwd_op(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, shape: list[int], causal: bool,
                           sm_scale: float) -> tuple[torch.Tensor,
                                                     torch.Tensor]:
    """``flash_attention_fwd`` as an op the dispatcher sees: K4 (its
    plain version for CPU tensors) on merged ``(bh, seq, head_dim)``
    q, k, v, returning a fresh o of the 4-D ``shape`` and lse.

    A selective-checkpoint policy (models/transformer.py's remat) can
    save this op's outputs, so a recomputed block does not launch K4
    again; a ctypes launch inside a Function's forward is invisible to
    it. The output is allocated in the final 4-D shape and the kernel
    writes it through a merged view: returning a view of a merged o
    would hide the Function behind a view's grad_fn."""
    out = torch.empty(shape, dtype=q.dtype, device=q.device)
    # looked up on the module at call time (a test may wrap it)
    _, lse = flash_attention_fwd(q, k, v, causal=causal, sm_scale=sm_scale,
                                 out=out.view(q.shape))
    return out, lse


@flash_attention_fwd_op.register_fake
def _flash_attention_fwd_fake(q, k, v, shape, causal, sm_scale):
    bh, seq, _ = q.shape
    return (q.new_empty(shape),
            q.new_empty((bh, 1, seq), dtype=torch.float32))


class FlashAttention(torch.autograd.Function):
    """Attention on ``(batch, heads, seq, head_dim)`` tensors whose
    gradient runs K5 and K6 (the JAX package's ``_attach``/``_flash``
    pair).

    The forward merges batch and heads, runs K4 through
    ``flash_attention_fwd_op`` (its plain version on the CPU) and saves
    ``(q, k, v, o, lse)``, so the backward never re-runs the forward.
    The backward computes ``delta`` in plain torch and launches K5 and
    K6 (their plain versions on the CPU); it returns contiguous
    gradients in the inputs' 4-D shape.
    """

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale):
        merged = [_merge(t) for t in (q, k, v)]
        out, lse = torch.ops.edl.flash_attention_fwd(
            *merged, list(q.shape), causal, sm_scale)
        ctx.save_for_backward(*merged, out, lse)
        ctx.causal = causal
        ctx.sm_scale = sm_scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        grads = flash_attention_bwd(
            q, k, v, out.view(q.shape), lse, _merge(do), causal=ctx.causal,
            sm_scale=ctx.sm_scale,
        )
        return (*(g.view(do.shape) for g in grads), None, None)


def flash_attention(q, k, v, causal=False, sm_scale=None):
    """Attention on ``(batch, heads, seq, head_dim)`` tensors through
    ``FlashAttention`` (the only way the flash path runs under
    autograd)."""
    if q.dim() != 4:
        raise ValueError("expected 4-D (batch, heads, seq, head_dim) q/k/v")
    return FlashAttention.apply(q, k, v, bool(causal),
                                _default_scale(q, sm_scale))

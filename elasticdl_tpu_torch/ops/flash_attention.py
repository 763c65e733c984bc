"""Flash attention (K4 forward, K5 dq and K6 dk/dv backward): the CUDA
kernels' wrappers, their plain PyTorch versions, and the autograd
Function that joins them.

Port of elasticdl_tpu/ops/flash_attention.py: ``_fwd`` (the Pallas
``_fwd_kernel``), ``_bwd`` (``_dq_kernel`` and ``_dkv_kernel``) and the
``_attach``/``_flash`` custom_vjp pair, over merged
``(batch * heads, seq, head_dim)`` inputs. q (and o, do, dq) hold
``seq_q`` rows and k, v (and dk, dv) ``seq_k``, which may differ; under
the causal mask query row i sees keys j <= i, both counted from 0 (the
reference's ``_causal_mask``). The kernel sources are
``ops/csrc/flash_fwd.cu`` and ``ops/csrc/flash_bwd.cu``; their notes
give the bounds at the serving and training shapes.

``flash_attention_fwd`` and ``flash_attention_bwd`` launch the kernels
for CUDA tensors and raise on anything the kernels do not take. The
kernels are built for head_dim 64, 128 and 256; any other head_dim up
to 256 is zero-padded to the next of those (``kernel_head_dim``,
``pad_head_dim``) and the outputs sliced back, with the scale of the
true head_dim. That is exact: zero columns add nothing to a score, and
the padded columns of o, dq, dk and dv are zeros. They run the plain
versions only for CPU tensors. ``LAUNCHES`` (K4),
``DQ_LAUNCHES`` (K5) and ``DKV_LAUNCHES`` (K6) count kernel launches, so
a run can show that its path went through the kernels.
``flash_attention_fwd_op`` (``torch.ops.edl.flash_attention_fwd``)
wraps the forward as a custom op, so a remat policy can save K4's
outputs. The op is defined through ``torch.library.Library``, not
``torch.library.custom_op``: custom_op's kernels import
``torch._dynamo`` on their first call, seconds of imports paid by
every new process's first forward (a serving replica's first
request).
"""

import math
import threading

import torch

NEG_INF = -1e30

LAUNCHES = 0
DQ_LAUNCHES = 0
DKV_LAUNCHES = 0
_launch_lock = threading.Lock()

KERNEL_HEAD_DIMS = (64, 128, 256)
KERNEL_DTYPES = (torch.bfloat16, torch.float32)


def _check_shapes(q, k, v, *like_q):
    """Raise unless q (and every tensor of ``like_q``) is ``(bh, seq_q,
    d)`` and k and v are ``(bh, seq_k, d)``."""
    shape = q.shape
    ok = (len(shape) == 3 and k.dim() == 3 and k.shape == v.shape
          and k.shape[0] == shape[0] and k.shape[2] == shape[2]
          and all(t.shape == shape for t in like_q))
    if not ok:
        raise ValueError(
            "q must be (batch*heads, seq_q, head_dim) and k, v (batch*heads,"
            " seq_k, head_dim); got %s" % ", ".join(
                str(tuple(t.shape)) for t in (q, k, v, *like_q))
        )


def _default_scale(q, sm_scale):
    return 1.0 / math.sqrt(q.shape[-1]) if sm_scale is None else sm_scale


def kernel_head_dim(head_dim):
    """The kernel instantiation a head_dim runs through: the smallest of
    ``KERNEL_HEAD_DIMS`` that holds it. Raises over the largest."""
    for d in KERNEL_HEAD_DIMS:
        if head_dim <= d:
            return d
    raise ValueError(
        "flash attention kernels take head_dim up to %d; got %d"
        % (KERNEL_HEAD_DIMS[-1], head_dim)
    )


def pad_head_dim(t, head_dim):
    """``t`` with zero columns appended up to ``head_dim``, contiguous
    (``t`` itself when it is already that wide)."""
    extra = head_dim - t.shape[-1]
    if extra == 0:
        return t
    return torch.nn.functional.pad(t, (0, extra)).contiguous()


def _kernel_inputs(name, *tensors):
    """Raise unless the CUDA tensors are what the kernels take: one
    device and dtype, bf16 or fp32, head_dim 64, 128 or 256, contiguous
    and 16-byte aligned."""
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
        q_pos = torch.arange(q.shape[1], device=q.device)[:, None]
        k_pos = torch.arange(k.shape[1], device=q.device)[None, :]
        s = torch.where(q_pos >= k_pos, s, NEG_INF)
    return s


# ---------------------------------------------------------------------------
# Forward (K4)
# ---------------------------------------------------------------------------


def flash_attention_fwd_reference(q, k, v, causal=False, sm_scale=None):
    """Plain version: full scores, the same -1e30 mask and dtype casts.

    p is cast to the input dtype before the PV product, and lse =
    logsumexp of the masked scores, ``(bh, 1, seq_q)`` fp32. With no
    keys (seq_k 0) o is zeros and lse -inf.
    """
    _check_shapes(q, k, v)
    s = _causal_scores(q, k, causal, _default_scale(q, sm_scale))
    lse = torch.logsumexp(s, dim=-1)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.matmul(p, v).to(q.dtype), lse.unsqueeze(1)


def flash_attention_fwd(q, k, v, causal=False, sm_scale=None, out=None):
    """``(o, lse)``: o like q, lse ``(bh, 1, seq_q)`` fp32. ``out``, if
    given, is a tensor like q that receives o (and is returned as o).

    CUDA tensors go to the kernel, which takes contiguous bf16 or fp32
    inputs with head_dim up to 256 (padded to 64, 128 or 256); anything
    else raises. CPU tensors go to ``flash_attention_fwd_reference``.
    """
    _check_shapes(q, k, v, *(() if out is None else (out,)))
    sm_scale = _default_scale(q, sm_scale)
    if q.device.type == "cpu":
        o, lse = flash_attention_fwd_reference(q, k, v, causal, sm_scale)
        return (o, lse) if out is None else (out.copy_(o), lse)
    if q.device.type != "cuda":
        raise ValueError("flash_attention_fwd: unsupported device %s" % q.device)
    head_dim = q.shape[-1]
    padded = kernel_head_dim(head_dim)
    if padded == head_dim:
        return _launch_fwd(q, k, v, causal, sm_scale, out)
    o, lse = _launch_fwd(*(pad_head_dim(t, padded) for t in (q, k, v)),
                         causal, sm_scale, None)
    o = o[..., :head_dim]
    return (o.contiguous(), lse) if out is None else (out.copy_(o), lse)


def _launch_fwd(q, k, v, causal, sm_scale, out):
    global LAUNCHES
    o = torch.empty_like(q) if out is None else out
    _kernel_inputs("flash_attention_fwd", q, k, v, o)
    from elasticdl_tpu_torch.ops import _build

    lib = _build.load("flash_fwd")
    bh, seq_q, head_dim = q.shape
    seq_k = k.shape[1]
    lse = torch.empty((bh, 1, seq_q), dtype=torch.float32, device=q.device)
    if seq_q == 0 or seq_k == 0:
        # no keys: what the plain version gives (o zeros, lse -inf)
        return o.zero_(), lse.fill_(-math.inf)
    with torch.cuda.device(q.device):
        err = lib.edl_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), bh, seq_q, seq_k, head_dim,
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
    """rowsum(o * do) in fp32, ``(bh, 1, seq_q)``: computed outside the
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
    (contiguous 16-byte-aligned bf16 or fp32, head_dim up to 256, padded
    as K4's; lse fp32); anything else raises. CPU tensors go to
    ``flash_attention_bwd_reference``.
    """
    _check_shapes(q, k, v, o, do)
    sm_scale = _default_scale(q, sm_scale)
    if q.device.type == "cpu":
        return flash_attention_bwd_reference(
            q, k, v, o, lse, do, causal, sm_scale)
    if q.device.type != "cuda":
        raise ValueError("flash_attention_bwd: unsupported device %s" % q.device)
    head_dim = q.shape[-1]
    padded = kernel_head_dim(head_dim)
    if padded == head_dim:
        return _launch_bwd(q, k, v, o, lse, do, causal, sm_scale)
    # delta = rowsum(o * do) is the same over the zero columns
    grads = _launch_bwd(*(pad_head_dim(t, padded) for t in (q, k, v, o)),
                        lse, pad_head_dim(do, padded), causal, sm_scale)
    return tuple(g[..., :head_dim].contiguous() for g in grads)


def _launch_bwd(q, k, v, o, lse, do, causal, sm_scale):
    global DQ_LAUNCHES, DKV_LAUNCHES
    _kernel_inputs("flash_attention_bwd", q, k, v, o, do)
    bh, seq_q, head_dim = q.shape
    seq_k = k.shape[1]
    if (lse.shape != (bh, 1, seq_q) or lse.dtype != torch.float32
            or lse.device != q.device or not lse.is_contiguous()):
        raise ValueError("flash_attention_bwd: lse must be a contiguous "
                         "(bh, 1, seq_q) fp32 tensor on q's device")
    from elasticdl_tpu_torch.ops import _build

    lib = _build.load("flash_bwd")
    delta = _delta(o, do)
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    if seq_q == 0 or seq_k == 0:
        # no (query, key) pair: every gradient is zero
        return dq.zero_(), dk.zero_(), dv.zero_()
    common = (bh, seq_q, seq_k, head_dim, int(q.dtype == torch.bfloat16),
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
    t = t.flatten(0, -3)
    if t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t
    return t.clone(memory_format=torch.contiguous_format)


_LIB = torch.library.Library("edl", "DEF")
_LIB.define("flash_attention_fwd(Tensor q, Tensor k, Tensor v, "
            "int[] shape, bool causal, float sm_scale) -> (Tensor, Tensor)")


def flash_attention_fwd_op(q, k, v, shape, causal, sm_scale):
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


_LIB.impl("flash_attention_fwd", flash_attention_fwd_op,
          "CompositeExplicitAutograd")


@torch.library.register_fake("edl::flash_attention_fwd")
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
        ctx.shapes = (q.shape, k.shape, v.shape)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        grads = flash_attention_bwd(
            q, k, v, out.view(q.shape), lse, _merge(do), causal=ctx.causal,
            sm_scale=ctx.sm_scale,
        )
        return (*(g.view(shape) for g, shape in zip(grads, ctx.shapes)),
                None, None)


def flash_attention(q, k, v, causal=False, sm_scale=None):
    """Attention on ``(batch, heads, seq, head_dim)`` tensors through
    ``FlashAttention`` (the only way the flash path runs under
    autograd)."""
    if q.dim() != 4:
        raise ValueError("expected 4-D (batch, heads, seq, head_dim) q/k/v")
    return FlashAttention.apply(q, k, v, bool(causal),
                                _default_scale(q, sm_scale))

"""Sequence parallelism: ring attention and all-to-all (Ulysses) over the
``sp`` mesh axis (port of elasticdl_tpu/ops/ring_attention.py).

The reference calls these inside jit on global arrays and opens a
shard_map over the mesh. The port's ranks are processes
(parallel/mesh.py), so each call here takes THIS rank's blocks of q, k
and v, ``(batch, heads, seq, head_dim)`` with the batch over the data
axes, the heads over tp and the sequence over sp (the reference's
default spec), and returns this rank's block of the output. Rank i
along sp holds positions ``[i * seq, (i + 1) * seq)``.

- ``ring_attention``: the k/v blocks go round the sp ring (a
  ``mesh_ppermute`` a step, rank j to j + 1) while each rank folds them
  into an online softmax. Two folds, as the reference's
  ``block_impl``:
  - "einsum": plain torch (the reference's XLA math, ``_block_update``);
    its backward is autograd through the ppermute, whose backward
    sends the gradients the other way round (a skipped block is tied
    into the graph, ``_Tie``, so every rank runs every hop's backward);
  - "flash": each step runs K4 (``flash_attention_fwd``) on (q, the
    block) and merges the block's (o, lse) by log-sum-exp in fp32. A
    block strictly after this rank's positions under the causal mask
    launches nothing (the reference's ``lax.cond`` zeros branch), and
    only the diagonal block launches with the mask. The backward
    rotates k/v again and runs K5/K6 (``flash_attention_bwd``) per
    block against the GLOBAL (o, lse, do): exp(s - lse) is the global
    softmax restricted to the block. dq stays; the dk/dv accumulators
    ride the ring with their blocks, and after sp hops they are home.
  Under the causal mask rank r launches r + 1 blocks each way.
- ``ulysses_attention``: ``mesh_all_to_all`` turns the sequence split
  into a head split, each rank runs attention over the whole sequence
  for its heads, and the all-to-all turns it back.

The hops go through parallel/collectives.py (``exchange``: one
``batch_isend_irecv`` a hop; over gloo a CUDA tensor is copied through
the host, counted and timed). Over a size-1 sp axis both are the
default attention.
"""

import math

import torch

from elasticdl_tpu_torch.ops import flash_attention as F
from elasticdl_tpu_torch.parallel import collectives
from elasticdl_tpu_torch.parallel.mesh import DATA_AXES, current_mesh
from elasticdl_tpu_torch.parallel.sharding import PartitionSpec as P
from elasticdl_tpu_torch.parallel.sharding import entry_axes

NEG_INF = -1e30

BLOCK_IMPLS = ("auto", "einsum", "flash")


def _default_spec():
    # (batch, heads, seq, head_dim): batch over data axes, heads over tp,
    # seq over sp.
    return P(DATA_AXES, "tp", "sp", None)


def _block_update(m_prev, l_prev, acc, k_blk, v_blk, q, mask):
    """Fold one KV block into the running (m, l, acc) softmax state (q
    is the fp32 query already scaled)."""
    s = torch.einsum("bhqd,bhkd->bhqk", q, k_blk.float())
    if mask is not None:
        s = torch.where(mask, s, NEG_INF)
    m_cur = torch.amax(s, dim=-1)
    m_new = torch.maximum(m_prev, m_cur)
    correction = torch.exp(m_prev - m_new)
    p = torch.exp(s - m_new[..., None])
    l_new = l_prev * correction + torch.sum(p, dim=-1)
    acc_new = acc * correction[..., None] + torch.einsum(
        "bhqk,bhkd->bhqd", p, v_blk.float())
    return m_new, l_new, acc_new


def _ring(sp):
    return [(j, (j + 1) % sp) for j in range(sp)]


class _Tie(torch.autograd.Function):
    """``acc`` unchanged, with the skipped blocks as inputs whose
    gradient is zero. Autograd runs only the nodes on a path to the
    loss, and the backward of a hop is a hop that every rank of the ring
    must post: a block that arrives only to be skipped (a future block
    under the causal mask) is tied in, so each rank runs every hop's
    backward, in the same order."""

    @staticmethod
    def forward(ctx, acc, *blocks):
        ctx.shapes = [(b.shape, b.dtype) for b in blocks]
        return acc.view_as(acc)

    @staticmethod
    def backward(ctx, grad):
        return (grad, *(torch.zeros(shape, dtype=dtype, device=grad.device)
                        for shape, dtype in ctx.shapes))


def _einsum_ring(q, k, v, mesh, axis, causal, sm_scale, remat):
    sp = mesh.shape[axis]
    my = mesh.index(axis)
    batch, heads, seq, dim = q.shape
    q32 = q.float() * sm_scale
    m = torch.full((batch, heads, seq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((batch, heads, seq), dtype=torch.float32,
                    device=q.device)
    acc = torch.zeros((batch, heads, seq, dim), dtype=torch.float32,
                      device=q.device)
    update = _block_update
    if remat and torch.is_grad_enabled():
        from torch.utils.checkpoint import checkpoint

        update = lambda *a: checkpoint(_block_update, *a,
                                       use_reentrant=False)
    pos = torch.arange(seq, device=q.device)
    k_blk, v_blk = k, v
    for t in range(sp):
        # after t hops the block here came from rank (my - t) mod sp
        src = (my - t) % sp
        if causal and src > my:
            # blocks strictly in the future contribute nothing: skipped
            if torch.is_grad_enabled() and k_blk.requires_grad:
                acc = _Tie.apply(acc, k_blk, v_blk)
        else:
            mask = None
            if causal:
                mask = ((my * seq + pos)[:, None]
                        >= (src * seq + pos)[None, :])[None, None]
            m, l, acc = update(m, l, acc, k_blk, v_blk, q32, mask)
        if t < sp - 1:
            k_blk, v_blk = collectives.mesh_ppermute(
                (k_blk, v_blk), axis, _ring(sp), mesh=mesh)
    safe_l = torch.where(l > 0.0, l, torch.ones_like(l))
    return (acc / safe_l[..., None]).to(q.dtype)


def _lse_w(lse_from, lse_to):
    # (bh, 1, S) log-weights -> (bh, S, 1) multiplicative weights
    return torch.exp(lse_from - lse_to).transpose(1, 2)


def _hop(tensors, mesh, axis, sp):
    # inside the Function: no autograd, one hop for every tensor
    with torch.no_grad():
        return collectives.mesh_ppermute(tuple(tensors), axis, _ring(sp),
                                         mesh=mesh)


class _FlashRing(torch.autograd.Function):
    """The flash fold on merged ``(batch * heads, seq, head_dim)``
    blocks (the reference's ``_make_flash_ring`` custom_vjp)."""

    @staticmethod
    def forward(ctx, q, k, v, mesh, axis, causal, sm_scale):
        sp = mesh.shape[axis]
        my = mesh.index(axis)
        bh, seq, _ = q.shape
        o = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        lse = torch.full((bh, 1, seq), NEG_INF, dtype=torch.float32,
                         device=q.device)
        k_blk, v_blk = k, v
        for t in range(sp):
            src = (my - t) % sp
            if not (causal and src > my):
                # looked up on the module at call time (a test may wrap it)
                o_t, lse_t = F.flash_attention_fwd(
                    q, k_blk, v_blk, causal=causal and src == my,
                    sm_scale=sm_scale)
                lse_new = torch.logaddexp(lse, lse_t)
                o = o * _lse_w(lse, lse_new) + o_t.float() * _lse_w(
                    lse_t, lse_new)
                lse = lse_new
            if t < sp - 1:
                k_blk, v_blk = _hop((k_blk, v_blk), mesh, axis, sp)
        o = o.to(q.dtype)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (mesh, axis, causal, sm_scale)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        mesh, axis, causal, sm_scale = ctx.args
        sp = mesh.shape[axis]
        my = mesh.index(axis)
        do = do.contiguous()
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
        dv = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
        k_blk, v_blk = k, v
        for t in range(sp):
            src = (my - t) % sp
            if not (causal and src > my):
                dq_t, dk_t, dv_t = F.flash_attention_bwd(
                    q, k_blk, v_blk, o, lse, do,
                    causal=causal and src == my, sm_scale=sm_scale)
                dq += dq_t.float()
                dk += dk_t.float()
                dv += dv_t.float()
            # the (dk, dv) accumulators ride with their blocks: after sp
            # hops both are back on the block's owner
            if t < sp - 1:
                k_blk, v_blk, dk, dv = _hop((k_blk, v_blk, dk, dv), mesh,
                                            axis, sp)
            else:
                dk, dv = _hop((dk, dv), mesh, axis, sp)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None, None)


def _flash_ring(q, k, v, mesh, axis, causal, sm_scale):
    batch, heads, seq, dim = q.shape
    merged = [F._merge(t) for t in (q, k, v)]
    o = _FlashRing.apply(*merged, mesh, axis, bool(causal), float(sm_scale))
    return o.view(batch, heads, seq, dim)


def _resolve(block_impl, q):
    if block_impl not in BLOCK_IMPLS:
        raise ValueError("unknown ring block_impl %r" % (block_impl,))
    if block_impl == "auto":
        # the kernels on the card (they take any local length), the
        # plain math elsewhere, as the reference's "auto" takes its
        # kernel on the TPU only
        return "flash" if q.is_cuda else "einsum"
    return block_impl


def _sp_size(mesh, axis):
    mesh = mesh if mesh is not None else current_mesh()
    return mesh, (1 if mesh is None else int(mesh.shape[axis]))


def ring_attention(q, k, v, mesh=None, axis_name="sp", causal=False,
                   sm_scale=None, spec=None, remat=True, block_impl="auto",
                   block_q=None, block_k=None, interpret=False):
    """Attention with q, k, v this rank's sequence blocks over
    ``axis_name`` (the module docstring); returns this rank's block of
    the output.

    ``block_impl``: "einsum" (plain torch, autograd backward), "flash"
    (K4 forward, K5/K6 backward) or "auto" (flash for CUDA tensors,
    einsum otherwise). ``remat`` recomputes each einsum block in the
    backward. ``spec`` is the layout the blocks were cut by (the
    reference's shard_map specs); the port's blocks arrive cut, so it
    is not read. ``block_q``, ``block_k`` and ``interpret`` are the
    reference's Pallas knobs: the Hopper kernels fix their own tiles and
    are compiled, so they are accepted and not read. ``mesh``: the
    ambient one when not given. Over a size-1 axis this is
    ``dot_product_attention`` (block_impl "flash" -> its "pallas",
    "einsum" -> its "xla")."""
    del spec
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    mesh, sp = _sp_size(mesh, axis_name)
    if sp == 1:
        from elasticdl_tpu_torch.ops.attention import dot_product_attention

        # honor block_impl even in the ring-of-one case: a caller who
        # pinned "einsum" must not get the kernel back through "auto"
        impl = {"flash": "pallas", "einsum": "xla"}.get(block_impl, "auto")
        return dot_product_attention(
            q, k, v, causal=causal, sm_scale=sm_scale, impl=impl,
            block_q=block_q, block_k=block_k, interpret=interpret)
    if _resolve(block_impl, q) == "flash":
        return _flash_ring(q, k, v, mesh, axis_name, causal, sm_scale)
    return _einsum_ring(q, k, v, mesh, axis_name, causal, sm_scale, remat)


def ulysses_attention(q, k, v, mesh=None, axis_name="sp", causal=False,
                      sm_scale=None, spec=None, attention_fn=None):
    """All-to-all sequence parallelism (DeepSpeed-Ulysses schedule) on
    this rank's blocks: the heads split over sp in place of the
    sequence, full-sequence attention on this rank's head group
    (``attention_fn(q, k, v, causal=, sm_scale=)``, by default
    ``dot_product_attention``), and back. Needs this rank's heads to
    divide by sp."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    spec = spec if spec is not None else _default_spec()
    mesh, sp = _sp_size(mesh, axis_name)
    if attention_fn is None:
        from elasticdl_tpu_torch.ops.attention import dot_product_attention

        attention_fn = dot_product_attention
    if sp == 1:
        return attention_fn(q, k, v, causal=causal, sm_scale=sm_scale)
    # the all-to-all splits this rank's heads (the global heads already
    # divided by the axes the spec splits dim 1 over)
    head_axes = entry_axes(tuple(spec)[1]) if len(tuple(spec)) > 1 else ()
    head_shard = mesh.size(head_axes)
    local_heads = q.shape[1]
    if local_heads % sp:
        raise ValueError(
            "ulysses needs per-device heads (%d global / %d sharded = %d)"
            " divisible by sp (%d)"
            % (local_heads * head_shard, head_shard, local_heads, sp))

    def seq_to_heads(x):
        # (B, H_loc, S/sp, D) -> (B, H_loc/sp, S, D)
        return collectives.mesh_all_to_all(x, axis_name, 1, 2, mesh=mesh)

    out = attention_fn(seq_to_heads(q), seq_to_heads(k), seq_to_heads(v),
                       causal=causal, sm_scale=sm_scale)
    return collectives.mesh_all_to_all(out, axis_name, 2, 1, mesh=mesh)

"""Attention dispatch: the CUDA flash kernel on the card, plain PyTorch
elsewhere.

Port of elasticdl_tpu/ops/attention.py. ``dot_product_attention`` is
the op model code calls:

- ``"flash"``  -- ops/flash_attention.py ``FlashAttention``: the K4
                  kernel forward and the K5/K6 kernels backward for CUDA
                  tensors (bf16 or fp32, any head_dim up to 256, padded
                  to the kernels' 64, 128 or 256; anything else raises),
                  their plain versions for CPU tensors. q may hold
                  another number of positions than k and v: seq_q !=
                  seq_k runs through the kernels too, and under
                  ``causal`` query row i sees keys j <= i, both counted
                  from 0
- ``"pallas"`` -- the JAX package's name for its kernel path: the same
                  as ``"flash"``, so model code written against the
                  reference (``TransformerLM(attention_impl="pallas")``)
                  runs unchanged
- ``"xla"``    -- the plain softmax attention below (name kept from the
                  JAX package); taken only when asked for by name
- ``"auto"``   -- ``"flash"``

Any other name raises. The reference's ``"ring"`` and ``"ulysses"``
(sequence parallelism over the ``sp`` axis) are not names of this op in
either package: the model dispatches them to ops/ring_attention.py
(models/transformer.py's ``Attention``).
"""

import math

import torch

from elasticdl_tpu_torch.ops import flash_attention as _flash


def xla_attention(q, k, v, causal=False, sm_scale=None):
    """Reference O(S^2) attention on (batch, heads, seq, dim). Scores in
    fp32, the -1e30 causal mask, p cast to q's dtype before the PV
    product."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    if causal:
        seq_q, seq_k = s.shape[-2], s.shape[-1]
        q_pos = torch.arange(seq_q, device=s.device)[:, None]
        k_pos = torch.arange(seq_k, device=s.device)[None, :]
        s = torch.where(q_pos >= k_pos, s, _flash.NEG_INF)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", p, v)


def dot_product_attention(q, k, v, causal=False, sm_scale=None,
                          impl="auto", block_q=None, block_k=None,
                          interpret=False):
    """Attention on (batch, heads, seq, dim) tensors. ``block_q``,
    ``block_k`` and ``interpret`` are the reference's Pallas tiles and
    interpret mode: the Hopper kernels fix their own tiles and are
    compiled, so the three are accepted (the ring of one passes them, as
    the reference's does) and not read."""
    del block_q, block_k, interpret
    if impl in ("auto", "flash", "pallas"):
        return _flash.flash_attention(q, k, v, causal=causal,
                                      sm_scale=sm_scale)
    if impl == "xla":
        return xla_attention(q, k, v, causal=causal, sm_scale=sm_scale)
    raise ValueError("unknown attention impl %r" % (impl,))

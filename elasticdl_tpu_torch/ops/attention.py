"""Attention dispatch: the CUDA flash kernel on the card, plain PyTorch
elsewhere.

Port of elasticdl_tpu/ops/attention.py. ``dot_product_attention`` is
the op model code calls:

- ``"flash"``  -- ops/flash_attention.py ``FlashAttention``: the K4
                  kernel forward and the K5/K6 kernels backward for CUDA
                  tensors (which raise on a dtype or head_dim they do
                  not take), their plain versions for CPU tensors
- ``"pallas"`` -- the JAX package's name for its kernel path: the same
                  as ``"flash"``, so model code written against the
                  reference (``TransformerLM(attention_impl="pallas")``)
                  runs unchanged
- ``"xla"``    -- the plain softmax attention below (name kept from the
                  JAX package); taken only when asked for by name
- ``"auto"``   -- ``"flash"``

The reference's ``"ring"`` and ``"ulysses"`` (sequence parallelism over
a mesh) are not ported yet and raise, as any other name does.
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
                          impl="auto"):
    """Attention on (batch, heads, seq, dim) tensors."""
    if impl in ("auto", "flash", "pallas"):
        return _flash.flash_attention(q, k, v, causal=causal,
                                      sm_scale=sm_scale)
    if impl == "xla":
        return xla_attention(q, k, v, causal=causal, sm_scale=sm_scale)
    raise ValueError("unknown attention impl %r" % (impl,))

"""Mixture-of-experts routing: top-k router with static capacity (port of
elasticdl_tpu/ops/moe.py).

The GShard/Switch dispatch formulation with static shapes: every token
picks its top-k experts from the router's logits; each expert has a
fixed per-group capacity C, and tokens beyond it are dropped (their
combine weight is zero, the residual stream carries them through).

Two forms with the same assignment policy:

- one-hot: (G, S, E, C) dispatch/combine tensors contracted against the
  token stream by ``torch.einsum`` (``moe_dispatch`` / ``moe_combine``);
- compact: flat slot ids per (rank, token) and gathers
  (``moe_dispatch_compact`` / ``moe_combine_compact``), whose backwards
  are gathers too (``torch.autograd.Function``s below), exactly as the
  reference's custom VJPs are: autograd's scatter-add is never used.

Differences from the reference that keep the same numbers:

- ``jax.nn.one_hot(position, C)`` gives a zero row for a position past
  the capacity (that is how overflow tokens are dropped);
  ``torch.nn.functional.one_hot`` raises on such an index, so slots are
  compared against an ``arange`` instead;
- ``jax.lax.top_k`` puts the lower expert first among equal
  probabilities; ``torch.topk`` promises no order among ties, so the
  top k come from a stable descending sort;
- slot ids and the inverted index are int64 (torch's index dtype) where
  the reference's are int32; the values are the same.

MoE has no Pallas kernel in the reference, so none here: the einsums
and the gathers are plain torch ops.
"""

import torch
import torch.nn.functional as F


def expert_capacity(seq_len, num_experts, k=1, capacity_factor=1.25):
    """Static per-group expert capacity: ceil(S*k/E) * factor."""
    per_expert = (seq_len * k + num_experts - 1) // num_experts
    return max(1, int(per_expert * capacity_factor))


def _top_k(probs, k):
    """``jax.lax.top_k`` over the last axis: the k largest values,
    descending, the lower index first among equal values."""
    values, indices = torch.sort(probs, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def _router_probs(router_logits, k, batch_mean=None):
    """Softmax in fp32, the kept gates renormalized, and the Switch
    load-balance aux loss over first choices (eq. 4): E * sum_e f_e p_e.
    ``batch_mean`` turns f_e and p_e, means over this rank's rows, into
    the means over the whole batch (a data-parallel rank; the reference
    takes them over its global arrays)."""
    num_experts = router_logits.shape[-1]
    probs = torch.softmax(router_logits.float(), dim=-1)
    gates, indices = _top_k(probs, k)  # (G, S, k)
    gates = gates / (gates.sum(dim=-1, keepdim=True) + 1e-9)
    first_choice = F.one_hot(indices[..., 0], num_experts).float()
    tokens_per_expert = first_choice.mean(dim=(0, 1))  # f_e
    prob_per_expert = probs.mean(dim=(0, 1))  # p_e
    if batch_mean is not None:
        tokens_per_expert = batch_mean(tokens_per_expert)
        prob_per_expert = batch_mean(prob_per_expert)
    aux_loss = num_experts * torch.sum(tokens_per_expert * prob_per_expert)
    return gates, indices, aux_loss


def top_k_routing(router_logits, k, capacity, batch_mean=None):
    """Dispatch/combine tensors for top-k token -> expert routing.

    router_logits: (G, S, E). Returns ``(combine, dispatch, aux_loss)``:
    combine (G, S, E, C) fp32 gate weights (zero for dropped tokens),
    dispatch (G, S, E, C) bool one-hot token -> (expert, slot), and the
    scalar aux loss. Slots are assigned choice-rank-major: every rank-0
    choice before any rank-1 choice, and within a rank earlier tokens
    win (cumsum order). ``batch_mean``: ``_router_probs``'s."""
    num_groups, _, num_experts = router_logits.shape
    device = router_logits.device
    gates, indices, aux_loss = _router_probs(router_logits, k, batch_mean)
    shape = tuple(router_logits.shape) + (capacity,)
    combine = torch.zeros(shape, dtype=torch.float32, device=device)
    dispatch = torch.zeros(shape, dtype=torch.bool, device=device)
    counts = torch.zeros((num_groups, num_experts), dtype=torch.int64,
                         device=device)
    slots = torch.arange(capacity, device=device)
    for rank in range(k):
        choice = F.one_hot(indices[..., rank], num_experts)  # (G, S, E)
        # position of each token inside its chosen expert's buffer
        position = torch.cumsum(choice, dim=1) - choice + counts[:, None, :]
        within = (position < capacity) & (choice > 0)
        # one_hot(position, C): all-False past the capacity
        slot = position[..., None] == slots  # (G, S, E, C)
        dispatch_r = within[..., None] & slot
        combine = combine + gates[..., rank, None, None] * dispatch_r
        dispatch = dispatch | dispatch_r
        counts = counts + (choice * within).sum(dim=1)
    return combine, dispatch, aux_loss


def top_k_routing_compact(router_logits, k, capacity, batch_mean=None):
    """Slot-index routing: ``top_k_routing``'s policy without the
    (G, S, E, C) one-hots.

    Returns ``(gates, slot, aux_loss)``: gates (G, k, S) fp32,
    rank-major (not zeroed for dropped tokens: the combine gather reads
    a zero row for them); slot (G, k*S) int64, the flat ``expert *
    capacity + position`` per (rank, token), rank-major, dropped tokens
    at the out-of-range ``E * capacity`` (the zero-pad row). A token's
    position counts every prior assignment to its expert in rank-major
    order, dropped ones too: a prior overflow forces >= C either way.
    ``batch_mean``: ``_router_probs``'s."""
    num_groups, seq, num_experts = router_logits.shape
    gates, indices, aux_loss = _router_probs(router_logits, k, batch_mean)
    e_flat = indices.transpose(1, 2).reshape(num_groups, k * seq)  # (G, kS)
    onehot = F.one_hot(e_flat, num_experts)
    prior = torch.cumsum(onehot, dim=1) - onehot  # (G, kS, E)
    position = torch.gather(prior, 2, e_flat[:, :, None])[..., 0]
    slot = torch.where(
        position < capacity,
        e_flat * capacity + position,
        torch.full_like(position, num_experts * capacity),
    )
    return gates.transpose(1, 2), slot, aux_loss


def invert_slots(slot, n_slots):
    """(G, kS) slot ids -> (G, n_slots) flat filler index per slot (the
    sentinel kS for an empty slot). Valid slot ids are unique by
    construction; only the dummy slot n_slots collides, and its column
    is sliced off. The one scatter of the compact form, on int64 ids."""
    num_groups, flat = slot.shape
    j_ids = torch.arange(flat, device=slot.device).expand(num_groups, flat)
    j_for_slot = torch.full((num_groups, n_slots + 1), flat,
                            dtype=torch.int64, device=slot.device)
    return j_for_slot.scatter(1, slot, j_ids)[:, :n_slots]


def _pad_row(t):
    """``t`` (G, N, M) with a zero row appended along axis 1."""
    return torch.cat([t, t.new_zeros((t.shape[0], 1, t.shape[2]))], dim=1)


def _gather_rows(t, index):
    """``t[g, index[g, i]]`` for (G, N, M) ``t`` and (G, I) ``index``."""
    return torch.gather(t, 1, index[:, :, None].expand(-1, -1, t.shape[2]))


def _filler_token(j_for_slot, flat, seq):
    """Each slot's token (seq, the pad row, for an empty slot)."""
    return torch.where(j_for_slot == flat, seq, j_for_slot % seq)


class _DispatchGather(torch.autograd.Function):
    """x (G, S, M) -> (G, E*C, M): each slot's filler token's row, zero
    for an empty slot. Backward: dx[g, s] = sum_r d_out[g, slot[g, r*S
    + s]], a gather through the forward index (dropped ranks hit the
    zero pad row)."""

    @staticmethod
    def forward(ctx, x, slot, j_for_slot):
        ctx.save_for_backward(slot)
        ctx.x_shape = x.shape
        token = _filler_token(j_for_slot, slot.shape[1], x.shape[1])
        return _gather_rows(_pad_row(x), token)

    @staticmethod
    def backward(ctx, d_out):
        (slot,) = ctx.saved_tensors
        num_groups, seq, dim = ctx.x_shape
        k = slot.shape[1] // seq
        rows = _gather_rows(_pad_row(d_out), slot)
        dx = rows.reshape(num_groups, k, seq, dim).sum(dim=1)
        return dx, None, None


class _CombineGather(torch.autograd.Function):
    """eo_flat (G, E*C, M), gates (G, k, S) -> y (G, S, M): each (rank,
    token)'s slot row weighted by its gate, summed over ranks. Both
    cotangents are gathers: d_eo[g, n] = gate of n's filler times
    dy[g, n's filler token] (a slot has at most one filler: the inverse
    index), and d_gates[g, r, s] = <dy[g, s], eo[g, slot[g, r*S + s]]>
    (the forward's rows gathered again, summed in fp32)."""

    @staticmethod
    def forward(ctx, eo_flat, gates, slot, j_for_slot):
        ctx.save_for_backward(eo_flat, gates, slot, j_for_slot)
        num_groups, _, dim = eo_flat.shape
        k = gates.shape[1]
        seq = slot.shape[1] // k
        rows = _gather_rows(_pad_row(eo_flat), slot).reshape(
            num_groups, k, seq, dim)
        return (rows * gates[..., None].to(rows.dtype)).sum(dim=1)

    @staticmethod
    def backward(ctx, dy):
        eo_flat, gates, slot, j_for_slot = ctx.saved_tensors
        num_groups, _, dim = eo_flat.shape
        k = gates.shape[1]
        flat = slot.shape[1]
        seq = flat // k
        # d_gates: the forward's row gather again (cheaper than keeping
        # the (G, kS, M) rows alive)
        rows = _gather_rows(_pad_row(eo_flat), slot).reshape(
            num_groups, k, seq, dim)
        d_gates = (rows.float() * dy[:, None].float()).sum(dim=-1).to(
            gates.dtype)
        # d_eo: dy gathered by each slot's filler token, weighted by the
        # filler's gate (an empty slot's sentinel hits the zero pads)
        token = _filler_token(j_for_slot, flat, seq)
        gate_flat_pad = torch.cat(
            [gates.reshape(num_groups, flat),
             gates.new_zeros((num_groups, 1))], dim=1)
        d_rows = _gather_rows(_pad_row(dy), token)
        gate_for_slot = torch.gather(gate_flat_pad, 1, j_for_slot)
        d_eo = (d_rows * gate_for_slot[:, :, None].to(d_rows.dtype)).to(
            eo_flat.dtype)
        return d_eo, d_gates, None, None


def moe_dispatch_compact(x, slot, num_experts, capacity, j_for_slot=None):
    """Token stream -> per-expert buffers by an inverse-permutation
    gather. x (G, S, M), slot (G, k*S) from ``top_k_routing_compact``
    -> (E, G, C, M), as ``moe_dispatch(x, dispatch)``: a slot holds its
    token's row, an empty slot zeros. Pass ``j_for_slot =
    invert_slots(slot, E*C)`` when the caller also combines, so the
    inversion runs once."""
    num_groups, _, dim = x.shape
    if j_for_slot is None:
        j_for_slot = invert_slots(slot, num_experts * capacity)
    out = _DispatchGather.apply(x, slot, j_for_slot)
    return out.reshape(num_groups, num_experts, capacity, dim).transpose(0, 1)


def moe_combine_compact(expert_out, slot, gates, j_for_slot=None):
    """Per-expert buffers -> token stream: each (rank, token)'s slot row
    gathered back and summed over ranks, weighted by the gates.
    expert_out (E, G, C, M), slot (G, k*S), gates (G, k, S) -> (G, S, M).
    A dropped token reads the zero pad row: zero output and a zero gate
    gradient, as ``moe_combine``'s zero combine weights give."""
    num_experts, num_groups, capacity, dim = expert_out.shape
    eo_flat = expert_out.transpose(0, 1).reshape(
        num_groups, num_experts * capacity, dim)
    if j_for_slot is None:
        j_for_slot = invert_slots(slot, num_experts * capacity)
    return _CombineGather.apply(eo_flat, gates, slot, j_for_slot)


def moe_dispatch(x, dispatch):
    """Token stream -> per-expert buffers: x (G, S, M), dispatch
    (G, S, E, C) -> (E, G, C, M)."""
    return torch.einsum("gsec,gsm->egcm", dispatch.to(x.dtype), x)


def moe_combine(expert_out, combine):
    """Per-expert buffers -> token stream, weighted by the gates:
    expert_out (E, G, C, M), combine (G, S, E, C) -> (G, S, M)."""
    return torch.einsum("gsec,egcm->gsm", combine.to(expert_out.dtype),
                        expert_out)

"""Mixture-of-experts transformer LM (port of
elasticdl_tpu/models/moe_transformer.py: the model and the model-zoo
contract).

Every other block (the odd ones) swaps the dense MLP for a top-k routed
expert MLP (ops/moe.py); the rest are the dense LM's blocks, and
attention goes through ``ops.attention`` as the dense LM's does (K4
forward, K5 and K6 backward on the card).

The mesh surface is the reference's: ``mesh`` (parallel/mesh.py),
``_constrain`` (its sharding hints, skipped without a mesh),
``moe_sharding_rules``, ``sharding_rules`` and ``batch_spec``. Under
parallel/spmd_trainer.py the expert weights' leading dim is split over
``ep`` and each expert's FFN over ``tp``: every rank of (tp, ep) routes
the same tokens (the batch is split over the data axes only), runs its
own experts' blocks on its own slots of the dispatch, and the combine's
partial sums add over (tp, ep) in one ``mesh_psum``. Attention and the
dense blocks are the dense LM's, tensor-parallel over tp. Without a
mesh the model computes what the reference computes without one.

Weights cross over by name (``params_from_flax`` / ``flax_params``):
the dense LM's names plus, under a MoE block,
``block_i/moe_mlp/router/kernel`` (Dense, (M, E)), ``w_up`` (E, M, F)
and ``w_down`` (E, F, M), the last two in the reference's layout.
"""

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from elasticdl_tpu_torch.data.example import decode_example
from elasticdl_tpu_torch.models import transformer
from elasticdl_tpu_torch.models.layers import lecun_normal
from elasticdl_tpu_torch.models.transformer import (
    LAYER_NORM_EPS,
    Attention,
    Block,
    vocab_embed,
    vocab_logits,
)
from elasticdl_tpu_torch.ops.moe import (
    expert_capacity,
    invert_slots,
    moe_combine,
    moe_combine_compact,
    moe_dispatch,
    moe_dispatch_compact,
    top_k_routing,
    top_k_routing_compact,
)
from elasticdl_tpu_torch.parallel.collectives import (
    mesh_batch_mean,
    mesh_psum,
    mesh_replicate,
)
from elasticdl_tpu_torch.parallel.mesh import DATA_AXES, MODEL_AXES
from elasticdl_tpu_torch.parallel.sharding import PartitionSpec as P
from elasticdl_tpu_torch.parallel.sharding import ShardingRules, entry_axes
from elasticdl_tpu_torch.train import metrics
from elasticdl_tpu_torch.train.losses import sparse_softmax_cross_entropy
from elasticdl_tpu_torch.train.optimizers import create_optimizer

DISPATCH_IMPLS = ("auto", "onehot", "compact")


def _model_split(mesh):
    """The live model axes (tp, ep) of ``mesh``; () without a mesh."""
    return () if mesh is None else mesh.live_axes(MODEL_AXES)


def _constrain(x, mesh, spec):
    """The reference's sharding hint for eager ranks: ``x``, the same on
    every rank of the model axes (tp, ep), feeds per-rank partial work
    there, so it enters through ``mesh_replicate`` (its gradient
    all-reduced over them), and each dim ``spec`` splits over a live
    model axis is cut to this rank's block. The data axes are already
    local (each rank holds its rows). Skipped without a mesh (single
    device) or with no model axis above 1."""
    if not _model_split(mesh):
        return x
    x = mesh_replicate(x, MODEL_AXES, mesh=mesh)
    for dim, entry in enumerate(spec):
        axes = [a for a in entry_axes(entry)
                if a in MODEL_AXES and mesh.shape[a] > 1]
        if axes:
            size = x.shape[dim] // mesh.size(axes)
            x = x.narrow(dim, mesh.index(axes) * size, size)
    return x


class MoeMlp(nn.Module):
    """Top-k routed expert FFN (GShard dispatch, Switch aux loss); the
    forward returns ``(y, aux_loss)``.

    ``dispatch_impl``: ``"onehot"`` (and ``"auto"``, the reference's
    measured default) contracts the (G, S, E, C) one-hot dispatch and
    combine tensors by einsum; ``"compact"`` routes by slot ids and
    gathers, with gather-only backwards. Both give the same outputs and
    gradients up to rounding. The expert weights ``w_up`` (E, M, F) and
    ``w_down`` (E, F, M) start lecun-normal over flax's fan-in for
    those shapes (E*M and E*F)."""

    def __init__(self, dim, num_experts, mlp_ratio=4, top_k=2,
                 capacity_factor=1.25, dispatch_impl="auto", mesh=None):
        super().__init__()
        self.mesh = mesh
        if dispatch_impl not in DISPATCH_IMPLS:
            raise ValueError("dispatch_impl must be one of %s, got %r"
                             % (DISPATCH_IMPLS, dispatch_impl))
        self.num_experts = num_experts
        self.top_k = top_k
        self.capacity_factor = capacity_factor
        self.dispatch_impl = dispatch_impl
        ff = dim * mlp_ratio
        self.router = nn.Linear(dim, num_experts, bias=False)
        self.w_up = nn.Parameter(
            lecun_normal((num_experts, dim, ff), num_experts * dim))
        self.w_down = nn.Parameter(
            lecun_normal((num_experts, ff, dim), num_experts * ff))

    def forward(self, x):
        _, seq, _ = x.shape
        capacity = expert_capacity(seq, self.num_experts, self.top_k,
                                   self.capacity_factor)
        router_logits = self.router(x)
        # the aux loss's expert fractions over the whole batch, which
        # the data axes split
        batch_mean = None
        if self.mesh is not None and self.mesh.live_axes(DATA_AXES):
            batch_mean = functools.partial(mesh_batch_mean, axes=DATA_AXES,
                                           mesh=self.mesh)
        compact = self.dispatch_impl == "compact"
        if compact:
            gates, slot, aux_loss = top_k_routing_compact(
                router_logits, self.top_k, capacity, batch_mean)
            # one inversion shared by dispatch and combine
            j_for_slot = invert_slots(slot, self.num_experts * capacity)
            expert_in = moe_dispatch_compact(x, slot, self.num_experts,
                                             capacity, j_for_slot=j_for_slot)
        else:
            combine, dispatch, aux_loss = top_k_routing(
                router_logits, self.top_k, capacity, batch_mean)
            expert_in = moe_dispatch(x, dispatch)  # (E, G, C, M)
        # this rank's experts (all of them without an ep split)
        expert_in = _constrain(expert_in, self.mesh,
                               P("ep", DATA_AXES, None, None))
        h = torch.einsum("egcm,emf->egcf", expert_in, self.w_up.to(x.dtype))
        h = F.gelu(h, approximate="tanh")
        out = torch.einsum("egcf,efm->egcm", h, self.w_down.to(x.dtype))
        split = _model_split(self.mesh)
        if compact:
            if split:
                # the slots index every expert: the others' rows are zero
                first = expert_in.shape[0] * (
                    self.mesh.index("ep") if "ep" in split else 0)
                out = F.pad(out, (0, 0, 0, 0, 0, 0, first,
                                  self.num_experts - first - out.shape[0]))
                gates = _constrain(gates, self.mesh, P())
            y = moe_combine_compact(out, slot, gates, j_for_slot=j_for_slot)
        else:
            y = moe_combine(out, _constrain(combine, self.mesh,
                                            P(DATA_AXES, None, "ep", None)))
        # the experts' and the FFN blocks' partial sums
        if split:
            y = mesh_psum(y, split, mesh=self.mesh)
        return y, aux_loss


class MoeBlock(nn.Module):
    """Pre-LayerNorm block: the dense LM's attention, then ``MoeMlp``;
    returns ``(x, aux_loss)``."""

    def __init__(self, dim, num_heads, num_experts, mlp_ratio=4, top_k=2,
                 capacity_factor=1.25, attention_impl="auto",
                 dispatch_impl="auto", mesh=None):
        super().__init__()
        self.ln_attn = nn.LayerNorm(dim, eps=LAYER_NORM_EPS)
        self.attn = Attention(dim, num_heads, attention_impl, mesh=mesh)
        self.ln_mlp = nn.LayerNorm(dim, eps=LAYER_NORM_EPS)
        self.moe_mlp = MoeMlp(dim, num_experts, mlp_ratio, top_k,
                              capacity_factor, dispatch_impl, mesh)

    def forward(self, x):
        x = x + self.attn(self.ln_attn(x))
        y, aux_loss = self.moe_mlp(self.ln_mlp(x))
        return x + y, aux_loss


class MoeTransformerLM(nn.Module):
    """Decoder-only LM with MoE FFNs in every other block.

    In training mode (``model.train()``) the forward returns
    ``{"logits", "aux_loss"}``: the router's load-balance penalty,
    ``aux_loss_weight`` times the sum over MoE blocks, must reach the
    loss. In eval mode it returns bare logits, so the metrics, the
    export and the serving engine see the dense LM's surface."""

    def __init__(self, vocab_size=32000, num_layers=4, num_heads=8,
                 embed_dim=512, mlp_ratio=4, num_experts=8, top_k=2,
                 capacity_factor=1.25, aux_loss_weight=0.01,
                 attention_impl="auto", dispatch_impl="auto", mesh=None):
        super().__init__()
        self.num_heads = num_heads
        self.mesh = mesh
        self.aux_loss_weight = aux_loss_weight
        self.wte = nn.Embedding(vocab_size, embed_dim)
        self.blocks = nn.ModuleList(
            MoeBlock(embed_dim, num_heads, num_experts, mlp_ratio, top_k,
                     capacity_factor, attention_impl, dispatch_impl, mesh)
            if i % 2 == 1 else
            Block(embed_dim, num_heads, mlp_ratio, attention_impl, mesh=mesh)
            for i in range(num_layers)
        )
        self.ln_f = nn.LayerNorm(embed_dim, eps=LAYER_NORM_EPS)
        self.lm_head = nn.Linear(embed_dim, vocab_size, bias=False)

    def forward(self, tokens):
        x = vocab_embed(tokens.long(), self.wte.weight, self.mesh)
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        for block in self.blocks:
            if isinstance(block, MoeBlock):
                x, aux = block(x)
                aux_total = aux_total + aux
            else:
                x = block(x)
        logits = vocab_logits(self.ln_f(x), self.lm_head, self.mesh)
        if self.training:
            return {"logits": logits,
                    "aux_loss": self.aux_loss_weight * aux_total}
        return logits

    def flax_params(self, state):
        """``{name: tensor}`` in this module's names -> the export's flat
        flax names (train/export.py reads it)."""
        return transformer.params_to_flax(state, self.num_heads,
                                          MOE_BLOCK_LEAVES)

    def params_from_flax(self, flat):
        return params_from_flax(flat)

    def flax_leaf(self, name):
        """``(flax path, layout kind)`` of the weight ``name``."""
        return transformer.flax_leaf(name, MOE_BLOCK_LEAVES)


# a MoE block's flax leaves: the dense block's attention and norms, and
# the expert MLP's (the dense MLP's leaves never occur under it)
MOE_BLOCK_LEAVES = dict(
    transformer._BLOCK_LEAVES,
    **{
        "moe_mlp/router/kernel": ("moe_mlp.router.weight", "dense"),
        "moe_mlp/w_up": ("moe_mlp.w_up", "copy"),
        "moe_mlp/w_down": ("moe_mlp.w_down", "copy"),
    },
)


def params_from_flax(flat):
    """``{flax name: array}`` (the reference's MoeTransformerLM, or an
    export of either package) -> this module's state_dict."""
    return transformer.params_from_flax(flat, MOE_BLOCK_LEAVES)


# ---------------------------------------------------------------------------
# Sharding rules: transformer TP rules + expert-dim ep sharding
# ---------------------------------------------------------------------------


def moe_sharding_rules():
    """Dense-block rules plus expert weights over (ep, fsdp/tp), on flax
    paths and layouts (parallel/sharding.py lays them over the port's).

    w_up (E, M, F): experts over ep, FFN dim over tp (Megatron within
    the expert); w_down (E, F, M) transposed to match. The router stays
    replicated: it is tiny and on the critical path of every token.
    """
    return ShardingRules(
        rules=[
            (r"router/kernel$", P()),
            (r"w_up$", P("ep", "fsdp", "tp")),
            (r"w_down$", P("ep", "tp", "fsdp")),
            (r"(query|key|value)/kernel$", P("fsdp", "tp", None)),
            (r"out_proj/kernel$", P("tp", None, "fsdp")),
            (r"mlp_up/kernel$", P("fsdp", "tp")),
            (r"mlp_down/kernel$", P("tp", "fsdp")),
            (r"wte/embedding$", P("tp", "fsdp")),
            (r"lm_head/kernel$", P("fsdp", "tp")),
            (r".*", P()),
        ],
        default_spec=P(),
    )


def batch_spec():
    return P(DATA_AXES, "sp")


# ---------------------------------------------------------------------------
# Model-zoo contract
# ---------------------------------------------------------------------------


def custom_model(vocab_size=32000, num_layers=12, num_heads=12,
                 embed_dim=768, num_experts=8, mlp_ratio=4, top_k=2,
                 capacity_factor=1.25, attention_impl="auto",
                 dispatch_impl="auto", mesh=None):
    """The zoo MoE LM (the reference's custom_model widths: vocab 32000,
    12 layers, 12 heads, d 768, 8 experts); ``--model_params`` may
    override any width, the routing and the impls. ``mesh``: the SPMD
    trainer's (tp and ep compute on the rank's blocks)."""
    return MoeTransformerLM(
        vocab_size=vocab_size,
        num_layers=num_layers,
        num_heads=num_heads,
        embed_dim=embed_dim,
        mlp_ratio=mlp_ratio,
        num_experts=num_experts,
        top_k=top_k,
        capacity_factor=capacity_factor,
        attention_impl=attention_impl,
        dispatch_impl=dispatch_impl,
        mesh=mesh,
    )


def loss(labels, predictions):
    """Next-token cross entropy per sample, plus the aux loss in
    training. The aux loss is an fp32 scalar: added to every
    per-sample loss it shifts the masked mean by exactly itself. The
    per-sample mean is taken in the logits' dtype and promoted as the
    reference's ``bf16 + f32`` promotes it."""
    if isinstance(predictions, dict):
        logits, aux = predictions["logits"], predictions["aux_loss"]
    else:
        logits, aux = predictions, None
    per_token = sparse_softmax_cross_entropy(labels[:, 1:], logits[:, :-1])
    per_sample = per_token.mean(dim=-1)
    if aux is None:
        return per_sample
    dtype = torch.promote_types(per_sample.dtype, aux.dtype)
    return per_sample.to(dtype) + aux


def optimizer():
    return create_optimizer("AdamW", learning_rate=3e-4, weight_decay=0.01)


def sharding_rules():
    return moe_sharding_rules()


def dataset_fn(dataset, mode=None, metadata=None):
    def parse(payload):
        tokens = decode_example(payload)["tokens"].astype(np.int32)
        # LM: the sequence is both input and label (the shift is in loss)
        return tokens, tokens

    return dataset.map(parse)


def eval_metrics_fn():
    return {"accuracy": metrics.Accuracy()}


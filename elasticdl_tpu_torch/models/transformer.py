"""Decoder-only transformer LM (port of elasticdl_tpu/models/transformer.py:
the model and the model-zoo contract).

Pre-LayerNorm blocks, tanh-approximate GELU MLP, rotary position
embeddings, untied LM head, no biases, dropout after the attention
projection and the MLP, per-block remat -- the flax model's function,
as ``nn.Module``s. Attention goes through ``ops.attention`` and so
through the flash kernels on the card: K4 forward, K5 and K6 backward.

Numerics kept from flax: LayerNorm epsilon is 1e-6 (torch's default is
1e-5), ``nn.gelu`` is the tanh approximation, and rotary angles are
computed in fp32 and the result cast back to the input dtype.

Weights cross over by name: ``params_from_flax`` maps the flax tree
(``block_0/attn/query/kernel``, ...) onto this module's state_dict and
``params_to_flax`` maps it back, so an export written by either package
serves on either. Layouts: DenseGeneral q/k/v kernels are
``(dim, heads, head_dim)`` and out_proj ``(heads, head_dim, dim)``;
Dense kernels are ``(in, out)``, the transpose of an ``nn.Linear``
weight; Embed is ``(vocab, dim)``. ``flax_leaf`` names a weight's flax
path and layout, which parallel/sharding.py reads to lay the
reference's ``sharding_rules`` over the port's weights.

Tensor parallelism (``mesh`` with tp > 1, parallel/spmd_trainer.py):
the model computes on its tp blocks of the weights, Megatron's layout
as the reference's rules give it. q, k, v and mlp_up hold their rank's
heads or features (attention runs K4-K6 on the rank's own heads) and
out_proj and mlp_down the matching inputs, whose partial sums one
``mesh_psum`` a branch adds; the branch's input enters through
``mesh_replicate`` (its gradient all-reduced). wte and lm_head hold the
rank's rows of the vocabulary: the lookup masks the other ranks' ids
and sums over tp, and the logits gather over tp. Without a mesh (or at
tp 1) none of it runs.

Sequence parallelism (``mesh`` with sp > 1, ``attention_impl`` "ring"
or "ulysses", as the reference dispatches them): each rank holds its
block of every sequence (the batch's dim 1 over sp, ``batch_spec``).
The reference runs the model on global arrays; here three places need
the rank's place in the sequence. Rotary positions start at the
block's first global position (``rotary_embedding``'s ``offset``);
attention runs ops/ring_attention.py over the sp ring; and ``loss``
shifts the labels across the block boundary (the next rank's first
label arrives by a ``mesh_ppermute``) and divides each sample's token
sum by the global S - 1, so the sp ranks' partial losses add up to the
reference's per-sample mean (the trainer sums them over sp).
"""

import functools
import re

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from elasticdl_tpu_torch.data.example import decode_example
from elasticdl_tpu_torch.models.layers import Dropout
from elasticdl_tpu_torch.ops.attention import dot_product_attention
from elasticdl_tpu_torch.ops.ring_attention import (
    ring_attention,
    ulysses_attention,
)
from elasticdl_tpu_torch.parallel.collectives import (
    mesh_gather_replicated,
    mesh_ppermute,
    mesh_psum,
    mesh_replicate,
)
from elasticdl_tpu_torch.parallel.mesh import DATA_AXES, current_mesh
from elasticdl_tpu_torch.parallel.sharding import PartitionSpec as P
from elasticdl_tpu_torch.parallel.sharding import ShardingRules
from elasticdl_tpu_torch.train import metrics
from elasticdl_tpu_torch.train.losses import sparse_softmax_cross_entropy
from elasticdl_tpu_torch.train.optimizers import create_optimizer

LAYER_NORM_EPS = 1e-6  # flax nn.LayerNorm's default


SEQ_PARALLEL_IMPLS = ("ring", "ulysses")


def rotary_embedding(x, base=10000.0, seq_axis=2, offset=0):
    """Apply RoPE; seq_axis=2 for (B, H, S, d), 1 for (B, S, H, d).
    ``offset``: the global position of the block's first row (a rank's
    block of a sequence split over sp)."""
    seq, dim = x.shape[seq_axis], x.shape[-1]
    half = dim // 2
    freqs = base ** (
        -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    )
    angles = (
        torch.arange(offset, offset + seq, dtype=torch.float32,
                     device=x.device)[:, None]
        * freqs[None, :]
    )
    shape = [1] * x.dim()
    shape[seq_axis], shape[-1] = seq, half
    cos = torch.cos(angles).reshape(shape)
    sin = torch.sin(angles).reshape(shape)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat(
        [x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1
    ).to(x.dtype)


def tp_live(mesh):
    """Whether ``mesh`` splits the model over tp."""
    return mesh is not None and mesh.shape["tp"] > 1


def sp_live(mesh):
    """Whether ``mesh`` splits the sequence over sp."""
    return mesh is not None and mesh.shape["sp"] > 1


def tp_enter(x, mesh):
    """``x`` entering a tp-split branch (``mesh_replicate``), or ``x``."""
    return mesh_replicate(x, "tp", mesh=mesh) if tp_live(mesh) else x


def tp_leave(x, mesh):
    """A tp-split branch's partial sums added over tp, or ``x``."""
    return mesh_psum(x, "tp", mesh=mesh) if tp_live(mesh) else x


def vocab_embed(tokens, weight, mesh):
    """``weight[tokens]`` with ``weight`` this rank's rows of a
    vocabulary split over tp: ids outside them look up zeros, and the
    ranks' lookups sum."""
    if not tp_live(mesh):
        return F.embedding(tokens, weight)
    rows = weight.shape[0]
    ids = tokens - mesh.index("tp") * rows
    inside = (ids >= 0) & (ids < rows)
    x = F.embedding(ids.clamp(0, rows - 1), weight)
    return mesh_psum(x * inside[..., None].to(x.dtype), "tp", mesh=mesh)


def vocab_logits(x, head, mesh):
    """``head(x)`` over the whole vocabulary, with ``head`` holding this
    rank's rows of a vocabulary split over tp: the blocks gather."""
    if not tp_live(mesh):
        return head(x)
    return mesh_gather_replicated(head(tp_enter(x, mesh)), "tp", dim=-1,
                                  mesh=mesh)


class Attention(nn.Module):
    def __init__(self, dim, num_heads, attention_impl="auto", dropout=0.0,
                 mesh=None):
        super().__init__()
        self.num_heads = num_heads
        self.mesh = mesh
        self.attention_impl = attention_impl
        self.query = nn.Linear(dim, dim, bias=False)
        self.key = nn.Linear(dim, dim, bias=False)
        self.value = nn.Linear(dim, dim, bias=False)
        self.out_proj = nn.Linear(dim, dim, bias=False)
        self.dropout = Dropout(dropout)

    def forward(self, x):
        batch, seq, dim = x.shape
        head_dim = dim // self.num_heads
        x = tp_enter(x, self.mesh)
        q = self.query(x)
        # this rank's heads: all of them, or its block under tp
        heads = q.shape[-1] // head_dim
        # (B, S, H*d) -> (B, H, S, d)
        to_bhsd = lambda t: t.view(batch, seq, heads, head_dim).transpose(1, 2)
        # the block's first global position under sp (0 otherwise)
        offset = self.mesh.index("sp") * seq if sp_live(self.mesh) else 0
        q = rotary_embedding(to_bhsd(q), offset=offset)
        k = rotary_embedding(to_bhsd(self.key(x)), offset=offset)
        v = to_bhsd(self.value(x))
        if self.attention_impl == "ring":
            out = ring_attention(q, k, v, self.mesh, causal=True)
        elif self.attention_impl == "ulysses":
            out = ulysses_attention(q, k, v, self.mesh, causal=True)
        else:
            out = dot_product_attention(
                q, k, v, causal=True, impl=self.attention_impl
            )
        out = out.transpose(1, 2).reshape(batch, seq, heads * head_dim)
        return self.dropout(tp_leave(self.out_proj(out), self.mesh))


class Block(nn.Module):
    def __init__(self, dim, num_heads, mlp_ratio=4, attention_impl="auto",
                 dropout=0.0, mesh=None):
        super().__init__()
        self.mesh = mesh
        self.ln_attn = nn.LayerNorm(dim, eps=LAYER_NORM_EPS)
        self.attn = Attention(dim, num_heads, attention_impl, dropout, mesh)
        self.ln_mlp = nn.LayerNorm(dim, eps=LAYER_NORM_EPS)
        self.mlp_up = nn.Linear(dim, dim * mlp_ratio, bias=False)
        self.mlp_down = nn.Linear(dim * mlp_ratio, dim, bias=False)
        self.dropout = Dropout(dropout)

    def forward(self, x):
        x = x + self.attn(self.ln_attn(x))
        h = F.gelu(self.mlp_up(tp_enter(self.ln_mlp(x), self.mesh)),
                   approximate="tanh")
        return x + self.dropout(tp_leave(self.mlp_down(h), self.mesh))


REMAT_POLICIES = ("full", "dots", "flash")
# what each policy keeps from a block's forward for its backward (the
# rest is recomputed): "dots" the matmul outputs of the projections and
# the MLP (jax's dots_with_no_batch_dims_saveable) and K4's (o, lse),
# "flash" only K4's (o, lse), "full" nothing
_DOTS = ("aten.mm.default", "aten.addmm.default")
_FLASH = ("edl.flash_attention_fwd.default",)
_SAVED = {"full": (), "dots": _DOTS + _FLASH, "flash": _FLASH}


def _remat_context(policy):
    """``torch.utils.checkpoint``'s ``context_fn`` for ``policy``: a
    selective-checkpoint policy that saves the named ops' outputs."""
    from torch.utils.checkpoint import (
        CheckpointPolicy,
        create_selective_checkpoint_contexts,
    )

    saved = _SAVED[policy]

    def policy_fn(ctx, op, *args, **kwargs):
        if str(op) in saved:
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE

    return lambda: create_selective_checkpoint_contexts(policy_fn)


def _run_block(block, names, x, *weights):
    return functional_call(block, dict(zip(names, weights)), (x,))


class TransformerLM(nn.Module):
    """``remat=True`` recomputes each block in the backward
    (``torch.utils.checkpoint``, non-reentrant) under ``remat_policy``:
    "full" saves nothing, so the recompute launches K4 again; "dots"
    saves the matmul outputs and K4's (o, lse); "flash" saves only K4's
    (o, lse), so neither re-launches K4. Dropout masks come from the
    step's seed (``layers.dropout_seed``), so a recompute redraws them."""

    def __init__(self, vocab_size=32000, num_layers=4, num_heads=8,
                 embed_dim=512, mlp_ratio=4, attention_impl="auto",
                 dropout=0.0, remat=False, remat_policy="full", mesh=None):
        super().__init__()
        if remat:
            if remat_policy not in REMAT_POLICIES:
                raise ValueError(
                    "remat_policy must be 'full', 'dots' or 'flash', "
                    "got %r" % (remat_policy,))
            # only the flash kernel's op is what "flash" saves: under
            # another attention impl (ring and ulysses too, as in the
            # reference) the policy would match nothing and silently
            # run as "full"
            if remat_policy == "flash" and attention_impl not in (
                    "auto", "flash", "pallas"):
                raise ValueError(
                    'remat_policy="flash" saves the flash kernel\'s '
                    "outputs; attention_impl=%r never produces them (the "
                    "policy would match nothing and degrade to \"full\")"
                    % (attention_impl,))
        if sp_live(mesh) and attention_impl not in SEQ_PARALLEL_IMPLS:
            raise ValueError(
                "mesh %s splits the sequence over sp: attention_impl must "
                "be 'ring' or 'ulysses' (each rank holds a block of the "
                "sequence), got %r" % (mesh, attention_impl))
        self.num_heads = num_heads
        self.mesh = mesh
        self.remat = bool(remat)
        self.remat_policy = remat_policy
        self.wte = nn.Embedding(vocab_size, embed_dim)
        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads, mlp_ratio, attention_impl, dropout,
                  mesh)
            for _ in range(num_layers)
        )
        self.ln_f = nn.LayerNorm(embed_dim, eps=LAYER_NORM_EPS)
        self.lm_head = nn.Linear(embed_dim, vocab_size, bias=False)

    def forward(self, tokens):
        x = vocab_embed(tokens.long(), self.wte.weight, self.mesh)
        remat = self.remat and torch.is_grad_enabled()
        if remat:
            from torch.utils.checkpoint import checkpoint

            kwargs = {"use_reentrant": False}
            if self.remat_policy != "full":
                kwargs["context_fn"] = _remat_context(self.remat_policy)
        for block in self.blocks:
            if not remat:
                x = block(x)
                continue
            # the block's weights go in as inputs: the recompute runs in
            # the backward, after the step's functional_call has put the
            # module's own (fp32) weights back, and must see the ones the
            # forward saw (under bf16 compute, their bf16 casts)
            names, weights = zip(*block.named_parameters())
            x = checkpoint(functools.partial(_run_block, block, names), x,
                           *weights, **kwargs)
        return vocab_logits(self.ln_f(x), self.lm_head, self.mesh)

    def flax_params(self, state):
        """``{name: tensor}`` in this module's names -> the export's flat
        flax names (train/export.py reads it)."""
        return params_to_flax(state, self.num_heads)

    def params_from_flax(self, flat):
        return params_from_flax(flat)

    def flax_leaf(self, name):
        """``(flax path, layout kind)`` of the weight ``name``."""
        return flax_leaf(name)


# ---------------------------------------------------------------------------
# flax names <-> state_dict
# ---------------------------------------------------------------------------

_BLOCK = re.compile(r"^block_(\d+)/(.+)$")
# flax leaf (under a block) -> (torch leaf, kind); kind says how the
# kernel's layout maps onto the nn.Linear weight
_BLOCK_LEAVES = {
    "ln_attn/scale": ("ln_attn.weight", "copy"),
    "ln_attn/bias": ("ln_attn.bias", "copy"),
    "ln_mlp/scale": ("ln_mlp.weight", "copy"),
    "ln_mlp/bias": ("ln_mlp.bias", "copy"),
    "attn/query/kernel": ("attn.query.weight", "in_heads"),
    "attn/key/kernel": ("attn.key.weight", "in_heads"),
    "attn/value/kernel": ("attn.value.weight", "in_heads"),
    "attn/out_proj/kernel": ("attn.out_proj.weight", "heads_out"),
    "mlp_up/kernel": ("mlp_up.weight", "dense"),
    "mlp_down/kernel": ("mlp_down.weight", "dense"),
}
_TOP_LEAVES = {
    "wte/embedding": ("wte.weight", "copy"),
    "ln_f/scale": ("ln_f.weight", "copy"),
    "ln_f/bias": ("ln_f.bias", "copy"),
    "lm_head/kernel": ("lm_head.weight", "dense"),
}
_TORCH_BLOCK = re.compile(r"^blocks\.(\d+)\.(.+)$")
_TOP_FROM_TORCH = {t: (f, k) for f, (t, k) in _TOP_LEAVES.items()}


def _torch_name(flax_name, block_leaves=_BLOCK_LEAVES):
    match = _BLOCK.match(flax_name)
    if match:
        leaf, kind = block_leaves[match.group(2)]
        return "blocks.%s.%s" % (match.group(1), leaf), kind
    return _TOP_LEAVES[flax_name]


def flax_leaf(name, block_leaves=_BLOCK_LEAVES):
    """``(flax path, layout kind)`` of the state_dict name ``name``:
    the inverse of ``_torch_name``."""
    match = _TORCH_BLOCK.match(name)
    if match:
        from_torch = {t: (f, k) for f, (t, k) in block_leaves.items()}
        flax_name, kind = from_torch[match.group(2)]
        return "block_%s/%s" % (match.group(1), flax_name), kind
    return _TOP_FROM_TORCH[name]


def params_from_flax(flat, block_leaves=_BLOCK_LEAVES):
    """``{flax name: array}`` -> state_dict of fp32-or-native tensors.
    Names may carry the export's ``params/`` prefix. ``block_leaves``:
    the flax leaf under a block -> (torch leaf, kind) table (the MoE LM
    passes its own, with the expert leaves)."""
    state = {}
    for name, value in flat.items():
        name = name[len("params/"):] if name.startswith("params/") else name
        target, kind = _torch_name(name, block_leaves)
        value = np.asarray(value)
        if kind == "in_heads":      # (dim, H, d) -> weight (H*d, dim)
            value = value.reshape(value.shape[0], -1).T
        elif kind == "heads_out":   # (H, d, dim) -> weight (dim, H*d)
            value = value.reshape(-1, value.shape[-1]).T
        elif kind == "dense":       # (in, out) -> weight (out, in)
            value = value.T
        state[target] = torch.from_numpy(np.array(value, order="C"))
    return state


def params_to_flax(state_dict, num_heads, block_leaves=_BLOCK_LEAVES):
    """state_dict -> ``{flax name: fp32 ndarray}`` (the export's names,
    without the ``params/`` prefix)."""
    from_torch = {t: (f, k) for f, (t, k) in block_leaves.items()}
    flat = {}
    for name, tensor in state_dict.items():
        value = tensor.detach().float().cpu().numpy()
        match = _TORCH_BLOCK.match(name)
        if match:
            flax_leaf, kind = from_torch[match.group(2)]
            flax_name = "block_%s/%s" % (match.group(1), flax_leaf)
        else:
            flax_name, kind = _TOP_FROM_TORCH[name]
        if kind == "in_heads":      # weight (H*d, dim) -> (dim, H, d)
            value = value.T.reshape(value.shape[1], num_heads, -1)
        elif kind == "heads_out":   # weight (dim, H*d) -> (H, d, dim)
            value = value.T.reshape(num_heads, -1, value.shape[0])
        elif kind == "dense":
            value = value.T
        flat[flax_name] = np.ascontiguousarray(value)
    return flat


# ---------------------------------------------------------------------------
# Model-zoo contract
# ---------------------------------------------------------------------------


def transformer_sharding_rules():
    """Megatron-style TP layout + fsdp on everything big (the
    reference's rules, on flax paths and layouts: parallel/sharding.py
    lays them over the port's weights).

    qkv and mlp-up split output features over tp (their matmuls become
    local); out-proj and mlp-down split input features, after which one
    psum a branch adds the partial sums. Embedding and lm_head split
    vocab.
    """
    return ShardingRules(
        rules=[
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
    """Tokens/labels (B, S): batch over data axes, sequence over sp."""
    return P(DATA_AXES, "sp")


def sharding_rules():
    return transformer_sharding_rules()


def custom_model(vocab_size=32000, num_layers=12, num_heads=12,
                 embed_dim=768, attention_impl="auto", dropout=0.0,
                 remat=False, remat_policy="full", mesh=None):
    """The zoo TransformerLM (elasticdl_tpu/models/transformer.py
    custom_model widths); ``--model_params`` may override any width,
    the attention impl, dropout and remat. ``mesh``: the SPMD trainer's
    (tensor parallelism computes on the rank's blocks)."""
    return TransformerLM(
        vocab_size=vocab_size,
        num_layers=num_layers,
        num_heads=num_heads,
        embed_dim=embed_dim,
        attention_impl=attention_impl,
        dropout=dropout,
        remat=remat,
        remat_policy=remat_policy,
        mesh=mesh,
    )


def loss(labels, predictions):
    """Next-token prediction: logits at t predict the token at t+1.
    Returns a per-sample vector (the trainer applies the batch mask).

    Under an ambient mesh with sp > 1 (the SPMD trainer's step) labels
    and predictions are this rank's block of each sequence: the target
    of the block's last position is the next rank's first label, the
    last rank's last position has none, and the result is this rank's
    share of the per-sample mean over the global S - 1 targets."""
    mesh = current_mesh()
    if not sp_live(mesh):
        logits = predictions[:, :-1]
        targets = labels[:, 1:]
        per_token = sparse_softmax_cross_entropy(targets, logits)
        return per_token.mean(dim=-1)
    sp, index = mesh.shape["sp"], mesh.index("sp")
    seq = labels.shape[1]
    # rank j + 1's first label to rank j (the last rank's is not used)
    following = mesh_ppermute(labels[:, :1].contiguous(), "sp",
                              [(j + 1, j) for j in range(sp - 1)],
                              mesh=mesh)
    targets = torch.cat([labels[:, 1:], following], dim=1)
    per_token = sparse_softmax_cross_entropy(targets, predictions)
    if index == sp - 1:
        per_token = per_token[:, :-1]
    return per_token.sum(dim=-1) / (seq * sp - 1)


def optimizer():
    return create_optimizer("AdamW", learning_rate=3e-4, weight_decay=0.01)


def dataset_fn(dataset, mode=None, metadata=None):
    def parse(payload):
        tokens = decode_example(payload)["tokens"].astype(np.int32)
        # LM: the sequence is both input and label (the shift is in loss)
        return tokens, tokens

    return dataset.map(parse)


def eval_metrics_fn():
    return {"accuracy": metrics.Accuracy()}

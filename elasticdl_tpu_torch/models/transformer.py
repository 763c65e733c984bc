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
weight; Embed is ``(vocab, dim)``.
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
from elasticdl_tpu_torch.train import metrics
from elasticdl_tpu_torch.train.losses import sparse_softmax_cross_entropy
from elasticdl_tpu_torch.train.optimizers import create_optimizer

LAYER_NORM_EPS = 1e-6  # flax nn.LayerNorm's default


def rotary_embedding(x, base=10000.0, seq_axis=2):
    """Apply RoPE; seq_axis=2 for (B, H, S, d), 1 for (B, S, H, d)."""
    seq, dim = x.shape[seq_axis], x.shape[-1]
    half = dim // 2
    freqs = base ** (
        -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    )
    angles = (
        torch.arange(seq, dtype=torch.float32, device=x.device)[:, None]
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


class Attention(nn.Module):
    def __init__(self, dim, num_heads, attention_impl="auto", dropout=0.0):
        super().__init__()
        self.num_heads = num_heads
        self.attention_impl = attention_impl
        self.query = nn.Linear(dim, dim, bias=False)
        self.key = nn.Linear(dim, dim, bias=False)
        self.value = nn.Linear(dim, dim, bias=False)
        self.out_proj = nn.Linear(dim, dim, bias=False)
        self.dropout = Dropout(dropout)

    def forward(self, x):
        batch, seq, dim = x.shape
        heads = self.num_heads
        # (B, S, H*d) -> (B, H, S, d)
        to_bhsd = lambda t: t.view(batch, seq, heads, dim // heads).transpose(1, 2)
        q = rotary_embedding(to_bhsd(self.query(x)))
        k = rotary_embedding(to_bhsd(self.key(x)))
        v = to_bhsd(self.value(x))
        out = dot_product_attention(
            q, k, v, causal=True, impl=self.attention_impl
        )
        out = out.transpose(1, 2).reshape(batch, seq, dim)
        return self.dropout(self.out_proj(out))


class Block(nn.Module):
    def __init__(self, dim, num_heads, mlp_ratio=4, attention_impl="auto",
                 dropout=0.0):
        super().__init__()
        self.ln_attn = nn.LayerNorm(dim, eps=LAYER_NORM_EPS)
        self.attn = Attention(dim, num_heads, attention_impl, dropout)
        self.ln_mlp = nn.LayerNorm(dim, eps=LAYER_NORM_EPS)
        self.mlp_up = nn.Linear(dim, dim * mlp_ratio, bias=False)
        self.mlp_down = nn.Linear(dim * mlp_ratio, dim, bias=False)
        self.dropout = Dropout(dropout)

    def forward(self, x):
        x = x + self.attn(self.ln_attn(x))
        h = F.gelu(self.mlp_up(self.ln_mlp(x)), approximate="tanh")
        return x + self.dropout(self.mlp_down(h))


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
                 dropout=0.0, remat=False, remat_policy="full"):
        super().__init__()
        if remat:
            if remat_policy not in REMAT_POLICIES:
                raise ValueError(
                    "remat_policy must be 'full', 'dots' or 'flash', "
                    "got %r" % (remat_policy,))
            # only the flash kernel's op is what "flash" saves: under
            # another attention impl the policy would match nothing and
            # silently run as "full"
            if remat_policy == "flash" and attention_impl not in (
                    "auto", "flash", "pallas"):
                raise ValueError(
                    'remat_policy="flash" saves the flash kernel\'s '
                    "outputs; attention_impl=%r never produces them (the "
                    "policy would match nothing and degrade to \"full\")"
                    % (attention_impl,))
        self.num_heads = num_heads
        self.remat = bool(remat)
        self.remat_policy = remat_policy
        self.wte = nn.Embedding(vocab_size, embed_dim)
        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads, mlp_ratio, attention_impl, dropout)
            for _ in range(num_layers)
        )
        self.ln_f = nn.LayerNorm(embed_dim, eps=LAYER_NORM_EPS)
        self.lm_head = nn.Linear(embed_dim, vocab_size, bias=False)

    def forward(self, tokens):
        x = self.wte(tokens.long())
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
        return self.lm_head(self.ln_f(x))

    def flax_params(self, state):
        """``{name: tensor}`` in this module's names -> the export's flat
        flax names (train/export.py reads it)."""
        return params_to_flax(state, self.num_heads)

    def params_from_flax(self, flat):
        return params_from_flax(flat)


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
_BLOCK_FROM_TORCH = {t: (f, k) for f, (t, k) in _BLOCK_LEAVES.items()}
_TOP_FROM_TORCH = {t: (f, k) for f, (t, k) in _TOP_LEAVES.items()}


def _torch_name(flax_name):
    match = _BLOCK.match(flax_name)
    if match:
        leaf, kind = _BLOCK_LEAVES[match.group(2)]
        return "blocks.%s.%s" % (match.group(1), leaf), kind
    return _TOP_LEAVES[flax_name]


def params_from_flax(flat):
    """``{flax name: array}`` -> state_dict of fp32-or-native tensors.
    Names may carry the export's ``params/`` prefix."""
    state = {}
    for name, value in flat.items():
        name = name[len("params/"):] if name.startswith("params/") else name
        target, kind = _torch_name(name)
        value = np.asarray(value)
        if kind == "in_heads":      # (dim, H, d) -> weight (H*d, dim)
            value = value.reshape(value.shape[0], -1).T
        elif kind == "heads_out":   # (H, d, dim) -> weight (dim, H*d)
            value = value.reshape(-1, value.shape[-1]).T
        elif kind == "dense":       # (in, out) -> weight (out, in)
            value = value.T
        state[target] = torch.from_numpy(np.array(value, order="C"))
    return state


def params_to_flax(state_dict, num_heads):
    """state_dict -> ``{flax name: fp32 ndarray}`` (the export's names,
    without the ``params/`` prefix)."""
    flat = {}
    for name, tensor in state_dict.items():
        value = tensor.detach().float().cpu().numpy()
        match = _TORCH_BLOCK.match(name)
        if match:
            flax_leaf, kind = _BLOCK_FROM_TORCH[match.group(2)]
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


def custom_model(vocab_size=32000, num_layers=12, num_heads=12,
                 embed_dim=768, attention_impl="auto", dropout=0.0,
                 remat=False, remat_policy="full"):
    """The zoo TransformerLM (elasticdl_tpu/models/transformer.py
    custom_model widths); ``--model_params`` may override any width,
    the attention impl, dropout and remat."""
    return TransformerLM(
        vocab_size=vocab_size,
        num_layers=num_layers,
        num_heads=num_heads,
        embed_dim=embed_dim,
        attention_impl=attention_impl,
        dropout=dropout,
        remat=remat,
        remat_policy=remat_policy,
    )


def loss(labels, predictions):
    """Next-token prediction: logits at t predict the token at t+1.
    Returns a per-sample vector (the trainer applies the batch mask)."""
    logits = predictions[:, :-1]
    targets = labels[:, 1:]
    per_token = sparse_softmax_cross_entropy(targets, logits)
    return per_token.mean(dim=-1)


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

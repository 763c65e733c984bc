"""Pipeline-parallel transformer LM (port of
elasticdl_tpu/models/pipeline_transformer.py).

Decoder blocks are pipeline stages over the ``pp`` mesh axis: their
parameters are one stack ``(num_layers, ...)`` per leaf, laid out
``P("pp")`` (``sharding_rules``), and the forward runs the schedule of
parallel/pipeline.py on each rank's block of the stack. The embedding,
the final norm and the head run on every stage.

The layer order at rest is topology-independent: the flat stack is in
layer order whatever the mesh, and the forward regroups the rank's rows
into its chunks, so a checkpoint written at pp 4 restores onto pp 2 or
one card. The exception is ``device_major_params=True`` (interleaved
schedules only): the stack is stored in the order the ranks hold their
interleaved chunks (``device_major_order``), pinned to (num_stages,
num_chunks), under the key ``blocks_device_major`` instead of
``blocks``, so restoring it into a job with the other layout fails
loudly on the names; ``blocks_to_portable`` and
``blocks_from_portable`` convert.

Each stage applies models/transformer.py's ``Block`` (the same
weights' function as TransformerLM's blocks) to each of its layers
through ``functional_call``. The port's leaves are the block's
``state_dict`` leaves with a leading layer axis: ``blocks.attn.query
.weight`` is ``(num_layers, H*d, dim)``; ``params_from_flax`` and
``flax_params`` convert each layer's layout as transformer.py does.
Dropout is not supported (nor in the reference); nor are "ring" and
"ulysses" attention, which need the model's sp axis while the stages
run over pp (the reference's nested shard_map cannot run them either).
``schedule`` (port addition) picks the pipeline schedule, "1f1b" by
default as the reference's ``pipeline_apply``.
"""

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from elasticdl_tpu_torch.models import transformer
from elasticdl_tpu_torch.parallel.pipeline import (
    device_major_order,
    pipeline_apply,
)
from elasticdl_tpu_torch.parallel.sharding import PartitionSpec as P
from elasticdl_tpu_torch.parallel.sharding import ShardingRules

BLOCK_KEYS = ("blocks", "blocks_device_major")


class PipelinedTransformerLM(nn.Module):
    """Decoder-only LM with blocks partitioned into pipeline stages.

    ``num_layers`` blocks split evenly over ``num_stages`` stages (the
    mesh's pp extent, or 1 without a mesh: the sequential path) times
    ``num_chunks`` interleaved chunks; a depth that does not divide
    raises (the model never changes depth to fit a mesh)."""

    def __init__(self, vocab_size=32000, num_layers=4, num_stages=4,
                 num_heads=8, embed_dim=512, mlp_ratio=4,
                 num_microbatches=4, attention_impl="auto", mesh=None,
                 num_chunks=1, device_major_params=False,
                 schedule="1f1b"):
        super().__init__()
        if num_layers % (num_stages * num_chunks) != 0:
            raise ValueError(
                "num_layers=%d is not divisible by num_stages*num_chunks"
                "=%d; refusing to silently change model depth"
                % (num_layers, num_stages * num_chunks))
        if device_major_params and (num_chunks == 1 or mesh is None):
            raise ValueError(
                "device_major_params only applies to interleaved "
                "pipelines (num_chunks > 1 with a mesh) — at V=1 the "
                "portable layout is already device-contiguous")
        if attention_impl in transformer.SEQ_PARALLEL_IMPLS:
            raise ValueError(
                "attention_impl=%r needs the sp axis; the pipeline's "
                "stages run over pp" % (attention_impl,))
        if mesh is not None and mesh.shape["pp"] != num_stages:
            raise ValueError("num_stages=%d but the mesh's pp extent is %d"
                             % (num_stages, mesh.shape["pp"]))
        self.vocab_size = vocab_size
        self.num_layers = num_layers
        self.num_stages = num_stages
        self.num_chunks = num_chunks
        self.device_major_params = device_major_params
        self.num_microbatches = num_microbatches
        self.num_heads = num_heads
        self.embed_dim = embed_dim
        self.schedule = schedule
        self.mesh = mesh
        self.wte = nn.Embedding(vocab_size, embed_dim)
        # the block whose function every layer applies; its parameters
        # are replaced by the stacked ones below
        template = transformer.Block(embed_dim, num_heads, mlp_ratio,
                                     attention_impl)
        layers = [transformer.Block(embed_dim, num_heads, mlp_ratio,
                                    attention_impl).state_dict()
                  for _ in range(num_layers)]
        order = self._layer_order()
        if order is not None:
            layers = [layers[i] for i in order]
        for name, _ in list(template.named_parameters()):
            owner, leaf = _owner(template, name)
            setattr(owner, leaf, nn.Parameter(torch.stack(
                [layer[name] for layer in layers])))
        self.add_module(self.blocks_key, template)
        self.ln_f = nn.LayerNorm(embed_dim, eps=transformer.LAYER_NORM_EPS)
        self.lm_head = nn.Linear(embed_dim, vocab_size, bias=False)

    @property
    def blocks_key(self):
        return "blocks_device_major" if self.device_major_params else "blocks"

    def _layer_order(self):
        """The flat layer order at rest: None for layer order (portable);
        under device_major_params flat position p*per_chunk + k holds
        layer order_dm[p]*per_chunk + k."""
        if not self.device_major_params:
            return None
        per_chunk = self.num_layers // (self.num_stages * self.num_chunks)
        order = []
        for chunk in device_major_order(self.num_stages, self.num_chunks):
            order.extend(range(chunk * per_chunk, (chunk + 1) * per_chunk))
        return order

    def blocks_to_portable(self, blocks):
        """Device-major block leaves ({name: (num_layers, ...)}) back to
        layer order, the topology-portable checkpoint layout."""
        order = self._layer_order()
        if order is None:
            return blocks
        inverse = np.argsort(order)
        return {k: v[torch.as_tensor(inverse)] for k, v in blocks.items()}

    def blocks_from_portable(self, blocks):
        """Inverse of blocks_to_portable."""
        order = self._layer_order()
        if order is None:
            return blocks
        return {k: v[torch.as_tensor(order)] for k, v in blocks.items()}

    def _stage_fn(self, stage_params, h):
        block = getattr(self, self.blocks_key)
        layers = next(iter(stage_params.values())).shape[0]
        for i in range(layers):
            h = functional_call(block, {n: p[i] for n, p in
                                        stage_params.items()}, (h,))
        return h

    def forward(self, tokens):
        x = F.embedding(tokens.long(), self.wte.weight)
        block = getattr(self, self.blocks_key)
        stack = dict(block.named_parameters())
        if self.mesh is None:
            # single-card sequential path over the flat stack
            x = self._stage_fn(stack, x)
        else:
            # this rank's rows (L/S of them) -> its V chunks of
            # L/(S*V) layers; the split follows the block boundaries
            per_chunk = self.num_layers // (self.num_stages
                                            * self.num_chunks)
            staged = {n: p.reshape((-1, per_chunk) + tuple(p.shape[1:]))
                      for n, p in stack.items()}
            x = pipeline_apply(
                self._stage_fn, staged, x,
                num_microbatches=self.num_microbatches, mesh=self.mesh,
                num_chunks=self.num_chunks, schedule=self.schedule,
                params_layout=("device" if self.device_major_params
                               else "chunk"))
        return self.lm_head(self.ln_f(x))

    def flax_params(self, state):
        """``{name: tensor}`` in this module's names -> the export's flat
        flax names (train/export.py reads it)."""
        return params_to_flax(state, self.num_heads)

    def params_from_flax(self, flat):
        return params_from_flax(flat)

    def flax_leaf(self, name):
        """``(flax path, layout kind)`` of the weight ``name``: a stacked
        leaf keeps its layer axis first in both layouts (the rules'
        ``P("pp")`` lands on it)."""
        key, _, rest = name.partition(".")
        if key in BLOCK_KEYS:
            return key + "/" + _FLAX_OF[rest], "copy"
        return transformer.flax_leaf(name)


def _owner(module, name):
    *path, leaf = name.split(".")
    for part in path:
        module = getattr(module, part)
    return module, leaf


_FLAX_OF = {t: f for f, (t, _) in transformer._BLOCK_LEAVES.items()}


def params_from_flax(flat):
    """``{flax name: array}`` (the reference's ``init`` tree flattened,
    or an export of either package) -> this module's state_dict; each
    layer of a stacked leaf converted as transformer.py converts it."""
    state, top = {}, {}
    for name, value in flat.items():
        name = name[len("params/"):] if name.startswith("params/") else name
        key, _, rest = name.partition("/")
        if key not in BLOCK_KEYS:
            top[name] = value
            continue
        target, kind = transformer._BLOCK_LEAVES[rest]
        value = np.asarray(value)
        layers = value.shape[0]
        if kind == "in_heads":      # (L, dim, H, d) -> (L, H*d, dim)
            value = value.reshape(layers, value.shape[1], -1).transpose(
                0, 2, 1)
        elif kind == "heads_out":   # (L, H, d, dim) -> (L, dim, H*d)
            value = value.reshape(layers, -1, value.shape[-1]).transpose(
                0, 2, 1)
        elif kind == "dense":       # (L, in, out) -> (L, out, in)
            value = value.transpose(0, 2, 1)
        state[key + "." + target] = torch.from_numpy(
            np.array(value, order="C"))
    state.update(transformer.params_from_flax(top))
    return state


def params_to_flax(state_dict, num_heads):
    """state_dict -> ``{flax name: fp32 ndarray}`` (inverse of
    ``params_from_flax``)."""
    flat, top = {}, {}
    for name, tensor in state_dict.items():
        key, _, rest = name.partition(".")
        if key not in BLOCK_KEYS:
            top[name] = tensor
            continue
        flax_leaf = _FLAX_OF[rest]
        kind = transformer._BLOCK_LEAVES[flax_leaf][1]
        value = tensor.detach().float().cpu().numpy()
        layers = value.shape[0]
        if kind == "in_heads":      # (L, H*d, dim) -> (L, dim, H, d)
            value = value.transpose(0, 2, 1).reshape(
                layers, value.shape[2], num_heads, -1)
        elif kind == "heads_out":   # (L, dim, H*d) -> (L, H, d, dim)
            value = value.transpose(0, 2, 1).reshape(
                layers, num_heads, -1, value.shape[1])
        elif kind == "dense":
            value = value.transpose(0, 2, 1)
        flat[key + "/" + flax_leaf] = np.ascontiguousarray(value)
    flat.update(transformer.params_to_flax(top, num_heads))
    return flat


def pipeline_sharding_rules():
    """Layer-stack axis over pp, everything else replicated (the
    reference's rules on flax paths: parallel/sharding.py lays them
    over the port's leaves). A stacked leaf's dim 0 over pp gives each
    stage exactly its own layers."""
    return ShardingRules(
        rules=[
            (r"^blocks(_device_major)?/", P("pp")),
            (r"wte/embedding$", P(None, "fsdp")),
            (r"lm_head/kernel$", P("fsdp", None)),
            (r".*", P()),
        ],
        default_spec=P(),
    )


# -- model-zoo contract -----------------------------------------------------


def mesh_config(num_devices):
    from elasticdl_tpu_torch.parallel.mesh import MeshConfig

    pp = 4 if num_devices % 4 == 0 else (2 if num_devices % 2 == 0 else 1)
    return MeshConfig(dp=num_devices // pp, pp=pp)


def custom_model(mesh=None, vocab_size=32000, num_layers=12, num_heads=12,
                 embed_dim=768, num_microbatches=4, attention_impl="auto",
                 num_chunks=1, device_major_params=False, schedule="1f1b"):
    """The zoo's pipelined LM (the reference's custom_model widths);
    ``--model_params`` may override any of them, the microbatches, the
    chunks and the schedule. The stage count is the mesh's pp extent."""
    num_stages = 1
    if mesh is not None:
        num_stages = max(mesh.shape.get("pp", 1), 1)
    if num_layers % num_stages != 0:
        raise ValueError(
            "pipeline_transformer has %d layers; mesh pp extent %d does "
            "not divide it — pick pp in {1,2,3,4,6,12}"
            % (num_layers, num_stages))
    return PipelinedTransformerLM(
        vocab_size=vocab_size,
        num_layers=num_layers,
        num_stages=num_stages,
        num_heads=num_heads,
        embed_dim=embed_dim,
        num_microbatches=num_microbatches,
        attention_impl=attention_impl,
        mesh=mesh,
        num_chunks=num_chunks,
        device_major_params=device_major_params,
        schedule=schedule,
    )


loss = transformer.loss
optimizer = transformer.optimizer
dataset_fn = transformer.dataset_fn
eval_metrics_fn = transformer.eval_metrics_fn


def sharding_rules():
    return pipeline_sharding_rules()

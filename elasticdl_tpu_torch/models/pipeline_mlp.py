"""Pipeline-parallel MLP with tensor parallelism inside each stage (port
of elasticdl_tpu/models/pipeline_mlp.py).

The minimal model of the pp x tp composition: stages are Megatron-style
column- and row-parallel MLP blocks (W1 split on its output dim over
tp, W2 on its input dim, one ``mesh_psum`` a block rejoining the
activation), scheduled by parallel/pipeline.py (1f1b, optional
interleaved chunks). The split branch enters through ``mesh_replicate``
(``tp_enter``), so its input's gradient is summed over tp while the
residual path's is not, as JAX's varying-axis typing gives the
reference.

The parameters keep the reference's flax layout and names: ``blocks``
holds ``W1 (num_layers, dim, hidden)``, ``W2 (num_layers, hidden,
dim)`` and ``b (num_layers, dim)``, and ``head`` is ``(dim,
num_classes)``; under a mesh each rank holds its block of them
(``sharding_rules``).
"""

import math

import numpy as np
import torch
from torch import nn

from elasticdl_tpu_torch.models.transformer import tp_enter, tp_live
from elasticdl_tpu_torch.parallel.collectives import mesh_psum
from elasticdl_tpu_torch.parallel.pipeline import pipeline_apply
from elasticdl_tpu_torch.parallel.sharding import PartitionSpec as P
from elasticdl_tpu_torch.parallel.sharding import ShardingRules
from elasticdl_tpu_torch.train import metrics
from elasticdl_tpu_torch.train.losses import sparse_softmax_cross_entropy
from elasticdl_tpu_torch.train.optimizers import create_optimizer


def _make_stage_fn(mesh):
    """Column-parallel W1, row-parallel W2, one psum over tp."""

    def layer_fn(p, x):
        h = torch.relu(tp_enter(x, mesh) @ p["W1"])
        out = h @ p["W2"]
        if tp_live(mesh):
            out = mesh_psum(out, "tp", mesh=mesh)
        return torch.tanh(out + p["b"]) + x  # residual keeps depth trainable

    def stage(p, h):
        for i in range(p["W1"].shape[0]):
            h = layer_fn({k: v[i] for k, v in p.items()}, h)
        return h

    return stage


class _Blocks(nn.Module):
    def __init__(self, num_layers, dim, hidden):
        super().__init__()
        self.W1 = nn.Parameter(torch.randn(num_layers, dim, hidden)
                               / math.sqrt(dim))
        self.W2 = nn.Parameter(torch.randn(num_layers, hidden, dim)
                               / math.sqrt(hidden))
        self.b = nn.Parameter(torch.zeros(num_layers, dim))


class PipelinedMlpNet(nn.Module):
    """Residual MLP classifier, layers split into pipeline stages."""

    def __init__(self, num_classes=16, dim=32, hidden=64, num_layers=4,
                 num_stages=1, num_chunks=1, num_microbatches=2,
                 mesh=None):
        super().__init__()
        chunks = num_stages * num_chunks
        if num_layers % chunks != 0:
            raise ValueError(
                "num_layers=%d not divisible by stages*chunks=%d"
                % (num_layers, chunks))
        self.num_classes = num_classes
        self.dim = dim
        self.hidden = hidden
        self.num_layers = num_layers
        self.num_stages = num_stages
        self.num_chunks = num_chunks
        self.num_microbatches = num_microbatches
        self.mesh = mesh
        self.blocks = _Blocks(num_layers, dim, hidden)
        self.head = nn.Parameter(torch.randn(dim, num_classes)
                                 / math.sqrt(dim))

    def forward(self, features):
        x = features.float()
        if x.shape[-1] != self.dim:
            raise ValueError("features last dim %d != model dim %d"
                             % (x.shape[-1], self.dim))
        blocks = dict(self.blocks.named_parameters())
        if self.mesh is None:
            x = _make_stage_fn(None)(blocks, x)
        else:
            per_chunk = self.num_layers // (self.num_stages
                                            * self.num_chunks)
            staged = {k: v.reshape((-1, per_chunk) + tuple(v.shape[1:]))
                      for k, v in blocks.items()}
            x = pipeline_apply(
                _make_stage_fn(self.mesh), staged, x,
                num_microbatches=self.num_microbatches, mesh=self.mesh,
                num_chunks=self.num_chunks)
        return x @ self.head

    def flax_params(self, state):
        return params_to_flax(state)

    def params_from_flax(self, flat):
        return params_from_flax(flat)

    def flax_leaf(self, name):
        """``(flax path, layout kind)``: the leaves are the flax arrays."""
        return name.replace(".", "/"), "copy"


def params_from_flax(flat):
    """``{flax name: array}`` -> state_dict (the same arrays)."""
    state = {}
    for name, value in flat.items():
        name = name[len("params/"):] if name.startswith("params/") else name
        state[name.replace("/", ".")] = torch.from_numpy(
            np.array(value, order="C"))
    return state


def params_to_flax(state_dict):
    return {name.replace(".", "/"): np.ascontiguousarray(
        t.detach().float().cpu().numpy()) for name, t in state_dict.items()}


def pipeline_mlp_sharding_rules():
    """State layout for the FLAT [num_layers, ...] block stack (the
    chunked view exists only inside ``forward``)."""
    return ShardingRules(
        rules=[
            (r"blocks/W1$", P("pp", None, "tp")),
            (r"blocks/W2$", P("pp", "tp", None)),
            (r"blocks/b$", P("pp")),
            (r".*", P()),
        ],
        default_spec=P(),
    )


# -- model-zoo contract -----------------------------------------------------


def mesh_config(num_devices):
    from elasticdl_tpu_torch.parallel.mesh import MeshConfig

    if num_devices % 4 == 0:
        return MeshConfig(dp=num_devices // 4, pp=2, tp=2)
    if num_devices % 2 == 0:
        return MeshConfig(dp=num_devices // 2, pp=2)
    return MeshConfig(dp=num_devices)


def custom_model(mesh=None):
    num_stages = max(mesh.shape.get("pp", 1), 1) if mesh is not None else 1
    return PipelinedMlpNet(num_stages=num_stages, mesh=mesh)


def loss(labels, logits):
    return sparse_softmax_cross_entropy(labels, logits)


def optimizer():
    return create_optimizer("Adam", learning_rate=0.01)


def sharding_rules():
    return pipeline_mlp_sharding_rules()


def eval_metrics_fn():
    return {"accuracy": metrics.Accuracy()}

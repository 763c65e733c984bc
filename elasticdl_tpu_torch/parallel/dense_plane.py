"""The dense data plane: what happens to every dense gradient, stated
explicitly (port of elasticdl_tpu/parallel/dense_plane.py).

Given the parameters and the mesh, ``plan_dense_plane`` derives each
parameter's reduction, with the spec resolution ``SpmdTrainer`` lays
the state out with (``sharding.param_specs``):

- a parameter sharded over ``fsdp`` (ZeRO) gets its gradient
  **reduce-scattered** over ``fsdp`` (each rank keeps only its block)
  and the optimizer applies on the block; the remaining ``dp`` extent
  all-reduces the scattered block;
- a replicated parameter gets a plain **psum** (all-reduce) over the
  full data extent, and every rank applies the identical update;
- a ``tp``/``ep``-sharded parameter reduces only over the data axes:
  its model-axis shards are *different* values, not partials;
- with no data extent left, a parameter is **local**.

A spec's size-1 axes shard nothing and are dropped first, as the
collectives drop them: a leaf whose rule names ``fsdp`` on a mesh of
fsdp 1 all-reduces over dp (psum), or is local on one rank. (The
reference's plan counts such a leaf as a reduce-scatter of 0 bytes; the
byte totals are the same.)

The byte totals use the ring-algorithm costs (payload ``B`` over ``n``
ranks: all-reduce ``2B(n-1)/n``, reduce-scatter ``B(n-1)/n``), the
figures ``parallel/collectives.py`` records, so the telemetry field
``collective_bytes_per_step`` means the same thing whichever layer
moved the bytes. The plan is pure arithmetic over shapes, specs and
mesh sizes.
"""

from dataclasses import dataclass, field

from elasticdl_tpu_torch.parallel.mesh import DATA_AXES
from elasticdl_tpu_torch.parallel.sharding import PartitionSpec as P
from elasticdl_tpu_torch.parallel.sharding import param_specs

__all__ = ["DenseParamPlan", "DensePlan", "plan_dense_plane"]


@dataclass
class DenseParamPlan:
    path: str
    shape: tuple
    nbytes: int
    spec: object  # PartitionSpec
    mode: str  # "reduce_scatter" | "psum" | "local"
    grad_bytes_per_step: int


@dataclass
class DensePlan:
    """The derived reduction plan for one model on one mesh."""

    mesh_shape: dict
    mesh_axes: tuple
    params: list = field(default_factory=list)

    @property
    def param_bytes(self):
        return sum(p.nbytes for p in self.params)

    @property
    def sharded_param_bytes(self):
        return sum(p.nbytes for p in self.params
                   if p.mode == "reduce_scatter")

    @property
    def replicated_param_bytes(self):
        return sum(p.nbytes for p in self.params if p.mode == "psum")

    @property
    def collective_bytes_per_step(self):
        return sum(p.grad_bytes_per_step for p in self.params)

    def counts(self):
        out = {}
        for p in self.params:
            out[p.mode] = out.get(p.mode, 0) + 1
        return out

    def mesh_shape_str(self):
        """Compact non-trivial-axes spelling, e.g. ``dp=2,tp=2`` (the
        telemetry blob's ``mesh_shape``; a one-rank mesh spells
        ``dp=1``)."""
        parts = ["%s=%d" % (axis, size)
                 for axis, size in self.mesh_shape.items() if size > 1]
        return ",".join(parts) if parts else "dp=1"

    def summary(self):
        counts = self.counts()
        return {
            "mesh_shape": self.mesh_shape_str(),
            "param_bytes": self.param_bytes,
            "sharded_param_bytes": self.sharded_param_bytes,
            "replicated_param_bytes": self.replicated_param_bytes,
            "collective_bytes_per_step": self.collective_bytes_per_step,
            "reduce_scatter_params": counts.get("reduce_scatter", 0),
            "psum_params": counts.get("psum", 0),
            "local_params": counts.get("local", 0),
        }


def _ring(nbytes, n):
    return nbytes * (n - 1) // n if n > 1 else 0


def plan_one(path, shape, nbytes, spec, mesh_shape):
    """One parameter's :class:`DenseParamPlan` under ``spec``."""
    fsdp = mesh_shape.get("fsdp", 1)
    dp = mesh_shape.get("dp", 1)
    spec = spec if spec is not None else P()
    spec_axes = {a for a in P(*spec).axes() if mesh_shape.get(a, 1) > 1}
    data_extent = dp * (1 if "fsdp" in spec_axes else fsdp)
    if "fsdp" in spec_axes:
        # grad reduce-scatters over fsdp; each scattered block then
        # all-reduces over the dp extent (if any)
        mode = "reduce_scatter"
        grad_bytes = _ring(nbytes, fsdp) + 2 * _ring(
            nbytes // max(fsdp, 1), dp)
    elif spec_axes - set(DATA_AXES):
        # tp/ep-sharded: each model shard is a distinct value; only the
        # data extent carries partials to reduce
        shard = nbytes
        for axis in spec_axes - set(DATA_AXES):
            shard //= max(mesh_shape.get(axis, 1), 1)
        if data_extent > 1:
            mode, grad_bytes = "psum", 2 * _ring(shard, data_extent)
        else:
            mode, grad_bytes = "local", 0
    elif data_extent > 1:
        # replicated param: plain all-reduce over all data parallelism,
        # identical optimizer apply everywhere
        mode, grad_bytes = "psum", 2 * _ring(nbytes, data_extent)
    else:
        mode, grad_bytes = "local", 0
    return DenseParamPlan(path=path, shape=tuple(shape), nbytes=nbytes,
                          spec=spec, mode=mode,
                          grad_bytes_per_step=grad_bytes)


def plan_dense_plane(params, mesh, rules=None, model=None, specs=None):
    """Derive the :class:`DensePlan` for ``params`` (``{name: tensor}``,
    or anything with ``.shape`` and ``.dtype``) over ``mesh``, with the
    specs ``SpmdTrainer`` shards the state with (``specs``, else
    ``sharding.param_specs(params, mesh, rules, model)``)."""
    shape = dict(mesh.shape)
    plan = DensePlan(mesh_shape=shape, mesh_axes=tuple(mesh.axis_names))
    if specs is None:
        specs = param_specs(params, mesh, rules, model)
    for path, leaf in params.items():
        numel = 1
        for n in leaf.shape:
            numel *= int(n)
        nbytes = max(numel, 1) * _itemsize(leaf.dtype)
        plan.params.append(
            plan_one(path, leaf.shape, nbytes, specs[path], shape))
    return plan


def _itemsize(dtype):
    import torch

    if isinstance(dtype, torch.dtype):
        return torch.empty((), dtype=dtype).element_size()
    import numpy as np

    return int(np.dtype(dtype).itemsize)

"""Mesh collective helpers: the one spelling of cross-rank reductions in
the port (port of elasticdl_tpu/parallel/collectives.py).

1. **Gradients.** ``mesh_psum``'s backward is the identity: the
   gradient of an all-reduce whose output is used replicated over the
   reduced axes is already whole on every rank. The reference pins that
   convention with a custom_vjp (its docstring records the 2x gradients
   the other convention gave on tp=2); the port pins it with an
   ``autograd.Function``. ``torch.distributed.nn.functional.all_reduce``
   all-reduces the gradient again, N times too large, and is not used.
   ``mesh_all_gather``'s backward reduce-scatters (the gathered tensor's
   gradient is each rank's partial: the fsdp parameter gather) and
   ``mesh_reduce_scatter``'s all-gathers, as JAX transposes them.
   Two helpers of tensor and expert parallelism complete the set:
   ``mesh_replicate`` (identity forward, all-reduced gradient: a
   replicated value entering per-rank partial work) and
   ``mesh_gather_replicated`` (all-gather forward, each rank's own
   block of the gradient backward: a sharded value leaving into
   replicated work). ``mesh_batch_mean`` averages a statistic of each
   data-parallel rank's rows into the whole batch's, with the ranks'
   partial gradients all-reduced.

2. **Byte accounting.** torch has no trace time, so each call records
   its ring-algorithm bytes into the ambient :class:`CollectiveBytes`
   accumulators as it runs (``track_collective_bytes``).

Every helper drops the size-1 axes of its mesh (the given one, else
the ambient ``with mesh:`` one) and is the identity when none is left,
so model code calls them unconditionally.
"""

import threading
from contextlib import contextmanager
from dataclasses import dataclass, field

import torch

from elasticdl_tpu_torch.parallel.mesh import current_mesh

__all__ = [
    "CollectiveBytes",
    "axis_size_product",
    "mesh_all_gather",
    "mesh_batch_mean",
    "mesh_gather_replicated",
    "mesh_pmean",
    "mesh_psum",
    "mesh_reduce_scatter",
    "mesh_replicate",
    "track_collective_bytes",
]


@dataclass
class CollectiveBytes:
    """Bytes the collectives of a block move over the interconnect.

    Ring-algorithm costs per participating rank, with ``n`` the number
    of ranks in the collective and ``B`` the payload bytes: all-reduce
    ``2B(n-1)/n``, reduce-scatter and all-gather each ``B(n-1)/n``.
    """

    all_reduce: int = 0
    reduce_scatter: int = 0
    all_gather: int = 0
    calls: int = 0
    by_kind: dict = field(default_factory=dict)

    @property
    def total(self):
        return self.all_reduce + self.reduce_scatter + self.all_gather

    def record(self, kind, payload_bytes, axis_size):
        if axis_size <= 1:
            return
        ring = payload_bytes * (axis_size - 1) // axis_size
        if kind == "all_reduce":
            self.all_reduce += 2 * ring
        elif kind == "reduce_scatter":
            self.reduce_scatter += ring
        elif kind == "all_gather":
            self.all_gather += ring
        else:
            raise ValueError("unknown collective kind %r" % (kind,))
        self.calls += 1
        self.by_kind[kind] = self.by_kind.get(kind, 0) + 1


_ambient = threading.local()


@contextmanager
def track_collective_bytes(acc: CollectiveBytes = None):
    """Accumulate the byte estimates of the helpers called inside the
    ``with`` block. Yields the accumulator. Reentrant: nested blocks
    each see only their own calls plus inner blocks'."""
    acc = acc if acc is not None else CollectiveBytes()
    stack = getattr(_ambient, "stack", None)
    if stack is None:
        stack = _ambient.stack = []
    stack.append(acc)
    try:
        yield acc
    finally:
        stack.pop()


def _leaves(x):
    if isinstance(x, dict):
        for v in x.values():
            yield from _leaves(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _leaves(v)
    elif isinstance(x, torch.Tensor):
        yield x


def _map(fn, x):
    if isinstance(x, dict):
        return {k: _map(fn, v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_map(fn, v) for v in x)
    return fn(x)


def _record(kind, x, axis_size):
    stack = getattr(_ambient, "stack", None)
    if not stack:
        return
    payload = sum(t.numel() * t.element_size() for t in _leaves(x))
    for acc in stack:
        acc.record(kind, payload, axis_size)


def _normalize_axes(axes):
    if isinstance(axes, str):
        return (axes,)
    return tuple(axes)


def axis_size_product(axes, mesh=None):
    """Product of the named axis sizes, from ``mesh`` when given, else
    from the ambient mesh; 1 for axes it cannot resolve (outside a mesh
    every axis has size 1)."""
    mesh = mesh if mesh is not None else current_mesh()
    n = 1
    for axis in _normalize_axes(axes):
        n *= int(mesh.shape.get(axis, 1)) if mesh is not None else 1
    return n


def _group(axes, mesh):
    """``(mesh, group, size)`` of the live axes; group None when none is
    left."""
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None:
        return None, None, 1
    live = mesh.live_axes(axes)
    return mesh, mesh.group(live), mesh.size(live)


def _all_reduce(x, group):
    import torch.distributed as dist

    out = x.contiguous().clone()
    dist.all_reduce(out, group=group)
    return out


# the collectives run over dim 0: another dim moves there and back
# (fresh contiguous tensors both ways: an autograd Function must not
# return a view of a tensor it made)


def _to_front(x, dim):
    return (x if dim == 0 else x.movedim(dim, 0)).contiguous()


def _from_front(x, dim):
    return x if dim == 0 else x.movedim(0, dim).contiguous()


def _all_gather(x, group, size, dim):
    import torch.distributed as dist

    moved = _to_front(x, dim)
    out = moved.new_empty((moved.shape[0] * size, *moved.shape[1:]))
    dist.all_gather_into_tensor(out, moved, group=group)
    return _from_front(out, dim)


def _reduce_scatter(x, group, size, dim):
    import torch.distributed as dist

    moved = _to_front(x, dim)
    if moved.shape[0] % size:
        raise ValueError("dim %d of %s does not scatter over %d ranks"
                         % (dim, tuple(x.shape), size))
    out = moved.new_empty((moved.shape[0] // size, *moved.shape[1:]))
    dist.reduce_scatter_tensor(out, moved, group=group)
    return _from_front(out, dim)


class _AllReduceIdentityGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _IdentityAllReduceGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, size, dim):
        ctx.args = (group, size, dim)
        return _all_gather(x, group, size, dim)

    @staticmethod
    def backward(ctx, grad):
        return _reduce_scatter(grad, *ctx.args), None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, size, dim):
        ctx.args = (group, size, dim)
        return _reduce_scatter(x, group, size, dim)

    @staticmethod
    def backward(ctx, grad):
        return _all_gather(grad, *ctx.args), None, None, None


class _GatherOwnBlockGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, size, dim, index):
        ctx.args = (dim, index, x.shape[dim])
        return _all_gather(x, group, size, dim)

    @staticmethod
    def backward(ctx, grad):
        dim, index, n = ctx.args
        return (grad.narrow(dim, index * n, n).contiguous(), None, None,
                None, None)


def mesh_psum(x, axes, *, mesh=None):
    """All-reduce ``x`` (a tensor or a dict/list of them) over the named
    mesh ``axes``; its backward is the identity (the module docstring).
    Size-1 axes reduce over nothing and are dropped."""
    mesh, group, size = _group(axes, mesh)
    if group is None:
        return x
    _record("all_reduce", x, size)
    return _map(lambda t: _AllReduceIdentityGrad.apply(t, group), x)


def mesh_pmean(x, axes, *, mesh=None):
    """Mean-reduce over the named axes; same gradient contract as
    :func:`mesh_psum`."""
    size = axis_size_product(axes, mesh)
    summed = mesh_psum(x, axes, mesh=mesh)
    return _map(lambda v: v / size, summed)


def mesh_reduce_scatter(x, axis, *, scatter_dimension=0, mesh=None):
    """Reduce-scatter over ``axis`` (a name or a tuple): each rank ends
    holding the fully-reduced block of ``x`` along
    ``scatter_dimension``, half the traffic of an all-reduce."""
    mesh, group, size = _group(axis, mesh)
    if group is None:
        return x
    _record("reduce_scatter", x, size)
    return _ReduceScatter.apply(x, group, size, scatter_dimension)


def mesh_all_gather(x, axis, *, gather_dimension=0, mesh=None):
    """All-gather over ``axis`` (a name or a tuple): the inverse of
    :func:`mesh_reduce_scatter` for re-materializing a sharded value.
    Its backward reduce-scatters."""
    mesh, group, size = _group(axis, mesh)
    if group is None:
        return x
    _record("all_gather", x, size)
    return _AllGather.apply(x, group, size, gather_dimension)


def mesh_replicate(x, axes, *, mesh=None):
    """``x``, replicated over ``axes``, entering work that each rank of
    ``axes`` does on its own shard (tensor parallelism's column split,
    expert parallelism's own experts): the identity forward, and the
    per-rank partial gradients all-reduced backward."""
    mesh, group, size = _group(axes, mesh)
    if group is None:
        return x
    _record("all_reduce", x, size)
    return _IdentityAllReduceGrad.apply(x, group)


def mesh_gather_replicated(x, axes, *, dim, mesh=None):
    """The blocks of ``x`` along ``dim`` over ``axes`` gathered into one
    tensor that the rest of the step uses replicated: its gradient is
    whole on every rank, so the backward keeps this rank's block."""
    mesh, group, size = _group(axes, mesh)
    if group is None:
        return x
    _record("all_gather", x, size)
    index = mesh.index(mesh.live_axes(axes))
    return _GatherOwnBlockGrad.apply(x, group, size, dim, index)


def mesh_batch_mean(x, axes, *, mesh=None):
    """The mean over the ranks of ``axes`` of ``x``, a statistic of
    each data-parallel rank's rows (equal row counts), as the whole
    batch's statistic; every rank's loss then holds a part of what uses
    it, so the backward all-reduces the ranks' partial gradients (over
    the ranks) instead of passing its own through."""
    mesh, group, size = _group(axes, mesh)
    if group is None:
        return x
    return mesh_pmean(mesh_replicate(x, axes, mesh=mesh), axes, mesh=mesh)

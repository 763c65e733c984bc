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
   partial gradients all-reduced. Sequence and pipeline parallelism
   add two: ``mesh_ppermute`` (the counterpart of ``jax.lax.ppermute``:
   each rank sends to the rank a permutation names, and the backward
   sends the gradient back by the inverse permutation) and
   ``mesh_all_to_all`` (``jax.lax.all_to_all(..., tiled=True)``: dim
   ``split_dim`` cut into one block a rank, the blocks received joined
   along ``concat_dim``; the backward is the swapped all-to-all).

   A hop is one ``dist.batch_isend_irecv`` of every send and receive
   of the call, waited together, never a blocking send before a
   receive (which deadlocks once the payload passes the transport's
   buffer). Gloo takes no CUDA tensor in a point-to-point op, and it
   is the backend when two ranks share one card (NCCL takes one rank
   a device): there the hop copies each CUDA tensor through a host
   buffer and back, and the copy's bytes and seconds are recorded
   (``host_staged``, ``host_staged_s``). The compute stays on the card.

2. **Byte accounting.** torch has no trace time, so each call records
   its ring-algorithm bytes into the ambient :class:`CollectiveBytes`
   accumulators as it runs (``track_collective_bytes``). The
   accumulators are the process's, not a thread's: autograd runs the
   backward of CUDA work on a device thread of its own, and what the
   collectives record there (a hop's reverse, the ring's and the
   pipeline's backward) belongs to the step the tracking thread waits
   on.

Every helper drops the size-1 axes of its mesh (the given one, else
the ambient ``with mesh:`` one) and is the identity when none is left,
so model code calls them unconditionally.
"""

from contextlib import contextmanager
from dataclasses import dataclass, field

import torch

from elasticdl_tpu_torch.parallel.mesh import current_mesh

__all__ = [
    "CollectiveBytes",
    "axis_size_product",
    "mesh_all_gather",
    "mesh_all_to_all",
    "mesh_batch_mean",
    "mesh_gather_replicated",
    "mesh_pmean",
    "mesh_ppermute",
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
    ``2B(n-1)/n``, reduce-scatter and all-gather each ``B(n-1)/n``; a
    permutation hop the bytes this rank sends, an all-to-all
    ``B(n-1)/n``. ``hops`` and ``hop_s`` count the point-to-point
    exchanges (ppermute, all-to-all) and their wall seconds on this
    rank (the wait for the peers included); ``host_staged`` and
    ``host_staged_s`` the bytes copied through host buffers for gloo
    and those copies' seconds (both directions).
    """

    all_reduce: int = 0
    reduce_scatter: int = 0
    all_gather: int = 0
    ppermute: int = 0
    all_to_all: int = 0
    calls: int = 0
    hops: int = 0
    hop_s: float = 0.0
    host_staged: int = 0
    host_staged_s: float = 0.0
    by_kind: dict = field(default_factory=dict)

    @property
    def total(self):
        return (self.all_reduce + self.reduce_scatter + self.all_gather
                + self.ppermute + self.all_to_all)

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
        elif kind == "ppermute":
            self.ppermute += payload_bytes
        elif kind == "all_to_all":
            self.all_to_all += ring
        else:
            raise ValueError("unknown collective kind %r" % (kind,))
        self.calls += 1
        self.by_kind[kind] = self.by_kind.get(kind, 0) + 1


# the process's accumulators, not a thread's (the module docstring)
_tracking = []


@contextmanager
def track_collective_bytes(acc: CollectiveBytes = None):
    """Accumulate the byte estimates of the helpers called inside the
    ``with`` block. Yields the accumulator. Reentrant: nested blocks
    each see only their own calls plus inner blocks'."""
    acc = acc if acc is not None else CollectiveBytes()
    _tracking.append(acc)
    try:
        yield acc
    finally:
        _tracking.pop()


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
    if not _tracking:
        return
    payload = sum(t.numel() * t.element_size() for t in _leaves(x))
    for acc in _tracking:
        acc.record(kind, payload, axis_size)


def _record_hop(seconds, staged_bytes, staged_s, hops=1):
    for acc in _tracking:
        acc.hops += hops
        acc.hop_s += seconds
        acc.host_staged += staged_bytes
        acc.host_staged_s += staged_s


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


def _on_host(fn, x, group):
    """``fn(x)``, through a host copy of ``x`` when gloo cannot take
    the CUDA tensor (the bytes copied each way recorded as host-staged,
    with the seconds of the whole staged call)."""
    if not _staged(group, [x]):
        return fn(x)
    import time

    t0 = time.perf_counter()
    out = fn(x.detach().to("cpu")).to(x.device)
    _record_hop(0.0, x.numel() * x.element_size()
                + out.numel() * out.element_size(),
                time.perf_counter() - t0, hops=0)
    return out


def _all_gather(x, group, size, dim):
    import torch.distributed as dist

    def gather(moved):
        out = moved.new_empty((moved.shape[0] * size, *moved.shape[1:]))
        dist.all_gather_into_tensor(out, moved, group=group)
        return out

    return _from_front(_on_host(gather, _to_front(x, dim), group), dim)


def _reduce_scatter(x, group, size, dim):
    import torch.distributed as dist

    moved = _to_front(x, dim)
    if moved.shape[0] % size:
        raise ValueError("dim %d of %s does not scatter over %d ranks"
                         % (dim, tuple(x.shape), size))

    def scatter(moved):
        out = moved.new_empty((moved.shape[0] // size, *moved.shape[1:]))
        dist.reduce_scatter_tensor(out, moved, group=group)
        return out

    return _from_front(_on_host(scatter, moved, group), dim)


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


# ---------------------------------------------------------------------------
# point to point: ppermute and all-to-all
# ---------------------------------------------------------------------------


def _staged(group, tensors):
    """Whether a point-to-point op over ``group`` must copy ``tensors``
    through the host: gloo moves no CUDA tensor point to point."""
    import torch.distributed as dist

    return (any(t.is_cuda for t in tensors)
            and dist.get_backend(group) == "gloo")


def exchange(sends, recvs, group):
    """One hop: ``sends`` (``[(tensor, peer)]``) and ``recvs`` (``[(out
    tensor, peer)]``), peers by their rank in ``group``, posted as one
    ``batch_isend_irecv`` and waited together. Over gloo, CUDA tensors
    travel through host copies (recorded). Fills the ``recvs`` tensors
    in place."""
    import time

    import torch.distributed as dist

    if not sends and not recvs:
        return
    t0 = time.perf_counter()
    staged = _staged(group, [t for t, _ in sends] + [t for t, _ in recvs])
    staged_bytes, staged_s = 0, 0.0
    if staged:
        s0 = time.perf_counter()
        sends = [(t.detach().to("cpu"), peer) for t, peer in sends]
        host = [(torch.empty(t.shape, dtype=t.dtype), peer)
                for t, peer in recvs]
        staged_s += time.perf_counter() - s0
    else:
        sends = [(t.contiguous(), peer) for t, peer in sends]
        host = recvs
    ops = [dist.P2POp(dist.isend, t, dist.get_global_rank(group, peer),
                      group) for t, peer in sends]
    ops += [dist.P2POp(dist.irecv, t, dist.get_global_rank(group, peer),
                       group) for t, peer in host]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    if staged:
        s0 = time.perf_counter()
        for (out, _), (buf, _) in zip(recvs, host):
            out.copy_(buf)
        staged_s += time.perf_counter() - s0
        staged_bytes = sum(t.numel() * t.element_size()
                           for t, _ in sends + host)
    _record_hop(time.perf_counter() - t0, staged_bytes, staged_s)


def record_hop(tensors, axis_size):
    """Record the bytes a rank sends in a hop it posted itself through
    ``exchange`` (a pipeline tick's), as a ppermute's."""
    _record("ppermute", tensors, axis_size)


def _ppermute(tensors, group, index, perm):
    """``tensors`` sent to this rank's destination in ``perm`` (pairs
    of axis indices), the source's received in their place (zeros
    without a source), all in one hop."""
    dst = [d for s, d in perm if s == index]
    src = [s for s, d in perm if d == index]
    outs = [torch.zeros_like(t, memory_format=torch.contiguous_format)
            for t in tensors]
    exchange([(t, dst[0]) for t in tensors] if dst else [],
             [(o, src[0]) for o in outs] if src else [], group)
    return outs


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, index, perm, *tensors):
        ctx.args = (group, index, [(d, s) for s, d in perm])
        return tuple(_ppermute(tensors, group, index, perm))

    @staticmethod
    def backward(ctx, *grads):
        group, index, inverse = ctx.args
        return (None, None, None, *_ppermute(grads, group, index, inverse))


def _check_perm(perm, size):
    perm = [(int(s), int(d)) for s, d in perm]
    for s, d in perm:
        if not (0 <= s < size and 0 <= d < size):
            raise ValueError("permutation pair %s outside %d ranks"
                             % ((s, d), size))
    if (len({s for s, _ in perm}) != len(perm)
            or len({d for _, d in perm}) != len(perm)):
        raise ValueError("a permutation sends from and to each rank at "
                         "most once: %s" % (perm,))
    return perm


def mesh_ppermute(x, axis, perm, *, mesh=None):
    """``jax.lax.ppermute`` over ``axis``: for every ``(src, dst)`` of
    ``perm`` (indices along the axis), rank ``src``'s ``x`` arrives at
    rank ``dst``; a rank no pair sends to gets zeros. ``x`` is a tensor
    or a list/tuple of tensors, which travel in one hop. Its backward
    sends the gradients by the inverse permutation. The identity over a
    size-1 axis."""
    mesh, group, size = _group(axis, mesh)
    if group is None:
        return x
    perm = _check_perm(perm, size)
    index = mesh.index(mesh.live_axes(axis))
    many = isinstance(x, (list, tuple))
    tensors = list(x) if many else [x]
    if any(s == index for s, _ in perm):
        _record("ppermute", tensors, size)
    out = _PPermute.apply(group, index, perm, *tensors)
    return type(x)(out) if many else out[0]


def _all_to_all(x, group, size, index, split_dim, concat_dim):
    if x.shape[split_dim] % size:
        raise ValueError("dim %d of %s does not split over %d ranks"
                         % (split_dim, tuple(x.shape), size))
    blocks = [b.contiguous() for b in torch.chunk(x, size, split_dim)]
    outs = [torch.empty_like(blocks[0]) for _ in range(size)]
    outs[index] = blocks[index].clone()
    peers = [j for j in range(size) if j != index]
    exchange([(blocks[j], j) for j in peers], [(outs[j], j) for j in peers],
             group)
    return torch.cat(outs, dim=concat_dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, size, index, split_dim, concat_dim):
        ctx.args = (group, size, index, concat_dim, split_dim)
        return _all_to_all(x, group, size, index, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, grad):
        return (_all_to_all(grad.contiguous(), *ctx.args), None, None, None,
                None, None)


def mesh_all_to_all(x, axis, split_dim, concat_dim, *, mesh=None):
    """``jax.lax.all_to_all(x, axis, split_dim, concat_dim,
    tiled=True)``: ``x``'s dim ``split_dim`` cut into one block a rank
    of ``axis`` (block j to rank j), the blocks this rank receives
    joined along ``concat_dim`` in rank order. Its backward is the
    swapped all-to-all. The identity over a size-1 axis."""
    mesh, group, size = _group(axis, mesh)
    if group is None:
        return x
    _record("all_to_all", x, size)
    index = mesh.index(mesh.live_axes(axis))
    return _AllToAll.apply(x, group, size, index, split_dim, concat_dim)

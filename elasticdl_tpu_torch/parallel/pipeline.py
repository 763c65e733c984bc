"""Pipeline parallelism over the ``pp`` mesh axis (port of
elasticdl_tpu/parallel/pipeline.py).

A stack of homogeneous stages (``stage_fn(stage_params, activations) ->
activations``) runs over the ranks of the pp axis, one microbatch a
tick, the reference's two schedules:

- ``schedule="gpipe"`` (V = 1): microbatch m enters stage d at tick
  ``m + d``, M + S - 1 ticks a direction. With ``remat=False`` each
  stage's forward graph is kept for its backward (the reference's
  autodiff of the scan, whose saved carries grow with M); with
  ``remat=True`` (the default, the reference's checkpointed tick) only
  the stage's input is kept and the stage is recomputed.
- ``schedule="1f1b"`` (the default): the forward saves one stage input
  per (chunk, microbatch) and the backward recomputes each stage from
  it (linear activation memory). ``num_chunks=V > 1`` splits the stack
  into S * V interleaved virtual chunks, chunk c on rank ``c mod S`` as
  its local chunk ``c // S``; every hop, the wrap from rank S - 1 back
  to rank 0 included, goes one step round the ring, and the bubble
  divides by V (``schedule_info``). V > 1 needs M <= S, the schedule's
  conflict-free window.

The port's ranks are processes (parallel/mesh.py), and two things
follow. First, the parameters arrive as THIS rank's block: the stacked
leaves' leading dim holds the rank's V chunks (its block of a stack laid
out ``P("pp")``, what the SPMD trainer slices), and ``x`` is this
rank's rows; ``param_specs`` and ``batch_spec`` are the layouts the
blocks were cut by (the reference's shard_map specs) and are not read.
Second, torch's autograd does not cross processes: the backward of a
hop is a hop the other way that both ranks must post, and autograd runs
only the nodes on a path to the loss, which an idle tick's is not. So
both schedules run inside one ``autograd.Function`` whose backward is
the reverse pipeline, written out: tick u of the backward handles the
chunks in reverse order, and each rank hands its stage-input gradient
to the rank before. A rank posts a hop only in a tick where it sends or
receives, and computes only in a tick where it has work: a rank with
no work in a tick skips it, where the reference's lockstep program
computes every tick on every device. The results are the reference's
(the tests hold them against it); only the timing of an idle tick
departs.

The pipeline's output is the last chunk's, summed over pp so that
every pp rank holds it (the reference's psum): the layers after the
pipeline run on every stage, with the same loss, so their parameters
get the same whole gradient on every pp rank and are reduced over the
data axes only. The input's gradient, which only chunk 0 computes, is
summed over pp the same way, so the layers before the pipeline get it
whole on every rank too. Tensor parallelism inside a stage: the stage
enters its tp-split branch through ``mesh_replicate`` (the port's tp
idiom, models/transformer.py ``tp_enter``), whose backward sums the
input's gradient over tp, as JAX's varying-axis typing does for the
reference; the schedule adds no sum of its own.

Each hop is one ``batch_isend_irecv`` (parallel/collectives.py
``exchange``; over gloo, CUDA tensors are copied through the host, and
the copies are recorded).
"""

import numpy as np
import torch

from elasticdl_tpu_torch.parallel import collectives
from elasticdl_tpu_torch.parallel.mesh import current_mesh
from elasticdl_tpu_torch.parallel.sharding import PartitionSpec as P

SCHEDULES = ("gpipe", "1f1b")


# ---------------------------------------------------------------------------
# stacked parameters
# ---------------------------------------------------------------------------


def _tree_map(fn, *trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_tree_map(fn, *vs) for vs in zip(*trees))
    return fn(*trees)


def _flatten(tree, prefix=""):
    """``[(path, tensor)]`` of a nested dict, in key order."""
    if isinstance(tree, dict):
        out = []
        for key in tree:
            out += _flatten(tree[key], prefix + str(key) + "/")
        return out
    return [(prefix[:-1], tree)]


def _unflatten(items):
    tree = {}
    for path, value in items:
        node = tree
        *parents, leaf = path.split("/")
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = value
    return tree


def stack_stage_params(stage_params_list):
    """Stack per-stage parameter trees on a new leading stage axis."""
    return _tree_map(lambda *leaves: torch.stack(leaves), *stage_params_list)


def unstack_stage_params(stacked, num_stages):
    """Inverse of :func:`stack_stage_params` (host-side, for export)."""
    return [_tree_map(lambda leaf: leaf[i], stacked)
            for i in range(num_stages)]


def pipeline_spec(leaf=None):
    """PartitionSpec for stacked stage params: stage axis over ``pp``."""
    return P("pp")


def schedule_info(num_stages, num_microbatches, num_chunks=1,
                  fwd_cost=1.0, bwd_cost=2.0):
    """Analytic schedule accounting: ticks a direction M + S*V - 1, each
    of cost f/V forward and (f+b)/V backward, against M useful
    microbatches of f + (f + b): the bubble is 1 - useful/total."""
    S, M, V = num_stages, num_microbatches, num_chunks
    ticks = M + S * V - 1  # per direction
    total = ticks * (fwd_cost + (fwd_cost + bwd_cost)) / V
    useful = M * (2 * fwd_cost + bwd_cost)
    return {
        "ticks_per_direction": ticks,
        "bubble_fraction": 1.0 - useful / total,
        "activations_per_device": V * M,
    }


def device_major_order(S, V):
    """Chunk-axis permutation putting row ``d*V + v`` = chunk
    ``v*S + d``: the order the contiguous ``P("pp")`` split needs so
    rank ``d`` gets its interleaved chunks {d, d+S, ..., d+(V-1)S} as
    its local rows."""
    return np.arange(S * V).reshape(V, S).T.reshape(-1)


def chunk_major_order(S, V):
    """Inverse of :func:`device_major_order`."""
    return np.arange(S * V).reshape(S, V).T.reshape(-1)


def _device_major(local, mesh, axis, S, V):
    """This rank's interleaved chunks from its block of the chunk-major
    stack: the stack all-gathered over pp and the rank's rows picked
    (the reference's cross-shard gather, which params_layout="device"
    removes). Differentiable: the gather's backward reduce-scatters
    each chunk's gradient home."""
    d = mesh.index(axis)
    rows = [v * S + d for v in range(V)]

    def pick(leaf):
        whole = collectives.mesh_all_gather(leaf, axis, gather_dimension=0,
                                            mesh=mesh)
        return whole[rows]

    return _tree_map(pick, local)


# ---------------------------------------------------------------------------
# the schedule
# ---------------------------------------------------------------------------


class _Plan:
    """What the schedule's Function needs besides tensors."""

    def __init__(self, stage_fn, names, M, S, V, mesh, axis, keep_graph):
        self.stage_fn = stage_fn
        self.names = names
        self.M, self.S, self.V = M, S, V
        self.mesh, self.axis = mesh, axis
        self.d = mesh.index(axis)
        self.group = mesh.group(axis)
        self.keep_graph = keep_graph
        self.ticks = M + S * V - 1

    def chunk(self, leaves, v):
        return _unflatten([(n, leaf[v]) for n, leaf in zip(self.names,
                                                           leaves)])

    def fwd_slot(self, t):
        """``(v, m)`` of this rank at forward tick t (m may be out of
        range: an idle tick)."""
        v = min(max((t - self.d) // self.S, 0), self.V - 1)
        return v, t - self.d - v * self.S

    def bwd_slot(self, u):
        """``(v, m)`` of this rank at backward tick u: the reverse chunk
        index (S - 1 - d) + v' * S handles microbatch m at tick u."""
        rd = self.S - 1 - self.d
        vp = min(max((u - rd) // self.S, 0), self.V - 1)
        return self.V - 1 - vp, u - rd - vp * self.S

    def hop(self, send, send_to, recv_like, recv_from):
        """One tick's hop: ``send`` to the rank ``send_to`` steps on, a
        tensor like ``recv_like`` from ``recv_from`` steps back (None:
        nothing that way). Returns the received tensor."""
        S, d = self.S, self.d
        if S == 1:
            return send if recv_like is not None else None
        recv = (None if recv_like is None else
                torch.empty_like(recv_like,
                                 memory_format=torch.contiguous_format))
        collectives.exchange(
            [] if send is None else [(send, (d + send_to) % S)],
            [] if recv is None else [(recv, (d - recv_from) % S)],
            self.group)
        if send is not None:
            collectives.record_hop(send, S)
        return recv


def _leaf_params(flat):
    return [p.detach().requires_grad_(p.is_floating_point()) for p in flat]


def _psum(x, plan):
    with torch.no_grad():
        return collectives.mesh_psum(x, plan.axis, mesh=plan.mesh)


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, plan, x, *flat):
        M, S, V, d = plan.M, plan.S, plan.V, plan.d
        rows = x.shape[0]
        x_mb = x.reshape((M, rows // M) + tuple(x.shape[1:]))
        like = x_mb[0]
        leaves = _leaf_params(flat) if plan.keep_graph else list(flat)
        saved, outputs, pending = {}, [None] * M, None
        for t in range(plan.ticks):
            v, m = plan.fwd_slot(t)
            active = 0 <= m < M
            first = d == 0 and v == 0
            recv = plan.hop(pending, 1,
                            like if active and not first else None, 1)
            pending = None
            if not active:
                continue
            inp = x_mb[m] if first else recv
            if plan.keep_graph:
                inp = inp.detach().requires_grad_(inp.is_floating_point())
                with torch.enable_grad():
                    out = plan.stage_fn(plan.chunk(leaves, v), inp)
                saved[v, m] = (inp, out)
            else:
                saved[v, m] = inp
                out = plan.stage_fn(plan.chunk(leaves, v), inp)
            if d == S - 1 and v == V - 1:
                outputs[m] = out.detach()
            else:
                pending = out.detach()
        ctx.plan, ctx.saved, ctx.leaves = plan, saved, leaves
        ctx.x_shape, ctx.x_dtype = x.shape, x.dtype
        ctx.save_for_backward(*flat)
        if d == S - 1:
            out = torch.cat(outputs)
        else:
            out = torch.zeros(x.shape, dtype=x.dtype, device=x.device)
        # only the last chunk's rank holds the output: summed over pp,
        # every stage holds it
        return _psum(out.reshape(x.shape), plan)

    @staticmethod
    def backward(ctx, g):
        plan, saved = ctx.plan, ctx.saved
        M, S, V, d = plan.M, plan.S, plan.V, plan.d
        flat = ctx.saved_tensors
        g_mb = g.contiguous().reshape((M, g.shape[0] // M)
                                      + tuple(g.shape[1:]))
        grads = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                 if p.is_floating_point() else None for p in flat]
        dx, pending = [None] * M, None
        for u in range(plan.ticks):
            v, m = plan.bwd_slot(u)
            active = 0 <= m < M
            last = d == S - 1 and v == V - 1
            recv = plan.hop(pending, -1,
                            g_mb[0] if active and not last else None, -1)
            pending = None
            if not active:
                continue
            g_in = g_mb[m] if last else recv
            if plan.keep_graph:
                inp, out = saved.pop((v, m))
                leaves = ctx.leaves
            else:
                leaves = _leaf_params(flat)
                inp = saved.pop((v, m))
                inp = inp.detach().requires_grad_(inp.is_floating_point())
                with torch.enable_grad():
                    out = plan.stage_fn(plan.chunk(leaves, v), inp)
            wrt = [inp] + [p for p in leaves if p.requires_grad]
            got = torch.autograd.grad(out, wrt, g_in, allow_unused=True)
            dinp, got = got[0], iter(got[1:])
            for i, p in enumerate(leaves):
                if p.requires_grad:
                    part = next(got)
                    if part is not None:
                        grads[i] += part.float()
            if dinp is None:
                dinp = torch.zeros_like(inp)
            if d == 0 and v == 0:
                dx[m] = dinp.detach()
            else:
                pending = dinp.detach()
        ctx.saved = ctx.leaves = None
        if d == 0:
            dx = torch.cat(dx).reshape(ctx.x_shape).to(ctx.x_dtype)
        else:
            dx = torch.zeros(ctx.x_shape, dtype=ctx.x_dtype, device=g.device)
        # chunk 0's rank holds the input's gradient: summed over pp
        dx = _psum(dx, plan)
        return (None, dx, *(None if gr is None else gr.to(p.dtype)
                            for gr, p in zip(grads, flat)))


def _sequential(stage_fn, stacked_params, x):
    """Every stacked stage in order, no collectives."""
    items = _flatten(stacked_params)
    rows = {leaf.shape[0] for _, leaf in items}
    for i in range(rows.pop() if rows else 0):
        x = stage_fn(_unflatten([(n, leaf[i]) for n, leaf in items]), x)
    return x


def pipeline_apply(stage_fn, stacked_params, x, num_microbatches,
                   mesh=None, axis="pp", batch_spec=None, remat=True,
                   schedule="1f1b", num_chunks=1, param_specs=None,
                   params_layout="chunk"):
    """Run ``x`` (this rank's rows) through a stack of pipeline stages.

    ``stage_fn(stage_params, activations) -> activations`` is one
    chunk's computation on a (microbatch, ...) block and keeps its
    shape. ``stacked_params``: a tree whose leaves carry a leading chunk
    axis, this rank's block of it (the module docstring): ``num_chunks``
    rows over a pp axis of more than one rank; with no mesh, or pp and
    num_chunks both 1, every row, applied in order (no collectives).
    ``params_layout``: "chunk" (the rank's block of the chunk-major
    stack, rows d*V ... d*V + V - 1; V > 1 pays a gather of the stack
    over pp a call) or "device" (the rank's rows are already its
    interleaved chunks d, d + S, ...: ``device_major_order``).
    ``remat`` is read by "gpipe" only (the module docstring); "1f1b"
    always recomputes. Returns the stack's output, on every pp rank,
    shaped like ``x``."""
    if params_layout not in ("chunk", "device"):
        raise ValueError(
            "params_layout must be 'chunk' or 'device', got %r"
            % (params_layout,))
    del batch_spec, param_specs
    mesh = mesh if mesh is not None else current_mesh()
    num_stages = 1 if mesh is None else int(mesh.shape[axis])
    num_chunks = int(num_chunks)
    items = _flatten(stacked_params)
    sizes = {leaf.shape[0] for _, leaf in items}
    if len(sizes) != 1:
        raise ValueError("Inconsistent stage-axis sizes in stacked params: "
                         "%s" % sorted(sizes))
    (stacked_size,) = sizes
    if num_stages == 1 and num_chunks == 1:
        return _sequential(stage_fn, stacked_params, x)
    if stacked_size != num_chunks:
        raise ValueError(
            "this rank's block of the stacked stage axis (%d rows) must "
            "hold num_chunks=%d chunks (%s extent %d * num_chunks rows in "
            "all)" % (stacked_size, num_chunks, axis, num_stages))
    if num_chunks > 1:
        if schedule != "1f1b":
            raise ValueError("num_chunks > 1 requires schedule='1f1b'")
        if num_microbatches > num_stages:
            raise ValueError(
                "interleaved schedule needs num_microbatches (%d) <= "
                "num_stages (%d) — the conflict-free window; raise pp, "
                "lower M, or process more microbatches per update via "
                "the trainer's grad_accum_steps (each accumulation "
                "slice runs its own M<=S pipeline pass with exact "
                "large-batch semantics)"
                % (num_microbatches, num_stages))
    if schedule not in SCHEDULES:
        raise ValueError("unknown pipeline schedule %r" % schedule)
    if schedule == "gpipe" and params_layout != "chunk":
        raise ValueError(
            "params_layout='device' requires schedule='1f1b' (gpipe has "
            "no interleaving, so there is nothing to save)")
    if x.shape[0] % num_microbatches:
        raise ValueError("Local batch %d not divisible by %d microbatches"
                         % (x.shape[0], num_microbatches))
    if num_chunks > 1 and params_layout == "chunk" and num_stages > 1:
        stacked_params = _device_major(stacked_params, mesh, axis,
                                       num_stages, num_chunks)
        items = _flatten(stacked_params)
    plan = _Plan(stage_fn, [n for n, _ in items], int(num_microbatches),
                 num_stages, num_chunks, mesh, axis,
                 keep_graph=(schedule == "gpipe" and not remat))
    return _Pipeline.apply(plan, x, *(leaf for _, leaf in items))

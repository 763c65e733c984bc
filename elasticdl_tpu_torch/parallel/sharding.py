"""Parameter sharding rules: regex path -> PartitionSpec (port of
elasticdl_tpu/parallel/sharding.py).

Rules are ordered (first match wins), keyed on the '/'-joined flax
parameter path, as the reference's. A model module can export
``sharding_rules()``; without rules every parameter gets
``fsdp_auto_spec``: replicated when the mesh has no fsdp extent, else
ZeRO-style sharding of its largest divisible dim.

The reference lays a spec over the flax array; the port's weights are
``state_dict`` tensors in ``nn.Linear`` layout. ``param_specs`` reads a
model's ``flax_leaf(name)`` (its flax path and the layout kind of
models/transformer.py's table) and translates the flax spec through the
same table, so each rank's local shard is the port-layout image of the
reference's shard: "copy" keeps the spec, "dense" ((in, out) -> weight
(out, in)) swaps it, "in_heads" ((dim, H, d) -> (H*d, dim)) and
"heads_out" ((H, d, dim) -> (dim, H*d)) carry the heads' axis onto the
merged H*d dim, which keeps each shard's heads contiguous.

``NamedSharding`` is a spec on a mesh: the local shape and slice of a
global tensor on this rank (``shard``), and the all-gather that
rebuilds it (``gather``).
"""

import re

import numpy as np

from elasticdl_tpu_torch.train.train_state import TrainState


class PartitionSpec(tuple):
    """One entry per dim: None (replicated), an axis name, or a tuple of
    axis names (the dim split over their product, the first the most
    significant), as ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def axes(self):
        """Every axis name the spec shards over."""
        names = set()
        for entry in self:
            if entry is None:
                continue
            names.update((entry,) if isinstance(entry, str) else entry)
        return names

    def __repr__(self):
        return "PartitionSpec%s" % (tuple.__repr__(self),)


P = PartitionSpec


def entry_axes(entry):
    """A spec entry's axis names as a tuple."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


class NamedSharding:
    """``spec`` laid over ``mesh``: which block of a global tensor this
    rank holds. A size-1 axis shards nothing."""

    def __init__(self, mesh, spec):
        self.mesh = mesh
        self.spec = PartitionSpec(*spec)

    def sharded_dims(self, ndim):
        """``[(dim, live axes)]`` of the dims split over a live axis."""
        out = []
        for dim, entry in enumerate(tuple(self.spec)[:ndim]):
            live = tuple(a for a in entry_axes(entry)
                         if self.mesh.shape[a] > 1)
            if live:
                out.append((dim, live))
        return out

    def local_shape(self, shape):
        shape = list(shape)
        for dim, axes in self.sharded_dims(len(shape)):
            parts = self.mesh.size(axes)
            if shape[dim] % parts:
                raise ValueError(
                    "dim %d of %s does not divide over %s (%d ranks)"
                    % (dim, tuple(shape), axes, parts))
            shape[dim] //= parts
        return tuple(shape)

    def slices(self, shape):
        """This rank's block of a global ``shape``, as slices."""
        local = self.local_shape(shape)
        index = [slice(None)] * len(shape)
        for dim, axes in self.sharded_dims(len(shape)):
            start = self.mesh.index(axes) * local[dim]
            index[dim] = slice(start, start + local[dim])
        return tuple(index)

    def shard(self, tensor):
        """This rank's block of the global ``tensor``, contiguous (a
        copy when it is a proper block)."""
        if not self.sharded_dims(tensor.dim()):
            return tensor
        return tensor[self.slices(tensor.shape)].contiguous()

    def gather(self, local, axes=None):
        """The global tensor from every rank's block (an all-gather over
        each sharded dim's axes, whose backward reduce-scatters the
        per-rank gradients back onto the block). With ``axes``, only the
        dims sharded over those axes are gathered (the rest stay
        blocks)."""
        from elasticdl_tpu_torch.parallel.collectives import mesh_all_gather

        for dim, dim_axes in self.sharded_dims(local.dim()):
            if axes is not None:
                inside = [a in axes for a in dim_axes]
                if not any(inside):
                    continue
                if not all(inside):
                    raise ValueError("dim %d is split over %s: gather all "
                                     "of it or none" % (dim, dim_axes))
            axes_ = dim_axes
            if list(axes_) != sorted(axes_, key=self.mesh.axis_names.index):
                raise ValueError("a dim's axes must follow the mesh's axis "
                                 "order, got %s" % (axes_,))
            local = mesh_all_gather(local, axes_, gather_dimension=dim,
                                    mesh=self.mesh)
        return local

    def __repr__(self):
        return "NamedSharding(%r, %r)" % (self.mesh, self.spec)


class ShardingRules:
    def __init__(self, rules=None, default_spec=P()):
        # rules: [(regex, PartitionSpec)]
        self._rules = [(re.compile(r), spec) for r, spec in (rules or [])]
        self._default = default_spec

    def spec_for(self, path: str, shape=None):
        for pattern, spec in self._rules:
            if pattern.search(path):
                return spec
        return self._default


def fsdp_auto_spec(shape, mesh, axis="fsdp", min_size=2**14):
    """ZeRO-style: shard the largest divisible dim over the fsdp axis;
    small params stay replicated (sharding them costs more in gathers
    than it saves in memory)."""
    if axis not in mesh.shape or mesh.shape[axis] == 1:
        return P()
    if int(np.prod(shape)) < min_size:
        return P()
    axis_size = mesh.shape[axis]
    dims = sorted(range(len(shape)), key=lambda d: shape[d], reverse=True)
    for dim in dims:
        if shape[dim] % axis_size == 0:
            spec = [None] * len(shape)
            spec[dim] = axis
            return P(*spec)
    return P()


def flax_shape(shape, kind, heads):
    """The flax array's shape of a port weight of ``shape`` and layout
    ``kind``."""
    if kind == "dense":
        return tuple(reversed(shape))
    if kind == "in_heads":      # weight (H*d, dim) -> (dim, H, d)
        return (shape[1], heads, shape[0] // heads)
    if kind == "heads_out":     # weight (dim, H*d) -> (H, d, dim)
        return (heads, shape[1] // heads, shape[0])
    return tuple(shape)


def port_spec(spec, kind, path=""):
    """A flax spec carried onto the port's layout of the same leaf."""
    entries = list(spec)
    if kind == "dense":
        entries = (entries + [None] * 2)[:2]
        return P(*reversed(entries))
    if kind in ("in_heads", "heads_out"):
        entries = (entries + [None] * 3)[:3]
        dim_entry, heads, head_dim = (
            (entries[0], entries[1], entries[2]) if kind == "in_heads"
            else (entries[2], entries[0], entries[1]))
        if head_dim is not None:
            raise ValueError(
                "%s: a spec that splits head_dim (%r) has no contiguous "
                "image in the port's merged H*d layout" % (path, spec))
        return P(heads, dim_entry) if kind == "in_heads" else P(
            dim_entry, heads)
    return P(*entries)


def param_specs(params, mesh, rules=None, model=None):
    """``{name: PartitionSpec}`` in the port's layout for ``params``
    (``{name: tensor}``, anything with ``.shape``). With ``rules`` the
    spec is looked up by the leaf's flax path and layout
    (``model.flax_leaf(name)``; a model without it names its leaves
    with ``.`` for flax's ``/`` in the flax layout) and translated;
    without rules each leaf gets ``fsdp_auto_spec`` of its own shape."""
    heads = getattr(model, "num_heads", 1)
    specs = {}
    for name, value in params.items():
        shape = tuple(value.shape)
        if rules is None:
            specs[name] = fsdp_auto_spec(shape, mesh)
            continue
        leaf = getattr(model, "flax_leaf", None)
        path, kind = (leaf(name) if leaf is not None
                      else (name.replace(".", "/"), "copy"))
        spec = rules.spec_for(path, flax_shape(shape, kind, heads))
        spec = port_spec(spec if spec is not None else P(), kind, path)
        if kind in ("in_heads", "heads_out"):
            # the merged H*d dim splits between heads only
            parts = mesh.size(entry_axes(spec[0 if kind == "in_heads"
                                              else 1]))
            if heads % parts:
                raise ValueError("%s: %d heads do not split over %d ranks"
                                 % (path, heads, parts))
        specs[name] = spec
    return specs


def infer_state_shardings(state, mesh, rules: ShardingRules = None,
                          model=None, specs=None):
    """A TrainState-shaped tree of NamedShardings.

    params follow the rules (or fsdp auto-sharding); step and
    model_state (batch stats etc.) are replicated. Optimizer slots
    inherit their parameter's spec (ZeRO: momentum/variance shard with
    the weight): a slot dict keyed by the params' names gets each
    name's sharding, and every other optimizer leaf (counters,
    scalars) is replicated. ``specs``: the params' specs when already
    resolved."""
    if specs is None:
        specs = param_specs(state.params, mesh, rules, model)
    params = {name: NamedSharding(mesh, spec) for name, spec in specs.items()}
    replicated = NamedSharding(mesh, P())

    def like_params(tree):
        if isinstance(tree, dict) and tree and set(tree) <= set(params):
            return {name: params[name] for name in tree}
        if isinstance(tree, dict):
            return {k: like_params(v) for k, v in tree.items()}
        return replicated

    return TrainState(
        step=replicated,
        params=params,
        model_state={c: {n: replicated for n in tensors}
                     for c, tensors in state.model_state.items()},
        opt_state=like_params(state.opt_state),
    )

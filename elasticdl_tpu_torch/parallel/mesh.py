"""Device mesh over the ranks of torch.distributed's default process
group (port of elasticdl_tpu/parallel/mesh.py).

The reference's mesh is a ``jax.sharding.Mesh`` over the chips one
process drives. torch runs one process per card, so the port's mesh
spans the ranks of the default process group: on the card one NCCL
rank per card, in tests N gloo ranks on the CPU. The six logical axes
are the reference's:

- ``dp``   -- pure data parallelism (params replicated)
- ``fsdp`` -- data parallelism with parameter/optimizer sharding (ZeRO)
- ``pp``   -- pipeline parallelism (not ported: must be 1)
- ``tp``   -- tensor parallelism (within-layer sharding)
- ``sp``   -- sequence parallelism (not ported: must be 1)
- ``ep``   -- expert parallelism (MoE expert-sharded FFNs)

Axis sizes multiply to the rank count; ``dp=-1`` absorbs the ranks
left over. Rank r sits at the C-order coordinates of r over the axes'
sizes (``init_device_mesh``'s layout), so the ranks that share every
coordinate but those of some axes form that axes' group, ordered by
rank, which is also the mixed-radix order of their coordinates (the
first axis the most significant).
"""

import itertools
import math
import threading
from dataclasses import dataclass

import numpy as np

AXES = ("dp", "fsdp", "pp", "tp", "sp", "ep")
# Batch is sharded over both flavors of data parallelism.
DATA_AXES = ("dp", "fsdp")
# the axes whose shards are different values of one computation
MODEL_AXES = ("tp", "ep")

_NO_GROUP = (
    "the mesh spans the ranks of torch.distributed's default process "
    "group, and none is initialised: call torch.distributed."
    "init_process_group(backend, init_method='tcp://localhost:<port>', "
    "world_size=N, rank=r) in every rank first, or "
    "parallel.mesh.init_local_group() for one rank"
)


@dataclass
class MeshConfig:
    dp: int = -1  # -1: absorb remaining ranks
    fsdp: int = 1
    pp: int = 1
    tp: int = 1
    sp: int = 1
    ep: int = 1

    def resolve(self, num_devices=None):
        """``(dp, fsdp, pp, tp, sp, ep)`` over ``num_devices`` ranks (the
        default group's size when not given)."""
        for axis in ("fsdp", "pp", "tp", "sp", "ep"):
            if getattr(self, axis) < 1:
                raise ValueError(
                    "mesh axis %s=%d: sizes must be >= 1"
                    % (axis, getattr(self, axis))
                )
        if self.dp < 1 and self.dp != -1:
            raise ValueError(
                "mesh axis dp=%d: must be >= 1, or -1 to absorb the "
                "remaining devices" % self.dp
            )
        n = world_size() if num_devices is None else int(num_devices)
        fixed = self.fsdp * self.pp * self.tp * self.sp * self.ep
        dp = self.dp
        if dp == -1:
            if n % fixed != 0:
                raise ValueError(
                    "%d devices not divisible by fsdp*pp*tp*sp*ep=%d"
                    % (n, fixed)
                )
            dp = n // fixed
        if dp * fixed != n:
            raise ValueError(
                "Mesh %dx%dx%dx%dx%dx%d != %d devices"
                % (dp, self.fsdp, self.pp, self.tp, self.sp, self.ep, n)
            )
        return (dp, self.fsdp, self.pp, self.tp, self.sp, self.ep)


def parse_mesh_spec(spec: str) -> "MeshConfig | None":
    """Parse the CLI mesh string, e.g. ``"dp=4,fsdp=2"``. Unnamed axes
    default (dp absorbs the remaining ranks). Empty string -> None."""
    spec = (spec or "").strip()
    if not spec:
        return None
    sizes = {}
    for part in spec.split(","):
        name, _, value = part.partition("=")
        name = name.strip()
        if name not in AXES:
            raise ValueError(
                "unknown mesh axis %r (valid: %s)" % (name, ", ".join(AXES))
            )
        if name in sizes:
            raise ValueError("duplicate mesh axis %r in %r" % (name, spec))
        try:
            sizes[name] = int(value)
        except ValueError:
            raise ValueError(
                "mesh axis %r needs an integer size, e.g. %s=2 (got %r)"
                % (name, name, value)
            ) from None
        if sizes[name] < 1 and not (name == "dp" and sizes[name] == -1):
            raise ValueError(
                "mesh axis %s=%d: sizes must be >= 1 (only dp may be -1 "
                "to absorb the remaining devices)" % (name, sizes[name])
            )
    return MeshConfig(**sizes)


def world_size():
    """The default process group's rank count; raises without one."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(_NO_GROUP)
    return dist.get_world_size()


def init_local_group(device="cuda"):
    """A default process group of one rank (NCCL for a card, gloo for
    the CPU) over an in-process store (no port: a lone rank exchanges
    nothing), for a single process that trains through the mesh;
    returns False when a group already exists."""
    import torch.distributed as dist

    if dist.is_initialized():
        return False
    backend = "nccl" if str(device).startswith("cuda") else "gloo"
    dist.init_process_group(backend, store=dist.HashStore(), world_size=1,
                            rank=0)
    return True


class Mesh:
    """The rank grid: ``shape`` ({axis: size}, the reference's
    ``mesh.shape``), this rank's ``coords`` and the process group of any
    set of axes (``group``). Built by ``build_mesh``; ``with mesh:``
    makes it the ambient mesh of the collective helpers. Without a
    ``device_mesh`` (``abstract_mesh``) it has the shape and no
    groups."""

    axis_names = AXES
    empty = False

    def __init__(self, device_mesh, sizes, rank, device_type):
        self.device_mesh = device_mesh
        self.device_type = device_type
        self.shape = dict(zip(AXES, sizes))
        self.rank = rank
        self.coords = dict(zip(AXES, np.unravel_index(rank, sizes)))
        self.coords = {a: int(c) for a, c in self.coords.items()}
        self._groups = {}
        if device_mesh is None:
            return
        ranks = np.arange(int(np.prod(sizes))).reshape(sizes)
        live = [a for a in AXES if self.shape[a] > 1]
        # every set of two or more non-trivial axes gets its groups now,
        # in one order on every rank (group creation is collective)
        for n in range(2, len(live) + 1):
            for axes in itertools.combinations(live, n):
                self._groups[axes] = self._new_groups(ranks, axes)

    def _new_groups(self, ranks, axes):
        import torch.distributed as dist

        dims = [AXES.index(a) for a in axes]
        rest = [d for d in range(len(AXES)) if d not in dims]
        blocks = np.transpose(ranks, rest + dims).reshape(
            -1, math.prod(self.shape[a] for a in axes))
        group, _ = dist.new_subgroups_by_enumeration(
            [list(map(int, b)) for b in blocks])
        return group

    def live_axes(self, axes):
        """``axes`` (a name or a tuple) without its size-1 axes, in
        ``AXES`` order."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        for a in axes:
            if a not in AXES:
                raise ValueError("unknown mesh axis %r" % (a,))
        return tuple(a for a in AXES if a in axes and self.shape[a] > 1)

    def size(self, axes):
        """Product of the sizes of ``axes``."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return math.prod(self.shape[a] for a in axes)

    def index(self, axes):
        """This rank's position among the ranks of ``axes``' group: the
        mixed-radix number of its coordinates on those axes, in the
        order given (the first the most significant)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        at = 0
        for a in axes:
            at = at * self.shape[a] + self.coords[a]
        return at

    def group(self, axes):
        """The process group of this rank over ``axes`` (size-1 axes
        dropped; None when none is left)."""
        live = self.live_axes(axes)
        if not live:
            return None
        if self.device_mesh is None:
            raise RuntimeError("an abstract mesh has no process groups")
        if len(live) == 1:
            return self.device_mesh.get_group(live[0])
        return self._groups[live]

    def __enter__(self):
        _ambient_stack().append(self)
        return self

    def __exit__(self, *exc):
        _ambient_stack().pop()

    def __deepcopy__(self, memo):
        return self  # process groups are not copied

    def __repr__(self):
        return "Mesh(%s, rank %d)" % (
            ",".join("%s=%d" % kv for kv in self.shape.items()), self.rank)


_ambient = threading.local()


def _ambient_stack():
    stack = getattr(_ambient, "stack", None)
    if stack is None:
        stack = _ambient.stack = []
    return stack


def current_mesh():
    """The innermost ``with mesh:`` mesh of this thread, or None."""
    stack = _ambient_stack()
    return stack[-1] if stack else None


def build_mesh(config: MeshConfig = None, num_devices=None) -> Mesh:
    """The mesh of ``config`` over every rank of the default process
    group (``init_device_mesh``, one dim per axis). Raises without a
    group, and when ``num_devices`` is not the group's size: the mesh
    spans the group."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    n = world_size()
    if num_devices is not None and int(num_devices) != n:
        raise ValueError(
            "the mesh spans the default group's %d ranks; num_devices=%d"
            % (n, num_devices))
    sizes = (config or MeshConfig()).resolve(n)
    backend = dist.get_backend()
    device_type = "cuda" if backend == "nccl" else "cpu"
    device_mesh = init_device_mesh(device_type, sizes, mesh_dim_names=AXES)
    return Mesh(device_mesh, sizes, dist.get_rank(), device_type)


def abstract_mesh(config: MeshConfig = None, num_devices=1) -> Mesh:
    """The shape of ``config``'s mesh over ``num_devices`` ranks, with
    no process group (the plans of parallel/sharding.py and
    parallel/dense_plane.py need only the shape), at rank 0."""
    sizes = (config or MeshConfig()).resolve(num_devices)
    return Mesh(None, sizes, 0, "cpu")


def batch_sharding(mesh: Mesh):
    """Batch dim sharded over all data axes; feature dims replicated."""
    from elasticdl_tpu_torch.parallel.sharding import NamedSharding
    from elasticdl_tpu_torch.parallel.sharding import PartitionSpec as P

    return NamedSharding(mesh, P(DATA_AXES))


def replicated(mesh: Mesh):
    from elasticdl_tpu_torch.parallel.sharding import NamedSharding
    from elasticdl_tpu_torch.parallel.sharding import PartitionSpec as P

    return NamedSharding(mesh, P())


def data_parallel_size(mesh: Mesh) -> int:
    return int(math.prod(mesh.shape[a] for a in DATA_AXES if a in mesh.shape))

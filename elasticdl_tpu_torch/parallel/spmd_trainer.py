"""SPMD trainer: the dense data plane over a mesh of ranks (port of
elasticdl_tpu/parallel/spmd_trainer.py).

The reference's trainer is one jitted step whose sharding annotations
make XLA insert every collective. torch runs eagerly, one process per
card, so the port states the plane explicitly: each rank of the mesh
(parallel/mesh.py, the ranks of the default process group) holds its
block of the state and its rows of the batch, and the step reduces
what the annotations made XLA reduce:

- the batch is split over the data axes (dp, fsdp): rank i of the data
  group trains on rows [i*b, (i+1)*b) of the global batch of d*b, and
  the masked mean divides by the global batch's mask weight;
- a parameter's block follows its spec (``sharding.param_specs``: the
  model's ``sharding_rules`` translated onto the port's layout, or
  ``fsdp_auto_spec``). An fsdp-sharded block is all-gathered for the
  forward, and that gather's backward reduce-scatters its gradient, so
  the optimizer steps on the block (ZeRO); tp- and ep-sharded blocks
  stay local and the model computes on them (models/transformer.py's
  and models/moe_transformer.py's ``mesh``);
- gradients then reduce by the dense plan (parallel/dense_plane.py):
  replicated parameters all-reduce over the data axes, fsdp blocks
  over dp, model-axis blocks over the data axes, in one flat bucket
  per group; the health norm sums each distinct block once.

The trainer presents ``TorchTrainer``'s surface (``create_state``,
``train_step``, ``eval_step``, ...), so the worker is oblivious to
whether it drives one card or a mesh. On a one-rank mesh every block
is the whole tensor and nothing is reduced: the step is
``TorchTrainer``'s, bit for bit.

Sequence parallelism: when the model's ``batch_spec`` splits dim 1
over sp (``P(DATA_AXES, "sp")``, the TransformerLM's), each rank also
takes its block of every sequence, and the sp ranks of a data slot are
parts of one computation: the model's loss is each rank's share of the
per-sample mean (models/transformer.py), so the loss and the gradients
of the parameters replicated over sp are summed over sp as over the
data axes. The mask weight is summed over the data axes only (every sp
rank holds the same samples).

Pipeline parallelism: leaves the rules put under ``P("pp")`` (a
pipeline model's block stack) stay on their stage, as tp blocks do;
the model computes its stages on them (parallel/pipeline.py), and its
output is the same on every pp rank, so the pieces every stage holds
(embedding, final norm, head) get the same whole gradient on each and
are reduced over the data axes only: counted once, not pp times.

The sharded init never puts a sharded leaf whole on the device: the
model's weights are drawn on the host (its constructor, or the seeded
generator for a layer sized by the first batch), each rank slices its
block there and moves only that, so the weights are ``TorchTrainer``'s
for the same seed.
"""

import numpy as np
import torch

from elasticdl_tpu_torch.common.device import resolve_device
from elasticdl_tpu_torch.common.log_utils import default_logger
from elasticdl_tpu_torch.models.layers import has_uninitialized_params
from elasticdl_tpu_torch.observability import device as device_obs
from elasticdl_tpu_torch.parallel import collectives
from elasticdl_tpu_torch.parallel.dense_plane import plan_dense_plane
from elasticdl_tpu_torch.parallel.mesh import (
    AXES,
    DATA_AXES,
    MODEL_AXES,
    MeshConfig,
    build_mesh,
    data_parallel_size,
)
from elasticdl_tpu_torch.parallel.sharding import (
    NamedSharding,
    ShardingRules,
    entry_axes,
    infer_state_shardings,
    param_specs,
)
from elasticdl_tpu_torch.testing import faults
from elasticdl_tpu_torch.train.health import maybe_tracker
from elasticdl_tpu_torch.train.step_fns import make_eval_step, make_train_step
from elasticdl_tpu_torch.train.train_state import TrainState, resolve_dtype
from elasticdl_tpu_torch.worker.trainer import _to_device, _to_numpy

logger = default_logger("elasticdl_tpu_torch.parallel.spmd_trainer")

# the axes on which the model computes on its own blocks: it must be
# built over the trainer's mesh when any of them is split
MODEL_COMPUTE_AXES = ("pp",) + MODEL_AXES


class SpmdTrainer:
    def __init__(
        self,
        model,
        loss_fn,
        optimizer,
        compute_dtype=None,
        seed=0,
        mesh=None,
        mesh_config: MeshConfig = None,
        sharding_rules: ShardingRules = None,
        batch_spec=None,
        grad_accum_steps=1,
        health=None,
        device="cuda",
    ):
        """``model`` is built on the host (its weights are the ones the
        state starts from); with ``tp`` or ``ep`` above 1 it must have
        been built over this mesh (``custom_model(mesh=mesh)``), since it
        computes on its own blocks. ``device`` is this rank's card
        (``cuda`` unless the caller asks for the CPU). ``batch_spec``
        (the model's, e.g. ``P(DATA_AXES, "sp")``) is checked: the batch
        splits over the data axes on dim 0 and may split dim 1 over sp,
        applied per leaf up to its number of dims."""
        self.device = resolve_device(device)
        self.mesh = mesh if mesh is not None else build_mesh(mesh_config)
        batch_spec = tuple(batch_spec or ()) + (None, None)
        if set(entry_axes(batch_spec[0])) - set(DATA_AXES):
            raise ValueError("the batch's dim 0 splits over the data axes "
                             "only, got %r" % (batch_spec,))
        if (set(entry_axes(batch_spec[1])) - {"sp"}
                or any(entry_axes(e) for e in batch_spec[2:])):
            raise ValueError("the batch's dim 1 may split over sp only and "
                             "no later dim splits, got %r" % (batch_spec,))
        # the sequence axis the batch's dim 1 splits over, if live
        self._seq = tuple(a for a in entry_axes(batch_spec[1])
                          if self.mesh.shape[a] > 1)
        computes = [a for a in MODEL_COMPUTE_AXES + self._seq
                    if self.mesh.shape[a] > 1]
        if computes and getattr(model, "mesh", None) is not self.mesh:
            raise ValueError(
                "mesh %s splits the model over %s: build the model over "
                "the same mesh (custom_model(mesh=mesh)), it computes on "
                "its own shards" % (self.mesh, "/".join(computes)))
        self._model = model
        self._seed = seed
        self._tx = optimizer
        self._rules = sharding_rules
        if health is None:
            self.health = maybe_tracker(role="worker")
        elif health is False:
            self.health = None
        else:
            self.health = health
        self._health_on = self.health is not None
        compute_dtype = resolve_dtype(compute_dtype)
        self._train_step = make_train_step(
            model, loss_fn, optimizer, compute_dtype,
            grad_accum_steps=grad_accum_steps,
            health=self._health_on,
            guard_nonfinite=(
                self._health_on and self.health.action == "skip"),
            plane=self,
        )
        self._eval_step = make_eval_step(model, compute_dtype, plane=self)
        self._data = self.mesh.live_axes(DATA_AXES)
        # the loss and the gradients add up over the data axes and the
        # sequence's
        self._summed = self._data + self._seq
        self._specs = None
        self._shardings = None
        self._state_shardings = None
        # the dropout rows of this rank's share of the step's batch
        self.rows = None
        # dense data plane: derived at create_state (needs the params)
        self.dense_plan = None
        logger.info("SPMD mesh %s (%d-way data parallel) on %s",
                    dict(self.mesh.shape), data_parallel_size(self.mesh),
                    self.device)

    @property
    def model(self):
        return self._model

    # ------------------------------------------------------------------
    def create_state(self, sample_features=None):
        """This rank's blocks of the state over the model's weights.
        A layer sized by the first batch is sized on the host and drawn
        from the trainer's seed, as ``TorchTrainer`` draws it."""
        model = self._model
        if has_uninitialized_params(model):
            if sample_features is None:
                raise ValueError("the model sizes layers from its first "
                                 "batch: pass sample_features")
            with torch.random.fork_rng(devices=[]), torch.no_grad():
                model.eval()
                model(_to_device(sample_features, torch.device("cpu")))
            model.reset_parameters(torch.Generator().manual_seed(self._seed))
        full = {name: p.detach() for name, p in model.named_parameters()}
        self._specs = param_specs(full, self.mesh, self._rules, model)
        self._shardings = {name: NamedSharding(self.mesh, spec)
                           for name, spec in self._specs.items()}
        self._set_dense_plan(full)
        # the host slices each block, and only the block moves
        params = {name: self._shardings[name].shard(p).to(
            self.device, copy=True) for name, p in full.items()}
        buffers = {name: b.detach().to(self.device, copy=True)
                   for name, b in model.named_buffers()}
        to_flax = getattr(model, "flax_params", None)
        state = TrainState(
            step=0,
            params=params,
            model_state={"batch_stats": buffers} if buffers else {},
            opt_state=self._tx.init(params),
            to_flax=(None if to_flax is None else
                     lambda p: to_flax(self.full_params(p))),
            from_flax=getattr(model, "params_from_flax", None),
        )
        self._state_shardings = infer_state_shardings(
            state, self.mesh, model=model, specs=self._specs)
        return state

    def _set_dense_plan(self, params):
        self.dense_plan = plan_dense_plane(params, self.mesh,
                                           specs=self._specs)
        summary = self.dense_plan.summary()
        logger.info(
            "dense plane: mesh %s, %d reduce-scatter / %d psum / %d local "
            "params, %.1f MB dense state, ~%.1f MB collective traffic per "
            "step (PS carries none of it)",
            summary["mesh_shape"], summary["reduce_scatter_params"],
            summary["psum_params"], summary["local_params"],
            summary["param_bytes"] / 1e6,
            summary["collective_bytes_per_step"] / 1e6,
        )

    def full_params(self, params):
        """The whole parameters from every rank's blocks (collective:
        every rank calls it), for an export."""
        with torch.no_grad():
            return {name: self._shardings[name].gather(p)
                    for name, p in params.items()}

    # the plane's hooks, called by train/step_fns.py -------------------
    def gather(self, leaves):
        """The parameters the forward computes with: fsdp blocks
        all-gathered (backward: reduce-scatter), model-axis blocks as
        they are."""
        return {name: self._shardings[name].gather(p, axes=DATA_AXES)
                for name, p in leaves.items()}

    def global_weight(self, weight):
        """The mask weight of the whole batch."""
        with torch.no_grad():
            return collectives.mesh_psum(weight, self._data, mesh=self.mesh)

    def global_loss(self, loss):
        """The batch's loss from each rank's share (each already divided
        by the global weight): summed over the data axes and, under
        sequence parallelism, over sp."""
        with torch.no_grad():
            return collectives.mesh_psum(loss, self._summed, mesh=self.mesh)

    def reduce_grads(self, grads):
        """Each gradient reduced by its plan: over the data axes (and
        the sequence's) its block is not sharded on, one flat all-reduce
        per group."""
        buckets = {}
        for name, g in grads.items():
            axes = tuple(a for a in self._summed
                         if a not in self._specs[name].axes())
            if axes:
                buckets.setdefault(axes, []).append(name)
        out = dict(grads)
        with torch.no_grad():
            for axes, names in buckets.items():
                flat = torch.cat([grads[n].reshape(-1) for n in names])
                flat = collectives.mesh_psum(flat, axes, mesh=self.mesh)
                for n, part in zip(names, torch.split(
                        flat, [grads[n].numel() for n in names])):
                    out[n] = part.view_as(grads[n])
        return out

    def grad_norm(self, grads):
        """The global L2 norm: every rank's squared blocks, each divided
        by the number of ranks holding the same block, summed over the
        whole mesh."""
        world = self.mesh.size(AXES)
        total = torch.zeros((), dtype=torch.float32, device=self.device)
        with torch.no_grad():
            for name, g in grads.items():
                blocks = self.mesh.size(
                    a for a in self._specs[name].axes())
                total = total + torch.sum(torch.square(g.float())) * (
                    blocks / world)
            total = collectives.mesh_psum(total, AXES, mesh=self.mesh)
        return torch.sqrt(total)

    # ------------------------------------------------------------------
    @property
    def cost_step_flops(self):
        """No compiled step, no cost model: 0.0 (not measured)."""
        return 0.0

    @property
    def cost_step_bytes(self):
        return 0.0

    @property
    def mesh_shape_str(self):
        return (self.dense_plan.mesh_shape_str()
                if self.dense_plan is not None else "")

    @property
    def collective_bytes_per_step(self):
        return float(self.dense_plan.collective_bytes_per_step
                     if self.dense_plan is not None else 0.0)

    @property
    def state_shardings(self):
        """TrainState-shaped tree of NamedShardings (None before
        create_state)."""
        return self._state_shardings

    # ------------------------------------------------------------------
    def shard_batch(self, batch):
        """This rank's rows of a host numpy batch (the batch dim over the
        data axes), moved to the device. Raises unless the global batch
        divides by the data-parallel size."""
        dp = data_parallel_size(self.mesh)
        leaves = list(_leaves(batch))
        global_rows = leaves[0].shape[0] if leaves else 0
        if leaves and global_rows % dp != 0:
            raise ValueError(
                "Global batch %d not divisible by data-parallel size %d"
                % (global_rows, dp))
        local = global_rows // dp if leaves else 0
        offset = self.mesh.index(self._data) * local
        self.rows = None if dp == 1 else (offset, global_rows)
        part = _map(lambda leaf: np.asarray(leaf)[offset:offset + local]
                    if dp > 1 else leaf, batch)
        if self._seq:
            part = _map(self.seq_block, part)
        device_obs.record_transfer(
            "h2d", sum(np.asarray(x).nbytes for x in _leaves(part)))
        return _to_device(part, self.device)

    def ensure_state(self, state, batch):
        if state is None:
            return self.create_state(batch["features"])
        return state

    def train_step(self, state, batch):
        """One step on a numpy batch (the same global batch on every
        rank); returns ``(state, loss)`` with the global loss a 0-d
        tensor on the device."""
        state = self.ensure_state(state, batch)
        batch = faults.maybe_poison_batch(batch)
        local = self.shard_batch(batch)
        with self.mesh:
            if not self._health_on:
                return self._train_step(state, local)
            state, loss, scalars = self._train_step(state, local)
        self.health.observe(float(loss), float(scalars["grad_norm"]),
                            bool(scalars["nonfinite"]))
        return state, loss

    def seq_block(self, leaf):
        """This rank's block of dim 1 of a host array under sequence
        parallelism (a leaf of fewer dims as it is)."""
        leaf = np.asarray(leaf)
        if leaf.ndim < 2:
            return leaf
        sp = self.mesh.shape["sp"]
        if leaf.shape[1] % sp:
            raise ValueError("sequence %d not divisible by sp=%d"
                             % (leaf.shape[1], sp))
        n = leaf.shape[1] // sp
        start = self.mesh.index("sp") * n
        return leaf[:, start:start + n]

    def eval_step(self, state, batch):
        """Outputs of the whole batch on every rank (each rank evaluates
        it whole; under sequence parallelism each rank its block of the
        sequence, and the outputs gather over sp: a collective)."""
        features = batch["features"]
        if self._seq:
            features = _map(self.seq_block, features)
        features = _to_device(features, self.device)
        with self.mesh:
            out = self._eval_step(state, features)
            if self._seq:
                with torch.no_grad():
                    out = collectives.mesh_all_gather(
                        out, self._seq, gather_dimension=1, mesh=self.mesh)
            return _to_numpy(out)


def _leaves(tree):
    if isinstance(tree, dict):
        for value in tree.values():
            yield from _leaves(value)
    elif isinstance(tree, (list, tuple)):
        for value in tree:
            yield from _leaves(value)
    elif tree is not None:
        yield tree


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return None if tree is None else fn(tree)


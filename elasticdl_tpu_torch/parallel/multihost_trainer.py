"""Lockstep SPMD trainer over a mesh spanning worker processes (port of
elasticdl_tpu/parallel/multihost_trainer.py).

The reference's mesh spans the processes of ``jax.distributed`` and
each process contributes its local batch as its shard of the global
one. The port's mesh spans the ranks of the default process group
(parallel/mesh.py), one rank a worker process, so the same holds rank
by rank: each process's batch is its data shard, the masked mean
divides by the all-reduced mask weight, and the dense gradients are
all-reduced over the data axes (parallel/spmd_trainer.py's plane).

Lockstep contract: every process runs the same sequence of
collectives. The elastic task queue hands workers different numbers of
batches, so the worker's lockstep loop (worker/worker.py
``_train_batches_lockstep``) runs a small consensus all-reduce before
the steps: each process says whether it holds a real batch and whether
its stream ended; processes whose stream ran dry step on zero-masked
batches until every stream has ended, and only then does anyone leave.

Failure: a collective with a dead peer fails (gloo at once, the peer's
sockets being closed; else at the group's timeout), and the worker
turns that into a relaunch: its tasks go back to the master, it exits
with code 3, and the relaunched processes form the group at the new
mesh epoch and resume from the checkpoint.

Layout: one data slot a process (a process drives one card), so the
model axes tp and ep stay 1 here; dp and fsdp may span the processes.
Pipeline and sequence parallelism (pp, sp) put several processes in one
data slot: their local batches are gathered over those axes (in rank
order) into the slot's batch, which every rank of the slot trains on
(the pipeline's stages, or each rank its block of every sequence), so
every record still trains once.
Checkpoints hold the whole state: ``checkpoint_state`` gathers every
block (a collective every rank calls at the same version, which the
lockstep loop guarantees) and only rank 0 writes it; ``adopt_restored``
takes a whole state read from disk and keeps this rank's blocks, so a
checkpoint of one world resumes onto another.
"""

import dataclasses
import time

import numpy as np
import torch

from elasticdl_tpu_torch.common.log_utils import (
    default_logger as _logger_factory,
)
from elasticdl_tpu_torch.observability import device as device_obs
from elasticdl_tpu_torch.parallel.mesh import (
    DATA_AXES,
    MODEL_AXES,
    data_parallel_size,
)
from elasticdl_tpu_torch.parallel.spmd_trainer import (
    SpmdTrainer,
    _leaves,
    _map,
)
from elasticdl_tpu_torch.train.step_fns import make_eval_step
from elasticdl_tpu_torch.train.train_state import resolve_dtype
from elasticdl_tpu_torch.worker.trainer import _to_device, _to_numpy

logger = _logger_factory("elasticdl_tpu_torch.parallel.multihost_trainer")

# the axes whose processes share one data slot
SLOT_AXES = ("pp", "sp")


def _join(fn, trees):
    """``fn`` over the leaves of ``trees`` (one structure) position by
    position."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _join(fn, [t[k] for t in trees]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_join(fn, list(vs)) for vs in zip(*trees))
    return fn(*trees)


def _param_keyed(tree, params):
    return isinstance(tree, dict) and bool(tree) and set(tree) <= set(params)


class LockstepMixin:
    """The cross-process lockstep runtime shared by the dense
    (MultiHostSpmdTrainer) and sparse (MultiHostSparseSpmdTrainer,
    train/sparse_spmd.py) trainers: the consensus all-reduce, the
    collective timings and the checkpoint surface. Hosts call
    ``_init_lockstep()`` once ``self.mesh`` exists; ``_spmd`` is the
    SpmdTrainer whose shardings lay the state out."""

    def _init_lockstep(self):
        import torch.distributed as dist

        self._process_count = dist.get_world_size()
        self._process_index = dist.get_rank()
        # the flags ride a CPU tensor over gloo, a card's over NCCL
        self._flag_device = (self.device if dist.get_backend() == "nccl"
                             else torch.device("cpu"))
        # host seconds and calls: the consensus all-reduce and the
        # dense gradients' all-reduce (reduce_grads)
        self.lockstep_stats = {"consensus_s": 0.0, "consensus_calls": 0,
                               "allreduce_s": 0.0, "allreduce_calls": 0}

    @property
    def process_count(self):
        return self._process_count

    @property
    def process_index(self):
        return self._process_index

    @property
    def checkpoint_writer(self):
        """Rank 0 writes the checkpoints every rank gathers."""
        return self._process_index == 0

    def _time_allreduce(self, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        self.lockstep_stats["allreduce_s"] += time.perf_counter() - t0
        self.lockstep_stats["allreduce_calls"] += 1
        return out

    def consensus(self, have_data, stream_ended=False):
        """``(alive, ended)``: how many processes hold a real batch this
        round, and how many have PERMANENTLY exhausted their task
        stream. A collective: every process calls it once per round.
        The two are distinct because batch acquisition is a
        non-blocking poll (worker.py ``_BatchPoller``): no batch can
        mean "nothing this round" (the master said WAIT), which must not
        read as "done", or a worker leaving on an idle round would
        strand its peers in the next consensus."""
        import torch.distributed as dist

        t0 = time.perf_counter()
        flags = torch.tensor(
            [1.0 if have_data else 0.0, 1.0 if stream_ended else 0.0],
            dtype=torch.float32, device=self._flag_device)
        dist.all_reduce(flags)
        alive, ended = flags.tolist()
        self.lockstep_stats["consensus_s"] += time.perf_counter() - t0
        self.lockstep_stats["consensus_calls"] += 1
        return int(round(alive)), int(round(ended))

    # -- checkpoint surface ---------------------------------------------
    def _state_tree(self, state, fn):
        """``state`` with ``fn(name, tensor)`` over its params and the
        optimizer slots keyed like them, other tensors through
        ``fn(None, tensor)``."""
        def slot(value):
            if _param_keyed(value, state.params):
                return {n: fn(n, t) for n, t in value.items()}
            if isinstance(value, dict):
                return {k: slot(v) for k, v in value.items()}
            if isinstance(value, torch.Tensor):
                return fn(None, value)
            return value

        with torch.no_grad():
            return dataclasses.replace(
                state,
                params={n: fn(n, t) for n, t in state.params.items()},
                opt_state={k: slot(v) for k, v in state.opt_state.items()},
                model_state={c: {n: fn(None, t) for n, t in ts.items()}
                             for c, ts in state.model_state.items()},
            )

    def checkpoint_state(self, state):
        """The whole state on the host: every sharded block gathered (a
        collective: every rank calls it at the same version) and named
        by the model's flax names. Rank 0 writes it
        (``checkpoint_writer``)."""
        shardings = self._spmd._shardings
        model = self._spmd.model

        def whole(name, t):
            if name is not None:
                t = shardings[name].gather(t)
            return t.detach().cpu().clone()

        return dataclasses.replace(
            self._state_tree(state, whole),
            to_flax=getattr(model, "flax_params", None),
            from_flax=getattr(model, "params_from_flax", None))

    def local_state(self, state):
        """The whole state without communication. Valid when no leaf is
        sharded over a data axis, which spans the processes here: a
        process then does not hold it, and evaluation (per worker, not
        collective) must not gather."""
        if self.mesh.live_axes(SLOT_AXES):
            raise ValueError(
                "mesh %s runs the model across processes (pp or sp): "
                "per-worker evaluation needs pp = sp = 1" % (self.mesh,))
        specs = self._spmd._specs or {}
        for name, spec in specs.items():
            if set(spec.axes()) & set(self.mesh.live_axes(DATA_AXES)):
                raise ValueError(
                    "state leaf %s is sharded over %s, which spans the "
                    "worker processes; per-worker evaluation needs the "
                    "dense state replicated (dp)" % (name, spec))
        return state

    def adopt_restored(self, restored):
        """A whole state read from a checkpoint (``checkpoint_state``'s
        shapes) as this rank's blocks on its device: the checkpoint of
        any world size resumes onto this mesh."""
        if self._spmd._shardings is None:
            raise RuntimeError("call create_state first")
        shardings = self._spmd._shardings
        device = self._spmd.device

        def block(name, t):
            if name is not None:
                t = shardings[name].shard(t)
            return t.to(device, copy=True)

        state = self._state_tree(restored, block)
        to_flax = getattr(self._spmd.model, "flax_params", None)
        return dataclasses.replace(
            state,
            to_flax=(None if to_flax is None else
                     lambda p: to_flax(self._spmd.full_params(p))),
            from_flax=getattr(self._spmd.model, "params_from_flax", None))

    @property
    def restore_shardings(self):
        """The current mesh's shardings of the state a restore adopts
        (``adopt_restored`` lays a whole checkpoint out by them)."""
        return self._spmd.state_shardings


class MultiHostSpmdTrainer(LockstepMixin, SpmdTrainer):
    """SpmdTrainer whose mesh spans the worker processes; each process's
    batch is its data shard."""

    def __init__(
        self,
        model,
        loss_fn,
        optimizer,
        compute_dtype=None,
        seed=0,
        mesh=None,
        mesh_config=None,
        sharding_rules=None,
        batch_spec=None,
        grad_accum_steps=1,
        health=None,
        device="cuda",
    ):
        super().__init__(
            model, loss_fn, optimizer, compute_dtype=compute_dtype,
            seed=seed, mesh=mesh, mesh_config=mesh_config,
            sharding_rules=sharding_rules, batch_spec=batch_spec,
            grad_accum_steps=grad_accum_steps, health=health,
            device=device)
        live = [a for a in MODEL_AXES if self.mesh.shape[a] > 1]
        if live:
            raise ValueError(
                "lockstep layout contract: each worker process owns one "
                "data slot (its own batch), so the model axes %s must be "
                "1; split the batch over dp and fsdp" % live)
        self._init_lockstep()
        self._local_eval = make_eval_step(model, resolve_dtype(compute_dtype))
        self._eval_cache = None

    @property
    def _spmd(self):
        return self

    def reduce_grads(self, grads):
        return self._time_allreduce(super().reduce_grads, grads)

    def _slot_batch(self, local_batch):
        """The data slot's batch: the local batches of the processes
        that share this slot (over pp and sp), in rank order (a
        collective of the slot's ranks)."""
        import torch.distributed as dist

        slot = self.mesh.live_axes(SLOT_AXES)
        if not slot:
            return local_batch
        group = self.mesh.group(slot)
        parts = [None] * dist.get_world_size(group)
        dist.all_gather_object(parts, local_batch, group=group)

        def join(*leaves):
            return np.concatenate([np.asarray(x) for x in leaves])

        return _join(join, parts)

    def shard_batch(self, local_batch):
        """This process's batch is its shard of the global batch (the
        global batch is the processes' batches in rank order; processes
        sharing a data slot over pp or sp train on their batches
        together)."""
        local_batch = self._slot_batch(local_batch)
        leaves = list(_leaves(local_batch))
        local = leaves[0].shape[0] if leaves else 0
        dp = data_parallel_size(self.mesh)
        offset = self.mesh.index(self._data) * local
        self.rows = None if dp == 1 else (offset, dp * local)
        if self._seq:
            local_batch = _map(self.seq_block, local_batch)
        device_obs.record_transfer(
            "h2d", sum(np.asarray(x).nbytes for x in _leaves(local_batch)))
        return _to_device(local_batch, self.device)

    def eval_step(self, state, batch):
        """Evaluation tasks are per worker, not collective: the local
        whole state (``local_state``) scores this worker's batch."""
        if self._eval_cache is None or self._eval_cache[0] is not state:
            self._eval_cache = (state, self.local_state(state))
        features = _to_device(batch["features"], self.device)
        return _to_numpy(self._local_eval(self._eval_cache[1], features))


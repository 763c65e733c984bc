"""Sparse embedding training under a mesh: sparse x SPMD (port of
elasticdl_tpu/train/sparse_spmd.py).

ElasticDL's flagship scenario is N workers training ONE model against a
parameter-server fleet. The host PS keeps what it is good at (sharded,
lazily grown embedding tables); the dense parameters are shared through
the mesh's collectives (parallel/spmd_trainer.py's plane), not through
per-step dense RPCs. The port's mesh spans the ranks of the default
process group, one rank a card.

Two compositions:

- ``SparseSpmdTrainer``: every rank holds the same global batch (the
  contract of the port's ``SpmdTrainer``) and trains on its rows of it,
  the batch split over the data axes and the pulled rows buffer
  replicated. The dense gradients reduce by the plane's plan and the
  row gradients are summed over the data ranks, so the worker as a
  whole still sends the requests a ``SparseTrainer`` sends: one pull
  and one push a step. Every rank runs the same host logic (unique
  ids, the device tier's lookups); rank 0 alone talks to the PS and
  what it hears is broadcast (``_LeaderPSClient``). The device tier is
  replicated at ep 1, as the reference's ``P()`` layout, so K1-K3 run
  on every rank on the same values; ep > 1 would shard it over the ep
  ranks, which has no launch path yet (ROADMAP Queue 1 item 2).
- ``MultiHostSparseSpmdTrainer``: N worker processes in lockstep, one
  dp slot each. The dense gradients are all-reduced over dp, so the
  dense parameters stay bit-identical on every worker. Each process
  pulls rows for its own batch and pushes only its own row gradients;
  the loss is the masked mean over the global batch, so the N pushes
  sum to the global batch's gradient (the sync PS's accumulate-then-
  apply with grads_to_wait = N).

Sync-PS version alignment: the lockstep loop keeps every process at
the same global round, and the sync PS bumps its version once per
grads_to_wait pushes, so a round-k push always arrives at store version
k. Pushes therefore carry ``version = completed rounds``, not the last
response's version (which for every non-final pusher of a round is the
pre-apply value and would be rejected next round).
"""

import numpy as np
import torch

from elasticdl_tpu_torch.common.log_utils import (
    default_logger as _logger_factory,
)
from elasticdl_tpu_torch.data.pipeline import MASK_KEY, pad_batch
from elasticdl_tpu_torch.parallel import collectives
from elasticdl_tpu_torch.parallel.mesh import (
    AXES,
    DATA_AXES,
    build_mesh,
    data_parallel_size,
)
from elasticdl_tpu_torch.parallel.multihost_trainer import LockstepMixin
from elasticdl_tpu_torch.parallel.spmd_trainer import SpmdTrainer, _map
from elasticdl_tpu_torch.train.sparse import (
    ROWS_SUFFIX,
    SparseTrainer,
    _to_device,
)
from elasticdl_tpu_torch.train.device_tier import resolve_tier_config
from elasticdl_tpu_torch.train.step_fns import global_grad_norm

logger = _logger_factory("elasticdl_tpu_torch.train.sparse_spmd")


class _SparsePlane:
    """The sparse step's dense data plane: ``spmd``'s hooks (the
    parameters' gather, the global weight and loss, the gradients'
    plan) and the row gradients' reduction. ``sum_rows``: the rows
    buffer is replicated and each rank's row gradients are its share,
    summed over the data ranks; else each rank's rows are its own."""

    def __init__(self, spmd, sum_rows, timed=None):
        self._spmd = spmd
        self._sum_rows = sum_rows
        self._timed = timed

    @property
    def rows(self):
        return self._spmd.rows

    def gather(self, params):
        return self._spmd.gather(params)

    def global_weight(self, weight):
        return self._spmd.global_weight(weight)

    def global_loss(self, loss):
        return self._spmd.global_loss(loss)

    def reduce_grads(self, grads):
        if self._timed is None:
            return self._spmd.reduce_grads(grads)
        return self._timed(self._spmd.reduce_grads, grads)

    def reduce_row_grads(self, row_grads):
        if not self._sum_rows:
            return row_grads
        with torch.no_grad():
            return collectives.mesh_psum(row_grads, DATA_AXES,
                                         mesh=self._spmd.mesh)

    def grad_norm(self, param_grads, row_grads):
        mesh = self._spmd.mesh
        if not mesh.live_axes(AXES):
            return global_grad_norm(param_grads, row_grads)
        dense = self._spmd.grad_norm(param_grads)
        with torch.no_grad():
            rows = torch.zeros((), dtype=torch.float32, device=dense.device)
            for g in row_grads.values():
                rows = rows + torch.sum(torch.square(g.float()))
            if not self._sum_rows:
                rows = collectives.mesh_psum(rows, DATA_AXES, mesh=mesh)
            return torch.sqrt(torch.square(dense) + rows)


class _LeaderPSClient:
    """One PS client for the ranks of a multi-rank SparseSpmdTrainer.
    Every rank runs the same host logic on the same batch, so its calls
    come in the same order on every rank: rank 0 sends each request and
    broadcasts what it hears (a pull's rows, a push's answer, the PS
    shards that restarted since the last call); the others send nothing.
    Table registration and the tier's writebacks are rank 0's alone."""

    def __init__(self, inner, leader, device):
        import torch.distributed as dist

        self._inner = inner
        self._leader = leader
        self._device = device if dist.get_backend() == "nccl" else None
        self._hook = None
        self._restarts = []
        if leader and hasattr(inner, "resync_hook"):
            inner.resync_hook = self._note_restart

    def _note_restart(self, shard):
        # rank 0's client saw a PS shard relaunch: every rank's hook
        # hears it with the next shared answer
        self._restarts.append(shard)

    @property
    def ps_num(self):
        return getattr(self._inner, "ps_num", 1)

    @property
    def resync_hook(self):
        return self._hook

    @resync_hook.setter
    def resync_hook(self, hook):
        self._hook = hook

    def _shared(self, fn):
        import torch.distributed as dist

        payload = [None]
        if self._leader:
            error = value = None
            try:
                value = fn()
            except Exception as e:
                error = e
            restarts, self._restarts = self._restarts, []
            payload = [(value, None if error is None else repr(error),
                        restarts)]
        dist.broadcast_object_list(payload, src=0, device=self._device)
        value, failed, restarts = payload[0]
        for shard in restarts:
            if self._hook is not None:
                self._hook(shard)
        if failed is not None:
            if self._leader:
                raise error
            raise RuntimeError("rank 0's PS call failed: %s" % failed)
        return value

    def pull_embedding_vectors(self, name, ids):
        return self._shared(
            lambda: self._inner.pull_embedding_vectors(name, ids))

    def pull_embedding_batch(self, ids_by_table):
        inner = self._inner
        if hasattr(inner, "pull_embedding_batch"):
            return self._shared(
                lambda: inner.pull_embedding_batch(ids_by_table))
        return self._shared(lambda: {
            name: inner.pull_embedding_vectors(name, ids)
            for name, ids in ids_by_table.items()})

    def push_gradients(self, grads_by_table, **kwargs):
        return self._shared(
            lambda: self._inner.push_gradients(grads_by_table, **kwargs))

    def push_embedding_table_infos(self, infos):
        if self._leader:
            return self._inner.push_embedding_table_infos(infos)
        return None

    def push_embedding_rows(self, rows_by_table, **kwargs):
        if self._leader:
            return self._inner.push_embedding_rows(rows_by_table, **kwargs)
        return None

    def close(self):
        close = getattr(self._inner, "close", None)
        if close is not None:
            close()


class SparseSpmdTrainer(SparseTrainer):
    """Host-PS embedding plane + the dense data plane over a mesh of
    ranks; ``SparseTrainer``'s surface. On a one-rank mesh its step is
    ``SparseTrainer``'s, bit for bit."""

    # the row gradients of the replicated rows buffer are each rank's
    # share: summed over the data ranks
    _SUM_ROWS = True

    def __init__(self, model, loss_fn, optimizer, specs, ps_client,
                 compute_dtype=None, seed=0, mesh=None, mesh_config=None,
                 sharding_rules=None, cache_staleness=0,
                 cache_capacity=1_000_000, async_push=None,
                 device_tier=None, health=None, device="cuda"):
        self.mesh = mesh if mesh is not None else build_mesh(mesh_config)
        if (self.SUPPORTS_DEVICE_TIER and self.mesh.shape["ep"] > 1
                and resolve_tier_config(device_tier) is not None):
            raise ValueError(
                "the device tier over ep=%d would shard its rows over the "
                "ep ranks, which has no launch path in the port yet "
                "(ROADMAP Queue 1 item 2); run the tier at ep=1, where it "
                "is replicated" % self.mesh.shape["ep"])
        self._rules = sharding_rules
        # the dense plane: SpmdTrainer's shardings, gather and plan over
        # this mesh (its own step is not used)
        self._spmd = SpmdTrainer(
            model, loss_fn, optimizer, compute_dtype=compute_dtype,
            seed=seed, mesh=self.mesh, sharding_rules=sharding_rules,
            health=False, device=device)
        self._data = self.mesh.live_axes(DATA_AXES)
        self._plane = _SparsePlane(self._spmd, self._SUM_ROWS,
                                   self._plane_timer())
        self._multi_rank = self.mesh.size(AXES) > 1
        if self._multi_rank and self._SUM_ROWS:
            ps_client = _LeaderPSClient(ps_client, self.mesh.rank == 0,
                                        self._spmd.device)
        super().__init__(
            model, loss_fn, optimizer, specs, ps_client,
            compute_dtype=compute_dtype, seed=seed,
            cache_staleness=cache_staleness, cache_capacity=cache_capacity,
            async_push=async_push, device_tier=device_tier, health=health,
            device=device)
        if self._multi_rank and self._SUM_ROWS and self._async_push:
            raise ValueError(
                "the async push runs its RPC on a thread, and the ranks of "
                "a SparseSpmdTrainer share rank 0's PS answers in step: "
                "train it with the synchronous push")
        logger.info("sparse-SPMD mesh %s (%d-way data parallel), %d tables",
                    dict(self.mesh.shape), data_parallel_size(self.mesh),
                    len(self._specs))

    # hooks of SparseTrainer -------------------------------------------
    def _plane_timer(self):
        return None

    def _step_plane(self):
        return self._plane

    def _eval_plane(self):
        return self._spmd

    def _batch_divisor(self):
        return data_parallel_size(self.mesh)

    def _sized(self, batch):
        """The raw batch zero-padded to a multiple of the data-parallel
        size (the padded rows carry mask 0)."""
        divisor = self._batch_divisor()
        n = int(np.asarray(batch[MASK_KEY]).shape[0])
        target = -(-n // divisor) * divisor
        return batch if target == n else pad_batch(batch, target)

    def _device_batch(self, prepared):
        """This rank's rows of the prepared global batch on the device;
        the pulled rows buffers stay whole (replicated)."""
        dp = data_parallel_size(self.mesh)
        if dp == 1:
            self._spmd.rows = None
            return _to_device(prepared, self.device)
        n = int(np.asarray(prepared[MASK_KEY]).shape[0])
        local = n // dp
        offset = self.mesh.index(self._data) * local
        self._spmd.rows = (offset, n)

        def part(leaf):
            return leaf[offset:offset + local]

        out = {k: _map(part, v) for k, v in prepared.items()
               if k != "features"}
        out["features"] = {
            k: v if k.endswith(ROWS_SUFFIX) else _map(part, v)
            for k, v in prepared["features"].items()}
        return _to_device(out, self.device)

    def create_state(self, sample_features):
        """The model's lazily sized layers sized as ``SparseTrainer``
        sizes them, then this rank's blocks of the state
        (``SpmdTrainer.create_state``)."""
        self._size_lazy_layers(sample_features)
        return self._spmd.create_state()

    def full_params(self, params):
        return self._spmd.full_params(params)

    @property
    def mesh_shape_str(self):
        return self._spmd.mesh_shape_str

    @property
    def collective_bytes_per_step(self):
        return self._spmd.collective_bytes_per_step

    @property
    def state_shardings(self):
        return self._spmd.state_shardings

    def train_stream(self, state, batches, on_first_batch=None,
                     push_interval=1):
        if self._multi_rank:
            raise NotImplementedError(
                "the pipelined stream pulls on a lookahead thread; the "
                "ranks of a SparseSpmdTrainer share rank 0's pulls in "
                "step, so they train with train_step")
        return super().train_stream(state, batches,
                                    on_first_batch=on_first_batch,
                                    push_interval=push_interval)


class MultiHostSparseSpmdTrainer(LockstepMixin, SparseSpmdTrainer):
    """N worker processes share one dense model in lockstep (the dense
    gradients all-reduced over dp), each with its own host-PS rows.
    See the module docstring for the layout.

    A sync-PS rejection here can only mean the version TAG went stale
    (a relaunched worker whose round counter restarted before its
    checkpoint), because every round pulls fresh rows. The retry
    therefore RESENDS the same gradients with the corrected version
    (RETRY_RECOMPUTES=False): a recompute would be a collective that one
    rejected process must not run alone."""

    MAX_PUSH_RETRIES = 8
    FORCE_EMPTY_PUSH = True
    RETRY_RECOMPUTES = False
    # each worker's rows are its own shard of the round, and the tier's
    # applies on the card would sit outside the sync PS's round
    # accounting: EDL_DEVICE_TIER is ignored here with a warning
    SUPPORTS_DEVICE_TIER = False
    # lockstep version tags are exact global round counters: the sync PS
    # pairs pushes by tag, so a worker whose pushes lag its rounds never
    # has its round-r and round-r+1 pushes paired with each other
    ROUND_SCOPED_PUSH = True
    _SUM_ROWS = False

    def __init__(self, model, loss_fn, optimizer, specs, ps_client,
                 compute_dtype=None, seed=0, mesh=None, mesh_config=None,
                 sharding_rules=None, cache_staleness=0,
                 cache_capacity=1_000_000, async_push=None,
                 device_tier=None, health=None, device="cuda"):
        super().__init__(
            model, loss_fn, optimizer, specs, ps_client,
            compute_dtype=compute_dtype, seed=seed, mesh=mesh,
            mesh_config=mesh_config, sharding_rules=sharding_rules,
            cache_staleness=cache_staleness, cache_capacity=cache_capacity,
            async_push=async_push, device_tier=device_tier, health=health,
            device=device)
        self._init_lockstep()
        if self.mesh.shape["dp"] != self.process_count:
            raise ValueError(
                "sparse lockstep layout contract: dp (%d) must equal the "
                "process count (%d): each worker owns one dp slot, and a "
                "process drives one card, so fsdp, tp and ep stay 1"
                % (self.mesh.shape["dp"], self.process_count))
        self._round = 0

    def _plane_timer(self):
        return self._time_allreduce

    def _eval_plane(self):
        # evaluation tasks are per worker: the replicated dense state
        # scores this worker's batch, no collective
        return None

    def _batch_divisor(self):
        # this process's batch is its dp slot: no split
        return 1

    def _device_batch(self, prepared):
        n = int(np.asarray(prepared[MASK_KEY]).shape[0])
        self._spmd.rows = (self.process_index * n, self.process_count * n)
        return _to_device(prepared, self.device)

    def train_step(self, state, batch):
        # push version = completed global rounds (module docstring): a
        # round-k push arrives at sync-PS store version k; max() keeps
        # the async PS's response tracking (its responses run ahead of
        # the rounds). state.step recovers the round count after a
        # relaunch, from the restored checkpoint.
        if state is not None:
            self._round = max(self._round, int(state.step))
        self._version = max(self._version, self._round)
        state, loss = super().train_step(state, batch)
        # a successful retry learned the true store version: the next
        # push is tagged right the first time
        self._round = max(self._round + 1, self._version)
        return state, loss


def sparse_trainer_for(dense_factory):
    """The sparse composition of the worker's dense trainer choice:
    SpmdTrainer -> SparseSpmdTrainer, MultiHostSpmdTrainer ->
    MultiHostSparseSpmdTrainer, TorchTrainer (or none) ->
    SparseTrainer; a factory that takes ``specs`` already is one."""
    if dense_factory is None:
        return SparseTrainer
    import inspect

    try:
        factory_params = inspect.signature(dense_factory).parameters
    except (TypeError, ValueError):
        factory_params = ()
    if "specs" in factory_params:
        return dense_factory  # already sparse-capable
    from elasticdl_tpu_torch.parallel.multihost_trainer import (
        MultiHostSpmdTrainer,
    )
    from elasticdl_tpu_torch.worker.trainer import TorchTrainer

    if isinstance(dense_factory, type):
        if issubclass(dense_factory, MultiHostSpmdTrainer):
            return MultiHostSparseSpmdTrainer
        if issubclass(dense_factory, SpmdTrainer):
            return SparseSpmdTrainer
        if issubclass(dense_factory, TorchTrainer):
            return SparseTrainer
    raise ValueError(
        "trainer factory %r cannot drive the host-PS sparse path and has "
        "no sparse composition; use SparseTrainer, SpmdTrainer or "
        "MultiHostSpmdTrainer (or a factory taking specs=)"
        % (dense_factory,))

"""Multi-rank scenarios of the port's mesh on the CPU.

``run_ranks(world, scenario, tmp_path, **kwargs)`` starts ``world``
processes that join one gloo process group (rendezvous through a
``FileStore`` under ``tmp_path``, so test files that run side by side
never share a port), each runs ``scenario(rank, world, **kwargs)`` (a
function of this module, or ``"module:function"`` of another) with one
intra-op thread, and the list of
their pickled results comes back. Every wait has a deadline that fails
the test instead of hanging. This module imports no jax: the ranks run
the port alone, and the tests hold their results against the reference
run in the pytest process.
"""

import datetime
import os
import pickle
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def run_ranks(world, scenario, tmp_path, timeout=120, **kwargs):
    """Run ``scenario`` in ``world`` gloo ranks; returns their results
    (rank order). Raises AssertionError, with each rank's log tail, when
    a rank fails or the deadline passes (every rank is then killed)."""
    work = os.path.join(str(tmp_path),
                        "ranks_%s" % scenario.replace(":", "_"))
    os.makedirs(work, exist_ok=True)
    with open(os.path.join(work, "spec.pkl"), "wb") as f:
        pickle.dump((scenario, kwargs), f)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    procs, logs = [], []
    for rank in range(world):
        log = open(os.path.join(work, "rank%d.log" % rank), "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), work, str(rank),
             str(world)],
            cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + timeout
    try:
        for proc in procs:
            left = deadline - time.monotonic()
            try:
                proc.wait(timeout=max(left, 0.1))
            except subprocess.TimeoutExpired:
                break
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for log in logs:
            log.close()
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    if failed:
        tails = []
        for r in failed:
            with open(os.path.join(work, "rank%d.log" % r)) as f:
                tails.append("rank %d (exit %s):\n%s" % (
                    r, procs[r].returncode, f.read()[-3000:]))
        raise AssertionError("scenario %s failed in %d s:\n%s" % (
            scenario, timeout, "\n".join(tails)))
    results = []
    for rank in range(world):
        with open(os.path.join(work, "result%d.pkl" % rank), "rb") as f:
            results.append(pickle.load(f))
    return results


def _main(work, rank, world):
    sys.path.insert(0, REPO)
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(work, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    with open(os.path.join(work, "spec.pkl"), "rb") as f:
        scenario, kwargs = pickle.load(f)
    if ":" in scenario:
        # "module:function": a scenario kept in another test module
        import importlib

        module, name = scenario.split(":")
        fn = getattr(importlib.import_module(module), name)
    else:
        fn = globals()[scenario]
    result = fn(rank, world, **kwargs)
    with open(os.path.join(work, "result%d.pkl" % rank), "wb") as f:
        pickle.dump(result, f)
    dist.barrier()
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# scenarios: (rank, world, **kwargs) -> a picklable result
# ---------------------------------------------------------------------------


def _np(t):
    return t.detach().float().cpu().numpy()


def mesh_scenario(rank, world):
    """tests/test_torch_mesh.py: the mesh over 8 ranks."""
    import torch
    import torch.distributed as dist

    from elasticdl_tpu_torch.parallel.mesh import (
        DATA_AXES,
        MeshConfig,
        batch_sharding,
        build_mesh,
        data_parallel_size,
        parse_mesh_spec,
        replicated,
    )

    out = {}
    mesh = build_mesh(parse_mesh_spec("fsdp=4"))
    out["shape"] = dict(mesh.shape)
    out["coords"] = dict(mesh.coords)
    out["data_parallel_size"] = data_parallel_size(mesh)
    out["group_sizes"] = {
        axes: dist.get_world_size(mesh.group(axes))
        for axes in ("dp", "fsdp", DATA_AXES)}
    x = torch.arange(48.0).reshape(16, 3)
    block = batch_sharding(mesh).shard(x)
    out["block"] = _np(block)
    out["gathered"] = _np(batch_sharding(mesh).gather(block))
    out["replicated"] = _np(replicated(mesh).shard(x))
    # a second mesh over the same group, three live axes
    mesh = build_mesh(MeshConfig(dp=2, tp=2, ep=2))
    out["shape2"] = dict(mesh.shape)
    out["coords2"] = dict(mesh.coords)
    for axes in (("tp", "ep"), ("dp", "ep"), ("dp", "tp", "ep")):
        t = torch.tensor([float(rank)])
        dist.all_reduce(t, group=mesh.group(axes))
        out["sum_%s" % "_".join(axes)] = float(t)
    try:
        build_mesh(MeshConfig(fsdp=3))
    except ValueError as e:
        out["not_divisible"] = str(e)
    try:
        build_mesh(MeshConfig(dp=2), num_devices=4)
    except ValueError as e:
        out["num_devices"] = str(e)
    return out


def collectives_scenario(rank, world):
    """tests/test_torch_collectives.py: the helpers over 4 ranks."""
    import torch

    from elasticdl_tpu_torch.parallel.collectives import (
        mesh_all_gather,
        mesh_gather_replicated,
        mesh_pmean,
        mesh_psum,
        mesh_reduce_scatter,
        mesh_replicate,
        track_collective_bytes,
    )
    from elasticdl_tpu_torch.parallel.mesh import MeshConfig, build_mesh

    out = {}
    # mesh_psum's value and its gradient taken through it: w varies over
    # tp (shard r holds r + 1), the loss reduces the partial products
    mesh = build_mesh(MeshConfig(dp=1, tp=4))
    w = torch.tensor([float(rank + 1)], requires_grad=True)
    x = torch.ones(())
    with mesh:
        loss = torch.sum(mesh_psum(w * x, "tp") ** 2)
    (grad,) = torch.autograd.grad(loss, w)
    out["psum_value"], out["psum_grad"] = float(loss), _np(grad)
    # the data-parallel helpers over dp=4
    mesh = build_mesh(MeshConfig(dp=4))
    full = torch.arange(8, dtype=torch.float32).reshape(4, 2)
    out["pmean"] = _np(mesh_pmean(full[rank:rank + 1], "dp", mesh=mesh))
    v = (rank + 1) * torch.arange(8, dtype=torch.float32)
    scattered = mesh_reduce_scatter(v, "dp", mesh=mesh)
    out["scattered"] = _np(scattered)
    out["gathered"] = _np(mesh_all_gather(scattered, "dp", mesh=mesh))
    # another dim than 0
    m = (rank + 1) * torch.arange(24, dtype=torch.float32).reshape(3, 8)
    out["scattered_dim1"] = _np(mesh_reduce_scatter(
        m, "dp", scatter_dimension=1, mesh=mesh))
    # their gradients: the transposes of each other
    leaf = scattered.detach().requires_grad_()
    gathered = mesh_all_gather(leaf, "dp", mesh=mesh)
    (g,) = torch.autograd.grad((gathered * (rank + 1)).sum(), leaf)
    out["all_gather_grad"] = _np(g)
    leaf = v.detach().requires_grad_()
    (g,) = torch.autograd.grad(
        (mesh_reduce_scatter(leaf, "dp", mesh=mesh) * (rank + 1)).sum(),
        leaf)
    out["reduce_scatter_grad"] = _np(g)
    # the tensor-parallel pair: replicate (gradients all-reduced) and
    # gather_replicated (each rank's own block of the gradient)
    leaf = torch.ones(3, requires_grad=True)
    (g,) = torch.autograd.grad(
        (mesh_replicate(leaf, "dp", mesh=mesh) * (rank + 1)).sum(), leaf)
    out["replicate_grad"] = _np(g)
    leaf = torch.full((2,), float(rank), requires_grad=True)
    gathered = mesh_gather_replicated(leaf, "dp", dim=0, mesh=mesh)
    coef = torch.arange(8, dtype=torch.float32)
    (g,) = torch.autograd.grad((gathered * coef).sum(), leaf)
    out["gather_replicated"] = _np(gathered)
    out["gather_replicated_grad"] = _np(g)
    # ring-cost accounting: 32 floats a rank (128 payload bytes)
    payload = torch.zeros(32)
    with track_collective_bytes() as acc:
        mesh_psum(payload, "dp", mesh=mesh)
        mesh_reduce_scatter(payload, "dp", mesh=mesh)
        mesh_all_gather(payload, "dp", mesh=mesh)
    out["bytes"] = (acc.all_reduce, acc.reduce_scatter, acc.all_gather,
                    acc.total, acc.calls, dict(acc.by_kind))
    # nested accumulators and a size-1 axis: no traffic, no call
    with track_collective_bytes() as outer:
        with track_collective_bytes() as inner:
            same = mesh_psum(torch.ones(4), "tp", mesh=mesh)
        mesh_psum(torch.ones(4), ("dp", "tp"), mesh=mesh)
    out["size1"] = (inner.total, inner.calls, _np(same))
    out["outer"] = (outer.total, outer.calls)
    # outside any mesh every axis has size 1
    out["no_mesh"] = _np(mesh_psum(torch.full((2,), 3.0), "dp"))
    return out


def _mnist(flat):
    """The port's mnist CNN with the reference's weights ``flat``."""
    from elasticdl_tpu_torch.models import mnist

    model = mnist.custom_model()
    model.load_state_dict(mnist.params_from_flax(flat), strict=True)
    return model


def _mnist_batches(seed, steps, n=16, size=28):
    import numpy as np

    rng = np.random.RandomState(seed)
    return [{
        "features": rng.rand(n, size, size).astype(np.float32),
        "labels": rng.randint(0, 10, size=n).astype(np.int32),
        "_mask": np.ones((n,), np.float32),
    } for _ in range(steps)]


def _state_arrays(state):
    """Every tensor of a state as numpy: params, and the optimizer's
    slots and counters by flat name."""
    out = {"params/" + k: _np(v) for k, v in state.params.items()}

    def walk(tree, prefix):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, "%s/%s" % (prefix, k))
        else:
            out[prefix] = _np(tree)

    walk(state.opt_state, "opt")
    return out


def mesh1_scenario(rank, world, flat):
    """tests/test_torch_dense_plane.py: SpmdTrainer on a one-rank mesh
    against TorchTrainer, 3 mnist steps from the same weights."""
    from elasticdl_tpu_torch.models import mnist
    from elasticdl_tpu_torch.parallel.mesh import MeshConfig, build_mesh
    from elasticdl_tpu_torch.parallel.spmd_trainer import SpmdTrainer
    from elasticdl_tpu_torch.worker.trainer import TorchTrainer

    mesh = build_mesh(MeshConfig(dp=1))
    common = dict(loss_fn=mnist.loss, health=False, device="cpu", seed=7)
    spmd = SpmdTrainer(model=_mnist(flat), optimizer=mnist.optimizer(),
                       mesh=mesh, **common)
    single = TorchTrainer(model=_mnist(flat), optimizer=mnist.optimizer(),
                          **common)
    s_state = d_state = None
    losses = []
    for batch in _mnist_batches(3, 3):
        s_state, s_loss = single.train_step(s_state, dict(batch))
        d_state, d_loss = spmd.train_step(d_state, dict(batch))
        losses.append((float(s_loss), float(d_loss)))
    return {"losses": losses, "single": _state_arrays(s_state),
            "spmd": _state_arrays(d_state),
            "summary": spmd.dense_plan.summary(),
            "mesh_shape": spmd.mesh_shape_str,
            "bytes": spmd.collective_bytes_per_step}


def fsdp2_scenario(rank, world, flat):
    """tests/test_torch_dense_plane.py: the dense plan of mnist on an
    fsdp=2 mesh, a step through it, and two bf16-compute steps beside
    TorchTrainer's."""
    import torch

    from elasticdl_tpu_torch.models import mnist
    from elasticdl_tpu_torch.parallel.mesh import MeshConfig, build_mesh
    from elasticdl_tpu_torch.parallel.spmd_trainer import SpmdTrainer
    from elasticdl_tpu_torch.worker.trainer import TorchTrainer

    mesh = build_mesh(MeshConfig(dp=1, fsdp=2))
    trainer = SpmdTrainer(model=_mnist(flat), loss_fn=mnist.loss,
                          optimizer=mnist.optimizer(), mesh=mesh, seed=0,
                          health=False, device="cpu")
    state, loss = trainer.train_step(None, _mnist_batches(0, 1)[0])
    out = {"loss": float(loss),
           "modes": {p.path: p.mode for p in trainer.dense_plan.params},
           "bytes": trainer.collective_bytes_per_step,
           "mesh_shape": trainer.mesh_shape_str}

    # bf16 compute: the forward casts the gathered weights, not the blocks
    common = dict(loss_fn=mnist.loss, compute_dtype=torch.bfloat16, seed=0,
                  health=False, device="cpu")
    bf16 = SpmdTrainer(model=_mnist(flat), optimizer=mnist.optimizer(),
                       mesh=mesh, **common)
    single = TorchTrainer(model=_mnist(flat), optimizer=mnist.optimizer(),
                          **common)
    s_state = d_state = None
    losses = []
    for batch in _mnist_batches(5, 2):
        s_state, s_loss = single.train_step(s_state, dict(batch))
        d_state, d_loss = bf16.train_step(d_state, dict(batch))
        losses.append((float(s_loss), float(d_loss)))
    out["bf16_losses"] = losses
    out["bf16_sharded"] = sorted(
        name for name, p in d_state.params.items()
        if tuple(p.shape) != tuple(s_state.params[name].shape))
    full = bf16.full_params(d_state.params)
    out["bf16_params"] = {k: (_np(s_state.params[k]), _np(full[k]))
                          for k in s_state.params}
    return out


def _big_mlp():
    """Three Dense layers (256 -> 2048 -> 2048 -> 16): the reference's
    sharded-init test model."""
    import torch
    import torch.nn.functional as F

    from elasticdl_tpu_torch.models.layers import Dense

    class BigMLP(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.Dense_0 = Dense(256, 2048)
            self.Dense_1 = Dense(2048, 2048)
            self.Dense_2 = Dense(2048, 16)

        def forward(self, x):
            x = F.relu(self.Dense_0(x))
            return self.Dense_2(F.relu(self.Dense_1(x)))

    torch.manual_seed(0)
    return BigMLP()


def spmd_scenario(rank, world, flat, batch):
    """tests/test_torch_spmd_trainer.py over 8 ranks: dp8 and dp4*fsdp2
    mnist steps (dropout at rate 0 and as mnist trains), the batch
    check, the fsdp blocks, and the sharded init of a big MLP at
    fsdp=8."""
    import numpy as np
    import torch

    from elasticdl_tpu_torch.models import mnist
    from elasticdl_tpu_torch.parallel.mesh import MeshConfig, build_mesh
    from elasticdl_tpu_torch.parallel.spmd_trainer import SpmdTrainer
    from elasticdl_tpu_torch.train.losses import sparse_softmax_cross_entropy
    from elasticdl_tpu_torch.train.optimizers import create_optimizer

    out = {}

    def trainer(config, model=None, **kw):
        return SpmdTrainer(model=model or _mnist(flat), loss_fn=mnist.loss,
                           optimizer=kw.pop("optimizer", mnist.optimizer()),
                           mesh=build_mesh(config), seed=0, health=False,
                           device="cpu", **kw)

    # dp=8: each rank trains on its 4 rows of the 32; "plain" with the
    # dropout at rate 0 (held against the reference), "dropout" as mnist
    # trains (held against TorchTrainer: the masks are the port's own)
    def run(config, dropout):
        model = _mnist(flat)
        if not dropout:
            model.dropout.rate = 0.0
        spmd = trainer(config, model=model)
        state = spmd.create_state(batch["features"])
        losses = []
        for _ in range(3):
            state, loss = spmd.train_step(state, dict(batch))
            losses.append(float(loss))
        params = spmd.full_params(state.params)
        return losses, {k: _np(v) for k, v in params.items()}

    for kind in ("plain", "dropout"):
        for arm, config in (("dp8", MeshConfig(dp=8)),
                            ("zero", MeshConfig(dp=4, fsdp=2))):
            losses, params = run(config, kind == "dropout")
            out["%s_%s_losses" % (arm, kind)] = losses
            out["%s_%s_params" % (arm, kind)] = params
    dp8 = trainer(MeshConfig(dp=8))
    state = dp8.create_state(batch["features"])
    bad = {k: v[:30] for k, v in batch.items()}
    try:
        dp8.train_step(state, bad)
    except ValueError as e:
        out["not_divisible"] = str(e)

    # dp=4 x fsdp=2: the big kernels and their Adam slots are blocks
    zero = trainer(MeshConfig(dp=4, fsdp=2))
    state = zero.create_state(batch["features"])
    full = _mnist(flat).state_dict()
    out["fsdp_leaves"] = {
        name: (tuple(p.shape), tuple(full[name].shape),
               tuple(state.opt_state["mu"][name].shape),
               tuple(state.opt_state["nu"][name].shape),
               str(zero.state_shardings.opt_state["mu"][name].spec))
        for name, p in state.params.items()
        if "fsdp" in zero.state_shardings.params[name].spec.axes()}
    # the health norm of the blocks is the whole tensors' norm
    out["norm_blocks"] = float(zero.grad_norm(state.params))
    out["norm_full"] = float(torch.sqrt(sum(
        torch.sum(torch.square(t.float())) for t in full.values())))

    # fsdp=8: no rank ever holds a big leaf whole
    big = SpmdTrainer(
        model=_big_mlp(), loss_fn=sparse_softmax_cross_entropy,
        optimizer=create_optimizer("Adam", learning_rate=1e-3),
        mesh=build_mesh(MeshConfig(dp=1, fsdp=8)), seed=0, health=False,
        device="cpu")
    rng = np.random.RandomState(0)
    mlp_batch = {"features": rng.rand(16, 256).astype(np.float32),
                 "labels": rng.randint(0, 16, size=16).astype(np.int32),
                 "_mask": np.ones(16, np.float32)}
    state = big.create_state(mlp_batch["features"])
    mine = sum(t.numel() * t.element_size()
               for t in _tensors((state.params, state.opt_state)))
    total = sum(p.numel() * 4 * 3 for p in big.model.parameters())
    out["mlp_bytes"] = (mine, total)
    out["mlp_kernel"] = (state.params["Dense_1.weight"].numel(),
                         big.model.Dense_1.weight.numel())
    losses = []
    for _ in range(5):
        state, loss = big.train_step(state, mlp_batch)
        losses.append(float(loss))
    out["mlp_losses"] = losses
    return out


def _tensors(tree):
    import torch

    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


SMALL_MOE = dict(vocab_size=128, num_layers=2, num_heads=4, embed_dim=32,
                 num_experts=4, top_k=2, capacity_factor=2.0)


def moe_mesh_scenario(rank, world, flat, batch, compact_batch):
    """tests/test_torch_moe_mesh.py over 8 ranks: the small MoE LM at
    dp2*tp2*ep2 (one-hot dispatch) and at dp8 (compact dispatch), 3 Adam
    steps each from the reference's weights."""
    from elasticdl_tpu_torch.models import moe_transformer as moe
    from elasticdl_tpu_torch.parallel.collectives import (
        track_collective_bytes,
    )
    from elasticdl_tpu_torch.parallel.mesh import MeshConfig, build_mesh
    from elasticdl_tpu_torch.parallel.spmd_trainer import SpmdTrainer
    from elasticdl_tpu_torch.train.optimizers import create_optimizer

    out = {}
    for arm, config, dispatch, data in (
            ("ep", MeshConfig(dp=2, tp=2, ep=2), "auto", batch),
            ("compact", MeshConfig(dp=8), "compact", compact_batch)):
        mesh = build_mesh(config)
        model = moe.MoeTransformerLM(**SMALL_MOE, dispatch_impl=dispatch,
                                     mesh=mesh)
        model.load_state_dict(moe.params_from_flax(flat), strict=True)
        trainer = SpmdTrainer(
            model=model, loss_fn=moe.loss,
            optimizer=create_optimizer("Adam", learning_rate=0.01),
            mesh=mesh, seed=0, sharding_rules=moe.sharding_rules(),
            batch_spec=moe.batch_spec(), health=False, device="cpu")
        state = trainer.create_state(data["features"])
        losses = []
        with track_collective_bytes() as acc:
            for _ in range(3):
                state, loss = trainer.train_step(state, dict(data))
                losses.append(float(loss))
        out[arm] = {
            "losses": losses,
            "shapes": {k: tuple(v.shape) for k, v in state.params.items()},
            "summary": trainer.dense_plan.summary(),
            "moved": acc.total,
        }
    return out


def cifar10_bn_scenario(rank, world, flat, batch, steps, lr):
    """tests/test_torch_batch_norm_mesh.py: cifar10 (flax-style
    BatchNorm in fp32) at dp=``world`` over gloo ranks, dropout at rate
    0, ``steps`` SGD steps at ``lr`` on the same global batch from the
    reference's weights: the losses, the full parameters and the running
    averages of every rank."""
    from elasticdl_tpu_torch.models import cifar10
    from elasticdl_tpu_torch.parallel.mesh import MeshConfig, build_mesh
    from elasticdl_tpu_torch.parallel.spmd_trainer import SpmdTrainer
    from elasticdl_tpu_torch.train.optimizers import create_optimizer

    model = cifar10.custom_model()
    model.load_state_dict(cifar10.params_from_flax(flat), strict=False)
    model.conv_dropout.rate = model.dense_dropout.rate = 0.0
    trainer = SpmdTrainer(model=model, loss_fn=cifar10.loss,
                          optimizer=create_optimizer("SGD", learning_rate=lr),
                          mesh=build_mesh(MeshConfig(dp=world)), seed=0,
                          health=False, device="cpu")
    state, losses = None, []
    for _ in range(steps):
        state, loss = trainer.train_step(state, dict(batch))
        losses.append(float(loss))
    return {"losses": losses,
            "params": {k: _np(v) for k, v in
                       trainer.full_params(state.params).items()},
            "batch_stats": {k: _np(v) for k, v in
                            state.model_state["batch_stats"].items()}}



# ---------------------------------------------------------------------------
# the sparse SPMD and lockstep trainers (tests/test_torch_sparse_spmd.py,
# tests/test_torch_lockstep.py)
# ---------------------------------------------------------------------------

# adam's eps on the dense params and the PS in the multi-step parity
# runs (tests/test_torch_sparse.py ADAM_EPS)
SPARSE_ADAM_EPS = 1e-3


def numpy_ps_client(seed=0):
    """The port's in-process client over a numpy store (adam lr 0.01)."""
    from elasticdl_tpu_torch.ps.embedding_store import NumpyEmbeddingStore
    from elasticdl_tpu_torch.ps.local_client import LocalPSClient

    store = NumpyEmbeddingStore(seed=seed)
    store.set_optimizer("adam", lr=0.01, epsilon=SPARSE_ADAM_EPS)
    return LocalPSClient(store=store)


def constant_specs(specs):
    """Every table's rows start at 0.01: rows created in another order
    (two processes pulling apart) start equal."""
    for spec in specs:
        spec.initializer, spec.init_scale = "constant", 0.01
    return specs


def deepfm_trainer(cls, flat, ps_client, fields, batch, **kwargs):
    """DeepFM through ``cls`` (a sparse trainer class) on the CPU from
    the reference's weights ``flat`` (None: the trainer's seed), adam
    lr 0.001 at SPARSE_ADAM_EPS, constant-initialised tables."""
    from elasticdl_tpu_torch.models import deepfm
    from elasticdl_tpu_torch.train.optimizers import create_optimizer

    model = deepfm.custom_model()
    if flat is not None:
        model.load_state_dict(deepfm.params_from_flax(flat))
    return cls(model=model, loss_fn=deepfm.loss,
               optimizer=create_optimizer("Adam", learning_rate=0.001,
                                          epsilon=SPARSE_ADAM_EPS),
               specs=constant_specs(deepfm.sparse_embedding_specs(
                   num_features=fields, batch_size=batch)),
               ps_client=ps_client, seed=0, health=False, device="cpu",
               **kwargs)


def _store_tables(client, tables=("deepfm_emb", "deepfm_linear")):
    """Each table's (ids, rows and slots, steps), sorted by id."""
    import numpy as np

    out = {}
    for table in tables:
        ids, rows, steps = client.store.export_table_full(table)
        order = np.argsort(ids, kind="stable")
        out[table] = (ids[order], rows[order], steps[order])
    return out


def sparse_spmd_scenario(rank, world, flat, batches, fields, batch):
    """tests/test_torch_sparse_spmd.py: SparseSpmdTrainer at dp=world
    over ``batches`` (the first one ragged) from the reference's
    weights: every rank's losses and full dense params, and rank 0's
    PS tables (the ranks share its pulls and pushes); then the tier at
    ep=2 refused."""
    from elasticdl_tpu_torch.parallel.mesh import MeshConfig, build_mesh
    from elasticdl_tpu_torch.train.device_tier import DeviceTierConfig
    from elasticdl_tpu_torch.train.sparse_spmd import SparseSpmdTrainer

    client = numpy_ps_client()
    trainer = deepfm_trainer(SparseSpmdTrainer, flat, client, fields, batch,
                             mesh=build_mesh(MeshConfig(dp=world)),
                             device_tier=False)
    state, losses = None, []
    for b in batches:
        state, loss = trainer.train_step(state, b)
        losses.append(float(loss))
    out = {"losses": losses,
           "params": {k: _np(v) for k, v in
                      trainer.full_params(state.params).items()},
           "tables": _store_tables(client) if rank == 0 else None,
           # rank 0 alone talks to the PS: no table on another's store
           "pulls": (len(client.store.export_table_full("deepfm_emb")[0])
                     if rank == 0 else len(client.store.table_names()))}
    if world % 2 == 0:
        try:
            deepfm_trainer(SparseSpmdTrainer, flat, numpy_ps_client(),
                           fields, batch,
                           mesh=build_mesh(MeshConfig(dp=world // 2, ep=2)),
                           device_tier=DeviceTierConfig(capacity=64))
        except ValueError as e:
            out["ep_error"] = str(e)
    return out


def sparse_one_rank_scenario(rank, world, batches, fields, batch,
                             tier_knobs):
    """tests/test_torch_sparse_spmd.py: SparseSpmdTrainer on a one-rank
    mesh beside SparseTrainer, the tier on, over the same batches."""
    import numpy as np
    import torch

    from elasticdl_tpu_torch.parallel.mesh import MeshConfig, build_mesh
    from elasticdl_tpu_torch.train.device_tier import DeviceTierConfig
    from elasticdl_tpu_torch.train.sparse import SparseTrainer
    from elasticdl_tpu_torch.train.sparse_spmd import SparseSpmdTrainer

    runs = {}
    for name, cls, extra in (
            ("single", SparseTrainer, {}),
            ("spmd", SparseSpmdTrainer,
             {"mesh": build_mesh(MeshConfig(dp=1))})):
        client = numpy_ps_client()
        trainer = deepfm_trainer(cls, None, client, fields, batch,
                                 device_tier=DeviceTierConfig(**tier_knobs),
                                 **extra)
        state, losses = None, []
        for b in batches:
            state, loss = trainer.train_step(state, b)
            losses.append(float(loss))
        runs[name] = {
            "losses": losses,
            "params": {k: v.detach().clone() for k, v in
                       state.params.items()},
            "tier": {t: trainer.device_tier.table_rows(t)
                     for t in ("deepfm_emb", "deepfm_linear")},
            "stats": trainer.device_tier.stats(),
            "tables": _store_tables(client)}
        trainer.close()
    single, spmd = runs["single"], runs["spmd"]
    return {
        "losses": spmd["losses"],
        "losses_equal": single["losses"] == spmd["losses"],
        "params_equal": all(torch.equal(single["params"][k],
                                        spmd["params"][k])
                            for k in single["params"]),
        "tier_equal": single["stats"] == spmd["stats"] and all(
            np.array_equal(a, b) for t in single["tier"]
            for a, b in zip(single["tier"][t], spmd["tier"][t])),
        "tables_equal": all(
            np.array_equal(a, b) for t in single["tables"]
            for a, b in zip(single["tables"][t], spmd["tables"][t])),
        "hits": spmd["stats"]["hits"]}


def lockstep_sparse_scenario(rank, world, flat, local_batches, ps_addrs,
                             fields, batch):
    """tests/test_torch_lockstep.py: MultiHostSparseSpmdTrainer, one dp
    slot a rank, each rank its own batches and its own client of the
    shared sync PS (grads_to_wait = world): the global losses, the dense
    params (equal on every rank) and the class options it pushes with."""
    from elasticdl_tpu_torch.parallel.mesh import MeshConfig, build_mesh
    from elasticdl_tpu_torch.train.sparse_spmd import (
        MultiHostSparseSpmdTrainer,
    )
    from elasticdl_tpu_torch.worker.ps_client import PSClient

    client = PSClient(ps_addrs, worker_id=rank)
    trainer = deepfm_trainer(MultiHostSparseSpmdTrainer, flat, client,
                             fields, batch,
                             mesh=build_mesh(MeshConfig(dp=world)),
                             device_tier=False)
    state, losses = None, []
    for b in local_batches[rank]:
        state, loss = trainer.train_step(state, b)
        losses.append(float(loss))
    out = {"losses": losses,
           "params": {k: _np(v) for k, v in state.params.items()},
           "rejections": trainer.push_rejections,
           "version": trainer._version, "step": int(state.step),
           "stats": dict(trainer.lockstep_stats)}
    trainer.close()
    return out


def _mnist_lockstep(flat, config, seed=0):
    from elasticdl_tpu_torch.models import mnist
    from elasticdl_tpu_torch.parallel.mesh import build_mesh
    from elasticdl_tpu_torch.parallel.multihost_trainer import (
        MultiHostSpmdTrainer,
    )

    model = _mnist(flat)
    model.dropout.rate = 0.0
    return MultiHostSpmdTrainer(model=model, loss_fn=mnist.loss,
                                optimizer=mnist.optimizer(),
                                mesh=build_mesh(config), seed=seed,
                                health=False, device="cpu")


def lockstep_dense_scenario(rank, world, flat, local_batches):
    """tests/test_torch_lockstep.py: MultiHostSpmdTrainer on mnist at
    dp=world (dropout at rate 0), each rank its own batch: the global
    losses and this rank's params."""
    from elasticdl_tpu_torch.parallel.mesh import MeshConfig

    trainer = _mnist_lockstep(flat, MeshConfig(dp=world))
    state, losses = None, []
    for b in local_batches[rank]:
        state, loss = trainer.train_step(state, dict(b))
        losses.append(float(loss))
    features = local_batches[rank][0]["features"]
    return {"losses": losses,
            "params": {k: _np(v) for k, v in state.params.items()},
            "eval": trainer.eval_step(state, {"features": features})}


def lockstep_checkpoint_scenario(rank, world, flat, batch, ckpt_dir, mode,
                                 mesh_spec):
    """tests/test_torch_lockstep.py: ``mode`` "save": 2 steps at
    ``mesh_spec`` then the whole state gathered (every rank) and written
    (rank 0); "restore": a fresh state at ``mesh_spec`` loaded from the
    newest checkpoint and adopted onto this mesh. Returns the whole
    params and optimizer slots either way, and this rank's block
    shapes."""
    from elasticdl_tpu_torch.parallel.mesh import parse_mesh_spec
    from elasticdl_tpu_torch.train.checkpoint import DenseCheckpointManager

    trainer = _mnist_lockstep(flat, parse_mesh_spec(mesh_spec))
    state = trainer.create_state(batch["features"])
    if mode == "save":
        for _ in range(2):
            state, _ = trainer.train_step(state, dict(batch))
        whole = trainer.checkpoint_state(state)
        if trainer.checkpoint_writer:
            DenseCheckpointManager(ckpt_dir).save(int(state.step), whole)
    else:
        template = trainer.checkpoint_state(state)
        restored = DenseCheckpointManager(
            ckpt_dir, create=False).restore(template=template)
        state = trainer.adopt_restored(restored)
        whole = trainer.checkpoint_state(state)
        # the restored blocks train on
        state, loss = trainer.train_step(state, dict(batch))
        whole_loss = float(loss)
    return {"step": int(whole.step),
            "params": {k: _np(v) for k, v in whole.params.items()},
            "mu": {k: _np(v) for k, v in whole.opt_state["mu"].items()},
            "blocks": {k: tuple(v.shape) for k, v in state.params.items()},
            "loss_after": None if mode == "save" else whole_loss}


def lockstep_loop_scenario(rank, world, flat, local_batches, interval,
                           minibatch):
    """tests/test_torch_lockstep.py: the worker's lockstep loop
    (``Worker._train_batches_lockstep`` on a worker stub) over each
    rank's own batches, rank 1's stream drying up first: the rounds
    each rank stepped, its real batches and its params."""
    import contextlib
    import types

    from elasticdl_tpu_torch.parallel.mesh import MeshConfig
    from elasticdl_tpu_torch.worker.worker import Worker

    trainer = _mnist_lockstep(flat, MeshConfig(dp=world))
    worker = Worker.__new__(Worker)
    real, rounds = [], []
    handed_back = []
    worker.__dict__.update(
        trainer=trainer, stop_training=False, _restore_attempted=True,
        _lockstep_poll_secs=0.05, _minibatch_size=minibatch,
        _consensus_interval=interval, state=None,
        tds=types.SimpleNamespace(out_of_band_tasks=[],
                                  train_end_task=None,
                                  report_pending_failed=handed_back.append),
        _step_trace=contextlib.nullcontext)

    def step(batch):
        worker.state, loss = trainer.train_step(worker.state, batch)
        rounds.append(float(batch["_mask"].sum()))
        return loss

    worker._timed_train_step = step
    worker._note_lockstep_round = lambda: None
    worker._after_train_batch = lambda batch, loss: real.append(
        float(batch["_mask"].sum()))
    worker._train_batches_lockstep(iter(local_batches[rank]))
    return {"rounds": rounds, "real": real,
            "params": {k: _np(v) for k, v in worker.state.params.items()},
            "consensus_calls": trainer.lockstep_stats["consensus_calls"]}



def sparse_worker_mesh_scenario(rank, world, workdir):
    """tests/test_torch_sparse_spmd.py: a DeepFM job (the port's master
    and two PS servicers in this process, phase 9's kind of data at a
    small size) drained by a Worker given a one-rank mesh: the trainer
    it built, the job's end and the last evaluation's AUC."""
    import threading

    import numpy as np

    import chip_smoke
    from elasticdl_tpu_torch.common.grpc_utils import (
        build_server,
        find_free_port,
    )
    from elasticdl_tpu_torch.data.readers import RecordIODataReader
    from elasticdl_tpu_torch.master.master import Master
    from elasticdl_tpu_torch.parallel.mesh import MeshConfig
    from elasticdl_tpu_torch.proto.services import (
        add_pserver_servicer_to_server,
    )
    from elasticdl_tpu_torch.ps.embedding_store import create_store
    from elasticdl_tpu_torch.ps.servicer import PserverServicer
    from elasticdl_tpu_torch.worker.master_client import MasterClient
    from elasticdl_tpu_torch.worker.worker import Worker

    zoo = "elasticdl_tpu_torch.models.deepfm"
    train, valid = chip_smoke.job_data(np, workdir, records=2048, valid=512,
                                       files=1)
    master = Master(zoo, training_data=train, validation_data=valid,
                    records_per_task=256, num_epochs=1,
                    port=find_free_port(), eval_steps=16, seed=0)
    servers, ps_addrs = [], []
    for ps_id in range(2):
        store = create_store(seed=ps_id)
        store.set_optimizer("adam", lr=0.01)
        server = build_server()
        add_pserver_servicer_to_server(
            PserverServicer(store, ps_id=ps_id), server)
        port = find_free_port()
        server.add_insecure_port("localhost:%d" % port)
        server.start()
        servers.append(server)
        ps_addrs.append("localhost:%d" % port)
    result = {}
    try:
        master.prepare()
        thread = threading.Thread(
            target=lambda: result.setdefault("rc", master.run(poll_secs=0.2)),
            daemon=True)
        thread.start()
        worker = Worker(MasterClient("localhost:%d" % master._port, 0), zoo,
                        RecordIODataReader(data_dir=train),
                        minibatch_size=64, report_version_steps=4,
                        wait_sleep_secs=0.1, ps_addrs=ps_addrs,
                        device="cpu", mesh_config=MeshConfig(dp=1))
        worker.run()
        thread.join(timeout=60)
    finally:
        master.stop()
        for server in servers:
            server.stop(0)
    dispatcher = master.task_dispatcher
    summaries = master.evaluation_service.completed_summaries
    return {"trainer": type(worker.trainer).__name__,
            "mesh": dict(worker.trainer.mesh.shape),
            "finished": dispatcher.finished(),
            "failed": dispatcher.job_failed(),
            "auc": summaries[-1][1]["auc"] if summaries else None}


if __name__ == "__main__":
    _main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))

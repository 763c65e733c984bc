"""Multi-rank scenarios of the port's sequence and pipeline parallelism,
run by ``tests.torch_ranks.run_ranks(world, "tests.torch_ranks_longctx:
<scenario>", ...)`` over gloo ranks on the CPU.

Each scenario takes numpy inputs made in the test process, runs the
port on this rank's blocks of them and returns this rank's blocks of
the results (numpy); the tests put the blocks together and hold them
against the reference, computed in the test process. This module
imports no jax.
"""

import numpy as np


def _np(t):
    return t.detach().float().cpu().numpy()


def _t(a, grad=False):
    import torch

    t = torch.from_numpy(np.array(a, order="C"))
    return t.requires_grad_(grad) if grad else t


def _seq_block(a, mesh, dim=2):
    """This rank's block of ``a``: rows over the data axes (dim 0), the
    sequence (``dim``) over sp."""
    from elasticdl_tpu_torch.parallel.mesh import DATA_AXES

    dp, sp = mesh.size(DATA_AXES), mesh.shape["sp"]
    rows, seq = a.shape[0] // dp, a.shape[dim] // sp
    i, j = mesh.index(DATA_AXES), mesh.index("sp")
    index = [slice(i * rows, (i + 1) * rows)] + [slice(None)] * (a.ndim - 1)
    index[dim] = slice(j * seq, (j + 1) * seq)
    return a[tuple(index)]


# ---------------------------------------------------------------------------
# ring and Ulysses attention (tests/test_torch_ring_attention.py)
# ---------------------------------------------------------------------------


def _counting(flash):
    """Wrap the flash wrappers (looked up on the module at call time) to
    count calls, as the CUDA wrappers count launches; returns the
    counter dict."""
    counts = {"fwd": 0, "bwd": 0}
    fwd, bwd = flash.flash_attention_fwd, flash.flash_attention_bwd

    def counted_fwd(*a, **kw):
        counts["fwd"] += 1
        return fwd(*a, **kw)

    def counted_bwd(*a, **kw):
        counts["bwd"] += 1
        return bwd(*a, **kw)

    flash.flash_attention_fwd = counted_fwd
    flash.flash_attention_bwd = counted_bwd
    return counts


def ring_scenario(rank, world, cases):
    """dp2*sp4 (8 ranks): each case ``{name: (kind, impl, causal, loss,
    q, k, v)}`` runs ring ("einsum"/"flash") or ulysses on this rank's
    blocks; returns the output block, and with a loss ("square": sum of
    squares, "cos": sum(out * cos(out))) the q, k, v gradient blocks
    of the global loss. Also: the ring of one (dp8), the collectives'
    semantics and byte records, and K4/K5-K6 calls per rank."""
    import torch

    from elasticdl_tpu_torch.ops import flash_attention as flash
    from elasticdl_tpu_torch.ops.attention import dot_product_attention
    from elasticdl_tpu_torch.ops.ring_attention import (
        ring_attention,
        ulysses_attention,
    )
    from elasticdl_tpu_torch.parallel import collectives
    from elasticdl_tpu_torch.parallel.mesh import MeshConfig, build_mesh

    counts = _counting(flash)
    mesh = build_mesh(MeshConfig(dp=2, sp=4))
    out = {"sp_index": mesh.index("sp")}
    for name, (kind, impl, causal, loss, q, k, v) in cases.items():
        q, k, v = (_t(_seq_block(a, mesh), grad=loss is not None)
                   for a in (q, k, v))
        before = dict(counts)
        with collectives.track_collective_bytes() as acc:
            if kind == "ring":
                o = ring_attention(q, k, v, mesh, causal=causal,
                                   block_impl=impl)
            else:
                o = ulysses_attention(q, k, v, mesh, causal=causal)
            record = {"out": _np(o)}
            if loss == "square":
                torch.sum(torch.square(o)).backward()
            elif loss == "cos":
                torch.sum(o * torch.cos(o)).backward()
        if loss is not None:
            record["grads"] = [_np(t.grad) for t in (q, k, v)]
        record["calls"] = {key: counts[key] - before[key] for key in counts}
        record["bytes"] = {"ppermute": acc.ppermute,
                           "all_to_all": acc.all_to_all, "hops": acc.hops}
        out[name] = record

    # the ring of one: dot_product_attention
    q, k, v = (_t(a) for a in cases["grad"][4:])
    mesh1 = build_mesh(MeshConfig(dp=8, sp=1))
    out["sp1"] = {
        "ring": _np(ring_attention(q, k, v, mesh1, causal=True)),
        "dot": _np(dot_product_attention(q, k, v, causal=True)),
        "einsum": _np(ring_attention(q, k, v, mesh1, causal=True,
                                     block_impl="einsum")),
        "xla": _np(dot_product_attention(q, k, v, causal=True,
                                         impl="xla")),
    }

    # the collectives: a ring shift and its gradient, and an all-to-all
    sp, i = 4, mesh.index("sp")
    x = torch.full((2, 3), float(rank), requires_grad=True)
    shifted = collectives.mesh_ppermute(
        x, "sp", [(j, (j + 1) % sp) for j in range(sp)], mesh=mesh)
    (shifted * (i + 1)).sum().backward()
    partial = collectives.mesh_ppermute(
        torch.full((2,), float(rank)), "sp", [(0, 1)], mesh=mesh)
    blocks = torch.arange(8.0).reshape(4, 2) + 100 * i
    blocks.requires_grad_()
    a2a = collectives.mesh_all_to_all(blocks, "sp", 0, 1, mesh=mesh)
    (a2a * torch.arange(8.0).reshape(1, 8)).sum().backward()
    try:
        ulysses_attention(*(torch.zeros(1, 2, 4, 8) for _ in range(3)),
                          mesh, causal=True)
    except ValueError as e:
        out["ulysses_heads_error"] = str(e)
    out["collectives"] = {
        "shifted": _np(shifted), "shift_grad": _np(x.grad),
        "partial": _np(partial), "a2a": _np(a2a),
        "a2a_grad": _np(blocks.grad)}
    return out


# ---------------------------------------------------------------------------
# TransformerLM at dp2*tp2*sp2 (tests/test_torch_transformer_sp.py)
# ---------------------------------------------------------------------------

SMALL_LM = dict(vocab_size=128, num_layers=2, num_heads=4, embed_dim=32)


def transformer_sp_scenario(rank, world, flat, batch, steps):
    """The small TransformerLM at dp2*tp2*sp2 with ring and with
    Ulysses: ``steps`` Adam steps through SpmdTrainer from the
    reference's weights, the first state's eval logits (gathered over
    sp), and each rank's rotary offset."""
    from elasticdl_tpu_torch.models import transformer
    from elasticdl_tpu_torch.parallel.mesh import MeshConfig, build_mesh
    from elasticdl_tpu_torch.parallel.spmd_trainer import SpmdTrainer
    from elasticdl_tpu_torch.train.optimizers import create_optimizer

    out = {}
    mesh = build_mesh(MeshConfig(dp=2, tp=2, sp=2))
    for impl in ("ring", "ulysses"):
        model = transformer.TransformerLM(**SMALL_LM, attention_impl=impl,
                                          mesh=mesh)
        model.load_state_dict(transformer.params_from_flax(flat),
                              strict=True)
        trainer = SpmdTrainer(
            model=model, loss_fn=transformer.loss,
            optimizer=create_optimizer("Adam", learning_rate=0.01),
            mesh=mesh, seed=0, sharding_rules=transformer.sharding_rules(),
            batch_spec=transformer.batch_spec(), health=False,
            device="cpu")
        state = trainer.create_state(batch["features"])
        logits = trainer.eval_step(state, batch)
        losses = []
        for _ in range(steps):
            state, loss = trainer.train_step(state, dict(batch))
            losses.append(float(loss))
        out[impl] = {"losses": losses, "logits": logits,
                     "shapes": {k: tuple(v.shape)
                                for k, v in state.params.items()}}
    out["sp_index"] = mesh.index("sp")
    return out


# ---------------------------------------------------------------------------
# pipelines (tests/test_torch_pipeline.py)
# ---------------------------------------------------------------------------


def _stage_fn(p, x):
    import torch

    return torch.tanh(x @ p["W"] + p["b"])


def _tp_stage_fn(mesh):
    """Megatron-style column+row parallel MLP inside a stage: the split
    branch enters through mesh_replicate, one psum rejoins it."""
    import torch

    from elasticdl_tpu_torch.models.transformer import tp_enter
    from elasticdl_tpu_torch.parallel.collectives import mesh_psum

    def fn(p, x):
        h = torch.relu(tp_enter(x, mesh) @ p["W1"])
        return mesh_psum(h @ p["W2"], "tp", mesh=mesh) + p["b"]

    return fn


def _block(tree, mesh, specs):
    """This rank's block of every leaf (``specs``: {leaf: spec})."""
    from elasticdl_tpu_torch.parallel.sharding import NamedSharding

    return {k: NamedSharding(mesh, specs[k]).shard(_t(v)).contiguous()
            for k, v in tree.items()}


def _grad_blocks(loss, params, mesh, axes=("dp",)):
    """The gradient blocks of ``loss`` (this rank's share of the global
    loss), summed over the data ranks."""
    import torch

    from elasticdl_tpu_torch.parallel.collectives import mesh_psum

    leaves = list(params.values())
    grads = torch.autograd.grad(loss, leaves)
    return {k: _np(mesh_psum(g, axes, mesh=mesh))
            for k, g in zip(params, grads)}


def _run_stack(mesh, stacked, x, specs, num_microbatches, **kwargs):
    """``pipeline_apply`` of ``_stage_fn`` (or ``kwargs["stage_fn"]``)
    on this rank's blocks: the output rows (this dp rank's), the loss
    mean(out**2) over the global batch and the gradient blocks."""
    import torch

    from elasticdl_tpu_torch.parallel.pipeline import pipeline_apply

    stage_fn = kwargs.pop("stage_fn", _stage_fn)
    params = {k: v.requires_grad_() for k, v in
              _block(stacked, mesh, specs).items()}
    dp = mesh.shape["dp"]
    rows = x.shape[0] // dp
    i = mesh.index("dp")
    local = _t(x[i * rows:(i + 1) * rows])
    out = pipeline_apply(stage_fn, params, local, num_microbatches, mesh,
                         **kwargs)
    loss = torch.sum(out ** 2) / out.numel() / dp
    return {"out": _np(out), "grads": _grad_blocks(loss, params, mesh),
            "index": (mesh.index("dp"), mesh.index("pp"),
                      mesh.index("tp"))}


def pipeline_scenario(rank, world, affine, x, lm, mlp):
    """dp2*pp4 and dp2*pp2*tp2 (8 ranks): every scenario of
    tests/test_pipeline.py on this rank's blocks (see the test file)."""
    import torch

    from elasticdl_tpu_torch.models import pipeline_mlp
    from elasticdl_tpu_torch.models import pipeline_transformer as ptm
    from elasticdl_tpu_torch.models import transformer
    from elasticdl_tpu_torch.parallel.mesh import MeshConfig, build_mesh
    from elasticdl_tpu_torch.parallel.sharding import PartitionSpec as P
    from elasticdl_tpu_torch.parallel.sharding import param_specs
    from elasticdl_tpu_torch.parallel.spmd_trainer import SpmdTrainer

    out = {}
    mesh = build_mesh(MeshConfig(dp=2, pp=4))
    pp = {"W": P("pp"), "b": P("pp")}
    out["forward"] = _run_stack(mesh, affine["s4"], x["x16"], pp, 4)
    out["gradients"] = _run_stack(mesh, affine["s4b"], x["x8"], pp, 2)
    # any M gives the same outputs (each dp rank runs all 12 rows)
    both = np.concatenate([x["x12"], x["x12"]])
    out["microbatches"] = [
        _run_stack(mesh, affine["s4c"], both, pp, m)["out"]
        for m in (1, 2, 4, 6)]
    out["schedules"] = {
        sched: _run_stack(mesh, affine["s4d"], x["x8b"], pp, 2,
                          schedule=sched)
        for sched in ("gpipe", "1f1b")}
    out["gpipe_kept"] = _run_stack(mesh, affine["s4d"], x["x8b"], pp, 2,
                                   schedule="gpipe", remat=False)
    # interleaved: 8 chunks over pp 4, the rank's block chunk-major,
    # and the same chunks device-major
    out["interleaved"] = _run_stack(mesh, affine["s8"], x["x16b"], pp, 4,
                                    num_chunks=2)
    from elasticdl_tpu_torch.parallel.pipeline import device_major_order

    order = device_major_order(4, 2)
    dev = {k: v[order] for k, v in affine["s8"].items()}
    out["interleaved_device"] = _run_stack(mesh, dev, x["x16b"], pp, 4,
                                           num_chunks=2,
                                           params_layout="device")

    # the pipelined LM: the sequential path's logits, the pipeline's,
    # the interleaved one's and the device-major one's, each with its
    # loss and gradient blocks
    tokens = torch.from_numpy(lm["tokens"])

    def lm_run(model, flat, grads=True):
        rules = ptm.sharding_rules()
        full = {k: v for k, v in model.params_from_flax(flat).items()}
        specs = param_specs(full, mesh, rules, model)
        params = {k: v.requires_grad_() for k, v in
                  _block(full, mesh, specs).items()}
        logits = torch.func.functional_call(model, params, (tokens,))
        loss = torch.mean(transformer.loss(tokens, logits).float())
        record = {"logits": _np(logits), "loss": float(loss)}
        if grads:
            # every dp rank runs the whole batch: its gradients are the
            # global loss's
            record["grads"] = _grad_blocks(loss, params, mesh, axes=())
            record["specs"] = {k: tuple(s) for k, s in specs.items()}
        return record

    kwargs = dict(vocab_size=64, num_layers=8, num_stages=4, num_heads=2,
                  embed_dim=16, num_microbatches=2, attention_impl="xla")
    out["lm"] = lm_run(ptm.PipelinedTransformerLM(mesh=mesh, **kwargs),
                       lm["flat"], grads=False)
    out["lm_interleaved"] = lm_run(ptm.PipelinedTransformerLM(
        mesh=mesh, num_chunks=2, **kwargs), lm["flat"], grads=False)
    out["lm_chunk"] = lm_run(ptm.PipelinedTransformerLM(
        mesh=mesh, num_chunks=2, **kwargs), lm["flat"])
    out["lm_device"] = lm_run(ptm.PipelinedTransformerLM(
        mesh=mesh, num_chunks=2, device_major_params=True, **kwargs),
        lm["flat_device"])
    seq_model = ptm.PipelinedTransformerLM(mesh=None, **kwargs)
    seq_model.load_state_dict(ptm.params_from_flax(lm["flat"]))
    out["lm_sequential"] = _np(seq_model(tokens))

    # the LM trained through SpmdTrainer on the pp mesh, from the
    # reference's weights; the whole parameters gathered and run on one
    # rank without a mesh (a pp checkpoint restores onto pp 1)
    model = ptm.PipelinedTransformerLM(
        vocab_size=64, num_layers=4, num_stages=4, num_heads=2,
        embed_dim=16, num_microbatches=2, attention_impl="xla", mesh=mesh)
    model.load_state_dict(ptm.params_from_flax(lm["train_flat"]))
    trainer = SpmdTrainer(
        model=model, loss_fn=ptm.loss, optimizer=transformer.optimizer(),
        mesh=mesh, seed=0, sharding_rules=ptm.sharding_rules(),
        health=False, device="cpu")
    batch = lm["train_batch"]
    state = trainer.create_state(batch["features"])
    out["train_specs"] = {k: tuple(s.spec) for k, s in
                          trainer.state_shardings.params.items()}
    out["train_shapes"] = {k: tuple(v.shape) for k, v in
                           state.params.items()}
    losses = []
    for _ in range(5):
        state, loss = trainer.train_step(state, dict(batch))
        losses.append(float(loss))
    out["train_losses"] = losses
    whole = trainer.full_params(state.params)
    out["train_eval"] = trainer.eval_step(state, batch)
    one = ptm.PipelinedTransformerLM(
        vocab_size=64, num_layers=4, num_stages=1, num_heads=2,
        embed_dim=16, attention_impl="xla")
    one.load_state_dict(ptm.params_from_flax(model.flax_params(whole)))
    with torch.no_grad():
        out["train_eval_pp1"] = _np(one(torch.from_numpy(
            batch["features"])))
    out["train_flat"] = {k: np.asarray(v) for k, v in
                         model.flax_params(whole).items()}

    # lockstep over the same mesh: each process polls one row, the pp
    # ranks of a data slot train on their rows together, and a
    # checkpoint is the whole state (gathered over pp), adopted back
    # into this rank's blocks
    from elasticdl_tpu_torch.parallel.multihost_trainer import (
        MultiHostSpmdTrainer,
    )

    lockstep = MultiHostSpmdTrainer(
        model=model, loss_fn=ptm.loss, optimizer=transformer.optimizer(),
        mesh=mesh, seed=0, sharding_rules=ptm.sharding_rules(),
        health=False, device="cpu")
    state = lockstep.create_state(batch["features"])
    mine = {k: v[rank:rank + 1] for k, v in batch.items()}
    state, loss = lockstep.train_step(state, mine)
    out["lockstep_loss"] = float(loss)
    whole = lockstep.checkpoint_state(state)
    out["lockstep_ckpt_shapes"] = {k: tuple(v.shape) for k, v in
                                   whole.params.items()}
    back = lockstep.adopt_restored(whole)
    out["lockstep_adopted_equal"] = all(
        torch.equal(back.params[k], state.params[k]) for k in state.params)
    try:
        lockstep.local_state(state)
    except ValueError as e:
        out["lockstep_local_error"] = str(e)

    # tp inside pp: dp2*pp2*tp2
    mesh = build_mesh(MeshConfig(dp=2, pp=2, tp=2))
    tp_specs = {"W1": P("pp", None, "tp"), "W2": P("pp", "tp", None),
                "b": P("pp")}
    out["tp"] = _run_stack(mesh, mlp["stages"], x["x8c"], tp_specs, 2,
                           stage_fn=_tp_stage_fn(mesh))
    # the pp x tp model family trained end to end from the reference's
    # weights
    net = pipeline_mlp.PipelinedMlpNet(
        num_classes=4, dim=16, hidden=32, num_layers=4, num_stages=2,
        num_microbatches=2, mesh=mesh)
    net.load_state_dict(pipeline_mlp.params_from_flax(mlp["flat"]))
    trainer = SpmdTrainer(
        model=net, loss_fn=pipeline_mlp.loss,
        optimizer=pipeline_mlp.optimizer(), mesh=mesh, seed=0,
        sharding_rules=pipeline_mlp.sharding_rules(), health=False,
        device="cpu")
    state = trainer.create_state(mlp["batch"]["features"])
    out["mlp_w1"] = (tuple(trainer.state_shardings.params["blocks.W1"]
                           .spec), tuple(state.params["blocks.W1"].shape))
    losses = []
    for _ in range(mlp["steps"]):
        state, loss = trainer.train_step(state, dict(mlp["batch"]))
        losses.append(float(loss))
    out["mlp_losses"] = losses
    return out

"""The port's pipeline parallelism (elasticdl_tpu_torch/parallel/
pipeline.py, models/pipeline_{transformer,mlp}.py) over 8 gloo ranks
(tests/torch_ranks.py) against the reference's on the 8-device CPU
mesh: every scenario of tests/test_pipeline.py, on the same numpy
inputs and weights.

The ranks run dp2*pp4 and dp2*pp2*tp2 meshes on their blocks (the
stacked stages' P("pp") rows, tp columns, dp rows of the batch) and the
blocks are put together here. Held against the reference's own runs:
outputs, losses and parameter gradients of GPipe, 1F1B and the
interleaved schedule (atol 1e-5 on the affine stages and the tp stage,
as the reference test holds them against the sequential math; 1e-4 on
the LM's logits and 1e-5 on its gradients, 1e-4 on trained losses). The
reference's test_microbatch_count_independence runs dp1*pp4 over 4
devices; here each dp rank of dp2*pp4 runs all 12 rows, the same
per-slot computation.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticdl_tpu.models import pipeline_mlp as ref_mlp
from elasticdl_tpu.models import pipeline_transformer as ref_ptm
from elasticdl_tpu.models import transformer as ref_transformer
from elasticdl_tpu.parallel import pipeline as ref_pipeline
from elasticdl_tpu.parallel.mesh import MeshConfig, build_mesh
from elasticdl_tpu.parallel.spmd_trainer import SpmdTrainer
from elasticdl_tpu.train import export as jax_export
from elasticdl_tpu_torch.models import pipeline_transformer as port_ptm
from elasticdl_tpu_torch.parallel import pipeline as port_pipeline
from elasticdl_tpu_torch.parallel.mesh import abstract_mesh
from elasticdl_tpu_torch.parallel.mesh import MeshConfig as PortMeshConfig
from tests.torch_ranks import run_ranks

MLP_STEPS = 30
LM_KW = dict(vocab_size=64, num_layers=8, num_stages=4, num_heads=2,
             embed_dim=16, num_microbatches=2, attention_impl="xla")


def _affine(num_stages, dim=8, seed=0):
    rng = np.random.RandomState(seed)
    stages = [dict(W=(rng.randn(dim, dim) * 0.3).astype(np.float32),
                   b=(rng.randn(dim) * 0.1).astype(np.float32))
              for _ in range(num_stages)]
    return {k: np.stack([s[k] for s in stages]) for k in ("W", "b")}


def _x(rows, seed, dim=8):
    return np.random.RandomState(seed).randn(rows, dim).astype(np.float32)


def _stage_fn(p, x):
    return jnp.tanh(x @ p["W"] + p["b"])


def _tp_stage_fn(p, x):
    from elasticdl_tpu.parallel.collectives import mesh_psum

    h = jnp.maximum(x @ p["W1"], 0.0)
    return mesh_psum(h @ p["W2"], "tp") + p["b"]


def _lm_batch(batch=8, seq=16, vocab=64, seed=0):
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, vocab, size=(batch, seq)).astype(np.int32)
    return {"features": tokens, "labels": tokens,
            "_mask": np.ones((batch,), np.float32)}


def _mlp_batch():
    rng = np.random.RandomState(0)
    features = rng.randn(16, 16).astype(np.float32)
    labels = (features.sum(axis=1) > 0).astype(np.int32)
    return {"features": features, "labels": labels,
            "_mask": np.ones((16,), np.float32)}


def _inputs():
    rng = np.random.RandomState(11)
    dim, hidden = 8, 16
    tp_stages = {"W1": (rng.randn(2, dim, hidden) * 0.3).astype(np.float32),
                 "W2": (rng.randn(2, hidden, dim) * 0.3).astype(np.float32),
                 "b": (rng.randn(2, dim) * 0.1).astype(np.float32)}
    return {
        "affine": {"s4": _affine(4), "s4b": _affine(4, seed=2),
                   "s4c": _affine(4, seed=4), "s4d": _affine(4, seed=7),
                   "s8": _affine(8, seed=9)},
        "x": {"x16": _x(16, 1), "x8": _x(8, 3), "x12": _x(12, 5),
              "x8b": _x(8, 8), "x16b": _x(16, 10), "x8c": _x(8, 12)},
        "tp_stages": tp_stages,
    }


# ---------------------------------------------------------------------------
# the reference's runs
# ---------------------------------------------------------------------------


def _ref_stack(mesh, stacked, x, m, fn=_stage_fn, **kw):
    stacked = {k: jnp.asarray(v) for k, v in stacked.items()}
    x = jnp.asarray(x)
    run = lambda sp: ref_pipeline.pipeline_apply(fn, sp, x, m, mesh, **kw)
    out = jax.jit(run)(stacked)
    grads = jax.jit(jax.grad(lambda sp: jnp.mean(run(sp) ** 2)))(stacked)
    return {"out": np.asarray(out),
            "grads": {k: np.asarray(v) for k, v in grads.items()}}


def _sequential(stacked, x):
    for i in range(stacked["W"].shape[0]):
        x = np.tanh(x @ stacked["W"][i] + stacked["b"][i])
    return x


def _lm_loss(model):
    def fn(variables, tokens):
        logits = model.apply(variables, tokens, training=False)
        return jnp.mean(ref_transformer.loss(tokens, logits).astype(
            jnp.float32))
    return fn


def _reference(inputs, start):
    """The reference's runs. ``start(lm, mlp)`` is called as soon as the
    weights the ranks start from exist, so the ranks run while the rest
    computes here."""
    aff, x = inputs["affine"], inputs["x"]
    mesh = build_mesh(MeshConfig(dp=2, pp=4))
    tp_mesh = build_mesh(MeshConfig(dp=2, pp=2, tp=2))
    # the weights: the LM's (portable and device-major), the trained
    # LM's and the pp x tp MLP's, from the reference's own inits
    batch = _lm_batch()
    tokens = batch["features"]
    piped = ref_ptm.PipelinedTransformerLM(mesh=mesh, **LM_KW)
    variables = piped.init(jax.random.PRNGKey(0), tokens)
    inter = ref_ptm.PipelinedTransformerLM(mesh=mesh, num_chunks=2, **LM_KW)
    dev = ref_ptm.PipelinedTransformerLM(mesh=mesh, num_chunks=2,
                                         device_major_params=True, **LM_KW)
    v_dev = dev.init(jax.random.PRNGKey(0), tokens)
    model = ref_ptm.PipelinedTransformerLM(
        vocab_size=64, num_layers=4, num_stages=4, num_heads=2,
        embed_dim=16, num_microbatches=2, attention_impl="xla", mesh=mesh)
    lm_trainer = SpmdTrainer(model=model, loss_fn=ref_ptm.loss,
                             optimizer=ref_transformer.optimizer(),
                             mesh=mesh, seed=0,
                             sharding_rules=ref_ptm.sharding_rules())
    train_batch = _lm_batch(batch=8, seq=16)
    lm_state = lm_trainer.create_state(train_batch["features"])
    net = ref_mlp.PipelinedMlpNet(num_classes=4, dim=16, hidden=32,
                                  num_layers=4, num_stages=2,
                                  num_microbatches=2, mesh=tp_mesh)
    mlp_trainer = SpmdTrainer(model=net, loss_fn=ref_mlp.loss,
                              optimizer=ref_mlp.optimizer(), mesh=tp_mesh,
                              seed=0,
                              sharding_rules=ref_mlp.sharding_rules())
    mlp_batch = _mlp_batch()
    mlp_state = mlp_trainer.create_state(mlp_batch["features"])
    ref = {"lm": {
        "tokens": tokens,
        "flat": jax_export._flatten(jax.device_get(variables["params"])),
        "flat_device": jax_export._flatten(jax.device_get(
            v_dev["params"])),
        "train_flat": jax_export._flatten(jax.device_get(lm_state.params)),
        "train_batch": train_batch}}
    ref["mlp"] = {"flat": jax_export._flatten(jax.device_get(
        mlp_state.params)), "batch": mlp_batch, "steps": MLP_STEPS}
    start(ref["lm"], ref["mlp"])

    ref.update({
        "forward": _ref_stack(mesh, aff["s4"], x["x16"], 4),
        "gradients": _ref_stack(mesh, aff["s4b"], x["x8"], 2),
        "schedules": {s: _ref_stack(mesh, aff["s4d"], x["x8b"], 2,
                                    schedule=s) for s in ("gpipe", "1f1b")},
        "interleaved": _ref_stack(mesh, aff["s8"], x["x16b"], 4,
                                  num_chunks=2),
    })
    mesh4 = build_mesh(MeshConfig(dp=1, pp=4), num_devices=4)
    ref["microbatches"] = [np.asarray(jax.jit(
        lambda sp, x, m=m: ref_pipeline.pipeline_apply(_stage_fn, sp, x, m,
                                                       mesh4))(
        {k: jnp.asarray(v) for k, v in aff["s4c"].items()},
        jnp.asarray(x["x12"]))) for m in (1, 2, 4, 6)]
    loss, grads = jax.jit(jax.value_and_grad(_lm_loss(inter)))(
        variables, tokens)
    ref["lm"].update({
        "logits": np.asarray(jax.jit(lambda v, t: piped.apply(v, t))(
            variables, tokens)),
        "logits_interleaved": np.asarray(jax.jit(
            lambda v, t: inter.apply(v, t))(variables, tokens)),
        "chunk_loss": float(loss),
        "chunk_grads": jax_export._flatten(jax.device_get(
            grads["params"])),
    })
    losses = []
    for _ in range(5):
        lm_state, loss = lm_trainer.train_step(lm_state, train_batch)
        losses.append(float(loss))
    ref["train_losses"] = losses
    ref["train_flat_after"] = jax_export._flatten(jax.device_get(
        lm_state.params))

    # tp inside pp, and the pp x tp model family
    specs = dict(W1=jax.sharding.PartitionSpec("pp", None, "tp"),
                 W2=jax.sharding.PartitionSpec("pp", "tp", None),
                 b=jax.sharding.PartitionSpec("pp"))
    ref["tp"] = _ref_stack(tp_mesh, inputs["tp_stages"], x["x8c"], 2,
                           fn=_tp_stage_fn, param_specs=specs)
    losses = []
    for _ in range(MLP_STEPS):
        mlp_state, loss = mlp_trainer.train_step(mlp_state, mlp_batch)
        losses.append(float(loss))
    ref["mlp_losses"] = losses
    return ref


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    inputs = _inputs()
    with ThreadPoolExecutor(1) as pool:
        ranks = []

        def start(lm, mlp):
            ranks.append(pool.submit(
                run_ranks, 8, "tests.torch_ranks_longctx:pipeline_scenario",
                tmp_path_factory.mktemp("pipeline"), timeout=240,
                affine=inputs["affine"], x=inputs["x"], lm=dict(lm),
                mlp=dict(mlp, stages=inputs["tp_stages"])))

        ref = _reference(inputs, start)
        return ranks[0].result(), ref


# ---------------------------------------------------------------------------
# putting rank blocks together
# ---------------------------------------------------------------------------


def _rows(results, key):
    """The output rows of the dp ranks (pp rank 0 of each)."""
    return np.concatenate([out[key]["out"] for out in results
                           if out[key]["index"][1:] == (0, 0)])


def _stacked(results, key, leaf, pp=4, tp_dim=None):
    """A gradient leaf put together from the blocks of dp rank 0: pp
    blocks along dim 0, tp blocks along ``tp_dim``."""
    blocks = {}
    for out in results:
        d, p, t = out[key]["index"]
        if d == 0:
            blocks[p, t] = out[key]["grads"][leaf]
    tps = sorted({t for _, t in blocks})
    return np.concatenate([
        np.concatenate([blocks[p, t] for t in tps], axis=tp_dim)
        if tp_dim is not None else blocks[p, 0]
        for p in range(pp)])


def _assert_stack(results, key, ref, atol=1e-5):
    np.testing.assert_allclose(_rows(results, key), ref["out"], atol=atol)
    for leaf in ("W", "b"):
        np.testing.assert_allclose(_stacked(results, key, leaf),
                                   ref["grads"][leaf], atol=atol)


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------


def test_pipeline_forward_matches_sequential(runs):
    results, ref = runs
    _assert_stack(results, "forward", ref["forward"])
    np.testing.assert_allclose(
        _rows(results, "forward"),
        _sequential(_inputs()["affine"]["s4"], _inputs()["x"]["x16"]),
        atol=1e-5)


def test_pipeline_gradients_match_sequential(runs):
    results, ref = runs
    _assert_stack(results, "gradients", ref["gradients"])


def test_microbatch_count_independence(runs):
    results, ref = runs
    for out in results:
        outs = out["microbatches"]
        for got, want in zip(outs, ref["microbatches"]):
            np.testing.assert_allclose(got, want, atol=1e-5)
        for other in outs[1:]:
            np.testing.assert_allclose(outs[0], other, atol=1e-5)


def test_stack_unstack_roundtrip():
    rng = np.random.RandomState(6)
    params = [dict(W=torch.from_numpy(rng.randn(8, 8)),
                   b=torch.from_numpy(rng.randn(8))) for _ in range(3)]
    stacked = port_pipeline.stack_stage_params(params)
    for orig, back in zip(params,
                          port_pipeline.unstack_stage_params(stacked, 3)):
        for k in orig:
            torch.testing.assert_close(orig[k], back[k], rtol=0, atol=0)


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_schedules_agree(runs, schedule):
    """gpipe and 1f1b are different schedules of the same math: each
    matches the reference's run of it and the other's outputs and
    gradients; gpipe without remat (the forward's graphs kept) too."""
    results, ref = runs
    for out in results:
        got = out["schedules"][schedule]
        other = out["schedules"]["1f1b" if schedule == "gpipe"
                                 else "gpipe"]
        np.testing.assert_allclose(got["out"], other["out"], atol=1e-5)
        for leaf in ("W", "b"):
            np.testing.assert_allclose(got["grads"][leaf],
                                       other["grads"][leaf], atol=1e-5)
            np.testing.assert_allclose(out["gpipe_kept"]["grads"][leaf],
                                       got["grads"][leaf], atol=1e-5)
    flat = [dict(out, schedules=out["schedules"][schedule])
            for out in results]
    _assert_stack(flat, "schedules", ref["schedules"][schedule])


def test_interleaved_chunks_match_sequential(runs):
    """num_chunks=2: 8 chunks over pp 4, microbatches wrapping from the
    last rank to the first; the rank's block chunk-major, and the same
    stack device-major (params_layout="device"), whose gradients come
    back device-major."""
    results, ref = runs
    _assert_stack(results, "interleaved", ref["interleaved"])
    np.testing.assert_allclose(
        _rows(results, "interleaved"),
        _sequential(_inputs()["affine"]["s8"], _inputs()["x"]["x16b"]),
        atol=1e-5)
    np.testing.assert_allclose(_rows(results, "interleaved_device"),
                               ref["interleaved"]["out"], atol=1e-5)
    back = port_pipeline.chunk_major_order(4, 2)
    for leaf in ("W", "b"):
        dev = _stacked(results, "interleaved_device", leaf)
        np.testing.assert_allclose(dev[back],
                                   ref["interleaved"]["grads"][leaf],
                                   atol=1e-5)


def test_interleaved_requires_small_m():
    mesh = abstract_mesh(PortMeshConfig(dp=2, pp=4), 8)
    stacked = {k: torch.from_numpy(v[:2])
               for k, v in _affine(8, seed=9).items()}
    with pytest.raises(ValueError, match="conflict-free"):
        port_pipeline.pipeline_apply(
            lambda p, x: x, stacked, torch.zeros(16, 8), 8, mesh,
            num_chunks=2)


def test_bubble_fraction_interleaving_beats_gpipe():
    for fn in (port_pipeline.schedule_info, ref_pipeline.schedule_info):
        gpipe = fn(num_stages=4, num_microbatches=4, num_chunks=1)
        inter = fn(num_stages=4, num_microbatches=4, num_chunks=2)
        assert gpipe["ticks_per_direction"] == 4 + 4 - 1
        assert inter["ticks_per_direction"] == 4 + 8 - 1
        assert inter["bubble_fraction"] < gpipe["bubble_fraction"]
        assert inter["activations_per_device"] == 8
    assert port_pipeline.schedule_info(4, 4, 2) == ref_pipeline.schedule_info(
        4, 4, 2)
    np.testing.assert_array_equal(port_pipeline.device_major_order(4, 2),
                                  ref_pipeline.device_major_order(4, 2))
    np.testing.assert_array_equal(port_pipeline.chunk_major_order(4, 2),
                                  ref_pipeline.chunk_major_order(4, 2))


def test_tp_inside_pp(runs):
    """tp composes within a stage (dp2*pp2*tp2): W1 split on its output
    dim and W2 on its input dim over tp, one psum over tp; outputs and
    gradients match the reference's."""
    results, ref = runs
    got = ref["tp"]
    np.testing.assert_allclose(_rows(results, "tp"), got["out"], atol=1e-5)
    for leaf, tp_dim in (("W1", 2), ("W2", 1), ("b", None)):
        np.testing.assert_allclose(
            _stacked(results, "tp", leaf, pp=2, tp_dim=tp_dim),
            got["grads"][leaf], atol=1e-5)


def test_pipelined_lm_matches_sequential_fallback(runs):
    """The same weights through the pp=4 pipeline (1f1b, and 2
    interleaved chunks) and the meshless sequential path: the
    reference's logits."""
    results, ref = runs
    for out in results:
        np.testing.assert_allclose(out["lm"]["logits"], ref["lm"]["logits"],
                                   atol=1e-4)
        np.testing.assert_allclose(out["lm_interleaved"]["logits"],
                                   ref["lm"]["logits_interleaved"],
                                   atol=1e-4)
        np.testing.assert_allclose(out["lm_sequential"],
                                   ref["lm"]["logits"], atol=1e-4)


def _lm_grads(results, key, model):
    """The LM's gradients put together from dp rank 0's pp blocks, in
    flax names."""
    blocks = [out[key]["grads"] for out in results[:4]]
    whole = {}
    for name in blocks[0]:
        if results[0][key]["specs"][name][:1] == ("pp",):
            whole[name] = torch.from_numpy(np.concatenate(
                [b[name] for b in blocks]))
        else:
            whole[name] = torch.from_numpy(blocks[0][name])
    return model.flax_params(whole)


def test_device_major_layout_matches_chunk_major(runs):
    """params_layout="device" (no per-step gather of the stack) gives
    the chunk-major layout's loss and, through the model's layout
    conversion, its gradients; both are the reference's."""
    results, ref = runs
    mesh = abstract_mesh(PortMeshConfig(dp=2, pp=4), 8)
    chunk = port_ptm.PipelinedTransformerLM(mesh=mesh, num_chunks=2,
                                            **LM_KW)
    dev = port_ptm.PipelinedTransformerLM(mesh=mesh, num_chunks=2,
                                          device_major_params=True, **LM_KW)
    for out in results:
        assert np.isclose(out["lm_chunk"]["loss"], out["lm_device"]["loss"],
                          rtol=1e-6)
        assert np.isclose(out["lm_chunk"]["loss"], ref["lm"]["chunk_loss"],
                          rtol=1e-5)
    g_chunk = _lm_grads(results, "lm_chunk", chunk)
    g_dev = _lm_grads(results, "lm_device", dev)
    order = np.argsort(dev._layer_order())
    for name, value in g_chunk.items():
        want = ref["lm"]["chunk_grads"][name]
        np.testing.assert_allclose(value, want, atol=1e-5)
        dev_name = name.replace("blocks/", "blocks_device_major/")
        got = g_dev[dev_name]
        if dev_name != name:
            got = got[order]
        np.testing.assert_allclose(got, want, atol=1e-5)
    # the stored stacks map onto each other under the layout conversion
    flat_dev = port_ptm.params_from_flax(ref["lm"]["flat_device"])
    blocks = {k.split(".", 1)[1]: v for k, v in flat_dev.items()
              if k.startswith("blocks_device_major.")}
    portable = dev.blocks_to_portable(blocks)
    flat = port_ptm.params_from_flax(ref["lm"]["flat"])
    for k, v in portable.items():
        torch.testing.assert_close(v, flat["blocks." + k], rtol=0, atol=0)


def test_zoo_contract_mesh_injection():
    from elasticdl_tpu_torch.models.registry import get_model_spec

    spec = get_model_spec("elasticdl_tpu_torch.models.pipeline_transformer")
    mesh = abstract_mesh(PortMeshConfig(dp=2, pp=4), 8)
    model = spec.custom_model(mesh=mesh)
    assert model.num_stages == 4
    assert model.mesh is mesh
    assert spec.custom_model().mesh is None
    config = spec.mesh_config(8)
    assert config.pp == 4 and config.dp == 2
    assert spec.sharding_rules is not None
    spec = get_model_spec("elasticdl_tpu_torch.models.pipeline_mlp")
    assert spec.mesh_config(8).tp == 2
    with pytest.raises(ValueError, match="does not divide"):
        get_model_spec(
            "elasticdl_tpu_torch.models.pipeline_transformer"
        ).custom_model(mesh=abstract_mesh(PortMeshConfig(pp=5), 5))


def test_param_layout_is_topology_independent():
    """The stacked leaves' shapes do not depend on num_stages (the same
    seed draws the same weights), and a depth that does not divide
    raises."""
    kwargs = dict(vocab_size=64, num_layers=8, num_heads=2, embed_dim=16)
    torch.manual_seed(0)
    v4 = port_ptm.PipelinedTransformerLM(num_stages=4, **kwargs).state_dict()
    torch.manual_seed(0)
    v2 = port_ptm.PipelinedTransformerLM(num_stages=2, **kwargs).state_dict()
    assert list(v4) == list(v2)
    for name in v4:
        torch.testing.assert_close(v4[name], v2[name], rtol=0, atol=0)
    with pytest.raises(ValueError, match="not divisible"):
        port_ptm.PipelinedTransformerLM(num_stages=3, **kwargs)


def test_device_major_requires_interleaving():
    with pytest.raises(ValueError, match="device_major_params"):
        port_ptm.PipelinedTransformerLM(
            num_layers=8, num_stages=4, num_chunks=1,
            device_major_params=True,
            mesh=abstract_mesh(PortMeshConfig(dp=2, pp=4), 8))


def test_weights_cross_both_ways(runs):
    """params_from_flax takes the reference's stacked blocks (and
    blocks_device_major) and flax_params gives them back."""
    _, ref = runs
    for key, flat in (("blocks", ref["lm"]["flat"]),
                      ("blocks_device_major", ref["lm"]["flat_device"])):
        model = port_ptm.PipelinedTransformerLM(
            mesh=abstract_mesh(PortMeshConfig(dp=2, pp=4), 8), num_chunks=2,
            device_major_params=key != "blocks", **LM_KW)
        state = port_ptm.params_from_flax(flat)
        model.load_state_dict(state, strict=True)
        back = model.flax_params(model.state_dict())
        assert set(back) == set(flat)
        for name, value in flat.items():
            np.testing.assert_array_equal(back[name], value)


def test_pipelined_lm_trains_on_pp_mesh(runs):
    """The LM through SpmdTrainer at dp2*pp4 from the reference's
    weights: the stacked blocks and their Adam slots under P("pp"), the
    reference's five losses (the embedding, final norm and head counted
    once, not pp times) and its trained weights; the whole parameters
    gathered run on one rank without a mesh give the pipeline's
    logits (a pp checkpoint restores onto pp 1)."""
    results, ref = runs
    for out in results:
        assert out["train_specs"]["blocks.attn.query.weight"][0] == "pp"
        assert out["train_shapes"]["blocks.attn.query.weight"] == (1, 16, 16)
        np.testing.assert_allclose(out["train_losses"], ref["train_losses"],
                                   atol=1e-4, rtol=1e-4)
        assert out["train_losses"][-1] < out["train_losses"][0]
        np.testing.assert_allclose(out["train_eval_pp1"], out["train_eval"],
                                   atol=1e-5)
        for name, want in ref["train_flat_after"].items():
            np.testing.assert_allclose(out["train_flat"][name], want,
                                       atol=2e-4)


def test_pipeline_mlp_trains_on_pptp_mesh(runs):
    """The pp x tp model family: W1 split over pp (the layer stack) and
    tp (the hidden dim), and the reference's losses over 30 steps."""
    results, ref = runs
    for out in results:
        spec, shape = out["mlp_w1"]
        assert spec[0] == "pp" and "tp" in spec
        assert shape == (2, 16, 16)
        np.testing.assert_allclose(out["mlp_losses"], ref["mlp_losses"],
                                   atol=1e-4, rtol=1e-4)
        assert out["mlp_losses"][-1] < out["mlp_losses"][0]


def test_lockstep_processes_share_a_pp_slot(runs):
    """MultiHostSpmdTrainer over dp2*pp4, each process polling one row:
    the pp ranks of a data slot train on their four rows together (the
    first loss is the SpmdTrainer's over the whole batch), a checkpoint
    holds every leaf whole (the stack gathered over pp; rank 0 writes
    it) and adopts back bit for bit into each rank's blocks, and
    per-worker evaluation, which would need the whole state on one
    process, refuses."""
    results, _ = runs
    for out in results:
        np.testing.assert_allclose(out["lockstep_loss"],
                                   out["train_losses"][0], rtol=1e-6)
        shapes = out["lockstep_ckpt_shapes"]
        assert shapes["blocks.attn.query.weight"] == (4, 16, 16)
        assert shapes["wte.weight"] == (64, 16)
        assert out["lockstep_adopted_equal"]
        assert "(pp or sp)" in out["lockstep_local_error"]

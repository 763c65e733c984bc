"""The port's dense data plane (elasticdl_tpu_torch/parallel/
dense_plane.py and the SPMD trainer's contract) against the reference's
(tests/test_dense_plane.py).

- ``plan_dense_plane`` is arithmetic over shapes, specs and mesh sizes:
  on the port's TransformerLM and MoE LM it gives the reference's plan
  of the same flax model, leaf by leaf and in total, on the same mesh
  sizes, with the models' sharding rules and without (the port's
  ``abstract_mesh`` here, the reference's mesh on the 8 virtual CPU
  devices). The port drops a spec's size-1 axes before it plans (the
  reference counts a rule's fsdp entry on a mesh of fsdp 1 as a
  reduce-scatter over nothing); the reference's arithmetic, fed the
  specs without them, is what the port's plan is held to.
- At mesh 1 the SPMD trainer's step is TorchTrainer's bit for bit (one
  gloo rank, tests/torch_ranks.py), from the reference mnist's weights.
- On an fsdp=2 mesh (two ranks) the plan reduce-scatters the big
  kernels, and bf16-compute steps match TorchTrainer's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticdl_tpu.models import mnist as ref_mnist
from elasticdl_tpu.models import moe_transformer as ref_moe
from elasticdl_tpu.models import transformer as ref_tf
from elasticdl_tpu.parallel import dense_plane as ref_plane
from elasticdl_tpu.parallel import mesh as ref_mesh
from elasticdl_tpu.parallel.sharding import ShardingRules as RefRules
from elasticdl_tpu.train import export as jax_export
from elasticdl_tpu_torch.models import moe_transformer as port_moe
from elasticdl_tpu_torch.models import transformer as port_tf
from elasticdl_tpu_torch.parallel import dense_plane as port_plane
from elasticdl_tpu_torch.parallel import mesh as port_mesh
from elasticdl_tpu_torch.parallel.sharding import PartitionSpec as P
from elasticdl_tpu_torch.parallel.sharding import ShardingRules
from tests.torch_ranks import run_ranks

from jax.sharding import PartitionSpec as JP

torch.set_num_threads(1)

LM = dict(vocab_size=512, num_layers=2, num_heads=4, embed_dim=64)
MOE = dict(LM, num_experts=4, top_k=2)


def _ref_params(model):
    tokens = jnp.zeros((2, 16), jnp.int32)
    return jax.eval_shape(model.init, jax.random.PRNGKey(0),
                          tokens)["params"]


MODELS = {
    "transformer": (lambda: ref_tf.TransformerLM(**LM),
                    lambda: port_tf.TransformerLM(**LM),
                    ref_tf.sharding_rules, port_tf.sharding_rules),
    "moe": (lambda: ref_moe.MoeTransformerLM(**MOE),
            lambda: port_moe.MoeTransformerLM(**MOE),
            ref_moe.sharding_rules, port_moe.sharding_rules),
}
MESHES = [dict(dp=2, fsdp=2, tp=2), dict(fsdp=8), dict(dp=8),
          dict(dp=2, tp=2, ep=2), dict(dp=1, fsdp=2, ep=4), dict(dp=1),
          dict(dp=1, fsdp=2, tp=2, ep=2)]


class _LiveAxes(RefRules):
    """The reference's rules with every size-1 axis of the mesh taken
    out of each spec (the port's plan drops them: a leaf sharded over
    nothing is not sharded)."""

    def __init__(self, rules, mesh):
        self._inner, self._shape = rules, dict(mesh.shape)

    def spec_for(self, path, shape=None):
        spec = self._inner.spec_for(path, shape)

        def live(entry):
            names = (entry,) if isinstance(entry, str) else tuple(
                entry or ())
            names = tuple(a for a in names if self._shape[a] > 1)
            return names[0] if len(names) == 1 else (names or None)

        return JP(*(live(e) for e in spec))


@pytest.mark.parametrize("rules", [True, False])
@pytest.mark.parametrize("config", MESHES)
@pytest.mark.parametrize("name", sorted(MODELS))
def test_plan_matches_reference_leaf_by_leaf(name, config, rules):
    """The reference's plan_dense_plane, fed the rules' specs with the
    mesh's size-1 axes taken out, computes the port's plan leaf by leaf
    and in total. On a mesh where every axis the rules name is live
    (and without rules) that is the reference's own plan; where a rule
    names a size-1 axis (fsdp=1 beside the model axes) the reference
    counts a reduce-scatter over nothing, and, for a tp-split leaf, the
    bytes of the whole leaf, where the port reduces its tp block over dp
    (what SpmdTrainer moves)."""
    make_ref, make_port, ref_rules, port_rules = MODELS[name]
    n = int(np.prod(list(config.values())))
    rmesh = ref_mesh.build_mesh(
        ref_mesh.MeshConfig(**config, devices=jax.devices()[:n]))
    live = _LiveAxes(ref_rules(), rmesh) if rules else None
    want = ref_plane.plan_dense_plane(_ref_params(make_ref()), rmesh, live)
    model = make_port()
    params = dict(model.named_parameters())
    got = port_plane.plan_dense_plane(
        params, port_mesh.abstract_mesh(port_mesh.MeshConfig(**config), n),
        port_rules() if rules else None, model)
    assert got.summary() == want.summary()
    ref_leaves = {p.path: p for p in want.params}
    assert len(got.params) == len(ref_leaves)
    for leaf in got.params:
        flax_path, _ = model.flax_leaf(leaf.path)
        ref = ref_leaves[flax_path]
        assert (leaf.mode, leaf.nbytes, leaf.grad_bytes_per_step) == (
            ref.mode, ref.nbytes, ref.grad_bytes_per_step), leaf.path
    named = set()
    for spec in (s for _, s in ref_rules()._rules):
        for entry in spec:
            named.update((entry,) if isinstance(entry, str) else entry or ())
    if not rules or all(rmesh.shape[a] > 1 for a in named):
        plain = ref_plane.plan_dense_plane(
            _ref_params(make_ref()), rmesh, ref_rules() if rules else None)
        assert got.summary() == plain.summary()


def test_plan_reduce_scatter_vs_psum_fallback():
    """fsdp-sharded params reduce-scatter; small/replicated params fall
    back to a psum; tp-sharded params reduce only over the data extent
    (the reference's test, on the port's abstract mesh)."""
    mesh = port_mesh.abstract_mesh(port_mesh.MeshConfig(dp=2, fsdp=2, tp=2),
                                   8)
    params = {"big": torch.empty(1024, 64), "tiny": torch.empty(8),
              "tpw": torch.empty(64, 64)}
    rules = ShardingRules(rules=[(r"^big$", P("fsdp", None)),
                                 (r"^tpw$", P(None, "tp"))],
                          default_spec=P())
    plan = port_plane.plan_dense_plane(params, mesh, rules)
    modes = {p.path: p for p in plan.params}
    big, tiny, tpw = modes["big"], modes["tiny"], modes["tpw"]
    assert (big.mode, tiny.mode, tpw.mode) == ("reduce_scatter", "psum",
                                               "psum")
    assert big.grad_bytes_per_step == (
        big.nbytes // 2 + 2 * ((big.nbytes // 2) // 2))
    assert tiny.grad_bytes_per_step == 2 * (tiny.nbytes * 3 // 4)
    assert tpw.grad_bytes_per_step == 2 * ((tpw.nbytes // 2) * 3 // 4)
    summary = plan.summary()
    assert summary["mesh_shape"] == "dp=2,fsdp=2,tp=2"
    assert summary["reduce_scatter_params"] == 1
    assert summary["psum_params"] == 2
    # the reference's plan of the same shapes and specs
    rmesh = ref_mesh.build_mesh(ref_mesh.MeshConfig(dp=2, fsdp=2, tp=2))
    ref = ref_plane.plan_dense_plane(
        {k: jax.ShapeDtypeStruct(tuple(v.shape), jnp.float32)
         for k, v in params.items()}, rmesh,
        RefRules(rules=[(r"^big$", JP("fsdp", None)),
                        (r"^tpw$", JP(None, "tp"))], default_spec=JP()))
    assert summary == ref.summary()


def test_plan_single_rank_is_all_local():
    mesh = port_mesh.abstract_mesh(port_mesh.MeshConfig(dp=1), 1)
    plan = port_plane.plan_dense_plane({"w": torch.empty(32, 32)}, mesh)
    assert all(p.mode == "local" for p in plan.params)
    assert plan.collective_bytes_per_step == 0
    assert plan.mesh_shape_str() == "dp=1"


def _mnist_flat(seed=7):
    params = ref_mnist.custom_model().init(
        jax.random.PRNGKey(seed), jnp.zeros((2, 28, 28)),
        training=False)["params"]
    return jax_export._flatten({"params": jax.device_get(params)})


def test_spmd_trainer_bit_exact_at_mesh1(tmp_path):
    """At mesh 1 the SPMD trainer's three steps are TorchTrainer's bit
    for bit: losses, params and Adam's slots; the plan is derived and
    reads all local, "dp=1", 0 bytes."""
    (out,) = run_ranks(1, "mesh1_scenario", tmp_path, flat=_mnist_flat())
    for single, spmd in out["losses"]:
        assert single == spmd
    assert out["single"].keys() == out["spmd"].keys()
    for name, value in out["single"].items():
        np.testing.assert_array_equal(out["spmd"][name], value, err_msg=name)
    assert out["mesh_shape"] == "dp=1" and out["bytes"] == 0.0
    assert out["summary"]["local_params"] == len(
        [k for k in out["single"] if k.startswith("params/")])


@pytest.fixture(scope="module")
def fsdp2_results(tmp_path_factory):
    return run_ranks(2, "fsdp2_scenario", tmp_path_factory.mktemp("fsdp2"),
                     flat=_mnist_flat())


def test_spmd_trainer_dense_plan_on_fsdp_mesh(fsdp2_results):
    results = fsdp2_results
    for out in results:
        assert np.isfinite(out["loss"])
        assert out["loss"] == results[0]["loss"]
        assert "reduce_scatter" in out["modes"].values()
        # biases fall back to a psum
        assert out["modes"]["Conv_0.bias"] == "psum"
        assert out["bytes"] > 0
        assert out["mesh_shape"] == "fsdp=2"


def test_fsdp_mesh_bf16_compute_matches_single_device(fsdp2_results):
    """With bf16 compute on an fsdp=2 mesh the forward runs on the
    gathered weights (cast after the all-gather): two steps against
    TorchTrainer's bf16 steps on the same batches. Tolerances: losses
    within 2e-3 (bf16 rounding of the two halves' sums). Adam moves an
    element by about the learning rate whatever its gradient's size, so
    a bf16-rounded gradient near zero may move it differently: at most
    1% of each leaf's elements may lie outside rtol 2e-3 / atol 2e-4
    (the dp test's), and none further than two steps' worth, 2 * 2 *
    0.002. Before the cast took the gathered weights the forward got
    the blocks and raised."""
    lr, steps = 0.002, 2
    for out in fsdp2_results:
        assert out["bf16_sharded"], "no parameter was an fsdp block"
        for single, spmd in out["bf16_losses"]:
            assert abs(single - spmd) < 2e-3, (single, spmd)
        for name, (single, spmd) in out["bf16_params"].items():
            assert spmd.shape == single.shape, name
            off = ~np.isclose(spmd, single, rtol=2e-3, atol=2e-4)
            assert off.mean() <= 0.01, (name, off.mean())
            np.testing.assert_allclose(spmd, single, rtol=0,
                                       atol=2 * steps * lr, err_msg=name)

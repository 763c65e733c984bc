"""The port's mesh (elasticdl_tpu_torch/parallel/mesh.py) against the
reference's: the --mesh spec parser and MeshConfig in process, the mesh
over 8 gloo ranks of the default process group (tests/torch_ranks.py).
The reference's mesh is built here on the 8 virtual CPU devices."""

import numpy as np
import pytest
import torch

from elasticdl_tpu.parallel import mesh as ref_mesh
from elasticdl_tpu_torch.parallel import mesh as port_mesh
from tests.torch_ranks import run_ranks

torch.set_num_threads(1)


@pytest.mark.parametrize("spec", ["", "  ", "dp=2,fsdp=4", "fsdp=4",
                                  "pp=2, tp=2", "dp=-1,fsdp=2",
                                  "tp=2,ep=2"])
def test_parse_mesh_spec_matches_reference(spec):
    want = ref_mesh.parse_mesh_spec(spec)
    got = port_mesh.parse_mesh_spec(spec)
    if want is None:
        assert got is None
        return
    for axis in port_mesh.AXES:
        assert getattr(got, axis) == getattr(want, axis), axis


@pytest.mark.parametrize(
    "bad,match",
    [
        ("bogus=2", "unknown mesh axis"),
        ("fsdp", "integer size"),
        ("fsdp=", "integer size"),
        ("dp=2,dp=4", "duplicate"),
        ("fsdp=-1", "sizes must be >= 1"),
        ("fsdp=0", "sizes must be >= 1"),
        ("dp=0", "sizes must be >= 1"),
        ("dp=-2", "sizes must be >= 1"),
    ],
)
def test_parse_mesh_spec_rejects_as_the_reference(bad, match):
    with pytest.raises(ValueError, match=match):
        ref_mesh.parse_mesh_spec(bad)
    with pytest.raises(ValueError, match=match):
        port_mesh.parse_mesh_spec(bad)


@pytest.mark.parametrize("config,n", [
    (dict(fsdp=4), 8), (dict(dp=2, tp=2, ep=2), 8), (dict(), 8),
    (dict(dp=1, fsdp=8), 8), (dict(tp=4), 4)])
def test_resolve_matches_reference(config, n):
    import jax

    want = ref_mesh.MeshConfig(**config, devices=jax.devices()[:n])
    assert port_mesh.MeshConfig(**config).resolve(n) == tuple(
        want.resolve()[:6])


@pytest.mark.parametrize("config", [dict(fsdp=3), dict(dp=3, fsdp=2),
                                    dict(tp=0), dict(dp=0)])
def test_resolve_rejects_as_the_reference(config):
    with pytest.raises(ValueError):
        ref_mesh.MeshConfig(**config).resolve(num_devices=8)
    with pytest.raises(ValueError):
        port_mesh.MeshConfig(**config).resolve(8)


def test_build_mesh_without_a_group_says_how_to_start_one():
    with pytest.raises(RuntimeError, match="init_process_group"):
        port_mesh.build_mesh(port_mesh.MeshConfig())
    with pytest.raises(RuntimeError, match="init_process_group"):
        port_mesh.MeshConfig().resolve()


def test_abstract_mesh_has_the_shape_and_no_groups():
    mesh = port_mesh.abstract_mesh(port_mesh.parse_mesh_spec("fsdp=4"), 8)
    assert mesh.shape == dict(dp=2, fsdp=4, pp=1, tp=1, sp=1, ep=1)
    assert port_mesh.data_parallel_size(mesh) == 8
    assert mesh.group("tp") is None  # size 1: nothing to reduce
    with pytest.raises(RuntimeError):
        mesh.group("fsdp")


def test_mesh_over_eight_ranks(tmp_path):
    """The mesh spans the 8 ranks of the default group: dp absorbs 8/4
    as the reference's build_mesh does on 8 devices, rank r sits at the
    C-order coordinates of r, each set of axes has its group, and the
    batch's blocks go rank by rank over (dp, fsdp)."""
    import jax

    want = ref_mesh.build_mesh(ref_mesh.parse_mesh_spec("fsdp=4"),
                               num_devices=8)
    results = run_ranks(8, "mesh_scenario", tmp_path)
    x = np.arange(48.0).reshape(16, 3)
    for rank, out in enumerate(results):
        assert out["shape"] == dict(want.shape)
        assert out["data_parallel_size"] == ref_mesh.data_parallel_size(
            want) == 8
        assert out["coords"] == dict(zip(port_mesh.AXES, np.unravel_index(
            rank, tuple(want.shape.values()))))
        assert out["group_sizes"] == {"dp": 2, "fsdp": 4,
                                      ("dp", "fsdp"): 8}
        np.testing.assert_array_equal(out["block"], x[2 * rank:2 * rank + 2])
        np.testing.assert_array_equal(out["gathered"], x)
        np.testing.assert_array_equal(out["replicated"], x)
        assert out["shape2"] == dict(dp=2, fsdp=1, pp=1, tp=2, sp=1, ep=2)
        dp, tp, ep = (out["coords2"][a] for a in ("dp", "tp", "ep"))
        ranks = np.arange(8).reshape(2, 2, 2)  # (dp, tp, ep)
        assert out["sum_tp_ep"] == ranks[dp].sum()
        assert out["sum_dp_ep"] == ranks[:, tp, :].sum()
        assert out["sum_dp_tp_ep"] == 28
        assert "not divisible" in out["not_divisible"]
        assert "spans" in out["num_devices"]
    assert len(jax.devices()) >= 8

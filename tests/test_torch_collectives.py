"""The port's mesh collectives (elasticdl_tpu_torch/parallel/
collectives.py) over 4 gloo ranks (tests/torch_ranks.py), against the
reference's contract (tests/test_dense_plane.py's collective tests).

- mesh_psum's gradient taken through it is the identity: the value and
  gradient are held against jax.value_and_grad of the unsharded
  function (the reference test's own oracle). A second all-reduce of
  the gradient, torch.distributed.nn.functional.all_reduce's, would give
  4 times it.
- The reference's test_mesh_pmean_and_gather_scatter_roundtrip fails
  under jax 0.9.0 (a known failure of the JAX package's own suite), so
  the port's copy of it is held against numpy.
- The ring-cost accounting and its nesting mirror the reference's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tests.torch_ranks import run_ranks

WORLD = 4


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return run_ranks(WORLD, "collectives_scenario",
                     tmp_path_factory.mktemp("collectives"))


def test_mesh_psum_value_and_gradient_match_reference(results):
    def reference(w_, x_):
        return jnp.sum(jnp.sum(w_ * x_) ** 2)

    w = jnp.arange(4, dtype=jnp.float32) + 1.0  # shards 1, 2, 3, 4
    value, grad = jax.value_and_grad(reference)(w, jnp.ones(()))
    for rank, out in enumerate(results):
        np.testing.assert_allclose(out["psum_value"], float(value))
        np.testing.assert_allclose(out["psum_grad"], [float(grad[rank])])
        # the N-times-too-large gradient of a second all-reduce
        assert out["psum_grad"][0] != WORLD * float(grad[rank])


def test_pmean_and_gather_scatter_roundtrip(results):
    full = np.arange(8, dtype=np.float32).reshape(4, 2)
    for rank, out in enumerate(results):
        np.testing.assert_allclose(out["pmean"],
                                   full.sum(0, keepdims=True) / 4.0)
        # the four scalings sum to 10; rank r keeps block r
        total = 10.0 * np.arange(8, dtype=np.float32)
        np.testing.assert_allclose(out["scattered"],
                                   total[2 * rank:2 * rank + 2])
        np.testing.assert_allclose(out["gathered"], total)
        m = 10.0 * np.arange(24, dtype=np.float32).reshape(3, 8)
        np.testing.assert_allclose(out["scattered_dim1"],
                                   m[:, 2 * rank:2 * rank + 2])


def test_gather_and_scatter_gradients_are_each_others_transpose(results):
    for rank, out in enumerate(results):
        # all-gather backward: the ranks' cotangents (r + 1) summed onto
        # this rank's block
        np.testing.assert_allclose(out["all_gather_grad"], [10.0, 10.0])
        # reduce-scatter backward: every rank's block cotangent gathered
        np.testing.assert_allclose(out["reduce_scatter_grad"],
                                   np.repeat([1.0, 2.0, 3.0, 4.0], 2))


def test_replicate_and_gather_replicated_gradients(results):
    for rank, out in enumerate(results):
        # each rank's partial gradient (r + 1) all-reduced
        np.testing.assert_allclose(out["replicate_grad"], [10.0] * 3)
        np.testing.assert_allclose(out["gather_replicated"],
                                   np.repeat(np.arange(4.0), 2))
        # the whole gradient is on every rank: its own block, not a sum
        np.testing.assert_allclose(out["gather_replicated_grad"],
                                   [2.0 * rank, 2.0 * rank + 1])


def test_track_collective_bytes_ring_costs(results):
    ring = 128 * 3 // 4
    for out in results:
        all_reduce, reduce_scatter, all_gather, total, calls, kinds = (
            out["bytes"])
        assert all_reduce == 2 * ring
        assert reduce_scatter == ring
        assert all_gather == ring
        assert total == 4 * ring
        assert calls == 3
        assert kinds == {"all_reduce": 1, "reduce_scatter": 1,
                         "all_gather": 1}


def test_track_collective_bytes_nested_and_size1_axis(results):
    for out in results:
        inner_total, inner_calls, same = out["size1"]
        assert inner_total == 0 and inner_calls == 0
        np.testing.assert_array_equal(same, np.ones(4))
        # the outer block sees the dp all-reduce of 16 bytes
        assert out["outer"] == (2 * (16 * 3 // 4), 1)
        np.testing.assert_array_equal(out["no_mesh"], [3.0, 3.0])

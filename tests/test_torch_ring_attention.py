"""The port's ring and Ulysses attention (elasticdl_tpu_torch/ops/
ring_attention.py) over 8 gloo ranks at dp2*sp4 (tests/torch_ranks.py)
against the reference's on the 8-device CPU mesh: tests/test_attention_
ops.py's ring, Ulysses and flash-ring scenarios, on the same numpy
inputs, forward and gradients, causal and not.

Each rank runs its block (rows over dp, the sequence over sp) and the
blocks are put together here. The flash fold runs the plain versions of
K4-K6 on the CPU (the kernels run on the card, chip_smoke.py); the
reference's flash ring runs its Pallas kernel in interpret mode.
Tolerances are the reference tests' own: 2e-5 for the einsum ring and
Ulysses against full attention, 3e-5 for the flash ring's forward and
5e-4 for its gradients; the port against the reference's same schedule
holds the same bounds.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from elasticdl_tpu.ops.attention import xla_attention
from elasticdl_tpu.ops.ring_attention import (
    ring_attention,
    ulysses_attention,
)
from elasticdl_tpu.parallel.mesh import MeshConfig, build_mesh
from tests.torch_ranks import run_ranks


def _inputs(batch=2, heads=2, seq=256, dim=64, seed=0):
    rng = np.random.RandomState(seed)
    shape = (batch, heads, seq, dim)
    mk = lambda: rng.normal(size=shape, scale=0.5).astype(np.float32)
    return mk(), mk(), mk()


# name -> (kind, block_impl, causal, loss, inputs)
CASES = {
    **{"ring_%s" % c: ("ring", "einsum", c, None, dict(seq=64, dim=16))
       for c in (False, True)},
    "ring_grad": ("ring", "einsum", True, "square", dict(seq=32, dim=8)),
    **{"ulysses_%s" % c: ("ulysses", None, c, "square",
                          dict(heads=4, seq=64, dim=16))
       for c in (False, True)},
    **{"flash_%s" % c: ("ring", "flash", c, None, dict(seq=256, dim=32))
       for c in (False, True)},
    **{"flash_grad_%s" % c: ("ring", "flash", c, "cos",
                             dict(seq=256, dim=32, seed=5))
       for c in (False, True)},
    "agree_flash": ("ring", "flash", True, None,
                    dict(seq=256, dim=32, seed=9)),
    "agree_einsum": ("ring", "einsum", True, None,
                     dict(seq=256, dim=32, seed=9)),
}
# the ring of one reuses ring_grad's inputs under this name
CASES["grad"] = CASES["ring_grad"]


def _loss(kind):
    if kind == "square":
        return lambda o: jnp.sum(jnp.square(o))
    return lambda o: jnp.sum(o * jnp.cos(o))


def _reference(name, mesh):
    """The reference's output (and q, k, v gradients) of ``name``."""
    kind, impl, causal, loss, shape = CASES[name]
    q, k, v = (jnp.asarray(a) for a in _inputs(**shape))
    if kind == "ring":
        fn = lambda q, k, v: ring_attention(
            q, k, v, mesh, causal=causal, block_impl=impl, interpret=True)
    else:
        fn = lambda q, k, v: ulysses_attention(q, k, v, mesh, causal=causal)
    out = {"out": np.asarray(jax.jit(fn)(q, k, v)),
           "oracle": np.asarray(xla_attention(q, k, v, causal=causal))}
    if loss is not None:
        grads = jax.jit(jax.grad(lambda *a: _loss(loss)(fn(*a)),
                                 argnums=(0, 1, 2)))(q, k, v)
        oracle = jax.grad(
            lambda *a: _loss(loss)(xla_attention(*a, causal=causal)),
            argnums=(0, 1, 2))(q, k, v)
        out["grads"] = [np.asarray(g) for g in grads]
        out["oracle_grads"] = [np.asarray(g) for g in oracle]
    return out


def _whole(results, name, key, index=None):
    """The rank blocks of ``results[r][name][key]`` put together over
    (dp, sp): rank r is dp r // 4, sp r % 4."""
    rows = []
    for i in range(2):
        blocks = []
        for j in range(4):
            value = results[i * 4 + j][name][key]
            blocks.append(value if index is None else value[index])
        rows.append(np.concatenate(blocks, axis=2))
    return np.concatenate(rows, axis=0)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cases = {name: (kind, impl, causal, loss, *_inputs(**shape))
             for name, (kind, impl, causal, loss, shape) in CASES.items()}
    # the ranks run while the reference computes here
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(run_ranks, 8,
                            "tests.torch_ranks_longctx:ring_scenario",
                            tmp_path_factory.mktemp("ring"), timeout=180,
                            cases=cases)
        mesh = build_mesh(MeshConfig(dp=2, sp=4))
        reference = {name: _reference(name, mesh) for name in CASES
                     if name != "grad"}
        return ranks.result(), reference


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_matches_reference(runs, causal):
    results, ref = runs
    name = "ring_%s" % causal
    got = _whole(results, name, "out")
    np.testing.assert_allclose(got, ref[name]["out"], atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(got, ref[name]["oracle"], atol=2e-5,
                               rtol=2e-5)


def test_ring_attention_grads_match_reference(runs):
    results, ref = runs
    for i in range(3):
        got = _whole(results, "ring_grad", "grads", i)
        np.testing.assert_allclose(got, ref["ring_grad"]["grads"][i],
                                   atol=2e-5, rtol=2e-5)
        np.testing.assert_allclose(got, ref["ring_grad"]["oracle_grads"][i],
                                   atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_ulysses_attention_matches_reference(runs, causal):
    results, ref = runs
    name = "ulysses_%s" % causal
    got = _whole(results, name, "out")
    np.testing.assert_allclose(got, ref[name]["out"], atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(got, ref[name]["oracle"], atol=2e-5,
                               rtol=2e-5)
    for i in range(3):
        np.testing.assert_allclose(_whole(results, name, "grads", i),
                                   ref[name]["grads"][i], atol=2e-5,
                                   rtol=2e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_ring_matches_reference(runs, causal):
    results, ref = runs
    name = "flash_%s" % causal
    got = _whole(results, name, "out")
    np.testing.assert_allclose(got, ref[name]["out"], atol=3e-5, rtol=3e-5)
    np.testing.assert_allclose(got, ref[name]["oracle"], atol=3e-5,
                               rtol=3e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_ring_grads_match_reference(runs, causal):
    results, ref = runs
    name = "flash_grad_%s" % causal
    for i in range(3):
        got = _whole(results, name, "grads", i)
        np.testing.assert_allclose(got, ref[name]["grads"][i], atol=5e-4,
                                   rtol=5e-4)
        np.testing.assert_allclose(got, ref[name]["oracle_grads"][i],
                                   atol=5e-4, rtol=5e-4)


def test_flash_ring_agrees_with_einsum_ring(runs):
    results, ref = runs
    a = _whole(results, "agree_flash", "out")
    b = _whole(results, "agree_einsum", "out")
    np.testing.assert_allclose(a, b, atol=3e-5, rtol=3e-5)
    np.testing.assert_allclose(a, ref["agree_flash"]["out"], atol=3e-5,
                               rtol=3e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_ring_calls_by_the_causal_formula(runs, causal):
    """The flash fold calls K4 (forward) and K5/K6 (backward) once a
    block it computes: under the causal mask rank r of sp calls r + 1
    each way (no call for a block after its positions), else sp; the
    einsum fold and Ulysses call neither."""
    results, _ = runs
    for out in results:
        want = out["sp_index"] + 1 if causal else 4
        assert out["flash_grad_%s" % causal]["calls"] == {"fwd": want,
                                                         "bwd": want}
        assert out["flash_%s" % causal]["calls"] == {"fwd": want, "bwd": 0}
        assert out["ring_%s" % causal]["calls"] == {"fwd": 0, "bwd": 0}


def test_hops_record_their_bytes(runs):
    """Each ring step's k/v hop records the bytes the rank sends (3
    hops forward of k and v; backward 3 of k, v, dk, dv and the last of
    dk, dv); Ulysses records its all-to-alls."""
    results, _ = runs
    for out in results:
        # flash_grad: (2 * 1 * 64 * 32) fp32 blocks of 8 KiB each
        block = 1 * 2 * 64 * 32 * 4
        rec = out["flash_grad_True"]["bytes"]
        assert rec["ppermute"] == block * (3 * 2 + 3 * 4 + 2)
        assert rec["hops"] == 3 + 4
        assert out["ulysses_True"]["bytes"]["all_to_all"] > 0
        assert out["ulysses_True"]["bytes"]["ppermute"] == 0


def test_ring_of_one_is_dot_product_attention(runs):
    """At sp 1 the ring is dot_product_attention: "auto" the default
    attention (the flash plain version on the CPU), "einsum" the plain
    ("xla") attention, as the reference maps block_impl there."""
    results, ref = runs
    for out in results:
        sp1 = out["sp1"]
        np.testing.assert_array_equal(sp1["ring"], sp1["dot"])
        np.testing.assert_array_equal(sp1["einsum"], sp1["xla"])
        np.testing.assert_allclose(sp1["ring"], ref["ring_grad"]["oracle"],
                                   atol=2e-5, rtol=2e-5)


def test_collectives_follow_jax_semantics(runs):
    """mesh_ppermute: rank j's value at rank j + 1 (zeros where no pair
    sends), the gradient back by the inverse permutation;
    mesh_all_to_all: block j of dim 0 to rank j, joined along dim 1 in
    rank order, the gradient by the swapped all-to-all."""
    results, _ = runs
    for rank, out in enumerate(results):
        dp, i = divmod(rank, 4)
        got = out["collectives"]
        src = dp * 4 + (i - 1) % 4
        np.testing.assert_array_equal(got["shifted"], np.full((2, 3), src))
        # rank i's x went to rank i + 1, which scaled it by i + 2
        np.testing.assert_array_equal(got["shift_grad"],
                                      np.full((2, 3), (i + 1) % 4 + 1))
        want = np.full(2, float(dp * 4)) if i == 1 else np.zeros(2)
        np.testing.assert_array_equal(got["partial"], want)
        blocks = [np.arange(8.0).reshape(4, 2)[i:i + 1] + 100 * j
                  for j in range(4)]
        np.testing.assert_array_equal(got["a2a"], np.concatenate(blocks, 1))
        weights = np.arange(8.0).reshape(4, 2)
        np.testing.assert_array_equal(got["a2a_grad"],
                                      np.broadcast_to(weights[i], (4, 2)))
        assert "divisible by sp (4)" in out["ulysses_heads_error"]


def test_byte_tracking_takes_other_threads_records():
    """Autograd runs the backward of CUDA work on a device thread of its
    own: a hop recorded on another thread (the ring's and the pipeline's
    backward on the card) lands in the accumulator of the block that the
    waiting thread has open."""
    import threading

    import torch

    from elasticdl_tpu_torch.parallel import collectives

    block = torch.zeros((2, 8), dtype=torch.float32)
    with collectives.track_collective_bytes() as acc:
        other = threading.Thread(target=collectives.record_hop,
                                 args=([block], 2))
        other.start()
        other.join()
    assert acc.ppermute == block.numel() * block.element_size()
    assert acc.calls == 1

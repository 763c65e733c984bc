"""The port's device-tier ops (K1 gather-merge, K2 insert rows, K3
scatter-apply) against the JAX package's, on the CPU.

On CPU tensors each wrapper runs its kernel's plain version; these
tests hold that plain version to the reference on the same numpy-made
state, twice: against the reference's jnp path and against its Pallas
kernels run in interpret mode (``tier_ops.INTERPRET = True``, as the
reference's own tests run them). The kernels themselves are held to
the plain versions on the card (tests/test_torch_cuda_kernels.py,
chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticdl_tpu.ops import embedding_tier as ref_ops
from elasticdl_tpu_torch.ops import embedding_tier as tier
from elasticdl_tpu_torch.ps.embedding_store import NumpyEmbeddingStore

torch.set_num_threads(1)

KERNELS = ["jnp", "pallas"]
OPTS = ["sgd", "momentum", "nesterov", "adagrad", "adam"]
ALLOC = 9          # 8 usable slots + the scratch row
SCRATCH = ALLOC - 1
# K3's plain version against the reference, every row but scratch: the
# same fp32 operations in the same order (against the jnp path they
# agree bit for bit here), but XLA may fuse the Pallas-interpret
# kernel's elementwise chain and libm's pow may differ by an ulp, so a
# few fp32 ulps: relative 1e-6, absolute 1e-7 near zero.
APPLY_RTOL, APPLY_ATOL = 1e-6, 1e-7


@pytest.fixture
def interpret(request):
    """Run the reference's Pallas kernels in interpret mode for
    kernel="pallas"."""
    old = ref_ops.INTERPRET
    ref_ops.INTERPRET = True
    yield
    ref_ops.INTERPRET = old


def _rand_state(rng, dim, opt_type):
    """The same random state as a reference (jnp) and a port (torch)
    dict."""
    state = {"rows": rng.rand(ALLOC, dim).astype(np.float32)}
    for k in range(tier.TIER_OPT_SLOTS[opt_type]):
        state["slot%d" % k] = rng.rand(ALLOC, dim).astype(np.float32) * 0.1
    state["steps"] = rng.randint(0, 4, ALLOC).astype(np.int32)
    ref = {k: jnp.asarray(v) for k, v in state.items()}
    port = {k: torch.from_numpy(v.copy()) for k, v in state.items()}
    return ref, port


def _np(x):
    return np.asarray(x)


@pytest.mark.parametrize("dim", [1, 8])
@pytest.mark.parametrize("kernel", KERNELS)
def test_insert_gather_matches_reference(kernel, dim, interpret):
    rng = np.random.RandomState(0)
    ref, port = _rand_state(rng, dim, "adam")
    slots = np.array([0, 3, -1, 5, -1, 7], np.int32)
    miss = rng.rand(6, dim).astype(np.float32)
    ins = np.array([7, SCRATCH, 2], np.int32)   # padded with scratch
    ins_rows = rng.rand(3, dim).astype(np.float32)
    evict = np.array([7, 1, SCRATCH], np.int32)
    want_state, want_combined, want_evicted = ref_ops.fused_insert_gather(
        ref, jnp.asarray(ins), jnp.asarray(ins_rows), jnp.asarray(evict),
        jnp.asarray(slots), jnp.asarray(miss), kernel=kernel,
    )
    before = (tier.GATHER_LAUNCHES, tier.SET_ROWS_LAUNCHES)
    got_state, combined, evicted = tier.fused_insert_gather(
        port, *(torch.from_numpy(a) for a in (ins, ins_rows, evict, slots,
                                              miss)),
    )
    # the CPU path runs the plain versions: no kernel launched
    assert (tier.GATHER_LAUNCHES, tier.SET_ROWS_LAUNCHES) == before
    assert got_state is port  # updated in place
    # data movement: bit for bit
    np.testing.assert_array_equal(combined.numpy(), _np(want_combined))
    # the scratch victim reads garbage by contract (the reference's two
    # paths differ there); the real victims are compared
    np.testing.assert_array_equal(evicted.numpy()[:2], _np(want_evicted)[:2])
    # the insert of slot 7 landed after its old value was read out
    np.testing.assert_array_equal(evicted.numpy()[0], _np(ref["rows"])[7])
    for key in want_state:
        np.testing.assert_array_equal(
            got_state[key].numpy()[:SCRATCH], _np(want_state[key])[:SCRATCH],
            err_msg=key)


@pytest.mark.parametrize("dim", [1, 8])
@pytest.mark.parametrize("opt_type", OPTS)
@pytest.mark.parametrize("kernel", KERNELS)
def test_insert_rows_matches_reference(kernel, opt_type, dim, interpret):
    """K2's plain version inserts a staging chunk into the whole table
    state as the reference's insert-gather does (weights, every slot
    buffer and the step counts), bit for bit on every row but scratch."""
    rng = np.random.RandomState(3)
    ref, port = _rand_state(rng, dim, opt_type)
    ins = np.array([6, SCRATCH, 2, 4], np.int32)   # padded with scratch
    ins_rows = rng.rand(4, dim).astype(np.float32)
    evict = np.array([6, 1], np.int32)
    slots = np.array([0, -1, 2], np.int32)
    miss = rng.rand(3, dim).astype(np.float32)
    want, _, _ = ref_ops.fused_insert_gather(
        ref, *(jnp.asarray(a) for a in (ins, ins_rows, evict, slots, miss)),
        kernel=kernel,
    )
    before = tier.SET_ROWS_LAUNCHES
    assert tier.insert_rows(port, torch.from_numpy(ins),
                            torch.from_numpy(ins_rows)) is port
    # the CPU path runs the plain version: no kernel launched
    assert tier.SET_ROWS_LAUNCHES == before
    assert sorted(port) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(
            port[key].numpy()[:SCRATCH], _np(want[key])[:SCRATCH],
            err_msg=key)
    # the inserted slots really changed: weights, zeroed state
    np.testing.assert_array_equal(port["rows"].numpy()[[6, 2, 4]],
                                  ins_rows[[0, 2, 3]])
    assert port["steps"].numpy()[[6, 2, 4]].tolist() == [0, 0, 0]


def test_insert_rows_skips_slots_outside_the_table():
    """As K2 on the card: a negative slot or one past the table's end is
    skipped in every buffer."""
    state = tier.init_table_state(4, 2, "adam")
    for key in ("rows", "slot0", "slot1"):
        state[key].fill_(7.0)
    state["steps"].fill_(5)
    tier.insert_rows(state, torch.tensor([-1, 1, 4], dtype=torch.int32),
                     torch.ones(3, 2))
    np.testing.assert_array_equal(state["rows"].numpy(),
                                  [[7, 7], [1, 1], [7, 7], [7, 7]])
    for key in ("slot0", "slot1"):
        np.testing.assert_array_equal(state[key].numpy()[:, 0],
                                      [7, 0, 7, 7])
    assert state["steps"].tolist() == [5, 0, 5, 5]


@pytest.mark.parametrize("opt_type", OPTS)
@pytest.mark.parametrize("kernel", KERNELS)
def test_scatter_apply_matches_reference(kernel, opt_type, interpret):
    rng = np.random.RandomState(1)
    dim = 8
    ref, port = _rand_state(rng, dim, opt_type)
    slots = np.array([0, 3, -1, 5, -1], np.int32)
    for step in range(3):  # slot state and step counts carry over
        grads = rng.randn(5, dim).astype(np.float32)
        ref = ref_ops.fused_scatter_apply(
            ref, jnp.asarray(slots), jnp.asarray(grads), opt_type=opt_type,
            lr=0.05, kernel=kernel,
        )
        before = tier.SCATTER_APPLY_LAUNCHES
        assert tier.fused_scatter_apply(
            port, torch.from_numpy(slots), torch.from_numpy(grads),
            opt_type=opt_type, lr=0.05) is port
        assert tier.SCATTER_APPLY_LAUNCHES == before
    np.testing.assert_array_equal(port["steps"].numpy()[:SCRATCH],
                                  _np(ref["steps"])[:SCRATCH])
    for key in port:
        if key == "steps":
            continue
        np.testing.assert_allclose(
            port[key].numpy()[:SCRATCH], _np(ref[key])[:SCRATCH],
            rtol=APPLY_RTOL, atol=APPLY_ATOL, err_msg=key)


@pytest.mark.parametrize("kernel", KERNELS)
def test_gather_rows_matches_reference(kernel, interpret):
    rng = np.random.RandomState(2)
    ref, port = _rand_state(rng, 8, "sgd")
    slots = np.array([4, 0, 7, SCRATCH], np.int32)
    want = ref_ops.gather_rows(ref, jnp.asarray(slots), kernel=kernel)
    got = tier.gather_rows(port, torch.from_numpy(slots))
    np.testing.assert_array_equal(got.numpy(), _np(want))
    # a copy: later in-place updates of the table do not reach it
    port["rows"].zero_()
    np.testing.assert_array_equal(got.numpy(), _np(want))


def test_plain_versions_edge_cases():
    """Negative slots read the miss row (zeros without a miss buffer);
    K2 skips slots outside the table; the scratch row absorbs misses in
    K3."""
    table = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    slots = torch.tensor([2, -1, 0], dtype=torch.int32)
    out = tier.gather_merge(table, slots)
    np.testing.assert_array_equal(out.numpy(), [[6, 7, 8], [0, 0, 0],
                                                [0, 1, 2]])
    tier.set_rows(table, torch.tensor([-1, 1, 9], dtype=torch.int32),
                  torch.ones(3, 3))
    np.testing.assert_array_equal(table[1].numpy(), [1, 1, 1])
    np.testing.assert_array_equal(table[0].numpy(), [0, 1, 2])
    state = tier.init_table_state(4, 3, "sgd")
    tier.fused_scatter_apply(state, torch.tensor([-1, 0], dtype=torch.int32),
                             torch.ones(2, 3), opt_type="sgd", lr=0.5)
    np.testing.assert_array_equal(state["rows"][0].numpy(), [-0.5] * 3)
    assert state["steps"].tolist() == [1, 0, 0, 1]
    with pytest.raises(ValueError):
        tier.init_table_state(4, 3, "amsgrad")
    with pytest.raises(ValueError):
        tier.fused_scatter_apply(state, slots, torch.ones(3, 3),
                                 opt_type="rmsprop")


@pytest.mark.parametrize("opt_type", ["sgd", "momentum", "nesterov",
                                      "adagrad", "adam"])
def test_scatter_apply_matches_store_math(opt_type):
    """The in-device optimizer step tracks the port's PS store's update
    math, so a row trains the same whichever tier holds it (the
    reference's test_jnp_scatter_apply_matches_store_math, on the
    port's own store). The store computes adam's bias correction in
    float64 and the tier in fp32: relative 1e-5."""
    rng = np.random.RandomState(1)
    dim, n = 6, 4
    store = NumpyEmbeddingStore(seed=0)
    store.set_optimizer(opt_type, lr=0.05)
    store.create_table("t", dim, init_scale=0.1)
    ids = np.arange(n, dtype=np.int64)
    init_rows = store.lookup("t", ids)  # materialize
    state = tier.init_table_state(n + 1, dim, opt_type)
    state["rows"][:n] = torch.from_numpy(init_rows)
    slots = torch.arange(n, dtype=torch.int32)
    for _ in range(3):  # multi-step: slot state + step counts
        grads = rng.rand(n, dim).astype(np.float32)
        store.push_gradients("t", ids, grads)
        tier.fused_scatter_apply(state, slots, torch.from_numpy(grads),
                                 opt_type=opt_type, lr=0.05)
    np.testing.assert_allclose(
        state["rows"].numpy()[:n], store.lookup("t", ids),
        rtol=1e-5, atol=1e-6,
    )


def test_cuda_wrappers_refuse_other_devices():
    """A tensor on neither the CPU nor a card is refused, not routed to
    the plain version."""
    table = torch.zeros(4, 3, device="meta")
    slots = torch.zeros(2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="device"):
        tier.gather_merge(table, slots)
    with pytest.raises(ValueError, match="device"):
        tier.set_rows(table, slots)
    with pytest.raises(ValueError, match="device"):
        tier.insert_rows(tier.init_table_state(4, 3, "adam", device="meta"),
                         slots, torch.zeros(2, 3, device="meta"))

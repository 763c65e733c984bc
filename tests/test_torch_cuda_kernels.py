"""The port's CUDA kernels on the card, against their plain versions.

These tests need an NVIDIA GPU and nvcc: they carry the ``cuda`` marker
and skip without a card. The file imports neither JAX nor the JAX
package, so it also runs on a machine that has only PyTorch (the
repo's tests/conftest.py imports JAX, hence ``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda_kernels.py
"""

import pytest
import torch

import chip_smoke
from elasticdl_tpu_torch.ops import attention
from elasticdl_tpu_torch.ops import flash_attention as flash

pytestmark = pytest.mark.cuda

# bf16: p and o round to bf16 at other points than in the plain version
# (one bf16 ulp of O(1) values is 2^-8); fp32: summation order only
O_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
LSE_TOL = 1e-3


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _qkv(card, bh, seq, dim, dtype, seed=0):
    gen = torch.Generator(device=card).manual_seed(seed)
    return [
        torch.randn(bh, seq, dim, device=card, generator=gen).to(dtype)
        for _ in range(3)
    ]


# S across the bf16 kernel's 128-row query tiles and its key tiles (128
# keys, 64 at d 256: 63, 127, 128, 129) and several turns of its K/V ring
# (3 stages at d 64, 2 at d 128 and d 256: 640, 1000 and 2048 wrap it),
# ragged and not
@pytest.mark.parametrize("seq", [1, 63, 127, 128, 129, 200, 256, 640, 1000,
                                 2048])
@pytest.mark.parametrize("dim", [64, 128, 256])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_fwd_matches_plain_version(card, dtype, causal, dim, seq):
    q, k, v = _qkv(card, 6, seq, dim, dtype)
    before = flash.LAUNCHES
    o, lse = flash.flash_attention_fwd(q, k, v, causal=causal)
    ro, rlse = flash.flash_attention_fwd_reference(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash.LAUNCHES == before + 1
    assert o.dtype == dtype and lse.shape == (6, 1, seq)
    tol = O_TOL[dtype]
    torch.testing.assert_close(o.float(), ro.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(lse, rlse, atol=LSE_TOL, rtol=1e-5)


@pytest.mark.parametrize("dim", [64, 128, 256])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_fwd_bf16_launches_are_bit_equal(card, causal, dim):
    """No atomics and no split over keys: two launches on the same
    inputs give the same bits (the serve phase holds served answers
    bit-equal to predict on this)."""
    q, k, v = _qkv(card, 12, 1000, dim, torch.bfloat16, seed=3)
    o1, lse1 = flash.flash_attention_fwd(q, k, v, causal=causal)
    o2, lse2 = flash.flash_attention_fwd(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert torch.equal(o1, o2) and torch.equal(lse1, lse2)


@pytest.mark.parametrize("dim", [32, 96, 200])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_fwd_pads_head_dims_between_the_kernels(card, dtype, dim):
    """A head_dim the kernels are not built for runs through the next
    of 64, 128 and 256, zero-padded, in one launch."""
    q, k, v = _qkv(card, 6, 257, dim, dtype)
    before = flash.LAUNCHES
    o, lse = flash.flash_attention_fwd(q, k, v, causal=True)
    ro, rlse = flash.flash_attention_fwd_reference(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert flash.LAUNCHES == before + 1
    assert o.shape == q.shape and o.is_contiguous()
    tol = O_TOL[dtype]
    torch.testing.assert_close(o.float(), ro.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(lse, rlse, atol=LSE_TOL, rtol=1e-5)


@pytest.mark.parametrize("dim", [257, 320])
def test_flash_fwd_refuses_other_bf16_head_dims(card, dim):
    """Over 256, the kernels' widest instantiation, the wrapper raises
    and names the limit."""
    q, k, v = _qkv(card, 2, 64, dim, torch.bfloat16)
    before = flash.LAUNCHES
    with pytest.raises(ValueError, match="256"):
        flash.flash_attention_fwd(q, k, v, causal=True)
    assert flash.LAUNCHES == before


def test_flash_fwd_rejects_what_the_kernel_does_not_take(card):
    q, k, v = _qkv(card, 2, 64, 64, torch.float16)
    with pytest.raises(ValueError):
        flash.flash_attention_fwd(q, k, v)
    q, k, v = _qkv(card, 2, 64, 128, torch.bfloat16)
    strided = q[..., :64]  # not contiguous
    with pytest.raises(ValueError):
        flash.flash_attention_fwd(strided, k[..., :64], v[..., :64])


# S across the bf16 kernels' tiles (128 owned rows, 64 in K6 at d 256;
# streamed tiles of 128 rows at d 64, 64 at d 128, 32 at d 256: 63, 127,
# 128, 129) and several turns of their rings (640, 1000, 2048), ragged
# and not
@pytest.mark.parametrize("seq", [1, 63, 127, 128, 129, 200, 256, 640, 1000,
                                 2048])
@pytest.mark.parametrize("dim", [64, 128, 256])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_bwd_matches_plain_version(card, dtype, causal, dim, seq):
    q, k, v = _qkv(card, 6, seq, dim, dtype)
    (do,) = _qkv(card, 6, seq, dim, dtype, seed=1)[:1]
    o, lse = flash.flash_attention_fwd_reference(q, k, v, causal=causal)
    before = (flash.DQ_LAUNCHES, flash.DKV_LAUNCHES)
    grads = flash.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    refs = flash.flash_attention_bwd_reference(q, k, v, o, lse, do,
                                               causal=causal)
    torch.cuda.synchronize()
    assert (flash.DQ_LAUNCHES, flash.DKV_LAUNCHES) == (before[0] + 1,
                                                       before[1] + 1)
    for name, got, ref in zip(("dq", "dk", "dv"), grads, refs):
        assert got.dtype == dtype and got.shape == q.shape, name
        # chip_smoke.py's row rule: each row's error against its own size
        err, _ = chip_smoke.worst_row_error(got, ref, dim)
        assert err <= chip_smoke.GRAD_ROW_RTOL[str(dtype)[6:]], (name, err)
        if dtype == torch.float32:
            torch.testing.assert_close(got, ref, atol=1e-4, rtol=1e-4)


def _bwd_inputs(card, bh, seq, dim, causal, seed):
    q, k, v = _qkv(card, bh, seq, dim, torch.bfloat16, seed=seed)
    (do,) = _qkv(card, bh, seq, dim, torch.bfloat16, seed=seed + 1)[:1]
    o, lse = flash.flash_attention_fwd_reference(q, k, v, causal=causal)
    return q, k, v, o, lse, do


@pytest.mark.parametrize("dim", [64, 128, 256])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_bwd_bf16_launches_are_bit_equal(card, causal, dim):
    """Each gradient row has one owner and no atomics: two launches of K5
    and K6 on the same inputs give the same bits (ragged S, several
    turns of the rings)."""
    args = _bwd_inputs(card, 12, 1000, dim, causal, seed=3)
    first = flash.flash_attention_bwd(*args, causal=causal)
    second = flash.flash_attention_bwd(*args, causal=causal)
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(a, b), name


# K6 at d 256 walks 64-key work tiles over 32-query tiles in a ring of
# 4 stages, each tile's S^T / dP^T issued before the previous tile's dV
# and dK. (seq_q, seq_k) at the schedule's edges: work tiles walking one
# query tile (32 queries; 96 causal: the last key tile sees only its
# diagonal tile; 33: one real query in the second tile), two (64: the
# overlap's first tile is its last), exactly the ring's depth plus one
# (160), the ring across many turns (1000, 2048), fewer queries than
# keys with a key tile half seen under the causal mask (100 / 300: the
# keys from 100 on seen by no query, their rows exactly zero), and a
# ragged seq_q with every key seen (1000 / 384)
D256_K6_LENGTHS = [(32, 32), (96, 96), (33, 33), (64, 64), (160, 160),
                   (1000, 1000), (2048, 2048), (100, 300), (1000, 384)]


@pytest.mark.parametrize("seq_q,seq_k", D256_K6_LENGTHS,
                         ids=["q%d_k%d" % pair for pair in D256_K6_LENGTHS])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_bwd_d256_schedule_edges(card, causal, seq_q, seq_k):
    """K5 and K6 at d 256 in bf16 against the plain backward, row by row,
    and a second launch bit-equal to the first."""
    q, k, v, do = _unequal_inputs(card, 6, seq_q, seq_k, 256,
                                  torch.bfloat16, 21)
    o, lse = flash.flash_attention_fwd_reference(q, k, v, causal=causal)
    before = flash.DKV_LAUNCHES
    grads = flash.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    again = flash.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    refs = flash.flash_attention_bwd_reference(q, k, v, o, lse, do,
                                               causal=causal)
    torch.cuda.synchronize()
    assert flash.DKV_LAUNCHES == before + 2
    for name, got, ref, like, second in zip(("dq", "dk", "dv"), grads, refs,
                                            (q, k, v), again):
        assert got.shape == like.shape and got.dtype == torch.bfloat16, name
        err, _ = chip_smoke.worst_row_error(got, ref, 256)
        assert err <= chip_smoke.GRAD_ROW_RTOL["bfloat16"], (name, err)
        assert torch.equal(got, second), name
    if causal and seq_q < seq_k:
        _, dk, dv = grads
        assert not bool(dk[:, seq_q:].any() | dv[:, seq_q:].any())


@pytest.mark.parametrize("dim", [32, 96, 200])
def test_flash_bwd_pads_head_dims_between_the_kernels(card, dim):
    """K5 and K6 at a head_dim they are not built for: one launch each
    on zero-padded inputs, gradients sliced back, held row by row."""
    args = _bwd_inputs(card, 6, 257, dim, True, seed=0)
    before = (flash.DQ_LAUNCHES, flash.DKV_LAUNCHES)
    grads = flash.flash_attention_bwd(*args, causal=True)
    refs = flash.flash_attention_bwd_reference(*args, causal=True)
    torch.cuda.synchronize()
    assert (flash.DQ_LAUNCHES, flash.DKV_LAUNCHES) == (before[0] + 1,
                                                       before[1] + 1)
    for name, got, ref in zip(("dq", "dk", "dv"), grads, refs):
        assert got.shape == args[0].shape and got.is_contiguous(), name
        err, _ = chip_smoke.worst_row_error(got, ref, dim)
        assert err <= chip_smoke.GRAD_ROW_RTOL["bfloat16"], (name, err)


@pytest.mark.parametrize("dim", [257, 320])
def test_flash_bwd_refuses_other_bf16_head_dims(card, dim):
    args = _bwd_inputs(card, 2, 64, dim, True, seed=0)
    before = (flash.DQ_LAUNCHES, flash.DKV_LAUNCHES)
    with pytest.raises(ValueError, match="256"):
        flash.flash_attention_bwd(*args, causal=True)
    assert (flash.DQ_LAUNCHES, flash.DKV_LAUNCHES) == before


def test_flash_bwd_rejects_what_the_kernel_does_not_take(card):
    def args(dim, dtype):
        q, k, v = _qkv(card, 2, 64, dim, dtype)
        lse = torch.zeros(2, 1, 64, device=card)
        return q, k, v, q, lse, v

    with pytest.raises(ValueError):
        flash.flash_attention_bwd(*args(320, torch.bfloat16))
    with pytest.raises(ValueError):
        flash.flash_attention_bwd(*args(64, torch.float16))
    q, k, v, o, lse, do = args(128, torch.bfloat16)
    strided = [t[..., :64] for t in (q, k, v, o, do)]  # not contiguous
    with pytest.raises(ValueError):
        flash.flash_attention_bwd(*strided[:4], lse, strided[4])


def _unequal_inputs(card, bh, seq_q, seq_k, dim, dtype, seed):
    gen = torch.Generator(device=card).manual_seed(seed)
    return [torch.randn(bh, rows, dim, device=card, generator=gen).to(dtype)
            for rows in (seq_q, seq_k, seq_k, seq_q)]


# chip_smoke.py's unequal-length cases: fewer queries than keys (causal:
# key tiles past seq_q seen by no query), more queries than keys (rows
# past seq_k see every key), fp32, and a padded head_dim
@pytest.mark.parametrize("case", chip_smoke.UNEQUAL_CASES,
                         ids=lambda case: case[0])
def test_flash_unequal_lengths_match_plain_version(card, case):
    _, bh, seq_q, seq_k, dim, dtype_name, causal = case
    dtype = getattr(torch, dtype_name)
    q, k, v, do = _unequal_inputs(card, bh, seq_q, seq_k, dim, dtype, 11)
    before = (flash.LAUNCHES, flash.DQ_LAUNCHES, flash.DKV_LAUNCHES)
    o, lse = flash.flash_attention_fwd(q, k, v, causal=causal)
    grads = flash.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    again = flash.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    ro, rlse = flash.flash_attention_fwd_reference(q, k, v, causal=causal)
    refs = flash.flash_attention_bwd_reference(q, k, v, o, lse, do,
                                               causal=causal)
    torch.cuda.synchronize()
    assert (flash.LAUNCHES, flash.DQ_LAUNCHES, flash.DKV_LAUNCHES) == (
        before[0] + 1, before[1] + 2, before[2] + 2)
    tol = O_TOL[dtype]
    assert o.shape == q.shape and lse.shape == (bh, 1, seq_q)
    torch.testing.assert_close(o.float(), ro.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(lse, rlse, atol=LSE_TOL, rtol=0)
    for name, got, ref, like, second in zip(("dq", "dk", "dv"), grads, refs,
                                            (q, k, v), again):
        assert got.dtype == dtype and got.shape == like.shape, name
        err, _ = chip_smoke.worst_row_error(got, ref, dim)
        assert err <= chip_smoke.GRAD_ROW_RTOL[dtype_name], (name, err)
        assert torch.equal(got, second), name


@pytest.mark.parametrize("dim", [64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_bwd_keys_no_query_sees_are_zero(card, dtype, dim):
    """Causal, seq_q 200 < seq_k 1000: K6's key tiles past the queries
    walk no query tile and store dk and dv rows of exact zeros (the
    outputs are not zero-filled before the launch: the block the
    allocator hands them was NaN-filled)."""
    bh, seq_q, seq_k = 8, 200, 1000
    stale = torch.full((4, bh, seq_k, dim), float("nan"), dtype=dtype,
                       device=card)
    del stale
    q, k, v, do = _unequal_inputs(card, bh, seq_q, seq_k, dim, dtype, 12)
    o, lse = flash.flash_attention_fwd(q, k, v, causal=True)
    _, dk, dv = flash.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    torch.cuda.synchronize()
    assert not bool(dk[:, seq_q:].any() | dv[:, seq_q:].any())
    assert bool(torch.isfinite(dk).all() & torch.isfinite(dv).all())
    assert dk[:, :seq_q].abs().max().item() > 0


def test_flash_attention_grads_match_plain_attention(card):
    """FlashAttention's gradient (K5, K6) against autograd through the
    plain attention, both in fp32 on the card, with a non-contiguous
    output gradient as the model hands it over."""
    gen = torch.Generator(device=card).manual_seed(2)
    shape = (2, 3, 200, 64)
    leaves = [torch.randn(shape, device=card, generator=gen).requires_grad_()
              for _ in range(3)]
    weight = torch.randn(2, 200, 3, 64, device=card, generator=gen)
    before = (flash.LAUNCHES, flash.DQ_LAUNCHES, flash.DKV_LAUNCHES)
    out = attention.dot_product_attention(*leaves, causal=True)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    loss = (out.transpose(1, 2) * weight).sum()
    got = torch.autograd.grad(loss, leaves)
    plain = attention.xla_attention(*leaves, causal=True)
    expected = torch.autograd.grad(
        (plain.transpose(1, 2) * weight).sum(), leaves)
    torch.cuda.synchronize()
    assert (flash.LAUNCHES, flash.DQ_LAUNCHES, flash.DKV_LAUNCHES) == tuple(
        n + 1 for n in before)
    for a, b in zip(got, expected):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


def test_trainer_step_launches_the_kernels(card):
    """One bf16 TorchTrainer step at a small width: K4, K5 and K6 once
    per layer each, and a finite loss."""
    import numpy as np

    from elasticdl_tpu_torch.models import transformer
    from elasticdl_tpu_torch.train.optimizers import create_optimizer
    from elasticdl_tpu_torch.worker.trainer import TorchTrainer

    torch.manual_seed(0)
    model = transformer.TransformerLM(vocab_size=256, num_layers=2,
                                      num_heads=2, embed_dim=128)
    trainer = TorchTrainer(
        model, transformer.loss,
        create_optimizer("AdamW", learning_rate=1e-3),
        compute_dtype="bfloat16", health=False, device="cuda",
    )
    tokens = np.random.RandomState(0).randint(0, 256, size=(4, 128))
    batch = {"features": tokens.astype(np.int32),
             "labels": tokens.astype(np.int32),
             "_mask": np.ones(4, np.float32)}
    before = (flash.LAUNCHES, flash.DQ_LAUNCHES, flash.DKV_LAUNCHES)
    state, loss = trainer.train_step(None, batch)
    torch.cuda.synchronize()
    assert (flash.LAUNCHES, flash.DQ_LAUNCHES, flash.DKV_LAUNCHES) == tuple(
        n + 2 for n in before)
    assert state.step == 1 and bool(torch.isfinite(loss))


@pytest.mark.parametrize("dim", [64, 96, 256])
def test_auto_dispatch_launches_the_kernel_on_the_card(card, dim):
    """"auto" is the kernel path for every head_dim up to 256 (96 runs
    padded to 128), and matches the plain attention."""
    q, k, v = (t.view(2, 3, 128, dim) for t in _qkv(card, 6, 128, dim,
                                                     torch.bfloat16))
    before = flash.LAUNCHES
    out = attention.dot_product_attention(q, k, v, causal=True)
    assert flash.LAUNCHES == before + 1
    plain = attention.xla_attention(q, k, v, causal=True)
    torch.testing.assert_close(out.float(), plain.float(), atol=2e-2,
                               rtol=2e-2)
    # over 256 the kernel path raises: the plain attention runs on the
    # card only when asked for by name
    q320 = torch.randn(2, 3, 128, 320, device=card, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="256"):
        attention.dot_product_attention(q320, q320, q320, causal=True)
    attention.dot_product_attention(q320, q320, q320, causal=True,
                                    impl="xla")
    assert flash.LAUNCHES == before + 1


# ---------------------------------------------------------------------------
# device-tier kernels K1 (gather-merge), K2 (insert rows), K3 (scatter-apply)
# ---------------------------------------------------------------------------

TIER_DIMS = [1, 8, 13, 64]
TIER_OPTS = ["sgd", "momentum", "nesterov", "adagrad", "adam"]


def _tier_case(card, dim, rows=1025, n=300, seed=0, opt_type="adam"):
    """A random tier state on the card and n slots: unique hits with
    every fourth slot a miss (-1)."""
    import numpy as np

    from elasticdl_tpu_torch.ops import embedding_tier as tier

    rng = np.random.RandomState(seed)
    state = tier.init_table_state(rows, dim, opt_type, device=card)
    state["rows"].copy_(torch.from_numpy(rng.randn(rows, dim).astype(
        np.float32)))
    for key in state:
        if key.startswith("slot"):
            state[key].copy_(torch.from_numpy(
                rng.rand(rows, dim).astype(np.float32)))
    state["steps"].copy_(torch.from_numpy(
        rng.randint(0, 5, rows).astype(np.int32)))
    slots = rng.permutation(rows - 1)[:n].astype(np.int32)
    slots[::4] = -1
    return state, torch.from_numpy(slots).to(card), rng


@pytest.mark.parametrize("dim", TIER_DIMS)
def test_tier_gather_matches_plain_version(card, dim):
    from elasticdl_tpu_torch.ops import embedding_tier as tier

    state, slots, rng = _tier_case(card, dim)
    miss = torch.from_numpy(rng.randn(slots.shape[0], dim).astype(
        "float32")).to(card)
    before = tier.GATHER_LAUNCHES
    got = tier.gather_merge(state["rows"], slots, miss)
    zeros_miss = tier.gather_merge(state["rows"], slots)
    torch.cuda.synchronize()
    assert tier.GATHER_LAUNCHES == before + 2
    # K1 moves data: bit for bit
    assert torch.equal(got, tier.gather_merge_reference(
        state["rows"], slots, miss))
    assert torch.equal(zeros_miss, tier.gather_merge_reference(
        state["rows"], slots))
    # a column view is not contiguous: refused, not copied behind the back
    with pytest.raises(ValueError):
        tier.gather_merge(state["rows"], slots, torch.empty(
            slots.shape[0], dim + 1, device=card)[:, :dim])


def _k1_slots(rows, n, kind, rng):
    """n slots into a table of ``rows`` rows: unique hits, all misses, or
    a mix of hits, misses (-1) and slots at and past the table's end (the
    last row, a hit; ``rows`` and beyond, misses)."""
    import numpy as np

    if kind == "all_misses":
        return np.full(n, -1, np.int32)
    slots = rng.randint(0, rows, n).astype(np.int32)
    if kind == "all_hits":
        return slots
    slots[::3] = -1
    slots[1::7] = rows - 1
    slots[2::7] = rows
    slots[3::11] = rows + 1000
    return slots


@pytest.mark.parametrize("kind", ["all_hits", "all_misses", "mix"])
@pytest.mark.parametrize("n", [1, 1000, 8192 + 37])
@pytest.mark.parametrize("dim", [1, 4, 8, 12, 64])
def test_tier_gather_rows_lanes_and_edges(card, dim, n, kind):
    """K1 bit for bit with its plain version for one row, a count that
    fills no whole block and more than deepfm's 8192, all hits, all
    misses and a mix with slots at and past the table's end, with miss
    rows and with none (zeros); two launches bit-equal; one counted
    launch per call."""
    import numpy as np

    from elasticdl_tpu_torch.ops import embedding_tier as tier

    rng = np.random.RandomState(dim * 7 + n)
    rows = 1025
    table = torch.from_numpy(rng.randn(rows, dim).astype(np.float32)).to(
        card)
    slots = torch.from_numpy(_k1_slots(rows, n, kind, rng)).to(card)
    miss = torch.from_numpy(rng.randn(n, dim).astype(np.float32)).to(card)
    for miss_rows in (miss, None):
        before = tier.GATHER_LAUNCHES
        got = tier.gather_merge(table, slots, miss_rows)
        again = tier.gather_merge(table, slots, miss_rows)
        torch.cuda.synchronize()
        assert tier.GATHER_LAUNCHES == before + 2
        assert torch.equal(got, tier.gather_merge_reference(table, slots,
                                                            miss_rows))
        assert torch.equal(got, again)


@pytest.mark.parametrize("dim", [1, 8])
def test_tier_chain_reuses_victim_slots_in_order(card, dim):
    """The staging chunk's chain (K1 victims -> K2 insert -> K1 combined,
    the last two programmatic dependents) with every insert reusing a
    victim's slot, 100 runs each queued behind a sleep so the launches
    meet on the card: the victims' old rows, the inserted rows in the
    combined buffer and every state buffer equal the plain versions
    applied in order, bit for bit, in every run."""
    import numpy as np

    from elasticdl_tpu_torch.ops import embedding_tier as tier

    before = (tier.GATHER_LAUNCHES, tier.SET_ROWS_LAUNCHES)
    record = chip_smoke.chain_check(torch, np, tier, dim, reps=100)
    assert record["mismatches"] == 0
    assert (tier.GATHER_LAUNCHES - before[0],
            tier.SET_ROWS_LAUNCHES - before[1]) == (200, 100)


@pytest.mark.parametrize("dim", TIER_DIMS)
def test_tier_set_rows_matches_plain_version(card, dim):
    from elasticdl_tpu_torch.ops import embedding_tier as tier

    state, slots, rng = _tier_case(card, dim)
    scratch = state["rows"].shape[0] - 1
    slots = torch.where(slots < 0, scratch, slots).to(torch.int32)
    rows = torch.from_numpy(rng.randn(slots.shape[0], dim).astype(
        "float32")).to(card)
    for values in (rows, None):
        got, want = state["rows"].clone(), state["rows"].clone()
        before = tier.SET_ROWS_LAUNCHES
        assert tier.set_rows(got, slots, values) is got
        tier.set_rows_reference(want, slots, values)
        torch.cuda.synchronize()
        assert tier.SET_ROWS_LAUNCHES == before + 1
        # every row but the scratch row, whose racing writes are benign
        assert torch.equal(got[:scratch], want[:scratch])


@pytest.mark.parametrize("opt_type", TIER_OPTS)
@pytest.mark.parametrize("dim", TIER_DIMS)
def test_tier_insert_rows_matches_plain_version(card, dim, opt_type):
    """K2 inserts a chunk into the whole table state (weights, every
    slot buffer, the step counts) in one counted launch, bit for bit
    with its plain version on every row but scratch (the chunk is
    padded with it, and its racing writes are benign)."""
    from elasticdl_tpu_torch.ops import embedding_tier as tier

    state, slots, rng = _tier_case(card, dim, opt_type=opt_type)
    scratch = state["rows"].shape[0] - 1
    slots = torch.where(slots < 0, scratch, slots).to(torch.int32)
    rows = torch.from_numpy(rng.randn(slots.shape[0], dim).astype(
        "float32")).to(card)
    got = {k: v.clone() for k, v in state.items()}
    want = {k: v.clone() for k, v in state.items()}
    before = tier.SET_ROWS_LAUNCHES
    assert tier.insert_rows(got, slots, rows) is got
    tier.insert_rows_reference(want, slots, rows)
    torch.cuda.synchronize()
    assert tier.SET_ROWS_LAUNCHES == before + 1
    for key in want:
        assert torch.equal(got[key][:scratch], want[key][:scratch]), key
    # an empty chunk launches nothing
    tier.insert_rows(got, slots[:0], rows[:0])
    assert tier.SET_ROWS_LAUNCHES == before + 1


# K3 against its plain version: every row but scratch. Each operation
# rounds once in the same order on both sides (the kernel's _rn
# intrinsics forbid FMA contraction; sqrt and division are IEEE), so
# sgd, momentum, nesterov and adagrad agree bit for bit; adam's
# bias correction 1 - pow(beta, t) may differ by an fp32 ulp between
# the device's powf and torch's pow, which moves the row by a few ulps:
# relative 2e-6 on a value (absolute 1e-7 where it is near zero).
K3_RTOL, K3_ATOL = 2e-6, 1e-7


@pytest.mark.parametrize("opt_type", TIER_OPTS)
@pytest.mark.parametrize("dim", TIER_DIMS)
def test_tier_scatter_apply_matches_plain_version(card, dim, opt_type):
    from elasticdl_tpu_torch.ops import embedding_tier as tier

    state, slots, rng = _tier_case(card, dim, opt_type=opt_type)
    scratch = state["rows"].shape[0] - 1
    grads = torch.from_numpy(rng.randn(slots.shape[0], dim).astype(
        "float32")).to(card)
    got = {k: v.clone() for k, v in state.items()}
    want = {k: v.clone() for k, v in state.items()}
    before = tier.SCATTER_APPLY_LAUNCHES
    for _ in range(3):  # step counts carry from one launch to the next
        tier.scatter_apply(got, slots, grads, opt_type, 0.05, 0.9, 0.9,
                           0.999, 1e-8)
        tier.scatter_apply_reference(want, slots, grads, opt_type, 0.05,
                                     0.9, 0.9, 0.999, 1e-8)
    torch.cuda.synchronize()
    assert tier.SCATTER_APPLY_LAUNCHES == before + 3
    assert torch.equal(got["steps"][:scratch], want["steps"][:scratch])
    for key in got:
        if key == "steps":
            continue
        if opt_type == "adam":
            torch.testing.assert_close(got[key][:scratch],
                                       want[key][:scratch],
                                       rtol=K3_RTOL, atol=K3_ATOL)
        else:
            assert torch.equal(got[key][:scratch], want[key][:scratch]), key


def _k3_mix_slots(rows, n, kind, rng):
    """n slots: unique hits, all misses (-1), or hits with every third a
    miss; the hits leave some rows between them untouched."""
    import numpy as np

    if kind == "all_misses":
        return np.full(n, -1, np.int32)
    slots = rng.permutation(rows - 1)[:n].astype(np.int32)
    if kind == "mix":
        slots[::3] = -1
    return slots


@pytest.mark.parametrize("kind", ["all_hits", "all_misses", "mix"])
@pytest.mark.parametrize("opt_type", TIER_OPTS)
@pytest.mark.parametrize("dim", [1, 4, 8, 12])
def test_tier_scatter_apply_hits_and_misses(card, dim, opt_type, kind):
    """K3 on all hits, all misses and a mix: every row but scratch as the
    plain version leaves it, every row no hit names unchanged (a miss
    touches nothing), and the scratch row, where the plain version sends
    misses, left alone on the card."""
    from elasticdl_tpu_torch.ops import embedding_tier as tier

    state, _, rng = _tier_case(card, dim, rows=600, opt_type=opt_type)
    scratch = state["rows"].shape[0] - 1
    slots_np = _k3_mix_slots(600, 257, kind, rng)
    slots = torch.from_numpy(slots_np).to(card)
    grads = torch.from_numpy(rng.randn(257, dim).astype("float32")).to(card)
    got = {k: v.clone() for k, v in state.items()}
    want = {k: v.clone() for k, v in state.items()}
    tier.scatter_apply(got, slots, grads, opt_type, 0.05, 0.9, 0.9, 0.999,
                       1e-8)
    tier.scatter_apply_reference(want, slots, grads, opt_type, 0.05, 0.9,
                                 0.9, 0.999, 1e-8)
    torch.cuda.synchronize()
    untouched = torch.ones(scratch + 1, dtype=torch.bool, device=card)
    untouched[torch.from_numpy(slots_np[slots_np >= 0]).long().to(card)] = 0
    for key in got:
        if opt_type == "adam" and key != "steps":
            torch.testing.assert_close(got[key][:scratch],
                                       want[key][:scratch],
                                       rtol=K3_RTOL, atol=K3_ATOL)
        else:
            assert torch.equal(got[key][:scratch], want[key][:scratch]), key
        assert torch.equal(got[key][untouched], state[key][untouched]), key


def test_tier_kernels_refuse_what_they_do_not_take(card):
    from elasticdl_tpu_torch.ops import embedding_tier as tier

    state, slots, _ = _tier_case(card, 8)
    with pytest.raises(ValueError):  # int64 slots
        tier.gather_merge(state["rows"], slots.long())
    with pytest.raises(ValueError):  # fp16 table
        tier.set_rows(state["rows"].half(), slots)
    grads = torch.zeros(slots.shape[0], 8, device=card)
    with pytest.raises(ValueError):  # adam state handed to momentum
        tier.scatter_apply(state, slots, grads, "momentum", 0.1, 0.9, 0.9,
                           0.999, 1e-8)
    with pytest.raises(ValueError):  # int64 steps
        tier.insert_rows(dict(state, steps=state["steps"].long()), slots,
                         grads)


def test_sparse_trainer_tier_step_launches_the_kernels(card):
    """A short tier-on DeepFM run on the card (4 fields, batch 32,
    vocab 1000, tier capacity 256): every step launches K3 once per
    table, and K1/K2 as its combines require (K1 once for a table with
    nothing staged; per staging chunk, K1 once for the combined buffer
    and once more to read victims out if it has any, and K2 once, the
    whole table state, if it has promotions); losses are finite and the
    flush leaves every resident row in the store bit for bit."""
    import numpy as np

    from elasticdl_tpu_torch.models import deepfm
    from elasticdl_tpu_torch.ops import embedding_tier as tier
    from elasticdl_tpu_torch.ps.local_client import LocalPSClient
    from elasticdl_tpu_torch.train.device_tier import DeviceTierConfig
    from elasticdl_tpu_torch.train.sparse import SparseTrainer

    trainer = SparseTrainer(
        deepfm.custom_model(), deepfm.loss, deepfm.optimizer(),
        deepfm.sparse_embedding_specs(num_features=4, batch_size=32),
        LocalPSClient(seed=0, opt_type="adam", lr=0.01), seed=0,
        device_tier=DeviceTierConfig(capacity=256, promote_hits=2, ttl=100,
                                     stage_budget=64, opt_type="adam",
                                     opt_args={"lr": 0.01},
                                     writeback_steps=0),
        device="cuda",
    )
    rng = np.random.RandomState(0)
    state = None
    for _ in range(6):
        ids = rng.zipf(1.6, size=(32, 4)) % 1000
        batch = {"features": {"ids": ids.astype(np.int64)},
                 "labels": (ids.sum(1) % 2).astype(np.float32),
                 "_mask": np.ones(32, np.float32)}
        before = (tier.GATHER_LAUNCHES, tier.SET_ROWS_LAUNCHES,
                  tier.SCATTER_APPLY_LAUNCHES)
        stats0 = trainer.device_tier.stats()
        state, loss = trainer.train_step(state, batch)
        torch.cuda.synchronize()
        stats1 = trainer.device_tier.stats()
        gather_only = (stats1["gather_only_combines"]
                       - stats0["gather_only_combines"])
        chunks, inserts, evicts = (
            stats1[k] - stats0[k]
            for k in ("staged_chunks", "insert_chunks", "evict_chunks"))
        assert (tier.GATHER_LAUNCHES - before[0],
                tier.SET_ROWS_LAUNCHES - before[1],
                tier.SCATTER_APPLY_LAUNCHES - before[2]) == (
                    gather_only + chunks + evicts, inserts, 2)
        assert bool(torch.isfinite(loss))
    assert trainer.device_tier.stats()["hits"] > 0
    trainer.close()
    store = trainer.preparer._ps.store
    for table in ("deepfm_emb", "deepfm_linear"):
        ids, rows = trainer.device_tier.table_rows(table)
        assert ids.size > 0
        np.testing.assert_array_equal(rows, store.lookup(table, ids))

"""chip_smoke.py's phase 16 (heads of 256 and the CTR zoo), rehearsed on
the CPU at small sizes: bench.py's transformer configuration cut to 2
layers of 2 heads of 256 (d 512), S 64, with K4-K6 counted by wrapping
their plain versions (the CPU path counts no launch); its s16k_flash
step under remat "flash" at S 128; the CTR zoo at a small vocab and
data size, each check passing. Each check also fails on a planted
fault: K4 launched twice a layer, a CTR table the step leaves
unchanged, a CTR gradient twice its size on one side. What only the card can give (times, peak memory, the
profile) reads "not measured" here.
"""

import numpy as np
import pytest
import torch

import chip_smoke

# the suite runs in several worker processes at once: one intra-op
# thread per process keeps these small-shape tests from oversubscribing
# the host's cores under other files' timing-sensitive tests
torch.set_num_threads(1)

WIDTHS = dict(vocab_size=256, num_layers=2, num_heads=2, embed_dim=512)


def _counting(fwd_per_call):
    """A context that bumps the wrappers' launch counters on the CPU as
    the CUDA path does at each launch (K4 ``fwd_per_call`` times a call:
    more than 1 plants a fault)."""
    from contextlib import contextmanager

    from elasticdl_tpu_torch.ops import flash_attention as flash

    @contextmanager
    def counting():
        fwd, bwd = flash.flash_attention_fwd, flash.flash_attention_bwd

        def counted_fwd(*args, **kwargs):
            flash.LAUNCHES += fwd_per_call
            return fwd(*args, **kwargs)

        def counted_bwd(*args, **kwargs):
            flash.DQ_LAUNCHES += 1
            flash.DKV_LAUNCHES += 1
            return bwd(*args, **kwargs)

        flash.flash_attention_fwd = counted_fwd
        flash.flash_attention_bwd = counted_bwd
        try:
            yield flash
        finally:
            flash.flash_attention_fwd, flash.flash_attention_bwd = fwd, bwd

    return counting()


def test_bench_transformer_and_s16k_rehearse():
    with _counting(1) as flash:
        bench = chip_smoke.bench_lm_phase(
            torch, np, flash, device="cpu", widths=WIDTHS, seq=64, batch=2,
            warmup=1, windows=1, window_steps=1)
        record = bench["record"]
        assert record["head_dim"] == 256
        assert record["launches_per_step"] == [
            {"fwd": 2, "dq": 2, "dkv": 2}] * 2
        assert record["peak_mem_gb"] == "not measured"
        agreement = bench["agreement"]
        assert agreement["loss_abs_diff"] <= chip_smoke.TRAIN_LOSS_TOL
        assert agreement["grad_cosine"] >= chip_smoke.TRAIN_GRAD_COS
        assert (agreement["attn_leaf_worst_rel_l2"]
                <= chip_smoke.TRAIN_ATTN_LEAF_TOL)
        s16k = chip_smoke.s16k_phase(torch, np, flash, bench["flat"], WIDTHS,
                                     device="cpu", seq=128, steps=2)
    # remat "flash" saves K4's outputs: K4 once a layer, not twice
    assert s16k["launches_per_step"] == [{"fwd": 2, "dq": 2, "dkv": 2}] * 2
    assert all(np.isfinite(s16k["losses"]))


def test_bench_transformer_fails_on_a_wrong_launch_count():
    with _counting(2) as flash, pytest.raises(SystemExit,
                                              match="launches a step"):
        chip_smoke.bench_lm_phase(
            torch, np, flash, device="cpu", widths=WIDTHS, seq=64, batch=2,
            warmup=1, windows=1, window_steps=1)


def test_model_flops_at_bench_shapes():
    """The formula's counts (scripts/bench_transformer_mfu.py:72-81):
    43.5 TFLOP a step for bench.py's transformer, 89 for s16k_flash
    (fwd + bwd, no recompute)."""
    flops = chip_smoke.model_train_flops(2048, 10, 1024, 12, 32000)
    assert round(flops / 1e12, 1) == 43.5
    flops = chip_smoke.model_train_flops(2048, 10, 16384, 1, 32000)
    assert round(flops / 1e12) == 89


@pytest.mark.parametrize("kernel,bh,seq,want_ms,by", [
    ("fwd", 96, 1024, 0.0602, "bytes"),
    ("dq", 96, 1024, 0.0782, "operations"),
    ("dkv", 96, 1024, 0.1043, "operations"),
    ("fwd", 8, 16384, 1.1118, "operations"),
])
def test_flash_bounds_at_head_dim_256(kernel, bh, seq, want_ms, by):
    """The bounds PERF.md states at bench.py's transformer shape (B*H
    96, S 1024) and at s16k_flash's (B*H 8, S 16384), d 256, bf16,
    causal."""
    ms, bound_by = chip_smoke.bound(bh, seq, 256, "bfloat16", True, kernel)
    assert round(ms, 4) == want_ms and bound_by == by


def test_ctr_phase_rehearses(tmp_path):
    """The zoo modules at their defaults (vocab 1M), over 1024 records
    of 10 fields of Zipf(1.2) ids below 1000, batch 64, 2 epochs: the
    phase's checks pass at its own AUC floor (this size reads 0.84-0.88
    on the CPU)."""
    out = chip_smoke.ctr_phase(torch, np, str(tmp_path), device="cpu",
                               records=1024, valid=512, batch=64, epochs=2,
                               fields=10, vocab=1000, agree_batch=16)
    assert set(out) == set(chip_smoke.CTR_ZOO)
    for record in out.values():
        assert record["steps"] == 32
        assert record["auc"] >= chip_smoke.CTR_AUC_FLOOR
        agreement = record["agreement"]
        # the CPU against itself: the same bits
        assert agreement["grad_worst_rel_l2"] == 0.0
        assert agreement["table_max_abs_diff"] == 0.0
        assert agreement["dense_max_abs_diff"] == 0.0
        # every parameter's gradient is held, the tables' too
        assert agreement["params"] == len(agreement["grad_rel_l2"])
        assert set(agreement["grad_rel_l2"]) >= set(
            agreement["tables_moved"])
        assert min(agreement["tables_moved"].values()) > 0


def test_ctr_check_fails_on_a_table_left_unchanged(monkeypatch):
    """A step whose tables get a zero gradient (the lookup reads a
    detached table, the table enters the graph times 0) leaves them as
    they were: ctr_agreement reads it and ctr_check refuses."""
    from elasticdl_tpu_torch.models import ctr

    monkeypatch.setattr(
        ctr.FieldEmbeddings, "forward",
        lambda self, ids: torch.nn.functional.embedding(
            ids.long(), self.embeddings.detach() + 0.0 * self.embeddings))
    agreement = chip_smoke.ctr_agreement(torch, np, "dcn", device="cpu",
                                         batch=16, fields=10, vocab=1000)
    assert agreement["tables_moved"] == {"FieldEmbeddings_0.embeddings": 0.0}
    record = {"auc": 0.9, "auc_floor": chip_smoke.CTR_AUC_FLOOR,
              "agreement": agreement}
    with pytest.raises(SystemExit, match="did not move"):
        chip_smoke.ctr_check(np, "dcn", [0.7] * 4 + [0.5] * 4, record)


def test_ctr_check_fails_on_a_gradient_scaled_on_one_side(monkeypatch):
    """The first of the two steps (the card's side) gets every gradient
    twice its size and the same loss: Adam's first update is about
    lr * sign(g) on both sides, so only the gradients themselves can
    tell, and ctr_check refuses on them."""
    from elasticdl_tpu_torch.models import ctr

    calls = []
    loss = ctr.loss

    def doubled_on_first_step(labels, predictions):
        value = loss(labels, predictions)
        calls.append(1)
        # the same value; twice the gradient in the first step
        return value + (value - value.detach()) if len(calls) == 1 else value

    monkeypatch.setattr(ctr, "loss", doubled_on_first_step)
    agreement = chip_smoke.ctr_agreement(torch, np, "wide_deep",
                                         device="cpu", batch=16, fields=10,
                                         vocab=1000)
    assert agreement["loss_rel_diff"] == 0.0
    # 2g against g: a relative error of one in every leaf
    assert all(abs(rel - 1.0) < 1e-6
               for rel in agreement["grad_rel_l2"].values())
    record = {"auc": 0.9, "auc_floor": chip_smoke.CTR_AUC_FLOOR,
              "agreement": agreement}
    with pytest.raises(SystemExit, match="gradients disagree"):
        chip_smoke.ctr_check(np, "wide_deep", [0.7] * 4 + [0.5] * 4, record)

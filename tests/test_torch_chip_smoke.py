"""chip_smoke.py's tables, checked on the CPU.

``chip_smoke.py --mutations`` plants faults in copies of the kernel
sources by replacing texts that must occur exactly once; a later edit of
a kernel that drops or repeats such a text would otherwise break the
mutation run only on the card. chip_smoke imports no torch at import
time, so this runs anywhere.
"""

import os

import pytest

import chip_smoke

TABLES = (
    [("K4_MUTATIONS", name, chip_smoke.K4_SOURCE, edits)
     for name, edits in chip_smoke.K4_MUTATIONS]
    + [("K4_SCHEDULES", name, chip_smoke.K4_SOURCE, edits)
       for name, edits in chip_smoke.K4_SCHEDULES.items() if edits]
    + [("BWD_MUTATIONS", name, chip_smoke.BWD_SOURCE, edits)
       for name, edits in chip_smoke.BWD_MUTATIONS]
    + [("K6_D256_VARIANTS", name, chip_smoke.BWD_SOURCE, edits)
       for name, edits in chip_smoke.K6_D256_VARIANTS.items()]
    + [("TIER_MUTATIONS", name, chip_smoke.TIER_SOURCE, edits)
       for name, edits in chip_smoke.TIER_MUTATIONS]
    + [("K3_VARIANTS", name, chip_smoke.TIER_SOURCE, edits)
       for name, edits in chip_smoke.K3_VARIANTS.items() if edits]
    + [("K1_CHAIN_VARIANTS", name, chip_smoke.TIER_SOURCE, edits)
       for name, edits in chip_smoke.K1_CHAIN_VARIANTS.items() if edits]
    + [("FC_MUTATIONS", name, source, edits)
       for name, source, edits in chip_smoke.FC_MUTATIONS]
)


def _source(path):
    with open(os.path.join(chip_smoke.HERE, path)) as f:
        return f.read()


@pytest.mark.parametrize(
    "table,name,source,edits", TABLES,
    ids=["%s-%s" % (table, name) for table, name, _, _ in TABLES])
def test_every_replaced_text_occurs_once(table, name, source, edits):
    text = _source(source)
    for old, new in edits:
        assert text.count(old) == 1, (table, name, old)
        assert old != new
    mutated = chip_smoke.apply_edits(text, edits, name)
    assert mutated != text


def test_apply_edits_refuses_a_missing_text():
    with pytest.raises(SystemExit):
        chip_smoke.apply_edits("abc", (("xyz", "q"),), "missing")
    with pytest.raises(SystemExit):
        chip_smoke.apply_edits("abab", (("ab", "q"),), "twice")


@pytest.mark.parametrize("kernel,want_ms", [
    ("fwd", 0.0151), ("dq", 0.0196), ("dkv", 0.0261)])
def test_flash_bounds_at_the_train_shape(kernel, want_ms):
    """The bounds PERF.md and the kernel notes state (B*H 96, S 1024,
    d 64, bf16, causal): K4 by bytes, K5 and K6 by operations."""
    ms, by = chip_smoke.bound(96, 1024, 64, "bfloat16", True, kernel)
    assert round(ms, 4) == want_ms
    assert by == ("bytes" if kernel == "fwd" else "operations")


def test_k1_faults_and_the_race_are_planted():
    """--mutations plants K1's three faults (a miss reading slot 0, a
    lane reading the wrong chunk, the table read before the dependency
    wait) and counts the last, a race, over K1_RACE_RUNS runs."""
    names = [name for name, _ in chip_smoke.TIER_MUTATIONS]
    for name in ("k1_miss_reads_slot_0", "k1_lane_reads_wrong_chunk",
                 chip_smoke.K1_RACE):
        assert names.count(name) == 1, name
    assert chip_smoke.K1_RACE_RUNS >= 2


def test_k1_bound_at_deepfm_shape():
    """K1's bound on the combined buffer (8192 slots, d 8): the slots,
    one row read and one written per slot, over the memory rate."""
    ms, by = chip_smoke.roofline(4 * 8192 + 2 * 4 * 8192 * 8, 0)
    assert round(ms, 6) == 0.000166 and by == "bytes"


def _bench_deepfm_calls():
    """The calls of bench.py's deepfm_run, parsed from its source:
    {callee name: [ast.Call, ...]}."""
    import ast

    with open(os.path.join(chip_smoke.HERE, "bench.py")) as f:
        tree = ast.parse(f.read())
    run = next(node for node in ast.walk(tree)
               if isinstance(node, ast.FunctionDef)
               and node.name == "deepfm_run")
    calls = {}
    for node in ast.walk(run):
        if isinstance(node, ast.Call):
            func = node.func
            name = func.attr if isinstance(func, ast.Attribute) else getattr(
                func, "id", None)
            calls.setdefault(name, []).append(node)
    return calls


def test_stream_phase_runs_bench_deepfm_configuration():
    """Phase 8 (stream) drives bench.py's deepfm ladder as bench.py
    configures it: train_stream(push_interval=2), cache_staleness 8 on
    the pipelined rungs, the tier config of bench.py's DeviceTierConfig,
    and two PS processes with adam lr 0.001 in sync mode (no
    --use_async) on the native store (no --use_native_store)."""
    import ast

    calls = _bench_deepfm_calls()
    (stream_call,) = calls["train_stream"]
    push_interval = {k.arg: ast.literal_eval(k.value)
                     for k in stream_call.keywords}["push_interval"]
    assert chip_smoke.STREAM_PUSH_INTERVAL == push_interval == 2
    (trainer_call,) = calls["SparseTrainer"]
    staleness = next(k.value for k in trainer_call.keywords
                     if k.arg == "cache_staleness")
    assert isinstance(staleness, ast.IfExp)  # 8 if pipelined else 0
    assert chip_smoke.STREAM_CACHE_STALENESS == ast.literal_eval(
        staleness.body) == 8
    assert ast.literal_eval(staleness.orelse) == 0
    (tier_call,) = calls["DeviceTierConfig"]
    bench_tier = {k.arg: ast.literal_eval(k.value) for k in tier_call.keywords}
    assert chip_smoke.SPARSE_TIER == bench_tier
    (popen,) = calls["Popen"]
    argv = [ast.literal_eval(e) for e in popen.args[0].elts
            if isinstance(e, ast.Constant)]
    flags = list(chip_smoke.STREAM_PS_FLAGS)
    for flag in ("--num_ps_pods", "--opt_type", "--opt_args"):
        assert flags[flags.index(flag) + 1] == argv[argv.index(flag) + 1]
    assert flags[flags.index("--num_ps_pods") + 1] == "2"
    assert flags[flags.index("--opt_args") + 1] == "lr=0.001"
    assert flags[flags.index("--opt_type") + 1] == "adam"
    for absent in ("--use_async", "--use_native_store", "--grads_to_wait"):
        assert absent not in argv and absent not in flags
    with open(os.path.join(chip_smoke.HERE, "bench.py")) as f:
        tree = ast.parse(f.read())
    run = next(node for node in ast.walk(tree)
               if isinstance(node, ast.FunctionDef)
               and node.name == "deepfm_run")
    names = [a.arg for a in run.args.args]
    defaults = dict(zip(names[-len(run.args.defaults):],
                        (ast.literal_eval(d) for d in run.args.defaults)))
    assert chip_smoke.STREAM_WARMUP == defaults["warmup"] == 10
    assert chip_smoke.SPARSE_STEPS == defaults["warmup"] + defaults["steps"]
    assert chip_smoke.SPARSE_BATCH == defaults["batch_size"] == 512
    assert chip_smoke.STREAM_LADDER == ("sequential", "pipelined",
                                        "pipelined_tier")


@pytest.fixture
def counting_tier(monkeypatch):
    """The tier ops' CPU paths, counting a launch wherever the CUDA
    wrappers would (a non-empty slot array), so the phases' launch
    formula can be rehearsed here. The public and fused ops look the
    private ones up on the module at call time."""
    from elasticdl_tpu_torch.ops import embedding_tier as tier

    gather, insert, scatter = (tier._gather_merge, tier._insert_rows,
                               tier.scatter_apply)

    def counted_gather(table, slots, miss_rows, pdl):
        out, _ = gather(table, slots, miss_rows, pdl)
        tier.GATHER_LAUNCHES += bool(slots.shape[0])
        return out, bool(slots.shape[0])

    def counted_insert(state, slots, rows, pdl):
        insert(state, slots, rows, pdl)
        tier.SET_ROWS_LAUNCHES += bool(slots.shape[0])
        return bool(slots.shape[0])

    def counted_scatter(state, slots, *args, **kwargs):
        out = scatter(state, slots, *args, **kwargs)
        tier.SCATTER_APPLY_LAUNCHES += bool(slots.shape[0])
        return out

    monkeypatch.setattr(tier, "_gather_merge", counted_gather)
    monkeypatch.setattr(tier, "_insert_rows", counted_insert)
    monkeypatch.setattr(tier, "scatter_apply", counted_scatter)
    return tier


def test_ps_restart_phase_rehearses_on_the_cpu(tmp_path, counting_tier):
    """Phase 10 end to end on the CPU at a small size (8 fields, batch
    64, 2 of 4 files of 4096 records: 128 steps; a checkpoint every 8
    versions, the kill 5 past a base and 2 deltas): every check of the
    phase holds, and the record carries what the card run prints."""
    import numpy as np
    import torch

    torch.set_num_threads(1)
    workdir = str(tmp_path)
    chip_smoke.job_data(np, workdir, records=16384, valid=2048, fields=8)
    out = chip_smoke.ps_restart_phase(
        torch, np, counting_tier, workdir, device="cpu", per_task=1024,
        batch=64, eval_steps=32, report_version_steps=8, task_timeout_s=5.0,
        ckpt_steps=8, min_lost=5, card="CPU rehearsal, no card",
        worker_env=dict(chip_smoke.JOB_WORKER_ENV,
                        EDL_DEVICE_TIER_ROWS="2048",
                        EDL_DEVICE_TIER_STAGE="256",
                        EDL_SPARSE_ID_CAPACITY="512"))
    base, deltas, newest = out["chain_at_kill"]
    assert deltas >= 2 and out["version_at_kill"] >= newest + 5
    assert out["restored_version"] >= newest >= 1
    assert out["shard1_stamp"] == out["restored_version"] + 1
    assert [shard for shard, _ in out["resyncs"]] == [1]
    assert out["tier_flush"]["reads"] == 2 and out["tier_flush"]["rows"] > 0
    assert out["saves_by_kind"]["full"]["saves"] >= 2
    assert out["saves_by_kind"]["delta"]["saves"] >= 2
    assert out["ps_exit_codes"] == [0, 0]
    assert out["launches"]["gather"] > 0 and not out[
        "launch_formula_mismatches"]


def test_artifact_phase_rehearses_on_the_cpu(tmp_path, counting_tier):
    """Phase 11 end to end on the CPU at a small size (8 fields, batch
    64, one file of 4096 records: 64 steps; a dense checkpoint every 16
    versions, 2 kept; a 128-row burst at max_batch 16): every check of
    the phase holds, and the record carries what the card run
    prints."""
    import numpy as np
    import torch

    torch.set_num_threads(1)
    workdir = str(tmp_path)
    chip_smoke.job_data(np, workdir, records=16384, valid=2048, fields=8)
    out = chip_smoke.artifact_phase(
        torch, np, counting_tier, workdir, device="cpu", per_task=1024,
        batch=64, report_version_steps=8, task_timeout_s=5.0,
        ckpt_steps=16, keep_max=2, serve_batch=16, burst=128, clients=8,
        card="CPU rehearsal, no card",
        worker_env=dict(chip_smoke.JOB_WORKER_ENV,
                        EDL_DEVICE_TIER_ROWS="2048",
                        EDL_DEVICE_TIER_STAGE="256",
                        EDL_SPARSE_ID_CAPACITY="512"))
    assert out["master_rc"] == 0 and out["worker0_version"] == 64
    assert out["export_step"] == 64 and out["dense_versions"] == [48, 64]
    assert len(out["train_end_tasks_done"]) == 1
    # the train-end barrier reads back what was dirty at it: both tables
    # when the job's evaluation ran first, nothing when a get_task
    # between the last task report and the version report handed the
    # train-end task out first (tests/test_torch_train_end_order.py)
    (end,) = out["train_end_flushes"]
    assert out["launches_train_end_flush"] == [end["want"]]
    assert end["reads"] == end["dirty_tables"]
    assert end["dirty_tables"] == (
        2 if out["train_end_order"] == "evaluation_first" else 0)
    assert not out["training_handed_after_train_end"]
    assert out["launches_checkpoint_flush"] == [[2, 0, 0]] * 4
    assert not out["launch_formula_mismatches"]
    assert out["ps_final_versions"] == [64, 64]
    assert [r[0] for r in out["ps_restored"]] == [64, 64]
    assert out["eval_only_auc"] >= chip_smoke.JOB_AUC_FLOOR
    assert out["eval_only_auc"] == pytest.approx(out["prediction_auc"],
                                                 abs=1e-6)
    assert out["predicted_once"] and out["predicted_records"] == 2048
    assert out["served_equal_direct"] and out["second_burst_equal"]
    assert out["serve_cache_drops"] == out["serve_stamped_relaunches"]
    assert out["ps1_relaunch_restored"][0] == 64


def test_control_phase_rehearses_on_the_cpu(tmp_path, counting_tier):
    """Phase 12 end to end on the CPU at a small size (8 fields, batch
    64, 2 of 4 files of 4096 records: 16 tasks of 8 steps): worker 1, a
    process, drains on SIGTERM; the master, a process, is SIGKILLed
    mid-epoch and relaunched; every check of the phase holds, and the
    record carries what the card run prints."""
    import numpy as np
    import torch

    torch.set_num_threads(1)
    workdir = str(tmp_path)
    chip_smoke.job_data(np, workdir, records=16384, valid=2048, fields=8)
    out = chip_smoke.control_phase(
        torch, np, counting_tier, workdir, device="cpu", per_task=512,
        batch=64, eval_steps=80, report_version_steps=8, task_timeout_s=10.0,
        card="CPU rehearsal, no card",
        worker_env=dict(chip_smoke.JOB_WORKER_ENV,
                        EDL_DEVICE_TIER_ROWS="2048",
                        EDL_DEVICE_TIER_STAGE="256",
                        EDL_SPARSE_ID_CAPACITY="512"))
    assert out["master_rc"] == 0 and out["worker1_rc"] == 0
    assert out["done_exactly_once"] and out["training_tasks"] == 16
    assert out["master_boots"] == [1, 2]
    assert len(out["train_end_done"]) == 1
    assert out["worker0_epochs"][1] > out["worker0_epochs"][0]
    assert out["drain_acks"] == [("1", "sigterm", "True", "True", "0")]
    assert out["drain_flush"]["rows"] > 0
    assert out["drain_flush"]["k1_launches"] == 0  # no kernel on the CPU
    assert out["replay_ops"] == out["journal_ops_at_kill"]
    assert out["export_step"] == out["worker0_version"]
    assert out["evaluations"] and not out["launch_formula_mismatches"]
    assert out["launches"]["gather"] > 0


@pytest.fixture
def counting_flash(monkeypatch):
    """K4's CPU path, counting a launch where the CUDA wrapper would."""
    from elasticdl_tpu_torch.ops import flash_attention as flash

    fwd = flash.flash_attention_fwd

    def counted(*args, **kwargs):
        flash.LAUNCHES += 1
        return fwd(*args, **kwargs)

    monkeypatch.setattr(flash, "flash_attention_fwd", counted)
    return flash


def test_telemetry_phase_rehearses_on_the_cpu(tmp_path, counting_tier,
                                              counting_flash):
    """Phase 13 end to end on the CPU at a small size (8 fields, batch
    64, 2 of 4 files of 8192 records: 32 tasks of 8 steps, evaluated
    every 96 versions, late enough that the worker which runs the
    evaluation has learned past the AUC floor; the dead-air
    times scaled down through the same knobs, each gap 3-5 s spare:
    dead air 8 s, a 12 s stop, a 20 s liveness timeout, the PS's poll
    each 1 s): worker 1 is SIGSTOPped and SIGCONTed, dead air raised for it
    alone and cleared; then the TransformerLM server at narrow widths
    (a warm-up batch, then 4 measured requests).
    Every check of the phase holds, and the record carries what the
    card run prints."""
    import numpy as np
    import torch

    torch.set_num_threads(1)
    workdir = str(tmp_path)
    chip_smoke.job_data(np, workdir, records=32768, valid=2048, fields=8)
    out = chip_smoke.telemetry_phase(
        torch, np, counting_tier, workdir, device="cpu", per_task=512,
        batch=64, eval_steps=96, report_version_steps=8, dead_air_s=8.0,
        stop_s=12.0, task_timeout_s=20.0, ps_gone_s=2.0,
        card="CPU rehearsal, no card", out_dir=os.path.join(workdir, "tel"),
        worker_env=dict(chip_smoke.JOB_WORKER_ENV,
                        EDL_DEVICE_TIER_ROWS="2048",
                        EDL_DEVICE_TIER_STAGE="256",
                        EDL_SPARSE_ID_CAPACITY="512"))
    assert out["master_rc"] == 0 and out["worker1_rc"] == 0
    assert out["ps_exit_codes"] == [0, 0]
    assert out["alerts_seen"] == [("dead_air", "worker-1")]
    assert out["alerts_total"] == {"dead_air": 1.0}
    assert [t[:3] for t in out["alert_transitions"]] == [
        ("alert_raised", "dead_air", "1"), ("alert_cleared", "dead_air", "1")]
    assert not out["requeues_or_deaths"]
    assert out["done_exactly_once"] and out["training_tasks"] == 32
    assert {"worker-0", "worker-1", "ps-0", "ps-1"} <= set(
        out["fleet_roles"])
    for series, stats in out["tier_series_vs_stats"].values():
        assert series == stats > 0
    assert sum(out["server_pushes"]) == sum(out["client_pushes"]) > 0
    assert out["traces_in_three_roles"] > 0
    assert out["evaluations"] and not out["launch_formula_mismatches"]
    assert out["launches"]["gather"] > 0
    serve = chip_smoke.telemetry_serve(
        torch, np, counting_flash, workdir, device="cpu",
        widths=dict(vocab_size=512, num_layers=2, num_heads=2,
                    embed_dim=128), seq=128, requests=4,
        out_dir=os.path.join(workdir, "tel_serve"))
    assert (serve["readyz_before_load"], serve["readyz_after_load"]) == (
        503, 200)
    # a warm-up batch of 8, then the 4 measured requests, each split
    assert serve["served_ok_counter"] == 8 + 4
    assert serve["launches"] == 2 * serve["batches"]
    assert serve["split_requests"] == 4 and serve["warmup_batches"] >= 1
    assert all(v is not None for v in serve["split_ms_median"].values())

"""chip_smoke.py's phase 14 (the serving fleet), rehearsed on the CPU.

The router is a ``router_main`` process, its two replicas and the
replacement port ``serve.main`` processes of a narrow TransformerLM
(2 layers, d 64) with ``--device cpu``; the callers are a process of
their own. The fleet clocks are the card run's but for the heartbeat
timeout (4 s, not 8) and the scale cooldown (12 s, not 30), which keep
the rehearsal short: a replica's cold start here is about 3-4 s.
"""

import os

import chip_smoke


def test_fleet_phase_rehearses_on_the_cpu(tmp_path, monkeypatch):
    """Phase 14 end to end: spin-up, SIGKILL, promote and rollback with
    every check of the phase, and K4 counted in every replica process
    (the hook counts the plain version's calls on the CPU)."""
    import numpy as np
    import torch

    from elasticdl_tpu_torch.ops import flash_attention as flash

    torch.set_num_threads(1)
    # the router's replicas inherit it: one intra-op thread each, so the
    # fleet's processes do not crowd out other files' timed tests
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    fwd = flash.flash_attention_fwd

    def counted(*args, **kwargs):
        flash.LAUNCHES += 1
        return fwd(*args, **kwargs)

    flash.flash_attention_fwd = counted
    try:
        out = chip_smoke.fleet_phase(
            torch, np, flash, device="cpu",
            widths=dict(vocab_size=256, num_layers=2, num_heads=2,
                        embed_dim=64),
            seq=32, callers=2, burst=16, wait_s=120,
            fleet_env=dict(chip_smoke.FLEET_ENV,
                           EDL_ROUTER_REPLICA_TIMEOUT_SECS="4",
                           EDL_SERVE_SCALE_COOLDOWN_SECS="12"),
            out_dir=os.path.join(str(tmp_path), "fleet"))
    finally:
        flash.flash_attention_fwd = fwd
    assert out["failed_requests"] == 0 and out["loop"]["n"] > 0
    assert out["router_rc"] == 0
    assert out["inprocess_k4_launches"] == 2
    assert out["vs_inprocess"]["max_abs"] <= chip_smoke.SERVE_MAX_TOL
    assert out["affinity"]["served"] == out["affinity"]["ring"]
    assert out["journal"]["replica_registered"] == 3
    assert out["journal"]["replica_lost"] == 1
    assert len(out["journal"]["promoted"]) == 1
    assert len(out["journal"]["rolled_back"]) == 1
    assert out["journal"]["canary_started"] == 2
    assert set(out["steps_served"]) >= {1, 8}
    assert len(out["replica_k4"]) == 3
    for replica in out["replica_k4"]:
        assert replica["launches"] == 2 * replica["forwards"] > 0
    for key in ("kill_to_replacement_registered_s",
                "kill_to_first_served_by_replacement_s",
                "v2_land_to_promotion_s", "v3_land_to_rollback_s"):
        assert out[key] > 0
    assert len(out["cold_start_s"]) == 3
    # each cold start split in three from the journals, adding up
    assert set(out["cold_start_split_s"]) == set(out["cold_start_s"])
    for replica, parts in out["cold_start_split_s"].items():
        assert len(parts) == 3 and min(parts) >= 0
        assert abs(sum(parts) - out["cold_start_s"][replica]) < 1e-6
    assert list(out["split_s"]) == [
        "weights_and_v1", "spin_up", "in_process_model",
        "first_routed_answer", "in_process_answer", "affinity_burst",
        "router_cost_bursts", "loop_kill_to_first_served", "v2_export",
        "v2_promoted_and_loaded", "v3_export", "v3_rolled_back",
        "no_retry_and_stop", "router_drain", "journal_and_checks"]

"""Phase 18 of chip_smoke.py (``continual_phase``: DeepFM as a continual
stream job, the PS embedding lifecycle, watermark checkpoints and
exports, TensorBoard summaries and a fault burst on PS 1) rehearsed on
the CPU at a small size, with the tier ops' plain versions counting a
launch where the CUDA wrappers launch: every check of the phase holds,
and the record carries what the card run prints.
"""

import numpy as np
import torch

import chip_smoke
from tests.test_torch_chip_smoke import counting_tier  # noqa: F401

# 6 fields, windows of 512 (8 steps of 64), 16 windows: 128 steps; a
# checkpoint boundary every 4 windows, an export every 8; a hot set of
# 800 ids sliding 8 (1%) a window against a bound of 384 rows a table.
# The whole stream takes seconds here, so an id touched in the last
# tenth of a second (not second) is safe from an LFU sweep
SMALL = dict(batch=64, fields=6, window=512, windows=16, hot_vocab=800,
             zipf_a=1.3, drift=8, backlog=2048, ckpt_every=2048,
             export_every=4096, max_rows=384, eval_steps=32,
             report_version_steps=4, task_timeout_s=10.0,
             lfu_protect_s=0.03, wait_s=240)
SMALL_WORKER_ENV = dict(chip_smoke.JOB_WORKER_ENV,
                        EDL_DEVICE_TIER_ROWS="1024",
                        EDL_DEVICE_TIER_STAGE="64",
                        EDL_SPARSE_ID_CAPACITY="384")


def test_continual_phase_rehearses_on_the_cpu(tmp_path,
                                              counting_tier):  # noqa: F811
    torch.set_num_threads(1)
    out = chip_smoke.continual_phase(
        torch, np, counting_tier, str(tmp_path), device="cpu",
        worker_env=SMALL_WORKER_ENV, card="CPU rehearsal, no card", **SMALL)
    chip_smoke.continual_summary(out)
    windows, total = SMALL["windows"], SMALL["window"] * SMALL["windows"]
    assert out["windows_minted"] == out["window_tasks_done"] == windows
    assert out["final_watermark"] == out["minted_records"] == total
    assert out["journal_stream"] == {"open": False, "pos": windows,
                                     "minted_records": total,
                                     "done_records": total}
    assert out["journal_windows_done"] == windows
    boundaries = [1, 2, 3, 4]
    assert [w // SMALL["ckpt_every"]
            for w in out["worker_checkpoint_watermarks"]] == boundaries
    assert all(len(saves) == 4 for saves in out["ps_stream_checkpoints"])
    assert all(b["k1_launches"] >= 1 for b in out["worker_barriers"])
    assert [w // SMALL["export_every"]
            for w in out["exports_minted_at"]] == [1, 2]
    assert len(out["train_end_tasks"]) == 3
    assert out["evictions"]["lfu"] > 0
    assert out["preadmission_grads_dropped"] > 0
    assert not out["rows_over_bound"]
    assert all(not c["differ"] and not any(final["overtaken"])
               for final in out["final_checks"]
               for c in final["tables"].values())
    assert max(max(p.values())
               for p in out["peak_resident_rows_in_stream"]) <= 384
    assert out["holdout_logloss"] < out["holdout_base_rate_logloss"]
    assert (out["holdout_logloss"] - out["holdout_logloss_tier_rows"]
            < chip_smoke.CONTINUAL_SERVED_GAP)
    for pulled, held, same in out["holdout_pulled_tier_held_served"].values():
        assert pulled >= held >= same > 0
    assert [n for _, n in out["fault_fires"][1]] == [1, 2, 3]
    assert out["fault_fires"][0] == []
    assert out["ps_final_versions"] == [
        out["worker_shard_versions"][k] for k in range(2)]
    assert len(out["evaluations"]) >= 2
    assert not out["tensorboard_missing_versions"]
    assert out["launches"]["gather"] > 0 and not out[
        "launch_formula_mismatches"]

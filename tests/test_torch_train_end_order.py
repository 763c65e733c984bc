"""Phase 11's train-end barrier holds in both orders of the job's end.

The worker reports its last training task done, then the model version
that triggers the job's evaluation (the reference's order). A
``get_task`` from the stream's prefetch can fall between the two: the
train-end task is then handed out before the evaluation tasks exist,
its barrier runs before the evaluation's lookups leave tier rows dirty,
and the barrier flushes nothing. The phase's check follows what was
dirty at the barrier (one K1 read per dirty table, by the flush
formula) and that no training task came after the train-end task.

This file forces the train-end-first order (``artifact_phase(...,
train_end_first=True)`` delays the triggering version report until the
prefetch's get_task was answered with the train-end task) and holds
the same checks; tests/test_torch_chip_smoke.py runs the usual order.
"""

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from tests.test_torch_chip_smoke import counting_tier  # noqa: E402,F401


def test_artifact_phase_holds_with_the_train_end_handed_out_first(
        tmp_path, counting_tier):  # noqa: F811
    import numpy as np
    import torch

    torch.set_num_threads(1)
    workdir = str(tmp_path)
    chip_smoke.job_data(np, workdir, records=16384, valid=2048, fields=8)
    out = chip_smoke.artifact_phase(
        torch, np, counting_tier, workdir, device="cpu", per_task=1024,
        batch=64, report_version_steps=8, task_timeout_s=5.0,
        ckpt_steps=16, keep_max=2, serve_batch=16, burst=128, clients=8,
        card="CPU rehearsal, no card", train_end_first=True,
        out_dir=os.path.join(workdir, "artifact"),
        worker_env=dict(chip_smoke.JOB_WORKER_ENV,
                        EDL_DEVICE_TIER_ROWS="2048",
                        EDL_DEVICE_TIER_STAGE="256",
                        EDL_SPARSE_ID_CAPACITY="512"))
    assert out["train_end_order"] == "train_end_first"
    assert out["train_end_forced_wait_s"] is not None
    (end,) = out["train_end_flushes"]
    # nothing was dirty at the barrier: the last dense checkpoint (at
    # the last step) had flushed the tier, and the evaluation came after
    assert end["dirty_tables"] == end["reads"] == 0
    assert out["launches_train_end_flush"] == [end["want"]] == [[0, 0, 0]]
    assert not out["training_handed_after_train_end"]
    assert out["master_rc"] == 0 and out["worker0_version"] == 64
    assert out["export_step"] == 64 and out["dense_versions"] == [48, 64]
    assert len(out["train_end_tasks_done"]) == 1
    assert not out["launch_formula_mismatches"]
    assert out["eval_only_auc"] >= chip_smoke.JOB_AUC_FLOOR
    assert out["served_equal_direct"] and out["second_burst_equal"]

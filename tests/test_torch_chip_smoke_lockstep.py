"""chip_smoke.py's lockstep arm of phase 9, rehearsed on the CPU at a
small size: (a) SparseSpmdTrainer on a one-rank mesh (gloo here, NCCL on
the card) beside SparseTrainer with the tier on (8 fields, batch 64, 12
steps, a 2,048-row tier), K1-K3 counted by wrapping their plain versions
(the ``counting_tier`` fixture of tests/test_torch_chip_smoke.py: the
CPU path counts no launch); (b) + (c) two ``--multihost 1`` worker
processes over a sync PS pair (1 of 4 files of 4,096 records, tasks of
1,024) with worker 1 SIGKILLed, the survivor's exit 3 and both
relaunched. Every check of the arm holds, and (a) refuses two planted
faults: a mesh loss off by one part in a million and a K1 counted
twice. The log lines the arm parses are the ones the port writes.
"""

import logging

import numpy as np
import pytest
import torch

import chip_smoke
from elasticdl_tpu_torch.master.rendezvous import MeshRendezvous
from elasticdl_tpu_torch.parallel.multihost import MultiHostRuntime
from tests.test_torch_chip_smoke import counting_tier  # noqa: F401
from tests.test_torch_multihost import Client, FakeDistributed

torch.set_num_threads(1)

SPMD = dict(batch=64, fields=8, steps=12,
            tier_knobs=dict(chip_smoke.SPARSE_TIER, capacity=2048,
                            stage_budget=256))
JOB = dict(per_task=1024, batch=64, eval_steps=24, report_version_steps=4)


def test_lockstep_arm_rehearses_on_the_cpu(  # noqa: F811
        tmp_path, counting_tier):
    workdir = str(tmp_path)
    chip_smoke.job_data(np, workdir, records=16384, valid=2048, fields=8)
    record = chip_smoke.lockstep_arm(
        torch, np, counting_tier, workdir, device="cpu",
        phase7_steps_per_s=1.0, spmd=SPMD,
        job=dict(JOB, out_dir=str(tmp_path / "out")))
    spmd = record["sparse_spmd"]
    for key in ("losses_bit_equal", "dense_bit_equal", "tier_bit_equal",
                "ps_rows_bit_equal"):
        assert spmd[key], key
    assert spmd["launch_formula_mismatches"] == []
    assert min(spmd["launches"].values()) > 0
    assert spmd["launches_per_step"]["scatter_apply"] == 2.0
    job = record["job"]
    assert job["final_rcs"] == [0, 0] and job["ps_exit_codes"] == [0, 0]
    assert job["done_training_records"] == job["dataset_records"] == 4096
    assert job["digests"][0] == job["digests"][1] is not None
    assert job["ps_stale_push_rejected"] == 0
    assert job["backends"] == ["gloo: a rank runs on the CPU"]
    kill = job["kill"]
    assert kill["survivor_exit_s"] < kill["exit_bound_s"]
    assert min(f[2] for f in kill["groups_formed_after"]) > kill[
        "epoch_at_kill"]
    assert all(kill["resumed"])
    assert kill["kill_to_first_step_s"] > 0
    assert job["final_auc"] >= chip_smoke.JOB_AUC_FLOOR
    for key in ("rounds_per_s", "consensus_ms_per_round",
                "allreduce_ms_per_round"):
        assert job[key] > 0, key


def test_lockstep_arm_fails_on_a_mesh_loss_off(  # noqa: F811
        counting_tier, monkeypatch):
    from elasticdl_tpu_torch.train import sparse_spmd

    loss = sparse_spmd._SparsePlane.global_loss
    monkeypatch.setattr(sparse_spmd._SparsePlane, "global_loss",
                        lambda self, x: loss(self, x) * (1 + 1e-6))
    with pytest.raises(SystemExit, match="losses_bit_equal"):
        chip_smoke.lockstep_sparse_spmd(torch, np, counting_tier,
                                        device="cpu", **SPMD)


def test_lockstep_arm_fails_on_a_wrong_launch_count(  # noqa: F811
        counting_tier, monkeypatch):
    gather = counting_tier._gather_merge

    def twice(table, slots, miss_rows, pdl):
        counting_tier.GATHER_LAUNCHES += bool(slots.shape[0])
        return gather(table, slots, miss_rows, pdl)

    monkeypatch.setattr(counting_tier, "_gather_merge", twice)
    with pytest.raises(SystemExit, match="phase 7's formula"):
        chip_smoke.lockstep_sparse_spmd(torch, np, counting_tier,
                                        device="cpu", **SPMD)


def test_the_arm_parses_the_ports_log_lines(caplog):
    """The group's formation and backend lines as the runtime logs them,
    and the log clock, through the arm's patterns."""
    rendezvous = MeshRendezvous()
    rendezvous.set_worker_hosts(["hostA:1", "hostB:1"])
    runtime = MultiHostRuntime(Client(rendezvous, "hostB:1"),
                               distributed=FakeDistributed(),
                               coordinator_port=5000, device="cpu")
    with caplog.at_level(logging.INFO):
        runtime.ensure_runtime()
    text = "\n".join(r.getMessage() for r in caplog.records)
    formed = chip_smoke._FORMED_RE.search(text)
    assert formed.groups() == ("1", "2", "1", "gloo")
    backend = chip_smoke._BACKEND_RE.search(text)
    assert backend.group(1) == "gloo"
    stamp = chip_smoke.log_time("2026-10-18 20:30:51,402 INFO x: y")
    assert stamp is not None and chip_smoke.log_time("no clock") is None
    line = ('Worker 1 dense digest at exit: {"digest": "ab", "version": 3}')
    assert chip_smoke._DIGEST_RE.search(line).group(1) == "1"
    assert chip_smoke._FIRST_STEP_RE.search(
        "Worker 0 first lockstep step at version 7").group(1) == "7"

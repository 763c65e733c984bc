"""chip_smoke.py's phase 20 (the long-context and pipelining arm),
rehearsed on the CPU at small widths: two gloo ranks (sp 2: the ring
and Ulysses against one-process flash attention at the full S, the ring
LM's steps beside one rank's first step; pp 2: 1F1B, GPipe and
interleaved steps beside the mesh-less model's, and the gathered pp
state on one rank) while a job of two ``--multihost 1 --mesh pp=2``
workers runs under the master. On the CPU the plain versions count no
launch, so each rank counts K4-K6 where the CUDA wrappers would and the
ring's "auto" takes the flash fold, as for CUDA tensors
(``chip_smoke._count_plain``). Every check of the arm holds, and its
checks refuse doctored records: a launch off the causal formula, an
error past the tolerance, a schedule's loss off the sequential one.
"""

import copy

import numpy as np
import pytest
import torch

import chip_smoke
from elasticdl_tpu_torch.ops import flash_attention as flash

torch.set_num_threads(1)

SIZES = dict(
    sp_widths=dict(vocab_size=256, num_layers=2, num_heads=2, embed_dim=64),
    seq=128, batch=1, sp_steps=2,
    pp_widths=dict(vocab_size=256, num_layers=4, num_heads=2, embed_dim=32),
    pp_seq=16, pp_batch=8, pp_micro=4, pp_steps=2)
JOB = dict(widths=dict(vocab_size=256, num_layers=4, num_heads=2,
                       embed_dim=32), seq=16, batch=4, records=32,
           per_task=16)


@pytest.fixture(scope="module")
def arm(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.setenv("OMP_NUM_THREADS", "1")
    try:
        return chip_smoke.longctx_arm(
            torch, np, flash, str(tmp_path_factory.mktemp("longctx")),
            device="cpu", sizes=SIZES, job=JOB)
    finally:
        mp.undo()


def test_longctx_arm_rehearses_on_the_cpu(arm):
    records = arm["ranks"]
    assert [r["rank"] for r in records] == [0, 1]
    assert chip_smoke.longctx_checks(records) == []
    job = arm["job"]
    assert job["worker_rcs"] == [0, 0] and job["master_rc"] == 0
    assert job["done_training_records"] == job["dataset_records"] == 32
    assert job["first_step_losses"][0] == job["first_step_losses"][1]


@pytest.mark.parametrize("rank", [0, 1])
def test_the_causal_ring_launches_rank_plus_one_blocks(arm, rank):
    """Rank r of sp 2 launches r + 1 K4, K5 and K6 in a ring call (rank
    0 one block, rank 1 two) and layers x (r + 1) in an LM step;
    Ulysses one each; a pipeline step 2 x layers-per-rank x M K4 (the
    recompute) and layers-per-rank x M K5/K6."""
    record = arm["ranks"][rank]
    ring = record["attention"]["ring"]["timed"]["launches"]
    assert ring == {"fwd": rank + 1, "dq": rank + 1, "dkv": rank + 1}
    assert record["attention"]["ulysses"]["timed"]["launches"] == {
        "fwd": 1, "dq": 1, "dkv": 1}
    per = 2 * (rank + 1)
    for step in record["sp_lm"]["steps"]:
        assert step["launches"] == {"fwd": per, "dq": per, "dkv": per}
    for name, m in (("1f1b", 4), ("gpipe", 4), ("interleaved", 2)):
        for step in record["pp"][name]["steps"]:
            assert step["launches"] == {"fwd": 4 * m, "dq": 2 * m,
                                        "dkv": 2 * m}
    entry = chip_smoke.longctx_launches(arm["ranks"], "fwd")
    assert entry["rank%d" % rank]["ring_call"] == rank + 1


def test_hops_are_counted_and_timed(arm):
    """The ring's call moves k and v (and the backward's dk, dv) one hop
    a step; Ulysses' all-to-alls; a pipeline step's activations. On the
    CPU nothing is staged through the host (the tensors are there)."""
    for record in arm["ranks"]:
        ring = record["attention"]["ring"]["timed"]
        assert ring["ppermute_bytes"] > 0 and ring["hops"] == 3
        assert ring["hop_ms"] > 0 and ring["host_staged_bytes"] == 0
        uly = record["attention"]["ulysses"]["timed"]
        assert uly["all_to_all_bytes"] > 0 and uly["ppermute_bytes"] == 0
        step = record["pp"]["1f1b"]["steps"][0]
        assert step["ppermute_bytes"] > 0 and step["all_reduce_bytes"] > 0


def _failures(arm, edit):
    records = copy.deepcopy(arm["ranks"])
    edit(records)
    return chip_smoke.longctx_checks(records)


def test_checks_refuse_a_launch_off_the_formula(arm):
    def edit(records):
        records[1]["attention"]["ring"]["timed"]["launches"]["fwd"] = 1

    assert any("rank 1 ring launches" in f for f in _failures(arm, edit))


def test_checks_refuse_an_error_past_the_tolerance(arm):
    def edit(records):
        records[0]["attention"]["ulysses"]["errors"]["dk"] = 0.02

    assert any("ulysses errors" in f for f in _failures(arm, edit))


def test_checks_refuse_a_schedule_off_the_sequential_loss(arm):
    def edit(records):
        records[0]["pp"]["gpipe"]["steps"][1]["loss"] += 0.2

    assert any("gpipe step 1" in f for f in _failures(arm, edit))


def test_checks_refuse_a_missing_one_rank_run(arm):
    def edit(records):
        for record in records:
            record["sp_lm"].pop("one_rank", None)

    assert _failures(arm, edit) == ["rank 0's one-rank runs are missing"]


def test_checks_refuse_hops_missing_the_backward(arm):
    """A ring call that counted its forward hop alone (on the card
    autograd runs the backward on its device thread, whose hops must
    land in the step's accumulator too) is refused."""
    def edit(records):
        records[0]["attention"]["ring"]["timed"]["hops"] = 1

    assert any("rank 0 ring hops" in f for f in _failures(arm, edit))

"""Phase 21 of chip_smoke.py (``cluster_phase``: the port's
``edl-torch train``, k8s pod manager and elastic controller driving a
DeepFM job on a double of a cluster) rehearsed on the CPU at a small
size: 8 fields, batch 64, 32,768 records in tasks of 512, a 1,024-row
tier, the workers on the CPU through the job's ``EDL_DEVICE``, and the
tier ops' plain versions counting a launch in each worker pod where the
CUDA wrappers would (``CLUSTER_TIER_HOOK``).

Every check of the phase holds: the master pod's command and flags, the
grow, the SIGKILL and the replacement under new ids, the budget's shrink
through a drain with an ack, every record once, both PS pods' exit 0,
the master pod's ``Finished`` label, each worker's K1-K3 launches by its
exit line, the AUC floor. The checks also refuse doctored records: a
record range done twice, a relaunch that reuses an id, a drained worker
that gets replaced, a killed worker's exit line, a K3 count off by one,
a PS pod gone before the master stopped.
"""

import copy
import os

import numpy as np
import pytest
import torch

import chip_smoke
from elasticdl_tpu_torch.data.readers import RecordIODataReader

SMALL = dict(batch=64, per_task=512, eval_steps=64, task_timeout_s=10.0,
             wait_s=240)
SMALL_WORKER_ENV = dict(chip_smoke.JOB_WORKER_ENV,
                        EDL_DEVICE_TIER_ROWS="1024",
                        EDL_DEVICE_TIER_STAGE="64",
                        EDL_SPARSE_ID_CAPACITY="512")


@pytest.fixture(scope="module")
def rehearsal(tmp_path_factory):
    torch.set_num_threads(1)
    workdir = str(tmp_path_factory.mktemp("cluster"))
    chip_smoke.job_data(np, workdir, records=32768, valid=2048, fields=8)
    # one intra-op thread in each pod, so the job's five processes do not
    # crowd out other files' timed tests
    with chip_smoke.patched_env({"OMP_NUM_THREADS": "1"}):
        record = chip_smoke.cluster_phase(
            workdir, device="cpu", worker_env=SMALL_WORKER_ENV,
            out_dir=os.path.join(workdir, "out"), **SMALL)
    dataset = {shard: count for shard, (_, count) in RecordIODataReader(
        data_dir=os.path.join(workdir, "cluster_train")
    ).create_shards().items()}
    return record, dataset


def test_cluster_phase_rehearses_on_the_cpu(rehearsal):
    record, dataset = rehearsal
    assert chip_smoke.cluster_checks(record, dataset) == []
    ids = record["ids"]
    assert ids["grown"] == ids["killed"] == 1
    assert ids["replacement"] == 2
    assert ids["victim"] in (0, 2) and ids["survivor"] in (0, 2)
    assert record["scale_decisions"] == {
        "counter": {"grow": 1, "shrink": 1}, "events": ["grow", "shrink"]}
    assert [p["name"] for p in record["pods"]] == [
        "elasticdl-smoke21-%s" % n for n in
        ("master", "ps-0", "ps-1", "worker-0", "worker-1", "worker-2")]
    killed = record["pods"][4]
    assert killed["exit_code"] == 137 and killed["deleted_s"] is not None
    assert record["dataset_records"] == 32768 == sum(dataset.values())
    assert record["card"] == "cpu"
    for wid in ("0", "2"):
        per_step = record["launches_per_step"][wid]
        assert per_step["k3"] == chip_smoke.CLUSTER_TABLES
        assert per_step["k1"] >= chip_smoke.CLUSTER_TABLES
        assert record["steps_per_s"][wid] > 0
    for key in ("job_wall_s", "backlog_to_grow_s",
                "kill_to_replacement_first_task_s", "shrink_to_drain_ack_s"):
        assert record[key] > 0, key
    assert set(record["submit_to_running_s"]) == {
        p["name"] for p in record["pods"]}


def _doctor(record, fault):
    bad = copy.deepcopy(record)
    ids = bad["ids"]
    workers = [p for p in bad["pods"] if p["kind"] == "worker"]
    if fault == "record_done_twice":
        bad["done"].append(list(bad["done"][0]))
    elif fault == "relaunch_reuses_an_id":
        ids["replacement"] = ids["killed"]
        workers[-1]["index"] = ids["killed"]
    elif fault == "drained_worker_replaced":
        bad["pods"].append(dict(workers[-1], name="elasticdl-smoke21-"
                                "worker-3", index=3,
                                created_s=bad["shrink_s"] + 0.5))
    elif fault == "killed_worker_exit_line":
        bad["launches"][str(ids["killed"])] = dict(
            bad["launches"][str(ids["survivor"])])
    elif fault == "k3_off_by_one":
        bad["launches"][str(ids["survivor"])]["k3"] += 1
    elif fault == "ps_gone_before_the_master":
        ps = next(p for p in bad["pods"] if p["kind"] == "ps")
        ps["exited_s"] = bad["master_stopped_s"] - 1.0
    return bad


@pytest.mark.parametrize("fault, message", [
    ("record_done_twice", "done twice"),
    ("relaunch_reuses_an_id", "used twice"),
    ("drained_worker_replaced", "created after the shrink"),
    ("killed_worker_exit_line", "killed worker printed"),
    ("k3_off_by_one", "K1-K3 launches"),
    ("ps_gone_before_the_master", "after the master's stop"),
])
def test_cluster_checks_refuse_a_doctored_record(rehearsal, fault, message):
    record, dataset = rehearsal
    failures = chip_smoke.cluster_checks(_doctor(record, fault), dataset)
    assert any(message in f for f in failures), failures

"""chip_smoke.py's phase 17 iris job, rehearsed on the CPU at the card's
size: the port's master and one worker as processes (``--device
cpu``) over two CSV files of 120 rows, 16 rows a task, 10 epochs; every
task done once, one train-end task, the export at the final step,
accuracy above 0.85, and the export served over gRPC bit-equal to
``eval_step``.
"""

import numpy as np
import torch

import chip_smoke

torch.set_num_threads(1)


def test_iris_job_rehearses(tmp_path):
    iris = chip_smoke.iris_job(torch, np, str(tmp_path), device="cpu")
    assert iris["master_rc"] == iris["worker_rc"] == 0
    assert iris["served_bit_equal"]
    assert iris["done"] == iris["tasks"] + iris["train_end_tasks"]
    assert iris["export_step"] == 150

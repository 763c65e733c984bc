"""chip_smoke.py's phase 17 (the feature-column family), rehearsed on
the CPU at small sizes: the promoted model at a 100,000-id vocab (3.2
MB, over the 2 MiB threshold), batch 64, 60 steps (the K1-K3 wrappers'
plain versions counting a launch where the CUDA wrappers launch); the
four zoo models at reduced sizes (iris as a job in
tests/test_torch_chip_smoke_iris.py); iris over a table at the card's
size. Every check of the phase holds, and the phase refuses each of
three planted faults: the ``mean`` combiner dividing by the padded
length (``FC_MUTATIONS``, the same text edit ``--mutations`` plants on
the card), K1 counted twice at one step, and a prediction landed in the
table an ulp off. What only the card can give reads "cpu" beside it here.
"""

import importlib.util

import numpy as np
import pytest
import torch

import chip_smoke
from elasticdl_tpu_torch.preprocessing import feature_column
from elasticdl_tpu_torch.train import model_handler
from tests.test_torch_chip_smoke import counting_tier  # noqa: F401

torch.set_num_threads(1)

SMALL = dict(vocab=100_000, batch=64, steps=60, warm=10)
SMALL_ZOO = (
    ("census_wide_deep", (512, 128), 2, 0.5),
    ("census_dnn", (1024, 128), 2, 0.5),
    ("census_sqlflow_wide_deep", (2048, 128), 6, 0.5),
    ("heart", (1024, 256), 10, 0.5),
)


def test_promoted_model_rehearses(tmp_path, counting_tier):  # noqa: F811
    out = chip_smoke.promoted_phase(torch, np, counting_tier, str(tmp_path),
                                    device="cpu", **SMALL)
    assert out["launches"]["scatter_apply"] == SMALL["steps"]
    assert min(out["launches"].values()) >= SMALL["steps"] - SMALL["warm"]
    assert out["export_rows_equal_ps"]
    assert out["agreement"]["worst_rel_l2"] <= chip_smoke.FEATURE_AGREE_RTOL
    assert out["combiner"]["max_rel_err"] <= chip_smoke.FEATURE_COMBINE_RTOL


def _mutated_combine_gathered():
    """combine_gathered with FC_MUTATIONS' edit applied to its source."""
    (name, source, edits), = chip_smoke.FC_MUTATIONS
    path = chip_smoke.os.path.join(chip_smoke.HERE, source)
    with open(path) as f:
        text = chip_smoke.apply_edits(f.read(), edits, name)
    spec = importlib.util.spec_from_loader("mutated_feature_column",
                                           loader=None)
    module = importlib.util.module_from_spec(spec)
    exec(compile(text, path, "exec"), module.__dict__)
    return module.combine_gathered


def test_promoted_model_refuses_the_padded_length_mean(
        tmp_path, counting_tier, monkeypatch):  # noqa: F811
    mutated = _mutated_combine_gathered()
    monkeypatch.setattr(model_handler, "combine_gathered", mutated)
    monkeypatch.setattr(feature_column, "combine_gathered", mutated)
    with pytest.raises(SystemExit, match="mean disagrees"):
        chip_smoke.promoted_phase(torch, np, counting_tier, str(tmp_path),
                                  device="cpu", **SMALL)


def test_promoted_model_refuses_a_k1_miscount(
        tmp_path, counting_tier, monkeypatch):  # noqa: F811
    gather, calls = counting_tier._gather_merge, [0]

    def twice_once(table, slots, miss_rows, pdl):
        out = gather(table, slots, miss_rows, pdl)
        calls[0] += 1
        if calls[0] == 40:  # one K1 counted twice, mid-run
            counting_tier.GATHER_LAUNCHES += 1
        return out

    monkeypatch.setattr(counting_tier, "_gather_merge", twice_once)
    with pytest.raises(SystemExit, match="formula"):
        chip_smoke.promoted_phase(torch, np, counting_tier, str(tmp_path),
                                  device="cpu", **SMALL)


def test_feature_zoo_rehearses(tmp_path):
    zoo = chip_smoke.feature_zoo_phase(torch, np, str(tmp_path),
                                       device="cpu", zoo=SMALL_ZOO)
    assert set(zoo) == {name for name, *_ in SMALL_ZOO}
    agree = zoo["census_wide_deep"]["agreement"]
    assert agree["grad_worst_rel_l2"] <= chip_smoke.FEATURE_AGREE_RTOL


def test_table_job_rehearses(tmp_path):
    """Phase 17's table job on the CPU at the card's size: iris over an
    in-process table (the rows of iris_job's CSV files), every row once
    an epoch, the accuracy floor, and the prediction-only job's rows
    read back from its table bit-equal to ``eval_step``."""
    record = chip_smoke.table_job(torch, np, str(tmp_path), device="cpu")
    assert record["train_tasks_done"] == 15 * chip_smoke.IRIS_EPOCHS
    assert record["model_version"] == record["steps"] == 150
    assert record["accuracy"] >= chip_smoke.IRIS_ACCURACY_FLOOR
    assert record["prediction_tasks_done"] == 8
    assert record["rows_written"] == chip_smoke.IRIS_ROWS
    assert record["read_back_bit_equal"]


def test_table_job_refuses_a_prediction_off(tmp_path, monkeypatch):
    """A processor that lands one row off (its first value nudged by an
    ulp) fails the read-back check."""
    from elasticdl_tpu_torch.data import table_writer

    write = table_writer.TableWriter.write

    def nudged(self, rows):
        rows = {k: np.array(v, copy=True) for k, v in rows.items()}
        first = rows["output"].reshape(-1)
        first[0] = np.nextafter(first[0], np.float32(np.inf))
        return write(self, rows)

    monkeypatch.setattr(table_writer.TableWriter, "write", nudged)
    with pytest.raises(SystemExit, match="read back bit-equal"):
        chip_smoke.table_job(torch, np, str(tmp_path), device="cpu")

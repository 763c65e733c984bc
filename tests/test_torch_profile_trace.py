"""The port's profiler region (common/timing_utils.py ``trace`` and
``step_annotation``, the reference's ``jax.profiler`` region in its
``torch.profiler`` form) on the CPU: with ``EDL_PROFILE_DIR`` set the
region writes a chrome trace holding its step annotations and the ops
run inside; unset, both are no-ops that write nothing.
"""

import glob
import json
import os

import torch

from elasticdl_tpu_torch.common import timing_utils


def test_trace_writes_a_chrome_trace_with_its_annotations(tmp_path,
                                                          monkeypatch):
    monkeypatch.setenv(timing_utils.PROFILE_DIR_ENV, str(tmp_path))
    a = torch.randn(64, 64)
    with timing_utils.trace("edl_train") as prof:
        assert prof is not None
        for step in range(3):
            with timing_utils.step_annotation("train_step", step):
                a = torch.tanh(a @ a)
    files = glob.glob(os.path.join(str(tmp_path), "edl_train",
                                   "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"train_step#0", "train_step#1", "train_step#2"} <= names
    assert any(n and "mm" in n for n in names)


def test_trace_is_a_noop_without_the_knob(tmp_path, monkeypatch):
    monkeypatch.delenv(timing_utils.PROFILE_DIR_ENV, raising=False)
    monkeypatch.chdir(tmp_path)
    with timing_utils.trace("edl_train") as prof:
        with timing_utils.step_annotation("train_step", 0):
            torch.ones(2) + 1
    assert prof is None
    assert os.listdir(str(tmp_path)) == []

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
    + [("TIER_MUTATIONS", name, chip_smoke.TIER_SOURCE, edits)
       for name, edits in chip_smoke.TIER_MUTATIONS]
    + [("K3_VARIANTS", name, chip_smoke.TIER_SOURCE, edits)
       for name, edits in chip_smoke.K3_VARIANTS.items() if edits]
    + [("K1_CHAIN_VARIANTS", name, chip_smoke.TIER_SOURCE, edits)
       for name, edits in chip_smoke.K1_CHAIN_VARIANTS.items() if edits]
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

"""The port's stream sources (stream/source.py) against the reference's,
on the CPU: a synthetic window is a pure function of ``(seed, index)``,
so the port's spool files are byte-equal to the reference's, decode to
the same ids and labels, carry the same drift stats, and stay so after a
``seek``; ``planted_weight`` is equal; the bounded replay covers every
shard over its passes, window for window as the reference does.
"""

import numpy as np
import pytest

from elasticdl_tpu.data import example as ref_example
from elasticdl_tpu.data import recordio as ref_recordio
from elasticdl_tpu.stream import source as ref_source
from elasticdl_tpu_torch.data import example as port_example
from elasticdl_tpu_torch.data import recordio as port_recordio
from elasticdl_tpu_torch.stream import source as port_source

SOURCES = {"ref": ref_source, "port": port_source}
KWARGS = dict(records_per_window=32, num_features=4, hot_vocab=50,
              drift_per_window=5, total_records=96, seed=3)


def _walk(source):
    windows = []
    while True:
        window = source.next_window()
        if window is None:
            return windows
        windows.append(window)


def _decode(path, recordio, example, n):
    with recordio.RecordReader(path) as reader:
        payloads = list(reader.read_range(0, n))
    decoded = [example.decode_example(p) for p in payloads]
    return (np.stack([d["ids"] for d in decoded]),
            np.array([int(d["label"]) for d in decoded]))


@pytest.mark.parametrize("side", sorted(SOURCES))
def test_synthetic_source_deterministic_and_seekable(side, tmp_path):
    module = SOURCES[side]
    source = module.SyntheticClickstreamSource(str(tmp_path / "a"),
                                               **KWARGS)
    windows = _walk(source)
    assert len(windows) == 3 and source.exhausted
    assert all(w.records == 32 for w in windows)
    ids0, _ = source.window_examples(0)
    ids2, _ = source.window_examples(2)
    assert ids2.max() > ids0.max()
    other = module.SyntheticClickstreamSource(str(tmp_path / "b"), **KWARGS)
    other.seek(1)
    regen = other.next_window()
    with open(windows[1].shard_name, "rb") as f:
        original = f.read()
    with open(regen.shard_name, "rb") as f:
        assert f.read() == original
    ids, labels = _decode(windows[0].shard_name, port_recordio,
                          port_example, 32)
    assert ids.shape == (32, 4)
    assert set(labels.tolist()) <= {0, 1}


@pytest.mark.parametrize("seed,drift,total", [
    (3, 5, 96), (0, 0, 0), (11, 20, 200), (2 ** 31 + 7, 13, 320),
])
def test_windows_equal_across_packages(tmp_path, seed, drift, total):
    kwargs = dict(records_per_window=64, num_features=6, hot_vocab=400,
                  zipf_a=1.3, drift_per_window=drift, total_records=total,
                  seed=seed)
    walked = {}
    for side, module in SOURCES.items():
        source = module.SyntheticClickstreamSource(
            str(tmp_path / side), **kwargs)
        windows = []
        for _ in range(6):
            window = source.next_window()
            if window is None:
                break
            windows.append(window)
        walked[side] = (source, windows)
    ref_windows, port_windows = walked["ref"][1], walked["port"][1]
    assert len(ref_windows) == len(port_windows) > 0
    for ref_w, port_w in zip(ref_windows, port_windows):
        assert (ref_w.start, ref_w.end) == (port_w.start, port_w.end)
        assert ref_w.stats == port_w.stats
        with open(ref_w.shard_name, "rb") as f:
            ref_bytes = f.read()
        with open(port_w.shard_name, "rb") as f:
            assert f.read() == ref_bytes
        ref_ids, ref_labels = _decode(ref_w.shard_name, ref_recordio,
                                      ref_example, ref_w.records)
        port_ids, port_labels = _decode(port_w.shard_name, port_recordio,
                                        port_example, port_w.records)
        np.testing.assert_array_equal(port_ids, ref_ids)
        np.testing.assert_array_equal(port_labels, ref_labels)
    for index in range(len(ref_windows)):
        for got, want in zip(walked["port"][0].window_examples(index),
                             walked["ref"][0].window_examples(index)):
            np.testing.assert_array_equal(got, want)


def test_windows_equal_after_seek(tmp_path):
    """A relaunched master's feeder seeks the source: both packages
    re-mint the same window at the same position, drift stats reset."""
    kwargs = dict(records_per_window=48, num_features=5, hot_vocab=300,
                  drift_per_window=7, total_records=48 * 10, seed=9)
    minted = {}
    for side, module in SOURCES.items():
        source = module.SyntheticClickstreamSource(str(tmp_path / side),
                                                   **kwargs)
        source.seek(4)
        first = source.next_window()
        second = source.next_window()
        minted[side] = (first, second)
        with open(second.shard_name, "rb") as f:
            minted[side] += (f.read(),)
    assert minted["port"][0].stats == minted["ref"][0].stats
    assert minted["port"][0].stats["novelty_rate"] == 0.0
    assert minted["port"][1].stats == minted["ref"][1].stats
    assert minted["port"][2] == minted["ref"][2]


def test_planted_weight_equal_across_packages():
    rng = np.random.RandomState(0)
    ids = np.concatenate([
        rng.randint(0, 2 ** 62, size=1000, dtype=np.int64),
        np.array([0, 1, 2, 1, 2 ** 63 - 1], np.int64),
    ])
    got = port_source.planted_weight(ids)
    np.testing.assert_array_equal(got, ref_source.planted_weight(ids))
    assert got[1001] == got[1003]
    assert (np.abs(got) <= 1.0).all()


class FakeReader:
    def create_shards(self):
        return {"a.rec": (0, 100), "b.rec": (0, 30), "c.rec": (10, 70)}


@pytest.mark.parametrize("passes", [1, 2, 3])
def test_bounded_replay_covers_every_shard_like_the_reference(passes):
    walked = {}
    for side, module in SOURCES.items():
        source = module.BoundedReplaySource(
            FakeReader(), records_per_window=64, passes=passes)
        walked[side] = [(w.shard_name, w.start, w.end)
                        for w in _walk(source)]
        assert source.exhausted
        assert source.total_windows == len(walked[side])
    assert walked["port"] == walked["ref"]
    one_pass = walked["port"][:len(walked["port"]) // passes]
    covered = {}
    for name, start, end in one_pass:
        covered.setdefault(name, []).append((start, end))
    assert covered == {"a.rec": [(0, 64), (64, 100)], "b.rec": [(0, 30)],
                       "c.rec": [(10, 74), (74, 80)]}
    for p in range(passes):
        assert walked["port"][p * len(one_pass):(p + 1) * len(one_pass)] \
            == one_pass


def test_bounded_replay_seek():
    source = port_source.BoundedReplaySource(FakeReader(),
                                             records_per_window=64,
                                             passes=2)
    source.seek(9)
    assert not source.exhausted
    assert (source.next_window().shard_name) == "c.rec"
    assert source.exhausted


def _oracle_holdout(drift, windows=24, seen=20):
    """Phase 18's stream (chip_smoke.py's CONTINUAL_* sizes, seed 7):
    the holdout's logloss under an oracle that knows the planted weight
    of every id seen ``seen`` times in the ``windows`` training windows
    and takes 0 for the rest, and the base-rate logloss of its labels.
    The holdout is the two windows after the stream's end."""
    source = port_source.SyntheticClickstreamSource(
        "/nonexistent", records_per_window=8192, num_features=39,
        hot_vocab=200_000, zipf_a=1.3, drift_per_window=drift, seed=7)
    train = np.concatenate([source.window_examples(i)[0].ravel()
                            for i in range(windows)])
    ids, counts = np.unique(train, return_counts=True)
    known = ids[counts >= seen]
    hold = [source.window_examples(windows + k) for k in range(2)]
    hold_ids = np.concatenate([h[0] for h in hold])
    labels = np.concatenate([h[1] for h in hold]).astype(np.float64)
    weights = np.where(np.isin(hold_ids, known),
                       port_source.planted_weight(hold_ids), 0.0)
    logits = 8.0 * weights.mean(axis=1)
    logloss = float(np.mean(np.logaddexp(0.0, logits) - labels * logits))
    p = labels.mean()
    return logloss, float(-(p * np.log(p) + (1 - p) * np.log(1 - p)))


def test_phase18_holdout_is_learnable_only_under_a_slow_slide():
    """Why phase 18 slides its hot set 20 ids a window and not 2,000 or
    20,000: a label is a steep logistic over the mean planted weight of
    its ids, and the holdout is learnable only where its Zipf head was
    trained. Under a slide of 20 an oracle that knows every id seen 20
    times in training beats the holdout's base rate by a wide margin;
    under 2,000 or 20,000 even that oracle does worse than the base
    rate, so no trained model could pass the phase's learning check."""
    slow, slow_base = _oracle_holdout(20)
    assert slow < slow_base - 0.15, (slow, slow_base)
    for drift in (2_000, 20_000):
        fast, fast_base = _oracle_holdout(drift)
        assert fast > fast_base, (drift, fast, fast_base)

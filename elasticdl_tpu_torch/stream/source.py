"""Stream sources: where unbounded training windows come from.

(Copy of elasticdl_tpu/stream/source.py for the PyTorch port.)

A stream source mints :class:`StreamWindow` record ranges for the
master's :class:`~elasticdl_tpu_torch.stream.feeder.StreamFeeder`, which
turns each into a dispatcher task. Two implementations:

- :class:`BoundedReplaySource` — replays an existing reader's shards
  window by window (optionally for several passes): turns any batch
  dataset into a stream for drills, benches, and migration testing,
  and is the bounded case the drain contract needs.
- :class:`SyntheticClickstreamSource` — generates a clickstream with a
  Zipfian id distribution whose vocabulary DRIFTS (the hot set slides
  by ``drift_per_window`` ids every window, so novel ids keep arriving
  and old ones fade — the unbounded-vocab regime the embedding
  lifecycle exists for). Windows are written as recordio files into a
  spool directory shared with the workers (same schema as the CTR
  fixtures: ``{"ids": int64 [F], "label": int64}``, which the deepfm/
  ctr model zoo consumes unchanged).

Determinism + resume: every window is generated by an RNG seeded from
``(seed, window_index)`` alone, and labels come from a hash-planted
per-id weight — so ``seek(pos)`` after a master relaunch regenerates
the exact stream the dead predecessor would have minted, and a window
file lost with a dead spool re-creates bit-identical content.
"""

import os
import threading

import numpy as np

from elasticdl_tpu_torch.common.log_utils import default_logger as _logger_factory

logger = _logger_factory("elasticdl_tpu_torch.stream.source")


class StreamWindow:
    """One minted window: a record range of a shard the workers' data
    reader can open. ``stats`` (optional) carries the window's
    training-health drift signals: label rate and
    id-novelty rate vs the previous window — sources that cannot see
    their labels (replay) leave it None."""

    __slots__ = ("shard_name", "start", "end", "stats")

    def __init__(self, shard_name, start, end, stats=None):
        self.shard_name = shard_name
        self.start = int(start)
        self.end = int(end)
        self.stats = stats

    @property
    def records(self):
        return self.end - self.start

    def __repr__(self):
        return "StreamWindow(%r, %d, %d)" % (
            self.shard_name, self.start, self.end
        )


class StreamSource:
    """Contract: ``next_window()`` returns the next StreamWindow, or
    None when the source is permanently exhausted (``exhausted`` is
    then True). ``seek(pos)`` positions the source so the next call
    returns window ``pos`` — the feeder calls it with the dispatcher's
    journaled ``stream_pos()`` so a master relaunch never re-mints a
    delivered window."""

    def next_window(self):
        raise NotImplementedError

    def seek(self, pos):
        raise NotImplementedError

    @property
    def exhausted(self):
        raise NotImplementedError


class BoundedReplaySource(StreamSource):
    """Replay an ``AbstractDataReader``'s shards as a window stream."""

    def __init__(self, reader, records_per_window=1024, passes=1):
        self._records_per_window = max(1, int(records_per_window))
        self._passes = max(1, int(passes))
        self._pos = 0
        # one pass's window list, fixed at construction (sorted shard
        # order — the reader contract already sorts for determinism)
        self._windows = []
        for name, (start, num_records) in reader.create_shards().items():
            end = start + num_records
            for lo in range(start, end, self._records_per_window):
                self._windows.append(
                    (name, lo, min(lo + self._records_per_window, end))
                )

    @property
    def total_windows(self):
        return len(self._windows) * self._passes

    @property
    def exhausted(self):
        return self._pos >= self.total_windows

    def seek(self, pos):
        self._pos = int(pos)

    def next_window(self):
        if self.exhausted:
            return None
        name, lo, hi = self._windows[self._pos % len(self._windows)]
        self._pos += 1
        return StreamWindow(name, lo, hi)


def planted_weight(ids):
    """Deterministic per-id weight in [-1, 1), planted by hashing the
    id — label structure every window of the stream shares, so holdout
    windows measure real generalization. Vectorized over int64 ids."""
    u = np.asarray(ids, dtype=np.uint64)
    with np.errstate(over="ignore"):
        h = (u * np.uint64(0x9E3779B97F4A7C15)) >> np.uint64(40)
    return (h.astype(np.float64) / float(1 << 24)) * 2.0 - 1.0


class SyntheticClickstreamSource(StreamSource):
    """Zipfian clickstream with vocab churn, spooled as recordio.

    Ids are ``offset(t) + zipf_rank`` where the offset slides by
    ``drift_per_window`` every window: the hot set at any instant is
    ~``hot_vocab`` ids, but over the stream's life the union of ids is
    unbounded — exactly the regime where an admission/eviction-free PS
    grows without bound. Labels are a logistic draw over the mean
    planted weight of the example's ids, so a model that keeps the
    (current) hot set's rows trained predicts well and cold-served
    tail ids cost only their own (rare) examples.
    """

    FILE_PATTERN = "stream-%08d.rec"

    def __init__(self, spool_dir, records_per_window=1024,
                 num_features=10, hot_vocab=2000, zipf_a=1.3,
                 drift_per_window=0, total_records=0, seed=0,
                 keep_windows=512):
        self._spool_dir = spool_dir
        self._records_per_window = max(1, int(records_per_window))
        self._num_features = int(num_features)
        self._hot_vocab = max(2, int(hot_vocab))
        self._zipf_a = float(zipf_a)
        self._drift = max(0, int(drift_per_window))
        self._total_records = max(0, int(total_records))  # 0 = unbounded
        self._seed = int(seed)
        self._keep_windows = max(2, int(keep_windows))
        self._pos = 0
        self._lock = threading.Lock()
        # previous window's unique id set, for the id-novelty rate
        #; reset by seek — a relaunched master's first
        # window then reports novelty 0.0 rather than a false spike
        self._prev_unique = None
        os.makedirs(spool_dir, exist_ok=True)

    @property
    def exhausted(self):
        if not self._total_records:
            return False
        return self._pos * self._records_per_window >= self._total_records

    def seek(self, pos):
        with self._lock:
            self._pos = int(pos)
            self._prev_unique = None

    # ------------------------------------------------------------------
    def window_examples(self, index):
        """(ids [n, F] int64, labels [n] int64) of window ``index`` —
        pure function of (seed, index), so resume/replay regenerate
        identical windows. Exposed for in-process benches that want
        the stream without spool files."""
        rng = np.random.RandomState(
            (self._seed * 1000003 + index) % (2 ** 32)
        )
        n = self._records_per_window
        if self._total_records:
            already = index * self._records_per_window
            n = max(0, min(n, self._total_records - already))
        # Zipf ranks clipped into the hot vocab, slid by the drift
        ranks = rng.zipf(self._zipf_a, size=(n, self._num_features))
        ranks = np.minimum(ranks - 1, self._hot_vocab - 1)
        ids = (ranks + index * self._drift).astype(np.int64)
        score = planted_weight(ids).mean(axis=1)
        # steep logistic: labels are strongly (not perfectly)
        # determined by the planted weights, so a model that keeps the
        # hot set's rows trained clearly beats the base rate
        p = 1.0 / (1.0 + np.exp(-8.0 * score))
        labels = (rng.uniform(size=n) < p).astype(np.int64)
        return ids, labels

    def window_path(self, index):
        return os.path.join(self._spool_dir, self.FILE_PATTERN % index)

    def _window_stats_locked(self, ids, labels):
        """Training-health drift stats for one window:
        label rate, and the fraction of this window's unique ids that
        the PREVIOUS window never carried (the drift signal — a
        healthy Zipfian stream with drift d has a steady novelty rate;
        a jump means the source's hot set moved). Updates the
        previous-window set."""
        unique = np.unique(ids)
        prev = self._prev_unique
        self._prev_unique = unique
        if prev is None or unique.size == 0:
            novelty = 0.0
        else:
            novel = np.setdiff1d(unique, prev, assume_unique=True)
            novelty = float(novel.size) / float(unique.size)
        label_rate = (
            float(np.mean(labels)) if np.size(labels) else 0.0
        )
        return {
            "label_rate": round(label_rate, 6),
            "novelty_rate": round(novelty, 6),
        }

    def _write_window(self, index, ids, labels):
        """Spool window ``index`` atomically (tmp + rename): a worker's
        reader must never open a torn file. Idempotent — an existing
        file (a master relaunch re-walking old positions) is kept."""
        from elasticdl_tpu_torch.data.example import encode_example
        from elasticdl_tpu_torch.data.recordio import write_records

        path = self.window_path(index)
        if os.path.exists(path):
            from elasticdl_tpu_torch.data import recordio

            # re-walked position (relaunch raced seek): keep the file
            # the workers may already hold tasks against
            return path, recordio.count_records(path)
        payloads = [
            encode_example({"ids": ids[i], "label": labels[i]})
            for i in range(ids.shape[0])
        ]
        tmp = path + ".tmp"
        write_records(tmp, payloads)
        os.replace(tmp, path)
        return path, len(payloads)

    def _gc(self, index):
        """Drop spool files far behind the mint position. keep_windows
        is deliberately generous: a requeued task for a GC'd window is
        a retriable failure, not a correctness issue, but the default
        keeps the whole tail of any reasonable backlog."""
        victim = index - self._keep_windows
        if victim < 0:
            return
        try:
            os.unlink(self.window_path(victim))
        except OSError:
            pass

    def next_window(self):
        with self._lock:
            if self.exhausted:
                return None
            index = self._pos
            # window content is a pure function of (seed, index), so
            # regenerating it here for the drift stats matches the
            # spool file byte-for-byte even when the file already
            # exists (a relaunch re-walking old positions)
            ids, labels = self.window_examples(index)
            path, n = self._write_window(index, ids, labels)
            if n <= 0:
                self._pos = index  # nothing left to mint
                return None
            self._pos = index + 1
            self._gc(index)
            return StreamWindow(
                path, 0, n, stats=self._window_stats_locked(ids, labels)
            )


def replay_source_for(data_origin, records_per_window=1024, passes=1,
                      reader_params=None):
    """BoundedReplaySource over whatever reader ``data_origin``
    resolves to (the EDL_STREAM=replay path)."""
    from elasticdl_tpu_torch.data.readers import create_data_reader

    reader = create_data_reader(data_origin, **(reader_params or {}))
    return BoundedReplaySource(
        reader, records_per_window=records_per_window, passes=passes
    )

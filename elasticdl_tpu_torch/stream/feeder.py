"""Master-side stream feeder: windows -> watermark tasks -> exports.

(Copy of elasticdl_tpu/stream/feeder.py for the PyTorch port.)

Runs as one daemon thread on the master (started in Master.prepare
when EDL_STREAM selects a source). Each tick it:

1. **Mints tasks** from arriving windows, flow-controlled by the
   minted-minus-completed record backlog (``max_backlog_records``): a
   fast source must not materialize an unbounded todo queue — windows
   wait in the source until the fleet catches up. This is also what
   keeps the watermark MEANINGFUL: backlog is bounded, so the
   watermark trails the stream head by a bounded gap.
2. **Mints export tasks** each time the watermark crosses an
   ``export_every``-records boundary (EDL_STREAM_EXPORT_EVERY): one
   worker joins its async pushes, flushes its device tier, and writes
   a fresh export — the serving tier's signature watcher then
   hot-swaps onto it. The streaming replacement for the end-of-job
   export, journaled as ``stream_watermark`` events.
3. **Closes the stream** once the source reports exhaustion (bounded
   replay / total-records cap) and every minted window completed:
   ``dispatcher.close_stream()`` flips ``finished()`` to the normal
   drain contract. Waiting for the drain (the reference closes at
   exhaustion) lets the export cadence cover the stream's last
   boundary before the job's train-end export, which the close
   releases.

Resume: the feeder seeks the source to the dispatcher's journaled
``stream_pos()`` before the first tick, so a relaunched master resumes
minting exactly after the last journaled window — no window delivered
twice (done-exactly-once extended to watermark tasks).
"""

import threading

from elasticdl_tpu_torch.common.env_utils import env_float, env_int, env_str
from elasticdl_tpu_torch.common.log_utils import default_logger as _logger_factory
from elasticdl_tpu_torch.observability import events

logger = _logger_factory("elasticdl_tpu_torch.stream.feeder")

STREAM_ENV = "EDL_STREAM"
WINDOW_RECORDS_ENV = "EDL_STREAM_WINDOW_RECORDS"
TOTAL_RECORDS_ENV = "EDL_STREAM_TOTAL_RECORDS"
CHECKPOINT_EVERY_ENV = "EDL_STREAM_CHECKPOINT_EVERY"
EXPORT_EVERY_ENV = "EDL_STREAM_EXPORT_EVERY"
MAX_BACKLOG_ENV = "EDL_STREAM_MAX_BACKLOG"
PASSES_ENV = "EDL_STREAM_PASSES"
HOT_VOCAB_ENV = "EDL_STREAM_HOT_VOCAB"
DRIFT_ENV = "EDL_STREAM_DRIFT"
FEATURES_ENV = "EDL_STREAM_FEATURES"
ZIPF_ENV = "EDL_STREAM_ZIPF_A"
SEED_ENV = "EDL_STREAM_SEED"


def source_from_env(training_data, reader_params=None):
    """Build the stream source EDL_STREAM selects, or None.

    - ``EDL_STREAM=synthetic``: clickstream generator spooling
      recordio windows into ``training_data`` (the workers read the
      spool through their ordinary reader — the dir IS the dataset).
    - ``EDL_STREAM=replay``: bounded replay of whatever reader
      ``training_data`` resolves to, EDL_STREAM_PASSES times.
    """
    mode = env_str(STREAM_ENV, "").strip().lower()
    if not mode or mode == "0":
        return None
    window_records = env_int(WINDOW_RECORDS_ENV, 512)
    if mode == "synthetic":
        from elasticdl_tpu_torch.stream.source import SyntheticClickstreamSource

        if not training_data:
            raise ValueError(
                "EDL_STREAM=synthetic needs --training_data as the "
                "spool directory the workers read"
            )
        return SyntheticClickstreamSource(
            training_data,
            records_per_window=window_records,
            num_features=env_int(FEATURES_ENV, 10),
            hot_vocab=env_int(HOT_VOCAB_ENV, 2000),
            zipf_a=env_float(ZIPF_ENV, 1.3),
            drift_per_window=env_int(DRIFT_ENV, 0),
            total_records=env_int(TOTAL_RECORDS_ENV, 0),
            seed=env_int(SEED_ENV, 0),
        )
    if mode == "replay":
        from elasticdl_tpu_torch.stream.source import replay_source_for

        return replay_source_for(
            training_data,
            records_per_window=window_records,
            passes=env_int(PASSES_ENV, 1),
            reader_params=reader_params,
        )
    raise ValueError(
        "unknown %s=%r (expected 'synthetic' or 'replay')"
        % (STREAM_ENV, mode)
    )


class StreamFeeder:
    def __init__(self, dispatcher, source, saved_model_path="",
                 export_every=None, max_backlog_records=None,
                 poll_secs=0.5, fleet=None):
        self._dispatcher = dispatcher
        self._source = source
        self._saved_model_path = saved_model_path
        # training-health fold: windows carrying drift
        # stats (label rate, id-novelty rate) feed the fleet monitor's
        # label_shift detector directly — the feeder runs in the
        # master process, no RPC
        self._fleet = fleet
        self._last_window_stats = None
        self._export_every = (
            export_every
            if export_every is not None
            else env_int(EXPORT_EVERY_ENV, 0)
        )
        self._max_backlog = (
            max_backlog_records
            if max_backlog_records is not None
            else env_int(MAX_BACKLOG_ENV, 8192)
        )
        self._poll_secs = poll_secs
        self._export_mark = None
        self._exports_minted = 0
        self._windows_minted = 0
        self._stop = threading.Event()
        self._thread = None

    # ------------------------------------------------------------------
    def start(self):
        # resume AFTER the dispatcher replayed its journal: the source
        # continues exactly past the last journaled window
        self._source.seek(self._dispatcher.stream_pos())
        self._thread = threading.Thread(
            target=self._run, name="stream-feeder", daemon=True
        )
        self._thread.start()
        logger.info(
            "Stream feeder started at source pos %d (backlog cap %d "
            "records, export every %s records)",
            self._dispatcher.stream_pos(), self._max_backlog,
            self._export_every or "-",
        )

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    def _run(self):
        try:
            while not self._stop.wait(self._poll_secs):
                self.tick()
                if (self._source.exhausted
                        and self._dispatcher.stream_state()[
                            "backlog_records"] <= 0):
                    self._dispatcher.close_stream()
                    events.emit(
                        "stream_watermark",
                        watermark=self._dispatcher.stream_watermark(),
                        minted=self._dispatcher.stream_pos(),
                        kind="closed",
                    )
                    return
        except Exception:
            # a feeder crash must be LOUD but not kill the master: the
            # job degrades to draining what was minted
            logger.exception("stream feeder failed; closing stream")
            try:
                self._dispatcher.close_stream()
            except Exception:
                logger.exception("closing the stream also failed")

    # ------------------------------------------------------------------
    def tick(self):
        """One feeder pass: mint windows up to the backlog cap, then
        check the export cadence. Callable directly (tests drive ticks
        without the thread)."""
        minted = 0
        while not self._stop.is_set():
            state = self._dispatcher.stream_state()
            if not state["open"]:
                return minted
            if state["backlog_records"] >= self._max_backlog:
                break  # fleet is behind; let the watermark catch up
            window = self._source.next_window()
            if window is None:
                break
            self._dispatcher.add_stream_window(
                window.shard_name, window.start, window.end
            )
            self._windows_minted += 1
            minted += 1
            stats = getattr(window, "stats", None)
            if stats is not None:
                # tag drift with the record offset this window lands
                # at (== the watermark once the window completes), so
                # a label_shift alert points at a WINDOW, not a time
                minted_records = self._dispatcher.stream_state()[
                    "minted_records"
                ]
                self._last_window_stats = dict(
                    stats, watermark=minted_records
                )
                if self._fleet is not None:
                    self._fleet.observe_stream_window(
                        minted_records,
                        stats["label_rate"],
                        stats["novelty_rate"],
                    )
        self._maybe_export()
        return minted

    def _maybe_export(self):
        if self._export_every <= 0 or not self._saved_model_path:
            return
        watermark = self._dispatcher.stream_watermark()
        boundary = watermark // self._export_every
        if self._export_mark is None:
            # anchor only: a restarted master must not re-export the
            # boundary its predecessor already covered
            self._export_mark = boundary
            return
        if boundary <= self._export_mark:
            return
        self._export_mark = boundary
        self._dispatcher.add_stream_export_task(
            {"saved_model_path": self._saved_model_path}
        )
        self._exports_minted += 1
        events.emit(
            "stream_watermark", watermark=watermark,
            minted=self._dispatcher.stream_pos(), kind="export",
        )
        logger.info(
            "Stream export task minted at watermark %d", watermark
        )

    def state(self):
        """/statusz section."""
        body = dict(self._dispatcher.stream_state())
        body.update({
            "exports_minted": self._exports_minted,
            "export_every": self._export_every,
            "max_backlog_records": self._max_backlog,
            "source_exhausted": bool(self._source.exhausted),
            "last_window_stats": self._last_window_stats,
        })
        return body

"""Model-version lifecycle: load, watch, warm, atomically swap (port of
elasticdl_tpu/serve/engine.py).

The engine owns the active ``ServingModel`` reference and, for a model
with sparse tables served over the PS (``ps_client``), the embedding
cache every version shares: a ``HotRowCache`` with a wall-clock TTL
(``cache_ttl_secs``, else ``EDL_SERVE_CACHE_TTL_SECS`` or 2 s; 0 turns
it off), thread-safe. A PS relaunch (the restored-version stamp changing
on a pull answer) drops that cache from whatever thread saw it: the
engine chains ``_on_ps_restart`` onto the PS client's resync hook. A watcher thread
polls the export's signature (``EDL_SERVE_WATCH_SECS``); when it
changes, the replacement version is built and WARMED in the background
while the active version keeps serving, then swapped in with one
reference assignment. A batch that already entered ``_run_batch`` holds
its own model reference, so in-flight requests finish on the version
that admitted them. The exporter rewrites a bundle in place as
model.npz, then manifest.json: a new npz under the manifest the active
version was read with is mid-rewrite, and the watcher waits for its
manifest; it takes the npz alone only once it has stood unchanged for
``REWRITE_SETTLE_SECS`` (a copy that wrote the manifest first).

Directed mode (``directed=True``, a fleet replica): ``export_dir`` is a
versioned root holding one subdirectory per export bundle, and the
router steers which version this replica loads through ``set_target``;
until the first directive the newest complete bundle wins. Undirected
(single pod) keeps the flat layout and follows whatever lands in
``export_dir``.

The ``edl_serve_model_info``, ``edl_serve_version_swaps_total`` and
``edl_serve_cache_hit_rate`` series and the ``model_loaded``,
``version_swapped`` and ``requests_shed`` events follow the lifecycle.
"""

import os
import threading
import time

from elasticdl_tpu_torch.common.device import resolve_device
from elasticdl_tpu_torch.common.log_utils import (
    default_logger as _logger_factory,
)
from elasticdl_tpu_torch.embedding.client import HotRowCache
from elasticdl_tpu_torch.models.registry import get_model_spec
from elasticdl_tpu_torch.observability import events, metrics
from elasticdl_tpu_torch.serve.batcher import MicroBatcher, _env_num
from elasticdl_tpu_torch.serve.fleet import scan_export_versions
from elasticdl_tpu_torch.serve.model import ServingModel, export_signature

logger = _logger_factory("elasticdl_tpu_torch.serve.engine")

WATCH_SECS_ENV = "EDL_SERVE_WATCH_SECS"
CACHE_TTL_ENV = "EDL_SERVE_CACHE_TTL_SECS"
# at most one requests_shed event per window: a shed storm must not
# flood the journal at the moment it matters most
_SHED_EVENT_WINDOW_SECS = 1.0
# how long a new model.npz under the active version's manifest waits
# for its own manifest before the watcher loads it anyway
REWRITE_SETTLE_SECS = 5.0


def _npz_rewritten_under(model, export_dir, signature):
    """True when ``signature`` shows a new model.npz in the directory
    ``model`` was loaded from, under the manifest it was loaded with."""
    if model is None or model.export_path != export_dir:
        return False
    _, npz, manifest = signature.split(":")
    _, loaded_npz, loaded_manifest = model.stamp.split(":")
    return manifest == loaded_manifest and npz != loaded_npz


class ServingEngine:
    def __init__(self, model_zoo, export_dir, ps_client=None,
                 model_def="", model_params="", compute_dtype=None,
                 max_batch=None, max_delay_ms=None, queue_depth=None,
                 deadline_ms=None, cache_ttl_secs=None,
                 cache_capacity=1_000_000, watch_secs=None,
                 device="cuda", registry=None, directed=False):
        self.model_zoo = model_zoo
        self.export_dir = export_dir
        self._directed = bool(directed)
        self._target_rel = None  # None = no directive yet: newest wins
        self._loaded_rel = ""
        self.device = resolve_device(device)
        self._ps = ps_client
        self._compute_dtype = compute_dtype
        self.spec = get_model_spec(
            model_zoo, model_def=model_def, model_params=model_params
        )
        if cache_ttl_secs is None:
            cache_ttl_secs = _env_num(CACHE_TTL_ENV, 2.0, float)
        self.cache = None
        if (self.spec.sparse_embedding_specs and ps_client is not None
                and cache_ttl_secs > 0):
            # no push thread bounds a served row's age: freshness is
            # wall-clock; thread-safe for the batcher, the warm-up and
            # the PS-restart hook
            self.cache = HotRowCache(capacity=cache_capacity,
                                     ttl_secs=cache_ttl_secs,
                                     thread_safe=True)
        # PS relaunches whose cache drop ran (tests and the smoke read it)
        self.cache_drops = 0
        if watch_secs is None:
            watch_secs = _env_num(WATCH_SECS_ENV, 2.0, float)
        self._watch_secs = float(watch_secs)
        self._model = None          # the active ServingModel
        self._swap_lock = threading.Lock()  # guards the stamp CAS only
        self._template = None       # (features, rows) of a recent batch
        self._stopped = threading.Event()
        self.swaps = 0
        self._last_shed_event = 0.0
        self._shed_at_last_event = 0
        reg = registry or metrics.default_registry()
        self._m_model_info = reg.gauge(
            "edl_serve_model_info",
            "1 for the loaded model version (export step), 0 for "
            "versions served earlier in this process's life",
            ("version",),
        )
        self._m_swaps = reg.counter(
            "edl_serve_version_swaps_total",
            "Completed model-version hot swaps",
        )
        self._m_cache_hit_rate = reg.gauge(
            "edl_serve_cache_hit_rate",
            "Lifetime hit fraction of the serving embedding row cache",
        )
        self.batcher = MicroBatcher(
            self._run_batch,
            max_batch=max_batch,
            max_delay_ms=max_delay_ms,
            queue_depth=queue_depth,
            default_deadline_ms=deadline_ms,
            on_shed=self._on_shed,
            registry=registry,
        )
        # read-only preparers never take the client's hook slot, so one
        # chain here covers every ServingModel build
        self._chain_resync_hook()
        self._watcher = threading.Thread(
            target=self._watch_loop, name="edl-serve-watcher", daemon=True
        )

    # ------------------------------------------------------------------
    def start(self, block=False):
        """Try the initial load, then start the export watcher. With
        ``block`` the call waits for a loadable export (tests);
        otherwise the role stays unloaded (predict answers
        FAILED_PRECONDITION) until the watcher sees one."""
        while True:
            try:
                self._load_and_swap()
            except FileNotFoundError:
                if not block:
                    logger.info(
                        "no export at %s yet; serving unready until one "
                        "appears", self.export_dir,
                    )
                    break
                time.sleep(0.2)
                continue
            break
        self._watcher.start()
        return self

    @property
    def loaded(self):
        return self._model is not None

    @property
    def loaded_export(self):
        """Rel name of the loaded version under the export root
        (directed mode); "" for the flat single-pod layout."""
        return self._loaded_rel

    def set_target(self, rel):
        """Directed mode: the router told this replica which version to
        run (canary membership, promote, or rollback). The watcher
        picks the change up on its next tick through the single-pod hot
        swap, in-flight requests finishing on the version that admitted
        them."""
        if not self._directed or not rel or rel == self._target_rel:
            return
        self._target_rel = rel
        logger.info("export target directed to %r", rel)

    def _resolve_export(self):
        """(directory, rel) the engine should be serving right now."""
        if not self._directed:
            return self.export_dir, ""
        rel = self._target_rel
        if not rel:
            # no directive yet (bootstrap): the newest complete bundle;
            # the router adopts whatever the fleet converged on as the
            # incumbent and pins everyone from then on
            versions = scan_export_versions(self.export_dir)
            if not versions:
                return self.export_dir, ""
            rel = versions[-1][0]
        return os.path.join(self.export_dir, rel), rel

    @property
    def model(self):
        return self._model

    def model_info(self):
        model = self._model
        return {
            "loaded": model is not None,
            "step": model.step if model is not None else -1,
            "stamp": model.stamp if model is not None else "",
            "model_zoo": str(self.model_zoo),
            "max_batch": self.batcher.max_batch,
        }

    # ------------------------------------------------------------------
    def _chain_resync_hook(self):
        """Wrap the PS client's current resync hook (a co-resident
        trainer's, or None) so a PS relaunch also drops the shared
        serving cache at once."""
        if self._ps is None or not hasattr(self._ps, "resync_hook"):
            return
        inner = self._ps.resync_hook

        def chained(shard, _inner=inner):
            if _inner is not None:
                _inner(shard)
            self._on_ps_restart(shard)

        self._ps.resync_hook = chained

    def _on_ps_restart(self, shard):
        if self.cache is not None:
            # rows cached from the dead process must serve no request
            self.cache.clear()
            self.cache_drops += 1
            logger.warning(
                "PS shard %s relaunched; serving embedding cache dropped",
                shard,
            )

    def _build(self, export_dir):
        return ServingModel(
            self.spec,
            export_dir,
            max_batch=self.batcher.max_batch,
            ps_client=self._ps,
            cache=self.cache,
            compute_dtype=self._compute_dtype,
            device=self.device,
        )

    def _load_and_swap(self):
        # build + warm OUTSIDE the swap lock: the lock guards only the
        # stamp compare-and-swap; a load that loses the race to the
        # same stamp drops its replacement
        export_dir, rel = self._resolve_export()
        previous = self._model
        replacement = self._build(export_dir)
        if previous is not None and replacement.stamp == previous.stamp:
            return False
        template = self._template
        if template is not None:
            try:
                replacement.warm(template[0], template[1])
            except Exception:
                logger.exception(
                    "warm-up of export %s failed; swapping cold",
                    replacement.stamp,
                )
        with self._swap_lock:
            previous = self._model
            if previous is not None and replacement.stamp == previous.stamp:
                return False
            self._model = replacement
            self._loaded_rel = rel
        self._m_model_info.labels(version=str(replacement.step)).set(1)
        if previous is not None:
            self._m_model_info.labels(version=str(previous.step)).set(0)
            self.swaps += 1
            self._m_swaps.inc()
            events.emit(
                "version_swapped",
                from_step=previous.step,
                to_step=replacement.step,
                stamp=replacement.stamp,
            )
            logger.info(
                "model version swapped: step %d -> %d (%s)",
                previous.step, replacement.step, replacement.stamp,
            )
        else:
            events.emit(
                "model_loaded",
                step=replacement.step,
                stamp=replacement.stamp,
                path=str(self.export_dir),
            )
            logger.info(
                "model loaded: step %d (%s) on %s",
                replacement.step, replacement.stamp, self.device,
            )
        return True

    def _watch_loop(self):
        pending = None  # (signature, first seen) of a mid-rewrite npz
        while not self._stopped.wait(self._watch_secs):
            try:
                export_dir = self._resolve_export()[0]
                signature = export_signature(export_dir)
                model = self._model
                if signature is None:
                    continue
                if model is not None and signature == model.stamp:
                    continue
                if _npz_rewritten_under(model, export_dir, signature):
                    if pending is None or pending[0] != signature:
                        pending = (signature, time.monotonic())
                    if time.monotonic() - pending[1] < REWRITE_SETTLE_SECS:
                        continue
                self._load_and_swap()
            except Exception:
                # a torn mid-write export fails here and succeeds on a
                # later tick; the active version keeps serving
                logger.exception("export watch tick failed")

    # ------------------------------------------------------------------
    def _run_batch(self, features, rows):
        model = self._model  # one read: in-flight batches keep theirs
        if model is None:
            raise RuntimeError("no model loaded")
        if self._template is None:
            self._template = (features, rows)
        outputs = model.predict(features, rows)
        if self.cache is not None:
            self._m_cache_hit_rate.set(model.embedding_hit_rate)
        return outputs, model.step, model.stamp

    def predict(self, features, rows, deadline_secs=None):
        """The servicer's entry: admission -> batch -> forward."""
        return self.batcher.submit(features, rows, deadline_secs)

    def _on_shed(self, reason, total):
        now = time.monotonic()
        if now - self._last_shed_event < _SHED_EVENT_WINDOW_SECS:
            return
        shed_since = total - self._shed_at_last_event
        self._last_shed_event = now
        self._shed_at_last_event = total
        events.emit(
            "requests_shed", reason=reason, count=shed_since, total=total
        )

    # ------------------------------------------------------------------
    def drain(self, timeout=30.0):
        """SIGTERM: stop admitting, flush the queue, stop the watcher.
        Returns the flushed-request count."""
        self._stopped.set()
        flushed = self.batcher.drain(timeout=timeout)
        if self._watcher.is_alive():
            self._watcher.join(timeout=self._watch_secs + 1.0)
        return flushed

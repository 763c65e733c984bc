"""Device-runtime observability on torch (port of
elasticdl_tpu/observability/device.py): device-memory accounting and
host<->device transfer attribution.

1. **Device-memory accounting** — ``memory_snapshot`` reads the CUDA
   caching allocator (``torch.cuda.memory_stats()``:
   ``allocated_bytes.all.current`` / ``.peak``) with the card's total
   memory from ``torch.cuda.mem_get_info()`` as the limit, ``source =
   "allocator"``. A process that never touched CUDA (the CPU path, the
   master) has no allocator view: ``source = "none"``, 0 bytes in use,
   ``EDL_HBM_LIMIT_BYTES`` as the limit, so the ``hbm_pressure`` fleet
   alert stays drillable on any box.
2. **Transfer attribution** — ``record_transfer`` / ``transfer_span``
   count host<->device bytes by direction and time a host-blocking
   transfer as a ``transfer`` span.

The reference's recompile sentinel (``instrumented_jit``, its
``edl_xla_*`` series and the AOT cost fetch) has no counterpart while
the port runs no compiled step: ``telemetry()`` reports its ``xla_*``
fields as 0 and ``EDL_DEVICE_COST_ANALYSIS`` is not read.

Nothing here synchronizes the device: allocator stats are host-side
books, and ``telemetry()`` is read at telemetry-RPC rate, never per
step.

Knobs: ``EDL_DEVICE_OBS`` (default 1; 0 turns every path here off and
``telemetry()`` into ``{}``), ``EDL_HBM_LIMIT_BYTES`` (default 0).
"""

import contextlib
import sys
import threading
import time

from elasticdl_tpu_torch.common.env_utils import env_bool, env_int
from elasticdl_tpu_torch.common.log_utils import (
    default_logger as _logger_factory,
)
from elasticdl_tpu_torch.observability import metrics as obs_metrics
from elasticdl_tpu_torch.observability import trace

logger = _logger_factory("elasticdl_tpu_torch.observability.device")

DEVICE_OBS_ENV = "EDL_DEVICE_OBS"
HBM_LIMIT_ENV = "EDL_HBM_LIMIT_BYTES"

_lock = threading.Lock()
# process-lifetime cumulative transfer totals
_totals = {"h2d_bytes": 0, "d2h_bytes": 0}

# lazy: the trainers import this module before a role's main()
# publishes EDL_METRICS_PORT (see metrics._LazyInstrument)
_m_transfer_bytes = obs_metrics.lazy_counter(
    "edl_device_transfer_bytes_total",
    "Host<->device transfer bytes attributed by direction",
    ("direction",),
)
_m_hbm_in_use = obs_metrics.lazy_gauge(
    "edl_device_hbm_bytes_in_use",
    "Device-memory bytes in use (allocator stats, or live-buffer "
    "fallback where the backend has no allocator)",
)
_m_hbm_peak = obs_metrics.lazy_gauge(
    "edl_device_hbm_peak_bytes",
    "Peak device-memory bytes observed (allocator peak, or the "
    "process-lifetime watermark of the fallback)",
)
_m_live_buffers = obs_metrics.lazy_gauge(
    "edl_device_live_buffers",
    "Live device arrays held by this process",
)


def device_obs_enabled():
    """The master gate: EDL_DEVICE_OBS=0 switches every path here off."""
    return env_bool(DEVICE_OBS_ENV, True)


# ---------------------------------------------------------------------------
# host<->device transfer attribution

def record_transfer(direction, nbytes):
    """Fold ``nbytes`` of attributed transfer into the counters
    (direction ``"h2d"`` or ``"d2h"``)."""
    if not device_obs_enabled() or nbytes <= 0:
        return
    _m_transfer_bytes.labels(direction=direction).inc(nbytes)
    with _lock:
        _totals["%s_bytes" % direction] += int(nbytes)


@contextlib.contextmanager
def transfer_span(direction, nbytes=0):
    """Time a host-blocking transfer (the row gradients' fetch to the
    host) as a ``transfer`` span and count its bytes. Inert when device
    obs is off."""
    if not device_obs_enabled():
        yield
        return
    t0 = time.time()
    try:
        yield
    finally:
        record_transfer(direction, nbytes)
        trace.complete(
            "transfer", t0, direction=direction, bytes=int(nbytes)
        )


# ---------------------------------------------------------------------------
# device-memory accounting

def _cuda_in_use():
    """torch.cuda when this process already initialized CUDA, else None.
    Never imports torch nor initializes a context: the master and a CPU
    role must not grow one by being asked for telemetry."""
    torch = sys.modules.get("torch")
    if torch is None:
        return None
    try:
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            return torch.cuda
    except Exception as e:
        logger.debug("cuda state unavailable: %s", e)
    return None


def memory_snapshot():
    """Allocator view of this process's device memory, JSON-ready.

    ``source`` is ``"allocator"`` once this process uses CUDA: bytes in
    use and the peak from the caching allocator's ``allocated_bytes``,
    live buffers its active blocks, the limit the card's total memory.
    Otherwise ``"none"``: 0 bytes, the limit from
    ``EDL_HBM_LIMIT_BYTES``."""
    if not device_obs_enabled():
        return {}
    in_use = peak = limit = arrays = 0
    source = "none"
    cuda = _cuda_in_use()
    if cuda is not None:
        try:
            stats = cuda.memory_stats()
            in_use = int(stats.get("allocated_bytes.all.current", 0))
            peak = int(stats.get("allocated_bytes.all.peak", 0))
            arrays = int(stats.get("active.all.current", 0))
            limit = int(cuda.mem_get_info()[1])
            source = "allocator"
        except Exception as e:
            logger.debug("allocator memory_stats unavailable: %s", e)
    if limit <= 0:
        limit = env_int(HBM_LIMIT_ENV, 0)
    _m_hbm_in_use.set(in_use)
    _m_hbm_peak.set(peak)
    _m_live_buffers.set(arrays)
    return {
        "bytes_in_use": int(in_use),
        "peak_bytes": int(peak),
        "limit_bytes": int(limit),
        "live_buffers": int(arrays),
        "source": source,
    }


# ---------------------------------------------------------------------------
# aggregation (telemetry-RPC rate, never per step)

def telemetry():
    """The device section of a role's TelemetryBlob, with the
    reference's keys: cumulative transfer totals and a fresh memory
    snapshot; the ``xla_*`` fields are 0 (no compiled step). Empty
    dict when device obs is off."""
    if not device_obs_enabled():
        return {}
    with _lock:
        totals = dict(_totals)
    mem = memory_snapshot()
    return {
        "xla_compiles": 0,
        "xla_recompiles": 0,
        "xla_compile_secs_total": 0.0,
        "hbm_bytes_in_use": mem.get("bytes_in_use", 0),
        "hbm_peak_bytes": mem.get("peak_bytes", 0),
        "hbm_limit_bytes": mem.get("limit_bytes", 0),
        "device_live_buffers": mem.get("live_buffers", 0),
        "h2d_bytes": int(totals["h2d_bytes"]),
        "d2h_bytes": int(totals["d2h_bytes"]),
    }


def fill_blob(blob):
    """Copy ``telemetry()`` into a TelemetryBlob's device fields (the
    keys are the field names); with device obs off the fields stay 0."""
    for key, value in telemetry().items():
        setattr(blob, key, value)
    return blob


def reset_for_tests():
    """Test isolation only: drop the totals."""
    with _lock:
        for key in _totals:
            _totals[key] = 0

"""Worker SIGTERM hook: route an eviction through the graceful drain
(port of elasticdl_tpu/worker/drain.py).

An eviction, a spot preemption and a scale-down all reach the worker as
SIGTERM. The hook is installed first in worker/main.py; once
``bind(worker)`` has run, a SIGTERM flips the worker into
``begin_drain`` and returns: the process keeps running, the training
loop finishes its current task, joins its pushes, flushes the device
tier, deregisters and exits normally (bounded by the worker's
``EDL_DRAIN_DEADLINE_SECS`` watchdog). Before ``bind`` (a SIGTERM during
start-up) it chains the handler installed before it, or exits 0.

worker/main.py installs the flight recorder's crash hooks
(``events.install_crash_hooks``) after this hook, so a SIGTERM first
dumps the event ring and flushes the journal and the trace, then chains
into the drain.
"""

import signal
import sys

from elasticdl_tpu_torch.common.log_utils import (
    default_logger as _logger_factory,
)

logger = _logger_factory("elasticdl_tpu_torch.worker.drain")


class SigtermDrain:
    """Two-phase SIGTERM handler: install early (on the main thread),
    bind the worker once it exists."""

    def __init__(self):
        self._worker = None
        self._previous = None

    def install(self):
        self._previous = signal.getsignal(signal.SIGTERM)
        try:
            signal.signal(signal.SIGTERM, self._on_term)
        except ValueError:
            # not the main thread (embedded use): no drain hook; the
            # liveness requeue still covers an eviction
            logger.warning(
                "not on main thread; SIGTERM drain hook not installed"
            )
        return self

    def bind(self, worker):
        self._worker = worker

    def _on_term(self, signum, frame):
        worker = self._worker
        if worker is not None:
            # flags only, safe at any interrupt point: the run loop does
            # the flushing, the watchdog bounds it
            worker.begin_drain("sigterm")
            return
        if callable(self._previous):
            self._previous(signum, frame)
        else:
            sys.exit(0)


def install_sigterm_drain():
    """Install and return the hook; call it before anything else of the
    worker starts."""
    return SigtermDrain().install()

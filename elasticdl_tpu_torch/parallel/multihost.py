"""Elastic multi-process runtime: (re)form the torch.distributed group
from the master's mesh rendezvous (port of
elasticdl_tpu/parallel/multihost.py).

The master's ``MeshRendezvous`` (master/rendezvous.py) assigns each
worker process a rank and bumps a mesh epoch whenever the alive set
changes. ``MultiHostRuntime`` turns a new epoch into
``destroy_process_group`` and a fresh ``init_process_group`` of the new
world, and tells the caller to rebuild its mesh and restore from the
latest checkpoint. The worker process's relaunch is the recovery: a
worker that sees the epoch move exits with ``EPOCH_RESTART_EXIT_CODE``
and the pod manager starts it again.

The group forms over a ``TCPStore`` the runtime creates itself, hosted
by rank 0 at the coordinator's host and ``--coordinator_port``. Before
the group forms, each rank publishes ``hostname/device`` there, and the
ranks take the backend by what they hold, the same on every rank:

- gloo when any rank is on the CPU, or when two ranks share one card
  (NCCL takes one rank a device: two workers on one H100 exchange over
  gloo, which moves CUDA tensors through the host);
- NCCL when every rank owns its card.

The choice is made before any collective runs and is logged; it is not
a fallback after a failure. The group's ``timeout`` bounds every
collective, so a collective with a dead peer fails within it (gloo
usually fails at once, the peer's socket being closed).

The reference's ``_maybe_enable_cpu_collectives`` switches XLA:CPU to
gloo before JAX's backend starts; it is JAX's own, and the backend rule
above does its work here.
"""

import datetime
import os
import socket
import threading
import time

from elasticdl_tpu_torch.common.log_utils import (
    default_logger as _logger_factory,
)

logger = _logger_factory("elasticdl_tpu_torch.parallel.multihost")

COORDINATOR_PORT = 51617

# the pod manager's relaunch-and-rejoin exit (worker/worker.py has the
# same value; not imported: this module must stay importable without
# the trainers), also the only way out of a join wedged in a C++ call
EPOCH_RESTART_EXIT_CODE = 3

# a collective waiting longer than this fails: long enough for a peer's
# inline evaluation task or checkpoint between consensus rounds
COLLECTIVE_TIMEOUT_SECS = 120.0


def device_key(device):
    """``hostname/<device>``: what a rank publishes before the group
    forms (a CUDA device with its index)."""
    import torch

    device = torch.device(device)
    if device.type == "cuda":
        index = device.index
        if index is None:
            index = torch.cuda.current_device()
        return "%s/cuda:%d" % (socket.gethostname(), index)
    return "%s/%s" % (socket.gethostname(), device.type)


def choose_backend(keys):
    """``(backend, why)`` for the ranks' published device keys."""
    if any(not key.split("/", 1)[1].startswith("cuda") for key in keys):
        return "gloo", "a rank runs on the CPU"
    if len(set(keys)) < len(keys):
        return "gloo", ("ranks share a card (NCCL takes one rank a "
                        "device): %s" % ", ".join(keys))
    return "nccl", "every rank owns its card"


class MultiHostRuntime:
    """Tracks the mesh epoch and re-forms the default process group when
    it moves. ``distributed`` is injectable (tests pass a fake with
    ``TCPStore``, ``PrefixStore``, ``init_process_group`` and
    ``destroy_process_group``); production uses torch.distributed."""

    def __init__(self, master_client, coordinator_port=COORDINATOR_PORT,
                 distributed=None, init_attempt_timeout_secs=30.0,
                 max_init_attempts=20, device="cuda",
                 collective_timeout_secs=COLLECTIVE_TIMEOUT_SECS):
        self._mc = master_client
        self._port = coordinator_port
        if distributed is None:
            import torch.distributed as distributed
        self._distributed = distributed
        self._epoch = None  # epoch of the live group
        self.rank = -1
        self.world_size = 0
        self.backend = None
        self._store = None
        # per-attempt bound on the join: a join started against
        # membership that then changed would otherwise wait for peers
        # that never come; on timeout it retries with FRESH membership
        self._init_attempt_timeout = float(init_attempt_timeout_secs)
        # a join that never succeeds (port taken, firewalled) surfaces as
        # an error, not an endless warn loop whose keepalive keeps the
        # master's liveness green
        self._max_init_attempts = max_init_attempts
        self._device = device
        self._collective_timeout = float(collective_timeout_secs)

    @property
    def initialized(self):
        return self._epoch is not None

    def _exit_wedged_join(self, rank, world, coordinator):
        """The watchdog's way out of a join that neither returned nor
        raised within twice its attempt timeout: the process is stuck in
        native code, so it exits with the epoch-restart code and the
        relaunch rejoins with fresh membership."""
        logger.error(
            "distributed join (rank %d/%d via %s) wedged past %ds; "
            "membership likely dissolved mid-join; exiting for "
            "relaunch-and-rejoin",
            rank, world, coordinator, self._init_attempt_timeout * 2,
        )
        os._exit(EPOCH_RESTART_EXIT_CODE)

    def _wait_admitted(self, wait_sleep_secs, max_wait_secs, start):
        while True:
            info = self._mc.get_comm_info()
            if info.rank >= 0:
                return info
            if max_wait_secs and time.time() - start > max_wait_secs:
                raise TimeoutError(
                    "master never admitted this host into the mesh"
                )
            time.sleep(wait_sleep_secs)

    def _join(self, info, host):
        """The store at ``host``:port (rank 0 serves it), the device
        keys, the backend, then the group."""
        dist = self._distributed
        attempt = datetime.timedelta(seconds=self._init_attempt_timeout)
        store = dist.TCPStore(host, self._port, info.world_size,
                              info.rank == 0, timeout=attempt)
        # one namespace an epoch: a store that outlives its group never
        # answers a later join with stale keys
        store = dist.PrefixStore("edl/epoch%d" % info.mesh_epoch, store)
        store.set("device/%d" % info.rank, device_key(self._device))
        keys = [store.get("device/%d" % r).decode()
                for r in range(info.world_size)]
        backend, why = choose_backend(keys)
        logger.info("process group backend %s: %s", backend, why)
        dist.init_process_group(
            backend, store=store, world_size=info.world_size,
            rank=info.rank,
            timeout=datetime.timedelta(seconds=self._collective_timeout))
        self._store = store
        self.backend = backend

    def _leave(self):
        self._distributed.destroy_process_group()
        self._store = None
        self.backend = None

    def ensure_runtime(self, wait_sleep_secs=1.0, max_wait_secs=0):
        """Join (or rejoin) the mesh. Blocks while the master has not
        admitted this host (rank -1). Returns True when the group was
        (re)formed (the caller rebuilds its mesh and restores from the
        latest checkpoint), False when the live group is current."""
        start = time.time()
        info = self._wait_admitted(wait_sleep_secs, max_wait_secs, start)
        if self._epoch == info.mesh_epoch:
            return False
        if self._epoch is not None:
            logger.info("Mesh epoch %s -> %s: destroying the process "
                        "group", self._epoch, info.mesh_epoch)
            self._leave()
        # down before the attempt: a retry after a failed join must not
        # destroy a group that was never formed
        self._epoch = None
        self.rank, self.world_size = -1, 0
        # the join blocks until every rank arrives, which can take
        # minutes while peers start: keep the master's liveness fresh
        stop_keepalive = threading.Event()

        def keepalive():
            while not stop_keepalive.wait(3.0):
                try:
                    self._mc.get_comm_info()
                except Exception:
                    pass

        keeper = threading.Thread(target=keepalive, name="join-keepalive",
                                  daemon=True)
        keeper.start()
        try:
            attempts = 0
            while True:
                host = info.coordinator_addr.split(":")[0]
                coordinator = "%s:%d" % (host, self._port)
                # the attempt timeout bounds the usual failure (a peer
                # slow or gone); the watchdog bounds a wedge past it
                watchdog = threading.Timer(
                    self._init_attempt_timeout * 2 + 15.0,
                    self._exit_wedged_join,
                    args=(info.rank, info.world_size, coordinator),
                )
                watchdog.daemon = True
                watchdog.start()
                try:
                    self._join(info, host)
                    watchdog.cancel()
                    break
                except Exception as e:
                    watchdog.cancel()
                    attempts += 1
                    if attempts >= self._max_init_attempts:
                        raise RuntimeError(
                            "distributed join failed %d times (last: %s "
                            "via %s)" % (attempts, e, coordinator)) from e
                    logger.warning(
                        "distributed join (rank %d/%d via %s) failed: %s; "
                        "refreshing membership and retrying",
                        info.rank, info.world_size, coordinator, e,
                    )
                    try:
                        self._leave()
                    except Exception as e:
                        # expected: a half-formed join has no group
                        logger.debug("pre-retry destroy failed: %s", e)
                    info = self._wait_admitted(wait_sleep_secs,
                                               max_wait_secs, start)
        finally:
            stop_keepalive.set()
        self._epoch = info.mesh_epoch
        self.rank = info.rank
        self.world_size = info.world_size
        logger.info(
            "process group formed: rank %d/%d (epoch %s, coordinator %s, "
            "%s)", info.rank, info.world_size, info.mesh_epoch, coordinator,
            self.backend,
        )
        return True

    def check_epoch(self):
        """Between-steps probe: True iff the epoch moved and
        ensure_runtime() must run. A failed RPC (mesh_epoch < 0, the
        master client's failure marker) is not an epoch change: a
        network blip must not discard work that is not checkpointed."""
        info = self._mc.get_comm_info()
        return self.epoch_moved(info.mesh_epoch)

    def epoch_moved(self, seen_epoch):
        """Compare an epoch seen elsewhere (the worker's heartbeat)
        with the live group's."""
        if seen_epoch is None or seen_epoch < 0:
            return False
        return self._epoch is not None and seen_epoch != self._epoch

    def shutdown(self):
        if self._epoch is not None:
            self._leave()
            self._epoch = None
            self.rank, self.world_size = -1, 0

"""Mesh-epoch rendezvous for the elastic worker set (port of
elasticdl_tpu/master/rendezvous.py). Each bump journals a
``mesh_epoch_restart`` event.

A counter the master bumps whenever the alive-host set changes. Workers
read it through ``get_comm_info`` (rank, world size, mesh epoch and the
coordinator, the first host to join).
"""

import threading
import time

from elasticdl_tpu_torch.common.log_utils import (
    default_logger as _logger_factory,
)
from elasticdl_tpu_torch.observability import events

logger = _logger_factory("elasticdl_tpu_torch.master.rendezvous")


class MeshRendezvous:
    def __init__(self):
        self._lock = threading.Lock()
        self._mesh_epoch = 0
        # host string -> rank; ranks assigned by join order
        self._hosts = []
        # wall time of the last epoch bump: liveness-based eviction
        # grants a grace window after it (TaskMonitor)
        self._last_change = 0.0

    def _bump(self, old_world, reason):
        """Epoch bump bookkeeping; the caller holds the lock and has
        already changed ``self._hosts``."""
        self._mesh_epoch += 1
        self._last_change = time.time()
        new_world = len(self._hosts)
        logger.info(
            "Mesh epoch -> %d (%s, %d -> %d hosts)",
            self._mesh_epoch, reason, old_world, new_world,
        )
        events.emit(
            "mesh_epoch_restart",
            epoch=self._mesh_epoch,
            old_mesh="dp=%d" % old_world if old_world else "",
            new_mesh="dp=%d" % new_world if new_world else "",
            old_world=old_world,
            new_world=new_world,
            reason=reason,
        )

    def set_worker_hosts(self, hosts, reason="set_hosts"):
        """Replace the alive-host list; bump the epoch if it changed."""
        hosts = list(hosts)
        with self._lock:
            if hosts == self._hosts:
                return self._mesh_epoch
            old_world = len(self._hosts)
            self._hosts = hosts
            self._bump(old_world, reason)
            return self._mesh_epoch

    def add_worker_host(self, host, reason="worker_join"):
        with self._lock:
            if host in self._hosts:
                return self._mesh_epoch
            old_world = len(self._hosts)
            self._hosts.append(host)
            self._bump(old_world, "%s:%s" % (reason, host))
            return self._mesh_epoch

    def remove_worker_host(self, host, reason="worker_leave"):
        with self._lock:
            if host not in self._hosts:
                return self._mesh_epoch
            old_world = len(self._hosts)
            self._hosts.remove(host)
            self._bump(old_world, "%s:%s" % (reason, host))
            return self._mesh_epoch

    def get_comm_info(self, host):
        """Returns (rank, world_size, mesh_epoch, coordinator_addr).

        rank is -1 when the host is not (yet) part of the mesh.
        """
        with self._lock:
            rank = self._hosts.index(host) if host in self._hosts else -1
            coordinator = self._hosts[0] if self._hosts else ""
            return rank, len(self._hosts), self._mesh_epoch, coordinator

    @property
    def last_change_time(self):
        with self._lock:
            return self._last_change

    @property
    def mesh_epoch(self):
        with self._lock:
            return self._mesh_epoch

    def hosts(self):
        with self._lock:
            return list(self._hosts)

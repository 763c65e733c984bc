"""The port's multi-process runtime (elasticdl_tpu_torch/parallel/
multihost.py) against the real MeshRendezvous: the six scenarios of
the reference's tests/test_multihost.py with a fake ``distributed``
(the group's store, its formation and its destruction recorded), the
backend rule over the ranks' published devices, and two real gloo ranks
that form a group, re-form it at a new epoch and agree on the backend.
"""

import json
import os
import subprocess
import sys

import pytest

from elasticdl_tpu_torch.master.rendezvous import MeshRendezvous
from elasticdl_tpu_torch.parallel.multihost import (
    MultiHostRuntime,
    choose_backend,
)
from elasticdl_tpu_torch.proto import elasticdl_tpu_pb2 as pb

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class FakeStore:
    """A TCPStore stand-in: this rank's keys, and a CPU device for every
    rank that never published."""

    def __init__(self, host, port):
        self.host, self.port = host, port
        self.keys = {}

    def set(self, key, value):
        self.keys[key] = value.encode() if isinstance(value, str) else value

    def get(self, key):
        return self.keys.get(key, b"otherhost/cpu")


class FakePrefixStore:
    def __init__(self, prefix, store):
        self.prefix, self.store = prefix, store

    def set(self, key, value):
        self.store.set("%s/%s" % (self.prefix, key), value)

    def get(self, key):
        return self.store.get("%s/%s" % (self.prefix, key))


class FakeDistributed:
    PrefixStore = FakePrefixStore

    def __init__(self):
        self.calls = []
        self._store = None

    def TCPStore(self, host, port, world_size, is_master, timeout=None):
        self._store = FakeStore(host, port)
        return self._store

    def init_process_group(self, backend, store=None, world_size=None,
                           rank=None, timeout=None):
        self.calls.append(("init", "%s:%d" % (self._store.host,
                                              self._store.port),
                           world_size, rank))
        self.backend = backend

    def destroy_process_group(self):
        self.calls.append(("shutdown",))


class Client:
    """MasterClient stand-in wired straight to a MeshRendezvous."""

    def __init__(self, rendezvous, host):
        self._r = rendezvous
        self._host = host

    def get_comm_info(self):
        rank, size, epoch, coord = self._r.get_comm_info(self._host)
        return pb.CommInfo(rank=rank, world_size=size, mesh_epoch=epoch,
                           coordinator_addr=coord)


def _runtime(rendezvous, host, fake):
    return MultiHostRuntime(Client(rendezvous, host), distributed=fake,
                            coordinator_port=5000, device="cpu")


def test_initialize_once_then_noop():
    rendezvous = MeshRendezvous()
    rendezvous.set_worker_hosts(["hostA:3333", "hostB:3333"])
    fake = FakeDistributed()
    runtime = _runtime(rendezvous, "hostB:3333", fake)
    assert runtime.ensure_runtime() is True
    assert fake.calls == [("init", "hostA:5000", 2, 1)]
    assert runtime.rank == 1 and runtime.world_size == 2
    assert runtime.backend == fake.backend == "gloo"
    # same epoch: no-op
    assert runtime.ensure_runtime() is False
    assert len(fake.calls) == 1
    assert not runtime.check_epoch()


def test_membership_change_reinitializes():
    rendezvous = MeshRendezvous()
    rendezvous.set_worker_hosts(["hostA:3333", "hostB:3333"])
    fake = FakeDistributed()
    runtime = _runtime(rendezvous, "hostA:3333", fake)
    runtime.ensure_runtime()
    rendezvous.add_worker_host("hostC:3333")  # epoch bump
    assert runtime.check_epoch()
    assert runtime.ensure_runtime() is True
    assert fake.calls == [
        ("init", "hostA:5000", 2, 0),
        ("shutdown",),
        ("init", "hostA:5000", 3, 0),
    ]


def test_rpc_failure_marker_is_not_an_epoch_change():
    """mesh_epoch=-1 (the master client's RPC-failure marker) must not
    trigger a restart: a network blip would discard work that is not
    checkpointed."""
    rendezvous = MeshRendezvous()
    rendezvous.set_worker_hosts(["hostA:3333"])
    runtime = _runtime(rendezvous, "hostA:3333", FakeDistributed())
    runtime.ensure_runtime()
    assert not runtime.epoch_moved(-1)
    assert not runtime.epoch_moved(None)
    assert runtime.epoch_moved(rendezvous.mesh_epoch + 1)


def test_unadmitted_host_blocks_then_joins():
    rendezvous = MeshRendezvous()
    rendezvous.set_worker_hosts(["hostA:3333"])
    runtime = _runtime(rendezvous, "hostB:3333", FakeDistributed())
    with pytest.raises(TimeoutError):
        runtime.ensure_runtime(wait_sleep_secs=0.01, max_wait_secs=0.05)
    rendezvous.add_worker_host("hostB:3333")
    assert runtime.ensure_runtime() is True
    assert runtime.rank == 1


def test_coordinator_loss_promotes_next_rank():
    """When the coordinator host dies, the survivor re-forms the group
    with itself as rank 0, serving the store."""
    rendezvous = MeshRendezvous()
    rendezvous.set_worker_hosts(["hostA:3333", "hostB:3333"])
    fake = FakeDistributed()
    runtime = _runtime(rendezvous, "hostB:3333", fake)
    runtime.ensure_runtime()
    assert runtime.rank == 1
    rendezvous.remove_worker_host("hostA:3333")
    assert runtime.ensure_runtime() is True
    assert runtime.rank == 0
    assert fake.calls[-1] == ("init", "hostB:5000", 1, 0)


def test_failed_init_retries_with_fresh_membership():
    """A join that fails (the coordinator died between the comm info
    and the connect, or the attempt's timeout expired) refreshes the
    membership and retries inside ensure_runtime."""

    class FlakyDistributed(FakeDistributed):
        def __init__(self):
            super().__init__()
            self.fail_next_init = False

        def init_process_group(self, backend, **kwargs):
            if self.fail_next_init:
                self.fail_next_init = False
                self.calls.append(("init-failed",))
                raise RuntimeError("coordinator unreachable")
            super().init_process_group(backend, **kwargs)

    rendezvous = MeshRendezvous()
    rendezvous.set_worker_hosts(["hostA:3333", "hostB:3333"])
    fake = FlakyDistributed()
    runtime = _runtime(rendezvous, "hostB:3333", fake)
    runtime.ensure_runtime()
    rendezvous.add_worker_host("hostC:3333")  # epoch bump
    fake.fail_next_init = True
    # the coordinator dies mid-join: the retry targets the new membership
    rendezvous.remove_worker_host("hostA:3333")
    assert runtime.ensure_runtime() is True
    assert runtime.initialized
    assert fake.calls[-1] == ("init", "hostB:5000", 2, 0)
    assert ("init-failed",) in fake.calls


@pytest.mark.parametrize("keys,backend", [
    (["h/cpu", "h/cpu"], "gloo"),
    (["h/cuda:0", "h/cpu"], "gloo"),
    (["h/cuda:0", "h/cuda:0"], "gloo"),
    (["h/cuda:0", "h/cuda:1"], "nccl"),
    (["a/cuda:0", "b/cuda:0"], "nccl"),
], ids=["cpu", "mixed", "one_card", "two_cards", "two_hosts"])
def test_backend_by_the_ranks_devices(keys, backend):
    assert choose_backend(keys)[0] == backend


_RANK = r'''
import json, sys
sys.path.insert(0, sys.argv[4])
import torch
import torch.distributed as dist
from elasticdl_tpu_torch.parallel.multihost import MultiHostRuntime
from elasticdl_tpu_torch.proto import elasticdl_tpu_pb2 as pb
rank, port = int(sys.argv[1]), int(sys.argv[2])
class Master:
    epoch = 1
    def get_comm_info(self):
        return pb.CommInfo(rank=rank, world_size=2, mesh_epoch=self.epoch,
                           coordinator_addr="localhost:1")
master = Master()
runtime = MultiHostRuntime(master, coordinator_port=port, device="cpu",
                           collective_timeout_secs=30,
                           init_attempt_timeout_secs=30)
out = {"formed": runtime.ensure_runtime(), "backend": runtime.backend}
t = torch.tensor([rank + 1.0])
dist.all_reduce(t)
out["sum"] = float(t)
out["noop"] = runtime.ensure_runtime()
master.epoch = 2
out["moved"] = runtime.check_epoch()
out["reformed"] = runtime.ensure_runtime()
t = torch.tensor([10.0 * (rank + 1)])
dist.all_reduce(t)
out["sum2"] = float(t)
out["world"] = dist.get_world_size()
runtime.shutdown()
out["after"] = dist.is_initialized()
print("RESULT " + json.dumps(out), flush=True)
'''


def test_two_gloo_ranks_form_and_reform_the_group(tmp_path):
    """Two processes form the group over the runtime's own store (rank
    0 serves it at the coordinator port), take gloo from the devices
    they published, all-reduce, re-form at a new epoch on the same port
    and all-reduce again."""
    from elasticdl_tpu_torch.common.grpc_utils import find_free_port

    port = find_free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK, str(rank), str(port), "x", REPO],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=str(tmp_path)) for rank in (0, 1)]
    outs = []
    try:
        for proc in procs:
            text, _ = proc.communicate(timeout=120)
            assert proc.returncode == 0, text[-3000:]
            line = [ln for ln in text.splitlines()
                    if ln.startswith("RESULT ")]
            outs.append(json.loads(line[0][len("RESULT "):]))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for out in outs:
        assert out == {"formed": True, "backend": "gloo", "sum": 3.0,
                       "noop": False, "moved": True, "reformed": True,
                       "sum2": 30.0, "world": 2, "after": False}

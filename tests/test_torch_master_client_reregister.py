"""The port's MasterClient re-registers once per master restart, whichever
of its threads sees the restart first.

A worker's heartbeat (``get_comm_info``) and its task loop (``get_task``)
both feed the restart detector. Here a fake stub stands in for the
master: the second master lifetime answers ``master_epoch`` 2 and every
``reset_worker`` is recorded, so each case counts the re-registrations
one restart caused (want: exactly 1).
"""

import threading
import time

from elasticdl_tpu_torch.proto import elasticdl_tpu_pb2 as pb
from elasticdl_tpu_torch.worker.master_client import MasterClient


class _FakeMaster:
    """The restarted master: epoch 2, task ids counted from 1."""

    def __init__(self, get_task_gate=None, reset_delay_s=0.0):
        self.resets = []
        self.dispatched = []
        self._gate = get_task_gate
        self._reset_delay_s = reset_delay_s
        self._lock = threading.Lock()

    def reset_worker(self, request, timeout=None):
        time.sleep(self._reset_delay_s)
        with self._lock:
            self.resets.append(request.worker_id)
            # a re-registration requeues whatever was dispatched before it
            self.dispatched.clear()
        return pb.ResetWorkerResponse(restart_count=len(self.resets),
                                      master_epoch=2)

    def get_task(self, request, timeout=None):
        if self._gate is not None:
            self._gate.wait(5.0)
        with self._lock:
            task_id = len(self.dispatched) + 100 * len(self.resets) + 1
            self.dispatched.append(task_id)
        return pb.Task(task_id=task_id, master_epoch=2)

    def get_comm_info(self, request, timeout=None):
        return pb.CommInfo(rank=0, world_size=1, master_epoch=2)


def _registered_client(stub):
    """A client registered with the first master lifetime (epoch 1)."""
    client = MasterClient("localhost:1", worker_id=0)
    client._stub = stub
    client._registered = True
    client._seen_master_epoch = 1
    return client


def test_heartbeat_alone_reregisters_once():
    stub = _FakeMaster()
    client = _registered_client(stub)
    for _ in range(3):
        client.get_comm_info()
    task = client.get_task()
    assert stub.resets == [0]
    # the task came after the re-registration, so the master still holds it
    assert task.task_id in stub.dispatched
    client.close()


def test_get_task_alone_reregisters_once_and_discards_the_requeued_task():
    stub = _FakeMaster()
    client = _registered_client(stub)
    task = client.get_task()
    assert stub.resets == [0]
    assert task.task_id in stub.dispatched
    client.get_comm_info()
    assert stub.resets == [0]
    client.close()


def test_heartbeat_during_get_task_in_flight_leaves_it_to_get_task():
    """The race a worker hits when the master comes back: the heartbeat
    sees epoch 2 while get_task waits on the relaunched master."""
    gate = threading.Event()
    stub = _FakeMaster(get_task_gate=gate)
    client = _registered_client(stub)
    got = []
    loop = threading.Thread(target=lambda: got.append(client.get_task()))
    loop.start()
    deadline = time.monotonic() + 5.0
    while not client._register_lock.locked():
        assert time.monotonic() < deadline
        time.sleep(0.001)
    for _ in range(3):
        client.get_comm_info()
    assert stub.resets == []
    gate.set()
    loop.join(10.0)
    assert not loop.is_alive()
    assert stub.resets == [0]
    assert got[0].task_id in stub.dispatched
    client.close()


def test_heartbeat_and_get_task_racing_reregister_once():
    """Both threads see epoch 2 at once, with a slow reset_worker: one
    restart, one re-registration, and the task kept is one the master
    still holds."""
    stub = _FakeMaster(reset_delay_s=0.05)
    client = _registered_client(stub)
    start = threading.Barrier(2)
    got = []

    def loop():
        start.wait()
        got.append(client.get_task())

    def beat():
        start.wait()
        for _ in range(5):
            client.get_comm_info()

    threads = [threading.Thread(target=loop), threading.Thread(target=beat)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10.0)
    assert stub.resets == [0]
    assert got[0].task_id in stub.dispatched
    client.close()

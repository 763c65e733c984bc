"""The master's state journal: crash recovery for the dispatcher (port of
elasticdl_tpu/master/state_store.py, same files on disk).

The dispatcher's todo/doing/done books, the epoch counter and the
per-worker relaunch-epoch grants live in the master's memory; this
module makes them outlive a master that dies:

- **Write-through NDJSON journal** (``master.journal.ndjson`` under
  ``$EDL_STATE_DIR``): one JSON op per dispatcher transition (task set
  creation, dispatch, done, requeue, relaunch-epoch grant, model
  version), flushed before the op's RPC answer leaves the process.
- **Compacted snapshot** (``master.snapshot.json``, atomic tmp+rename):
  every ``compact_every`` ops the live state is snapshotted from the
  registered section providers and the journal truncated, so replay
  costs the ops since the last snapshot. Every journal line carries a
  global monotonic ``seq``; the snapshot records the last seq it
  covers, so a crash between the snapshot and the truncation replays no
  op twice.
- **Replay** (``load``): snapshot + tail ops folded through the same
  state machine the dispatcher runs live. The caller hands the state to
  ``TaskDispatcher(recovered=...)`` (in-flight tasks requeued, their
  pre-restart assignee's completion still accepted) and
  ``MasterServicer(recovered=...)`` (the relaunch-epoch base re-anchored
  above every epoch granted before).
- **master_epoch**: a boot counter bumped by every ``load``. The
  servicer stamps it on its answers; a worker that sees it move
  re-registers with the new process.

The ``stream_*`` ops and the state's ``stream`` section belong to the
reference's streaming mode, which the port does not run yet: they are
kept so that a journal or snapshot written by either package loads in
the other. With ``EDL_STATE_DIR`` unset nothing is constructed.
"""

import json
import os
import threading
import time

from elasticdl_tpu_torch.common.env_utils import env_str
from elasticdl_tpu_torch.common.log_utils import (
    default_logger as _logger_factory,
)

logger = _logger_factory("elasticdl_tpu_torch.master.state_store")

STATE_DIR_ENV = "EDL_STATE_DIR"

JOURNAL_NAME = "master.journal.ndjson"
SNAPSHOT_NAME = "master.snapshot.json"

# ops the replay state machine understands; appending an unknown op is
# a programming error caught loudly (the replay would silently drop it)
OP_TYPES = frozenset({
    "tasks_created",    # + tasks [[id,type,shard,start,end,mv]...],
                        #   queue ("train"|"eval"), epochs_left
    "dispatch",         # + task, worker
    "done",             # + task, type [, records (stream watermark)]
    "requeue",          # + task, retries
    "job_failed",       # + task
    "grant",            # + worker, count (relaunch-epoch grant)
    "epoch_base",       # + base (servicer relaunch-epoch base)
    "version",          # + version (model version reports)
    "master_restarted",  # + master_epoch (bookkeeping; no state change)
    # streaming mode: the watermark-task extension of
    # done-exactly-once — a relaunched master resumes minting at the
    # journaled source position instead of re-delivering windows
    "stream_open",      # streaming dispatcher constructed
    "stream_window",    # + pos (source windows minted so far), task
                        #   [id,type,shard,start,end,mv]
    "stream_close",     # source exhausted; drain contract takes over
})


def empty_state():
    return {
        "tasks": {},          # id -> [id, type, shard, start, end, mv]
        "todo": [],           # train + callback queue, FIFO
        "eval_todo": [],
        "doing": {},          # id -> worker
        "retries": {},        # id -> failed-attempt count
        "done_counts": {},    # type -> n
        "epochs_left": 0,
        "next_task_id": 1,
        "job_failed": False,
        "worker_restarts": {},  # worker -> relaunch count
        "epoch_base": 0,
        "model_version": 0,
        # streaming mode: source position + record
        # accounting; "open" False means epoch semantics (the default)
        "stream": {
            "open": False,
            "pos": 0,
            "minted_records": 0,
            "done_records": 0,
        },
    }


def apply_op(state, op):
    """Fold one journal op into a replay state dict — the exact queue
    semantics the live dispatcher runs (task_dispatcher.py).

    IDEMPOTENT against ops the snapshot already reflects: ops are
    buffered under the dispatcher lock but written after it, so a
    compaction snapshot (taken from LIVE state) can land between the
    state transition and its journal line — the op then follows the
    snapshot in seq order and is replayed on top of state that already
    contains it. Guards: task creation is fenced by the monotonic
    next_task_id; dispatch/done/requeue apply only to tasks the state
    still knows (a done task is gone from ``tasks``, so a duplicate
    done can't double-count).
    """
    kind = op["op"]
    if kind == "tasks_created":
        queue = state["eval_todo"] if op.get("queue") == "eval" else state["todo"]
        # fence at op entry: ids within one op arrive SHUFFLED, so the
        # guard must not move while the op's own tasks are added
        fence = state["next_task_id"]
        added = False
        for task in op["tasks"]:
            task_id = int(task[0])
            if task_id < fence:
                continue  # already reflected in the snapshot
            state["tasks"][task_id] = list(task)
            queue.append(task_id)
            state["next_task_id"] = max(
                state["next_task_id"], task_id + 1
            )
            added = True
        if added and "epochs_left" in op:
            state["epochs_left"] = op["epochs_left"]
    elif kind == "dispatch":
        task_id = op["task"]
        if task_id in state["tasks"]:
            for queue in (state["todo"], state["eval_todo"]):
                if task_id in queue:
                    queue.remove(task_id)
                    break
            state["doing"][task_id] = op["worker"]
    elif kind == "done":
        task_id = op["task"]
        if task_id in state["tasks"]:
            state["doing"].pop(task_id, None)
            for queue in (state["todo"], state["eval_todo"]):
                if task_id in queue:
                    queue.remove(task_id)
            state["tasks"].pop(task_id, None)
            state["retries"].pop(task_id, None)
            task_type = op.get("type", 0)
            state["done_counts"][task_type] = (
                state["done_counts"].get(task_type, 0) + 1
            )
            # stream watermark: records of completed window tasks.
            # Guarded by the same task-known fence as the rest of this
            # op, so a snapshot-covered duplicate can't double-count.
            if op.get("records"):
                state["stream"]["done_records"] += int(op["records"])
    elif kind == "requeue":
        task_id = op["task"]
        if task_id in state["tasks"]:
            state["doing"].pop(task_id, None)
            task = state["tasks"][task_id]
            # eval tasks requeue to the eval queue, the rest train
            queue = (
                state["eval_todo"] if task[1] == 1 else state["todo"]
            )
            if task_id not in queue:
                queue.append(task_id)
            if "retries" in op:
                state["retries"][task_id] = op["retries"]
    elif kind == "job_failed":
        state["job_failed"] = True
    elif kind == "grant":
        state["worker_restarts"][str(op["worker"])] = op["count"]
    elif kind == "epoch_base":
        state["epoch_base"] = op["base"]
    elif kind == "version":
        state["model_version"] = op["version"]
    elif kind == "stream_open":
        state["stream"]["open"] = True
    elif kind == "stream_window":
        stream = state["stream"]
        task = op["task"]
        task_id = int(task[0])
        # fence like tasks_created: a window the snapshot already
        # reflects must not re-mint (done-exactly-once for watermark
        # tasks); pos advances monotonically either way so the feeder
        # resumes the SOURCE at the right offset
        if task_id >= state["next_task_id"]:
            state["tasks"][task_id] = list(task)
            state["todo"].append(task_id)
            state["next_task_id"] = task_id + 1
            stream["minted_records"] += int(task[4]) - int(task[3])
        stream["open"] = True
        stream["pos"] = max(stream["pos"], int(op.get("pos", 0)))
    elif kind == "stream_close":
        state["stream"]["open"] = False
    elif kind == "master_restarted":
        pass  # bookkeeping only
    else:  # unreachable: append() validates
        raise ValueError("unknown journal op %r" % kind)
    return state


class MasterStateJournal:
    """Write-through op journal + compacted snapshot for one master."""

    def __init__(self, state_dir, compact_every=512):
        self.dir = state_dir
        self.journal_path = os.path.join(state_dir, JOURNAL_NAME)
        self.snapshot_path = os.path.join(state_dir, SNAPSHOT_NAME)
        self._compact_every = max(1, compact_every)
        self._lock = threading.RLock()
        self._file = None
        self._seq = 0
        self._ops_since_snapshot = 0
        # name -> provider(); each returns its slice of the replay-state
        # schema, merged into the compaction snapshot
        self._sections = {}
        self.master_epoch = 0
        self._model_version = 0

    @classmethod
    def maybe_create(cls, **kwargs):
        """The journal iff ``EDL_STATE_DIR`` is set; else None (the
        zero-overhead disabled path)."""
        state_dir = env_str(STATE_DIR_ENV, "")
        if not state_dir:
            return None
        return cls(state_dir, **kwargs)

    # ------------------------------------------------------------------
    # recovery

    def load(self):
        """Replay snapshot + journal; bump and persist ``master_epoch``.

        Returns the recovered state dict, or None when nothing usable
        was on disk (first boot). Either way the journal is open for
        appends afterwards and a ``master_restarted`` op marks the boot.
        """
        t0 = time.monotonic()
        with self._lock:
            state, last_epoch, snap_seq = self._read_snapshot()
            tail_ops, max_seq, boots = self._read_journal(snap_seq)
            recovered = state is not None or bool(tail_ops)
            if state is None:
                state = empty_state()
            for op in tail_ops:
                try:
                    apply_op(state, op)
                except Exception:
                    # a torn trailing line is expected after SIGKILL;
                    # anything else is still better skipped than a
                    # master that can never come back up
                    logger.warning("skipping bad journal op: %r", op)
            self.master_epoch = max(last_epoch, boots) + 1
            self._model_version = state["model_version"]
            self._seq = max_seq
            self._open_file_locked()
        self.append(
            {"op": "master_restarted", "master_epoch": self.master_epoch}
        )
        if recovered:
            logger.info(
                "Recovered master state: %d tasks (%d todo / %d doing), "
                "epochs_left=%d, master_epoch=%d (%d journal ops "
                "replayed in %.4f s)",
                len(state["tasks"]), len(state["todo"]),
                len(state["doing"]), state["epochs_left"],
                self.master_epoch, len(tail_ops), time.monotonic() - t0,
            )
            return state
        return None

    def _read_snapshot(self):
        if not os.path.isfile(self.snapshot_path):
            return None, 0, 0
        try:
            with open(self.snapshot_path, "r", encoding="utf-8") as f:
                payload = json.load(f)
        except (OSError, ValueError) as e:
            logger.warning("unreadable snapshot %s: %s", self.snapshot_path, e)
            return None, 0, 0
        state = empty_state()
        state.update(payload.get("state", {}))
        # JSON round-trip stringifies int dict keys
        state["tasks"] = {
            int(k): v for k, v in state["tasks"].items()
        }
        state["doing"] = {int(k): v for k, v in state["doing"].items()}
        state["retries"] = {int(k): v for k, v in state["retries"].items()}
        state["done_counts"] = {
            int(k): v for k, v in state["done_counts"].items()
        }
        return (
            state,
            int(payload.get("master_epoch", 0)),
            int(payload.get("seq", 0)),
        )

    def _read_journal(self, after_seq):
        ops = []
        max_seq = after_seq
        boots = 0
        if not os.path.isfile(self.journal_path):
            return ops, max_seq, boots
        with open(self.journal_path, "r", encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    op = json.loads(line)
                except ValueError:
                    continue  # torn tail line (SIGKILL mid-write)
                seq = int(op.get("seq", 0))
                max_seq = max(max_seq, seq)
                if op.get("op") == "master_restarted":
                    boots = max(boots, int(op.get("master_epoch", 0)))
                if seq <= after_seq:
                    continue  # already folded into the snapshot
                ops.append(op)
        return ops, max_seq, boots

    # ------------------------------------------------------------------
    # appends + compaction

    def _open_file_locked(self):
        if self._file is None:
            os.makedirs(self.dir, exist_ok=True)
            self._file = open(self.journal_path, "a", encoding="utf-8")

    def register_section(self, name, provider):
        """Register a snapshot section provider (e.g. the dispatcher's
        export_state); its dict is merged into compaction snapshots."""
        with self._lock:
            self._sections[name] = provider

    def append(self, op):
        """Write-through one op; flushed before return so it survives
        SIGKILL. Compacts when the op budget since the last snapshot is
        exhausted (snapshot from the live section providers)."""
        if op.get("op") not in OP_TYPES:
            raise ValueError("unknown journal op %r" % op.get("op"))
        compact = False
        with self._lock:
            if op["op"] == "version":
                self._model_version = op["version"]
            self._seq += 1
            op = dict(op, seq=self._seq, ts=time.time())
            try:
                self._open_file_locked()
                self._file.write(json.dumps(op) + "\n")
                self._file.flush()
            except OSError as e:
                logger.warning("state journal write failed: %s", e)
                return
            self._ops_since_snapshot += 1
            compact = (
                self._ops_since_snapshot >= self._compact_every
                and bool(self._sections)
            )
        if compact:
            self.compact()

    def compact(self):
        """Snapshot the live state (section providers) atomically, then
        truncate the journal. Provider calls happen OUTSIDE any caller
        lock (providers take their own locks)."""
        with self._lock:
            sections = dict(self._sections)
        state = empty_state()
        for name, provider in sections.items():
            try:
                state.update(provider())
            except Exception:
                logger.exception("snapshot section %r failed", name)
                return
        with self._lock:
            state["model_version"] = self._model_version
            payload = {
                "seq": self._seq,
                "master_epoch": self.master_epoch,
                "saved_at": time.time(),
                "state": state,
            }
            tmp = self.snapshot_path + ".tmp"
            try:
                with open(tmp, "w", encoding="utf-8") as f:
                    json.dump(payload, f)
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(tmp, self.snapshot_path)
                # snapshot durable: the journal prefix it covers can go
                if self._file is not None:
                    self._file.close()
                self._file = open(self.journal_path, "w", encoding="utf-8")
                self._ops_since_snapshot = 0
            except OSError as e:
                logger.warning("state snapshot failed: %s", e)

    def close(self):
        with self._lock:
            if self._file is not None:
                try:
                    self._file.close()
                except OSError:
                    pass
                self._file = None

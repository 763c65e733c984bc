"""Sparse embedding checkpoints: versioned, id-shardable, incremental
(port of elasticdl_tpu/ps/checkpoint.py, with the same files on disk: a
checkpoint written by either package restores in the other).

``<dir>/version-<v>/embeddings-<i>-of-<N>.npz`` holds shard ``i`` of
``N`` at store version ``v``; rows belong to shard ``id % N``, keep-max
GC retires old versions, and restore re-shards any checkpoint onto the
current PS count. A ``version-<v>`` directory is a chain anchored at a
full base save:

    version-<v>/
      embeddings-<i>-of-<N>.npz            # full base, store version v
      delta-1-embeddings-<i>-of-<N>.npz    # dirty rows + tombstones
      delta-2-embeddings-<i>-of-<N>.npz    # ...

Each delta carries only the rows changed since the previous save (the
store's snapshot-and-clear ``export_table_dirty``) plus the ids
``drop_rows`` removed since then, which restore replays as deletes.
Every ``EDL_CKPT_COMPACT_EVERY`` deltas the next save is a fresh full
base in a new ``version-<v'>`` directory, which bounds the chain and
lets the keep-max GC retire old chains whole. Restore walks the newest
chain all or nothing: the base plus the longest contiguous prefix of
complete, verified deltas, so a kill mid-delta or mid-compaction
shortens the replay to the newest complete state. A full-format
checkpoint without deltas is a chain of length zero.

Every shard file is written to a ``.tmp`` sibling and renamed into
place, so a crash mid-``np.savez`` leaves a temp file (ignored by every
reader, removed with its chain by GC), never a truncated shard.

A version skipped at restore journals ``checkpoint_skipped``, a chain
cut short ``checkpoint_delta_skipped`` (observability/events.py).
"""

import binascii
import os
import re
import shutil
import threading
import time
from dataclasses import dataclass

import numpy as np

from elasticdl_tpu_torch.common.env_utils import env_int
from elasticdl_tpu_torch.common.log_utils import (
    default_logger as _logger_factory,
)
from elasticdl_tpu_torch.observability import events

logger = _logger_factory("elasticdl_tpu_torch.ps.checkpoint")

# anchored: a delta file name contains the base pattern as a suffix
_FILE_RE = re.compile(r"^embeddings-(\d+)-of-(\d+)\.npz$")
_DELTA_RE = re.compile(r"^delta-(\d+)-embeddings-(\d+)-of-(\d+)\.npz$")

# deltas per chain before the saver compacts into a fresh full base;
# 0 turns deltas off (every save is a full base)
COMPACT_EVERY_ENV = "EDL_CKPT_COMPACT_EVERY"
DEFAULT_COMPACT_EVERY = 8

# the key a delta shard file records its store version under (a base's
# version is its directory's name)
_DELTA_VERSION_KEY = "__delta_version__"

# chain-generation token: every full base mints one and every delta of
# its chain repeats it. Restore replays a delta only when its token
# matches its shard's base, so a delta of an older generation that
# shares a directory with a newer base (a relaunch saving a colliding
# version) never replays over it. A base without a token accepts only
# deltas without one.
_CHAIN_TOKEN_KEY = "__chain_token__"


@dataclass
class SaveResult:
    """What one ``save()`` wrote."""

    path: str
    kind: str        # "full" | "delta"
    version: int     # store version recorded with the save
    rows: int        # rows written (all resident for full, dirty for delta)
    tombstones: int  # dead ids written (always 0 for full)
    chain_len: int   # deltas in the chain after this save (full -> 0)


def _savez_atomic(path, arrays):
    """np.savez through a temp file and an atomic rename: readers only
    see complete shard files. The temp name ends ``.tmp`` (no shard
    pattern matches it) and is opened as a file object, so np.savez
    appends no ``.npz`` to it."""
    tmp = path + ".tmp"
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
    except BaseException:
        # a failed write leaves no temp file in the next attempt's way;
        # what survives a hard kill goes with its chain at GC
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def _versions(checkpoint_dir):
    """Base versions of the ``version-<v>`` directories, ascending."""
    return sorted(
        int(d.split("-")[1]) for d in os.listdir(checkpoint_dir)
        if d.startswith("version-") and d.split("-")[1].isdigit()
    )


class SparseCheckpointSaver:
    def __init__(self, checkpoint_dir, shard_id=0, shard_num=1, keep_max=3,
                 compact_every=None):
        self._dir = checkpoint_dir
        self._shard_id = shard_id
        self._shard_num = shard_num
        self._keep_max = keep_max
        self._compact_every = (
            env_int(COMPACT_EVERY_ENV, DEFAULT_COMPACT_EVERY)
            if compact_every is None else int(compact_every)
        )
        # the open chain: deltas only append to a chain whose base this
        # saver wrote, so a relaunch always starts with a full base and
        # never extends a predecessor's (maybe torn) chain
        self._chain_dir = None
        self._chain_token = None
        self._delta_index = 1
        # one save at a time: inline saves from concurrent push handlers
        # would otherwise write the same delta-<k> through one .tmp path
        self._save_lock = threading.Lock()

    def _version_dir(self, version):
        return os.path.join(self._dir, "version-%d" % version)

    # ------------------------------------------------------------------
    # save
    def save(self, version, store, force_full=False):
        """Save at ``version``: a delta of the store's dirty rows when a
        chain is open and the store tracks dirty rows, else a full base;
        a full base also when ``force_full`` (the SIGTERM final save) or
        when the chain holds EDL_CKPT_COMPACT_EVERY deltas. Returns a
        :class:`SaveResult`."""
        supports_delta = (
            self._compact_every > 0
            and callable(getattr(store, "export_table_dirty", None))
        )
        with self._save_lock:
            if (not force_full and supports_delta
                    and self._chain_dir is not None
                    and self._delta_index <= self._compact_every
                    and os.path.isdir(self._chain_dir)):
                return self._save_delta(version, store)
            return self._save_full(version, store, supports_delta)

    def _save_full(self, version, store, supports_delta):
        vdir = self._version_dir(version)
        os.makedirs(vdir, exist_ok=True)
        token = "%d-%s" % (version,
                           binascii.hexlify(os.urandom(8)).decode())
        arrays = {_CHAIN_TOKEN_KEY: np.str_(token)}
        rows = 0
        for name in store.table_names():
            if supports_delta:
                # the base carries the complete state. Clearing before
                # the export is the race-free order: a row changed in
                # between lands in the base and in the next delta
                store.clear_dirty(name)
            # weights, optimizer slot rows and per-row step counts
            ids, full_rows, steps = store.export_table_full(name)
            arrays["ids/" + name] = ids
            arrays["fullrows/" + name] = full_rows
            arrays["steps/" + name] = steps
            arrays["dim/" + name] = np.int64(store.table_dim(name))
            # slots only mean something under the optimizer that made
            # them: restore compares this before importing them
            arrays["opt/" + name] = np.str_(store.opt_type)
            rows += int(ids.size)
        path = os.path.join(
            vdir, "embeddings-%d-of-%d.npz" % (self._shard_id,
                                               self._shard_num))
        _savez_atomic(path, arrays)
        self._chain_dir = vdir if supports_delta else None
        self._chain_token = token
        self._delta_index = 1
        logger.info("Saved sparse checkpoint %s (full, %d rows)", path, rows)
        self._gc()
        return SaveResult(path=path, kind="full", version=int(version),
                          rows=rows, tombstones=0, chain_len=0)

    def _save_delta(self, version, store):
        k = self._delta_index
        arrays = {
            _DELTA_VERSION_KEY: np.int64(version),
            _CHAIN_TOKEN_KEY: np.str_(self._chain_token),
        }
        rows = tombstones = 0
        for name in store.table_names():
            ids, full_rows, steps, dead = store.export_table_dirty(name)
            arrays["ids/" + name] = ids
            arrays["fullrows/" + name] = full_rows
            arrays["steps/" + name] = steps
            arrays["dead/" + name] = dead
            arrays["dim/" + name] = np.int64(store.table_dim(name))
            arrays["opt/" + name] = np.str_(store.opt_type)
            rows += int(ids.size)
            tombstones += int(dead.size)
        path = os.path.join(
            self._chain_dir, "delta-%d-embeddings-%d-of-%d.npz"
            % (k, self._shard_id, self._shard_num))
        _savez_atomic(path, arrays)
        self._delta_index = k + 1
        logger.info("Saved sparse checkpoint %s (delta %d, %d dirty rows, "
                    "%d tombstones)", path, k, rows, tombstones)
        return SaveResult(path=path, kind="delta", version=int(version),
                          rows=rows, tombstones=tombstones, chain_len=k)

    # ------------------------------------------------------------------
    # directory structure
    def _complete(self, vdir):
        """A chain is valid when its base is: all N base shard files
        exist (writes are atomic, so present means whole)."""
        try:
            names = sorted(os.listdir(vdir))
        except OSError:
            return False
        files = [f for f in names if _FILE_RE.match(f)]
        if not files:
            return False
        return len(files) >= int(_FILE_RE.match(files[0]).group(2))

    def _delta_chain(self, vdir):
        """The contiguous complete delta prefix of a chain directory:
        ``[(k, [shard paths])]`` for k = 1, 2, ... up to the first
        missing or incomplete index (past a gap nothing is
        reachable)."""
        by_k = {}
        try:
            names = sorted(os.listdir(vdir))
        except OSError:
            return []
        for fname in names:
            match = _DELTA_RE.match(fname)
            if match:
                by_k.setdefault(int(match.group(1)), []).append(
                    os.path.join(vdir, fname))
        chain = []
        k = 1
        while k in by_k:
            files = sorted(by_k[k])
            total = int(_DELTA_RE.match(os.path.basename(files[0])).group(3))
            if len(files) < total:
                break
            chain.append((k, files))
            k += 1
        return chain

    def _gc(self):
        if self._keep_max <= 0 or not os.path.isdir(self._dir):
            return
        complete = [v for v in _versions(self._dir)
                    if self._complete(self._version_dir(v))]
        for v in complete[:-self._keep_max]:
            shutil.rmtree(self._version_dir(v), ignore_errors=True)

    # ------------------------------------------------------------------
    @staticmethod
    def latest_version(checkpoint_dir):
        """The newest complete checkpoint's effective version: the newest
        complete chain's base version advanced by its readable contiguous
        delta prefix, the same walk restore replays, so the two agree
        when a middle delta is torn. Incomplete or unreadable bases are
        skipped; a bad delta truncates the answer there. (This opens
        files without checking every array's CRC: bit rot inside an
        intact zip is restore's to catch.) None when nothing is
        there."""
        if not os.path.isdir(checkpoint_dir):
            return None
        saver = SparseCheckpointSaver(checkpoint_dir)
        for v in reversed(_versions(checkpoint_dir)):
            vdir = saver._version_dir(v)
            if not saver._complete(vdir):
                continue
            try:
                # opening each base shard reads the zip directory at the
                # file's end: a torn base fails here
                base_tokens = {
                    saver._shard_index(path): saver._file_token(path)
                    for path in saver._shard_files(v)
                }
            except Exception as e:
                logger.warning("latest_version: unreadable base in "
                               "version-%d (%s); skipping the chain", v, e)
                continue
            effective = v
            for k, files in saver._delta_chain(vdir):
                try:
                    stamp = 0
                    for path in files:
                        if saver._file_token(path) != base_tokens.get(
                                saver._shard_index(path)):
                            raise ValueError("chain token mismatch")
                        with np.load(path) as data:
                            stamp = max(stamp,
                                        int(data[_DELTA_VERSION_KEY]))
                    effective = max(effective, stamp)
                except Exception as e:
                    logger.warning("latest_version: unreadable delta %d in "
                                   "version-%d (%s); truncating", k, v, e)
                    break
            return effective
        return None

    def _candidate_versions(self, version):
        """Base versions to try, preferred first: ``version`` (if any),
        then every one on disk, newest first."""
        if not os.path.isdir(self._dir):
            return []
        versions = _versions(self._dir)[::-1]
        if version is not None:
            versions = [version] + [v for v in versions if v != version]
        return versions

    def _shard_files(self, version):
        vdir = self._version_dir(version)
        return [os.path.join(vdir, fname) for fname in sorted(os.listdir(vdir))
                if _FILE_RE.match(fname)]

    @staticmethod
    def _verify_chain_file(path):
        """Read every array of a shard file (the zip's CRC and length
        checks; peak memory one shard file) and return ``(chain_token,
        delta_version)``, None for keys the file lacks."""
        token = stamp = None
        with np.load(path) as data:
            for key in data.files:
                arr = data[key]
                if key == _CHAIN_TOKEN_KEY:
                    token = str(arr)
                elif key == _DELTA_VERSION_KEY:
                    stamp = int(arr)
        return token, stamp

    @staticmethod
    def _file_token(path):
        """The chain token a shard file carries (None without one)."""
        with np.load(path) as data:
            if _CHAIN_TOKEN_KEY in data.files:
                return str(data[_CHAIN_TOKEN_KEY])
        return None

    @staticmethod
    def _shard_index(path):
        match = _DELTA_RE.match(os.path.basename(path))
        if match:
            return int(match.group(2))
        return int(_FILE_RE.match(os.path.basename(path)).group(1))

    def _chain_plan(self, version):
        """Verified replay plan of one chain: ``(base_files, [(k,
        delta_files, delta_version)])``. Raises on any problem with the
        base (the candidate is unusable); a bad delta (torn, incomplete,
        or another generation's token) truncates the plan there."""
        vdir = self._version_dir(version)
        if not self._complete(vdir):
            raise ValueError("incomplete version dir (missing shards)")
        base_files = self._shard_files(version)
        base_tokens = {}
        for path in base_files:
            token, _ = self._verify_chain_file(path)
            base_tokens[self._shard_index(path)] = token
        deltas = []
        for k, files in self._delta_chain(vdir):
            try:
                stamp = version
                for path in files:
                    token, file_stamp = self._verify_chain_file(path)
                    if token != base_tokens.get(self._shard_index(path)):
                        raise ValueError("chain token mismatch (delta from "
                                         "another chain generation)")
                    if file_stamp is not None:
                        stamp = max(stamp, file_stamp)
            except Exception as e:
                logger.warning("truncating chain version-%d at delta %d: %s",
                               version, k, e)
                events.emit(
                    "checkpoint_delta_skipped", version=version,
                    delta=k, why=str(e)[:200],
                )
                break
            deltas.append((k, files, stamp))
        return base_files, deltas

    def restore(self, store, version=None):
        """Load the newest restorable chain (``version``'s first, if
        given): the full base plus the longest contiguous verified delta
        prefix, keeping only this shard's rows (so any old shard count
        re-shards onto this one). A delta's tombstones replay as deletes
        after its rows. An incomplete version directory or a torn file
        is skipped with a warning and the newest older complete state
        restores instead; every file is verified before the store is
        touched, so a restore is all or nothing. Returns the restored
        effective version (the newest replayed delta's store version),
        or None when nothing on disk restores."""
        for candidate in self._candidate_versions(version):
            try:
                base_files, deltas = self._chain_plan(candidate)
            except Exception as e:
                logger.warning("skipping sparse checkpoint version %d: %s",
                               candidate, e)
                events.emit(
                    "checkpoint_skipped", version=candidate,
                    why=str(e)[:200],
                )
                continue
            # imports one verified file at a time, keeping only this
            # shard's rows: peak memory one shard file
            seen_tables = set()
            for path in base_files:
                with np.load(path) as data:
                    seen_tables |= self._import_shard_arrays(
                        store, {key: data[key] for key in data.files})
            effective = candidate
            last_tables = None
            for _, files, stamp in deltas:
                delta_tables = set()
                for path in files:
                    with np.load(path) as data:
                        delta_tables |= self._import_shard_arrays(
                            store, {key: data[key] for key in data.files})
                seen_tables |= delta_tables
                last_tables = delta_tables
                effective = max(effective, stamp)
            if last_tables is not None:
                # every delta records the live table set, so a table
                # absent from the newest delta was dropped before it:
                # replay the drop (the table-level tombstone)
                for name in sorted(seen_tables - last_tables):
                    if callable(getattr(store, "drop_table", None)):
                        logger.info("dropping table %r absent from the "
                                    "chain's newest delta", name)
                        store.drop_table(name)
            if callable(getattr(store, "clear_dirty", None)):
                # the imports marked every restored row dirty; the chain
                # on disk already holds that state
                for name in store.table_names():
                    store.clear_dirty(name)
            logger.info("Restored sparse checkpoint version %d (+%d deltas "
                        "-> version %d) into shard %d/%d", candidate,
                        len(deltas), effective, self._shard_id,
                        self._shard_num)
            return effective
        return None

    def _import_shard_arrays(self, store, data):
        """Import one verified shard file's arrays (base or delta),
        keeping this shard's rows, then replay the delta's tombstones as
        deletes. Returns the table names the file records."""
        tables = {key.split("/", 1)[1] for key in data
                  if key.startswith("ids/")}
        # sorted: table creation order must not follow set order
        for name in sorted(tables):
            dim = int(data["dim/" + name])
            store.create_table(name, dim)
            saved_opt = (str(data["opt/" + name]) if "opt/" + name in data
                         else None)
            shard = dict(shard_id=self._shard_id, shard_num=self._shard_num)
            if "fullrows/" + name in data and saved_opt == store.opt_type:
                store.import_table_full(name, data["ids/" + name],
                                        data["fullrows/" + name],
                                        data["steps/" + name], **shard)
            elif "fullrows/" + name in data:
                # the optimizer changed since the save: weights only
                store.import_table(name, data["ids/" + name],
                                   data["fullrows/" + name][:, :dim], **shard)
            else:  # a weights-only checkpoint (the older format)
                store.import_table(name, data["ids/" + name],
                                   data["values/" + name], **shard)
            dead = data.get("dead/" + name)
            if dead is not None and dead.size:
                # ids dropped after the rows above were saved (other
                # shards' ids are absent here: a no-op)
                store.drop_rows(name, dead)
        return tables


class AsyncCheckpointer:
    """Off-RPC checkpoint executor: push handlers only enqueue a save
    request, and one thread takes the brief dirty export under the store
    lock and does the serialization and file IO. Requests that arrive
    while a save is in flight coalesce into one trailing save at the
    newest version: a burst costs at most one save in flight and one
    after it.

    The thread is a daemon started by the first request, so building a
    servicer starts no thread. ``stop()`` ends it; the SIGTERM path stops
    without draining, because its synchronous final full save
    supersedes anything pending."""

    def __init__(self, save_fn, name="ps-ckpt"):
        self._save_fn = save_fn
        self._name = name
        self._cond = threading.Condition()
        self._pending = None  # (version, kind)
        self._in_flight = False
        self._stopped = False
        self._thread = None
        self.requested = 0
        self.completed = 0
        self.coalesced = 0

    def request(self, version, kind="sparse"):
        """Enqueue a save; False after stop(). Never blocks on IO: the
        caller is a push handler."""
        with self._cond:
            if self._stopped:
                return False
            self.requested += 1
            if self._pending is not None:
                # folded into this one: the dirty export covers
                # everything up to the moment it runs
                self.coalesced += 1
            self._pending = (int(version), kind)
            if self._thread is None:
                self._thread = threading.Thread(target=self._run,
                                                name=self._name, daemon=True)
                self._thread.start()
            self._cond.notify()
        return True

    def _run(self):
        while True:
            with self._cond:
                while self._pending is None and not self._stopped:
                    self._cond.wait()
                if self._pending is None:
                    return
                version, kind = self._pending
                self._pending = None
                self._in_flight = True
            try:
                self._save_fn(version, kind)
            except Exception:  # the thread outlives a failed save
                logger.exception("async sparse checkpoint failed")
            with self._cond:
                self._in_flight = False
                self.completed += 1
                self._cond.notify_all()

    def drain(self, timeout=30.0):
        """Wait until idle (nothing pending, nothing in flight); True when
        that happened within ``timeout``."""
        deadline = time.time() + timeout
        with self._cond:
            while self._pending is not None or self._in_flight:
                remaining = deadline - time.time()
                if remaining <= 0:
                    return False
                self._cond.wait(remaining)
        return True

    def stop(self, drain=False, timeout=30.0):
        """End the thread; ``drain=True`` finishes pending work first
        (orderly exits), False abandons it (SIGTERM: the final full save
        supersedes it)."""
        if drain:
            self.drain(timeout)
        with self._cond:
            self._stopped = True
            self._pending = None
            self._cond.notify_all()
        thread = self._thread
        if thread is not None and thread is not threading.current_thread():
            thread.join(timeout=timeout)

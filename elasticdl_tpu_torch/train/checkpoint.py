"""Dense train-state checkpoints: full-state, versioned (port of
elasticdl_tpu/train/checkpoint.py).

The whole ``TrainState`` is saved: the params, the model's mutable
state, every optimizer slot and the step, as in the reference, whose
worker restores a job from them (``--checkpoint_dir_for_init``) and
exports a model it never trained itself.

Layout, as the reference's: ``<dir>/<version>/`` with keep-max GC, and
``latest_version()`` reporting only committed versions. The format is
the port's own. The reference writes orbax checkpoints, and orbax is
JAX's library: reading its tensorstore/OCDBT layout needs orbax itself,
which the port does not import, so the port neither reads nor writes
orbax checkpoints. Each version is one ``state.npz`` (no pickle):

- ``params/<name>``: the params under the export's flat flax names
  (the model's ``flax_params``, as ``train/export.py`` writes them);
- ``model_state/<name>``: the buffers under their module names;
- ``opt/<slot>/<name>``: each optimizer slot over the params, under the
  same flax names (Adam's ``mu``, ``nu``), and ``opt/<slot>`` for a
  scalar slot (Adam's ``count``);
- ``step``.

A version is written into a temporary directory under ``<dir>`` and
``os.replace``d into place, so a crash mid-write never leaves a
version that ``latest_version`` reports. ``restore`` loads into the
template's tensors in place, as ``load_state_dict`` does: a state that
shares its tensors with a module (``create_train_state``) keeps doing
so, and the module holds the restored weights.
"""

import dataclasses
import os
import shutil
import threading

import numpy as np
import torch

from elasticdl_tpu_torch.common.log_utils import (
    default_logger as _logger_factory,
)

logger = _logger_factory("elasticdl_tpu_torch.train.checkpoint")

STATE_FILE = "state.npz"
_TMP_PREFIX = ".tmp-"


def _host(tensor):
    """A host copy the training step can no longer change (a CPU
    tensor's ``numpy()`` would share its storage)."""
    return np.array(tensor.detach().cpu().numpy(), copy=True)


def _to_flat(state):
    """{array name: host ndarray} of ``state`` (the module docstring's
    names)."""
    to_flax = state.to_flax or (
        lambda tree: {name: _host(t) for name, t in tree.items()})
    flat = {"step": np.asarray(int(state.step), np.int64)}
    for name, value in to_flax(state.params).items():
        flat["params/" + name] = np.array(value, copy=True)
    for name, tensor in state.model_state.items():
        flat["model_state/" + name] = _host(tensor)
    for slot, value in state.opt_state.items():
        if isinstance(value, dict):
            for name, array in to_flax(value).items():
                flat["opt/%s/%s" % (slot, name)] = np.array(array, copy=True)
        else:
            flat["opt/" + slot] = _host(value)
    return flat


def _load_into(template, arrays, what):
    """Copy ``arrays`` ({name: ndarray}, the template's names) into the
    template's tensors in place; names and shapes must match."""
    if set(arrays) != set(template):
        raise ValueError(
            "checkpoint %s do not match the model: missing %s, "
            "unexpected %s" % (what, sorted(set(template) - set(arrays)),
                               sorted(set(arrays) - set(template))))
    for name, tensor in template.items():
        value = torch.as_tensor(np.asarray(arrays[name]))
        if tuple(value.shape) != tuple(tensor.shape):
            raise ValueError(
                "checkpoint %s %r has shape %s, the model %s"
                % (what, name, tuple(value.shape), tuple(tensor.shape)))
        with torch.no_grad():
            tensor.copy_(value)


class DenseCheckpointManager:
    """Versioned full-TrainState snapshots with keep-max GC.

    ``async_save=True`` (opt-in) copies the state to the host inside
    ``save`` and writes the file on a background thread, so the loop
    resumes after the copy instead of after the write; the next save
    (or ``close``) joins the previous write first, and
    ``latest_version`` only ever reports committed versions."""

    def __init__(self, checkpoint_dir, keep_max=3, create=True,
                 async_save=False):
        # create=False for read-only resume: creating an empty directory
        # at a mistyped path would mask the operator's mistake
        self._dir = os.path.abspath(checkpoint_dir)
        self._keep_max = int(keep_max)
        self._async = bool(async_save)
        self._writer = None
        self._write_error = None
        if not os.path.isdir(self._dir):
            if not create:
                raise FileNotFoundError(
                    "checkpoint dir %s does not exist" % self._dir)
            os.makedirs(self._dir, exist_ok=True)

    # ------------------------------------------------------------------
    def _versions(self):
        """Committed versions, ascending."""
        try:
            names = os.listdir(self._dir)
        except OSError:
            return []
        return sorted(int(n) for n in names if n.isdigit()
                      and os.path.isfile(os.path.join(self._dir, n,
                                                      STATE_FILE)))

    def _write(self, version, flat):
        tmp = os.path.join(self._dir, "%s%d-%d-%d" % (
            _TMP_PREFIX, version, os.getpid(), threading.get_ident()))
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        with open(os.path.join(tmp, STATE_FILE), "wb") as f:
            np.savez(f, **flat)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(self._dir, str(version)))
        self._gc()

    def _gc(self):
        if self._keep_max <= 0:
            return
        for version in self._versions()[:-self._keep_max]:
            # renamed aside first: a reader never sees half a version
            doomed = os.path.join(self._dir, "%sgc-%d-%d" % (
                _TMP_PREFIX, version, os.getpid()))
            os.replace(os.path.join(self._dir, str(version)), doomed)
            shutil.rmtree(doomed, ignore_errors=True)

    def _join(self):
        writer, self._writer = self._writer, None
        if writer is not None:
            writer.join()
        error, self._write_error = self._write_error, None
        if error is not None:
            raise error

    # ------------------------------------------------------------------
    def save(self, version, state):
        """Save ``state`` as ``version``. A version already committed
        is kept (a resumed worker reaching it again skips the save)."""
        version = int(version)
        self._join()
        if version in self._versions():
            logger.info("Dense checkpoint version %d already saved under "
                        "%s; kept", version, self._dir)
            return
        flat = _to_flat(state)
        if not self._async:
            self._write(version, flat)
        else:
            def write():
                try:
                    self._write(version, flat)
                except Exception as e:  # surfaced by the next join
                    self._write_error = e

            self._writer = threading.Thread(
                target=write, name="dense-checkpoint-writer", daemon=True)
            self._writer.start()
        logger.info("Saved dense checkpoint version %d under %s%s",
                    version, self._dir, " (async)" if self._async else "")

    def wait_until_finished(self):
        self._join()

    def latest_version(self):
        versions = self._versions()
        return versions[-1] if versions else None

    def restore(self, version=None, template=None):
        """Load ``version`` (the latest when None) into ``template``, a
        TrainState of the same model and optimizer (typically the
        freshly initialized state), in place; returns the template at
        the restored step, or None when nothing is saved."""
        version = version if version is not None else self.latest_version()
        if version is None:
            return None
        path = os.path.join(self._dir, str(int(version)), STATE_FILE)
        with np.load(path, allow_pickle=False) as data:
            flat = {name: data[name] for name in data.files}
        from_flax = template.from_flax or (
            lambda tree: {name: torch.as_tensor(v)
                          for name, v in tree.items()})

        def group(prefix):
            return {name[len(prefix):]: value for name, value in flat.items()
                    if name.startswith(prefix)}

        _load_into(template.params, from_flax(group("params/")), "params")
        _load_into(template.model_state, group("model_state/"),
                   "model state")
        for slot, value in template.opt_state.items():
            if isinstance(value, dict):
                _load_into(value, from_flax(group("opt/%s/" % slot)),
                           "optimizer slot %r" % slot)
            else:
                _load_into({slot: value}, {slot: flat["opt/" + slot]},
                           "optimizer slot")
        restored = dataclasses.replace(template, step=int(flat["step"]))
        logger.info("Restored dense checkpoint version %d from %s",
                    int(version), self._dir)
        return restored

    def close(self):
        self._join()

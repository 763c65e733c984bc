"""One loaded, servable model version (port of
elasticdl_tpu/serve/model.py).

A ``ServingModel`` is immutable once built: the export's params loaded
into the model-zoo module on its device, floating params cast to the
compute dtype (as ``cast_floating`` does in the JAX eval step), and a
padded-batch ``predict`` that runs the forward under
``torch.inference_mode()``. Every formed batch is zero-padded to
``max_batch``, so each row sees the same shapes whatever batch it rode
in, and a served answer equals ``predict`` on the same rows bit for bit.
Version hot swap builds a NEW ServingModel and swaps the engine's
reference; in-flight batches finish on the instance that admitted them.

A model with sparse embedding tables (DeepFM) serves its export's dense
params beside the training job's PS: a read-only
``SparseBatchPreparer`` (the trainer's own unique-id planning and pull
stack, through the engine's shared cache) swaps the ids for
(rows, indices) features. The padding rows ride under the row mask, so
their ids never reach the PS.
"""

import json
import os

import numpy as np
import torch

from elasticdl_tpu_torch.common.device import resolve_device
from elasticdl_tpu_torch.common.log_utils import (
    default_logger as _logger_factory,
)
from elasticdl_tpu_torch.common.tensor_utils import as_tensor
from elasticdl_tpu_torch.data.pipeline import MASK_KEY
from elasticdl_tpu_torch.train.export import load_exported
from elasticdl_tpu_torch.train.train_state import resolve_dtype

logger = _logger_factory("elasticdl_tpu_torch.serve.model")

# single-input models (features is one bare array, not a dict) wire
# their tensor under this reserved feature key
SINGLE_INPUT_KEY = "__input__"


def export_signature(path):
    """Identity stamp of an export: ``"<step>:<npz mtime_ns>:<manifest
    mtime_ns>"``, or None while the bundle is absent or incomplete.
    Stat-only: manifest.json is written after model.npz, so its
    presence implies a complete bundle."""
    manifest = os.path.join(path, "manifest.json")
    npz = os.path.join(path, "model.npz")
    try:
        manifest_stat = os.stat(manifest)
        npz_stat = os.stat(npz)
    except OSError:
        return None
    try:
        with open(manifest) as f:
            step = int(json.load(f).get("step", -1))
    except (OSError, ValueError):
        return None
    return "%d:%d:%d" % (step, npz_stat.st_mtime_ns, manifest_stat.st_mtime_ns)


class ServingModel:
    """One export, loaded on ``device``, behind a padded-batch
    ``predict``."""

    def __init__(self, spec, export_path, max_batch, ps_client=None,
                 cache=None, compute_dtype=None, device="cuda"):
        self.spec = spec
        self.export_path = export_path
        self.max_batch = int(max_batch)
        self.device = resolve_device(device)
        self.stamp = export_signature(export_path)
        if self.stamp is None:
            raise FileNotFoundError(
                "no complete export at %r (model.npz + manifest.json)"
                % export_path
            )
        params, model_state, step = load_exported(export_path)
        if model_state:
            raise ValueError(
                "export %r carries model_state %s; the port serves "
                "stateless models only" % (export_path, sorted(model_state))
            )
        self.step = int(step)
        model = spec.custom_model()
        model.load_state_dict(spec.params_from_flax(params), strict=True)
        self.compute_dtype = resolve_dtype(compute_dtype)
        if self.compute_dtype is not None:
            model = model.to(self.compute_dtype)  # floating params only
        self.model = model.to(self.device).eval()
        self._preparer = None
        if spec.sparse_embedding_specs:
            if ps_client is None:
                raise ValueError(
                    "model %r declares sparse embedding tables; serving "
                    "it needs a PS client (--ps_addrs)" % (
                        getattr(spec.module, "__name__", spec.module),
                    )
                )
            from elasticdl_tpu_torch.train.sparse import SparseBatchPreparer

            # read_only: the training job created the tables; a PS
            # relaunch drops the engine's cache and registers nothing
            self._preparer = SparseBatchPreparer(
                spec.sparse_embedding_specs(batch_size=self.max_batch),
                ps_client,
                cache=cache,
                read_only=True,
            )

    @property
    def sparse(self):
        return self._preparer is not None

    @property
    def embedding_hit_rate(self):
        if self._preparer is None:
            return 0.0
        return self._preparer._embedding.hit_rate()

    # ------------------------------------------------------------------
    def _pad(self, features, rows):
        """Zero-pad every feature's leading dim to max_batch."""
        if rows > self.max_batch:
            raise ValueError(
                "batch of %d rows exceeds max_batch %d"
                % (rows, self.max_batch)
            )

        def pad(leaf):
            leaf = as_tensor(leaf)
            if leaf.shape[0] == self.max_batch:
                return leaf
            fill = leaf.new_zeros(
                (self.max_batch - leaf.shape[0],) + tuple(leaf.shape[1:])
            )
            return torch.cat([leaf, fill], dim=0)

        if isinstance(features, dict):
            return {k: pad(v) for k, v in features.items()}
        return pad(features)

    def _to_device(self, leaf):
        leaf = leaf.to(self.device)
        if self.compute_dtype is not None and leaf.is_floating_point():
            leaf = leaf.to(self.compute_dtype)
        return leaf

    def predict(self, features, rows):
        """``features``: dict of batch-leading arrays or tensors (or one
        bare array for single-input models) with ``rows`` real rows;
        returns ``{output name: CPU tensor[rows, ...]}``."""
        padded = self._pad(features, rows)
        if self._preparer is not None:
            # the trainer's prepare: unique ids -> cached or pulled rows
            # and indices; the mask keeps the padding rows' ids out of
            # the unique set
            mask = np.zeros((self.max_batch,), np.float32)
            mask[:rows] = 1.0
            prepared, _ = self._preparer.prepare({
                "features": {k: v.numpy() for k, v in padded.items()},
                MASK_KEY: mask,
            })
            padded = {k: as_tensor(v)
                      for k, v in prepared["features"].items()}
        with torch.inference_mode():
            if isinstance(padded, dict):
                outputs = self.model(
                    {k: self._to_device(v) for k, v in padded.items()}
                )
            else:
                outputs = self.model(self._to_device(padded))
            if isinstance(outputs, dict):
                return {k: v[:rows].cpu() for k, v in outputs.items()}
            return {"output": outputs[:rows].cpu()}

    def warm(self, template_features=None, template_rows=1):
        """One predict on a template before this version takes traffic
        (kernel builds, allocator warm-up). Without a template (nothing
        served yet) the first real request warms instead."""
        if template_features is None:
            return False
        self.predict(template_features, template_rows)
        return True

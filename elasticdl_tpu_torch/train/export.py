"""Model export bundle (port of elasticdl_tpu/train/export.py).

The same ``elasticdl_tpu.export.v1`` bundle as the JAX package:
``model.npz`` holding every array under its flat flax name
(``params/block_0/attn/query/kernel``, ``model_state/...``), then
``manifest.json`` written after it (its presence means a complete
bundle). An export written by either package loads in either.
"""

import json
import os

import numpy as np

from elasticdl_tpu_torch.common.log_utils import (
    default_logger as _logger_factory,
)

logger = _logger_factory("elasticdl_tpu_torch.train.export")

FORMAT = "elasticdl_tpu.export.v1"


def export_state_dict(params, path, step=0):
    """Write ``params`` ({flax name: array}, names without the
    ``params/`` prefix -- e.g. ``models.transformer.params_to_flax``)
    as an export bundle of a model with no mutable state."""
    os.makedirs(path, exist_ok=True)
    flat = {"params/" + k: np.asarray(v) for k, v in params.items()}
    np.savez(os.path.join(path, "model.npz"), **flat)
    manifest = {"format": FORMAT, "step": int(step), "num_arrays": len(flat)}
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=2)
    logger.info("Exported model (%d arrays) to %s", len(flat), path)
    return path


def export_train_state(state, path):
    """Write a ``TrainState``'s params as an export bundle at its step.
    The params go out under the export's flax names through the
    model's ``flax_params`` (``state.to_flax``), so a state trained on
    the port serves on either package. Models with mutable state
    (buffers) are not exported yet: the bundle has no mapping for
    their names."""
    if state.model_state:
        raise NotImplementedError(
            "export of a model with buffers %s is not ported yet"
            % sorted(state.model_state)
        )
    params = state.params
    if state.to_flax is not None:
        params = state.to_flax(params)
    else:
        params = {name: t.detach().float().cpu().numpy()
                  for name, t in params.items()}
    return export_state_dict(params, path, step=int(state.step))


def load_exported(path):
    """Returns (params, model_state, step); params and model_state are
    flat {name: ndarray} dicts with the ``params/`` and
    ``model_state/`` prefixes stripped."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    params, model_state = {}, {}
    with np.load(os.path.join(path, "model.npz")) as data:
        for name in data.files:
            group, _, leaf = name.partition("/")
            if group == "params":
                params[leaf] = data[name]
            elif group == "model_state":
                model_state[leaf] = data[name]
    return params, model_state, manifest["step"]

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
from elasticdl_tpu_torch.train.train_state import flat_model_state

logger = _logger_factory("elasticdl_tpu_torch.train.export")

FORMAT = "elasticdl_tpu.export.v1"


def export_state_dict(params, path, step=0, model_state=None):
    """Write ``params`` ({flax name: array}, names without the
    ``params/`` prefix -- e.g. ``models.transformer.params_to_flax``)
    and ``model_state`` ({"<collection>/<flax path>": array}, e.g.
    ``batch_stats/BatchNorm_0/mean``, or None) as an export bundle."""
    os.makedirs(path, exist_ok=True)
    flat = {"params/" + k: np.asarray(v) for k, v in params.items()}
    for name, value in (model_state or {}).items():
        flat["model_state/" + name] = np.asarray(value)
    np.savez(os.path.join(path, "model.npz"), **flat)
    manifest = {"format": FORMAT, "step": int(step), "num_arrays": len(flat)}
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=2)
    logger.info("Exported model (%d arrays) to %s", len(flat), path)
    return path


def export_train_state(state, path):
    """Write a ``TrainState``'s params and model state as an export
    bundle at its step. The params go out under the export's flax names
    through the model's ``flax_params`` (``state.to_flax``), the model
    state under the reference's ``model_state/batch_stats/<flax path>``
    names, so a state trained on the port serves on either package."""
    params = state.params
    if state.to_flax is not None:
        params = state.to_flax(params)
    else:
        params = {name: t.detach().float().cpu().numpy()
                  for name, t in params.items()}
    model_state = {name: t.detach().cpu().numpy()
                   for name, t in flat_model_state(state.model_state).items()}
    return export_state_dict(params, path, step=int(state.step),
                             model_state=model_state)


def load_exported(path):
    """Returns (params, model_state, step); params and model_state are
    flat {name: ndarray} dicts with the ``params/`` and
    ``model_state/`` prefixes stripped (a model state name keeps its
    collection: ``batch_stats/BatchNorm_0/mean``)."""
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

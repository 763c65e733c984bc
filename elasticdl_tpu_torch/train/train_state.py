"""Train state: everything a training step owns (port of
elasticdl_tpu/train/train_state.py).

As in the JAX package, one object holds the whole training state: the
step, the fp32 master parameters (``{name: tensor}``, the module's
``named_parameters`` names), the model's mutable state and the
optimizer state. The tensors live on the trainer's device.

The model state keeps flax's collection layout: ``{"batch_stats":
{buffer name: tensor}}`` (the module's ``named_buffers`` names; every
buffer of the zoo is a BatchNorm statistic), ``{}`` for a model without
buffers. Its flat flax names (``batch_stats/BatchNorm_0/mean``, the
export's ``model_state/`` group) come from ``flat_model_state``.
"""

import dataclasses
from typing import Callable, Optional

import torch


@dataclasses.dataclass
class TrainState:
    step: int
    params: dict
    model_state: dict
    opt_state: dict
    # params -> the export bundle's flat flax names (the model's
    # ``flax_params``), read by train/export.py; None: the names are
    # already the export's
    to_flax: Optional[Callable] = dataclasses.field(
        default=None, repr=False, compare=False
    )
    # the inverse (the model's ``params_from_flax``): flat flax names ->
    # state_dict, read by the dense checkpoints' restore
    from_flax: Optional[Callable] = dataclasses.field(
        default=None, repr=False, compare=False
    )


BATCH_STATS = "batch_stats"


def model_buffers(model_state):
    """``{buffer name: tensor}`` over every collection: what
    ``functional_call`` takes beside the params."""
    return {name: t for tensors in model_state.values()
            for name, t in tensors.items()}


def flat_model_state(model_state):
    """``{"<collection>/<flax path>": tensor}``: the buffer names with
    ``.`` as flax's ``/`` (the zoo's modules carry flax's scope
    names), as the export bundle and the dense checkpoints name them
    under ``model_state/``."""
    return {"%s/%s" % (collection, name.replace(".", "/")): t
            for collection, tensors in model_state.items()
            for name, t in tensors.items()}


def create_train_state(model, tx):
    """State over ``model``'s current parameters and buffers. The state
    shares their storage: the step updates them in place, so the module
    always holds the newest weights."""
    params = {name: p.detach() for name, p in model.named_parameters()}
    buffers = {name: b.detach() for name, b in model.named_buffers()}
    model_state = {BATCH_STATS: buffers} if buffers else {}
    return TrainState(
        step=0,
        params=params,
        model_state=model_state,
        opt_state=tx.init(params),
        to_flax=getattr(model, "flax_params", None),
        from_flax=getattr(model, "params_from_flax", None),
    )


def cast_floating(tree, dtype):
    """Cast floating tensors of a dict/list/tuple tree (bf16 compute on
    the tensor cores); other leaves pass through."""
    if isinstance(tree, dict):
        return {k: cast_floating(v, dtype) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(cast_floating(v, dtype) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(cast_floating(v, dtype) for v in tree)
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return tree.to(dtype)
    return tree


def resolve_dtype(dtype):
    """A torch floating dtype from a name ('bfloat16', 'float32', ...);
    None and torch dtypes pass through."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    resolved = getattr(torch, str(dtype), None)
    if not isinstance(resolved, torch.dtype) or not resolved.is_floating_point:
        raise ValueError("compute dtype %r is not a torch float type" % dtype)
    return resolved


def num_params(params):
    return sum(p.numel() for p in params.values())

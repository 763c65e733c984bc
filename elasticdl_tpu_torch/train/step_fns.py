"""Train/eval step functions, shared by the trainers (port of
elasticdl_tpu/train/step_fns.py).

The model runs through ``torch.func.functional_call`` on the state's
parameters. With a compute dtype, the step casts bf16 copies of the
floating params and features explicitly (as ``cast_floating`` does in
the JAX step), so LayerNorm, softmax and the loss run in bf16 exactly
where the reference runs them; gradients reach the fp32 masters through
the cast and are cast to fp32. ``torch.autocast`` is not used: it keeps
those ops in fp32, which is another program.

The update is applied to the state's tensors in place (``p += u``, the
reference's ``(p + u).astype(p.dtype)``): at the zoo TransformerLM's
width a functional copy of the params and AdamW's slots is 1.6 GB of
device memory a step. The returned state shares those tensors with the
one passed in.

Model state (``{"batch_stats": ...}``, the reference's ``_apply_model``
with ``mutable=``): the train step runs the model in training mode
(``model.train()``) on FRESH copies of the state's buffers, into which
BatchNorm writes the new running averages; with grad accumulation the
copies carry through the microbatches in order, as the reference's
scan carries them. Only an applied update copies them back into the
state's tensors, so a nonfinite batch under the guard leaves the old
statistics whole. The eval step runs in eval mode on the running
averages.

Dropout: each step's masks come from ``layers.dropout_key(step)``
(``(step, microbatch)`` under grad accumulation), set on the model's
``Dropout`` modules for the forward and the backward, so a block
recomputed under remat draws the masks it drew in the forward.
"""

import dataclasses

import torch
from torch.func import functional_call

from elasticdl_tpu_torch.data.pipeline import MASK_KEY
from elasticdl_tpu_torch.models.layers import dropout_key, dropout_seed
from elasticdl_tpu_torch.train.train_state import (
    cast_floating,
    model_buffers,
)


def _leaves(tree):
    if isinstance(tree, dict):
        for value in tree.values():
            yield from _leaves(value)
    elif isinstance(tree, (list, tuple)):
        for value in tree:
            yield from _leaves(value)
    elif isinstance(tree, torch.Tensor):
        yield tree


def _tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, *vs) for vs in zip(tree, *rest))
    return fn(tree, *rest)


def global_grad_norm(*grad_trees):
    """Global L2 norm over every leaf of the given gradient trees, in
    fp32 -- the health scalar the grad-explosion sentinel watches."""
    total = None
    for tree in grad_trees:
        for leaf in _leaves(tree):
            part = torch.sum(torch.square(leaf.float()))
            total = part if total is None else total + part
    if total is None:
        return torch.zeros((), dtype=torch.float32)
    return torch.sqrt(total)


def health_scalars(loss, grad_norm):
    """The health tuple: ``nonfinite`` covers the loss and -- because a
    NaN/Inf anywhere in the gradients makes their global norm
    nonfinite -- every gradient leaf."""
    nonfinite = torch.logical_or(
        torch.logical_not(torch.isfinite(loss)),
        torch.logical_not(torch.isfinite(grad_norm)),
    )
    return {"grad_norm": grad_norm, "nonfinite": nonfinite}


def guard_nonfinite_state(old_state, new_state, nonfinite):
    """Keep the ENTIRE previous state (params, optimizer slots, model
    state, step) where ``nonfinite`` is set, per leaf with
    ``torch.where``, for two states that share no storage.
    ``make_train_step(guard_nonfinite=True)`` gets the same result
    without a second copy by skipping its in-place update."""
    keep = bool(nonfinite)
    pick = lambda old, new: torch.where(nonfinite, old, new)
    return dataclasses.replace(
        new_state,
        step=old_state.step if keep else new_state.step,
        params=_tree_map(pick, old_state.params, new_state.params),
        model_state=_tree_map(pick, old_state.model_state,
                              new_state.model_state),
        opt_state=_tree_map(pick, old_state.opt_state, new_state.opt_state),
    )


def apply_model(model, params, model_state, features):
    """The model's outputs at ``params`` and ``model_state`` (a
    functional call: the module's own tensors are not read; a training
    mode BatchNorm writes its running averages into ``model_state``'s
    tensors)."""
    return functional_call(
        model, {**params, **model_buffers(model_state)}, (features,))


def _fresh_model_state(model_state):
    """Copies of the buffers for a training forward to write into."""
    return _tree_map(torch.clone, model_state)


def _commit_model_state(state, new_model_state):
    """The new running averages into the state's own tensors (in place,
    as the optimizer update)."""
    with torch.no_grad():
        for old, new in zip(_leaves(state.model_state),
                            _leaves(new_model_state)):
            old.copy_(new)


def _make_loss_grads_state(model, loss_fn, compute_dtype, grad_accum_steps):
    """(state, batch) -> (loss, fp32 grads, new model state): the train
    step's forward and backward in training mode."""
    if grad_accum_steps < 1:
        raise ValueError(
            "grad_accum_steps must be >= 1, got %r" % (grad_accum_steps,)
        )
    k = int(grad_accum_steps)

    def loss_sum(leaves, model_state, features, labels, mask):
        """(masked loss SUM, mask weight) -- summed so microbatch
        gradients add linearly."""
        compute_params, compute_features = leaves, features
        if compute_dtype is not None:
            compute_params = cast_floating(leaves, compute_dtype)
            compute_features = cast_floating(features, compute_dtype)
        outputs = apply_model(model, compute_params, model_state,
                              compute_features)
        per_sample = loss_fn(labels, outputs).float()
        # multi-dim per-sample losses average over their trailing dims
        per_sample = per_sample.reshape(mask.shape[0], -1).mean(dim=1)
        return torch.sum(per_sample * mask), torch.sum(mask)

    def run(state, batch):
        features, labels, mask = (
            batch["features"], batch["labels"], batch[MASK_KEY]
        )
        model.train()
        model_state = _fresh_model_state(state.model_state)
        leaves = {n: p.detach().requires_grad_()
                  for n, p in state.params.items()}
        names, inputs = list(leaves), list(leaves.values())
        if k == 1:
            # the seed stays set through the backward: a remat block's
            # recompute redraws the forward's masks
            with dropout_seed(model, dropout_key(state.step)):
                total, weight = loss_sum(leaves, model_state, features,
                                         labels, mask)
                loss = total / torch.clamp(weight, min=1.0)
                grads = torch.autograd.grad(loss, inputs)
            return loss.detach(), {
                n: g.float() for n, g in zip(names, grads)
            }, model_state

        whole = (features, labels, mask)
        for leaf in _leaves(whole):
            if leaf.shape[0] % k:
                raise ValueError(
                    "batch dim %d not divisible by grad_accum_steps=%d"
                    % (leaf.shape[0], k)
                )
        grads_sum = [torch.zeros_like(p, dtype=torch.float32) for p in inputs]
        loss_total = weight_total = 0.0
        for i in range(k):
            # STRIDED split (microbatch i = rows i::k), as the reference
            # does: under a sharded batch every microbatch draws from
            # every device's block; which rows ride together does not
            # change the sums. The model state carries from one
            # microbatch to the next.
            m_features, m_labels, m_mask = _tree_map(
                lambda leaf: leaf[i::k], whole)
            with dropout_seed(model, dropout_key(state.step, i)):
                total, weight = loss_sum(leaves, model_state, m_features,
                                         m_labels, m_mask)
                micro_grads = torch.autograd.grad(total, inputs)
            for acc, g in zip(grads_sum, micro_grads):
                acc.add_(g.float())
            loss_total = loss_total + total.detach()
            weight_total = weight_total + weight
        weight = torch.clamp(weight_total, min=1.0)
        return loss_total / weight, {
            n: g / weight for n, g in zip(names, grads_sum)
        }, model_state

    return run


def make_loss_and_grads(model, loss_fn, compute_dtype=None,
                        grad_accum_steps=1):
    """Returns loss_and_grads(state, batch) -> (loss, grads): the masked
    mean loss over the batch's real rows and its fp32 gradients with
    respect to ``state.params``, in training mode (the state's model
    state is read, never written).

    ``grad_accum_steps=k`` splits the batch into k strided microbatches
    (rows i::k), accumulates MASK-WEIGHTED loss and gradient sums over
    them and divides once by the whole batch's weight: the same
    large-batch semantics with activation memory divided by k."""
    run = _make_loss_grads_state(model, loss_fn, compute_dtype,
                                 grad_accum_steps)

    def loss_and_grads(state, batch):
        loss, grads, _ = run(state, batch)
        return loss, grads

    return loss_and_grads


def apply_update(tx, state, grads):
    """One optimizer step of ``grads`` ({name: fp32 tensor}) on the
    state's params, in place; returns the state with its step advanced
    (the dense and the sparse train steps share it)."""
    with torch.no_grad():
        updates, opt_state = tx.update(grads, state.opt_state, state.params)
        for name, p in state.params.items():
            p.add_(updates[name])
    return dataclasses.replace(state, step=state.step + 1,
                               opt_state=opt_state)


def make_train_step(model, loss_fn, tx, compute_dtype=None,
                    grad_accum_steps=1, health=False,
                    guard_nonfinite=False):
    """Returns train_step(state, batch) -> (new_state, loss).

    ``health=True`` additionally returns a third output, the health
    scalars dict (global grad norm and nonfinite flag); with
    ``guard_nonfinite`` a nonfinite batch keeps the previous state
    entire (the update is skipped, so the batch contributes nothing).
    ``health=False`` returns exactly ``(new_state, loss)``."""
    run = _make_loss_grads_state(model, loss_fn, compute_dtype,
                                 grad_accum_steps)

    def update(state, grads, model_state):
        _commit_model_state(state, model_state)
        return apply_update(tx, state, grads)

    def train_step(state, batch):
        loss, grads, model_state = run(state, batch)
        if not health:
            return update(state, grads, model_state), loss
        scalars = health_scalars(loss, global_grad_norm(grads))
        if guard_nonfinite and bool(scalars["nonfinite"]):
            # params, slots, step AND model state stay as they were
            return state, loss, scalars
        return update(state, grads, model_state), loss, scalars

    return train_step


def make_eval_step(model, compute_dtype=None):
    """Returns eval_step(state, features) -> outputs."""

    def eval_step(state, features):
        model.eval()  # BatchNorm on the running averages, no dropout
        params = state.params
        if compute_dtype is not None:
            params = cast_floating(params, compute_dtype)
            features = cast_floating(features, compute_dtype)
        with torch.no_grad():
            return apply_model(model, params, state.model_state, features)

    return eval_step

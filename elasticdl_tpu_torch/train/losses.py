"""Per-sample loss functions (port of elasticdl_tpu/train/losses.py).

The model contract's ``loss(labels, predictions)`` returns a
**per-sample** loss vector (shape [batch]); the trainer reduces it with
the batch mask so padded tail batches never bias training (see
data/pipeline.py). The arithmetic is optax's, in the logits' dtype: a
bf16 model's cross entropy is computed in bf16, as the JAX package
computes it.
"""

import torch
import torch.nn.functional as F


def sparse_softmax_cross_entropy(labels, logits):
    """optax.softmax_cross_entropy_with_integer_labels:
    ``logsumexp(logits) - logits[label]``, the logsumexp taken as
    jax.nn.logsumexp takes it (shift by the stop-gradient max)."""
    label_logits = logits.gather(-1, labels.long().unsqueeze(-1)).squeeze(-1)
    amax = logits.detach().amax(dim=-1, keepdim=True)
    amax = torch.where(torch.isfinite(amax), amax, torch.zeros_like(amax))
    log_normalizers = (
        torch.log(torch.exp(logits - amax).sum(dim=-1)) + amax.squeeze(-1)
    )
    return log_normalizers - label_logits


def sigmoid_binary_cross_entropy(labels, logits):
    """optax.sigmoid_binary_cross_entropy on logits reshaped to the
    labels' shape."""
    logits = logits.reshape(labels.shape)
    labels = labels.to(logits.dtype)
    return -labels * F.logsigmoid(logits) - (1.0 - labels) * F.logsigmoid(
        -logits
    )


def mean_squared_error(labels, predictions):
    predictions = predictions.reshape(labels.shape)
    return torch.square(predictions - labels.to(predictions.dtype))


def masked_mean(per_sample, mask):
    """Mean over real rows of a (possibly padded) batch."""
    per_sample = per_sample.reshape(mask.shape[0], -1).mean(dim=1)
    denom = torch.clamp(mask.sum(), min=1.0)
    return (per_sample * mask).sum() / denom

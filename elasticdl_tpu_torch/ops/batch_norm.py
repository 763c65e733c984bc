"""BatchNorm with the reference's math (port of
elasticdl_tpu/ops/batch_norm.py; the reference is jnp, no Pallas
kernel, so this is plain torch).

- statistics in float32 in one pass: ``E[x]`` and the biased variance
  ``E[x^2] - E[x]^2``, clamped at 0; the backward keeps the input in
  its own dtype, not a float32 copy;
- the running averages follow flax's momentum convention,
  ``ra = m * ra + (1 - m) * batch`` with ``m = 0.9``;
- ``stats_samples=k`` takes the statistics over the first ``k`` batch
  rows only (every row is normalized);
- the normalize is ``x * mul + add`` in the input's dtype, with
  ``mul = scale * rsqrt(var + eps)`` and ``add = bias - mean * mul``
  computed on the per-channel vectors in float32.

``nn.BatchNorm2d`` and ``F.batch_norm(training=True)`` are not used:
their momentum is the complement of flax's and they update the running
variance with the unbiased estimator, so the running statistics would
leave the reference's after the first step.

Names follow flax: parameters ``scale`` and ``bias``, buffers ``mean``
and ``var`` (the ``batch_stats`` collection). The module reads
``self.training``: in training mode it normalizes with the batch's
statistics and writes the new running averages IN PLACE into its
``mean`` and ``var`` buffers (under ``functional_call`` those are the
tensors the step passed in: train/step_fns.py hands it fresh copies,
so a batch whose update is skipped leaves the old statistics whole);
in eval mode it normalizes with the running averages.

``dtype`` pins the output dtype: flax's stock ``nn.BatchNorm(dtype=
float32)`` (the cifar10 model's) normalizes and outputs in float32.
``None`` outputs the input's dtype, as ``TpuBatchNorm`` does.

Under data parallelism (an ambient mesh, parallel/mesh.py, whose data
axes hold more than one rank) each rank holds its share of the batch's
rows, where the reference's one SPMD program takes ``jnp.mean`` over the
whole sharded batch. So each rank's ``E[x]`` and ``E[x^2]`` are weighted
by its share of the batch's rows (of the first ``stats_samples`` rows
when set) and summed over the data ranks in one all-reduce, whose
backward all-reduces the ranks' gradients of the global moments
(``collectives.mesh_replicate``): every rank normalizes with the whole
batch's statistics and writes the same running averages. On one rank,
or without a mesh, nothing of this runs.
"""

import torch
from torch import nn

from elasticdl_tpu_torch.parallel import collectives
from elasticdl_tpu_torch.parallel.mesh import DATA_AXES, current_mesh


class _Moments(torch.autograd.Function):
    """``(E[x], E[x^2])`` over ``dims`` in ``dtype``, saving only ``x``
    for the backward: autograd of ``x.float()`` would keep a float32
    copy of every BatchNorm input until the backward (ResNet-50 at batch
    256 in bf16 would not fit the card's 80 GB)."""

    @staticmethod
    def forward(ctx, x, dims, dtype):
        xf = x.to(dtype)
        ctx.save_for_backward(x)
        ctx.dims, ctx.dtype = dims, dtype
        return xf.mean(dims), torch.square(xf).mean(dims)

    @staticmethod
    def backward(ctx, grad_mean, grad_mean_sq):
        x, = ctx.saved_tensors
        count = 1
        shape = list(x.shape)
        for d in ctx.dims:
            count *= x.shape[d]
            shape[d] = 1
        xf = x.to(ctx.dtype)
        grad = (grad_mean / count).view(shape) + 2 * xf * (
            grad_mean_sq / count).view(shape)
        return grad.to(x.dtype), None, None


class BatchNorm(nn.Module):
    # the statistics' dtype (the reference's float32; a parity test in
    # float64 widens it on both sides)
    stats_dtype = torch.float32

    def __init__(self, features, momentum=0.9, epsilon=1e-5,
                 scale_init=1.0, stats_samples=0, dtype=None):
        super().__init__()
        self.momentum = momentum
        self.epsilon = epsilon
        self.stats_samples = int(stats_samples)
        self.dtype = dtype
        self.scale_init = float(scale_init)
        self.scale = nn.Parameter(torch.full((features,), self.scale_init))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def reset_parameters(self):
        with torch.no_grad():
            self.scale.fill_(self.scale_init)
            self.bias.zero_()

    def _mesh_moments(self, x, dims, mesh, axes):
        """The whole batch's ``(E[x], E[x^2])`` from this rank's rows
        ``x`` (the module docstring): the batch splits evenly over the
        data ranks, this rank's rows start at its data index times
        its row count."""
        rows, ranks = x.shape[0], mesh.size(axes)
        total = rows * ranks
        take = rows
        if self.stats_samples:
            total = min(self.stats_samples, total)
            take = min(max(self.stats_samples - mesh.index(axes) * rows, 0),
                       rows)
        if take:
            mean, mean_sq = _Moments.apply(x[:take], dims, self.stats_dtype)
            local = torch.stack([mean, mean_sq]) * (take / total)
        else:
            local = x.new_zeros((2, x.shape[1]), dtype=self.stats_dtype)
        moments = collectives.mesh_psum(
            collectives.mesh_replicate(local, axes, mesh=mesh), axes,
            mesh=mesh)
        return moments[0], moments[1]

    def forward(self, x):
        """``x``: [B, C, ...], channels on axis 1 (the zoo's NCHW
        stream)."""
        if self.training:
            dims = (0,) + tuple(range(2, x.dim()))
            mesh = current_mesh()
            axes = mesh.live_axes(DATA_AXES) if mesh is not None else ()
            if axes:
                mean, mean_sq = self._mesh_moments(x, dims, mesh, axes)
            else:
                xs = x[:self.stats_samples] if self.stats_samples else x
                mean, mean_sq = _Moments.apply(xs, dims, self.stats_dtype)
            var = torch.clamp(mean_sq - torch.square(mean), min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_(m * self.mean + (1 - m) * mean)
                self.var.copy_(m * self.var + (1 - m) * var)
        else:
            mean, var = self.mean, self.var
        inv = torch.rsqrt(var + self.epsilon) * self.scale
        out_dtype = self.dtype or x.dtype
        shape = [1] * x.dim()
        shape[1] = -1
        mul = inv.to(out_dtype).view(shape)
        add = (self.bias - mean * inv).to(out_dtype).view(shape)
        return x.to(out_dtype) * mul + add


TpuBatchNorm = BatchNorm

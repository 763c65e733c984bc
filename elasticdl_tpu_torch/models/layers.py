"""flax ``linen`` layers the vision zoo is built from, as ``nn.Module``s
(port addition: the JAX package takes them from flax).

- ``Conv``: ``nn.Conv`` on NCHW tensors (channels_last memory, cuDNN's
  fast path); ``"SAME"`` padding is XLA's, lower half
  ``total // 2``, so an even kernel or a stride-2 window pads
  unevenly, through an explicit ``F.pad``;
- ``Dense`` and ``LazyDense``: ``nn.Dense`` (the lazy one sized by the
  first batch, as flax sizes every Dense);
- ``Dropout``: ``nn.Dropout`` (keep with probability ``1 - rate``,
  scale the kept units by ``1 / (1 - rate)``), its mask drawn from
  ``(seed, site)`` through a generator made for that call, never from
  a generator that carries state from call to call, so a recomputed
  block (``torch.utils.checkpoint``) draws the same mask;
- ``init_flax_``: flax's default initializers (lecun-normal kernels
  truncated at two standard deviations, zero biases).

As flax promotes, ``Conv`` and ``Dense`` compute in the wider of the
input's and the kernel's dtype unless a ``dtype`` pins it.

Names: a model of these layers names its submodules as flax names its
scopes (``Conv_0``, ``BatchNorm_1``, ``BottleneckBlock_3``), so
``params_from_flax`` and ``params_to_flax`` map the export bundle's
flat flax names onto its state_dict by layout alone: conv kernels
``(kh, kw, in, out)`` are ``weight.permute(2, 3, 1, 0)``, Dense kernels
``(in, out)`` are ``weight.T``, BatchNorm's ``scale``/``bias`` and its
``batch_stats`` ``mean``/``var`` keep their names.
"""

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# the stddev of a unit normal truncated to [-2, 2]: flax's
# truncated-normal variance scaling divides by it
_TRUNC_STD = 0.87962566103423978
_MASK64 = (1 << 64) - 1


def _promote(x, *tensors, dtype=None):
    dtype = dtype or torch.promote_types(x.dtype, tensors[0].dtype)
    return x.to(dtype), [None if t is None else t.to(dtype) for t in tensors]


def same_pads(size, kernel, stride):
    """XLA's ``"SAME"`` padding of one spatial axis: ``(low, high)``."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """flax ``nn.Conv`` over NCHW: ``padding`` is ``"SAME"``,
    ``"VALID"`` or ``((low, high), (low, high))``."""

    def __init__(self, in_features, features, kernel_size, strides=1,
                 padding="SAME", groups=1, use_bias=True):
        super().__init__()
        kh, kw = kernel_size
        self.strides = (strides, strides) if isinstance(strides, int) else (
            tuple(strides))
        self.padding = padding
        self.groups = groups
        self.weight = nn.Parameter(
            torch.empty(features, in_features // groups, kh, kw))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def _pads(self, x):
        if self.padding == "VALID":
            return ((0, 0), (0, 0))
        if self.padding == "SAME":
            return tuple(same_pads(n, k, s) for n, k, s in zip(
                x.shape[2:], self.weight.shape[2:], self.strides))
        return tuple(tuple(p) for p in self.padding)

    def forward(self, x):
        x, (weight, bias) = _promote(x, self.weight, self.bias)
        (top, bottom), (left, right) = self._pads(x)
        if top == bottom and left == right:
            padding = (top, left)
        else:
            x = F.pad(x, (left, right, top, bottom))
            padding = 0
        return F.conv2d(x, weight, bias, self.strides, padding, 1,
                        self.groups)


def _dense(self, x):
    x, (weight, bias) = _promote(x, self.weight, self.bias,
                                 dtype=self.dtype)
    return F.linear(x, weight, bias)


class Dense(nn.Linear):
    """flax ``nn.Dense``; ``dtype`` pins the compute dtype (the zoo's
    ``Dense(dtype=float32)`` heads give fp32 logits under bf16)."""

    dtype = None

    def __init__(self, in_features, features, use_bias=True, dtype=None):
        super().__init__(in_features, features, bias=use_bias)
        self.dtype = dtype

    forward = _dense


class LazyDense(nn.LazyLinear):
    """``Dense`` whose input width comes from the first batch."""

    cls_to_become = Dense
    dtype = None

    def __init__(self, features, use_bias=True, dtype=None):
        super().__init__(features, bias=use_bias)
        self.dtype = dtype

    forward = _dense


# ---------------------------------------------------------------------------
# dropout
# ---------------------------------------------------------------------------


def _mix(value):
    """splitmix64's finalizer: well-spread 64-bit words from counters."""
    value = (value + 0x9E3779B97F4A7C15) & _MASK64
    value = ((value ^ (value >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    value = ((value ^ (value >> 27)) * 0x94D049BB133111EB) & _MASK64
    return value ^ (value >> 31)


def dropout_key(step, microbatch=None):
    """The seed of one step's masks (the reference folds the step, then
    the microbatch index, into ``PRNGKey(0)``)."""
    key = _mix(int(step))
    if microbatch is not None:
        key = _mix(key ^ (int(microbatch) + 1))
    return key


class Dropout(nn.Module):
    """flax ``nn.Dropout``: identity in eval mode or at rate 0. In
    training mode the mask comes from this module's ``seed`` and its
    ``site`` (its index among the model's dropouts), both set by
    ``dropout_seed``."""

    def __init__(self, rate):
        super().__init__()
        self.rate = float(rate)
        self.seed = None
        self.site = 0

    def forward(self, x):
        if not self.training or self.rate == 0.0:
            return x
        if self.seed is None:
            raise RuntimeError(
                "Dropout in training mode needs a seed: run the model "
                "under layers.dropout_seed(model, key)")
        keep = 1.0 - self.rate
        if keep == 0.0:
            return torch.zeros_like(x)
        generator = torch.Generator(device=x.device)
        generator.manual_seed(
            _mix(self.seed ^ _mix(self.site)) & ((1 << 63) - 1))
        draw = torch.rand(x.shape, generator=generator, device=x.device)
        return torch.where(draw < keep, x / keep, torch.zeros_like(x))


@contextlib.contextmanager
def dropout_seed(model, key):
    """Give every ``Dropout`` of ``model`` the seed ``key`` (and its
    site) for the forward AND the backward run inside the block: a
    recompute under ``torch.utils.checkpoint`` redraws the same mask."""
    sites = [m for m in model.modules() if isinstance(m, Dropout)]
    for site, module in enumerate(sites):
        module.seed, module.site = key, site
    try:
        yield
    finally:
        for module in sites:
            module.seed = None


# ---------------------------------------------------------------------------
# initialization and flax names
# ---------------------------------------------------------------------------


def has_uninitialized_params(model):
    """Whether a lazy layer of ``model`` still waits for its first
    batch."""
    return any(isinstance(p, nn.parameter.UninitializedParameter)
               for p in model.parameters())


def _lecun_normal_(weight, fan_in, generator):
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    values = torch.empty(weight.shape)
    nn.init.trunc_normal_(values, mean=0.0, std=std, a=-2.0 * std,
                          b=2.0 * std, generator=generator)
    weight.copy_(values)


@torch.no_grad()
def init_flax_(model, generator=None):
    """flax's default initializers on every ``Conv`` and ``Dense`` of
    ``model`` (lecun-normal kernels truncated at two stddevs, drawn on
    the CPU from ``generator``, or the default generator; zero biases).
    Layers not yet sized are left alone. BatchNorm keeps its own
    ``scale_init``."""
    for module in model.modules():
        if isinstance(module, nn.modules.lazy.LazyModuleMixin) and (
                module.has_uninitialized_params()):
            continue
        if isinstance(module, Conv):
            fan_in = math.prod(module.weight.shape[1:])
        elif isinstance(module, nn.Linear):
            fan_in = module.weight.shape[1]
        else:
            continue
        _lecun_normal_(module.weight, fan_in, generator)
        if module.bias is not None:
            module.bias.zero_()


def _strip(name):
    for prefix in ("params/", "model_state/", "batch_stats/"):
        if name.startswith(prefix):
            name = name[len(prefix):]
    return name


def params_from_flax(flat):
    """``{flax name: array}`` -> state_dict. Names may carry the export's
    ``params/`` or ``model_state/`` prefix; ``batch_stats/...`` names
    are the BatchNorm buffers."""
    state = {}
    for name, value in flat.items():
        path, _, leaf = _strip(name).rpartition("/")
        value = np.asarray(value)
        if leaf == "kernel":
            leaf = "weight"
            value = (value.transpose(3, 2, 0, 1) if value.ndim == 4
                     else value.T)
        state["%s.%s" % (path.replace("/", "."), leaf)] = torch.from_numpy(
            np.array(value, order="C"))
    return state


def params_to_flax(tensors):
    """``{torch name: tensor}`` (params or buffers) -> ``{flax name: fp32
    ndarray}`` without a collection prefix."""
    flat = {}
    for name, tensor in tensors.items():
        path, _, leaf = name.rpartition(".")
        value = tensor.detach().float().cpu().numpy()
        if leaf == "weight":
            leaf = "kernel"
            value = (value.transpose(2, 3, 1, 0) if value.ndim == 4
                     else value.T)
        flat["%s/%s" % (path.replace(".", "/"), leaf)] = (
            np.ascontiguousarray(value))
    return flat


class FlaxNamed(nn.Module):
    """Base of the vision zoo's models: flax names both ways, flax's
    initializers, conv weights in channels_last memory."""

    def channels_last_(self):
        """Conv weights in channels_last memory (cuDNN's fast path for
        NCHW activations in channels_last memory)."""
        with torch.no_grad():
            for module in self.modules():
                if isinstance(module, Conv):
                    module.weight.data = module.weight.data.contiguous(
                        memory_format=torch.channels_last)
        return self

    def flax_params(self, state):
        """``{name: tensor}`` in this module's names -> the export's
        flat flax names (train/export.py reads it)."""
        return params_to_flax(state)

    def params_from_flax(self, flat):
        return params_from_flax(flat)

    def reset_parameters(self, generator=None):
        init_flax_(self, generator)

"""Single-card trainer around the shared step functions (port of
elasticdl_tpu/worker/trainer.py, ``JaxTrainer``).

The JAX trainer jits the step; PyTorch runs it eagerly, so
``TorchTrainer`` moves each numpy batch to its device once and calls
the step functions of train/step_fns.py: forward, backward through the
flash kernels, optimizer update, all on the card. The JAX package's
compile sentinels and cost counters (``instrumented_jit``,
``cost_step_*``) wait for the device-observability port.
"""

import numpy as np
import torch

from elasticdl_tpu_torch.common.device import resolve_device
from elasticdl_tpu_torch.models.layers import has_uninitialized_params
from elasticdl_tpu_torch.train.health import maybe_tracker
from elasticdl_tpu_torch.train.step_fns import make_eval_step, make_train_step
from elasticdl_tpu_torch.train.train_state import (
    create_train_state,
    resolve_dtype,
)


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_device(v, device) for v in tree)
    return torch.as_tensor(np.asarray(tree)).to(device, non_blocking=True)


def _to_numpy(tree):
    """Outputs to numpy; bf16 (no numpy dtype without ml_dtypes) goes
    out as fp32, which holds every bf16 value exactly."""
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if tree.dtype == torch.bfloat16:
        tree = tree.float()
    return tree.cpu().numpy()


class TorchTrainer:
    def __init__(self, model, loss_fn, optimizer, compute_dtype=None,
                 grad_accum_steps=1, health=None, device="cuda", seed=0):
        """``model`` is trained in place on ``device`` (``cuda`` unless
        the caller asks for the CPU; no card raises). ``health``: None
        reads EDL_HEALTH (default on), False disables, or pass a
        HealthTracker. ``seed`` initialises the layers a model sizes
        from its first batch."""
        self.device = resolve_device(device)
        self._seed = seed
        self._model = model.to(self.device)
        self._tx = optimizer
        if health is None:
            self.health = maybe_tracker(role="worker")
        elif health is False:
            self.health = None
        else:
            self.health = health
        self._health_on = self.health is not None
        compute_dtype = resolve_dtype(compute_dtype)
        self._train_step = make_train_step(
            self._model, loss_fn, optimizer, compute_dtype,
            grad_accum_steps=grad_accum_steps,
            health=self._health_on,
            guard_nonfinite=(
                self._health_on and self.health.action == "skip"
            ),
        )
        self._eval_step = make_eval_step(self._model, compute_dtype)

    @property
    def model(self):
        """The module being trained (its parameters are the state's)."""
        return self._model

    # ------------------------------------------------------------------
    def create_state(self, sample_features=None):
        """State over the model's current weights. A model with layers
        sized by the first batch (flax's Dense infers its input width;
        the port's ``LazyDense``) runs once on ``sample_features`` in
        eval mode to size them, then draws its weights from the
        trainer's seed through ``reset_parameters(generator)``; a model
        whose weights exist (built or loaded) keeps them."""
        if has_uninitialized_params(self._model):
            if sample_features is None:
                raise ValueError("the model sizes layers from its first "
                                 "batch: pass sample_features")
            features = _to_device(sample_features, self.device)
            devices = [self.device] if self.device.type == "cuda" else []
            # sizing draws no number from the caller's RNG streams and
            # moves no running average
            with torch.random.fork_rng(devices=devices), torch.no_grad():
                self._model.eval()
                self._model(features)
            self._model.reset_parameters(
                torch.Generator().manual_seed(self._seed))
        return create_train_state(self._model, self._tx)

    def ensure_state(self, state, batch):
        if state is None:
            return self.create_state(batch["features"])
        return state

    def train_step(self, state, batch):
        """One step on a numpy batch; returns ``(state, loss)`` with the
        loss a 0-d tensor on the device."""
        state = self.ensure_state(state, batch)
        batch = _to_device(batch, self.device)
        if not self._health_on:
            return self._train_step(state, batch)
        state, loss, scalars = self._train_step(state, batch)
        # a skip-sentinel batch already kept its state; halt raises
        self.health.observe(
            float(loss),
            float(scalars["grad_norm"]),
            bool(scalars["nonfinite"]),
        )
        return state, loss

    def eval_step(self, state, batch):
        features = _to_device(batch["features"], self.device)
        return _to_numpy(self._eval_step(state, features))

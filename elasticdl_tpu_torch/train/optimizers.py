"""Optimizer factory (port of elasticdl_tpu/train/optimizers.py, the
dense optimizers SGD, Momentum, Adam and AdamW).

Each optimizer is optax's update rule with optax's defaults, written
out over a ``{name: tensor}`` parameter dict: ``init(params)`` returns
the optimizer state (a dict of tensors, so ``TrainState.opt_state``
holds all of it), and ``update(grads, state, params)`` returns
``(updates, state)`` with ``params + updates`` the next parameters, as
``optax.GradientTransformation`` does.

The port updates the state's slot tensors (momentum trace, Adam's mu
and nu, the step count) IN PLACE and returns the same dict: at the zoo
TransformerLM's width a functional copy of AdamW's two slots is 1.07 GB
more device memory per step. Callers that need the previous state keep
it themselves (``step_fns.make_train_step`` skips the update of a
nonfinite batch instead).

The module imports torch only inside the optimizer factories, so
``parse_opt_args`` stays torch-free: a PS entry parses the same
``k=v;k=v`` strings.
"""

from typing import Callable, NamedTuple

SUPPORTED = ("SGD", "Momentum", "Adam", "AdamW")
# the JAX package's other optimizers, not ported yet (ROADMAP Queue 1)
NOT_PORTED = ("Adagrad", "RMSprop", "Adamax", "Nadam", "Adadelta", "Ftrl")


class GradientTransformation(NamedTuple):
    init: Callable
    update: Callable


def _scaled(updates, learning_rate):
    """optax.scale_by_learning_rate: ``-lr * u``."""
    step_size = -learning_rate
    return {name: step_size * u for name, u in updates.items()}


def sgd(learning_rate, momentum=None, nesterov=False):
    """optax.sgd: an optional trace (``t = g + momentum * t``; nesterov
    steps along ``g + momentum * t``), then ``-lr``."""
    import torch

    def init(params):
        if momentum is None:
            return {}
        return {"trace": {n: torch.zeros_like(p) for n, p in params.items()}}

    def update(grads, state, params=None):
        del params
        if momentum is None:
            return _scaled(grads, learning_rate), state
        directions = {}
        for name, g in grads.items():
            trace = state["trace"][name]
            trace.mul_(momentum).add_(g)
            directions[name] = g + momentum * trace if nesterov else trace
        return _scaled(directions, learning_rate), state

    return GradientTransformation(init, update)


def adam(learning_rate, b1=0.9, b2=0.999, eps=1e-8, weight_decay=None):
    """optax.adam, and optax.adamw when ``weight_decay`` is given:
    ``mu = (1 - b1) g + b1 mu``, ``nu = (1 - b2) g^2 + b2 nu``, bias
    corrections ``1 - b ** count`` in fp32, ``u = mu_hat / (sqrt(nu_hat)
    + eps)``, AdamW adds ``weight_decay * p`` to every parameter (optax
    adamw with no mask), then ``-lr``."""
    import torch

    def init(params):
        device = next(iter(params.values())).device if params else None
        return {
            "count": torch.zeros((), dtype=torch.int32, device=device),
            "mu": {n: torch.zeros_like(p) for n, p in params.items()},
            "nu": {n: torch.zeros_like(p) for n, p in params.items()},
        }

    def update(grads, state, params=None):
        if weight_decay is not None and params is None:
            raise ValueError("adamw needs params for its weight decay")
        count = state["count"]
        count.add_(1)
        fp32 = lambda x: torch.full((), x, dtype=torch.float32,
                                    device=count.device)
        correction1 = 1 - torch.pow(fp32(b1), count)
        correction2 = 1 - torch.pow(fp32(b2), count)
        directions = {}
        for name, g in grads.items():
            mu = state["mu"][name].mul_(b1).add_((1 - b1) * g)
            nu = state["nu"][name].mul_(b2).add_((1 - b2) * torch.square(g))
            u = (mu / correction1) / (torch.sqrt(nu / correction2) + eps)
            if weight_decay is not None:
                u = u + weight_decay * params[name]
            directions[name] = u
        return _scaled(directions, learning_rate), state

    return GradientTransformation(init, update)


def create_optimizer(opt_type: str, **opt_args) -> GradientTransformation:
    opt_type_lower = opt_type.lower()
    lr = float(opt_args.pop("learning_rate", 0.01))
    if opt_type_lower == "sgd":
        momentum = float(opt_args.pop("momentum", 0.0))
        nesterov = _parse_bool(opt_args.pop("nesterov", False))
        _reject_extra(opt_type, opt_args)
        return sgd(lr, momentum=momentum or None, nesterov=nesterov)
    if opt_type_lower == "momentum":
        momentum = float(opt_args.pop("momentum", 0.9))
        nesterov = _parse_bool(opt_args.pop("nesterov", False))
        _reject_extra(opt_type, opt_args)
        return sgd(lr, momentum=momentum, nesterov=nesterov)
    if opt_type_lower in ("adam", "adamw"):
        b1 = float(opt_args.pop("beta_1", 0.9))
        b2 = float(opt_args.pop("beta_2", 0.999))
        eps = float(opt_args.pop("epsilon", 1e-8))
        wd = None
        if opt_type_lower == "adamw":
            wd = float(opt_args.pop("weight_decay", 1e-4))
        _reject_extra(opt_type, opt_args)
        return adam(lr, b1=b1, b2=b2, eps=eps, weight_decay=wd)
    if opt_type_lower in (name.lower() for name in NOT_PORTED):
        raise NotImplementedError(
            "optimizer %r is not ported yet (ported: %s; the rest are "
            "queued in ROADMAP.md)" % (opt_type, SUPPORTED)
        )
    raise ValueError(
        "Unsupported optimizer %r (supported: %s)" % (opt_type, SUPPORTED)
    )


def parse_opt_args(opt_args_str: str) -> dict:
    """Parse 'k=v;k=v' optimizer arg strings (the reference's Go-PS flag
    format, go/pkg/ps/optimizer.go parseOptArgs)."""
    args = {}
    for part in (opt_args_str or "").split(";"):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError("Bad opt_args segment %r" % part)
        key, value = part.split("=", 1)
        args[key.strip()] = value.strip()
    return args


def _parse_bool(value):
    if isinstance(value, bool):
        return value
    return str(value).lower() in ("1", "true", "yes")


def _reject_extra(opt_type, extra):
    if extra:
        raise ValueError(
            "Unknown args for optimizer %s: %s" % (opt_type, sorted(extra))
        )

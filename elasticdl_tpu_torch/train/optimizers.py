"""Optimizer factory (port of elasticdl_tpu/train/optimizers.py: SGD,
Momentum, Adam, AdamW, Adagrad, RMSprop, Adamax, Nadam, Adadelta and
Ftrl, the host-schedulable learning rate).

Each optimizer is optax's update rule with optax's defaults, written
out over a ``{name: tensor}`` parameter dict: ``init(params)`` returns
the optimizer state (a flat dict whose values are either
``{param name: tensor}`` slot dicts or scalar tensors, so
``TrainState.opt_state`` holds all of it and the dense checkpoints
save it), and ``update(grads, state, params)`` returns ``(updates,
state)`` with ``params + updates`` the next parameters, as
``optax.GradientTransformation`` does. ``torch.optim`` is not used: its
RMSprop, Adagrad and Adamax put ``eps`` elsewhere than optax does, and
its NAdam has a momentum-decay schedule that optax's ``nadam`` lacks.

``learning_rate`` is a number, a schedule (a callable of the update
count, which it gets as an int32 tensor on the params' device, as
optax's ``scale_by_schedule`` hands its schedule a count; the count
lives in the state's ``schedule_count``), or a 0-d tensor read at every
update (``create_host_schedulable_optimizer`` keeps it in the state
under ``learning_rate``, where ``set_learning_rate`` rewrites it
between steps, the counterpart of optax's ``inject_hyperparams``).

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

SUPPORTED = (
    "SGD", "Momentum", "Adam", "Adagrad", "AdamW", "RMSprop",
    "Adamax", "Nadam", "Adadelta", "Ftrl",
)


class GradientTransformation(NamedTuple):
    init: Callable
    update: Callable


def _device(params):
    return next(iter(params.values())).device if params else None


def _slots(params, fill=0.0):
    import torch

    return {n: torch.full_like(p, fill) for n, p in params.items()}


def _count(params):
    import torch

    return torch.zeros((), dtype=torch.int32, device=_device(params))


def _with_lr(learning_rate, init, update):
    """``init``/``update`` of the unscaled direction (optax's
    ``scale_by_*``), then ``-lr`` (``scale_by_learning_rate``): a
    schedule gets the state's ``schedule_count`` before its increment."""
    schedule = callable(learning_rate)

    def full_init(params):
        state = init(params)
        if schedule:
            state["schedule_count"] = _count(params)
        return state

    def full_update(grads, state, params=None):
        directions, state = update(grads, state, params)
        if schedule:
            lr = learning_rate(state["schedule_count"].clone())
            state["schedule_count"].add_(1)
        else:
            lr = learning_rate
        return _scaled(directions, lr), state

    return GradientTransformation(full_init, full_update)


def _scaled(updates, learning_rate):
    """optax.scale_by_learning_rate: ``-lr * u``."""
    step_size = -learning_rate
    return {name: step_size * u for name, u in updates.items()}


def _bias_correction(decay, count):
    """``1 - decay ** count`` in fp32 (optax's tree_bias_correction)."""
    import torch

    base = torch.full((), decay, dtype=torch.float32, device=count.device)
    return 1 - torch.pow(base, count)


def sgd(learning_rate, momentum=None, nesterov=False):
    """optax.sgd: an optional trace (``t = g + momentum * t``; nesterov
    steps along ``g + momentum * t``), then ``-lr``."""

    def init(params):
        if momentum is None:
            return {}
        return {"trace": _slots(params)}

    def update(grads, state, params=None):
        del params
        if momentum is None:
            return dict(grads), state
        directions = {}
        for name, g in grads.items():
            trace = state["trace"][name]
            trace.mul_(momentum).add_(g)
            directions[name] = g + momentum * trace if nesterov else trace
        return directions, state

    return _with_lr(learning_rate, init, update)


def adam(learning_rate, b1=0.9, b2=0.999, eps=1e-8, weight_decay=None,
         nesterov=False):
    """optax.adam (optax.nadam with ``nesterov``), and optax.adamw when
    ``weight_decay`` is given: ``mu = (1 - b1) g + b1 mu``, ``nu = (1 -
    b2) g^2 + b2 nu``, bias corrections ``1 - b ** count`` in fp32, ``u =
    mu_hat / (sqrt(nu_hat) + eps)``; nesterov's ``mu_hat = b1 mu / (1 -
    b1 ** (count + 1)) + (1 - b1) g / (1 - b1 ** count)``. AdamW adds
    ``weight_decay * p`` to every parameter (optax adamw with no mask),
    then ``-lr``."""
    import torch

    def init(params):
        return {"count": _count(params), "mu": _slots(params),
                "nu": _slots(params)}

    def update(grads, state, params=None):
        if weight_decay is not None and params is None:
            raise ValueError("adamw needs params for its weight decay")
        count = state["count"]
        count.add_(1)
        correction1 = _bias_correction(b1, count)
        correction2 = _bias_correction(b2, count)
        if nesterov:
            correction1_next = _bias_correction(b1, count + 1)
        directions = {}
        for name, g in grads.items():
            mu = state["mu"][name].mul_(b1).add_((1 - b1) * g)
            nu = state["nu"][name].mul_(b2).add_((1 - b2) * torch.square(g))
            if nesterov:
                mu_hat = (b1 * (mu / correction1_next)
                          + (1 - b1) * (g / correction1))
            else:
                mu_hat = mu / correction1
            u = mu_hat / (torch.sqrt(nu / correction2) + eps)
            if weight_decay is not None:
                u = u + weight_decay * params[name]
            directions[name] = u
        return directions, state

    return _with_lr(learning_rate, init, update)


def adagrad(learning_rate, initial_accumulator_value=0.1, eps=1e-7):
    """optax.adagrad (scale_by_rss): ``s = g^2 + s``, ``u = g *
    rsqrt(s + eps)`` where ``s > 0``, else 0."""
    import torch

    def init(params):
        return {"sum_of_squares": _slots(params, initial_accumulator_value)}

    def update(grads, state, params=None):
        del params
        directions = {}
        for name, g in grads.items():
            s = state["sum_of_squares"][name].add_(torch.square(g))
            scale = torch.where(s > 0, torch.rsqrt(s + eps),
                                torch.zeros_like(s))
            directions[name] = scale * g
        return directions, state

    return _with_lr(learning_rate, init, update)


def rmsprop(learning_rate, decay=0.9, eps=1e-8, momentum=None):
    """optax.rmsprop (uncentered, scale_by_rms): ``nu = (1 - decay) g^2
    + decay nu``, ``u = g * rsqrt(nu + eps)``, ``-lr``, then optax's
    trace over the scaled updates when ``momentum`` is set (a zero
    momentum's trace leaves them as they are and keeps no slot)."""
    import torch

    def init(params):
        return {"nu": _slots(params)}

    def update(grads, state, params=None):
        del params
        directions = {}
        for name, g in grads.items():
            nu = state["nu"][name].mul_(decay).add_(
                (1 - decay) * torch.square(g))
            directions[name] = torch.rsqrt(nu + eps) * g
        return directions, state

    scaled = _with_lr(learning_rate, init, update)
    if not momentum:
        return scaled

    def traced_init(params):
        state = scaled.init(params)
        state["trace"] = _slots(params)
        return state

    def traced_update(grads, state, params=None):
        updates, state = scaled.update(grads, state, params)
        return {name: state["trace"][name].mul_(momentum).add_(u)
                for name, u in updates.items()}, state

    return GradientTransformation(traced_init, traced_update)


def adamax(learning_rate, b1=0.9, b2=0.999, eps=1e-8):
    """optax.adamax: ``mu = (1 - b1) g + b1 mu``, ``nu = max(|g| + eps,
    b2 nu)``, ``u = (mu / (1 - b1 ** count)) / nu``."""
    import torch

    def init(params):
        return {"count": _count(params), "mu": _slots(params),
                "nu": _slots(params)}

    def update(grads, state, params=None):
        del params
        count = state["count"]
        count.add_(1)
        correction1 = _bias_correction(b1, count)
        directions = {}
        for name, g in grads.items():
            mu = state["mu"][name].mul_(b1).add_((1 - b1) * g)
            nu = state["nu"][name]
            torch.maximum(torch.abs(g) + eps, b2 * nu, out=nu)
            directions[name] = (mu / correction1) / nu
        return directions, state

    return _with_lr(learning_rate, init, update)


def adadelta(learning_rate, rho=0.95, eps=1e-7):
    """optax.adadelta (its zero weight decay is a no-op): ``e_g = (1 -
    rho) g^2 + rho e_g``, ``u = sqrt(e_x + eps) / sqrt(e_g + eps) * g``,
    ``e_x = (1 - rho) u^2 + rho e_x``."""
    import torch

    def init(params):
        return {"e_g": _slots(params), "e_x": _slots(params)}

    def update(grads, state, params=None):
        del params
        directions = {}
        for name, g in grads.items():
            e_g = state["e_g"][name].mul_(rho).add_(
                (1 - rho) * torch.square(g))
            e_x = state["e_x"][name]
            u = torch.sqrt(e_x + eps) / torch.sqrt(e_g + eps) * g
            e_x.mul_(rho).add_((1 - rho) * torch.square(u))
            directions[name] = u
        return directions, state

    return _with_lr(learning_rate, init, update)


def ftrl(learning_rate, learning_rate_power=-0.5,
         initial_accumulator_value=0.1, l1_regularization_strength=0.0,
         l2_regularization_strength=0.0):
    """FTRL-proximal (McMahan et al. 2013), the reference's own
    transformation (tf.keras.optimizers.Ftrl's rule): it returns
    ``delta = w_new - w_old``, the weight rebuilt from the proximal
    closed form, so it composes with ``params + updates`` like every
    other optimizer. Slots ``accum`` (n) and ``linear`` (z); a schedule
    gets ``count`` before its increment."""
    import torch

    lr_power = learning_rate_power
    l1 = l1_regularization_strength
    l2 = l2_regularization_strength

    def init(params):
        return {"accum": _slots(params, initial_accumulator_value),
                "linear": _slots(params), "count": _count(params)}

    def update(grads, state, params=None):
        if params is None:
            raise ValueError("ftrl requires params")
        count = state["count"]
        lr = (learning_rate(count.clone()) if callable(learning_rate)
              else learning_rate)
        updates = {}
        for name, g in grads.items():
            w = params[name]
            g = g.to(w.dtype)
            n = state["accum"][name]
            z = state["linear"][name]
            new_n = n + g * g
            sigma = (new_n ** -lr_power - n ** -lr_power) / lr
            z.add_(g - sigma * w)
            n.copy_(new_n)
            quadratic = new_n ** -lr_power / lr + 2.0 * l2
            new_w = torch.where(torch.abs(z) > l1,
                                (torch.sign(z) * l1 - z) / quadratic,
                                torch.zeros_like(w))
            updates[name] = new_w - w
        count.add_(1)
        return updates, state

    return GradientTransformation(init, update)


def create_optimizer(opt_type: str, **opt_args) -> GradientTransformation:
    opt_type_lower = opt_type.lower()
    # a number, a schedule (callable of the update count) or a 0-d
    # tensor (the host-schedulable state's)
    lr = opt_args.pop("learning_rate", 0.01)
    if isinstance(lr, (str, int)):
        lr = float(lr)
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
    if opt_type_lower in ("adam", "adamw", "nadam"):
        b1 = float(opt_args.pop("beta_1", 0.9))
        b2 = float(opt_args.pop("beta_2", 0.999))
        eps = float(opt_args.pop("epsilon", 1e-8))
        wd = None
        if opt_type_lower == "adamw":
            wd = float(opt_args.pop("weight_decay", 1e-4))
        _reject_extra(opt_type, opt_args)
        return adam(lr, b1=b1, b2=b2, eps=eps, weight_decay=wd,
                    nesterov=opt_type_lower == "nadam")
    if opt_type_lower == "adagrad":
        eps = float(opt_args.pop("epsilon", 1e-7))
        init_acc = float(opt_args.pop("initial_accumulator_value", 0.1))
        _reject_extra(opt_type, opt_args)
        return adagrad(lr, initial_accumulator_value=init_acc, eps=eps)
    if opt_type_lower == "rmsprop":
        decay = float(opt_args.pop("rho", 0.9))
        eps = float(opt_args.pop("epsilon", 1e-7))
        momentum = float(opt_args.pop("momentum", 0.0))
        _reject_extra(opt_type, opt_args)
        return rmsprop(lr, decay=decay, eps=eps, momentum=momentum)
    if opt_type_lower == "adamax":
        b1 = float(opt_args.pop("beta_1", 0.9))
        b2 = float(opt_args.pop("beta_2", 0.999))
        eps = float(opt_args.pop("epsilon", 1e-8))
        _reject_extra(opt_type, opt_args)
        return adamax(lr, b1=b1, b2=b2, eps=eps)
    if opt_type_lower == "adadelta":
        rho = float(opt_args.pop("rho", 0.95))
        eps = float(opt_args.pop("epsilon", 1e-7))
        _reject_extra(opt_type, opt_args)
        return adadelta(lr, rho=rho, eps=eps)
    if opt_type_lower == "ftrl":
        kwargs = {
            name: float(opt_args.pop(name, default)) for name, default in (
                ("learning_rate_power", -0.5),
                ("initial_accumulator_value", 0.1),
                ("l1_regularization_strength", 0.0),
                ("l2_regularization_strength", 0.0),
            )
        }
        _reject_extra(opt_type, opt_args)
        return ftrl(lr, **kwargs)
    raise ValueError(
        "Unsupported optimizer %r (supported: %s)" % (opt_type, SUPPORTED)
    )


LEARNING_RATE = "learning_rate"


def create_host_schedulable_optimizer(opt_type: str, **opt_args
                                      ) -> GradientTransformation:
    """Like ``create_optimizer``, but the learning rate is a 0-d fp32
    tensor in the state (``state["learning_rate"]``), read at every
    update, so ``set_learning_rate`` (the LearningRateScheduler
    callback) can rewrite it between steps: the counterpart of the
    reference's ``optax.inject_hyperparams``."""
    import torch

    lr = float(opt_args.pop(LEARNING_RATE, 0.01))

    def build(learning_rate):
        return create_optimizer(opt_type, learning_rate=learning_rate,
                                **dict(opt_args))

    build(lr)  # reject bad args now, not at the first update

    def init(params):
        state = build(lr).init(params)
        state[LEARNING_RATE] = torch.full((), lr, dtype=torch.float32,
                                          device=_device(params))
        return state

    def update(grads, state, params=None):
        inner = {k: v for k, v in state.items() if k != LEARNING_RATE}
        updates, inner = build(state[LEARNING_RATE]).update(
            grads, inner, params)
        inner[LEARNING_RATE] = state[LEARNING_RATE]
        return updates, inner

    return GradientTransformation(init, update)


def set_learning_rate(opt_state, learning_rate):
    """Rewrite the learning rate of a state built by
    ``create_host_schedulable_optimizer`` (in place); returns the state,
    or None when it holds no learning rate."""
    if not isinstance(opt_state, dict) or LEARNING_RATE not in opt_state:
        return None
    opt_state[LEARNING_RATE].fill_(float(learning_rate))
    return opt_state


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

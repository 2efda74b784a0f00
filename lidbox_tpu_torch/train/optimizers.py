"""
Config-driven optimizers and learning-rate schedules (counterpart of
``lidbox_tpu.train.optimizers``), mirroring the reference's tf.keras
optimizer/schedule factories (reference: lidbox/models/keras_utils.py:135-140).

Config shape:
    {"cls": "Adam", "kwargs": {"learning_rate": 1e-3,
                               "lr_scheduler": {"cls": "ExponentialDecay",
                                                "kwargs": {...}}}}

The updates are written by hand, as functions on lists of tensors, to the
numerics of the optax transformations the JAX package builds (optax
0.2.6). ``torch.optim`` is not used: it differs from optax in each case
(RMSprop's eps sits outside the square root, Adagrad starts its
accumulator at 0 and uses eps 1e-10, AdamW scales the decay differently,
``clip_grad_norm_`` adds 1e-6 to the norm).

An optimizer is a :class:`GradientTransformation` as in optax:
``init(params) -> state`` and ``update(grads, state, params) -> (updates,
state)``, then ``apply_updates(params, updates)``. ``params``, ``grads``
and ``updates`` are dicts name -> tensor in one order. A state holds lists
of tensors in that order and Python ints for step counts, under optax's
field names (``count``, ``mu``, ``nu``, ``trace``, ``sum_of_squares``); a
chain's state is the tuple of its parts' states, so
:func:`opt_state_from_optax` carries a JAX optimizer state across.
Schedules are evaluated on the host at the step count before the update.
Nothing is updated in place.
"""
import math
from typing import Callable, NamedTuple

import numpy as np
import torch


class GradientTransformation(NamedTuple):
    init: Callable
    update: Callable


def _lists(tree):
    return list(tree.values())


def _like(tree, values):
    return dict(zip(tree, values))


def identity():
    return GradientTransformation(lambda params: {},
                                  lambda updates, state, params=None:
                                  (updates, state))


def chain(*transforms):
    """Apply ``transforms`` in order; the state is the tuple of theirs."""
    def init(params):
        return tuple(t.init(params) for t in transforms)

    def update(updates, state, params=None):
        new_state = []
        for t, s in zip(transforms, state):
            updates, s = t.update(updates, s, params)
            new_state.append(s)
        return updates, tuple(new_state)
    return GradientTransformation(init, update)


def _ema(g, moments, decay):
    """(1 - decay) * g + decay * moments, element by element (optax's
    tree_update_moment)."""
    return torch._foreach_add(torch._foreach_mul(g, 1.0 - decay),
                              torch._foreach_mul(moments, decay))


def _bias_correction(decay, count):
    """1 - decay**count, in float32 as optax computes it."""
    return float(np.float32(1.0) - np.float32(decay) ** np.float32(count))


def scale_by_adam(b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0):
    def init(params):
        return {"count": 0,
                "mu": [torch.zeros_like(p) for p in params.values()],
                "nu": [torch.zeros_like(p) for p in params.values()]}

    def update(updates, state, params=None):
        g = _lists(updates)
        mu = _ema(g, state["mu"], b1)
        nu = _ema(torch._foreach_mul(g, g), state["nu"], b2)
        count = state["count"] + 1
        mu_hat = torch._foreach_div(mu, _bias_correction(b1, count))
        nu_hat = torch._foreach_div(nu, _bias_correction(b2, count))
        denom = torch._foreach_add(
            torch._foreach_sqrt(torch._foreach_add(nu_hat, eps_root)), eps)
        return (_like(updates, torch._foreach_div(mu_hat, denom)),
                {"count": count, "mu": mu, "nu": nu})
    return GradientTransformation(init, update)


def scale_by_rms(decay=0.9, eps=1e-8, initial_scale=0.0):
    """RMSprop's scaling: g * rsqrt(nu + eps), eps inside the root."""
    def init(params):
        return {"nu": [torch.full_like(p, initial_scale)
                       for p in params.values()]}

    def update(updates, state, params=None):
        g = _lists(updates)
        nu = _ema(torch._foreach_mul(g, g), state["nu"], decay)
        scaling = torch._foreach_rsqrt(torch._foreach_add(nu, eps))
        return _like(updates, torch._foreach_mul(scaling, g)), {"nu": nu}
    return GradientTransformation(init, update)


def scale_by_rss(initial_accumulator_value=0.1, eps=1e-7):
    """Adagrad's scaling: g * rsqrt(sum of squares + eps), 0 where the sum
    is 0."""
    def init(params):
        return {"sum_of_squares": [torch.full_like(p, initial_accumulator_value)
                                   for p in params.values()]}

    def update(updates, state, params=None):
        g = _lists(updates)
        sos = torch._foreach_add(torch._foreach_mul(g, g),
                                 state["sum_of_squares"])
        out = [torch.where(s > 0, torch.rsqrt(s + eps), torch.zeros_like(s)) * x
               for s, x in zip(sos, g)]
        return _like(updates, out), {"sum_of_squares": sos}
    return GradientTransformation(init, update)


def trace(decay, nesterov=False):
    """Momentum: trace = g + decay * trace (optax.trace)."""
    def init(params):
        return {"trace": [torch.zeros_like(p) for p in params.values()]}

    def update(updates, state, params=None):
        g = _lists(updates)
        new_trace = torch._foreach_add(g, torch._foreach_mul(state["trace"],
                                                             decay))
        out = (torch._foreach_add(g, torch._foreach_mul(new_trace, decay))
               if nesterov else new_trace)
        return _like(updates, out), {"trace": new_trace}
    return GradientTransformation(init, update)


def add_decayed_weights(weight_decay=0.0):
    """g + weight_decay * p (AdamW's decoupled decay, before the learning
    rate scales it)."""
    def update(updates, state, params=None):
        if params is None:
            raise ValueError("add_decayed_weights needs the params")
        out = torch._foreach_add(_lists(updates),
                                 torch._foreach_mul(_lists(params),
                                                    weight_decay))
        return _like(updates, out), state
    return GradientTransformation(lambda params: {}, update)


def scale_by_learning_rate(learning_rate):
    """Multiply by -learning_rate; a schedule is called with its own step
    count, which starts at 0, so it sees the count before the update."""
    if callable(learning_rate):
        def update(updates, state, params=None):
            step_size = -float(learning_rate(state["count"]))
            return (_like(updates, torch._foreach_mul(_lists(updates),
                                                      step_size)),
                    {"count": state["count"] + 1})
        return GradientTransformation(lambda params: {"count": 0}, update)

    def update(updates, state, params=None):
        return (_like(updates, torch._foreach_mul(_lists(updates),
                                                  -learning_rate)), state)
    return GradientTransformation(lambda params: {}, update)


def clip_by_global_norm(max_norm):
    """t / g_norm * max_norm for every t when the global norm reaches
    max_norm, t unchanged below it; decided on the device, without a
    readback."""
    def update(updates, state, params=None):
        g = _lists(updates)
        g_norm = torch.sqrt(sum(torch.sum(t * t) for t in g))
        keep = g_norm < max_norm
        out = [torch.where(keep, t, t / g_norm * max_norm) for t in g]
        return _like(updates, out), state
    return GradientTransformation(lambda params: {}, update)


def clip(max_delta):
    """Clamp every element to [-max_delta, max_delta]."""
    def update(updates, state, params=None):
        out = [torch.clamp(t, -max_delta, max_delta) for t in _lists(updates)]
        return _like(updates, out), state
    return GradientTransformation(lambda params: {}, update)


def apply_updates(params, updates):
    """params + updates, as new tensors."""
    return _like(params, torch._foreach_add(_lists(params), _lists(updates)))


def adam(learning_rate, b1=0.9, b2=0.999, eps=1e-8):
    return chain(scale_by_adam(b1, b2, eps),
                 scale_by_learning_rate(learning_rate))


def adamw(learning_rate, b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-4):
    return chain(scale_by_adam(b1, b2, eps),
                 add_decayed_weights(weight_decay),
                 scale_by_learning_rate(learning_rate))


def sgd(learning_rate, momentum=None, nesterov=False):
    return chain(trace(momentum, nesterov) if momentum is not None
                 else identity(),
                 scale_by_learning_rate(learning_rate))


def rmsprop(learning_rate, decay=0.9, eps=1e-8, momentum=None):
    return chain(scale_by_rms(decay, eps),
                 scale_by_learning_rate(learning_rate),
                 trace(momentum) if momentum is not None else identity())


def adagrad(learning_rate, initial_accumulator_value=0.1, eps=1e-7):
    return chain(scale_by_rss(initial_accumulator_value, eps),
                 scale_by_learning_rate(learning_rate))


def exponential_decay(init_value, transition_steps, decay_rate,
                      staircase=False):
    if transition_steps <= 0 or decay_rate == 0:
        return lambda count: init_value

    def schedule(count):
        p = count / transition_steps
        if staircase:
            p = math.floor(p)
        return init_value if count <= 0 else init_value * decay_rate ** p
    return schedule


def piecewise_constant_schedule(init_value, boundaries_and_scales):
    if not all(scale >= 0.0 for scale in boundaries_and_scales.values()):
        raise ValueError(
            "`piecewise_constant_schedule` expects non-negative scale factors")

    def schedule(count):
        v = init_value
        for threshold, scale in sorted(boundaries_and_scales.items()):
            if count >= threshold:
                v = scale * v
        return v
    return schedule


def cosine_decay_schedule(init_value, decay_steps, alpha=0.0):
    if not decay_steps > 0:
        raise ValueError("The cosine_decay_schedule requires positive "
                         f"decay_steps, got decay_steps={decay_steps}.")

    def schedule(count):
        count = min(count, decay_steps)
        cosine_decay = 0.5 * (1 + math.cos(math.pi * count / decay_steps))
        return init_value * ((1 - alpha) * cosine_decay + alpha)
    return schedule


def polynomial_schedule(init_value, end_value, power, transition_steps):
    if transition_steps <= 0:
        return lambda count: init_value

    def schedule(count):
        count = min(max(count, 0), transition_steps)
        frac = 1 - count / transition_steps
        return (init_value - end_value) * frac ** power + end_value
    return schedule


SCHEDULES = {
    # tf.keras.optimizers.schedules names
    "ExponentialDecay": lambda initial_learning_rate, decay_steps, decay_rate,
                               staircase=False, **kw: exponential_decay(
        initial_learning_rate, decay_steps, decay_rate, staircase=staircase),
    "PiecewiseConstantDecay": lambda boundaries, values, **kw:
        piecewise_constant_schedule(
            values[0], {int(b): values[i + 1] / values[i]
                        for i, b in enumerate(boundaries)}),
    "CosineDecay": lambda initial_learning_rate, decay_steps, alpha=0.0, **kw:
        cosine_decay_schedule(initial_learning_rate, decay_steps, alpha=alpha),
    "PolynomialDecay": lambda initial_learning_rate, decay_steps,
                              end_learning_rate=1e-4, power=1.0, **kw:
        polynomial_schedule(initial_learning_rate, end_learning_rate, power,
                            decay_steps),
    "InverseTimeDecay": lambda initial_learning_rate, decay_steps, decay_rate,
                               staircase=False, **kw:
        (lambda step: initial_learning_rate /
            (1.0 + decay_rate * ((step // decay_steps) if staircase
                                 else step / decay_steps))),
}

OPTIMIZERS = {
    "Adam": lambda learning_rate=1e-3, beta_1=0.9, beta_2=0.999, epsilon=1e-7, **kw:
        adam(learning_rate, b1=beta_1, b2=beta_2, eps=epsilon),
    "AdamW": lambda learning_rate=1e-3, weight_decay=1e-4, beta_1=0.9,
                    beta_2=0.999, epsilon=1e-7, **kw:
        adamw(learning_rate, b1=beta_1, b2=beta_2, eps=epsilon,
              weight_decay=weight_decay),
    "SGD": lambda learning_rate=0.01, momentum=0.0, nesterov=False, **kw:
        sgd(learning_rate, momentum=momentum or None, nesterov=nesterov),
    "RMSprop": lambda learning_rate=1e-3, rho=0.9, momentum=0.0, epsilon=1e-7, **kw:
        rmsprop(learning_rate, decay=rho, momentum=momentum, eps=epsilon),
    "Adagrad": lambda learning_rate=1e-3, **kw: adagrad(learning_rate),
}


def schedule_from_config(config):
    """{"cls": ..., "kwargs": {...}} -> schedule (callable step -> lr)."""
    cls = config["cls"]
    if cls not in SCHEDULES:
        raise KeyError(f"unknown LR schedule {cls!r}; valid: {sorted(SCHEDULES)}")
    return SCHEDULES[cls](**config.get("kwargs", {}))


def optimizer_from_config(config):
    """Build (optimizer, lr schedule or float) from an optimizer config
    dict; ``lr_scheduler`` inside kwargs is resolved first
    (reference: keras_utils.py:136-140).

    Keras-style ``clipnorm`` / ``clipvalue`` kwargs become gradient
    transforms chained before the optimizer."""
    cls = config["cls"]
    if cls not in OPTIMIZERS:
        raise KeyError(f"unknown optimizer {cls!r}; valid: {sorted(OPTIMIZERS)}")
    kwargs = dict(config.get("kwargs", {}))
    lr = kwargs.get("learning_rate", 1e-3)
    if "lr_scheduler" in kwargs:
        lr = schedule_from_config(kwargs.pop("lr_scheduler"))
        kwargs["learning_rate"] = lr
    clipnorm = kwargs.pop("clipnorm", None)
    clipvalue = kwargs.pop("clipvalue", None)
    opt = OPTIMIZERS[cls](**kwargs)
    transforms = []
    if clipnorm is not None:
        transforms.append(clip_by_global_norm(clipnorm))
    if clipvalue is not None:
        transforms.append(clip(clipvalue))
    if transforms:
        opt = chain(*transforms, opt)
    return opt, lr


def opt_state_from_optax(opt_state, params):
    """A JAX optimizer state (the optax state of ``optimizer_from_config``'s
    optimizer, leaves as numpy arrays) -> this module's state for the same
    config, on the devices of ``params`` (this port's name -> tensor dict).

    Chains become tuples, each optax state its fields as a dict; moment
    trees are converted like the parameters (``params_from_flax``) and
    listed in ``params``' order, and step counts become ints."""
    from lidbox_tpu_torch.models.model_api import params_from_flax

    def field(value):
        if isinstance(value, dict) or hasattr(value, "items"):
            state = params_from_flax(value)
            if set(state) != set(params):
                raise ValueError("optimizer moments do not match the params: "
                                 f"{sorted(set(state) ^ set(params))}")
            return [state[k].to(device=p.device, dtype=p.dtype)
                    for k, p in params.items()]
        return int(np.asarray(value))

    def convert(node):
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return {f: field(getattr(node, f)) for f in node._fields}
        if isinstance(node, (tuple, list)):
            return tuple(convert(n) for n in node)
        raise TypeError(f"unsupported optimizer state node {type(node)}")
    return convert(opt_state)

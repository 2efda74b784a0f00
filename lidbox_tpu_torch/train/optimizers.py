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
No update writes in place (:func:`copy_state_` is the one function here
that does).

The values an update derives from its step counts (Adam's two bias
corrections, a schedule's step size) are the transform's ``scalars(state)``,
Python floats computed on the host. ``update(..., scalars=)`` takes them as
0-dim float32 tensors instead, so that a step captured once as a CUDA graph
(``train/graphs.py``) reads them from device buffers filled before each
replay; the buffers hold the very floats ``scalars`` returns, so both forms
compute the same bits. The counts stay host ints: :func:`advance_counts`
is what one update does to them, and :func:`copy_state_` writes an update's
moments into the tensors of the state it started from.
"""
import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from lidbox_tpu_torch import parallel


def _no_scalars(state):
    return ()


class GradientTransformation(NamedTuple):
    """``init(params) -> state``; ``update(updates, state, params=None,
    scalars=None) -> (updates, state)``; ``scalars(state)`` -> the floats
    this update derives from the state's step counts, in the order
    ``update`` takes them as tensors through ``scalars=`` (None: computed
    from the state on the host)."""
    init: Callable
    update: Callable
    scalars: Callable = _no_scalars


def _lists(tree):
    return list(tree.values())


def _like(tree, values):
    return dict(zip(tree, values))


def identity():
    return GradientTransformation(lambda params: {},
                                  lambda updates, state, params=None,
                                  scalars=None: (updates, state))


def chain(*transforms):
    """Apply ``transforms`` in order; the state is the tuple of theirs and
    the scalars the concatenation of theirs."""
    def init(params):
        return tuple(t.init(params) for t in transforms)

    def update(updates, state, params=None, scalars=None):
        new_state = []
        for t, s in zip(transforms, state):
            mine = None
            if scalars is not None:
                n = len(t.scalars(s))
                mine, scalars = scalars[:n], scalars[n:]
            updates, s = t.update(updates, s, params, scalars=mine)
            new_state.append(s)
        return updates, tuple(new_state)

    def step_scalars(state):
        return tuple(v for t, s in zip(transforms, state)
                     for v in t.scalars(s))
    return GradientTransformation(init, update, step_scalars)


def _ema(g, moments, decay):
    """(1 - decay) * g + decay * moments, element by element (optax's
    tree_update_moment)."""
    return torch._foreach_add(torch._foreach_mul(g, 1.0 - decay),
                              torch._foreach_mul(moments, decay))


def _bias_correction(decay, count):
    """1 - decay**count, in float32 as optax computes it."""
    return float(np.float32(1.0) - np.float32(decay) ** np.float32(count))


def _divide(tensors, divisor):
    """``tensors`` / ``divisor``, a Python float or a 0-dim tensor, rounded
    alike. By a float torch divides on the CPU but multiplies by the
    float32 reciprocal on CUDA (as ``torch.div`` by a CPU scalar does); by
    a 0-dim tensor it divides on both, so on CUDA the tensor's reciprocal,
    computed there in float32, is what multiplies."""
    if isinstance(divisor, torch.Tensor) and divisor.device.type == "cuda":
        return torch._foreach_mul(tensors, torch.reciprocal(divisor))
    return torch._foreach_div(tensors, divisor)


def scale_by_adam(b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0):
    """Scalars: the two bias corrections of the step's count."""
    def init(params):
        return {"count": 0,
                "mu": [torch.zeros_like(p) for p in params.values()],
                "nu": [torch.zeros_like(p) for p in params.values()]}

    def step_scalars(state):
        count = state["count"] + 1
        return _bias_correction(b1, count), _bias_correction(b2, count)

    def update(updates, state, params=None, scalars=None):
        c1, c2 = step_scalars(state) if scalars is None else scalars
        g = _lists(updates)
        mu = _ema(g, state["mu"], b1)
        nu = _ema(torch._foreach_mul(g, g), state["nu"], b2)
        mu_hat = _divide(mu, c1)
        nu_hat = _divide(nu, c2)
        denom = torch._foreach_add(
            torch._foreach_sqrt(torch._foreach_add(nu_hat, eps_root)), eps)
        return (_like(updates, torch._foreach_div(mu_hat, denom)),
                {"count": state["count"] + 1, "mu": mu, "nu": nu})
    return GradientTransformation(init, update, step_scalars)


def scale_by_rms(decay=0.9, eps=1e-8, initial_scale=0.0):
    """RMSprop's scaling: g * rsqrt(nu + eps), eps inside the root."""
    def init(params):
        return {"nu": [torch.full_like(p, initial_scale)
                       for p in params.values()]}

    def update(updates, state, params=None, scalars=None):
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

    def update(updates, state, params=None, scalars=None):
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

    def update(updates, state, params=None, scalars=None):
        g = _lists(updates)
        new_trace = torch._foreach_add(g, torch._foreach_mul(state["trace"],
                                                             decay))
        out = (torch._foreach_add(g, torch._foreach_mul(new_trace, decay))
               if nesterov else new_trace)
        return _like(updates, out), {"trace": new_trace}
    return GradientTransformation(init, update)


def add_decayed_weights(weight_decay=0.0, mask=None):
    """g + weight_decay * p (AdamW's decoupled decay, before the learning
    rate scales it; a coupled L2 term when it comes first in a chain).

    ``mask`` follows optax: a dict name -> bool, or a callable params ->
    such a dict; only the names it marks True decay, the others pass
    unchanged, and the state is optax's ``MaskedState``,
    ``{"inner_state": {}}``."""
    def update(updates, state, params=None, scalars=None):
        if params is None:
            raise ValueError("add_decayed_weights needs the params")
        chosen = list(updates)
        if mask is not None:
            marks = mask(params) if callable(mask) else mask
            chosen = [k for k in chosen if marks[k]]
        if not chosen:
            return updates, state
        out = torch._foreach_add([updates[k] for k in chosen],
                                 torch._foreach_mul([params[k] for k in chosen],
                                                    weight_decay))
        return {**updates, **dict(zip(chosen, out))}, state
    return GradientTransformation(
        lambda params: {} if mask is None else {"inner_state": {}}, update)


def scale_by_learning_rate(learning_rate):
    """Multiply by -learning_rate; a schedule is called with its own step
    count, which starts at 0, so it sees the count before the update. A
    schedule's step size is the transform's scalar."""
    if callable(learning_rate):
        def step_scalars(state):
            return (-float(learning_rate(state["count"])),)

        def update(updates, state, params=None, scalars=None):
            step_size, = step_scalars(state) if scalars is None else scalars
            return (_like(updates, torch._foreach_mul(_lists(updates),
                                                      step_size)),
                    {"count": state["count"] + 1})
        return GradientTransformation(lambda params: {"count": 0}, update,
                                      step_scalars)

    def update(updates, state, params=None, scalars=None):
        return (_like(updates, torch._foreach_mul(_lists(updates),
                                                  -learning_rate)), state)
    return GradientTransformation(lambda params: {}, update)


def clip_by_global_norm(max_norm):
    """t / g_norm * max_norm for every t when the global norm reaches
    max_norm, t unchanged below it; decided on the device, without a
    readback. Under tensor parallelism the norm is the whole parameters'
    (``parallel.sum_of_squares``)."""
    def update(updates, state, params=None, scalars=None):
        g = _lists(updates)
        g_norm = torch.sqrt(parallel.sum_of_squares(updates))
        keep = g_norm < max_norm
        out = [torch.where(keep, t, t / g_norm * max_norm) for t in g]
        return _like(updates, out), state
    return GradientTransformation(lambda params: {}, update)


def clip(max_delta):
    """Clamp every element to [-max_delta, max_delta]."""
    def update(updates, state, params=None, scalars=None):
        out = [torch.clamp(t, -max_delta, max_delta) for t in _lists(updates)]
        return _like(updates, out), state
    return GradientTransformation(lambda params: {}, update)


def apply_updates(params, updates):
    """params + updates, as new tensors."""
    return _like(params, torch._foreach_add(_lists(params), _lists(updates)))


def advance_counts(opt_state):
    """The state's step counts one update on: every int of a state here is
    a count that each update adds one to (Adam's ``count``, a schedule's
    ``count``). Tensors and the structure are the same objects."""
    if isinstance(opt_state, dict):
        return {k: advance_counts(v) for k, v in opt_state.items()}
    if isinstance(opt_state, tuple):
        return tuple(advance_counts(v) for v in opt_state)
    if isinstance(opt_state, int):
        return opt_state + 1
    return opt_state


def copy_state_(dst, src):
    """Write every tensor of ``src`` into the tensor at the same place in
    ``dst`` (two optimizer states of one structure; a donating step's new
    moments into the state it started from). Counts are left alone."""
    if isinstance(dst, dict):
        for k in dst:
            copy_state_(dst[k], src[k])
    elif isinstance(dst, tuple):
        for d, s in zip(dst, src):
            copy_state_(d, s)
    elif isinstance(dst, list) and dst:
        pairs = [(d, s) for d, s in zip(dst, src) if d is not s]
        if pairs:
            torch._foreach_copy_([d for d, _ in pairs], [s for _, s in pairs])


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
    listed in ``params``' order, and step counts become ints.

    ``opt_state`` may also be the msgpack form of a JAX checkpoint
    (``flax.serialization.to_state_dict``): a chain is a dict keyed
    ``"0"``, ``"1"``, ... and each state a dict of its fields; or the raw
    tree of an Orbax checkpoint: a chain is a list, each state a dict and
    an empty state (optax ``EmptyState``) None."""
    from lidbox_tpu_torch.models.model_api import params_from_flax

    def field(value):
        if value is None:  # an empty nested state, in Orbax's raw form
            return {}
        if isinstance(value, tuple):  # a nested state (optax MaskedState)
            return convert(value)
        if (isinstance(value, dict) or hasattr(value, "items")) and not value:
            return {}  # an empty nested state, in flax's state-dict form
        if isinstance(value, dict) or hasattr(value, "items"):
            state = params_from_flax(value)
            if set(state) != set(params):
                raise ValueError("optimizer moments do not match the params: "
                                 f"{sorted(set(state) ^ set(params))}")
            return [state[k].to(device=p.device, dtype=p.dtype)
                    for k, p in params.items()]
        return int(np.asarray(value))

    def convert(node):
        if node is None:
            return {}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return {f: field(getattr(node, f)) for f in node._fields}
        if isinstance(node, dict):
            if node and set(node) == {str(i) for i in range(len(node))}:
                return tuple(convert(node[str(i)]) for i in range(len(node)))
            return {f: field(v) for f, v in node.items()}
        if isinstance(node, (tuple, list)):
            return tuple(convert(n) for n in node)
        raise TypeError(f"unsupported optimizer state node {type(node)}")
    return convert(opt_state)


def opt_state_to_optax(opt_state, names):
    """This module's state -> the tree a JAX checkpoint of the same optax
    state holds, as Orbax restores it raw (the inverse of
    :func:`opt_state_from_optax`): a chain is a list, each state a dict of
    its fields, an empty state None, moments the JAX package's parameter
    trees (``params_to_flax`` of ``names``, this port's parameter names in
    the moments' order) and step counts int32 scalars."""
    from lidbox_tpu_torch.models.model_api import params_to_flax

    def convert(node):
        if isinstance(node, dict):
            return {f: convert(v) for f, v in node.items()} if node else None
        if isinstance(node, (list, tuple)) and node and all(
                isinstance(t, torch.Tensor) for t in node):
            if len(node) != len(names):  # moments, in the order of names
                raise ValueError("optimizer moments do not match the params")
            return params_to_flax(dict(zip(names, node)))
        if isinstance(node, (list, tuple)):  # a chain
            return [convert(n) for n in node]
        return np.asarray(node, np.int32)
    return convert(opt_state)

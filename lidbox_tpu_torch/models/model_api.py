"""
Model contract shared by the model zoo, in PyTorch (counterpart of
``lidbox_tpu.models.model_api``).

``create(input_shape, num_outputs)`` returns a :class:`Model`: an
``nn.Module`` on ``device`` bound to its input signature. ``init`` draws the
Flax default initialization (lecun_normal kernels, zero biases) from a
``torch.Generator``; ``load_flax_params`` takes the JAX package's trained
parameters instead (``params_from_flax``).
"""
import math

import numpy as np
import torch
import torch.nn as nn

from lidbox_tpu_torch import RANDOM_SEED, get_device

# Flax's lecun_normal: variance_scaling(1.0, "fan_in", "truncated_normal"),
# a normal truncated at two standard deviations, rescaled so the truncated
# distribution keeps variance 1 / fan_in.
_TRUNCATED_NORMAL_STDDEV = 0.87962566103423978

# kernel rank -> axes of a Flax kernel in torch's weight layout, and back
_KERNEL_TO_TORCH = {2: (1, 0), 3: (2, 1, 0), 4: (3, 2, 0, 1)}
_KERNEL_TO_FLAX = {2: (1, 0), 3: (2, 1, 0), 4: (2, 3, 1, 0)}


def params_from_flax(params):
    """JAX package parameters -> this port's ``state_dict``.

    ``params`` is the Flax ``variables["params"]`` tree (or its
    ``batch_stats``) as nested dicts of numpy arrays (or torch tensors, as
    Orbax's bfloat16 leaves read). Conv kernels go from
    [k, in, out] to [out, in, k] and 2-D ones (depthwise too) from
    [kh, kw, in, out] to [out, in, kh, kw], Dense kernels (the gates of
    the recurrent cells too) are transposed; biases, BatchNorm ``scale`` /
    ``bias`` and running ``mean`` / ``var`` are kept. ``kernel`` becomes
    ``weight`` and the module path is joined with dots."""
    state = {}

    def walk(tree, prefix):
        for name, value in tree.items():
            path = f"{prefix}{name}"
            if isinstance(value, dict) or hasattr(value, "items"):
                walk(value, path + ".")
                continue
            if isinstance(value, torch.Tensor):  # bfloat16 from Orbax
                value = value.float().numpy()
            a = np.asarray(value, np.float32)
            if name == "kernel":
                path = f"{prefix}weight"
                if a.ndim not in _KERNEL_TO_TORCH:
                    raise ValueError(f"{path}: unsupported kernel rank {a.ndim}")
                a = a.transpose(_KERNEL_TO_TORCH[a.ndim])
            # contiguous, as the module's own tensors: strides decide the
            # kernels, and so the rounding, of what runs on them
            state[path] = torch.tensor(a).contiguous()
    walk(params, "")
    return state


def params_to_flax(state):
    """This port's ``state_dict`` -> the JAX package's parameter tree, the
    inverse of ``params_from_flax``: nested dicts of float32 numpy arrays
    with every level's keys sorted, as a JAX pytree holds them."""
    tree = {}
    for path, value in state.items():
        *modules, name = path.split(".")
        a = value.detach().cpu().numpy().astype(np.float32)
        if name == "weight":
            name = "kernel"
            a = a.transpose(_KERNEL_TO_FLAX[a.ndim])
        node = tree
        for m in modules:
            node = node.setdefault(m, {})
        node[name] = np.ascontiguousarray(a)

    def ordered(node):
        if isinstance(node, dict):
            return {k: ordered(node[k]) for k in sorted(node)}
        return node
    return ordered(tree)


def flax_default_init_(module, generator):
    """Flax's default initialization in place: lecun_normal weights of
    every Conv1d, Conv2d and Linear (fan_in = in / groups x the kernel's
    extent, so kh * kw for a depthwise conv), zero biases, BatchNorm scale
    1, bias 0 and running statistics 0 / 1; then each module's own
    ``flax_init_`` (the recurrent cells' orthogonal hidden kernels). Every
    draw is made on the CPU from ``generator``, in module order, so one
    seed gives one set of weights on any device."""
    from lidbox_tpu_torch.models.layers import BatchNorm
    for sub in module.modules():
        if isinstance(sub, (nn.Conv1d, nn.Conv2d, nn.Linear)):
            w = sub.weight
            std = math.sqrt(1.0 / w[0].numel()) / _TRUNCATED_NORMAL_STDDEV
            cpu = torch.empty(w.shape, dtype=torch.float32)
            nn.init.trunc_normal_(cpu, std=std, a=-2.0 * std, b=2.0 * std,
                                  generator=generator)
            with torch.no_grad():
                w.copy_(cpu)
                if sub.bias is not None:
                    sub.bias.zero_()
        elif isinstance(sub, BatchNorm):
            with torch.no_grad():
                sub.scale.fill_(1.0)
                sub.bias.zero_()
                sub.mean.zero_()
                sub.var.fill_(1.0)
    for sub in module.modules():
        if hasattr(sub, "flax_init_"):
            sub.flax_init_(generator)


def functional_forward(module, params, buffers, x, compute_dtype=None,
                       train=False, **kwargs):
    """``module``'s forward on the given parameter and buffer tensors
    (dicts name -> tensor) instead of its own.

    With ``compute_dtype`` every floating tensor and the input are cast to
    it inside the autograd graph, so gradients reach the float32 tensors
    passed in, and the output is cast back to float32 (the JAX package's
    explicit casts, ``Trainer._apply``; not autocast).

    ``train=True`` runs the module in training mode for the call (back in
    eval mode after) and returns ``(outputs, new batch stats)``: the
    buffers with every running statistic a BatchNorm updated replaced by
    its new float32 value (Flax's ``mutable=["batch_stats"]``). The
    tensors passed in are never written."""
    from lidbox_tpu_torch.models.layers import collect_batch_stats
    if compute_dtype is not None:
        def cast(t):
            return t.to(compute_dtype) if t.is_floating_point() else t
        cast_params = {k: cast(v) for k, v in params.items()}
        cast_buffers = {k: cast(v) for k, v in buffers.items()}
        x = x.to(compute_dtype)
    else:
        cast_params, cast_buffers = params, buffers
        if x.is_floating_point() and x.dtype != torch.float32:
            x = x.float()
    if not train:
        out = torch.func.functional_call(
            module, {**cast_params, **cast_buffers}, (x,), kwargs)
        return out.float() if compute_dtype is not None else out
    module.train()
    try:
        with collect_batch_stats(module) as updates:
            out = torch.func.functional_call(
                module, {**cast_params, **cast_buffers}, (x,), kwargs)
    finally:
        module.eval()
    if compute_dtype is not None:
        out = out.float()
    return out, {**buffers, **updates}


class Model:
    """An ``nn.Module`` on ``device`` bound to an input signature
    ``input_shape`` (per-example, e.g. (T, F)) and an output head. A new
    Model holds the default ``init()`` weights."""

    def __init__(self, module, input_shape, name, output="logits",
                 device="cuda"):
        self.device = get_device(device)
        self.module = module.to(self.device).eval()
        self.input_shape = tuple(input_shape)
        self.name = name
        self.output = output
        self.init()

    def init(self, generator=None):
        """Flax default initialization drawn from ``generator`` (a CPU
        ``torch.Generator``; default seeded with RANDOM_SEED)."""
        if generator is None:
            generator = torch.Generator().manual_seed(RANDOM_SEED)
        flax_default_init_(self.module, generator)
        return self

    def load_flax_params(self, params, batch_stats=None):
        """Load the JAX package's parameter tree and, when given, its
        ``batch_stats`` tree (``params_from_flax``); without them the
        running statistics stay as they are."""
        state = {k: b.detach() for k, b in self.module.named_buffers()}
        state.update(params_from_flax(params))
        state.update(params_from_flax(batch_stats or {}))
        self.module.load_state_dict(state)
        return self

    def num_params(self):
        return sum(p.numel() for p in self.module.parameters())

    def apply(self, x, mask=None, output=None, compute_dtype=None,
              train=False, generator=None):
        """Forward of [B, T, F] features (frame ``mask`` [B, T] for padded
        batches) on the model's device. ``compute_dtype`` (e.g.
        torch.bfloat16) runs it on parameters and input cast to that type,
        as the trainer does; the output comes back float32.

        ``train=True`` runs training mode (dropout and noise drawn from
        ``generator``, BatchNorm on the batch's statistics) and returns
        ``(outputs, new batch stats)`` as the JAX package's
        ``apply(..., train=True)`` does; the model's own buffers stay as
        they are."""
        output = output or self.output
        if compute_dtype is None and not train:
            return self.module(x, mask=mask, output=output)
        kwargs = {"mask": mask, "output": output}
        if train:
            kwargs["generator"] = generator
        return functional_forward(
            self.module, dict(self.module.named_parameters()),
            dict(self.module.named_buffers()), x, compute_dtype=compute_dtype,
            train=train, **kwargs)

    __call__ = apply

    def with_output(self, output):
        """The same module and weights with another output head."""
        other = Model.__new__(Model)
        other.__dict__.update(self.__dict__, output=output)
        return other


def as_embedding_extractor(model: Model) -> Model:
    """Same module and weights; the forward returns the pre-activation
    embedding layer output."""
    return model.with_output("embedding")

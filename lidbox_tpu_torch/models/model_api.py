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


def params_from_flax(params):
    """JAX package parameters -> this port's ``state_dict``.

    ``params`` is the Flax ``variables["params"]`` tree as nested dicts of
    numpy arrays. Conv kernels go from [k, in, out] to [out, in, k], Dense
    kernels are transposed, biases are kept; ``kernel`` becomes ``weight``
    and the module path is joined with dots."""
    state = {}

    def walk(tree, prefix):
        for name, value in tree.items():
            path = f"{prefix}{name}"
            if isinstance(value, dict) or hasattr(value, "items"):
                walk(value, path + ".")
                continue
            a = np.asarray(value, np.float32)
            if name == "kernel":
                path = f"{prefix}weight"
                if a.ndim == 3:
                    a = a.transpose(2, 1, 0)
                elif a.ndim == 2:
                    a = a.T
                else:
                    raise ValueError(f"{path}: unsupported kernel rank {a.ndim}")
            state[path] = torch.tensor(a)
    walk(params, "")
    return state


def flax_default_init_(module, generator):
    """Flax's default initialization in place: lecun_normal weights of
    every Conv1d and Linear, zero biases."""
    for sub in module.modules():
        if isinstance(sub, (nn.Conv1d, nn.Linear)):
            w = sub.weight
            fan_in = w.shape[1] * (w.shape[2] if w.dim() == 3 else 1)
            std = math.sqrt(1.0 / fan_in) / _TRUNCATED_NORMAL_STDDEV
            # drawn on the CPU so one seed gives one set of weights on any
            # device
            cpu = torch.empty(w.shape, dtype=torch.float32)
            nn.init.trunc_normal_(cpu, std=std, a=-2.0 * std, b=2.0 * std,
                                  generator=generator)
            with torch.no_grad():
                w.copy_(cpu)
                if sub.bias is not None:
                    sub.bias.zero_()


def functional_forward(module, params, buffers, x, compute_dtype=None,
                       **kwargs):
    """``module``'s forward on the given parameter and buffer tensors
    (dicts name -> tensor) instead of its own.

    With ``compute_dtype`` every floating tensor and the input are cast to
    it inside the autograd graph, so gradients reach the float32 tensors
    passed in, and the output is cast back to float32 (the JAX package's
    explicit casts, ``Trainer._apply``; not autocast)."""
    if compute_dtype is not None:
        def cast(t):
            return t.to(compute_dtype) if t.is_floating_point() else t
        params = {k: cast(v) for k, v in params.items()}
        buffers = {k: cast(v) for k, v in buffers.items()}
        x = x.to(compute_dtype)
    elif x.is_floating_point() and x.dtype != torch.float32:
        x = x.float()
    out = torch.func.functional_call(module, {**params, **buffers}, (x,),
                                     kwargs)
    return out.float() if compute_dtype is not None else out


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

    def load_flax_params(self, params):
        """Load the JAX package's parameter tree (``params_from_flax``)."""
        self.module.load_state_dict(params_from_flax(params))
        return self

    def num_params(self):
        return sum(p.numel() for p in self.module.parameters())

    def apply(self, x, mask=None, output=None, compute_dtype=None):
        """Forward of [B, T, F] features (frame ``mask`` [B, T] for padded
        batches) on the model's device. ``compute_dtype`` (e.g.
        torch.bfloat16) runs it on parameters and input cast to that type,
        as the trainer does; the output comes back float32."""
        if compute_dtype is None:
            return self.module(x, mask=mask, output=output or self.output)
        return functional_forward(
            self.module, dict(self.module.named_parameters()),
            dict(self.module.named_buffers()), x, compute_dtype=compute_dtype,
            mask=mask, output=output or self.output)

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

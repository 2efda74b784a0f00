"""
The port's Flax default initialization, memoized for the CPU tests.

``model_api.flax_default_init_`` draws every weight it writes from a CPU
generator in module order, so what it writes is a function of the module's
structure and of the generator's state. On the CPU that draw
(``torch.nn.init.trunc_normal_``) is most of the time a small test spends
on a model: every new ``Model`` draws once, and ``Model.init(generator)``
again. Within ``memoized()`` the first draw for a (structure, generator
state) pair runs and is kept; a later one writes the kept tensors and
leaves the generator where the draw left it, so every model and generator
holds the same bits as without the cache.
"""
import contextlib

import torch
from torch import nn

from lidbox_tpu_torch.models import model_api
from lidbox_tpu_torch.models.layers import BatchNorm


def drawn_tensors(module):
    """The tensors ``flax_default_init_`` writes, by name: the weights and
    biases of every Conv1d, Conv2d and Linear (the recurrent cells' hidden
    kernels among them) and every BatchNorm's scale, bias and statistics."""
    out = {}
    for name, sub in module.named_modules():
        if isinstance(sub, (nn.Conv1d, nn.Conv2d, nn.Linear, BatchNorm)):
            for k, t in (list(sub.named_parameters(recurse=False))
                         + list(sub.named_buffers(recurse=False))):
                out[f"{name}.{k}"] = t
    return out


@contextlib.contextmanager
def memoized():
    draw = model_api.flax_default_init_
    kept = {}

    def init(module, generator):
        tensors = drawn_tensors(module)
        key = (tuple(type(m).__name__ for m in module.modules()),
               tuple((k, tuple(t.shape), t.dtype, t.device.type)
                     for k, t in tensors.items()),
               generator.get_state().numpy().tobytes())
        if key not in kept:
            draw(module, generator)
            kept[key] = ({k: t.detach().clone() for k, t in tensors.items()},
                         generator.get_state())
            return
        values, after = kept[key]
        with torch.no_grad():
            for k, t in tensors.items():
                t.copy_(values[k])
        generator.set_state(after)

    model_api.flax_default_init_ = init
    try:
        yield
    finally:
        model_api.flax_default_init_ = draw

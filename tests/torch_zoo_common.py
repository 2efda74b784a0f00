"""
Shared pieces of the model-zoo parity tests (tests/test_torch_zoo*.py): a
port model and the JAX model holding the same weights, and the JAX
package's outputs of one jitted program per model.

The weights are the port's seeded Flax-default init with BatchNorm
statistics moved off their init (so eval-mode normalization is not the
identity), handed to the JAX module through ``params_to_flax``; the tests
hold that tree to Flax's own (``jax.eval_shape`` of the JAX init), and
load JAX-initialized weights through ``params_from_flax`` where noted.
"""
import numpy as np
import torch

import jax
import jax.numpy as jnp

import lidbox_tpu.models as jmodels
import lidbox_tpu_torch.models as tmodels
from lidbox_tpu_torch.models.model_api import params_to_flax

# the JAX package's own masked-vs-trimmed budget (tests/test_models.py:235)
RTOL, ATOL = 1e-4, 1e-5


def port_model(key, input_shape, num_outputs, kwargs, seed=0):
    """A port model on the CPU, seeded, with BatchNorm statistics drawn
    away from 0 / 1."""
    model = tmodels.create(key, input_shape, num_outputs, device="cpu",
                           **kwargs)
    model.init(torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, b in model.module.named_buffers():
            if name.endswith(".mean"):
                b.copy_(torch.as_tensor(rng.normal(0, 0.1, b.shape)))
            else:
                b.copy_(torch.as_tensor(rng.uniform(0.5, 1.5, b.shape)))
    return model


def flax_variables(model):
    """The port model's weights as the JAX package's variables."""
    variables = {"params": params_to_flax(dict(model.module.named_parameters()))}
    buffers = dict(model.module.named_buffers())
    if buffers:
        variables["batch_stats"] = params_to_flax(buffers)
    return variables


def jax_init_shapes(key, input_shape, num_outputs, kwargs):
    """Shapes of the JAX package's initialized variables (traced, not
    run)."""
    jm = jmodels.create(key, input_shape, num_outputs, **kwargs)
    rng = jax.random.PRNGKey(0)
    dummy = jnp.zeros((1,) + tuple(input_shape), jnp.float32)
    shapes = jax.eval_shape(lambda: jm.module.init(
        {"params": rng, "dropout": rng, "noise": rng}, dummy, train=False))
    return jax.tree_util.tree_map(lambda s: tuple(s.shape), dict(shapes))


def tree_shapes(tree):
    return jax.tree_util.tree_map(lambda a: tuple(np.shape(a)), tree)


def jax_outputs(key, input_shape, num_outputs, kwargs, variables, x, mask,
                train=True, masked=True):
    """The JAX model's outputs on (x, mask) in one jitted program: eval
    logits and embeddings, unmasked and (``masked``) masked, and (with
    ``train``) the training-mode logits and Flax's updated
    ``batch_stats``."""
    jm = jmodels.create(key, input_shape, num_outputs, **kwargs)

    def run(v, x, m):
        out = {}
        for head in ("logits", "embedding"):
            out[head] = jm.apply(v, x, output=head)
            if masked:
                out[head + "_masked"] = jm.apply(v, x * m[..., None],
                                                 output=head, mask=m)
        if train:
            out["train"], updates = jm.apply(v, x, train=True)
            out["batch_stats"] = updates.get("batch_stats", {})
        return out
    out = jax.jit(run)(variables, jnp.asarray(x), jnp.asarray(mask))
    return jax.tree_util.tree_map(np.asarray, out)


def port_outputs(model, x, mask, masked=True):
    """The port model's eval outputs, keyed as ``jax_outputs``."""
    out = {}
    xt, mt = torch.as_tensor(x), torch.as_tensor(mask)
    with torch.inference_mode():
        for head in ("logits", "embedding"):
            out[head] = model.apply(xt, output=head).numpy()
            if masked:
                out[head + "_masked"] = model.apply(
                    xt * mt[..., None], output=head, mask=mt).numpy()
    return out


def inputs(batch, frames, feat, lengths, seed=1):
    """Seeded features [batch, frames, feat] and the prefix mask of
    ``lengths``."""
    x = np.random.default_rng(seed).normal(
        0, 1, (batch, frames, feat)).astype(np.float32)
    mask = np.arange(frames)[None, :] < np.asarray(lengths)[:, None]
    return x, mask

"""
The port's recurrent layers and models against lidbox_tpu.models on the
CPU.

- ``LSTMLayer`` and ``BidirectionalRNN`` (LSTM and GRU cells), sequences
  and final states, with and without lengths: the JAX layers' own
  initialized weights load through ``params_from_flax`` (Flax's
  ``OptimizedLSTMCell`` / ``GRUCell`` kernels onto cuDNN's gate layout)
  and give the same outputs at every valid step, and the same gradients
  of a loss over the valid steps with respect to the input and every
  parameter (``jax.grad`` of the Flax layer with ``seq_lengths``), within
  rtol 1e-4 + atol 1e-5 (``RTOL`` / ``ATOL``). The lengths include a full
  row, a row of 1 and a row of 0, which both packages run as 1 (the JAX
  layer is given 1; the port's outputs for 0 equal its outputs for 1),
  and the port's outputs past a row's length are zero;
- lstm, bi_gru, spherespeaker, ap_lstm and crnn with the same weights
  (tests/torch_zoo_common.py): parameter trees equal Flax's, eval logits
  and embeddings unmasked and masked within rtol 1e-4 + atol 1e-5, the
  masked forward equal to the trimmed one, and training mode (all five
  are deterministic apart from BatchNorm) with Flax's batch-stats update;
- Flax's recurrent init: lecun_normal input kernels, orthogonal hidden
  kernels, zero biases;
- crnn's coupled decay marks exactly the conv kernels the JAX package's
  mask marks.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import lidbox_tpu.models.layers as jlayers
import lidbox_tpu.models.model_utils as jutils
import lidbox_tpu_torch.models as tmodels
from lidbox_tpu_torch.models import layers
from lidbox_tpu_torch.models import model_utils as tutils
from lidbox_tpu_torch.models.model_api import params_from_flax, params_to_flax
from torch_zoo_common import (ATOL, RTOL, flax_variables, inputs,
                              jax_init_shapes, jax_outputs, port_model,
                              port_outputs, tree_shapes)

torch.set_num_threads(2)

B, T, FEAT, N = 3, 64, 32, 5
LENGTHS = [T, 41, 9]
CONFIGS = {
    "lstm": ("lstm", {"num_units": 96}),
    "bi_gru": ("bi_gru", {}),
    "spherespeaker": ("spherespeaker", {}),
    "ap_lstm": ("ap_lstm", {}),
    "crnn": ("crnn", {}),
}
LAYERS = {
    "lstm": (lambda: jlayers.LSTMLayer(7, return_sequences=True),
             lambda: layers.LSTMLayer(5, 7, return_sequences=True)),
    "lstm_final": (lambda: jlayers.LSTMLayer(7, return_sequences=False),
                   lambda: layers.LSTMLayer(5, 7, return_sequences=False)),
    "bilstm": (lambda: jlayers.BidirectionalRNN(6),
               lambda: layers.BidirectionalRNN(5, 6)),
    "bilstm_final": (
        lambda: jlayers.BidirectionalRNN(6, return_sequences=False),
        lambda: layers.BidirectionalRNN(5, 6, return_sequences=False)),
    "bigru": (lambda: jlayers.BidirectionalRNN(6, cell="gru"),
              lambda: layers.BidirectionalRNN(5, 6, cell="gru")),
    "bigru_final": (
        lambda: jlayers.BidirectionalRNN(6, cell="gru",
                                         return_sequences=False),
        lambda: layers.BidirectionalRNN(5, 6, cell="gru",
                                        return_sequences=False)),
}


# the rows' lengths of the layers' [4, 11, 5] input: none, ragged, and the
# edges (a full row, a row of 0, which runs as 1, and a row of 1)
LAYER_LENGTHS = {"full": None, "lengths": [11, 6, 1, 9],
                 "edges": [11, 0, 1, 5]}
# case -> (lengths, compare the gradients too)
LAYER_CASES = {"full": ("full", False), "lengths": ("lengths", False),
               "edges": ("edges", False), "full_grads": ("full", True),
               "lengths_grads": ("lengths", True),
               "edges_grads": ("edges", True)}


@functools.lru_cache(maxsize=None)
def flax_layer(name):
    """(the JAX layer's initialized params, its jitted value and gradients
    of ``sum(outputs * weights)`` with respect to the params and the
    input): one compilation per layer and lengths case for the file."""
    jl = LAYERS[name][0]()
    x = jnp.zeros((4, 11, 5), jnp.float32)
    params = jax.device_get(jax.jit(jl.init)(jax.random.PRNGKey(3), x)[
        "params"])

    def loss(p, x, n, weights):
        out = jl.apply({"params": p}, x, lengths=n)
        return jnp.sum(out * weights), out
    return params, jax.jit(jax.value_and_grad(loss, argnums=(0, 1),
                                              has_aux=True))


@pytest.mark.parametrize("case", LAYER_CASES)
@pytest.mark.parametrize("name", LAYERS)
def test_recurrent_layers_match_flax(name, case):
    which, grads = LAYER_CASES[case]
    x = np.random.default_rng(2).normal(0, 1, (4, 11, 5)).astype(np.float32)
    lengths = LAYER_LENGTHS[which]
    n = None if lengths is None else np.maximum(lengths, 1)
    params, value_and_grad = flax_layer(name)
    pl = LAYERS[name][1]()
    pl.load_state_dict(params_from_flax(params))
    xt = torch.as_tensor(x).requires_grad_(grads)
    with torch.set_grad_enabled(grads):
        y = pl(xt, lengths=None if lengths is None
               else torch.as_tensor(lengths))
    ours = y.detach().numpy()
    valid = np.ones(ours.shape[:2], bool)
    if ours.ndim == 3:  # past a row's length: unspecified in JAX, 0 here
        valid = np.broadcast_to(np.arange(11)[None, :] < (
            11 if n is None else n[:, None]), ours.shape[:2])
        assert not ours[~valid].any()
    if lengths is not None:  # a length under 1 runs as 1
        with torch.set_grad_enabled(grads):
            as_one = pl(torch.as_tensor(x), lengths=torch.as_tensor(n))
        assert torch.equal(y.detach(), as_one.detach())
    weights = np.random.default_rng(4).normal(0, 1, ours.shape).astype(
        np.float32)
    weights[~valid] = 0.0  # the loss reads the valid steps alone
    (_, ref), (ref_dp, ref_dx) = value_and_grad(
        params, jnp.asarray(x), None if n is None else jnp.asarray(n),
        jnp.asarray(weights))
    ref = np.asarray(ref)
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours[valid], ref[valid], rtol=RTOL, atol=ATOL)
    back = params_to_flax(dict(pl.named_parameters()))
    assert jax.tree_util.tree_all(jax.tree_util.tree_map(np.array_equal,
                                                         back, params))
    if not grads:
        return
    torch.sum(y * torch.as_tensor(weights)).backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(ref_dx),
                               rtol=RTOL, atol=ATOL)
    ours_dp = params_to_flax({k: p.grad for k, p in pl.named_parameters()})
    paths = jax.tree_util.tree_flatten_with_path(jax.device_get(ref_dp))[0]
    assert len(paths) == len(jax.tree_util.tree_leaves(ours_dp))
    for path, ref_g in paths:
        got = ours_dp
        for key in path:
            got = got[key.key]
        np.testing.assert_allclose(np.asarray(got), np.asarray(ref_g),
                                   rtol=RTOL, atol=ATOL,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.fixture(scope="module")
def runs():
    x, mask = inputs(B, T, FEAT, LENGTHS)
    out = {}
    for name, (key, kw) in CONFIGS.items():
        model = port_model(key, (T, FEAT), N, kw)
        variables = flax_variables(model)
        out[name] = {"model": model, "variables": variables,
                     "ref": jax_outputs(key, (T, FEAT), N, kw, variables, x,
                                        mask, train="batch_stats" in variables),
                     "ours": port_outputs(model, x, mask)}
    return x, mask, out


@pytest.mark.parametrize("name", CONFIGS)
def test_parameter_trees_match_flax(runs, name):
    _, _, out = runs
    key, kw = CONFIGS[name]
    variables = out[name]["variables"]
    assert tree_shapes(variables) == jax_init_shapes(key, (T, FEAT), N, kw)
    state = params_from_flax(variables["params"])
    state.update(params_from_flax(variables.get("batch_stats", {})))
    for k, v in out[name]["model"].module.state_dict().items():
        assert torch.equal(state.pop(k), v), k
    assert not state


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("head", ["logits", "embedding"])
@pytest.mark.parametrize("name", CONFIGS)
def test_eval_forward_matches_jax(runs, name, head, masked):
    _, _, out = runs
    k = head + ("_masked" if masked else "")
    ours, ref = out[name]["ours"][k], out[name]["ref"][k]
    assert ours.shape == ref.shape and np.isfinite(ours).all()
    np.testing.assert_allclose(ours, ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", ["lstm", "bi_gru", "ap_lstm",
                                  "spherespeaker"])
def test_masked_forward_equals_trimmed(runs, name):
    """A padded row with its frame mask scores as the row cut to its
    length (the backward direction starts at the last valid frame)."""
    x, mask, out = runs
    model = out[name]["model"]
    n = LENGTHS[2]
    with torch.inference_mode():
        trimmed = model.apply(torch.as_tensor(x[2:, :n]))
    np.testing.assert_allclose(out[name]["ours"]["logits_masked"][2:],
                               trimmed.numpy(), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", ["bi_gru", "spherespeaker", "crnn"])
def test_train_mode_matches_flax_mutable(runs, name):
    x, _, out = runs
    model, ref = out[name]["model"], out[name]["ref"]
    logits, new_bs = model.apply(torch.as_tensor(x), train=True)
    np.testing.assert_allclose(logits.detach().numpy(), ref["train"],
                               rtol=RTOL, atol=ATOL)
    ref_bs = params_from_flax(jax.device_get(ref["batch_stats"]))
    assert set(new_bs) == set(ref_bs) == set(dict(
        model.module.named_buffers()))
    for k, v in ref_bs.items():
        np.testing.assert_allclose(new_bs[k].numpy(), v.numpy(), rtol=RTOL,
                                   atol=ATOL, err_msg=k)


def test_recurrent_init_statistics():
    """Flax's cell defaults: lecun_normal input kernels, orthogonal hidden
    kernels (each gate's own), zero biases; one seed, one set."""
    model = tmodels.create("bi_gru", (T, FEAT), N, device="cpu")
    cell = model.module.BGRU_2.GRUCell_1
    for g in cell.gates:
        w = getattr(cell, f"h{g}").weight.detach()
        np.testing.assert_allclose((w @ w.T).numpy(), np.eye(512), atol=1e-4)
        wi = getattr(cell, f"i{g}").weight.detach()
        assert abs(float(wi.std()) * np.sqrt(1024) - 1.0) < 0.05
        assert not getattr(cell, f"i{g}").bias.any()
    assert not cell.hn.bias.any() and cell.hr.bias is None
    lstm = tmodels.create("lstm", (T, FEAT), N, device="cpu", num_units=16)
    lcell = lstm.module.lstm.OptimizedLSTMCell_0
    assert lcell.ii.bias is None and not lcell.hf.bias.any()
    again = tmodels.create("bi_gru", (T, FEAT), N, device="cpu")
    for (k, a), b in zip(model.module.state_dict().items(),
                         again.module.state_dict().values()):
        assert torch.equal(a, b), k


def test_crnn_decay_mask_matches_jax(runs):
    """The coupled L2 decay reaches the conv kernels and nothing else, the
    same leaves as the JAX package's _conv_kernel_decay_mask."""
    _, _, out = runs
    variables = out["crnn"]["variables"]
    leaves = jax.tree_util.tree_flatten_with_path(
        jutils._conv_kernel_decay_mask(variables["params"]))[0]
    ref = {".".join("weight" if k.key == "kernel" else k.key for k in path):
           bool(mark) for path, mark in leaves}
    marks = tutils._conv_kernel_decay_mask(dict(
        out["crnn"]["model"].module.named_parameters()))
    assert marks == ref
    assert sorted(k for k, v in marks.items() if v) == [
        f"conv_{i}.weight" for i in range(1, 6)]

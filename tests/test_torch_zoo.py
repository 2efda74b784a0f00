"""
The port's conv, dense, attention and 2-D models against lidbox_tpu.models
on the CPU: xvector_extended, xvector_freq_attention, dnn, cnn (causal and
SAME), multilevel_attention, xvector_2d, the three clstm options and
convnet_extractor with mobilenet_v2 (resnet50_v2 is in
tests/test_torch_zoo_resnet.py).

For each configuration the same weights (tests/torch_zoo_common.py) and
seeded features go through both packages:

- the converted parameter and batch-stats trees equal Flax's own, leaf for
  leaf, and convert back unchanged;
- eval logits and embeddings, unmasked and masked, within rtol 1e-4 +
  atol 1e-5 (the JAX package's masked-vs-trimmed budget);
- training mode where it is deterministic apart from BatchNorm: the
  outputs and Flax's ``mutable=["batch_stats"]`` update, at the same
  tolerance; MobileNetV2's outputs within the JAX package's own float32
  distance from a float64 evaluation (its chained batch statistics over a
  few pixels per channel amplify float32 rounding in both packages);
- the stochastic layers (clstm's noise and channel dropout,
  multilevel_attention's dropout) by their draw statistics;
- the init statistics, Flax SAME padding and pooling, and JAX-initialized
  weights loading through ``params_from_flax``.
"""
import copy

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

import lidbox_tpu.models as jmodels
import lidbox_tpu_torch.models as tmodels
from lidbox_tpu_torch.models import layers
from lidbox_tpu_torch.models.model_api import params_from_flax, params_to_flax
from torch_zoo_common import (ATOL, RTOL, flax_variables, inputs,
                              jax_init_shapes, jax_outputs, port_model,
                              port_outputs, tree_shapes)

torch.set_num_threads(2)

B, T, FEAT, N = 3, 40, 32, 5
LENGTHS = [T, 29, 17]
CONFIGS = {
    "xvector_extended": ("xvector_extended", {}),
    "xvector_freq_attention": ("xvector_freq_attention", {}),
    "dnn": ("dnn", {}),
    "cnn": ("cnn", {}),
    "cnn_same": ("cnn", {"padding": "same"}),
    "multilevel_attention": ("multilevel_attention", {}),
    "xvector_2d": ("xvector_2d", {}),
    "clstm": ("clstm", {}),
    "clstm_conv2d": ("clstm", {"use_conv2d": True}),
    "clstm_attention_lstm": ("clstm", {"use_attention": True,
                                       "use_lstm": True}),
    "mobilenet_v2": ("convnet_extractor", {"core": "mobilenet_v2"}),
}
# training mode is deterministic apart from BatchNorm
TRAIN_COMPARED = ("xvector_2d", "mobilenet_v2")
# SAME convs read past the valid prefix: masked forwards raise in both
UNMASKABLE = ("cnn_same",)


@pytest.fixture(scope="module")
def runs():
    x, mask = inputs(B, T, FEAT, LENGTHS)
    out = {}
    for name, (key, kw) in CONFIGS.items():
        model = port_model(key, (T, FEAT), N, kw)
        variables = flax_variables(model)
        out[name] = {
            "model": model, "variables": variables,
            "ref": jax_outputs(key, (T, FEAT), N, kw, variables, x, mask,
                               train=name in TRAIN_COMPARED,
                               masked=name not in UNMASKABLE),
            "ours": port_outputs(model, x, mask,
                                 masked=name not in UNMASKABLE)}
    return x, mask, out


@pytest.mark.parametrize("name", CONFIGS)
def test_parameter_trees_match_flax(runs, name):
    _, _, out = runs
    key, kw = CONFIGS[name]
    run = out[name]
    shapes = jax_init_shapes(key, (T, FEAT), N, kw)
    assert tree_shapes(run["variables"]) == shapes
    model = run["model"]
    state = dict(model.module.state_dict())
    back = params_from_flax(run["variables"]["params"])
    back.update(params_from_flax(run["variables"].get("batch_stats", {})))
    assert set(back) == set(state)
    for k, v in state.items():
        assert torch.equal(back[k], v), k
    assert model.num_params() == sum(
        int(np.prod(s)) for s in jax.tree_util.tree_leaves(
            shapes["params"], is_leaf=lambda s: isinstance(s, tuple)))


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("head", ["logits", "embedding"])
@pytest.mark.parametrize("name", CONFIGS)
def test_eval_forward_matches_jax(runs, name, head, masked):
    x, mask, out = runs
    if masked and name in UNMASKABLE:
        with pytest.raises(ValueError, match="CAUSAL"):
            out[name]["model"].apply(torch.as_tensor(x),
                                     mask=torch.as_tensor(mask))
        return
    k = head + ("_masked" if masked else "")
    ours, ref = out[name]["ours"][k], out[name]["ref"][k]
    assert ours.shape == ref.shape and np.isfinite(ours).all()
    np.testing.assert_allclose(ours, ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", TRAIN_COMPARED)
def test_train_mode_matches_flax_mutable(runs, name):
    """Training-mode outputs and the new batch stats against Flax's
    ``apply(..., train=True, mutable=["batch_stats"])``; the model's own
    buffers stay as they were."""
    x, _, out = runs
    model, ref = out[name]["model"], out[name]["ref"]
    before = {k: b.clone() for k, b in model.module.named_buffers()}
    logits, new_bs = model.apply(torch.as_tensor(x), train=True,
                                 generator=torch.Generator().manual_seed(0))
    for k, b in model.module.named_buffers():
        assert torch.equal(b, before[k]), k
    ref_bs = params_from_flax(ref["batch_stats"])
    assert set(new_bs) == set(ref_bs) == set(before)
    for k, v in ref_bs.items():
        assert new_bs[k].dtype == torch.float32
        np.testing.assert_allclose(new_bs[k].numpy(), v.numpy(), rtol=RTOL,
                                   atol=ATOL, err_msg=k)
        assert not torch.equal(new_bs[k], before[k]), k
    logits = logits.detach().numpy()
    if name == "mobilenet_v2":
        m64 = copy.deepcopy(model.module).double().train()
        with torch.no_grad():
            exact = m64(torch.as_tensor(x, dtype=torch.float64)).numpy()
        jax_err = np.abs(ref["train"] - exact).max()
        assert np.abs(logits - exact).max() <= jax_err
    else:
        np.testing.assert_allclose(logits, ref["train"], rtol=RTOL, atol=ATOL)


def test_stochastic_layers_draw_from_the_generator():
    """clstm's GaussianNoise(0.01) and channel dropout 0.4 (one draw per
    channel over time), multilevel_attention's element dropout 0.4: keep
    rates, noise stddev, whole channels, scaling, one seed one draw."""
    gen = lambda: torch.Generator().manual_seed(3)
    x = torch.ones(64, 50, 40)
    model = tmodels.create("clstm", (50, 40), N, device="cpu").module.train()
    noisy = model.input_noise(x, generator=gen()) - x
    assert abs(float(noisy.std()) - 0.01) < 2e-4
    assert abs(float(noisy.mean())) < 2e-4
    dropped = model.channel_dropout(x, generator=gen())
    per_channel = dropped.amax(dim=1)
    assert torch.equal(dropped, per_channel[:, None, :].expand_as(dropped))
    kept = float(torch.tensor(1.0) / 0.6)
    assert set(per_channel.unique().tolist()) == {0.0, kept}
    assert abs(float((per_channel > 0).float().mean()) - 0.6) < 0.03
    assert torch.equal(model.channel_dropout(x, generator=gen()), dropped)
    block = tmodels.create("multilevel_attention", (50, 40), N,
                           device="cpu").module.dense_block1
    y = layers.dropout(x, block.dropout_rate, gen())
    assert set(y.unique().tolist()) == {0.0, kept}
    assert abs(float((y > 0).float().mean()) - 0.6) < 0.01
    assert not torch.equal(y[0, 0], y[0, 1])  # elements, not channels
    # training forwards of the whole models are finite and seeded
    xin = torch.as_tensor(inputs(2, 40, 32, [40, 30])[0])
    for key in ("clstm", "multilevel_attention"):
        m = tmodels.create(key, (40, 32), N, device="cpu")
        a, _ = m.apply(xin, train=True, generator=gen())
        b, _ = m.apply(xin, train=True, generator=gen())
        assert torch.equal(a, b) and torch.isfinite(a).all()
        assert not torch.allclose(a, m.apply(xin))


def test_init_statistics():
    """Flax's defaults: lecun_normal conv (2-D and depthwise: fan_in =
    kh * kw * in / groups) and dense kernels, zero biases, BatchNorm scale
    1, bias 0, running mean 0 and var 1; one seed, one set of weights."""
    model = tmodels.create("convnet_extractor", (T, FEAT), N, device="cpu",
                           core="mobilenet_v2")
    mod = model.module.mobilenet_v2
    for conv in (mod.block3_1.expand, mod.block3_1.depthwise,
                 mod.head_conv):
        w = conv.weight.detach()
        fan_in = w[0].numel()
        assert conv.groups == 1 or fan_in == 9
        assert abs(float(w.std()) / (1.0 / np.sqrt(fan_in)) - 1.0) < 0.1
        assert float(w.abs().max()) <= 2.0 / 0.8796 / np.sqrt(fan_in) + 1e-6
    bn = mod.block3_1.depthwise_bn
    assert torch.equal(bn.scale, torch.ones_like(bn.scale))
    assert torch.equal(bn.var, torch.ones_like(bn.var))
    assert not bn.bias.any() and not bn.mean.any()
    assert not model.module.embedding.bias.any()
    again = tmodels.create("convnet_extractor", (T, FEAT), N, device="cpu",
                           core="mobilenet_v2")
    for (k, a), b in zip(model.module.state_dict().items(),
                         again.module.state_dict().values()):
        assert torch.equal(a, b), k


@pytest.mark.parametrize("size,kernel,stride", [
    (298, 7, 2), (298, 3, 2), (64, 9, 6), (11, 9, 6), (75, 3, 1), (2, 3, 2)])
def test_same_padding_matches_flax(size, kernel, stride):
    """A strided Flax SAME conv pads total = max((ceil(n/s)-1)*s + k - n,
    0) with the smaller half low (the ResNet stem on 298 frames: 2 | 3);
    the port's Conv2d and max pool reproduce Flax's on the same grid, the
    pool padding with -inf."""
    lo, hi = layers.same_padding(size, kernel, stride)
    total = max((-(-size // stride) - 1) * stride + kernel - size, 0)
    assert (lo, hi) == (total // 2, total - total // 2)
    if (size, kernel, stride) == (298, 7, 2):
        assert (lo, hi) == (2, 3)
    rng = np.random.default_rng(size)
    x = rng.normal(-1.0, 1.0, (2, size, 5, 3)).astype(np.float32)
    ours = layers.Conv2d(3, 4, (kernel, 3), (stride, 1))
    nn_init = torch.Generator().manual_seed(size)
    with torch.no_grad():
        ours.weight.normal_(generator=nn_init)
        ours.bias.normal_(generator=nn_init)
    conv = fnn.Conv(4, (kernel, 3), strides=(stride, 1), padding="SAME")

    def flax_side(params, x):
        return (conv.apply({"params": params}, x),
                fnn.max_pool(x, (kernel, 3), strides=(stride, 2),
                             padding="SAME"))
    ref, pool_ref = jax.jit(flax_side)(
        params_to_flax(dict(ours.named_parameters())), jnp.asarray(x))
    img = torch.as_tensor(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        got = ours(img).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    pool = layers.max_pool_same(img, (kernel, 3), (stride, 2))
    np.testing.assert_array_equal(pool.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(pool_ref))


def test_jax_initialized_weights_load_and_match():
    """The JAX package's own initialized weights and batch stats
    (``Model.init``) load into the port through ``params_from_flax`` and
    give the same eval outputs; ``params_to_flax`` gives them back."""
    jm = jmodels.create("xvector_2d", (T, FEAT), N)
    rng = jax.random.PRNGKey(7)
    variables = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda: jm.module.init({"params": rng}, jnp.zeros((1, T, FEAT)),
                               train=False))())
    tm = tmodels.create("xvector_2d", (T, FEAT), N, device="cpu")
    tm.load_flax_params(variables["params"], variables["batch_stats"])
    x, mask = inputs(B, T, FEAT, LENGTHS, seed=5)
    ref = np.asarray(jax.jit(lambda v, x, m: jm.apply(v, x, mask=m))(
        variables, jnp.asarray(x), jnp.asarray(mask)))
    with torch.inference_mode():
        ours = tm.apply(torch.as_tensor(x), mask=torch.as_tensor(mask))
    np.testing.assert_allclose(ours.numpy(), ref, rtol=RTOL, atol=ATOL)
    back = params_to_flax(dict(tm.module.named_parameters()))
    assert jax.tree_util.tree_all(jax.tree_util.tree_map(
        np.array_equal, back, variables["params"]))

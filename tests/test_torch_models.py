"""
The x-vector port against lidbox_tpu.models.xvector: the JAX model's
initialized parameters are converted with ``params_from_flax`` and both
forwards run on the same numpy features (log-probabilities and embeddings
within 1e-5). Also the masked pooling and the strided-conv mask mapping.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import lidbox_tpu.models as jmodels
import lidbox_tpu_torch.models as tmodels
from lidbox_tpu_torch.models import layers, model_api

torch.set_num_threads(2)

T, FEAT, NUM_OUTPUTS = 60, 24, 5


def flax_params(model):
    return jax.tree_util.tree_map(np.asarray, model.variables["params"])


@pytest.fixture(scope="module")
def pair():
    jm = jmodels.create("xvector", (T, FEAT), NUM_OUTPUTS).init()
    tm = tmodels.create("xvector", (T, FEAT), NUM_OUTPUTS, device="cpu")
    tm.load_flax_params(flax_params(jm))
    return jm, tm


@pytest.mark.parametrize("output", ["logits", "embedding"])
def test_forward_matches_flax(pair, output):
    jm, tm = pair
    x = np.random.default_rng(0).normal(0, 1, (3, T, FEAT)).astype(np.float32)
    ref = np.asarray(jm.apply(jm.variables, jnp.asarray(x), output=output))
    with torch.inference_mode():
        ours = tm.apply(torch.as_tensor(x), output=output).numpy()
    assert ours.shape == ref.shape == ((3, NUM_OUTPUTS) if output == "logits"
                                       else (3, 512))
    np.testing.assert_allclose(ours, ref, atol=1e-5)
    emb = model_api.as_embedding_extractor(tm)
    assert emb.module is tm.module and emb.output == "embedding"


def test_masked_forward_matches_flax_and_trimmed(pair):
    jm, tm = pair
    rng = np.random.default_rng(1)
    x = rng.normal(0, 1, (2, T, FEAT)).astype(np.float32)
    n = np.array([T, 23])
    x[1, n[1]:] = 0.0
    mask = np.arange(T)[None, :] < n[:, None]
    ref = np.asarray(jm.apply(jm.variables, jnp.asarray(x),
                              mask=jnp.asarray(mask)))
    with torch.inference_mode():
        ours = tm.apply(torch.as_tensor(x), mask=torch.as_tensor(mask)).numpy()
        trimmed = tm.apply(torch.as_tensor(x[1:, :n[1]])).numpy()
    np.testing.assert_allclose(ours, ref, atol=1e-5)
    np.testing.assert_allclose(ours[1:], trimmed, atol=1e-5)


def test_mask_subsampling_exhaustive_lengths():
    """For every length n in 1..max_t the padded forward with a prefix mask
    equals the forward on the first n frames (the port of
    tests/test_models.py::test_mask_subsampling_exhaustive_lengths)."""
    max_t, feat = 37, 12
    model = tmodels.create("xvector", (max_t, feat), NUM_OUTPUTS, device="cpu")
    x_full = np.random.default_rng(42).normal(0, 1, (1, max_t, feat)).astype(
        np.float32)
    with torch.inference_mode():
        for n in range(1, max_t + 1):
            trimmed = model.apply(torch.as_tensor(x_full[:, :n]))
            xp = np.zeros_like(x_full)
            xp[:, :n] = x_full[:, :n]
            mask = torch.arange(max_t)[None, :] < n
            out = model.apply(torch.as_tensor(xp), mask=mask)
            np.testing.assert_allclose(out.numpy(), trimmed.numpy(), rtol=1e-4,
                                       atol=1e-5, err_msg=f"length {n}")


def test_pooling_matches_flax_layer():
    from lidbox_tpu.models.layers import GlobalMeanStddevPooling1D as JPool
    rng = np.random.default_rng(5)
    x = rng.normal(0, 1, (3, 11, 4)).astype(np.float32)
    x[2] = 0.5  # constant row: variance clipped at 1e-10
    mask = np.arange(11)[None, :] < np.array([[11], [1], [6]])
    pool = layers.GlobalMeanStddevPooling1D()
    for m in (None, mask):
        ref = np.asarray(JPool().apply({}, jnp.asarray(x),
                                       None if m is None else jnp.asarray(m)))
        ours = pool(torch.as_tensor(x),
                    None if m is None else torch.as_tensor(m)).numpy()
        np.testing.assert_allclose(ours, ref, atol=1e-6)
    np.testing.assert_array_equal(
        layers.subsample_frame_mask(torch.as_tensor(mask), 6, 2).numpy(),
        mask[:, ::6][:, :2])


def test_params_from_flax_layouts(pair):
    jm, _ = pair
    state = model_api.params_from_flax(flax_params(jm))
    params = flax_params(jm)
    assert state["frame1.conv.weight"].shape == (512, FEAT, 5)
    np.testing.assert_array_equal(state["frame2.conv.weight"].numpy(),
                                  params["frame2"]["conv"]["kernel"].transpose(2, 1, 0))
    np.testing.assert_array_equal(state["segment1.weight"].numpy(),
                                  params["segment1"]["kernel"].T)
    np.testing.assert_array_equal(state["outputs.bias"].numpy(),
                                  params["outputs"]["bias"])
    assert sum(v.numel() for v in state.values()) == jm.num_params()


def test_init_is_flax_default_and_seeded():
    def make(seed):
        return tmodels.create("xvector", (T, FEAT), NUM_OUTPUTS,
                              device="cpu").init(torch.Generator().manual_seed(seed))

    a, b, c = make(7), make(7), make(8)
    sa, sb, sc = (m.module.state_dict() for m in (a, b, c))
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["segment1.weight"], sc["segment1.weight"])
    w = sa["frame5.conv.weight"]             # fan_in 512 * 1
    assert abs(w.std().item() - (1 / 512) ** 0.5) < 2e-3
    assert w.abs().max().item() <= 2 * (1 / 512) ** 0.5 / 0.8796256610342398 + 1e-6
    assert all(sa[k].abs().sum() == 0 for k in sa if k.endswith("bias"))
    assert a.num_params() == jmodels.create(
        "xvector", (T, FEAT), NUM_OUTPUTS).init().num_params()


def test_registry_and_unported_options():
    with pytest.raises(KeyError):
        tmodels.get_module("resnet")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tmodels.create("lstm", (T, FEAT), NUM_OUTPUTS, device="cpu")
    model = tmodels.create("xvector", (T, FEAT), NUM_OUTPUTS, device="cpu")
    # compute_dtype is ported (the trainer's casts); the serving flag is not
    x = torch.as_tensor(np.random.default_rng(2).normal(0, 1, (2, T, FEAT)),
                        dtype=torch.float32)
    with torch.inference_mode():
        y16 = model.apply(x, compute_dtype=torch.bfloat16)
        y32 = model.apply(x)
    assert y16.dtype == torch.float32
    np.testing.assert_allclose(y16.numpy(), y32.numpy(), rtol=2e-2, atol=2e-2)
    from lidbox_tpu_torch.util import make_batch_predict_fn
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_batch_predict_fn(model, compute_dtype=torch.bfloat16)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tmodels.create("xvector", (T, FEAT), NUM_OUTPUTS)


def test_spatial_dropout_drops_whole_channels():
    drop = layers.SpatialDropout1D(0.5).train()
    torch.manual_seed(0)
    y = drop(torch.ones(4, 9, 16))
    per_channel = y.amax(dim=1)
    assert torch.equal(y, per_channel[:, None, :].expand_as(y))
    assert set(per_channel.unique().tolist()) == {0.0, 2.0}
    assert torch.equal(drop.eval()(torch.ones(2, 3, 4)), torch.ones(2, 3, 4))

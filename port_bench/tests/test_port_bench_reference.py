"""The frozen reference against the measured package's CPU path, at small
sizes: the same inputs through both, float64 where the package allows it.
The reference imports nothing of the package; this test imports both."""
import json
import os

import numpy as np
import pytest
import torch

from port_bench import common, program, signals
from port_bench.reference import bi_gru, logmel, nn, train, vad, wav, xvector

CONFIGS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs")
CPU = torch.device("cpu")


def config(name):
    with open(os.path.join(CONFIGS, name + ".json")) as f:
        return json.load(f)


def tones(n, samples, seed=5):
    return signals.class_tones(signals.generator(seed, signals.INPUTS, CPU),
                               list(range(n)), samples, 16000, CPU)


def test_mel_matrix_matches_package():
    from lidbox_tpu_torch.features import mel_ops
    ours = logmel.mel_matrix(64, 257, 16000, 0.0, 8000.0)
    theirs = mel_ops.linear_to_mel_weight_matrix(64, 257, 16000, 0.0, 8000.0)
    np.testing.assert_allclose(ours, theirs, rtol=1e-6, atol=1e-7)


def test_logmel_matches_package():
    import lidbox_tpu_torch.features as F
    f = config("xvector")["features"]
    x = tones(3, 8000)
    ours = logmel.logmel(x.double(), **logmel.feature_args(f))
    theirs = F.extract_features(x, 16000, **{
        k: v for k, v in program.feature_config(config("xvector")).items()
        if k != "type"})
    assert ours.shape == theirs.shape == (3, 48, 64)
    np.testing.assert_allclose(ours.numpy(), theirs.double().numpy(),
                               rtol=1e-4, atol=1e-4)


def test_int16_quantization_matches_staging():
    from lidbox_tpu_torch.data import on_device
    x = tones(2, 1000).numpy()
    staged = on_device.stage_signals(x, "int16")
    np.testing.assert_array_equal(wav.pcm_values(x),
                                  staged.astype(np.float64) / 32768.0)


def test_vad_matches_package():
    from lidbox_tpu_torch.data import on_device
    x = signals.with_pauses(signals.generator(3, signals.INPUTS, CPU),
                            tones(4, 16000), 16000, 0.35, 0.5)
    x = torch.as_tensor(wav.pcm_values(x.numpy()))
    out, lengths = on_device.energy_vad_compact_batch(
        x.float(), torch.full((4,), 16000), 16000)
    for row, got, n in zip(x, out, lengths):
        kept = vad.remove_silence(row, 16000)
        assert kept.shape[0] == int(n) < 16000
        np.testing.assert_allclose(kept.numpy(), got[:int(n)].double().numpy(),
                                   atol=1e-7)


def package_module(name, weights):
    m = program.model(config(name), weights, CPU)
    return m.module.double()


def test_xvector_forward_matches_package_masked():
    c = config("xvector")
    w = program.weights(c, 11, CPU)
    module = package_module("xvector", w)
    params = {k: v.double() for k, v in w.items()}
    lengths = [40, 27, 33]
    feats = torch.randn(3, 40, 64, generator=torch.Generator().manual_seed(1),
                        dtype=torch.float64)
    mask = torch.arange(40)[None] < torch.tensor(lengths)[:, None]
    theirs = module(feats * mask[..., None], mask=mask)
    for i, n in enumerate(lengths):
        ours = xvector.forward(params, feats[i:i + 1, :n], c)[0]
        np.testing.assert_allclose(ours.detach().numpy(),
                                   theirs[i].detach().numpy(), atol=1e-9)


def test_bi_gru_forward_matches_package_masked_training():
    c = config("bi_gru")
    w = program.weights(c, 12, CPU)
    module = package_module("bi_gru", w)
    params = {k: v.double() for k, v in w.items()}
    lengths = [20, 13, 17, 20]
    feats = torch.randn(4, 20, 64, generator=torch.Generator().manual_seed(2),
                        dtype=torch.float64)
    mask = torch.arange(20)[None] < torch.tensor(lengths)[:, None]
    theirs = module.train()(feats * mask[..., None], mask=mask)
    ours = bi_gru.forward(params, feats, c, lengths)
    np.testing.assert_allclose(ours.detach().numpy(),
                               theirs.detach().numpy(), atol=1e-9)


def test_adam_matches_package():
    from lidbox_tpu_torch.train import optimizers
    opt = config("xvector")["optimizer"]
    rule, _ = optimizers.optimizer_from_config({"cls": "Adam", "kwargs": {
        k: opt[k] for k in ("learning_rate", "beta_1", "beta_2", "epsilon")}})
    g = torch.Generator().manual_seed(3)
    params = {"a": torch.randn(5, generator=g, dtype=torch.float64)}
    state = rule.init(params)
    ref = nn.Adam(opt["learning_rate"], opt["beta_1"], opt["beta_2"],
                  opt["epsilon"])
    ours = dict(params)
    for _ in range(3):
        grads = {"a": torch.randn(5, generator=g, dtype=torch.float64)
                 * torch.tensor([1.0, 1e-3, 1e-7, 1e-9, 0.0])}
        updates, state = rule.update(grads, state, params)
        params = {"a": params["a"] + updates["a"]}
        ours = ref.step(ours, grads)
    # the package rounds each bias correction to float32, as optax does
    np.testing.assert_allclose(ours["a"].numpy(), params["a"].numpy(),
                               rtol=1e-6, atol=1e-15)


def test_weights_are_the_seeds():
    c = config("bi_gru")
    a, b = program.weights(c, 2 ** 40 + 3, CPU), program.weights(c, 2 ** 40 + 3, CPU)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["output.weight"],
                           program.weights(c, 4, CPU)["output.weight"])
    assert common.make_weights([("w", (2, 3), ("fan_in", 4))], 1, CPU)[
        "w"].shape == (2, 3)


@pytest.mark.parametrize("name", ["xvector", "bi_gru"])
def test_first_train_step_matches_package(name):
    """One step of the reference against the package's model in training
    mode on the same features: the loss and every gradient."""
    c = config(name)
    w = program.weights(c, 13, CPU)
    module = package_module(name, w)
    x = tones(4, 6400).numpy()
    y = np.array([0, 3, 5, 1])
    vad_args = {} if name == "bi_gru" else None
    feats, lengths = train.batch_features(x, dict(c["features"]), vad_args)
    mask = torch.arange(feats.shape[1])[None] < torch.tensor(lengths)[:, None]
    live = dict(module.named_parameters())
    out = module.train()(feats, **({"mask": mask} if vad_args is not None
                                   else {}))
    loss = nn.nll(out, torch.as_tensor(y))
    grads = dict(zip(live, torch.autograd.grad(loss, list(live.values()))))
    losses, ref_grads, _ = train.train_steps(
        program.reference_model(c), w, [(x, y)], c, vad_args)
    assert losses[0] == pytest.approx(float(loss.detach()), rel=1e-10)
    for k, g in ref_grads.items():
        np.testing.assert_allclose(g.numpy(), grads[k].numpy(), atol=1e-9,
                                   err_msg=k)

"""
The port's rematerialized train step and the DSP split precision modes,
on the CPU.

- ``Trainer.remat``: the train step under ``torch.utils.checkpoint``
  (the JAX package's ``jax.checkpoint``) against the plain step at rtol
  1e-6 (tests/test_models.py:194), over 3 steps of an x-vector with
  channel dropout at 0.5 and of multilevel_attention (BatchNorm and
  dropout): a recompute that drew new masks would give other gradients,
  and the batch statistics must come back once. Toggling ``remat``
  between fits takes effect (tests/test_train.py:1775-1790).
- ``precision="bf16_3x"`` / ``"bf16_6x"`` (XLA's BF16_BF16_F32_X3 / X6 as
  bfloat16 piece products): log-Mel and MFCC through
  ``features.extract_features`` against a float64 evaluation and against
  the JAX package's ``extract_features`` in the same mode, within the JAX
  package's budget for the split modes, a log-Mel error of about 1.5e-3
  against float64 (lidbox_tpu/features/audio.py:199-210), held here as
  atol 1.5e-3 for both features. On the CPU the JAX package computes
  these modes in float32. A ``stft_method: "pallas"`` request in a split
  mode takes the matmul path with the JAX package's log line
  (lidbox_tpu/features/__init__.py:277-286).
"""
import logging

import numpy as np
import pytest
import scipy.fft
import torch

import jax.numpy as jnp

import lidbox_tpu.features as JF
import lidbox_tpu_torch.features as TF
import lidbox_tpu_torch.models as tmodels
from lidbox_tpu import testutil
from lidbox_tpu_torch import losses
from lidbox_tpu_torch.data.device_pipeline import DeviceFeatureExtractor
from lidbox_tpu_torch.features import audio, mel_ops
from lidbox_tpu_torch.train import loop, optimizers

torch.set_num_threads(2)

RATE = 16000
SPLIT_BUDGET = 1.5e-3
MFCC = {"coef_begin": 0, "coef_end": 20}


def batches(shape, n=3, seed=0, batch=4):
    rng = np.random.default_rng(seed)
    return [{"input": rng.normal(0, 1, (batch,) + shape).astype(np.float32),
             "target": rng.integers(0, 3, batch).astype(np.int32)}
            for _ in range(n)]


def trainer(key, shape, remat, **kw):
    model = tmodels.create(key, shape, 3, device="cpu", **kw)
    t = loop.Trainer(model, optimizers.adam(1e-3), losses.nll_loss,
                     device="cpu")
    t.remat = remat
    return t


@pytest.mark.parametrize("key,shape,kw", [
    ("xvector", (40, 30), {"channel_dropout_rate": 0.5}),
    ("multilevel_attention", (20, 16), {})])
def test_remat_training_matches_plain(key, shape, kw):
    runs = {}
    for remat in (False, True):
        t = trainer(key, shape, remat, **kw)
        state = t.create_state()
        step_losses = []
        for b in batches(shape):
            batch = {k: torch.as_tensor(v) for k, v in b.items()}
            state, loss = t._train_step(state, batch, t.generator)
            step_losses.append(float(loss))
        runs[remat] = (step_losses, state, t.generator.get_state())
    (plain, s0, g0), (remat, s1, g1) = runs[False], runs[True]
    np.testing.assert_allclose(remat, plain, rtol=1e-6)
    for k, v in s0.params.items():
        np.testing.assert_allclose(s1.params[k], v, rtol=1e-6, atol=1e-7,
                                   err_msg=k)
    # the statistics came back once per step, as the plain step's
    for k, v in s0.batch_stats.items():
        np.testing.assert_allclose(s1.batch_stats[k], v, rtol=1e-6,
                                   atol=1e-7, err_msg=k)
    # the recompute left the dropout generator where the forward did
    assert torch.equal(g0, g1)


def test_remat_toggles_between_fits(monkeypatch):
    calls = []
    checkpoint = torch.utils.checkpoint.checkpoint

    def counting(*args, **kw):
        calls.append(1)
        return checkpoint(*args, **kw)
    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint", counting)
    feed = batches((40, 30), n=2)
    toggled = trainer("xvector", (40, 30), False, channel_dropout_rate=0.5)
    plain = trainer("xvector", (40, 30), False, channel_dropout_rate=0.5)
    seen = []
    for epoch, remat in ((1, False), (2, True), (3, False)):
        toggled.remat = remat
        h = toggled.fit(lambda: feed, epochs=epoch, verbose=False)
        seen.append(len(calls))
        np.testing.assert_allclose(
            h[-1]["loss"], plain.fit(lambda: feed, epochs=epoch,
                                     verbose=False)[-1]["loss"], rtol=1e-6)
        toggled.initial_epoch = plain.initial_epoch = epoch
    assert seen == [0, 2, 2]  # two checkpointed steps in the remat epoch


def float64_logmel(signals, num_mel_bins=40):
    """tf.signal's log-Mel in float64 numpy: 25 / 10 ms periodic-Hann
    frames, a 512-point rFFT, |X|^2, HTK mel weights, log(x + 1e-6)."""
    n = np.arange(400)
    window = 0.5 - 0.5 * np.cos(2 * np.pi * n / 400)
    count = 1 + (signals.shape[-1] - 400) // 160
    idx = 160 * np.arange(count)[:, None] + n[None, :]
    frames = signals.astype(np.float64)[:, idx] * window
    power = np.abs(np.fft.rfft(frames, n=512)) ** 2
    weights = mel_ops.linear_to_mel_weight_matrix(
        num_mel_bins, 257, RATE, 0.0, 8000.0, dtype=np.float64)
    return np.log(power @ weights + 1e-6)


def float64_mfcc(log_mel):
    """tf.signal.mfccs_from_log_mel_spectrograms in float64."""
    coeffs = scipy.fft.dct(log_mel, type=2) / np.sqrt(2 * log_mel.shape[-1])
    return coeffs[..., MFCC["coef_begin"]:MFCC["coef_end"]]


@pytest.fixture(scope="module")
def signals():
    return np.stack([testutil.noisy_sinewave(150 * (i + 1), RATE, 0.1, 1.0,
                                             seed=i) for i in range(3)])


@pytest.mark.parametrize("mode", ["bf16_3x", "bf16_6x"])
@pytest.mark.parametrize("feature_type", ["logmelspectrogram", "mfcc"])
def test_split_modes_within_the_jax_budget(signals, mode, feature_type):
    kw = dict(feature_type=feature_type, stft_method="matmul",
              melspectrogram={"num_mel_bins": 40}, mfcc=MFCC, precision=mode)
    ours = TF.extract_features(torch.as_tensor(signals), RATE, **kw).numpy()
    theirs = np.asarray(JF.extract_features(jnp.asarray(signals), RATE,
                                            **kw))
    ref = float64_logmel(signals)
    if feature_type == "mfcc":
        ref = float64_mfcc(ref)
    assert ours.shape == theirs.shape == ref.shape
    np.testing.assert_allclose(ours, ref, rtol=0, atol=SPLIT_BUDGET)
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=SPLIT_BUDGET)
    # the split beats the 1-pass mode, which does not hold the budget
    one_pass = TF.extract_features(torch.as_tensor(signals), RATE,
                                   **dict(kw, precision="bf16")).numpy()
    assert np.abs(ours - ref).max() < np.abs(one_pass - ref).max()
    # the device pipeline's extractor takes the mode from its config
    extractor = DeviceFeatureExtractor(
        {"type": feature_type, "stft_method": "matmul", "precision": mode,
         "melspectrogram": {"num_mel_bins": 40}, "mfcc": MFCC}, device="cpu")
    np.testing.assert_array_equal(
        extractor.extract(torch.as_tensor(signals), RATE).numpy(), ours)


def test_pallas_request_in_a_split_mode_takes_matmul(signals, caplog):
    kw = dict(feature_type="logmelspectrogram",
              melspectrogram={"num_mel_bins": 40}, precision="bf16_3x")
    with caplog.at_level(logging.INFO, logger="lidbox_tpu_torch"):
        ours = TF.extract_features(torch.as_tensor(signals), RATE,
                                   stft_method="pallas", **kw).numpy()
    assert "stft_method='pallas' unavailable for this request" in caplog.text
    np.testing.assert_array_equal(ours, TF.extract_features(
        torch.as_tensor(signals), RATE, stft_method="matmul", **kw).numpy())
    theirs = np.asarray(JF.extract_features(jnp.asarray(signals), RATE,
                                            stft_method="pallas", **kw))
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=SPLIT_BUDGET)
    assert audio.DSP_PRECISIONS == ("highest", "bf16", "bf16_3x", "bf16_6x")

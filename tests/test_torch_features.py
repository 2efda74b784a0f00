"""
DSP and feature-dispatcher parity of the PyTorch port against lidbox_tpu:
the same numpy inputs go through ``lidbox_tpu.features`` (JAX, CPU) and
``lidbox_tpu_torch.features`` (device="cpu"). Tolerance 1e-4, the JAX
package's own tf.signal budget.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import lidbox_tpu.features as JF
import lidbox_tpu_torch.features as TF
from lidbox_tpu import testutil
from lidbox_tpu.features import audio as jaudio
from lidbox_tpu_torch.features import audio as taudio

torch.set_num_threads(2)

RATE = 16000
ATOL = 1e-4


def _signals(batch=3, dur=1.0):
    return np.stack([testutil.noisy_sinewave(100 * (i + 1), RATE, 0.1, dur,
                                             seed=i) for i in range(batch)])


def _t(x):
    return torch.as_tensor(np.array(x))


@pytest.mark.parametrize("n", [400, 512, 401])
def test_hann_window(n):
    np.testing.assert_allclose(taudio.hann_window(n).numpy(),
                               np.asarray(jaudio.hann_window(n)), atol=1e-7)


def test_frame_and_ms_to_frames():
    x = _signals(2, 0.2)
    for axis, sig in ((-1, x), (0, x[0]), (0, x[0, :399])):
        np.testing.assert_array_equal(
            taudio.frame(_t(sig), 400, 160, axis=axis).numpy(),
            np.asarray(jaudio.frame(jnp.asarray(sig), 400, 160, axis=axis)))
    assert taudio.ms_to_frames(8000, 25) == jaudio.ms_to_frames(8000, 25) == 200


# The geometry sweep of tests/test_features_audio.py: segment split points,
# non-multiple tails, step > length gaps, odd frame and fft lengths, and
# tf.signal's fft_length < frame_length truncation.
GEOMETRIES = [
    (400, 160, 512, 48000), (400, 160, 512, 48001), (400, 160, 512, 439),
    (512, 128, 512, 8192), (256, 256, 512, 4096), (200, 80, 256, 5000),
    (240, 100, 256, 7013), (64, 400, 512, 9000), (331, 97, 512, 6100),
    (400, 160, 511, 4000), (400, 160, 257, 4000),
]


@pytest.mark.parametrize("frame_length,frame_step,fft_length,T", GEOMETRIES)
def test_stft_matches_jax_all_geometries(frame_length, frame_step,
                                         fft_length, T):
    rng = np.random.default_rng(frame_length * 7 + T)
    x = rng.normal(0, 1, (2, T)).astype(np.float32)
    jr, ji = jaudio.stft(jnp.asarray(x), frame_length, frame_step,
                         fft_length=fft_length, method="matmul")
    jfft = np.asarray(jaudio.stft(jnp.asarray(x), frame_length, frame_step,
                                  fft_length=fft_length, method="fft"))
    scale = max(1.0, float(np.abs(np.asarray(jr)).max(initial=0.0)))
    tr, ti = taudio.stft(_t(x), frame_length, frame_step,
                         fft_length=fft_length, method="matmul")
    tfft = taudio.stft(_t(x), frame_length, frame_step,
                       fft_length=fft_length, method="fft").numpy()
    assert tr.shape == jr.shape and tfft.shape == jfft.shape
    for ours, ref in ((tr.numpy(), np.asarray(jr)), (ti.numpy(), np.asarray(ji)),
                      (tfft.real, jfft.real), (tfft.imag, jfft.imag)):
        np.testing.assert_allclose(ours / scale, ref / scale, atol=2e-5)


@pytest.mark.parametrize("method", ["matmul", "fft"])
@pytest.mark.parametrize("power", [1.0, 2.0])
def test_spectrograms_mel_db_mfcc(method, power):
    x = _signals()
    S_j = np.asarray(jaudio.spectrograms(jnp.asarray(x), RATE, power=power,
                                         method=method))
    S_t = taudio.spectrograms(_t(x), RATE, power=power, method=method)
    scale = max(1.0, float(np.abs(S_j).max()))
    np.testing.assert_allclose(S_t.numpy() / scale, S_j / scale, atol=2e-6)
    M_j = np.asarray(jaudio.linear_to_mel(jnp.asarray(S_j), RATE,
                                          num_mel_bins=40, fmin=20.0,
                                          fmax=7000.0))
    M_t = taudio.linear_to_mel(_t(S_j), RATE, num_mel_bins=40, fmin=20.0,
                               fmax=7000.0).numpy()
    np.testing.assert_allclose(M_t / scale, M_j / scale, atol=2e-6)
    np.testing.assert_allclose(taudio.power_to_db(_t(S_j)).numpy(),
                               np.asarray(jaudio.power_to_db(jnp.asarray(S_j))),
                               atol=ATOL)
    log_mel = np.log(M_j + 1e-6)
    for begin, end in ((1, 13), (0, 20)):
        np.testing.assert_allclose(
            taudio.mfcc(_t(log_mel), begin, end).numpy(),
            np.asarray(jaudio.mfcc(jnp.asarray(log_mel), begin, end)),
            atol=ATOL)


def test_dsp_precision_modes():
    x = _t(_signals(2, 0.5))
    ref = taudio.spectrograms(x, RATE, method="matmul")
    bf16 = taudio.spectrograms(x, RATE, method="matmul", precision="bf16")
    rel = (bf16 - ref).abs().max() / ref.abs().max()
    assert 0 < rel < 1e-2
    for mode in ("bf16_3x", "bf16_6x"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            taudio.spectrograms(x, RATE, method="matmul", precision=mode)


_FEATURE_OPTIONS = {
    "spectrogram": {},
    "db_spectrogram": {"db_spectrogram": {"top_db": 60.0}},
    "melspectrogram": {"melspectrogram": {"num_mel_bins": 40}},
    "logmelspectrogram": {"melspectrogram": {"num_mel_bins": 40},
                          "sample_minmax_scaling": {"min": -1.0, "max": 1.0}},
    "mfcc": {"melspectrogram": {"num_mel_bins": 40},
             "mfcc": {"coef_begin": 0, "coef_end": 20},
             "window_normalization": {"window_len": 31}},
}


@pytest.mark.parametrize("with_lengths", [False, True])
@pytest.mark.parametrize("feature_type", list(_FEATURE_OPTIONS))
def test_extract_features_matches_jax(feature_type, with_lengths):
    x = _signals(3, 1.0)
    kw = dict(_FEATURE_OPTIONS[feature_type], feature_type=feature_type,
              stft_method="matmul")
    lengths = [16000, 11111, 6000] if with_lengths else None
    ref, ref_mask = JF.extract_features(jnp.asarray(x), RATE, lengths=lengths,
                                        return_mask=True, **kw)
    ours, mask = TF.extract_features(_t(x), RATE, lengths=lengths,
                                     return_mask=True, **kw)
    ref = np.asarray(ref)
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(ours.numpy() / scale, ref / scale, atol=ATOL)
    if with_lengths:
        np.testing.assert_array_equal(mask.numpy(), np.asarray(ref_mask))
    else:
        assert mask is None and ref_mask is None


@pytest.mark.parametrize("window_len,normalize_variance",
                         [(8, True), (15, False), (32, True), (200, True)])
def test_window_normalization_plain_and_masked(window_len, normalize_variance):
    rng = np.random.default_rng(window_len)
    X = rng.normal(2.0, 3.0, (3, 90, 7)).astype(np.float32)
    kw = dict(window_len=window_len, normalize_variance=normalize_variance)
    np.testing.assert_allclose(
        TF.window_normalization(_t(X), **kw).numpy(),
        np.asarray(JF.window_normalization(jnp.asarray(X), **kw)), atol=ATOL)
    n = np.array([90, 41, 12], np.int32)
    np.testing.assert_allclose(
        TF.window_normalization_masked(_t(X), _t(n), **kw).numpy(),
        np.asarray(JF.window_normalization_masked(jnp.asarray(X),
                                                  jnp.asarray(n), **kw)),
        atol=ATOL)


def test_masked_moments_and_scaling():
    rng = np.random.default_rng(3)
    X = rng.normal(0, 2, (2, 20, 5)).astype(np.float32)
    mask = (np.arange(20)[None, :] < np.array([[20], [9]]))[..., None]
    for name in ("cmn_masked", "cmvn_masked"):
        np.testing.assert_allclose(
            getattr(TF, name)(_t(X), _t(mask)).numpy(),
            np.asarray(getattr(JF, name)(jnp.asarray(X), jnp.asarray(mask))),
            atol=1e-5)
    np.testing.assert_allclose(
        TF.feature_scaling_masked(_t(X), 0.0, 1.0, _t(mask)).numpy(),
        np.asarray(JF.feature_scaling_masked(jnp.asarray(X), 0.0, 1.0,
                                             jnp.asarray(mask))), atol=1e-6)
    np.testing.assert_allclose(TF.cmvn(_t(X)).numpy(),
                               np.asarray(JF.cmvn(jnp.asarray(X))), atol=1e-5)
    np.testing.assert_allclose(
        TF.feature_scaling(_t(X), 0.0, 1.0).numpy(),
        np.asarray(JF.feature_scaling(jnp.asarray(X), 0.0, 1.0)), atol=1e-6)
    lengths = np.array([16000, 399, 401, 5000])
    np.testing.assert_array_equal(
        TF.frame_mask_from_lengths(_t(lengths), 98, 400, 160).numpy(),
        np.asarray(JF.frame_mask_from_lengths(jnp.asarray(lengths), 98, 400,
                                              160)))

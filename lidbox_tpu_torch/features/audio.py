"""
Audio DSP in PyTorch: the subset of ``lidbox_tpu.features.audio`` that
feature extraction needs (framing, periodic Hann window, STFT, power
spectrograms, mel projection, dB scaling, MFCC).

Numerics follow tf.signal as the JAX package does (within 1e-4).

Precision modes of the matmul DSP path (``precision=``):

- ``"highest"``: float32 operands and float32 products. On a CUDA device
  the caller keeps TF32 off (``torch.backends.cuda.matmul.allow_tf32`` is
  False by default) or the 1e-4 budget does not hold.
- ``"bf16"``: operands rounded to bfloat16, products accumulated in
  float32 (the rounding points of the JAX package's 1-pass mode).

The JAX package's ``"bf16_3x"``/``"bf16_6x"`` split modes have no port
yet (ROADMAP queue 1, "DSP precision split modes") and raise.
"""
import functools

import numpy as np
import torch

from . import mel_ops

DSP_PRECISIONS = ("highest", "bf16")


def dsp_operand(x, precision):
    """Round a matmul operand to the precision mode's input type; the
    product itself always runs in float32."""
    if precision == "highest":
        return x
    if precision == "bf16":
        return x.to(torch.bfloat16).to(torch.float32)
    if precision in ("bf16_3x", "bf16_6x"):
        raise NotImplementedError(
            f"precision={precision!r} is not ported yet (ROADMAP queue 1, "
            "'DSP precision split modes'); use 'highest' or 'bf16'")
    raise ValueError(f"unknown DSP precision {precision!r}; "
                     f"valid: {DSP_PRECISIONS}")


def ms_to_frames(sample_rate, ms):
    """Milliseconds to sample count (reference: lidbox/features/audio.py:185-189)."""
    return int(sample_rate * 1e-3 * ms)


def log10(x):
    return torch.log(x) / np.float32(np.log(10.0))


def power_to_db(S, amin=1e-10, top_db=80.0):
    """Power/amplitude to decibel with a dynamic-range floor, with the
    reference's 20*log10 and *global* max over the whole batched tensor
    (reference: lidbox/features/audio.py:167-174)."""
    amin = torch.tensor(amin, dtype=S.dtype, device=S.device)
    db = 20.0 * (log10(torch.maximum(amin, S))
                 - log10(torch.maximum(amin, S.max())))
    return torch.maximum(db, db.max() - top_db)


def num_frames(num_samples, frame_length, frame_step):
    """tf.signal frame count without end padding."""
    return max(0, 1 + (int(num_samples) - frame_length) // frame_step)


def frame(signal, frame_length, frame_step, axis=-1):
    """tf.signal.frame without end padding: a new frames axis at ``axis``,
    the frame samples at ``axis + 1``."""
    axis = axis % signal.dim()
    if signal.shape[axis] < frame_length:
        shape = list(signal.shape)
        shape[axis:axis + 1] = [0, frame_length]
        return signal.new_zeros(shape)
    return torch.movedim(signal.unfold(axis, frame_length, frame_step),
                         -1, axis + 1)


def hann_window(window_length, periodic=True, dtype=torch.float32):
    """Periodic Hann window with tf.signal's raised-cosine denominator
    ``window_length + periodic * (1 - window_length % 2) - 1``
    (reference STFT at lidbox/features/audio.py:226-230)."""
    even = 1 - window_length % 2
    n = window_length + int(periodic) * even - 1
    count = np.arange(window_length, dtype=np.float64)
    return torch.as_tensor(0.5 - 0.5 * np.cos(2.0 * np.pi * count / n),
                           dtype=dtype)


@functools.lru_cache(maxsize=16)
def _windowed_dft_basis(frame_length, fft_length):
    """float32 numpy (cos, sin) bases [frame_length, fft_length//2 + 1]
    with the periodic Hann window folded in:
    rfft(w * x)[k] = sum_n x[n] w[n] exp(-2 pi i n k / N).

    tf.signal.stft rffts only the first ``fft_length`` samples of a frame
    longer than ``fft_length``: those basis rows are zero."""
    n = np.arange(frame_length, dtype=np.float64)[:, None]
    k = np.arange(fft_length // 2 + 1, dtype=np.float64)[None, :]
    ang = -2.0 * np.pi * n * k / fft_length
    denom = frame_length + (1 - frame_length % 2) - 1
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / denom)
    cos_b = np.asarray(w * np.cos(ang), np.float32)
    sin_b = np.asarray(w * np.sin(ang), np.float32)
    if fft_length < frame_length:
        cos_b[fft_length:] = 0.0
        sin_b[fft_length:] = 0.0
    return cos_b, sin_b


@functools.lru_cache(maxsize=16)
def _basis_tensor(frame_length, fft_length, device):
    """[L, 2 * num_bins] cos|sin basis on ``device``, cut to the
    L = min(frame_length, fft_length) rows that can be nonzero."""
    cos_b, sin_b = _windowed_dft_basis(frame_length, fft_length)
    rows = min(frame_length, fft_length)
    return torch.as_tensor(np.concatenate([cos_b[:rows], sin_b[:rows]],
                                          axis=1), device=device)


def stft(signals, frame_length, frame_step, fft_length=512, method="fft",
         precision="highest"):
    """Short-time Fourier transform over the last axis, with
    tf.signal.stft semantics: periodic Hann window, frames zero-padded (or
    cut) to ``fft_length``, no end padding.

    ``method="matmul"``: frames (``unfold``) times the windowed-DFT basis
    in one matmul; returns ``(real, imag)``. ``method="fft"``:
    ``torch.fft.rfft``; returns a complex tensor."""
    num_bins = fft_length // 2 + 1
    frames = frame(signals, frame_length, frame_step, axis=-1)
    if method == "matmul":
        basis = _basis_tensor(frame_length, fft_length, signals.device)
        frames = frames[..., :basis.shape[0]]
        out = torch.matmul(dsp_operand(frames, precision),
                           dsp_operand(basis, precision))
        return out[..., :num_bins], out[..., num_bins:]
    if method != "fft":
        raise ValueError(f"unknown stft method {method!r}")
    frames = frames * hann_window(frame_length).to(signals.device)
    return torch.fft.rfft(frames[..., :fft_length], n=fft_length, dim=-1)


def spectrograms(signals, sample_rate, frame_length_ms=25, frame_step_ms=10,
                 power=2.0, fft_length=512, method="fft", precision="highest"):
    """|STFT|^power over batched signals [B, T] -> [B, frames, bins]
    (reference: lidbox/features/audio.py:219-230)."""
    frame_length = ms_to_frames(sample_rate, frame_length_ms)
    frame_step = ms_to_frames(sample_rate, frame_step_ms)
    S = stft(signals, frame_length, frame_step, fft_length=fft_length,
             method=method, precision=precision)
    if method == "matmul":
        real, imag = S
        psd = real * real + imag * imag
        if power == 2.0:
            return psd
        return torch.pow(torch.sqrt(psd), power)
    return torch.pow(torch.abs(S), power)


@functools.lru_cache(maxsize=16)
def _mel_tensor(num_mel_bins, num_spectrogram_bins, sample_rate, fmin, fmax,
                device):
    return torch.as_tensor(mel_ops.linear_to_mel_weight_matrix(
        num_mel_bins=num_mel_bins, num_spectrogram_bins=num_spectrogram_bins,
        sample_rate=sample_rate, lower_edge_hertz=fmin,
        upper_edge_hertz=fmax), device=device)


def linear_to_mel(S, sample_rate, num_mel_bins=40, fmin=0.0, fmax=8000.0,
                  precision="highest"):
    """Project spectrogram bins onto the HTK mel filterbank
    (reference: lidbox/features/audio.py:247-261)."""
    weights = _mel_tensor(num_mel_bins, S.shape[-1], sample_rate,
                          float(fmin), float(fmax), S.device)
    return torch.matmul(dsp_operand(S, precision),
                        dsp_operand(weights, precision))


@functools.lru_cache(maxsize=16)
def _dct_tensor(num_mel, device):
    # tf.signal's type-II DCT scale 1/sqrt(2N), with NO sqrt(2)
    # correction of coefficient 0 (unlike scipy's 'ortho' norm)
    n = np.arange(num_mel, dtype=np.float64)
    basis = 2.0 * np.cos(np.pi * n[None, :] * (2.0 * n[:, None] + 1.0)
                         / (2.0 * num_mel))
    basis *= 1.0 / np.sqrt(2.0 * num_mel)
    return torch.as_tensor(basis, dtype=torch.float32, device=device)


def mfcc(log_mel, coef_begin=1, coef_end=13):
    """MFCCs from log-mel as tf.signal.mfccs_from_log_mel_spectrograms
    computes them (reference: lidbox/data/tf_utils.py:178-184), sliced to
    [coef_begin, coef_end)."""
    coeffs = torch.matmul(log_mel, _dct_tensor(log_mel.shape[-1],
                                               log_mel.device))
    return coeffs[..., coef_begin:coef_end]

"""Log-Mel features as lidbox defines them (tf.signal semantics).

Frames of ``frame_length`` samples every ``frame_step``, no end padding;
periodic Hann window; the first ``fft_length`` samples of each frame
zero-padded to ``fft_length`` and transformed; power spectrum |X|^2; HTK mel
filterbank (lidbox's vendored TF construction, whose linspace divides by
``num`` and not ``num - 1``, with the DC bin zeroed); ``log(mel + 1e-6)``.
"""
import math

import numpy as np
import torch


def ms_to_samples(sample_rate, ms):
    return int(sample_rate * 1e-3 * ms)


def num_frames(num_samples, frame_length, frame_step):
    return max(0, 1 + (int(num_samples) - frame_length) // frame_step)


def _hz_to_mel(f):
    return 1127.0 * np.log1p(np.asarray(f, np.float64) / 700.0)


def _linspace(start, stop, num):
    return start + (stop - start) * np.arange(num, dtype=np.float64) / num


def mel_matrix(num_mel_bins, num_spectrogram_bins, sample_rate, fmin, fmax):
    """[num_spectrogram_bins, num_mel_bins] float64 triangular filterbank."""
    freqs = _linspace(0.0, sample_rate / 2.0, num_spectrogram_bins)[1:]
    bins_mel = _hz_to_mel(freqs)[:, None]
    edges = _linspace(_hz_to_mel(fmin), _hz_to_mel(fmax), num_mel_bins + 2)
    lower, center, upper = (edges[None, i:i + num_mel_bins] for i in range(3))
    up = (bins_mel - lower) / (center - lower)
    down = (upper - bins_mel) / (upper - center)
    weights = np.maximum(0.0, np.minimum(up, down))
    return np.concatenate([np.zeros((1, num_mel_bins)), weights])


def hann_periodic(length):
    n = np.arange(length, dtype=np.float64)
    denom = length + (1 - length % 2) - 1
    return 0.5 - 0.5 * np.cos(2.0 * math.pi * n / denom)


def logmel(signals, sample_rate, frame_length_ms=25, frame_step_ms=10,
           fft_length=512, num_mel_bins=64, fmin=0.0, fmax=8000.0):
    """[B, T] waveforms (a float64 tensor) -> [B, frames, num_mel_bins]."""
    fl = ms_to_samples(sample_rate, frame_length_ms)
    fs = ms_to_samples(sample_rate, frame_step_ms)
    x = signals.to(torch.float64)
    frames = x.unfold(-1, fl, fs)[..., :fft_length]
    window = torch.as_tensor(hann_periodic(fl)[:frames.shape[-1]],
                             device=x.device)
    spectrum = torch.fft.rfft(frames * window, n=fft_length, dim=-1)
    power = spectrum.real ** 2 + spectrum.imag ** 2
    mel = torch.as_tensor(mel_matrix(num_mel_bins, fft_length // 2 + 1,
                                     sample_rate, fmin, fmax), device=x.device)
    return torch.log(power @ mel + 1e-6)


def logmel_of(signal, features):
    """One 1-D float64 signal through ``logmel`` with a configuration's
    ``features`` section -> [frames, num_mel_bins]."""
    return logmel(signal[None, :], **feature_args(features))[0]


def feature_args(features):
    return {k: features[k] for k in (
        "sample_rate", "frame_length_ms", "frame_step_ms", "fft_length",
        "num_mel_bins", "fmin", "fmax")}

"""Energy VAD with silence removal, as lidbox's ``remove_silence``.

The signal is cut into windows of ``frame_ms`` (a partial tail window is
dropped); a window is voiced when its RMS exceeds ``strength`` times the
mean window RMS (that mean clipped below at ``min_rms``); runs of unvoiced
windows shorter than ``min_non_speech_ms`` count as voiced; the voiced
windows are kept in order and the rest dropped.
"""
import numpy as np
import torch


def voiced_windows(signal, sample_rate, frame_ms=10, min_non_speech_ms=300,
                   strength=0.1, min_rms=1e-3):
    """Bool numpy array, one decision per whole window of a 1-D tensor."""
    w = int(sample_rate * 1e-3 * frame_ms)
    n = signal.shape[0] // w
    rms = torch.sqrt(torch.mean(signal[:n * w].reshape(n, w) ** 2, dim=1))
    threshold = strength * torch.clamp(torch.mean(rms), min=min_rms)
    voiced = (rms > threshold).cpu().numpy()
    shortest = int(sample_rate * 1e-3 * min_non_speech_ms) // w
    start = 0
    while start < n:
        end = start
        while end < n and voiced[end] == voiced[start]:
            end += 1
        if not voiced[start] and end - start < shortest:
            voiced[start:end] = True
        start = end
    return voiced


def remove_silence(signal, sample_rate, frame_ms=10, min_non_speech_ms=300,
                   strength=0.1):
    """The voiced windows of a 1-D tensor, concatenated in order."""
    w = int(sample_rate * 1e-3 * frame_ms)
    voiced = voiced_windows(signal, sample_rate, frame_ms, min_non_speech_ms,
                            strength)
    n = voiced.size
    keep = torch.as_tensor(np.flatnonzero(voiced), device=signal.device)
    return signal[:n * w].reshape(n, w)[keep].reshape(-1)

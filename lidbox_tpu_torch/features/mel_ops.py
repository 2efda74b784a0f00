"""
Mel filterbank construction in pure numpy (a copy of
``lidbox_tpu.features.mel_ops``; the port imports nothing of lidbox_tpu).

Numerically matches the reference's vendored TF mel matrix
(reference: lidbox/features/mel_ops.py:11-75), which is the HTK-style
tf.signal construction with one quirk: it uses a *non-standard* linspace
``start + (stop - start) * arange(num) / num`` (dividing by ``num`` instead
of ``num - 1``) for both the linear frequency grid and the mel band edges
(reference: lidbox/features/mel_ops.py:11-16). We reproduce that exactly so
log-Mel features agree with the reference to float32 precision.

The matrix is a constant for any fixed
(num_mel_bins, num_spectrogram_bins, sample_rate, fmin, fmax) tuple, so we
build it with numpy and memoize.
"""
import functools

import numpy as np

MEL_BREAK_FREQUENCY_HERTZ = 700.0
MEL_HIGH_FREQUENCY_Q = 1127.0


def _tf_compat_linspace(start, stop, num):
    """start + (stop - start) * i / num  for i in [0, num).

    NOT numpy.linspace: the step divides by num, not num - 1
    (reference: lidbox/features/mel_ops.py:11-16).
    """
    return start + (stop - start) * np.arange(num, dtype=np.float64) / num


def hertz_to_mel(frequencies_hertz):
    """HTK mel scale: 1127 * ln(1 + f / 700)."""
    return MEL_HIGH_FREQUENCY_Q * np.log1p(
        np.asarray(frequencies_hertz, np.float64) / MEL_BREAK_FREQUENCY_HERTZ)


def mel_to_hertz(mels):
    return MEL_BREAK_FREQUENCY_HERTZ * np.expm1(
        np.asarray(mels, np.float64) / MEL_HIGH_FREQUENCY_Q)


@functools.lru_cache(maxsize=64)
def linear_to_mel_weight_matrix(num_mel_bins=20,
                                num_spectrogram_bins=129,
                                sample_rate=8000,
                                lower_edge_hertz=125.0,
                                upper_edge_hertz=3800.0,
                                dtype=np.float32):
    """[num_spectrogram_bins, num_mel_bins] triangular mel filterbank.

    HTK convention: the spectrogram DC bin is excluded (zero row), triangles
    are linear in the mel domain (reference: lidbox/features/mel_ops.py:28-75).
    """
    # HTK excludes the spectrogram DC bin.
    bands_to_zero = 1
    nyquist_hertz = sample_rate / 2.0
    linear_frequencies = _tf_compat_linspace(
        0.0, nyquist_hertz, num_spectrogram_bins)[bands_to_zero:]
    spectrogram_bins_mel = hertz_to_mel(linear_frequencies)[:, np.newaxis]

    # num_mel_bins + 2 edges -> sliding triples (lower, center, upper);
    # the center of each band is the edge of its neighbours.
    band_edges_mel = _tf_compat_linspace(
        hertz_to_mel(lower_edge_hertz),
        hertz_to_mel(upper_edge_hertz),
        num_mel_bins + 2)
    lower_edge_mel = band_edges_mel[np.newaxis, 0:num_mel_bins]
    center_mel = band_edges_mel[np.newaxis, 1:num_mel_bins + 1]
    upper_edge_mel = band_edges_mel[np.newaxis, 2:num_mel_bins + 2]

    # Up/down slopes of each triangle, intersected with each other and zero.
    lower_slopes = (spectrogram_bins_mel - lower_edge_mel) / (
        center_mel - lower_edge_mel)
    upper_slopes = (upper_edge_mel - spectrogram_bins_mel) / (
        upper_edge_mel - center_mel)
    weights = np.maximum(0.0, np.minimum(lower_slopes, upper_slopes))

    # Re-add the zeroed DC row sliced out above.
    weights = np.pad(weights, [[bands_to_zero, 0], [0, 0]])
    return weights.astype(dtype)

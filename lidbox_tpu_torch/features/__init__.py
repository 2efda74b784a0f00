"""
Feature normalization and the feature-type dispatcher, in PyTorch
(counterpart of ``lidbox_tpu.features``).

Features are ``[B, frames, channels]`` tensors and frame masks
``[B, frames]``, the JAX package's layouts. The masked variants reproduce
each row's unpadded numerics on a zero-padded batch.
"""
import numpy as np
import torch
import torch.nn.functional as F

from lidbox_tpu_torch import get_logger

from . import audio
from . import mel_ops  # noqa: F401  (re-export)


def divide_no_nan(x, y):
    """x / y, 0 where y == 0 (tf.math.divide_no_nan semantics)."""
    safe = torch.where(y == 0, torch.ones_like(y), y)
    return torch.where(y == 0, torch.zeros_like(x), x / safe)


def _dims(X, axis):
    return tuple(range(X.dim())) if axis is None else axis


def feature_scaling(X, min, max, axis=None):
    """Min-max scale X into [min, max] over the given axis
    (reference: lidbox/features/__init__.py:5-9)."""
    X_min = torch.amin(X, dim=_dims(X, axis), keepdim=True)
    X_max = torch.amax(X, dim=_dims(X, axis), keepdim=True)
    return min + (max - min) * divide_no_nan(X - X_min, X_max - X_min)


def cmn(X, axis=1):
    """Cepstral mean normalization (reference: lidbox/features/__init__.py:12-20)."""
    return X - torch.mean(X, dim=axis, keepdim=True)


def cmvn(X, axis=1):
    """Cepstral mean and variance normalization, with the population std
    of the unnormalized input (reference: lidbox/features/__init__.py:22-32)."""
    return divide_no_nan(cmn(X, axis=axis),
                         torch.std(X, dim=axis, correction=0, keepdim=True))


def _masked_moments(X, mask, axis):
    m = mask.to(X.dtype)
    count = torch.clamp(torch.sum(m, dim=axis, keepdim=True), min=1.0)
    mean = torch.sum(X * m, dim=axis, keepdim=True) / count
    var = torch.sum(torch.square(X - mean) * m, dim=axis, keepdim=True) / count
    return mean, var


def _zero_outside(mask, X):
    return torch.where(mask, X, torch.zeros_like(X))


def cmn_masked(X, mask, axis=1):
    """CMN over valid frames only (``mask`` broadcastable to X, True on
    real frames); padded frames are zeroed."""
    mean, _ = _masked_moments(X, mask, axis)
    return _zero_outside(mask, X - mean)


def cmvn_masked(X, mask, axis=1):
    """CMVN over valid frames only; padded frames are zeroed."""
    mean, var = _masked_moments(X, mask, axis)
    return _zero_outside(mask, divide_no_nan(X - mean, torch.sqrt(var)))


def feature_scaling_masked(X, min, max, mask):
    """Per-sample min-max scaling over valid frames only (``mask``
    broadcastable to X, e.g. [B, T, 1]); padded frames are zeroed."""
    dims = tuple(range(1, X.dim()))
    inf = torch.tensor(float("inf"), dtype=X.dtype, device=X.device)
    X_min = torch.amin(torch.where(mask, X, inf), dim=dims, keepdim=True)
    X_max = torch.amax(torch.where(mask, X, -inf), dim=dims, keepdim=True)
    out = min + (max - min) * divide_no_nan(X - X_min, X_max - X_min)
    return _zero_outside(mask, out)


def _sliding_mean(Xp, window_len):
    """Mean over each ``window_len`` window of the time axis of
    [B, Tp, F] -> [B, Tp - window_len + 1, F]."""
    return F.avg_pool1d(Xp.transpose(1, 2), window_len, stride=1).transpose(1, 2)


def window_normalization(X, axis=1, window_len=-1, normalize_variance=True):
    """Sliding-window CMVN over the time axis of [B, T, F] features
    (reference: lidbox/features/__init__.py:35-67).

    Boundaries are reflect-padded by window_len//2 on the left and
    window_len//2 - 1 + (window_len & 1) on the right, as in the
    reference; whole-tensor CMN/CMVN when the window covers all frames.
    The variance is taken around a per-(B, F) centering constant to keep
    the sum-of-squares form accurate in float32."""
    if axis != 1:
        raise ValueError("window normalization is defined over the time "
                         "axis of [B, T, F]")
    T = X.shape[1]
    if window_len == -1 or T <= window_len:
        return cmvn(X, axis=axis) if normalize_variance else cmn(X, axis=axis)
    pad_l = window_len // 2
    pad_r = window_len // 2 - 1 + (window_len & 1)
    Xp = F.pad(X.transpose(1, 2), (pad_l, pad_r), mode="reflect").transpose(1, 2)
    mean = _sliding_mean(Xp, window_len)
    out = X - mean
    if normalize_variance:
        center = torch.mean(X, dim=1, keepdim=True)
        sq = _sliding_mean(torch.square(Xp - center), window_len)
        var = torch.clamp(sq - torch.square(mean - center), min=0.0)
        out = divide_no_nan(out, torch.sqrt(var))
    return out


def window_normalization_masked(X, frame_lengths, axis=1, window_len=-1,
                                normalize_variance=True):
    """Per-row exact ``window_normalization`` on a padded batch: row i
    equals ``window_normalization(X[i:i+1, :n_i])`` padded back with zeros
    (``frame_lengths`` [B] valid frame counts). Rows with n_i <= window_len
    take the masked whole-row CMN/CMVN, as the reference does when the
    window covers all frames (reference: lidbox/features/__init__.py:39-43).
    Each row's reflect padding is a gather: padded index q maps to |q| on
    the left bounce and 2(n-1) - q on the right one."""
    if axis != 1:
        raise ValueError("window normalization is defined over the time "
                         "axis of [B, T, F]")
    B, T, C = X.shape
    n = frame_lengths.to(device=X.device, dtype=torch.int64)[:, None]
    mask3 = (torch.arange(T, device=X.device)[None, :] < n)[..., None]
    fallback = (cmvn_masked(X, mask3) if normalize_variance
                else cmn_masked(X, mask3))
    if window_len == -1:
        return fallback
    pad_l = window_len // 2
    pad_r = window_len // 2 - 1 + (window_len & 1)
    q = torch.arange(T + pad_l + pad_r, device=X.device) - pad_l
    idx = torch.abs(q)[None, :]
    idx = torch.where(idx >= n, 2 * (n - 1) - idx, idx)
    idx = torch.clamp(idx, 0, T - 1)
    Xp = torch.gather(X, 1, idx[..., None].expand(B, idx.shape[1], C))
    mean = _sliding_mean(Xp, window_len)
    out = X - mean
    if normalize_variance:
        center, _ = _masked_moments(X, mask3, axis=1)
        sq = _sliding_mean(torch.square(Xp - center), window_len)
        var = torch.clamp(sq - torch.square(mean - center), min=0.0)
        out = divide_no_nan(out, torch.sqrt(var))
    out = torch.where(n[..., None] <= window_len, fallback, out)
    return _zero_outside(mask3, out)


VALID_FEATURE_TYPES = (
    "spectrogram", "db_spectrogram", "melspectrogram",
    "logmelspectrogram", "mfcc",
)


def window_normalization_numpy(X, window_len=-1, normalize_variance=True):
    """Host-side sliding-window CMVN of [B, T, F] numpy features WITHOUT
    boundary padding: windows are clipped at the edges instead of
    reflected (reference: lidbox/features/__init__.py:89-110, kept for
    parity; ``window_normalization`` is the pipeline's)."""
    X = np.asarray(X, np.float32)
    T = X.shape[1]
    if window_len == -1 or T <= window_len:
        centered = X - np.mean(X, axis=1, keepdims=True)
        if normalize_variance:
            centered = centered / np.std(X, axis=1, keepdims=True)
        return centered
    begin = np.clip(np.arange(T) - window_len // 2, 0, T)
    end = np.clip(begin + window_len, 0, T)
    result = np.zeros_like(X)
    for i, (b, e) in enumerate(zip(begin, end)):
        window = X[:, b:e]
        centered = X[:, i] - np.mean(window, axis=1)
        if normalize_variance:
            centered = centered / np.std(window, axis=1)
        result[:, i] = centered
    return result


def _fused_kernel_serves(feature_type, spectrogram, precision):
    """True when the fused log-Mel kernel computes this request: log-mel
    or MFCC features of a power spectrum, in 'highest' or 'bf16'."""
    return (feature_type in ("logmelspectrogram", "mfcc")
            and spectrogram.get("power", 2.0) == 2.0
            and precision in ("highest", "bf16"))


def extract_features(signals, sample_rate, feature_type="logmelspectrogram",
                     spectrogram=None, melspectrogram=None, mfcc=None,
                     db_spectrogram=None, sample_minmax_scaling=None,
                     window_normalization=None, stft_method="fft",
                     lengths=None, precision="highest", return_mask=False):
    """Batched waveforms [B, T] -> features [B, frames, channels]
    (reference: lidbox/data/tf_utils.py:166-195): power spectrogram, then
    by ``feature_type`` dB scaling, mel projection, log(mel + 1e-6) or
    MFCCs sliced to [coef_begin, coef_end); optional per-sample min-max
    scaling and sliding-window normalization.

    ``stft_method``: ``"fft"`` (torch.fft), ``"matmul"`` (windowed-DFT
    basis matmul) or ``"pallas"``, the name the JAX package's configs use
    for the fused kernel: log-Mel/MFCC requests then go through
    ``ops.logmel.fused_logmel`` (the CUDA kernel on a CUDA tensor, its
    plain version on a CPU tensor). Requests the kernel does not compute
    are logged and take ``"matmul"``.

    ``lengths`` [B] (valid sample counts of a zero-padded batch) switches
    min-max scaling and window normalization to their masked variants;
    padded frames come back zeroed. ``return_mask`` also returns the
    [B, frames] frame mask (None without ``lengths``)."""
    if feature_type not in VALID_FEATURE_TYPES:
        raise ValueError(f"unknown feature type {feature_type!r}; valid: "
                         f"{VALID_FEATURE_TYPES}")
    spectrogram = spectrogram or {}
    if stft_method == "pallas" and not _fused_kernel_serves(
            feature_type, spectrogram, precision):
        get_logger("features").info(
            "stft_method='pallas' unavailable for this request "
            "(feature_type=%s, precision=%s, backend=%s) — using 'matmul'",
            feature_type, precision, signals.device.type)
        stft_method = "matmul"
    if stft_method == "pallas":
        from lidbox_tpu_torch.ops import logmel as _logmel
        mel_kw = dict(melspectrogram or {})
        X = _logmel.fused_logmel(
            signals, sample_rate,
            frame_length_ms=spectrogram.get("frame_length_ms", 25),
            frame_step_ms=spectrogram.get("frame_step_ms", 10),
            fft_length=spectrogram.get("fft_length", 512),
            num_mel_bins=mel_kw.get("num_mel_bins", 40),
            fmin=mel_kw.get("fmin", 0.0), fmax=mel_kw.get("fmax", 8000.0),
            precision=precision)
        if feature_type == "mfcc":
            kw = dict(mfcc or {})
            X = audio.mfcc(X, coef_begin=kw.pop("coef_begin", 1),
                           coef_end=kw.pop("coef_end", 13))
    else:
        S = audio.spectrograms(signals, sample_rate, method=stft_method,
                               precision=precision, **spectrogram)
        if feature_type == "spectrogram":
            X = S
        elif feature_type == "db_spectrogram":
            X = audio.power_to_db(S, **(db_spectrogram or {}))
        else:
            X = audio.linear_to_mel(S, sample_rate, precision=precision,
                                    **(melspectrogram or {}))
            if feature_type in ("logmelspectrogram", "mfcc"):
                X = torch.log(X + 1e-6)
                if feature_type == "mfcc":
                    kw = dict(mfcc or {})
                    X = audio.mfcc(X, coef_begin=kw.pop("coef_begin", 1),
                                   coef_end=kw.pop("coef_end", 13))
    frame_mask = frame_lengths = None
    if lengths is not None:
        fl = audio.ms_to_frames(sample_rate,
                                spectrogram.get("frame_length_ms", 25))
        fs = audio.ms_to_frames(sample_rate,
                                spectrogram.get("frame_step_ms", 10))
        lengths = torch.as_tensor(lengths, dtype=torch.int64,
                                  device=X.device)
        frame_mask = frame_mask_from_lengths(lengths, X.shape[1], fl, fs)
        frame_lengths = frame_mask.sum(dim=1)
    if sample_minmax_scaling:
        lo = sample_minmax_scaling.get("min", 0.0)
        hi = sample_minmax_scaling.get("max", 1.0)
        if frame_mask is not None:
            X = feature_scaling_masked(X, lo, hi, frame_mask[..., None])
        else:
            X = feature_scaling(X, lo, hi, axis=tuple(range(1, X.dim())))
    if window_normalization:
        if frame_lengths is not None:
            X = window_normalization_masked(X, frame_lengths,
                                            **window_normalization)
        else:
            X = globals()["window_normalization"](X, **window_normalization)
    if frame_mask is not None:
        X = _zero_outside(frame_mask[..., None], X)
    if return_mask:
        return X, frame_mask
    return X


def frame_mask_from_lengths(lengths, num_frames, frame_length, frame_step):
    """[B] sample lengths -> [B, num_frames] bool mask of the frames that
    lie entirely inside each unpadded signal (tf.signal's frame count)."""
    starts = torch.arange(num_frames, device=lengths.device) * frame_step
    return (starts[None, :] + frame_length) <= lengths[:, None]


def num_non_finite(X):
    """Count of NaN/Inf entries (reference sanitization analogue:
    lidbox/data/steps.py:897-919)."""
    return torch.sum(~torch.isfinite(X))


def load_tensor_from_kaldi_archive(ark_key):
    """Load a float32 matrix from a Kaldi archive key
    (reference: lidbox/features/__init__.py:113-118). Uses kaldiio when
    installed (covers compressed matrices); otherwise the built-in binary
    ark reader (features.kaldi_io)."""
    try:
        import kaldiio
        return np.asarray(kaldiio.load_mat(str(ark_key)), np.float32)
    except ImportError:
        from lidbox_tpu_torch.features import kaldi_io
        return np.asarray(kaldi_io.read_mat(str(ark_key)), np.float32)

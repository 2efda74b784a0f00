"""
Audio DSP in PyTorch: the subset of ``lidbox_tpu.features.audio`` that
feature extraction, the data pipeline and the on-device augmentation chain
need (framing, periodic Hann window, STFT, power spectrograms, mel
projection, dB scaling and its inverse, FFT bin frequencies, MFCC; peak
normalization, RMS levels, the SNR mixer, FIR filtering, run-length
smoothing and the energy VAD).

Numerics follow tf.signal as the JAX package does (within 1e-4).

Precision modes of the matmul DSP path (``precision=``):

- ``"highest"``: float32 operands and float32 products. On a CUDA device
  the caller keeps TF32 off (``torch.backends.cuda.matmul.allow_tf32`` is
  False by default) or the 1e-4 budget does not hold.
- ``"bf16"``: operands rounded to bfloat16, products accumulated in
  float32 (the rounding points of the JAX package's 1-pass mode).
- ``"bf16_3x"`` / ``"bf16_6x"``: XLA's ``BF16_BF16_F32_X3`` / ``_X6``
  split products. Each operand is split into bfloat16 pieces, a = a1 + a2
  (+ a3), and the products of the pieces that matter are summed in
  float32, the smallest first: a1 b1 + a1 b2 + a2 b1 for 3x, those and
  a1 b3 + a2 b2 + a3 b1 for 6x. The pieces are float32 tensors holding
  bfloat16 values, so each piece product is exact in float32 (and in
  TF32, whose 10-bit mantissa holds bfloat16's 8 bits) and accumulates in
  float32. The JAX package's budget for 3x is a log-Mel error of about
  1.5e-3 against float64 (``lidbox_tpu/features/audio.py:199-210``).
"""
import contextlib
import functools
import threading

import numpy as np
import torch
import torch.nn.functional as F

from lidbox_tpu_torch import get_device, parallel

from . import mel_ops

_holding = threading.local()


@contextlib.contextmanager
def holding_constants(held):
    """Within it, every cached device constant read on this thread (a
    ``device_constant`` function's result, the log-Mel kernel's tiles) is
    appended to the list ``held``. A CUDA graph captured within reads
    their addresses: keeping ``held`` as long as the graph keeps them
    alive when their caches drop them."""
    outer = getattr(_holding, "held", None)
    _holding.held = held
    try:
        yield held
    finally:
        _holding.held = outer


def hold(value):
    """``value``, appended to the list of the enclosing
    ``holding_constants`` on this thread, if any."""
    held = getattr(_holding, "held", None)
    if held is not None:
        held.append(value)
    return value


def device_constant(fn):
    """``functools.lru_cache(maxsize=16)`` of ``fn``, a function returning
    a constant tensor on a device, whose every result is also ``hold``-ed:
    a captured graph keeps what it reads alive after an eviction."""
    cached = functools.lru_cache(maxsize=16)(fn)

    @functools.wraps(fn)
    def wrapper(*args):
        return hold(cached(*args))
    wrapper.cache_clear = cached.cache_clear
    wrapper.cache_info = cached.cache_info
    return wrapper


# precision mode -> (pieces per operand, (i, j) piece products summed,
# smallest first)
_SPLIT_PRODUCTS = {
    "highest": (1, ((0, 0),)),
    "bf16": (1, ((0, 0),)),
    "bf16_3x": (2, ((1, 0), (0, 1), (0, 0))),
    "bf16_6x": (3, ((2, 0), (1, 1), (0, 2), (1, 0), (0, 1), (0, 0))),
}
DSP_PRECISIONS = tuple(_SPLIT_PRODUCTS)


def _bf16_pieces(x, n):
    """x = sum of n float32 tensors holding bfloat16 values (the last one
    holds what the bfloat16 pieces before it left)."""
    pieces = []
    for _ in range(n):
        piece = x.to(torch.bfloat16).to(torch.float32)
        pieces.append(piece)
        x = x - piece
    return pieces


def dsp_matmul(a, b, precision):
    """``a @ b`` in a DSP precision mode (module doc): "highest" as it
    is, "bf16" on operands rounded to bfloat16, the split modes as sums of
    bfloat16 piece products; every product accumulates in float32."""
    if precision not in _SPLIT_PRODUCTS:
        raise ValueError(f"unknown DSP precision {precision!r}; "
                         f"valid: {DSP_PRECISIONS}")
    if precision == "highest":
        return torch.matmul(a, b)
    n, products = _SPLIT_PRODUCTS[precision]
    a_pieces, b_pieces = _bf16_pieces(a, n), _bf16_pieces(b, n)
    out = None
    for i, j in products:
        term = torch.matmul(a_pieces[i], b_pieces[j])
        out = term if out is None else out + term
    return out


def dBFS_to_linear(level):
    """10^(dB/20) as a float32 tensor (reference: lidbox/features/audio.py:50-52)."""
    return torch.pow(10.0, torch.as_tensor(level, dtype=torch.float32) / 20.0)


def ms_to_frames(sample_rate, ms):
    """Milliseconds to sample count (reference: lidbox/features/audio.py:185-189)."""
    return int(sample_rate * 1e-3 * ms)


def log10(x):
    return torch.log(x) / np.float32(np.log(10.0))


def peak_normalize(signal, dBFS=0.0):
    """Scale so the peak amplitude sits at the given dBFS level, on the
    signal's device (reference: lidbox/features/audio.py:55-60). An
    all-zero signal returns zeros instead of 0/0 = NaN."""
    peak = torch.max(torch.abs(signal))
    safe = torch.where(peak == 0, torch.ones_like(peak), peak)
    scaled = torch.where(peak == 0, torch.zeros_like(signal), signal / safe)
    return dBFS_to_linear(dBFS).to(signal.device) * scaled


def db_to_power(S):
    """(reference: lidbox/features/audio.py:177-181)"""
    return torch.pow(10.0, S / 20.0)


def fft_frequencies(sample_rate, n_fft, device="cuda"):
    """Center frequency of each rFFT bin as a float32 tensor on ``device``,
    equal to librosa.fft_frequencies
    (reference: lidbox/features/audio.py:151-159)."""
    return torch.as_tensor(
        np.linspace(0.0, sample_rate // 2, 1 + n_fft // 2), dtype=torch.float32,
        device=get_device(device))


def root_mean_square(x, axis=-1, keepdims=False):
    """sqrt(mean(|x|^2)) (reference: lidbox/features/audio.py:264-271)."""
    return torch.sqrt(torch.mean(torch.square(torch.abs(x)), dim=axis,
                                 keepdim=keepdims))


def _masked_rms(x, mask, axis=-1, keepdims=False):
    """RMS over the elements where ``mask`` is True."""
    mask = mask.to(x.dtype)
    total = torch.sum(torch.square(x) * mask, dim=axis, keepdim=keepdims)
    count = torch.clamp(torch.sum(mask, dim=axis, keepdim=keepdims), min=1.0)
    return torch.sqrt(total / count)


def power_to_db(S, amin=1e-10, top_db=80.0):
    """Power/amplitude to decibel with a dynamic-range floor, with the
    reference's 20*log10 and *global* max over the whole batched tensor
    (reference: lidbox/features/audio.py:167-174): inside
    ``parallel.data_parallel`` the global batch's."""
    amin = torch.tensor(amin, dtype=S.dtype, device=S.device)
    db = 20.0 * (log10(torch.maximum(amin, S))
                 - log10(torch.maximum(amin, parallel.global_max(S))))
    return torch.maximum(db, parallel.global_max(db) - top_db)


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


def blackman_window(window_length, periodic=True, alpha=0.16,
                    dtype=torch.float32):
    """Cosine-sum Blackman window with hann_window's denominator
    (reference: lidbox/features/audio.py:192-216)."""
    if window_length <= 1:
        raise ValueError("unit length window not supported")
    a0, a1, a2 = (1 - alpha) / 2, 0.5, alpha / 2
    even = 1 - window_length % 2
    n = window_length + int(periodic) * even - 1
    count = np.arange(window_length, dtype=np.float64)
    w = (a0 - a1 * np.cos(2.0 * np.pi * count / n)
         + a2 * np.cos(4.0 * np.pi * count / n))
    return torch.as_tensor(w, dtype=dtype)


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


@device_constant
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
        out = dsp_matmul(frames, basis, precision)
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


@device_constant
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
    return dsp_matmul(S, weights, precision)


def melspectrograms(S, sample_rate, num_mel_bins=40, fmin=0.0, fmax=8000.0):
    """Alias for linear_to_mel: the reference pipeline called
    ``audio_features.melspectrograms``, which it never defined
    (reference: lidbox/data/tf_utils.py:175 vs lidbox/features/audio.py:253)."""
    return linear_to_mel(S, sample_rate, num_mel_bins=num_mel_bins, fmin=fmin,
                         fmax=fmax)


@functools.lru_cache(maxsize=16)
def _kept_bins(sample_rate, fft_length, fmin, fmax):
    freqs = np.linspace(0.0, sample_rate // 2, 1 + fft_length // 2)
    return np.flatnonzero((fmin <= freqs) & (freqs <= fmax))


def drop_frequency_bins(S, sample_rate, fft_length, fmin, fmax):
    """Keep the fft bins of [B, T, bins] inside [fmin, fmax]
    (reference: lidbox/features/audio.py:233-244); the band depends only
    on the configuration, so only the band is cached."""
    keep = _kept_bins(sample_rate, fft_length, fmin, fmax)
    return torch.index_select(S, 2, torch.as_tensor(keep, device=S.device))


@device_constant
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


# ---------------------------------------------------------------------------
# Augmentation
# ---------------------------------------------------------------------------

def snr_mixer(clean, noise, snr):
    """Mix ``noise`` into ``clean`` at ``snr`` dB, MS-SNSD style: both
    normalized to -25 dBFS first (reference: lidbox/features/audio.py:124-148).

    Returns (clean_norm, noise_at_new_level, noisy_speech)."""
    scalarclean = dBFS_to_linear(-25.0) / root_mean_square(clean)
    clean_norm = scalarclean * clean
    rmsclean = root_mean_square(clean_norm)

    scalarnoise = dBFS_to_linear(-25.0) / root_mean_square(noise)
    noise_norm = scalarnoise * noise
    rmsnoise = root_mean_square(noise_norm)

    level = dBFS_to_linear(snr)
    noisescalar = torch.sqrt(rmsclean / level / rmsnoise)
    noisenewlevel = noisescalar * noise_norm
    return clean_norm, noisenewlevel, clean_norm + noisenewlevel


def snr_mixer_batch(clean, noise, snr, mask=None):
    """Batched, mask-aware SNR mixer over [B, T] signals: ``mask`` marks the
    valid samples of ``clean`` and the RMS statistics ignore the rest, so a
    padded row mixes as its unpadded slice would. ``snr`` is [B] dB values;
    padding comes back zero."""
    if mask is None:
        mask = torch.ones_like(clean, dtype=torch.bool)
    rms_c = _masked_rms(clean, mask, axis=-1, keepdims=True)
    clean_norm = clean * (dBFS_to_linear(-25.0) / rms_c)
    rmsclean = _masked_rms(clean_norm, mask, axis=-1, keepdims=True)

    rms_n = _masked_rms(noise, mask, axis=-1, keepdims=True)
    noise_norm = noise * (dBFS_to_linear(-25.0) / rms_n)
    rmsnoise = _masked_rms(noise_norm, mask, axis=-1, keepdims=True)

    level = dBFS_to_linear(snr).to(clean.device)[:, None]
    noisescalar = torch.sqrt(rmsclean / level / rmsnoise)
    noisy = clean_norm + noisescalar * noise_norm
    return torch.where(mask, noisy, torch.zeros_like(noisy))


def fir_filter(signal, fir):
    """Causal FIR filtering, equal to scipy.signal.lfilter(fir, 1.0, signal)
    (reference: lidbox/features/audio.py:63-74): a signal [T] with taps [K],
    or rows [B, T] each with its own taps [B, K] (one grouped conv1d).
    conv1d is a cross-correlation, so the taps are flipped."""
    num_coefs = fir.shape[-1]
    x = F.pad(signal, (num_coefs - 1, 0)).reshape(1, -1, signal.shape[-1]
                                                   + num_coefs - 1)
    w = fir.flip(-1).reshape(-1, 1, num_coefs)
    return F.conv1d(x, w, groups=w.shape[0]).reshape(signal.shape)


def random_gaussian_fir_filter(generator, signal, num_coefs):
    """Random-normal FIR channel simulation (reference:
    lidbox/features/audio.py:63-74), taps drawn from ``generator``."""
    fir = torch.randn(num_coefs, generator=generator, device=signal.device,
                      dtype=signal.dtype)
    return fir_filter(signal, fir)


# ---------------------------------------------------------------------------
# Run-length tools and VAD
# ---------------------------------------------------------------------------

def _run_ids(v):
    """Change points and run labels along the last axis: a run starts
    wherever a value differs from its predecessor."""
    first = torch.ones(v.shape[:-1] + (1,), dtype=torch.bool, device=v.device)
    change = torch.cat([first, v[..., 1:] != v[..., :-1]], dim=-1)
    return change, torch.cumsum(change, dim=-1) - 1


def run_length_encoding(v):
    """Positions and lengths of the equal-value runs of a [T] vector
    (reference: lidbox/features/audio.py:274-283), as fixed-shape [T]
    tensors (pos, lengths, num_runs): entries at index >= num_runs are
    padding."""
    v = torch.as_tensor(v)
    t = v.shape[0]
    change, run_id = _run_ids(v)
    num_runs = run_id[-1] + 1
    lengths = torch.zeros(t, dtype=torch.int64, device=v.device).index_add_(
        0, run_id, torch.ones(t, dtype=torch.int64, device=v.device))
    ar = torch.arange(t, device=v.device)
    pos = torch.sort(torch.where(change, ar, t)).values
    pos = torch.where(ar < num_runs, pos, torch.zeros_like(pos))
    return pos, lengths, num_runs


def invert_too_short_consecutive_false(mask, min_length):
    """Flip the False runs shorter than ``min_length`` along the last axis
    to True (VAD smoothing, reference: lidbox/features/audio.py:286-296):
    each run's length is scattered to its label and gathered back."""
    if min_length <= 0:
        return mask
    _, run_id = _run_ids(mask)
    run_len = torch.zeros_like(run_id).scatter_add_(-1, run_id,
                                                    torch.ones_like(run_id))
    return mask | (torch.gather(run_len, -1, run_id) < min_length)


def framewise_rms_energy_vad_decisions(signal, sample_rate, frame_step_ms,
                                       min_non_speech_ms=0, strength=0.05,
                                       min_rms_threshold=1e-3):
    """Energy VAD of one [T] waveform: True for the frames whose RMS exceeds
    strength * mean RMS (reference: lidbox/features/audio.py:299-329)."""
    frame_step = ms_to_frames(sample_rate, frame_step_ms)
    rms = root_mean_square(frame(signal, frame_step, frame_step, axis=0),
                           axis=1)
    threshold = strength * torch.clamp(torch.mean(rms), min=min_rms_threshold)
    min_frames = ms_to_frames(sample_rate, min_non_speech_ms) // frame_step
    return invert_too_short_consecutive_false(rms > threshold, min_frames)


def framewise_rms_energy_vad_decisions_batch(signals, lengths, sample_rate,
                                             frame_step_ms, min_non_speech_ms=0,
                                             strength=0.05,
                                             min_rms_threshold=1e-3):
    """Batched, padding-aware energy VAD over [B, T] signals with valid
    sample counts ``lengths`` [B]: the mean RMS covers valid frames only,
    so a padded row decides as its unpadded slice would. Returns
    [B, frames] bool, False on padded frames."""
    frame_step = ms_to_frames(sample_rate, frame_step_ms)
    frames = frame(signals, frame_step, frame_step, axis=-1)  # [B, F, L]
    starts = torch.arange(frames.shape[1], device=signals.device) * frame_step
    valid = (starts[None, :] + frame_step) <= lengths[:, None]
    rms = root_mean_square(frames, axis=2)
    vmask = valid.to(rms.dtype)
    mean_rms = torch.sum(rms * vmask, dim=1, keepdim=True) / torch.clamp(
        torch.sum(vmask, dim=1, keepdim=True), min=1.0)
    threshold = strength * torch.clamp(mean_rms, min=min_rms_threshold)
    decisions = (rms > threshold) & valid
    min_frames = ms_to_frames(sample_rate, min_non_speech_ms) // frame_step
    if min_frames > 0:
        # padding is marked True before smoothing, so a short non-speech run
        # at the end of the real signal keeps its own length instead of
        # merging with the padding's False run; then masked again
        decisions = invert_too_short_consecutive_false(
            decisions | ~valid, min_frames) & valid
    return decisions


def compact_voiced(windows, vad):
    """Voiced windows to the front, in order: windows [..., F, W] and
    decisions [..., F] -> (samples [..., F * W] with a zero tail, voiced
    window count [...]). A stable sort of (index if voiced else F)."""
    num_windows = vad.shape[-1]
    ar = torch.arange(num_windows, device=vad.device)
    order = torch.argsort(torch.where(vad, ar, num_windows), dim=-1,
                          stable=True)
    compacted = torch.gather(windows, -2,
                             order[..., None].expand(windows.shape))
    keep = torch.sum(vad, dim=-1)
    mask = (ar < keep[..., None])[..., None]
    out = torch.where(mask, compacted, torch.zeros_like(compacted))
    return out.flatten(-2), keep


def remove_silence(signal, rate, window_ms=10, min_non_speech_ms=300):
    """Drop the unvoiced ``window_ms`` windows of one [T] waveform by the
    energy VAD (reference: lidbox/features/audio.py:332-353). Returns
    (voiced windows compacted to the front with a zero tail, number of
    valid samples)."""
    window = (window_ms * rate) // 1000
    vad = framewise_rms_energy_vad_decisions(
        signal=signal, sample_rate=rate, frame_step_ms=window_ms,
        min_non_speech_ms=min_non_speech_ms, strength=0.1)
    trimmed, keep = compact_voiced(frame(signal, window, window, axis=0), vad)
    return trimmed, keep * window

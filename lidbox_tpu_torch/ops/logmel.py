"""
Fused waveform -> log-Mel: the port of the JAX package's Pallas kernel.

Replaces ``lidbox_tpu/ops/logmel.py::_logmel_kernel_packed`` (launched by
``fused_logmel_packed``) with a CUDA C++ kernel for Hopper,
``lidbox_tpu_torch/csrc/logmel.cu``: one launch computes frames ->
Hann-windowed DFT -> power -> HTK mel -> ``log(x + 1e-6)``, and neither the
frame tensor nor the power spectrogram goes to device memory.

What bounds it on the card: operations. At b32 x 4 s (25/10 ms, fft 512,
64 mel) the two products are 5.41 GFLOP against ~11.5 MB of signal in and
log-Mel out. Both run on the tensor cores through warp-level ``mma.sync``:
"highest" as 3xTF32 (m16n8k8, three TF32 products per float32 product,
16.2 GFLOP at 495 TFLOP/s), "bf16" as one bf16 product (m16n8k16, at 989
TFLOP/s). Blocks of 32 frames stage the signal in shared memory with a
row pitch that keeps the fragment loads free of bank conflicts, read the
basis fragments from L2, and keep the power tile on chip for the mel
product (see the source's header).

The host side lives here: ``kernel_bases`` builds the operands (cos and
sin of each bin in adjacent columns, zero-padded to the mma depth),
``split_tf32`` splits "highest" operands into TF32 hi and lo, and
``mma_fragments`` lays them out in the order each lane loads them.

``fused_logmel`` is the wrapper: on a CPU tensor it computes the plain
version, ``logmel_plain``; on a CUDA tensor it launches the kernel or
raises. There is no fallback from one to the other. The kernel is built with
``nvcc`` for ``sm_90a`` into ``lidbox_tpu_torch/_build/`` at first use and
loaded with ctypes; a missing ``nvcc`` or a failed build raises.
"""
import ctypes
import functools
import os
import shutil
import subprocess
import tempfile

import numpy as np
import torch

from lidbox_tpu_torch.features import audio, mel_ops

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "csrc", "logmel.cu")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
LIBRARY = os.path.join(BUILD_DIR, "liblogmel.so")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
MAX_GRID_Y = 65535
# k of one mma.sync: m16n8k8 in TF32, m16n8k16 in bf16
MMA_DEPTH = {False: 8, True: 16}
# No mma of the kernel sits behind a branch, so its operands come in whole
# units of its loops: basis rows in 32-row chunks, bins in 128-bin passes,
# mel columns in rounds of 64 (csrc/logmel.cu).
KERNEL_PADDING = (32, 128, 64)

_lib = None


def _find_nvcc():
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        candidate = os.path.join(home, "bin", "nvcc")
        if os.path.exists(candidate):
            nvcc = candidate
    if nvcc is None:
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin or "
                           "/usr/local/cuda/bin): the log-Mel kernel cannot "
                           "be built")
    return nvcc


def build():
    """Compile ``csrc/logmel.cu`` into ``_build/liblogmel.so`` unless the
    library is newer than the source. Returns the library path."""
    if (os.path.exists(LIBRARY)
            and os.path.getmtime(LIBRARY) >= os.path.getmtime(SOURCE)):
        return LIBRARY
    nvcc = _find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, SOURCE],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, LIBRARY)  # atomic: a concurrent loader never sees half a file
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return LIBRARY


def _load_library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.lidbox_logmel.argtypes = [ptr, ptr, ptr, ptr] + [i32] * 9 + [ptr]
        lib.lidbox_logmel.restype = i32
        lib.lidbox_logmel_variant.argtypes = [i32]
        lib.lidbox_logmel_variant.restype = ctypes.c_char_p
        lib.lidbox_logmel_error_string.argtypes = [i32]
        lib.lidbox_logmel_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _round_up(n, multiple):
    return -(-n // multiple) * multiple


def tf32_rna(x):
    """float32 -> the nearest TF32 value (10 explicit mantissa bits), ties
    away from zero: what ``cvt.rna.tf32.f32`` computes on the card."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split_tf32(x):
    """3xTF32 operand split: ``hi = tf32(x)``, ``lo = tf32(x - hi)``, so
    ``hi + lo`` is ``x`` within 2^-22 relative and every one of the products
    ``hi*hi``, ``hi*lo``, ``lo*hi`` is exact in float32."""
    hi = tf32_rna(x)
    return hi, tf32_rna(np.asarray(x, np.float32) - hi)


@functools.lru_cache(maxsize=16)
def kernel_bases(frame_length, fft_length, num_mel_bins, sample_rate, fmin,
                 fmax, bf16):
    """numpy float32 (W [K, 2 * NB], M [NB, n_mel8]): the kernel's operands
    before they are cut into mma fragments.

    L = min(frame_length, fft_length) basis rows (tf.signal's truncation).
    Only the bins with a nonzero mel weight are kept: the DC bin and, when
    fmax <= rate / 2, the Nyquist bin contribute exactly zero, so dropping
    them changes no value; with fmax above the Nyquist rate the Nyquist bin
    is kept. Bin i's cos and sin columns are W[:, 2i] and W[:, 2i + 1], so
    one mma accumulator fragment holds both parts of a bin. K and NB are L
    and the bin count zero-padded to the mma depth (8 for TF32, 16 for
    bf16); M's mel columns are zero-padded to a multiple of 8. In bf16 mode
    both operands are rounded to bfloat16 here."""
    cos_b, sin_b = audio._windowed_dft_basis(frame_length, fft_length)
    mel = mel_ops.linear_to_mel_weight_matrix(
        num_mel_bins=num_mel_bins, num_spectrogram_bins=fft_length // 2 + 1,
        sample_rate=sample_rate, lower_edge_hertz=fmin, upper_edge_hertz=fmax)
    used = np.flatnonzero(np.any(mel != 0.0, axis=1))
    k0, k1 = (int(used[0]), int(used[-1]) + 1) if used.size else (0, 1)
    rows, bins = min(frame_length, fft_length), k1 - k0
    depth = MMA_DEPTH[bool(bf16)]
    W = np.zeros((_round_up(rows, depth), 2 * _round_up(bins, depth)),
                 np.float32)
    W[:rows, 0:2 * bins:2] = cos_b[:rows, k0:k1]
    W[:rows, 1:2 * bins:2] = sin_b[:rows, k0:k1]
    M = np.zeros((W.shape[1] // 2, _round_up(num_mel_bins, 8)), np.float32)
    M[:bins, :num_mel_bins] = mel[k0:k1]
    if bf16:
        W, M = (torch.from_numpy(a).to(torch.bfloat16).float().numpy()
                for a in (W, M))
    return W, M


def mma_fragments(X, bf16):
    """A [K, N] operand (K a multiple of the mma depth, N of 8) in the order
    the kernel loads it as the B operand of ``mma.sync``: one fragment of 4
    values per (k-step, 8-column tile, lane), [K / depth, N / 8, 32, 4].
    Lane ``4 * g + t`` holds column ``8 * tile + g``:

    - TF32 (m16n8k8): rows t and t + 4 of the k-step, as ``hi`` then ``lo``
      of ``split_tf32``, float32;
    - bf16 (m16n8k16): rows 2t, 2t + 1, 2t + 8, 2t + 9, bfloat16.
    """
    K, N = X.shape
    S, J = K // MMA_DEPTH[bool(bf16)], N // 8
    if bf16:
        f = torch.from_numpy(X).reshape(S, 2, 4, 2, J, 8)
        f = f.permute(0, 4, 5, 2, 1, 3)
        return f.reshape(S, J, 32, 4).to(torch.bfloat16).contiguous()
    parts = [torch.from_numpy(a).reshape(S, 2, 4, J, 8).permute(0, 3, 4, 2, 1)
             for a in split_tf32(X)]
    return torch.cat(parts, dim=-1).reshape(S, J, 32, 4).contiguous()


def _zero_pad(X, rows, cols):
    out = np.zeros((_round_up(X.shape[0], rows), _round_up(X.shape[1], cols)),
                   np.float32)
    out[:X.shape[0], :X.shape[1]] = X
    return out


@functools.lru_cache(maxsize=16)
def _device_bases(key, device):
    """(W fragments, M fragments, K, NB) of one geometry on ``device``,
    zero-padded to ``KERNEL_PADDING``."""
    rows, bins, mel = KERNEL_PADDING
    W, M = kernel_bases(*key)
    W, M = _zero_pad(W, rows, 2 * bins), _zero_pad(M, bins, mel)
    bf16 = key[-1]
    return (mma_fragments(W, bf16).to(device),
            mma_fragments(M, bf16).to(device), W.shape[0], M.shape[0])


def fused_logmel(signals, sample_rate, frame_length_ms=25, frame_step_ms=10,
                 fft_length=512, num_mel_bins=64, fmin=0.0, fmax=8000.0,
                 precision="highest"):
    """[B, T] float32 waveforms -> [B, frames, num_mel_bins] float32 log-Mel.

    CPU tensor: ``logmel_plain``. CUDA tensor: the CUDA kernel (counted in
    ``fused_logmel.launches``), or an exception. Either way a signal that
    requires grad raises: the kernel has no backward. ``precision`` is
    ``"highest"`` (float32) or ``"bf16"`` (bfloat16 operands, float32
    accumulation, power rounded to bfloat16 before the mel product)."""
    if precision not in ("highest", "bf16"):
        raise ValueError(f"fused_logmel computes precision 'highest' or "
                         f"'bf16', not {precision!r}")
    if not isinstance(signals, torch.Tensor) or signals.dim() != 2:
        raise ValueError("signals must be a [batch, samples] tensor")
    if signals.dtype != torch.float32:
        raise ValueError(f"signals must be float32, got {signals.dtype}")
    if signals.requires_grad:
        # the kernel has no backward (nor has the TPU kernel): a gradient
        # that reached the plain version on the CPU would be lost on the card
        raise ValueError("fused_logmel has no gradient: signals must not "
                         "require grad (featurize under torch.no_grad)")
    frame_length = audio.ms_to_frames(sample_rate, frame_length_ms)
    frame_step = audio.ms_to_frames(sample_rate, frame_step_ms)
    if frame_length <= 0 or frame_step <= 0:
        raise ValueError(f"frames of {frame_length} samples every "
                         f"{frame_step} samples are empty")
    B, T = signals.shape
    num_frames = audio.num_frames(T, frame_length, frame_step)
    if num_frames == 0:
        raise ValueError(f"signal of {T} samples is shorter than one "
                         f"{frame_length}-sample frame")
    if signals.device.type == "cpu":
        return logmel_plain(signals, sample_rate, frame_length_ms,
                            frame_step_ms, fft_length, num_mel_bins, fmin,
                            fmax, precision)
    if signals.device.type != "cuda":
        raise ValueError(f"fused_logmel runs on cpu or cuda tensors, not "
                         f"{signals.device.type}")
    lib = _load_library()
    if not signals.is_contiguous():
        raise ValueError("signals must be contiguous")
    if B > MAX_GRID_Y:
        raise ValueError(f"batch {B} exceeds the kernel grid's {MAX_GRID_Y}")
    key = (frame_length, fft_length, int(num_mel_bins), int(sample_rate),
           float(fmin), float(fmax), precision == "bf16")
    W, M, K, NB = _device_bases(key, signals.device)
    L = min(frame_length, fft_length)
    out = torch.empty((B, num_frames, num_mel_bins), dtype=torch.float32,
                      device=signals.device)
    with torch.cuda.device(signals.device):
        stream = torch.cuda.current_stream(signals.device).cuda_stream
        err = lib.lidbox_logmel(
            signals.data_ptr(), W.data_ptr(), M.data_ptr(), out.data_ptr(),
            B, T, num_frames, frame_step, L, K, NB, num_mel_bins,
            int(precision == "bf16"), stream)
    if err != 0:
        raise RuntimeError(f"log-Mel kernel launch failed (basis rows {K}, "
                           f"bins {NB}): "
                           + lib.lidbox_logmel_error_string(err).decode())
    fused_logmel.launches += 1
    return out


fused_logmel.launches = 0


def kernel_variant(precision):
    """The instruction and split the built kernel runs for ``precision``
    (as the library itself reports it)."""
    return _load_library().lidbox_logmel_variant(
        int(precision == "bf16")).decode()


def logmel_plain(signals, sample_rate, frame_length_ms=25, frame_step_ms=10,
                 fft_length=512, num_mel_bins=64, fmin=0.0, fmax=8000.0,
                 precision="highest"):
    """The kernel's function in plain PyTorch: unfold + DFT-basis matmul +
    mel matmul + log, with the same bfloat16 rounding points in ``"bf16"``
    (the analogue of ``lidbox_tpu.ops.logmel_reference``)."""
    S = audio.spectrograms(signals, sample_rate,
                           frame_length_ms=frame_length_ms,
                           frame_step_ms=frame_step_ms,
                           fft_length=fft_length, method="matmul",
                           precision=precision)
    mel = audio.linear_to_mel(S, sample_rate, num_mel_bins=num_mel_bins,
                              fmin=fmin, fmax=fmax, precision=precision)
    return torch.log(mel + 1e-6)

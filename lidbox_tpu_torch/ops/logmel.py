"""
Fused waveform -> log-Mel: the port of the JAX package's Pallas kernel.

Replaces ``lidbox_tpu/ops/logmel.py::_logmel_kernel_packed`` (launched by
``fused_logmel_packed``) with a CUDA C++ kernel for Hopper,
``lidbox_tpu_torch/csrc/logmel.cu``: one launch computes frames ->
Hann-windowed DFT -> power -> HTK mel -> ``log(x + 1e-6)``, and neither the
frame tensor nor the power spectrogram leaves the registers.

What bounds it on the card: operations and the basis stream from L2. At
b32 x 4 s (25/10 ms, fft 512, 64 mel) the two products are 5.41 GFLOP
against ~11.5 MB of signal in and log-Mel out; "highest" runs them as
3xTF32 (16.2 GFLOP at 495 TFLOP/s), "bf16" as one bf16 product (989
TFLOP/s). Every block reads the whole basis (1.7 MB hi|lo in "highest")
from L2, so the frames a block covers set the L2 bytes. Both products run
on ``wgmma`` with A in registers: two consumer warpgroups of 64 frames
share each basis tile, which one producer thread brings into a ring in
shared memory by ``cp.async.bulk`` with ``mbarrier``s; the mel product is
folded into each pass of 32 bins (see the source's header). Where the
frame tiles cannot fill the card, the bin passes are split over blocks and
``split_reduce`` adds their partial mel sums in a fixed order.

The host side lives here: ``kernel_bases`` builds the operands (cos and
sin of each bin in adjacent columns), ``split_tf32`` splits "highest"
operands into TF32 hi and lo, ``basis_tiles`` and ``mel_tiles`` lay them out
as the kernel's wgmma descriptors read them (``core_matrix_order``,
``mel_row_order``), and ``kernel_plan`` sizes the tiles, the signal span in
shared memory, the grid and the split from the card's SM count and
shared memory.

``fused_logmel`` is the wrapper: on a CPU tensor it computes the plain
version, ``logmel_plain``; on a CUDA tensor it launches the kernel (and,
when the plan splits, ``split_reduce``'s kernel) or raises. There is no
fallback from one to the other. Every launch of either kernel adds one to
a counter on its device, in the kernel itself, so a launch that a CUDA
graph replays counts as an eager one does (``launch_counts``). The kernels are built with ``nvcc`` for
``sm_90a`` into ``lidbox_tpu_torch/_build/`` at first use and loaded with
ctypes; a missing ``nvcc`` or a failed build raises.
"""
import contextlib
import ctypes
import functools
import os
import shutil
import subprocess
import tempfile
import threading

import numpy as np
import torch

from lidbox_tpu_torch.features import audio, mel_ops

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "csrc", "logmel.cu")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
LIBRARY = os.path.join(BUILD_DIR, "liblogmel.so")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
# k of one wgmma: m64nNk8 in TF32, m64nNk16 in bf16
MMA_DEPTH = {False: 8, True: 16}
# The kernel's tiles (csrc/logmel.cu): basis rows of a ring stage, bins of
# a pass (64 DFT columns), frames of a consumer warpgroup, mel columns of
# one mel wgmma and of one block (more run in rounds), consumer warpgroups
# of a block.
CHUNK, PASS_BINS, TILE_FRAMES = 32, 32, 64
MEL_CHUNK, MEL_ROUND, MAX_CONSUMERS = 32, 128, 2
# Per mode (False: "highest", True: "bf16"): bytes of a basis tile and of
# 32 mel columns of a pass, and the span's pitch residue mod 32 words that
# keeps the A fragment loads conflict-free.
TILE_BYTES = {False: 16384, True: 4096}
MEL_CHUNK_BYTES = {False: 8192, True: 2048}
PITCH_MOD = {False: 4, True: 8}
# kernel_plan's ints in the order of the kernel's Params
GEO_FIELDS = ("B", "T", "F", "step", "K", "nchunks", "passes", "pps",
              "splits", "n_mel", "mc", "rounds", "tiles_per_row",
              "total_tiles", "nwg", "pitch", "rows", "cols", "span_floats",
              "smem")

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
        lib.lidbox_logmel.argtypes = [ptr] * 6 + [i32, i32, ptr, ptr]
        lib.lidbox_logmel.restype = i32
        lib.lidbox_logmel_reduce.argtypes = [ptr, ptr, i32, ctypes.c_longlong,
                                             ptr, ptr]
        lib.lidbox_logmel_reduce.restype = i32
        lib.lidbox_logmel_device.argtypes = [ptr, ptr]
        lib.lidbox_logmel_device.restype = i32
        lib.lidbox_logmel_setup.argtypes = [i32]
        lib.lidbox_logmel_setup.restype = i32
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


def core_matrix_order(X, bf16):
    """K-major tiles [..., N, Kc] (N a multiple of 8, Kc of the wgmma depth)
    flattened to [..., N * Kc] in the order a no-swizzle K-major wgmma
    descriptor reads them: [k-step, K half, 8-column group, column % 8, k %
    (depth / 2)]. A core matrix is 8 columns x 16 bytes (128 contiguous
    bytes); the two K halves of a k-step are N / 8 * 128 bytes apart (the
    descriptor's leading byte offset), the column groups 128 bytes (its
    stride byte offset). Keeps the dtype."""
    depth = MMA_DEPTH[bool(bf16)]
    lead, (N, Kc) = X.shape[:-2], X.shape[-2:]
    x = X.reshape(*lead, N // 8, 8, Kc // depth, 2, depth // 2)
    n = len(lead)
    x = x.transpose(*range(n), n + 2, n + 3, n, n + 1, n + 4)
    return x.reshape(*lead, -1)


def _tiles(blocks, bf16):
    """[..., N, Kc] float32 tiles as the kernel reads them: bfloat16, or
    float32 hi then lo of split_tf32, in core_matrix_order."""
    x = np.ascontiguousarray(core_matrix_order(blocks, bf16), np.float32)
    if bf16:
        return torch.from_numpy(x).to(torch.bfloat16)
    return torch.from_numpy(np.concatenate(split_tf32(x), axis=-1))


def basis_blocks(W):
    """W [K, 2 * NB] (``kernel_bases``) zero-padded to whole 32-row chunks and
    32-bin passes, as [passes, chunks, 64, 32] tiles W[32c:32c + 32, 64p:64p
    + 64]^T (K-major). Keeps the dtype."""
    Wp = _zero_pad(W, CHUNK, 2 * PASS_BINS)
    chunks, passes = Wp.shape[0] // CHUNK, Wp.shape[1] // (2 * PASS_BINS)
    blocks = Wp.reshape(chunks, CHUNK, passes, 2 * PASS_BINS)
    return blocks.transpose(2, 0, 3, 1)


def basis_tiles(W, bf16):
    """The kernel's basis stream: ``basis_blocks(W)``, each tile in
    ``core_matrix_order`` (hi then lo, float32, in "highest"; bfloat16 in
    "bf16"), so one bulk copy brings a tile in the order the descriptors
    read it."""
    return _tiles(basis_blocks(W), bf16)


def mel_row_order(bf16):
    """Which bin of a mel k-step each of the A fragment's k positions holds:
    the kernel feeds the power straight from the DFT accumulator, where lane
    (g, t) holds bin 4i + t of its n8 group i. In TF32 (k8) that is the
    fragment's own order; in bf16 (k16) positions 2t, 2t + 1, 2t + 8, 2t + 9
    hold bins t, 4 + t, 8 + t, 12 + t, so M's rows are permuted alike."""
    if not bf16:
        return np.arange(8)
    t = np.arange(4)
    order = np.empty(16, np.int64)
    order[2 * t], order[2 * t + 1] = t, 4 + t
    order[2 * t + 8], order[2 * t + 9] = 8 + t, 12 + t
    return order


def mel_layout(n_mel):
    """(mc, rounds): mel wgmmas of 32 columns a block keeps, and rounds of
    blocks over the mel columns (a block keeps at most MEL_ROUND)."""
    rounds = -(-n_mel // MEL_ROUND)
    return -(-(-(-n_mel // rounds)) // MEL_CHUNK), rounds


def mel_blocks(M, bf16, mc, rounds):
    """M [NB, n_mel] zero-padded to whole passes and to rounds * mc * 32
    columns, its rows permuted within each k-step (``mel_row_order``), as
    [rounds, passes, mc * 32, 32] tiles (the pass's 32 rows by the round's
    columns, transposed: K-major). Keeps the dtype."""
    depth = MMA_DEPTH[bool(bf16)]
    cols = mc * MEL_CHUNK
    Mp = _zero_pad(M, PASS_BINS, rounds * cols)
    idx = np.arange(Mp.shape[0])
    Mp = Mp[idx // depth * depth + mel_row_order(bf16)[idx % depth]]
    passes = Mp.shape[0] // PASS_BINS
    blocks = Mp.reshape(passes, PASS_BINS, rounds, cols)
    return blocks.transpose(2, 0, 3, 1)


def mel_tiles(M, bf16, mc, rounds):
    """The kernel's mel stream: ``mel_blocks`` in ``core_matrix_order``, as
    ``basis_tiles``."""
    return _tiles(mel_blocks(M, bf16, mc, rounds), bf16)


def ring_stages(bf16):
    """Stages of the kernel's basis ring, each holding two passes' tiles: 2
    in "highest", 4 in "bf16"."""
    return 4 if bf16 else 2


def _zero_pad(X, rows, cols):
    """X zero-padded to whole multiples of rows and cols; keeps the dtype."""
    out = np.zeros((_round_up(X.shape[0], rows), _round_up(X.shape[1], cols)),
                   X.dtype)
    out[:X.shape[0], :X.shape[1]] = X
    return out


def kernel_plan(batch, samples, num_frames, frame_step, rows, bins, n_mel,
                bf16, sms, max_smem):
    """The kernel's geometry for one call, as a dict of ``GEO_FIELDS``.

    ``rows`` basis rows (L) and ``bins`` weighted bins (``kernel_bases``)
    round up to K (whole chunks) and whole passes. Each consumer keeps the
    span of its 64 frames in shared memory: rows of ``frame_step`` samples
    (``cols`` = min(step, K) of them used) at ``pitch`` words, 63 + ceil(K /
    step) rows, so column k of frame f sits at (f + k // step) * pitch + k %
    step; beside it a table of K span offsets, each lane's columns in load
    order, and its running mel sums. Two consumers a block where both fit in
    ``max_smem`` bytes beside the rings, else one (raises when none fits). 64-frame tiles are
    numbered row by row; a block takes ``nwg`` consecutive ones. The bin
    passes of a tile are split over blocks (one block an SM) where the
    blocks (times the mel rounds) fill less than half of the ``sms``: into
    sms // blocks splits, at most one pass each."""
    bf16 = bool(bf16)
    K = _round_up(rows, CHUNK)
    passes = -(-bins // PASS_BINS)
    mc, rounds = mel_layout(n_mel)
    cols = min(frame_step, K)
    pitch = cols + (PITCH_MOD[bf16] - cols) % 32
    span_rows = TILE_FRAMES - 1 + -(-K // frame_step)
    span_floats = _round_up(span_rows * pitch, 4)
    stages = ring_stages(bf16)
    fixed = (stages * 2 * TILE_BYTES[bf16] + 2 * mc * MEL_CHUNK_BYTES[bf16]
             + (2 * stages + 4) * 8)
    for nwg in range(MAX_CONSUMERS, 0, -1):
        # a consumer's span, offset table and running mel sums
        smem = fixed + nwg * (span_floats + K + 128 * 16 * mc) * 4
        if smem <= max_smem:
            break
    else:
        raise ValueError(f"the log-Mel kernel's signal span ({span_rows} "
                         f"rows of {pitch} floats) does not fit the card's "
                         f"{max_smem} bytes of shared memory a block")
    tiles_per_row = -(-num_frames // TILE_FRAMES)
    total = batch * tiles_per_row
    blocks = -(-total // nwg)
    pps = -(-passes // min(max(sms // (blocks * rounds), 1), passes))
    return dict(B=batch, T=samples, F=num_frames, step=frame_step, K=K,
                nchunks=K // CHUNK, passes=passes, pps=pps,
                splits=-(-passes // pps), n_mel=n_mel, mc=mc, rounds=rounds,
                tiles_per_row=tiles_per_row, total_tiles=total, nwg=nwg,
                pitch=pitch, rows=span_rows, cols=cols,
                span_floats=span_floats, smem=smem)


def partial_slices(plan):
    """Slices of a split launch's partial mel sums: the first split's sum of
    its passes, then one slice for each later pass (added in that order,
    which is the order an unsplit block adds its passes in)."""
    return plan["passes"] - plan["pps"] + 1


def plan_stats(plan, bf16, sms):
    """What a plan costs the card: blocks, the SMs they occupy (one block an
    SM: the rings and spans take most of its shared memory), the share of
    computed frames that are padding, and the basis and mel bytes the blocks
    read from L2 (each block reads its passes' tiles once)."""
    bf16 = bool(bf16)
    frame_blocks = -(-plan["total_tiles"] // plan["nwg"])
    blocks = frame_blocks * plan["splits"] * plan["rounds"]
    computed = plan["total_tiles"] * TILE_FRAMES
    per_pass = (plan["nchunks"] * TILE_BYTES[bf16]
                + plan["mc"] * MEL_CHUNK_BYTES[bf16])
    return {"blocks": blocks, "sms_used": min(blocks, sms),
            "padded_frames": 1.0 - plan["B"] * plan["F"] / computed,
            "basis_bytes": frame_blocks * plan["rounds"] * plan["passes"]
            * per_pass}


@functools.lru_cache(maxsize=16)
def _device_bases(key, device):
    """(basis tiles, mel tiles, L, NB) of one geometry on ``device``."""
    W, M = kernel_bases(*key)
    bf16 = key[-1]
    mc, rounds = mel_layout(key[2])
    return (basis_tiles(W, bf16).to(device),
            mel_tiles(M, bf16, mc, rounds).to(device),
            min(key[0], key[1]), M.shape[0])


@functools.lru_cache(maxsize=16)
def device_limits(device):
    """(SM count, shared memory a block may opt in to) of a CUDA device,
    as the kernel's library reads them. The first call for a device also
    lets the kernel use that shared memory there (``lidbox_logmel_setup``):
    the one runtime call besides the launch, kept out of the launch path so
    that a CUDA graph can capture a launch."""
    lib = _load_library()
    sms, smem = ctypes.c_int(), ctypes.c_int()
    with torch.cuda.device(device):
        err = lib.lidbox_logmel_device(ctypes.byref(sms), ctypes.byref(smem))
        if err == 0:
            err = lib.lidbox_logmel_setup(smem.value)
    if err != 0:
        raise RuntimeError("log-Mel kernel: cannot set up the device: "
                           + lib.lidbox_logmel_error_string(err).decode())
    return sms.value, smem.value


# the kernels that count their launches, in the order of their counters
KERNELS = ("logmel_kernel", "logmel_reduce")


def _cuda_device(device):
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


@functools.lru_cache(maxsize=None)
def _launch_counter(device):
    """int64 [len(KERNELS)] on ``device``: every launch of ``KERNELS[i]``
    adds one to element i on the card. Kept for the process, since a
    captured CUDA graph holds its address; a normal tensor even when the
    first launch runs in inference mode (a served forward), so that
    ``reset_launch_counts`` may zero it outside."""
    with torch.inference_mode(False):
        return torch.zeros(len(KERNELS), dtype=torch.int64, device=device)


def launch_counts(device="cuda"):
    """{kernel name: its launches on ``device``} since the last
    ``reset_launch_counts``, as the launches counted themselves on the card
    (eager, or replayed from a CUDA graph). Reads the device: a sync. The
    CPU runs no kernel, so counts nothing."""
    device = _cuda_device(device)
    if device.type != "cuda":
        return dict.fromkeys(KERNELS, 0)
    return dict(zip(KERNELS, _launch_counter(device).tolist()))


def reset_launch_counts(device="cuda"):
    """Set the launch counts of ``device`` to 0 (in its stream order)."""
    device = _cuda_device(device)
    if device.type == "cuda":
        _launch_counter(device).zero_()


_captures = threading.local()


# within it, every launch on this thread appends the cached constant
# operands it reads (the basis and mel tiles) to ``held``, beside the
# feature functions' cached constants: a graph captured within holds them
holding_operands = audio.holding_constants


@contextlib.contextmanager
def tallying_launches(tally):
    """Within it, every launch on this thread also adds one to
    ``tally[kernel name]`` (a ``collections.Counter``) on the host: what a
    capture's warm-up steps launched, which ``train/graphs.py`` adds up
    beside the counts the card keeps."""
    outer = getattr(_captures, "tally", None)
    _captures.tally = tally
    try:
        yield tally
    finally:
        _captures.tally = outer


def _tally(kernel):
    tally = getattr(_captures, "tally", None)
    if tally is not None:
        tally[kernel] += 1


def _key(sample_rate, frame_length, fft_length, num_mel_bins, fmin, fmax,
         precision):
    return (frame_length, fft_length, int(num_mel_bins), int(sample_rate),
            float(fmin), float(fmax), precision == "bf16")


@functools.lru_cache(maxsize=64)
def _launch_config(key, batch, samples, frame_step, device):
    """(basis tiles, mel tiles, plan, the plan's ints for the library, the
    device's shared memory limit, its launch counter) of one launch shape.
    Its first call for a shape uploads the bases and sets the device up,
    which no stream capture may do: a captured step's warm-up makes that
    call (``train/graphs.py``), and the capture holds the tiles
    (``holding_operands``)."""
    W, M, L, NB = _device_bases(key, device)
    sms, max_smem = device_limits(device)
    plan = kernel_plan(batch, samples,
                       audio.num_frames(samples, key[0], frame_step),
                       frame_step, L, NB, key[2], key[-1], sms, max_smem)
    return W, M, plan, (ctypes.c_int * len(GEO_FIELDS))(
        *(plan[f] for f in GEO_FIELDS)), max_smem, _launch_counter(device)


def _operands(key, batch, samples, frame_step, device):
    """``_launch_config``, its tiles appended to the operands held on this
    thread (``holding_operands``)."""
    config = _launch_config(key, batch, samples, frame_step, device)
    audio.hold(config[:2])
    return config


def launch_plan(batch, samples, sample_rate, frame_length_ms=25,
                frame_step_ms=10, fft_length=512, num_mel_bins=64, fmin=0.0,
                fmax=8000.0, precision="highest", device="cuda"):
    """``kernel_plan`` and ``plan_stats`` of the launch ``fused_logmel``
    makes for [batch, samples] signals on ``device``."""
    frame_length = audio.ms_to_frames(sample_rate, frame_length_ms)
    frame_step = audio.ms_to_frames(sample_rate, frame_step_ms)
    key = _key(sample_rate, frame_length, fft_length, num_mel_bins, fmin,
               fmax, precision)
    device = torch.device(device)
    plan = _launch_config(key, batch, samples, frame_step, device)[2]
    return plan, plan_stats(plan, key[-1], device_limits(device)[0])


def fused_logmel(signals, sample_rate, frame_length_ms=25, frame_step_ms=10,
                 fft_length=512, num_mel_bins=64, fmin=0.0, fmax=8000.0,
                 precision="highest"):
    """[B, T] float32 waveforms -> [B, frames, num_mel_bins] float32 log-Mel.

    CPU tensor: ``logmel_plain``. CUDA tensor: the CUDA kernel (counted on
    the card: ``launch_counts``), or an exception. Either way a signal that
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
    key = _key(sample_rate, frame_length, fft_length, num_mel_bins, fmin,
               fmax, precision)
    W, M, plan, geo, max_smem, counter = _operands(key, B, T, frame_step,
                                                   signals.device)
    out = torch.empty((B, num_frames, num_mel_bins), dtype=torch.float32,
                      device=signals.device)
    partial = (torch.empty((partial_slices(plan),) + out.shape,
                           dtype=torch.float32, device=signals.device)
               if plan["splits"] > 1 else None)
    with _on(signals.device) as stream:
        err = lib.lidbox_logmel(
            signals.data_ptr(), W.data_ptr(), M.data_ptr(), out.data_ptr(),
            None if partial is None else partial.data_ptr(), geo,
            int(key[-1]), max_smem, counter.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"log-Mel kernel launch failed (plan {plan}): "
                           + lib.lidbox_logmel_error_string(err).decode())
    _tally(KERNELS[0])
    if partial is not None:  # the library launched the reduction too
        _tally(KERNELS[1])
    return out


@contextlib.contextmanager
def _on(device):
    """The current CUDA stream of ``device`` as an int, with ``device``
    current (switched only when another card is)."""
    if device.index is None or device.index == torch.cuda.current_device():
        yield torch.cuda.current_stream(device).cuda_stream
    else:
        with torch.cuda.device(device):
            yield torch.cuda.current_stream(device).cuda_stream


def split_reduce(partial, out=None):
    """[n, B, F, n_mel] partial mel sums -> [B, F, n_mel] ``log(sum +
    1e-6)``, the n slices added in order: the second kernel of a split
    ``fused_logmel`` (``partial_slices``: the slices add up as an unsplit
    launch adds its passes), which launches it from the library.
    CPU tensor: ``split_reduce_plain``. CUDA tensor: the kernel
    ``logmel_reduce`` (counted on the card: ``launch_counts``), or an
    exception."""
    if partial.dim() != 4 or partial.dtype != torch.float32:
        raise ValueError("partial must be a float32 [n, batch, frames, mel] "
                         "tensor")
    if partial.device.type == "cpu":
        return split_reduce_plain(partial)
    if partial.device.type != "cuda" or not partial.is_contiguous():
        raise ValueError("partial must be a contiguous cpu or cuda tensor")
    lib = _load_library()
    if out is None:
        out = torch.empty(partial.shape[1:], dtype=torch.float32,
                          device=partial.device)
    with _on(partial.device) as stream:
        err = lib.lidbox_logmel_reduce(
            partial.data_ptr(), out.data_ptr(), partial.shape[0],
            out.numel(), _launch_counter(partial.device)[1].data_ptr(),
            stream)
    if err != 0:
        raise RuntimeError("log-Mel split reduction launch failed: "
                           + lib.lidbox_logmel_error_string(err).decode())
    _tally(KERNELS[1])
    return out


def split_reduce_plain(partial):
    """``split_reduce`` in plain PyTorch: the same order of additions."""
    total = partial[0].clone()
    for part in partial[1:]:
        total += part
    return torch.log(total + 1e-6)


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

"""
The tail of ECAPA-TDNN's ``TDNN`` in one kernel pass forward and one
backward: conv bias, ReLU, BatchNorm over a padded batch's valid frames
and the frame mask, for a training-mode forward.

Replaces no TPU kernel (the JAX package has no ECAPA-TDNN). Composed from
PyTorch's operations, the tail of a [B, C, T] activation runs some 20
element-wise and reduction passes over it forward and 30 backward; the
kernels ``csrc/tdnn_norm.cu`` make one forward (z in, y out) and one
backward (z and dy in, dz out), bound by those bytes (the source's header
says how they keep the rest on chip).

``tdnn_norm_plain`` is the same function in plain PyTorch: the CPU's
form and the kernels' oracle on the card. ``tdnn_norm`` is the wrapper: on
a CPU tensor it computes the plain form, on a CUDA tensor it runs the
kernels through ``TdnnNorm`` (a ``torch.autograd.Function``) or raises.
``route`` says which form ``models/ecapa_tdnn.py::TDNN`` takes: the kernels
only where it can observe a training-mode forward of a CUDA float32 input
under a frame mask, with no data mesh, whose channel fits on chip; the
composition of ``layers.BatchNorm`` everywhere else. The TDNN counts the
route of each training-mode forward (``norm_fused``, ``norm_composed``),
which a captured step's replays carry as their captured body's. Each
launch of either kernel also adds one to a counter on the card, eager or
replayed from a CUDA graph (``launch_counts``).
The kernels are built with ``nvcc`` for ``sm_90a`` into
``lidbox_tpu_torch/_build/`` at first use and loaded with ctypes, as
``ops/logmel.py::build`` builds the log-Mel kernel; a missing ``nvcc`` or
a failed build raises.
"""
import ctypes
import functools
import os

import torch

from lidbox_tpu_torch import parallel

from . import logmel

SOURCE = os.path.join(os.path.dirname(logmel.SOURCE), "tdnn_norm.cu")
LIBRARY = os.path.join(logmel.BUILD_DIR, "libtdnn_norm.so")
# Blocks of the cluster that splits a channel's rows (portable cluster
# size), the shared memory a block aims at (four blocks of 256 threads on
# an SM) and the most it may hold (the card's 227 KB, less the kernels'
# static shared memory).
MAX_CLUSTER = 8
SMEM_TARGET = 48 * 1024
MAX_HELD = 224 * 1024
# Bytes a block holds for a value of its rows: the forward's ReLU output;
# the backward's dy m, xhat and one byte for the ReLU's and mask's gate.
FORWARD_BYTES, BACKWARD_BYTES = 4, 9

_lib = None


def build():
    """Compile ``csrc/tdnn_norm.cu`` into ``_build/libtdnn_norm.so`` unless
    the library is newer than the source. Returns the library path."""
    return logmel.build_library(SOURCE, LIBRARY)


def _load_library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.lidbox_tdnn_norm_forward.argtypes = (
            [ptr] * 9 + [i32, i32, i32, f32, i32, i32, ptr, ptr])
        lib.lidbox_tdnn_norm_forward.restype = i32
        lib.lidbox_tdnn_norm_backward.argtypes = (
            [ptr] * 11 + [i32, i32, i32, i32, i32, ptr, ptr])
        lib.lidbox_tdnn_norm_backward.restype = i32
        lib.lidbox_tdnn_norm_error_string.argtypes = [i32]
        lib.lidbox_tdnn_norm_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def held_bytes(rows, steps, cluster, value_bytes):
    """Shared memory of a block of a ``cluster`` that splits ``rows`` rows
    of ``steps`` frames, ``value_bytes`` a value."""
    return -(-rows // cluster) * steps * value_bytes


def cluster_split(channels, rows, steps, value_bytes, sms):
    """Blocks that share a channel of a [rows, channels, steps] activation:
    the fewest, a power of two up to ``MAX_CLUSTER`` and ``rows``, that
    give each of the card's ``sms`` SMs two blocks and hold each block's
    rows in ``SMEM_TARGET`` bytes. None where ``MAX_CLUSTER`` blocks
    cannot hold a channel (``MAX_HELD``)."""
    cluster, most = 1, min(MAX_CLUSTER, rows)
    while cluster * 2 <= most and (
            channels * cluster < 2 * sms
            or held_bytes(rows, steps, cluster, value_bytes) > SMEM_TARGET):
        cluster *= 2
    if held_bytes(rows, steps, cluster, value_bytes) > MAX_HELD:
        return None
    return cluster


def fits(rows, steps):
    """Whether the kernels hold a channel of ``rows`` rows of ``steps``
    frames on chip."""
    return cluster_split(1, rows, steps, BACKWARD_BYTES, 0) is not None


def route(x, mask, training):
    """``"fused"`` where a TDNN's tail over ``x`` ([B, C, T], the
    convolution's input) runs as the kernels: a training-mode forward
    (``training``) of a CUDA float32 ``x`` under a frame ``mask``, with no
    data mesh active, whose channel fits on chip. ``"composed"``
    elsewhere: evaluation and serving, the CPU, other dtypes, unmasked
    batches and meshes."""
    if (training and mask is not None and x.is_cuda
            and x.dtype == torch.float32 and parallel.active_mesh() is None
            and fits(x.shape[0], x.shape[2])):
        return "fused"
    return "composed"


def tdnn_norm_plain(z, bias, scale, shift, mask, epsilon):
    """(y, mean, var) of the TDNN's tail in plain PyTorch: r = relu(z +
    bias); mean and biased variance per channel over ``mask``'s frames
    (two passes, the count floored at 1); y = (scale (r - mean)
    rsqrt(var + epsilon) + shift) mask. ``z`` [B, C, T], ``mask`` [B, T]
    bool, the others [C]."""
    m = mask[:, None, :].to(z.dtype)
    r = torch.relu(z + bias[:, None])
    count = torch.clamp(m.sum(), min=1.0)
    mean = (r * m).sum(dim=(0, 2)) / count
    var = torch.square((r - mean[:, None]) * m).sum(dim=(0, 2)) / count
    mul = torch.rsqrt(var + epsilon) * scale
    y = ((r - mean[:, None]) * mul[:, None] + shift[:, None]) * m
    return y, mean, var


# the kernels, in the order of their launch counters
KERNELS = ("tdnn_norm_forward", "tdnn_norm_backward")


@functools.lru_cache(maxsize=None)
def _launch_counter(device):
    """int64 [len(KERNELS)] on ``device``: every launch of ``KERNELS[i]``
    adds one to element i on the card. Kept for the process, since a
    captured CUDA graph holds its address."""
    with torch.inference_mode(False):
        return torch.zeros(len(KERNELS), dtype=torch.int64, device=device)


def launch_counts(device="cuda"):
    """{kernel name: its launches on ``device``} since the last
    ``reset_launch_counts``, as the launches counted themselves on the card
    (eager, or replayed from a CUDA graph). Reads the device: a sync. The
    CPU runs no kernel, so counts nothing."""
    device = logmel._cuda_device(device)
    if device.type != "cuda":
        return dict.fromkeys(KERNELS, 0)
    return dict(zip(KERNELS, _launch_counter(device).tolist()))


def reset_launch_counts(device="cuda"):
    """Set the launch counts of ``device`` to 0 (in its stream order)."""
    device = logmel._cuda_device(device)
    if device.type == "cuda":
        _launch_counter(device).zero_()


@functools.lru_cache(maxsize=None)
def _sms(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


def vector_width(steps, *tensors):
    """Values a load of the kernels takes at once: 4, 2 or 1, as ``steps``
    and the alignment of each tensor's data (float32, or the mask's
    bytes) allow."""
    for vec in (4, 2):
        if steps % vec == 0 and all(
                t.data_ptr() % (vec * t.element_size()) == 0
                for t in tensors):
            return vec
    return 1


def _check(z, mask, *vectors):
    if z.dim() != 3 or z.dtype != torch.float32 or not z.is_cuda:
        raise ValueError("z must be a [batch, channels, frames] float32 CUDA "
                         "tensor")
    B, C, T = z.shape
    if mask.shape != (B, T) or mask.dtype != torch.bool:
        raise ValueError(f"mask must be a [{B}, {T}] bool tensor")
    for t in (z, mask) + vectors:
        if t.device != z.device or not t.is_contiguous():
            raise ValueError("the tail's tensors must be contiguous, on "
                             "z's device")
    for v in vectors:
        if v.shape != (C,) or v.dtype != torch.float32:
            raise ValueError(f"bias, scale and shift must be [{C}] float32")
    if not fits(B, T):
        raise ValueError(f"a [{B}, {C}, {T}] activation does not fit the "
                         f"kernels")


def _raise_on(err, what, shape):
    if err != 0:
        raise RuntimeError(
            f"TDNN tail {what} kernel launch failed at {list(shape)}: "
            + _load_library().lidbox_tdnn_norm_error_string(err).decode())


def forward(z, bias, scale, shift, mask, epsilon):
    """The forward kernel: (y, mean, var, rstd) of ``tdnn_norm_plain`` on
    CUDA tensors, rstd = rsqrt(var + epsilon)."""
    _check(z, mask, bias, scale, shift)
    lib = _load_library()
    B, C, T = z.shape
    y = torch.empty_like(z)
    mean, var, rstd = (torch.empty(C, dtype=torch.float32, device=z.device)
                       for _ in range(3))
    cluster = cluster_split(C, B, T, FORWARD_BYTES, _sms(z.device))
    counter = _launch_counter(logmel._cuda_device(z.device))
    with logmel._on(z.device) as stream:
        err = lib.lidbox_tdnn_norm_forward(
            z.data_ptr(), bias.data_ptr(), scale.data_ptr(),
            shift.data_ptr(), mask.data_ptr(), y.data_ptr(),
            mean.data_ptr(), var.data_ptr(), rstd.data_ptr(), B, C, T,
            float(epsilon), cluster, vector_width(T, z, y, mask),
            counter[0].data_ptr(), stream)
    _raise_on(err, "forward", z.shape)
    return y, mean, var, rstd


def backward(z, dy, bias, scale, mean, rstd, mask):
    """The backward kernel: (dz, dbias, dscale, dshift) from ``forward``'s
    inputs, its mean and rstd and the gradient ``dy`` of y."""
    _check(z, mask, bias, scale, mean, rstd)
    _check(dy, mask)
    if dy.shape != z.shape:
        raise ValueError("dy must be of z's shape")
    lib = _load_library()
    B, C, T = z.shape
    dz = torch.empty_like(z)
    dbias, dscale, dshift = (torch.empty(C, dtype=torch.float32,
                                         device=z.device) for _ in range(3))
    cluster = cluster_split(C, B, T, BACKWARD_BYTES, _sms(z.device))
    counter = _launch_counter(logmel._cuda_device(z.device))
    with logmel._on(z.device) as stream:
        err = lib.lidbox_tdnn_norm_backward(
            z.data_ptr(), dy.data_ptr(), bias.data_ptr(), scale.data_ptr(),
            mean.data_ptr(), rstd.data_ptr(), mask.data_ptr(),
            dz.data_ptr(), dbias.data_ptr(), dscale.data_ptr(),
            dshift.data_ptr(), B, C, T, cluster,
            vector_width(T, z, dy, dz, mask), counter[1].data_ptr(), stream)
    _raise_on(err, "backward", z.shape)
    return dz, dbias, dscale, dshift


class TdnnNorm(torch.autograd.Function):
    """``forward`` and ``backward`` as one differentiable operation; saves
    z, the mean and rstd, and recomputes the rest in the backward."""

    @staticmethod
    def forward(ctx, z, bias, scale, shift, mask, epsilon):
        y, mean, var, rstd = forward(z, bias, scale, shift, mask, epsilon)
        ctx.save_for_backward(z, bias, scale, mean, rstd, mask)
        ctx.mark_non_differentiable(mean, var)
        ctx.set_materialize_grads(False)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        z, bias, scale, mean, rstd, mask = ctx.saved_tensors
        return backward(z, dy.contiguous(), bias, scale, mean, rstd,
                        mask) + (None, None)


def tdnn_norm(z, bias, scale, shift, mask, epsilon):
    """(y, mean, var) of ``tdnn_norm_plain``. CPU tensor: the plain form.
    CUDA tensor: the kernels (``TdnnNorm``), or an exception."""
    if z.device.type == "cpu":
        return tdnn_norm_plain(z, bias, scale, shift, mask, epsilon)
    return TdnnNorm.apply(z, bias, scale, shift, mask, epsilon)

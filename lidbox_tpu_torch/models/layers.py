"""
Shared layers of the model zoo, in PyTorch (counterpart of
``lidbox_tpu.models.layers``).

Activations keep the JAX package's ``[batch, time, channels]`` layout
between layers; the time-pooling layers take an optional boolean frame
``mask`` so padded batches reproduce variable-length numerics. The 2-D
models run their images in NCHW with the JAX package's H/W meaning (an
NHWC ``[B, T, F, 1]`` image becomes ``[B, 1, T, F]``), so a Flax
``[kh, kw, in, out]`` kernel maps onto ``[out, in, kh, kw]`` by one
transpose.

Stochastic layers (dropout, Gaussian noise) draw from the
``torch.Generator`` their forward is given, as ``SpatialDropout1D`` does;
the JAX package's ``rngs`` streams cannot be matched draw for draw. Under
``parallel.data_parallel`` they draw for the global batch and keep this
rank's rows (``parallel.draw_rows``).

Tensor parallelism: a layer handed a weight that ``parallel.shard_params``
split (fewer output features than the layer has; only inside
``parallel.tensor_parallel``) computes its own output columns. ``Dense``,
``Conv1d`` and non-grouped ``Conv2d`` run their product on this rank's
rows of the weight and all-gather the output before the bias
(``column_parallel``); grouped convolutions and the recurrent cells, whose
product cannot split by output column in one call, all-gather the weight
(``parallel.gather_weight``).
"""
import concurrent.futures
import contextlib
import functools
import math
import queue
import threading
import weakref

import torch
import torch.nn as nn
import torch.nn.functional as F

from lidbox_tpu_torch import parallel

TIME_AXIS = 1
STDDEV_SQRT_MIN_CLIP = 1e-10

# Keras-compatible BatchNorm defaults (momentum 0.99, eps 1e-3), as the
# JAX package's batch_norm (lidbox_tpu/models/layers.py:20-28).
BN_MOMENTUM = 0.99
BN_EPSILON = 1e-3


class GlobalMeanStddevPooling1D(nn.Module):
    """Concat of mean and stddev over the time axis, with the reference's
    variance clip at 1e-10 (reference: lidbox/models/xvector.py:25-35).
    With a mask, the statistics run over valid frames only."""

    def forward(self, x, mask=None):
        if mask is None:
            means = torch.mean(x, dim=TIME_AXIS, keepdim=True)
            variances = torch.mean(torch.square(x - means), dim=TIME_AXIS)
            means = means.squeeze(TIME_AXIS)
        else:
            m = mask[..., None].to(x.dtype)
            # the count stays float32 whatever the compute type (a bf16
            # sum of ones saturates at 256)
            count = torch.clamp(mask.to(torch.float32).sum(dim=TIME_AXIS),
                                min=1.0)[:, None]
            means = ((x * m).sum(dim=TIME_AXIS).float() / count).to(x.dtype)
            deltas = (x - means[:, None, :]) * m
            variances = (torch.square(deltas).sum(dim=TIME_AXIS).float()
                         / count).to(x.dtype)
        stddevs = torch.sqrt(torch.clamp(variances, min=STDDEV_SQRT_MIN_CLIP))
        return torch.cat([means, stddevs], dim=-1)


def subsample_frame_mask(mask, total_stride, num_frames):
    """Valid-output mask after a stack of causal strided convolutions with
    combined stride ``total_stride``: output t of a causal conv at stride s
    reads the input window ending at s*t, so it is valid iff input s*t is,
    and ceil-division composes over the stack. For a prefix mask that is
    every ``total_stride``-th entry, cut to the output length (the JAX
    package proves it exhaustively, tests/test_models.py)."""
    return mask[:, ::total_stride][:, :num_frames]


def column_parallel(x, weight, bias, product, channel_dim):
    """``product(x, weight, bias)`` for a weight split over its output
    features (axis 0): this rank's columns, from the replicated input and
    this rank's slice of the replicated bias (both through
    ``parallel.copy_to_model``, whose backward sums the ranks' parts), all
    gathered along ``channel_dim`` of the output
    (``parallel.gather_columns``)."""
    mesh = parallel.model_group()
    if bias is not None:
        width = weight.shape[0]
        bias = parallel.copy_to_model(bias, mesh).narrow(
            0, mesh.rank * width, width)
    return parallel.gather_columns(
        product(parallel.copy_to_model(x, mesh), weight, bias), channel_dim,
        mesh)


class Dense(nn.Linear):
    """``nn.Linear`` (weight [out, in]) that computes column-parallel when
    its weight is split (module doc)."""

    def forward(self, x):
        if self.weight.shape[0] == self.out_features:
            return super().forward(x)
        return column_parallel(x, self.weight, self.bias, F.linear, -1)


class _ColumnParallelConv:
    """Column-parallel products for the Conv layers (module doc): the
    output channels are axis 1 of the NC... output."""

    def _conv_forward(self, x, weight, bias):
        if weight.shape[0] == self.out_channels:
            return super()._conv_forward(x, weight, bias)
        if self.groups > 1:
            return super()._conv_forward(x, parallel.gather_weight(weight),
                                         bias)
        return column_parallel(
            x, weight, bias, super(_ColumnParallelConv, self)._conv_forward,
            1)


class FrameLayer(nn.Module):
    """Causal 1D convolution "frame layer" of the x-vector TDNN stack
    (reference: lidbox/models/xvector.py:38-39): left pad k - 1, so stride
    s gives ceil(T / s) frames. [B, T, C_in] -> [B, ceil(T / s), filters]."""

    def __init__(self, in_channels, filters, kernel_size, strides,
                 activation="relu"):
        super().__init__()
        self.activation = activation
        self.conv = Conv1d(in_channels, filters, kernel_size, strides,
                           padding="CAUSAL")

    def forward(self, x):
        x = self.conv(x)
        if self.activation:
            x = getattr(F, self.activation)(x)
        return x


class SpatialDropout1D(nn.Module):
    """Channel dropout: drops whole feature channels across all time steps
    (Keras SpatialDropout1D; reference: lidbox/models/xvector.py:50-51).
    Active only in training mode. The [B, 1, C] keep mask is drawn from
    ``generator`` (a ``torch.Generator`` on x's device; None draws from
    torch's global one), and kept channels are scaled by 1 / (1 - rate)."""

    def __init__(self, rate):
        super().__init__()
        self.rate = rate

    def forward(self, x, generator=None):
        if not self.training:
            return x
        return dropout(x, self.rate, generator, broadcast_dims=(TIME_AXIS,))


def activation(x, name):
    """Flax's ``getattr(nn, name)(x)`` head activation ("log_softmax",
    "softmax" over the last axis, or any elementwise one); a falsy name
    leaves x as it is."""
    if not name:
        return x
    if name in ("softmax", "log_softmax"):
        return getattr(torch, name)(x, dim=-1)
    return getattr(F, name)(x)


def dropout(x, rate, generator=None, broadcast_dims=()):
    """Flax ``nn.Dropout`` in training mode: keep each element (or each
    slice along ``broadcast_dims``, which share one draw) with probability
    1 - rate and scale the kept ones by 1 / (1 - rate). The keep mask is
    drawn from ``generator``."""
    if rate == 0:
        return x
    keep = 1.0 - rate
    shape = [1 if d in broadcast_dims else n for d, n in enumerate(x.shape)]

    def draw(rows):
        probs = torch.full([rows] + shape[1:], keep, dtype=torch.float32,
                           device=x.device)
        return torch.bernoulli(probs, generator=generator)
    mask = draw(1) if 0 in broadcast_dims else parallel.draw_rows(
        draw, shape[0])
    return x * mask.to(x.dtype) / keep


class GaussianNoise(nn.Module):
    """Additive zero-mean Gaussian noise of ``stddev``, active only in
    training (Keras GaussianNoise; reference: lidbox/models/clstm.py:48),
    drawn from ``generator``."""

    def __init__(self, stddev):
        super().__init__()
        self.stddev = stddev

    def forward(self, x, generator=None):
        if not self.training or self.stddev == 0:
            return x
        noise = parallel.draw_rows(
            lambda rows: torch.randn((rows,) + tuple(x.shape[1:]),
                                     generator=generator, device=x.device,
                                     dtype=torch.float32), x.shape[0])
        return x + self.stddev * noise.to(x.dtype)


class BatchNorm(nn.Module):
    """Flax ``nn.BatchNorm`` with the Keras defaults of the JAX package:
    momentum 0.99, epsilon 1e-3, features on ``axis``.

    Parameters ``scale`` / ``bias`` and running statistics ``mean`` /
    ``var`` (buffers) carry Flax's names. A training-mode forward
    normalizes with the batch's statistics, reduced in float32 (float64
    for float64 inputs, as Flax promotes) over every axis but ``axis``:
    the mean and the biased variance, taken in two
    passes as E[(x - E[x])^2]. Flax's one-pass E[x^2] - E[x]^2 is the same
    value, but in torch's float32 reductions it cancels badly (crnn's
    3-step trajectory at 40 frames left rtol 1e-4 of the JAX package's and
    of a float64 run); the two-pass form stays with both. Padded rows of a
    masked batch count, as in the JAX package. Inside
    ``parallel.data_parallel`` the statistics are the global batch's: the
    sums and the count, then the squared deviations, are all-reduced over
    the mesh (gradients flow through both), as GSPMD computes them, so the
    running statistics come out equal on every rank. ``momentum`` (the
    running statistics' weight on their old value, Flax's and Keras's
    sense: torch's ``momentum=0.1`` is 0.9 here) and ``epsilon`` default to
    the Keras constants. A ``mask`` (a training-mode forward's boolean
    frame mask, ``x``'s shape without ``axis``) restricts the statistics to
    the positions it marks: the count is theirs, floored at 1, and every
    position, marked or not, is normalized with them. It never writes its
    buffers: inside ``collect_batch_stats``
    it hands the new running statistics (the momentum average of the old
    ones and the batch's) to the collector, which is how the trainer gets
    them back as the new state (Flax's ``mutable=["batch_stats"]``).
    Evaluation normalizes with the running statistics."""

    def __init__(self, num_features, axis=-1, epsilon=BN_EPSILON,
                 momentum=BN_MOMENTUM):
        super().__init__()
        self.axis = axis
        self.epsilon = epsilon
        self.momentum = momentum
        self.scale = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("mean", torch.zeros(num_features))
        self.register_buffer("var", torch.ones(num_features))
        self.collector = None

    def forward(self, x, mask=None):
        axis = self.axis % x.dim()
        shape = [1] * x.dim()
        shape[axis] = -1
        if self.training:
            dims = [d for d in range(x.dim()) if d != axis]
            xf = x.to(torch.promote_types(x.dtype, torch.float32))
            mesh = parallel.active_mesh()
            if mask is not None:
                mean, var = _masked_moments(xf, mask.unsqueeze(axis), dims,
                                            shape, mesh)
            elif mesh is None:
                mean = xf.mean(dim=dims)
                var = torch.square(xf - mean.reshape(shape)).mean(dim=dims)
            else:  # the global batch's statistics, differentiably
                count = xf.new_tensor([xf.numel() / xf.shape[axis]])
                sums = parallel.all_reduce_sum(
                    torch.cat([xf.sum(dim=dims), count]), mesh)
                mean = sums[:-1] / sums[-1]
                var = parallel.all_reduce_sum(
                    torch.square(xf - mean.reshape(shape)).sum(dim=dims),
                    mesh) / sums[-1]
            if self.collector is not None:
                self.collector[self] = (
                    self.momentum * self.mean + (1 - self.momentum) * mean,
                    self.momentum * self.var + (1 - self.momentum) * var)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + self.epsilon) * self.scale
        y = (x - mean.reshape(shape)) * mul.reshape(shape)
        y = y + self.bias.reshape(shape)
        return y.to(torch.promote_types(x.dtype, torch.promote_types(
            self.scale.dtype, self.bias.dtype)))


def _masked_moments(xf, mask, dims, shape, mesh):
    """(mean, biased variance) over ``dims`` of the positions of ``xf``
    that the boolean ``mask`` (broadcast along the feature axis) marks, in
    two passes, the count floored at 1; over the global batch inside a
    mesh, as ``BatchNorm`` reduces its unmasked statistics."""
    m = mask.to(xf.dtype)
    sums = torch.cat([(xf * m).sum(dim=dims), m.sum().reshape(1)])
    if mesh is not None:
        sums = parallel.all_reduce_sum(sums, mesh)
    count = torch.clamp(sums[-1], min=1.0)
    mean = sums[:-1] / count
    squares = torch.square((xf - mean.reshape(shape)) * m).sum(dim=dims)
    if mesh is not None:
        squares = parallel.all_reduce_sum(squares, mesh)
    return mean, squares / count


@contextlib.contextmanager
def collect_batch_stats(module):
    """Collect the new running statistics of every ``BatchNorm`` of
    ``module`` over the training-mode forwards run inside the block.

    Yields a dict that, after the block, maps each updated statistic's
    ``state_dict`` name (``<path>.mean``, ``<path>.var``) to its new
    float32 tensor (outside the autograd graph); statistics of BatchNorms
    that did not run are absent.
    The module's own buffers, and the tensors a ``functional_call`` put in
    their place, are left as they were."""
    norms = [(name, m) for name, m in module.named_modules()
             if isinstance(m, BatchNorm)]
    store, out = {}, {}
    for _, m in norms:
        m.collector = store
    try:
        yield out
    finally:
        for name, m in norms:
            m.collector = None
            if m in store:
                prefix = f"{name}." if name else ""
                mean, var = store[m]
                out[prefix + "mean"] = mean.detach().float()
                out[prefix + "var"] = var.detach().float()


def global_avg_pool_1d(x, mask=None):
    """Masked GlobalAveragePooling1D over the time axis. The valid-frame
    count accumulates in float32 (a bf16 sum of ones saturates at 256)."""
    if mask is None:
        return torch.mean(x, dim=TIME_AXIS)
    m = mask[..., None].to(x.dtype)
    count = torch.clamp(mask.to(torch.float32).sum(dim=TIME_AXIS),
                        min=1.0)[:, None]
    return ((x * m).sum(dim=TIME_AXIS).float() / count).to(x.dtype)


class FrequencyAttention(nn.Module):
    """Frequency attention over d_f bins (Miao et al., Interspeech 2019;
    reference: lidbox/models/clstm.py:31-42): softmax bin weights from two
    bias-free dense layers, applied multiplicatively to channel groups."""

    def __init__(self, channels, d_a=64, d_f=16):
        super().__init__()
        if channels % d_f:
            raise ValueError(f"channels ({channels}) must divide evenly into "
                             f"d_f={d_f} bins")
        self.d_f = d_f
        self.Wf_1 = Dense(channels, d_a, bias=False)
        self.Wf_2 = Dense(d_a, d_f, bias=False)

    def forward(self, H):
        B, T, d_h = H.shape
        F_A = torch.softmax(self.Wf_2(F.relu(self.Wf_1(H))), dim=-1)
        H_bins = H.reshape(B, T, self.d_f, d_h // self.d_f)
        return (F_A[..., None] * H_bins).reshape(B, T, d_h)


def l2_normalize(x, dim=-1, epsilon=1e-12):
    """tf.math.l2_normalize semantics: x / max(||x||, sqrt(eps))."""
    sq = torch.sum(torch.square(x), dim=dim, keepdim=True)
    return x * torch.rsqrt(torch.clamp(sq, min=epsilon))


class DenseBlock(nn.Module):
    """Dense + BN + relu + dropout (reference:
    lidbox/models/multilevel_attention.py:47-66)."""

    def __init__(self, in_features, units, dropout_rate):
        super().__init__()
        self.fc = Dense(in_features, units)
        self.bn = BatchNorm(units)
        self.dropout_rate = dropout_rate

    def forward(self, x, generator=None):
        x = F.relu(self.bn(self.fc(x)))
        if self.training:
            x = dropout(x, self.dropout_rate, generator)
        return x


def same_padding(size, kernel, stride):
    """Flax/XLA ``SAME`` padding of one spatial axis as (low, high):
    ceil(size / stride) outputs, total = max((out - 1) * stride + kernel -
    size, 0), the smaller half on the low side."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Conv1d(_ColumnParallelConv, nn.Conv1d):
    """A Flax ``nn.Conv`` over [B, T, C]: ``padding`` "SAME", "VALID" or
    "CAUSAL" (left pad k - 1)."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding="SAME", bias=True):
        super().__init__(in_channels, out_channels, kernel_size,
                         stride=stride, bias=bias)
        self.flax_padding = padding.upper()

    def forward(self, x):
        x = x.transpose(1, 2)
        k, s = self.kernel_size[0], self.stride[0]
        if self.flax_padding == "CAUSAL":
            x = F.pad(x, (k - 1, 0))
        elif self.flax_padding == "SAME":
            x = F.pad(x, same_padding(x.shape[-1], k, s))
        return super().forward(x).transpose(1, 2)


class Conv2d(_ColumnParallelConv, nn.Conv2d):
    """A Flax ``nn.Conv`` over an NCHW image, ``padding`` "SAME" (Flax's
    asymmetric split, ``same_padding``) or "VALID"; ``groups`` is Flax's
    ``feature_group_count``."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding="SAME", groups=1, bias=True):
        super().__init__(in_channels, out_channels, kernel_size,
                         stride=stride, groups=groups, bias=bias)
        self.flax_padding = padding.upper()

    def forward(self, x):
        if self.flax_padding == "SAME":
            (kh, kw), (sh, sw) = self.kernel_size, self.stride
            x = F.pad(x, same_padding(x.shape[-1], kw, sw)
                      + same_padding(x.shape[-2], kh, sh))
        return super().forward(x)


def max_pool_same(x, window, stride):
    """Flax ``nn.max_pool(..., padding="SAME")`` over an NCHW image: -inf
    padding on Flax's asymmetric split."""
    x = F.pad(x, same_padding(x.shape[-1], window[1], stride[1])
              + same_padding(x.shape[-2], window[0], stride[0]),
              value=-math.inf)
    return F.max_pool2d(x, window, stride)


def mask_to_lengths(mask):
    """Prefix-contiguous frame mask [B, T] -> valid lengths [B] (None
    passthrough)."""
    if mask is None:
        return None
    return mask.to(torch.int64).sum(dim=1)


def _final_step(y, lengths):
    """Output at each row's last valid step (y[:, n - 1])."""
    idx = torch.clamp(lengths.to(torch.int64) - 1, 0, y.shape[1] - 1)
    return y[torch.arange(y.shape[0], device=y.device), idx.to(y.device)]


class RNNCell(nn.Module):
    """The parameters of a Flax recurrent cell under its names, as torch
    ``Linear`` layers (weight [out, in]).

    ``"lstm"`` is ``OptimizedLSTMCell``: input kernels ``ii/if/ig/io``
    without bias, hidden kernels ``hi/hf/hg/ho`` with bias. ``"gru"`` is
    ``GRUCell``: ``ir/iz/in`` with bias, ``hr/hz`` without and ``hn`` with.
    ``flat_weights`` lays them out as cuDNN's (torch's ``nn.LSTM`` /
    ``nn.GRU``) single layer: gate order i, f, g, o and r, z, n, with the
    biases Flax lacks held at zero, and split weights gathered whole. Flax's formulas are torch's, GRU's
    n = tanh(W_in x + b_in + r * (W_hn h + b_hn)) and h' = (1 - z) n + z h
    included. Initialization (Flax's defaults): lecun_normal input
    kernels, orthogonal hidden kernels, zero biases."""

    def __init__(self, kind, in_features, units):
        super().__init__()
        self.kind = kind
        self.units = units
        self.gates = "ifgo" if kind == "lstm" else "rzn"
        for g in self.gates:
            self.add_module(f"i{g}", nn.Linear(in_features, units,
                                               bias=kind == "gru"))
            self.add_module(f"h{g}", nn.Linear(units, units,
                                               bias=kind == "lstm" or g == "n"))

    def flax_init_(self, generator):
        """Orthogonal hidden kernels, drawn on the CPU from ``generator``
        (the input kernels and the biases are the generic init's)."""
        for g in self.gates:
            w = getattr(self, f"h{g}").weight
            cpu = torch.empty(w.shape, dtype=torch.float32)
            nn.init.orthogonal_(cpu, generator=generator)
            with torch.no_grad():
                w.copy_(cpu)

    def flat_weights(self):
        def bias(layer):
            return (layer.bias if layer.bias is not None
                    else layer.weight.new_zeros(self.units))
        def weight(layer):
            w = layer.weight
            return w if w.shape[0] == self.units else parallel.gather_weight(w)
        ins = [getattr(self, f"i{g}") for g in self.gates]
        hids = [getattr(self, f"h{g}") for g in self.gates]
        return [torch.cat([weight(l) for l in ins]),
                torch.cat([weight(l) for l in hids]),
                torch.cat([bias(l) for l in ins]),
                torch.cat([bias(l) for l in hids])]


def _flip_prefixes(x, lengths):
    """Each row's first ``lengths[b]`` steps reversed, the rest in place:
    index n - 1 - t for t < n, t otherwise (Flax's ``flip_sequences`` at
    every valid step). A permutation that is its own inverse, gathered on
    the device, so its backward adds each element exactly once."""
    t = torch.arange(x.shape[1], device=x.device)
    n = lengths[:, None]
    idx = torch.where(t < n, n - 1 - t, t)
    return torch.take_along_dim(x, idx[..., None], dim=1)


_tallies = threading.local()  # .open: the Counters of ``tallying_rnn_runs``
_sides = threading.local()  # .by_device: device -> (stream, _SideCaller)
# cudnnRNNMode_t of a cell kind: CUDNN_LSTM, CUDNN_GRU
_CUDNN_MODES = {"lstm": 2, "gru": 3}


def rnn_route(num_cells, lengths, cudnn=False, capturing=False):
    """How ``run_rnn`` runs a layer of ``num_cells`` directions given
    ``lengths`` or None, where ``cudnn`` says that its single-direction
    calls go to cuDNN (``torch.backends.cudnn.is_acceptable`` of its input:
    a CUDA tensor of half, float or double, cuDNN on) and ``capturing``
    that a CUDA graph captures it: None for one call (one direction, or no
    lengths: one bidirectional call); "forked" for the two single-direction
    calls run concurrently, where both hold; "serial" for the two calls one
    after the other otherwise. Run eagerly, a fork's host work (a hand-off
    to the side thread for each cuDNN call) costs more than the overlap
    saves."""
    if num_cells != 2 or lengths is None:
        return None
    return "forked" if cudnn and capturing else "serial"


@contextlib.contextmanager
def tallying_rnn_runs(tally):
    """Within it, every frame-masked two-direction layer run on this thread
    also adds one to ``tally[route]`` (a ``collections.Counter``), and to
    the tallies of the enclosing calls: what a program's run or capture
    ran, which ``train/graphs.py`` puts on its spans."""
    if not hasattr(_tallies, "open"):
        _tallies.open = []
    _tallies.open.append(tally)
    try:
        yield tally
    finally:
        _tallies.open.pop()


def _count_run(route):
    for tally in getattr(_tallies, "open", ()):
        tally[route] += 1


class _SideCaller:
    """A thread of its own that makes calls for its caller and waits for
    them: ``caller(fn)`` returns ``fn()`` run there, or raises what it
    raised. PyTorch keeps one cuDNN handle a thread, and cuDNN launches a
    recurrent layer's per-step kernels on the internal streams of the
    calling thread's handle, so two recurrent calls made on one thread run
    one after the other whatever streams they are given; a call made here
    runs on another handle, beside them. The thread ends when the caller
    is collected, or at exit."""

    def __init__(self):
        jobs = self._jobs = queue.SimpleQueue()
        thread = threading.Thread(target=_side_calls, args=(jobs,),
                                  daemon=True, name="lidbox-rnn-side")
        thread.start()
        weakref.finalize(self, _stop_side_calls, jobs, thread)

    def __call__(self, fn):
        done = concurrent.futures.Future()
        self._jobs.put((fn, done))
        return done.result()


def _stop_side_calls(jobs, thread):
    """End a ``_SideCaller``'s thread and wait for it: at exit, before the
    interpreter finalizes, as a thread that has made CUDA calls aborts the
    process if it ends while the interpreter finalizes."""
    jobs.put(None)
    if thread is not threading.current_thread():
        thread.join()


def _side_calls(jobs):
    while (job := jobs.get()) is not None:
        fn, done = job
        try:
            result = fn()
        except BaseException as fault:  # raised in the caller's thread
            done.set_exception(fault)
        else:
            done.set_result(result)
        del job, fn, done  # hold no call's tensors while idle


def _side(device):
    """(``device``'s second stream, the ``_SideCaller`` that makes the
    backward directions' cuDNN calls) of this thread, made at its first
    use and shared by every layer and every capture of the thread. One
    pair a thread: a stream or a handle's internal stream forked into a
    capture takes in whatever any thread enqueues on it, so a capture on
    one thread must not see another's layers. Making it makes one cuDNN
    call on the caller's thread (``_open_handle``), so that ``run_rnn``'s
    eager runs, a capture's warm-up steps among them, set up the cuDNN
    handle the capture's forked calls use."""
    sides = getattr(_sides, "by_device", None)
    if sides is None:
        sides = _sides.by_device = {}
    side = sides.get(device)
    if side is None:
        stream, caller = torch.cuda.Stream(device), _SideCaller()
        caller(functools.partial(_open_handle, stream))
        side = sides[device] = (stream, caller)
    return side


def _open_handle(stream):
    """One cuDNN GRU call of one unit on ``stream``, waited for: PyTorch
    makes a thread's cuDNN handle at its first cuDNN call, which a graph's
    capture must not be the first to make."""
    with torch.cuda.stream(stream), torch.no_grad():
        x = torch.zeros(1, 1, 1, device=stream.device)
        w = torch.zeros(3, 1, device=stream.device)
        torch.gru(x, x, [w, w, w[:, 0], w[:, 0]], True, 1, 0.0, False,
                  False, True)
    stream.synchronize()


class _SideRNN(torch.autograd.Function):
    """One direction of a recurrent layer through cuDNN, its forward and
    its backward each called by ``caller`` (a ``_SideCaller``) on the
    current stream: ``_cudnn_rnn``, the call ``torch.gru`` and
    ``torch.lstm`` make on a CUDA device, with their arguments (one layer,
    batch first, no dropout, the cell's four weights, zero initial states
    ``h0``), and ``_cudnn_rnn_backward``, the call their autograd makes.
    Returns the outputs [B, T, units]."""

    @staticmethod
    def forward(ctx, caller, kind, units, train, x, h0, *weights):
        stream = torch.cuda.current_stream(x.device)
        args = (_CUDNN_MODES[kind], units, 0, 1, True, 0.0, train, False,
                [], None)
        cx = h0 if kind == "lstm" else None

        def call():
            with torch.cuda.stream(stream), torch.no_grad():
                return torch.ops.aten._cudnn_rnn(
                    x, list(weights), len(weights), None, h0, cx, *args)
        out, _, _, reserve, weight_buf = caller(call)
        if train:
            ctx.caller, ctx.kind, ctx.args = caller, kind, args
            ctx.save_for_backward(x, h0, out, reserve, weight_buf, *weights)
        return out

    @staticmethod
    def backward(ctx, grad):
        if ctx.caller is None:
            raise RuntimeError("a forked recurrent direction's backward ran "
                               "twice: cuDNN's backward consumes its reserve "
                               "(retain_graph is not supported)")
        x, h0, out, reserve, weight_buf, *weights = ctx.saved_tensors
        stream = torch.cuda.current_stream(x.device)
        cx = h0 if ctx.kind == "lstm" else None
        mask = [ctx.needs_input_grad[4], False, False,
                any(ctx.needs_input_grad[6:])]

        def call():
            with torch.cuda.stream(stream), torch.no_grad():
                return torch.ops.aten._cudnn_rnn_backward(
                    x, list(weights), len(weights), weight_buf, h0, cx, out,
                    grad, None, None, *ctx.args, reserve, mask)
        dx, _, _, dw = ctx.caller(call)
        ctx.caller = None
        return (None, None, None, None, dx, None,
                *(dw if mask[3] else [None] * len(weights)))


def _forked(first, second, device):
    """(``first()``, ``second()``): ``first`` on the current stream,
    ``second`` on ``device``'s side stream, forked from the current stream
    before ``first`` and joined back after ``second``; ``second`` is given
    the ``_SideCaller`` for its cuDNN calls. Under a CUDA graph's capture,
    where ``run_rnn`` calls it, the two become parallel branches of the one
    graph. The tensors that cross the streams are the caller's inputs,
    alive until this returns, and ``second``'s outputs, read only after
    the join; the tensors ``second`` reads in its backward it allocates on
    the side stream (its gather's saved input lends only its shape), so
    the caching allocator never hands a block one stream still reads to
    the other. Autograd runs each backward op on its forward op's stream,
    so the backward passes are forked the same way. ``first`` is called
    first, as the serial route calls it: autograd then adds up the
    gradients of a tensor that feeds both in the same order."""
    current = torch.cuda.current_stream(device)
    stream, caller = _side(device)
    stream.wait_stream(current)
    a = first()
    with torch.cuda.stream(stream):
        b = second(caller)
    current.wait_stream(stream)
    return a, b


def run_rnn(cells, x, lengths=None):
    """One cuDNN (or CPU) RNN layer of one or two directions over
    [B, T, F] -> [B, T, D * units].

    ``cells`` is (forward,) or (forward, backward) ``RNNCell``s. Without
    ``lengths`` it is one call of both directions. With ``lengths`` (on the
    device; under 1 run as 1) each direction is a single-direction call
    over the whole padded batch, Flax's ``nn.RNN`` with ``seq_lengths``:
    the forward direction's outputs at valid steps do not depend on the
    padding after them, and the backward direction runs over each row's
    valid prefix reversed (``_flip_prefixes``) and is flipped back, Flax's
    ``reverse=True, keep_order=True``. Outputs past a row's length are
    zero (the JAX package's are unspecified there and must be masked
    downstream). Nothing is read back to the host, so a CUDA graph
    captures it.

    One bidirectional cuDNN call, which runs its directions side by side,
    takes per-row lengths only as a host array (``pack_padded_sequence``),
    which a graph cannot capture. So where a CUDA graph captures a masked
    layer whose calls go to cuDNN, its two calls run concurrently instead
    (``rnn_route`` "forked", ``_forked``): the backward direction's chain on
    a second stream, its cuDNN calls, forward and backward, made on a
    second cuDNN handle (``_SideRNN``), the same calls on the same inputs
    as the serial route, which runs everywhere else: eagerly, on the CPU,
    and in dtypes cuDNN refuses (bfloat16), where ``torch.gru`` runs
    PyTorch's own kernels. An eager run on the card also sets up the side
    handle (``_side``) that a capture after it forks onto. Each masked
    two-direction run counts by route in ``tallying_rnn_runs``."""
    kind = cells[0].kind
    fn = torch.lstm if kind == "lstm" else torch.gru
    # cuDNN keeps what its backward needs only in training mode
    train = torch.is_grad_enabled()

    def run(inputs, cells):
        h0 = inputs.new_zeros(len(cells), inputs.shape[0], cells[0].units)
        hx = (h0, h0) if kind == "lstm" else h0
        weights = [w for c in cells for w in c.flat_weights()]
        return fn(inputs, hx, weights, True, 1, 0.0, train, len(cells) == 2,
                  True)[0]

    def run_side(caller, inputs, cells):
        h0 = inputs.new_zeros(1, inputs.shape[0], cells[0].units)
        return _SideRNN.apply(caller, kind, cells[0].units, train, inputs,
                              h0, *cells[0].flat_weights())
    if lengths is None:
        return run(x, cells)
    lengths = torch.clamp(lengths.to(device=x.device, dtype=torch.int64),
                          min=1)
    cudnn = torch.backends.cudnn.is_acceptable(x)
    route = rnn_route(len(cells), lengths, cudnn,
                      cudnn and torch.cuda.is_current_stream_capturing())
    if route is None:
        y = run(x, cells)
    else:
        _count_run(route)

        def backward(run):
            return _flip_prefixes(run(_flip_prefixes(x, lengths), cells[1:]),
                                  lengths)
        if route == "forked":
            yf, yb = _forked(
                lambda: run(x, cells[:1]),
                lambda caller: backward(functools.partial(run_side, caller)),
                x.device)
        else:
            if cudnn:  # a capture after this run forks onto its handle
                _side(x.device)
            yf, yb = run(x, cells[:1]), backward(run)
        y = torch.cat([yf, yb], dim=-1)
    valid = torch.arange(x.shape[1], device=x.device) < lengths[:, None]
    return torch.where(valid[..., None], y, y.new_zeros(()))


class LSTMLayer(nn.Module):
    """Unidirectional LSTM over [B, T, F] (Flax ``nn.RNN`` of an
    ``OptimizedLSTMCell``). With ``lengths``, return_sequences=False takes
    each row's last valid step."""

    def __init__(self, in_features, units, return_sequences=True):
        super().__init__()
        self.return_sequences = return_sequences
        self.OptimizedLSTMCell_0 = RNNCell("lstm", in_features, units)

    def forward(self, x, lengths=None):
        y = run_rnn((self.OptimizedLSTMCell_0,), x, lengths)
        if self.return_sequences:
            return y
        return y[:, -1] if lengths is None else _final_step(y, lengths)


class BidirectionalRNN(nn.Module):
    """Bidirectional LSTM/GRU with concat merge (Keras Bidirectional),
    Flax's forward cell ``<Cell>_0`` and backward cell ``<Cell>_1``.

    With ``lengths`` the backward pass reads only each row's valid prefix
    (``run_rnn``: two single-direction calls on the same weights; on a
    CUDA device they run concurrently, on two streams and two cuDNN
    handles, forked and joined inside the layer, since one bidirectional
    call takes lengths only from the host).
    return_sequences=False concatenates the forward's last valid step with
    the backward's index 0 (Keras Bidirectional)."""

    def __init__(self, in_features, units, cell="lstm",
                 return_sequences=True):
        super().__init__()
        self.return_sequences = return_sequences
        name = "OptimizedLSTMCell" if cell == "lstm" else "GRUCell"
        self.cell_names = (f"{name}_0", f"{name}_1")
        for n in self.cell_names:
            self.add_module(n, RNNCell(cell, in_features, units))

    def forward(self, x, lengths=None):
        y = run_rnn(tuple(getattr(self, n) for n in self.cell_names), x,
                    lengths)
        if self.return_sequences:
            return y
        units = y.shape[-1] // 2
        yf, yb = y[..., :units], y[..., units:]
        yf_final = yf[:, -1] if lengths is None else _final_step(yf, lengths)
        return torch.cat([yf_final, yb[:, 0]], dim=-1)

"""
ECAPA-TDNN, Desplanques, Thienpondt and Demuynck (2020) "ECAPA-TDNN:
Emphasized Channel Attention, Propagation and Aggregation in TDNN Based
Speaker Verification", Proc. Interspeech 2020 (arXiv:2005.07143), with the
classifier head of SpeechBrain's VoxLingua107 language identifier
(``speechbrain/lang-id-voxlingua107-ecapa``; model code
``speechbrain/lobes/models/ECAPA_TDNN.py`` and ``Xvector.py::Classifier``).
The defaults are that model's widths. The JAX package has no counterpart:
the key is one of the port's own (``models.PORT_ONLY_KEYS``).

Activations run channels first, [B, C, T], for cuDNN's convolutions.
``TDNN(i -> o, k, d)`` is a Conv1d with zero "same" padding and a bias,
then ReLU, then BatchNorm (epsilon 1e-5, torch's momentum 0.1).

- input: x - its mean over the row's frames;
- block 0: TDNN(F -> C, k0, d0);
- SE-Res2Net block b (b = 1 .. n, kernel k_b, dilation d_b), around a
  residual: TDNN(C -> C, 1); the channels in ``scale`` chunks x_0 ..,
  y_0 = x_0, y_1 = T_1(x_1), y_i = T_i(x_i + y_{i-1}), T_i =
  TDNN(C/scale -> C/scale, k_b, d_b), concatenated; TDNN(C -> C, 1); the
  squeeze-excitation s = sigmoid(W2 relu(W1 mean_t(x) + b1) + b2), x = s x;
- MFA: the blocks' outputs concatenated, TDNN(nC -> C', k, d);
- attentive statistics pooling with global context: mean and standard
  deviation of h over time (the variance clamped at 1e-12), attention
  a = Conv(A -> C')(tanh(TDNN(3C' -> A, 1)([h; mean; std]))), softmax of a
  over time per channel, then the weighted mean and standard deviation,
  [B, 2C'];
- embedding: BatchNorm(2C'), Linear(2C' -> E) (``output="embedding"``);
- classifier: LeakyReLU(0.01), BatchNorm(E), then per block Linear, LeakyReLU,
  BatchNorm, and Linear to the outputs, log-softmax.

With a frame ``mask`` [B, T] (a padded batch: the trainer's VAD crops,
``Trainer._apply``), every convolution reads zeros past each row's
length and every statistic over time runs over the row's valid frames
(BatchNorm's over the batch's valid frames), so a row's result does not
depend on its padding. A row with no valid frame scores finite: the counts
are floored at 1 and its attention spans every frame. No value is read on
the host, so a CUDA graph captures the step. Each statistic over frames
(the input mean, a training BatchNorm, the squeeze, the pooling) counts
``stats_masked`` or ``stats_full`` (``observability.count``), and the
blocks run in ``lidbox.ecapa.<block>`` spans.

Departures from SpeechBrain: zero "same" padding where it reflects; masked
BatchNorm statistics where it counts padded frames; the running variance
biased, as ``layers.BatchNorm`` keeps it, where torch's is unbiased; the
port's log-Mel features (``ops/logmel.py``) where it takes Fbank.
"""
import math
from typing import NamedTuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from lidbox_tpu_torch.train import observability

from .layers import BatchNorm, Dense
from .model_api import Model, as_embedding_extractor  # noqa: F401

CHANNELS = (1024, 1024, 1024, 1024, 3072)
KERNEL_SIZES = (5, 3, 3, 3, 1)
DILATIONS = (1, 2, 3, 4, 1)
# torch's BatchNorm1d constants; momentum in ``layers.BatchNorm``'s sense,
# the weight of the old running statistics (torch's 0.1)
BN_EPSILON = 1e-5
BN_MOMENTUM = 0.9
STD_CLAMP = 1e-12
LEAKY_SLOPE = 0.01


class Frames(NamedTuple):
    """A padded batch's frames, [B, T] ``mask`` broadcast for [B, C, T]."""
    mask: torch.Tensor    # [B, T] bool, the valid frames
    weight: torch.Tensor  # [B, 1, T], 1 at a valid frame, else 0
    count: torch.Tensor   # [B, 1, 1] float32, valid frames floored at 1
    fill: torch.Tensor    # [B, 1, T] bool: padding of a row with frames

    @classmethod
    def of(cls, mask, dtype):
        weight = mask[:, None, :].to(dtype)
        valid = mask.to(torch.float32).sum(dim=1)
        fill = ~mask[:, None, :] & (valid > 0)[:, None, None]
        return cls(mask, weight, torch.clamp(valid, min=1.0)[:, None, None],
                   fill)


def _statistic(frames):
    observability.count("stats_full" if frames is None else "stats_masked")


def time_mean(x, frames=None):
    """[B, C, 1] mean of [B, C, T] over each row's valid frames."""
    _statistic(frames)
    if frames is None:
        return x.mean(dim=2, keepdim=True)
    acc = torch.promote_types(x.dtype, torch.float32)
    return ((x * frames.weight).sum(dim=2, keepdim=True).to(acc)
            / frames.count).to(x.dtype)


def _weighted_moments(x, weights):
    """[B, C, 1] mean and standard deviation of [B, C, T] under per-frame
    ``weights`` that sum to one over time."""
    mean = (weights * x).sum(dim=2, keepdim=True)
    var = (weights * torch.square(x - mean)).sum(dim=2, keepdim=True)
    return mean, torch.sqrt(torch.clamp(var, min=STD_CLAMP))


class TDNN(nn.Module):
    """Conv1d (zero "same" padding, bias), ReLU, BatchNorm over [B, C, T];
    zeros past each row's length under ``frames``."""

    def __init__(self, in_channels, out_channels, kernel_size, dilation=1):
        super().__init__()
        self.conv = nn.Conv1d(in_channels, out_channels, kernel_size,
                              dilation=dilation, padding="same")
        self.norm = BatchNorm(out_channels, axis=1, epsilon=BN_EPSILON,
                              momentum=BN_MOMENTUM)

    def forward(self, x, frames=None):
        if self.training:
            _statistic(frames)
        x = self.norm(F.relu(self.conv(x)),
                      None if frames is None else frames.mask)
        return x if frames is None else x * frames.weight


class Res2Net(nn.Module):
    """The channels in ``scale`` chunks, each after the first through a
    TDNN that also reads the previous chunk's output."""

    def __init__(self, channels, kernel_size, dilation, scale):
        super().__init__()
        if channels % scale:
            raise ValueError(f"channels ({channels}) must divide into "
                             f"scale={scale} chunks")
        self.scale = scale
        width = channels // scale
        self.blocks = nn.ModuleList(TDNN(width, width, kernel_size, dilation)
                                    for _ in range(scale - 1))

    def forward(self, x, frames=None):
        chunks = torch.chunk(x, self.scale, dim=1)
        ys = [chunks[0]]
        for i, block in enumerate(self.blocks, 1):
            ys.append(block(chunks[i] if i == 1 else chunks[i] + ys[-1],
                            frames))
        return torch.cat(ys, dim=1)


class SqueezeExcitation(nn.Module):
    """Channel gates from the time mean: sigmoid(W2 relu(W1 s + b1) + b2)."""

    def __init__(self, channels, se_channels):
        super().__init__()
        self.conv1 = nn.Conv1d(channels, se_channels, 1)
        self.conv2 = nn.Conv1d(se_channels, channels, 1)

    def forward(self, x, frames=None):
        s = time_mean(x, frames)
        return torch.sigmoid(self.conv2(F.relu(self.conv1(s)))) * x


class SERes2NetBlock(nn.Module):
    def __init__(self, channels, kernel_size, dilation, scale, se_channels):
        super().__init__()
        self.tdnn1 = TDNN(channels, channels, 1)
        self.res2net = Res2Net(channels, kernel_size, dilation, scale)
        self.tdnn2 = TDNN(channels, channels, 1)
        self.se = SqueezeExcitation(channels, se_channels)

    def forward(self, x, frames=None):
        y = self.res2net(self.tdnn1(x, frames), frames)
        return self.se(self.tdnn2(y, frames), frames) + x


class AttentiveStatisticsPooling(nn.Module):
    """[B, C, T] -> [B, 2C]: the attention-weighted mean and standard
    deviation over time, the attention per channel and frame computed from
    the frame and the utterance's mean and standard deviation."""

    def __init__(self, channels, attention_channels):
        super().__init__()
        self.tdnn = TDNN(3 * channels, attention_channels, 1)
        self.conv = nn.Conv1d(attention_channels, channels, 1)

    def forward(self, x, frames=None):
        _statistic(frames)
        steps = x.shape[2]
        if frames is None:
            mean, std = _weighted_moments(x, 1.0 / steps)
        else:
            mean, std = _weighted_moments(
                x, (frames.weight / frames.count).to(x.dtype))
        context = torch.cat([x, mean.expand(-1, -1, steps),
                             std.expand(-1, -1, steps)], dim=1)
        a = self.conv(torch.tanh(self.tdnn(context, frames)))
        if frames is not None:
            a = a.masked_fill(frames.fill, -math.inf)
        _statistic(frames)
        mean, std = _weighted_moments(x, torch.softmax(a, dim=2))
        return torch.cat([mean, std], dim=1).squeeze(2)


class ECAPATDNN(nn.Module):
    def __init__(self, input_dim, num_outputs, channels=CHANNELS,
                 kernel_sizes=KERNEL_SIZES, dilations=DILATIONS,
                 res2net_scale=8, se_channels=128, attention_channels=128,
                 embedding_dim=256, classifier_blocks=1,
                 classifier_neurons=512):
        super().__init__()
        if not len(channels) == len(kernel_sizes) == len(dilations) >= 3:
            raise ValueError("channels, kernel_sizes and dilations need one "
                             "entry a block (block 0, the SE-Res2Net "
                             "blocks, MFA)")
        c = list(channels)
        self.blocks = nn.ModuleList(
            [TDNN(input_dim, c[0], kernel_sizes[0], dilations[0])]
            + [SERes2NetBlock(c[i], kernel_sizes[i], dilations[i],
                              res2net_scale, se_channels)
               for i in range(1, len(c) - 1)])
        self.mfa = TDNN(sum(c[1:-1]), c[-1], kernel_sizes[-1], dilations[-1])
        self.asp = AttentiveStatisticsPooling(c[-1], attention_channels)
        self.asp_bn = BatchNorm(2 * c[-1], epsilon=BN_EPSILON,
                                momentum=BN_MOMENTUM)
        self.fc = Dense(2 * c[-1], embedding_dim)
        self.norm = BatchNorm(embedding_dim, epsilon=BN_EPSILON,
                              momentum=BN_MOMENTUM)
        width, dnn = embedding_dim, []
        for _ in range(classifier_blocks):
            block = nn.Module()
            block.linear = Dense(width, classifier_neurons)
            block.norm = BatchNorm(classifier_neurons, epsilon=BN_EPSILON,
                                   momentum=BN_MOMENTUM)
            dnn.append(block)
            width = classifier_neurons
        self.dnn = nn.ModuleList(dnn)
        self.out = Dense(width, num_outputs)

    def forward(self, x, mask=None, output="logits", generator=None):
        """Log-probabilities [B, num_outputs] of [B, T, F] features (frame
        ``mask`` [B, T] for a padded batch); ``output="embedding"``: the
        [B, embedding_dim] embedding."""
        x = x.transpose(1, 2)
        frames = None if mask is None else Frames.of(mask, x.dtype)
        span = observability.span
        with span("lidbox.ecapa.input"):
            x = x - time_mean(x, frames)
            if frames is not None:
                x = x * frames.weight
        with span("lidbox.ecapa.block0"):
            x = self.blocks[0](x, frames)
        outs = []
        for i, block in enumerate(self.blocks[1:], 1):
            with span(f"lidbox.ecapa.block{i}"):
                x = block(x, frames)
            outs.append(x)
        with span("lidbox.ecapa.mfa"):
            x = self.mfa(torch.cat(outs, dim=1), frames)
        with span("lidbox.ecapa.asp"):
            x = self.asp(x, frames)
        with span("lidbox.ecapa.head"):
            x = self.fc(self.asp_bn(x))
            if output == "embedding":
                return x
            x = self.norm(F.leaky_relu(x, LEAKY_SLOPE))
            for block in self.dnn:
                x = block.norm(F.leaky_relu(block.linear(x), LEAKY_SLOPE))
            return torch.log_softmax(self.out(x), dim=-1)


def create(input_shape, num_outputs, channels=CHANNELS,
           kernel_sizes=KERNEL_SIZES, dilations=DILATIONS, res2net_scale=8,
           se_channels=128, attention_channels=128, embedding_dim=256,
           classifier_blocks=1, classifier_neurons=512, device="cuda"):
    """The model at SpeechBrain's VoxLingua107 widths by default."""
    return Model(ECAPATDNN(int(input_shape[-1]), num_outputs,
                           channels=tuple(channels),
                           kernel_sizes=tuple(kernel_sizes),
                           dilations=tuple(dilations),
                           res2net_scale=res2net_scale,
                           se_channels=se_channels,
                           attention_channels=attention_channels,
                           embedding_dim=embedding_dim,
                           classifier_blocks=classifier_blocks,
                           classifier_neurons=classifier_neurons),
                 input_shape=tuple(input_shape), name="ECAPA-TDNN",
                 device=device)

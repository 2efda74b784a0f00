"""
Shared layers of the model zoo, in PyTorch (counterpart of
``lidbox_tpu.models.layers``).

Activations keep the JAX package's ``[batch, time, channels]`` layout
between layers; the time-pooling layers take an optional boolean frame
``mask`` so padded batches reproduce variable-length numerics.
"""
import torch
import torch.nn as nn
import torch.nn.functional as F

TIME_AXIS = 1
STDDEV_SQRT_MIN_CLIP = 1e-10


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


class FrameLayer(nn.Module):
    """Causal 1D convolution "frame layer" of the x-vector TDNN stack
    (reference: lidbox/models/xvector.py:38-39): left pad k - 1, so stride
    s gives ceil(T / s) frames. [B, T, C_in] -> [B, ceil(T / s), filters]."""

    def __init__(self, in_channels, filters, kernel_size, strides,
                 activation="relu"):
        super().__init__()
        self.kernel_size = kernel_size
        self.activation = activation
        self.conv = nn.Conv1d(in_channels, filters, kernel_size,
                              stride=strides)

    def forward(self, x):
        x = F.pad(x.transpose(1, 2), (self.kernel_size - 1, 0))
        x = self.conv(x).transpose(1, 2)
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
        if not self.training or self.rate == 0:
            return x
        keep = 1.0 - self.rate
        probs = torch.full((x.shape[0], 1, x.shape[2]), keep,
                           dtype=torch.float32, device=x.device)
        mask = torch.bernoulli(probs, generator=generator).to(x.dtype)
        return x * mask / keep

"""
X-vector with a 2D CNN frequency front-end
(reference: lidbox/models/xvector_2d.py; JAX counterpart
lidbox_tpu.models.xvector_2d, whose parameter names this module keeps).

The image is [B, 1, T, F] (NCHW with the JAX package's [B, T, F, 1]
meaning): the (1, k) kernels run over frequency only, so the time axis and
the frame mask pass the front-end unchanged.
"""
import torch.nn as nn
import torch.nn.functional as F

from .layers import (BatchNorm, Conv2d, Dense, FrameLayer,
                     GlobalMeanStddevPooling1D, activation,
                     subsample_frame_mask)
from .model_api import Model, as_embedding_extractor  # noqa: F401

# (filters, freq kernel, freq stride) of the 2-D frame layers
# (reference xvector_2d.py:24-62)
FRAMES_2D = ((256, 5, 1), (128, 3, 2), (64, 3, 3), (32, 3, 3))


class FrameLayer2D(nn.Module):
    """VALID Conv2D + relu + BN block (the JAX block's dropout is never
    set by the model)."""

    def __init__(self, in_channels, filters, kernel_size, strides):
        super().__init__()
        self.conv = Conv2d(in_channels, filters, kernel_size, strides,
                           padding="VALID")
        self.bn = BatchNorm(filters, axis=1)

    def forward(self, x):
        return self.bn(F.relu(self.conv(x)))


def frequency_bins(num_bins):
    """Frequency bins left after the VALID front-end."""
    for _, k, s in FRAMES_2D:
        num_bins = (num_bins - k) // s + 1
    if num_bins < 1:
        raise ValueError("xvector_2d needs at least 24 frequency bins")
    return num_bins


class XVector2D(nn.Module):
    def __init__(self, input_dim, num_outputs, output_activation="log_softmax"):
        super().__init__()
        self.output_activation = output_activation
        in_ch = 1
        for i, (filters, k, s) in enumerate(FRAMES_2D, start=1):
            self.add_module(f"frame2d_{i}",
                            FrameLayer2D(in_ch, filters, (1, k), (1, s)))
            in_ch = filters
        self.frame1 = FrameLayer(frequency_bins(input_dim) * in_ch, 512, 5, 1)
        self.frame2 = FrameLayer(512, 512, 3, 2)
        self.frame3 = FrameLayer(512, 512, 3, 3)
        self.frame4 = FrameLayer(512, 512, 1, 1)
        self.frame5 = FrameLayer(512, 1500, 1, 1)
        self.stats_pooling = GlobalMeanStddevPooling1D()
        self.segment1 = Dense(3000, 512)
        self.segment2 = Dense(512, 512)
        self.output = Dense(512, num_outputs)

    def forward(self, x, mask=None, output="logits", generator=None):
        img = x[:, None]
        for i in range(1, len(FRAMES_2D) + 1):
            img = getattr(self, f"frame2d_{i}")(img)
        # [B, C, T, F'] -> [B, T, F' * C], Flax's [B, T, F', C] flattening
        b, c, t, f = img.shape
        x = img.permute(0, 2, 3, 1).reshape(b, t, f * c)
        x = self.frame1(x)
        x = self.frame2(x)
        x = self.frame3(x)
        x = self.frame4(x)
        x = self.frame5(x)
        if mask is not None:
            mask = subsample_frame_mask(mask, 6, x.shape[1])
        x = self.stats_pooling(x, mask=mask)
        x = self.segment1(x)
        if output == "embedding":
            return x
        x = F.relu(x)
        x = F.relu(self.segment2(x))
        return activation(self.output(x), self.output_activation)


def create(input_shape, num_outputs, output_activation="log_softmax",
           device="cuda"):
    return Model(XVector2D(int(input_shape[-1]), num_outputs,
                           output_activation=output_activation),
                 input_shape=tuple(input_shape), name="x-vector-2D",
                 device=device)

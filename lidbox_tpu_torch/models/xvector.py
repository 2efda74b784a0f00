"""
X-Vector TDNN: five temporal convolutions, stats pooling, two segment
layers. Snyder et al. (2018) "Spoken Language Recognition using X-vectors",
Proc. Odyssey 2018. (reference: lidbox/models/xvector.py; JAX counterpart
lidbox_tpu.models.xvector, whose parameter names this module keeps so
``params_from_flax`` maps one onto the other.)
"""
import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import (FrameLayer, GlobalMeanStddevPooling1D, SpatialDropout1D,
                     subsample_frame_mask)
from .model_api import Model, as_embedding_extractor  # noqa: F401


class XVector(nn.Module):
    def __init__(self, input_dim, num_outputs, channel_dropout_rate=0.0):
        super().__init__()
        self.channel_dropout = (SpatialDropout1D(channel_dropout_rate)
                                if channel_dropout_rate > 0 else None)
        # Frame-layer geometry from reference lidbox/models/xvector.py:53-57.
        self.frame1 = FrameLayer(input_dim, 512, 5, 1)
        self.frame2 = FrameLayer(512, 512, 3, 2)
        self.frame3 = FrameLayer(512, 512, 3, 3)
        self.frame4 = FrameLayer(512, 512, 1, 1)
        self.frame5 = FrameLayer(512, 1500, 1, 1)
        self.stats_pooling = GlobalMeanStddevPooling1D()
        self.segment1 = nn.Linear(3000, 512)
        self.segment2 = nn.Linear(512, 512)
        self.outputs = nn.Linear(512, num_outputs)

    def forward(self, x, mask=None, output="logits", generator=None):
        """``generator`` feeds the channel dropout in training mode."""
        if self.channel_dropout is not None:
            x = self.channel_dropout(x, generator=generator)
        x = self.frame1(x)
        x = self.frame2(x)
        x = self.frame3(x)
        x = self.frame4(x)
        x = self.frame5(x)
        if mask is not None:
            # the strided convs shrink the time axis by 2 * 3
            mask = subsample_frame_mask(mask, 6, x.shape[1])
        x = self.stats_pooling(x, mask=mask)
        # Embedding = segment1 pre-activation (reference xvector.py:70-73).
        x = self.segment1(x)
        if output == "embedding":
            return x
        x = F.relu(x)
        x = F.relu(self.segment2(x))
        return torch.log_softmax(self.outputs(x), dim=-1)


def create(input_shape, num_outputs, channel_dropout_rate=0, name="x-vector",
           device="cuda"):
    return Model(XVector(int(input_shape[-1]), num_outputs,
                         channel_dropout_rate=channel_dropout_rate),
                 input_shape=tuple(input_shape), name=name, device=device)

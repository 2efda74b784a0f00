"""
X-vector with frequency attention after frame5
(reference: lidbox/models/xvector_freq_attention.py; JAX counterpart
lidbox_tpu.models.xvector_freq_attention, whose parameter names this
module keeps).
"""
import torch.nn as nn
import torch.nn.functional as F

from .layers import (Dense, FrameLayer, FrequencyAttention,
                     GlobalMeanStddevPooling1D, activation,
                     subsample_frame_mask)
from .model_api import Model, as_embedding_extractor  # noqa: F401


class XVectorFreqAttention(nn.Module):
    def __init__(self, input_dim, num_outputs, output_activation="log_softmax",
                 freq_attention_bins=60):
        super().__init__()
        self.output_activation = output_activation
        self.frame1 = FrameLayer(input_dim, 512, 5, 1)
        self.frame2 = FrameLayer(512, 512, 3, 2)
        self.frame3 = FrameLayer(512, 512, 3, 3)
        self.frame4 = FrameLayer(512, 512, 1, 1)
        self.frame5 = FrameLayer(512, 1500, 1, 1)
        self.freq_attention = FrequencyAttention(1500, d_f=freq_attention_bins)
        self.stats_pooling = GlobalMeanStddevPooling1D()
        self.segment1 = Dense(3000, 512)
        self.segment2 = Dense(512, 512)
        self.output = Dense(512, num_outputs)

    def forward(self, x, mask=None, output="logits", generator=None):
        x = self.frame1(x)
        x = self.frame2(x)
        x = self.frame3(x)
        x = self.frame4(x)
        x = self.frame5(x)
        x = self.freq_attention(x)
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
           freq_attention_bins=60, device="cuda"):
    return Model(XVectorFreqAttention(int(input_shape[-1]), num_outputs,
                                      output_activation=output_activation,
                                      freq_attention_bins=freq_attention_bins),
                 input_shape=tuple(input_shape),
                 name="x-vector-frequency-attention", device=device)

"""
CNN-LSTM-TDNN with time-frequency attention, Miao, McLoughlin, Yan (2019)
"A New Time-Frequency Attention Mechanism for TDNN and CNN-LSTM-TDNN, with
Application to Language Identification", Proc. Interspeech 2019.
(reference: lidbox/models/clstm.py; JAX counterpart
lidbox_tpu.models.clstm, whose parameter names this module keeps.)
"""
import torch.nn as nn
import torch.nn.functional as F

from .layers import (BatchNorm, Conv2d, Dense, FrameLayer, FrequencyAttention,
                     GaussianNoise, GlobalMeanStddevPooling1D, LSTMLayer,
                     SpatialDropout1D, activation, subsample_frame_mask)
from .model_api import Model, as_embedding_extractor  # noqa: F401


class CLSTM(nn.Module):
    def __init__(self, input_dim, num_outputs, output_activation="log_softmax",
                 use_attention=False, use_conv2d=False, use_lstm=False):
        super().__init__()
        self.output_activation = output_activation
        self.use_attention = use_attention
        self.use_conv2d = use_conv2d
        self.use_lstm = use_lstm
        self.input_noise = GaussianNoise(0.01)
        # channel dropout with noise shape [B, 1, F] (reference clstm.py:49)
        self.channel_dropout = SpatialDropout1D(0.4)
        frame_in = input_dim
        if use_conv2d:
            # [B, 1, T, F] -> stride (1, 6) twice (reference clstm.py:51-60)
            self.conv2d_1 = Conv2d(1, 128, (3, 9), (1, 6))
            self.conv2d_1_bn = BatchNorm(128, axis=1)
            self.conv2d_2 = Conv2d(128, 256, (3, 9), (1, 6))
            self.conv2d_2_bn = BatchNorm(256, axis=1)
            frame_in = 256
        self.frame1 = FrameLayer(frame_in, 512, 5, 1)
        self.frame2 = FrameLayer(512, 512, 3, 2)
        self.frame3 = FrameLayer(512, 512, 3, 3)
        if use_lstm:
            self.lstm = LSTMLayer(512, 512)
        self.frame4 = FrameLayer(512, 512, 1, 1)
        self.frame5 = FrameLayer(512, 1500, 1, 1)
        if use_attention:
            self.freq_attention = FrequencyAttention(1500, d_f=60)
        self.stats_pooling = GlobalMeanStddevPooling1D()
        self.segment1 = Dense(3000, 512)
        self.segment2 = Dense(512, 512)
        self.output = Dense(512, num_outputs)

    def forward(self, x, mask=None, output="logits", generator=None):
        x = self.input_noise(x, generator=generator)
        x = self.channel_dropout(x, generator=generator)
        if self.use_conv2d:
            # The time kernel is SAME (non-causal), so invalid time rows are
            # re-zeroed around every stage: bias, BN and relu of a zero
            # input are nonzero, and the next SAME kernel would read that at
            # the valid boundary.
            tmask = None if mask is None else mask[:, None, :, None].to(x.dtype)
            img = x[:, None]
            if tmask is not None:
                img = img * tmask
            img = F.relu(self.conv2d_1_bn(self.conv2d_1(img)))
            if tmask is not None:
                img = img * tmask
            img = F.relu(self.conv2d_2_bn(self.conv2d_2(img)))
            if tmask is not None:
                img = img * tmask
            # max over the frequency axis: [B, 256, T, F''] -> [B, T, 256]
            x = img.amax(dim=3).transpose(1, 2)
        x = self.frame1(x)
        x = self.frame2(x)
        x = self.frame3(x)
        if self.use_lstm:
            x = self.lstm(x)
        x = self.frame4(x)
        x = self.frame5(x)
        if self.use_attention:
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
           use_attention=False, use_conv2d=False, use_lstm=False,
           device="cuda"):
    return Model(CLSTM(int(input_shape[-1]), num_outputs,
                       output_activation=output_activation,
                       use_attention=use_attention, use_conv2d=use_conv2d,
                       use_lstm=use_lstm),
                 input_shape=tuple(input_shape), name="CLSTM", device=device)

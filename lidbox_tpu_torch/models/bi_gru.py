"""
Bi-GRU classifier, Mateju et al. (2018) "Using Deep Neural Networks for
Identification of Slavic Languages from Acoustic Signal", Proc. Interspeech
2018. (reference: lidbox/models/bi_gru.py; JAX counterpart
lidbox_tpu.models.bi_gru.)
"""
import torch.nn as nn
import torch.nn.functional as F

from .layers import (BatchNorm, BidirectionalRNN, Dense, SpatialDropout1D,
                     activation, mask_to_lengths)
from .model_api import Model, as_embedding_extractor  # noqa: F401


class BiGRU(nn.Module):
    def __init__(self, input_dim, num_outputs, output_activation="log_softmax",
                 channel_dropout_rate=0.0):
        super().__init__()
        self.output_activation = output_activation
        self.channel_dropout = (SpatialDropout1D(channel_dropout_rate)
                                if channel_dropout_rate > 0 else None)
        self.BGRU_1 = BidirectionalRNN(input_dim, 512, cell="gru")
        self.BGRU_2 = BidirectionalRNN(1024, 512, cell="gru",
                                       return_sequences=False)
        self.BGRU_2_bn = BatchNorm(1024)
        self.fc_relu_1 = Dense(1024, 1024)
        self.fc_relu_1_bn = BatchNorm(1024)
        self.fc_relu_2 = Dense(1024, 1024)
        self.fc_relu_2_bn = BatchNorm(1024)
        self.output = Dense(1024, num_outputs)

    def forward(self, x, mask=None, output="logits", generator=None):
        if self.channel_dropout is not None:
            x = self.channel_dropout(x, generator=generator)
        lengths = mask_to_lengths(mask)
        x = self.BGRU_1(x, lengths=lengths)
        x = self.BGRU_2(x, lengths=lengths)
        x = self.BGRU_2_bn(x)
        # Embedding = fc_relu_1 pre-activation (reference bi_gru.py:20-24).
        x = self.fc_relu_1(x)
        if output == "embedding":
            return x
        x = self.fc_relu_1_bn(F.relu(x))
        x = self.fc_relu_2_bn(F.relu(self.fc_relu_2(x)))
        return activation(self.output(x), self.output_activation)


def create(input_shape, num_outputs, output_activation="log_softmax",
           channel_dropout_rate=0, device="cuda"):
    return Model(BiGRU(int(input_shape[-1]), num_outputs,
                       output_activation=output_activation,
                       channel_dropout_rate=channel_dropout_rate),
                 input_shape=tuple(input_shape), name="BGRU", device=device)

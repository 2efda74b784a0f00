"""
MGB-3 dialect CNN with average pooling, Shon, Ali, Glass (2018)
"Convolutional Neural Network and Language Embeddings for End-to-End
Dialect Recognition". (reference: lidbox/models/cnn.py; JAX counterpart
lidbox_tpu.models.cnn.)
"""
import torch.nn as nn
import torch.nn.functional as F

from .layers import (Conv1d, Dense, SpatialDropout1D, activation,
                     global_avg_pool_1d, subsample_frame_mask)
from .model_api import Model, as_embedding_extractor  # noqa: F401


class CNN(nn.Module):
    def __init__(self, input_dim, num_outputs, output_activation="log_softmax",
                 padding="CAUSAL", channel_dropout_rate=0.0):
        super().__init__()
        self.output_activation = output_activation
        self.padding = padding
        self.channel_dropout = (SpatialDropout1D(channel_dropout_rate)
                                if channel_dropout_rate > 0 else None)
        self.conv_1 = Conv1d(input_dim, 500, 5, 1, padding)
        self.conv_2 = Conv1d(500, 500, 7, 2, padding)
        self.conv_3 = Conv1d(500, 500, 1, 1, padding)
        self.conv_4 = Conv1d(500, 3000, 1, 1, padding)
        self.fc_1 = Dense(3000, 1500)
        self.fc_2 = Dense(1500, 600)
        self.output = Dense(600, num_outputs)

    def forward(self, x, mask=None, output="logits", generator=None):
        if mask is not None and self.padding != "CAUSAL":
            # subsample_frame_mask's validity derivation holds for causal
            # left-padding only: SAME convs read past the valid prefix
            raise ValueError("CNN masked forwards require padding='CAUSAL' "
                             f"(got {self.padding!r})")
        if self.channel_dropout is not None:
            x = self.channel_dropout(x, generator=generator)
        x = F.relu(self.conv_1(x))
        x = F.relu(self.conv_2(x))
        x = F.relu(self.conv_3(x))
        x = F.relu(self.conv_4(x))
        if mask is not None:
            mask = subsample_frame_mask(mask, 2, x.shape[1])
        x = global_avg_pool_1d(x, mask=mask)
        # Embedding = fc_1 pre-activation (reference cnn.py:19-22).
        x = self.fc_1(x)
        if output == "embedding":
            return x
        x = F.relu(x)
        x = F.relu(self.fc_2(x))
        return activation(self.output(x), self.output_activation)


def create(input_shape, num_outputs, output_activation="log_softmax",
           padding="CAUSAL", channel_dropout_rate=0, device="cuda"):
    return Model(CNN(int(input_shape[-1]), num_outputs,
                     output_activation=output_activation,
                     padding=padding.upper(),
                     channel_dropout_rate=channel_dropout_rate),
                 input_shape=tuple(input_shape), name="MGB-3_CNN",
                 device=device)

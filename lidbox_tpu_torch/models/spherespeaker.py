"""
SphereSpeaker, Kaseva, Rouhe, Kurimo (2019) "SphereDiar: an effective
speaker diarization system for meeting data", ASRU 2019.
(reference: lidbox/models/spherespeaker.py, VLAD replaced by mean pooling;
JAX counterpart lidbox_tpu.models.spherespeaker.)
"""
import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import (BatchNorm, BidirectionalRNN, Dense, activation,
                     global_avg_pool_1d, l2_normalize, mask_to_lengths)
from .model_api import Model, as_embedding_extractor  # noqa: F401


class SphereSpeaker(nn.Module):
    def __init__(self, input_dim, num_outputs, embedding_dim=1000,
                 output_activation="log_softmax"):
        super().__init__()
        self.output_activation = output_activation
        self.blstm_1 = BidirectionalRNN(input_dim, 250)
        self.blstm_2 = BidirectionalRNN(500, 250)
        self.blstm_3 = BidirectionalRNN(500, 250)
        self.blstm_bn = BatchNorm(1500)
        self.fc_relu = Dense(1500, embedding_dim)
        self.pool_bn = BatchNorm(embedding_dim)
        self.outputs = Dense(embedding_dim, num_outputs)

    def forward(self, x, mask=None, output="logits", generator=None):
        lengths = mask_to_lengths(mask)
        blstm_1 = self.blstm_1(x, lengths=lengths)
        blstm_2 = self.blstm_2(blstm_1, lengths=lengths)
        blstm_3 = self.blstm_3(blstm_2, lengths=lengths)
        x = self.blstm_bn(torch.cat([blstm_1, blstm_2, blstm_3], dim=-1))
        x = F.relu(self.fc_relu(x))
        x = self.pool_bn(global_avg_pool_1d(x, mask=mask))
        x = l2_normalize(x, dim=1)
        # Embedding = the L2-normalized output itself (reference
        # spherespeaker.py:23-26).
        if output == "embedding":
            return x
        return activation(self.outputs(x), self.output_activation)


def create(input_shape, num_outputs, embedding_dim=1000,
           output_activation="log_softmax", device="cuda"):
    return Model(SphereSpeaker(int(input_shape[-1]), num_outputs,
                               embedding_dim=embedding_dim,
                               output_activation=output_activation),
                 input_shape=tuple(input_shape), name="spherespeaker",
                 device=device)

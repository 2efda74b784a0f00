"""
Single-layer LSTM classifier (reference: lidbox/models/lstm.py; JAX
counterpart lidbox_tpu.models.lstm).
"""
import torch.nn as nn

from .layers import Dense, LSTMLayer, activation, mask_to_lengths
from .model_api import Model, as_embedding_extractor  # noqa: F401


class LSTM(nn.Module):
    def __init__(self, input_dim, num_outputs, output_activation="log_softmax",
                 num_units=1024):
        super().__init__()
        self.output_activation = output_activation
        self.lstm = LSTMLayer(input_dim, num_units, return_sequences=False)
        self.output = Dense(num_units, num_outputs)

    def forward(self, x, mask=None, output="logits", generator=None):
        x = self.lstm(x, lengths=mask_to_lengths(mask))
        if output == "embedding":
            return x
        return activation(self.output(x), self.output_activation)


def create(input_shape, num_outputs, output_activation="log_softmax",
           num_units=1024, device="cuda"):
    return Model(LSTM(int(input_shape[-1]), num_outputs,
                      output_activation=output_activation,
                      num_units=num_units),
                 input_shape=tuple(input_shape), name="lstm", device=device)

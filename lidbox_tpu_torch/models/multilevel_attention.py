"""
Multi-level attention, Yu et al. (2018) "Multi-level attention model for
weakly supervised audio classification", DCASE 2018 Workshop.
(reference: lidbox/models/multilevel_attention.py; JAX counterpart
lidbox_tpu.models.multilevel_attention.)
"""
import torch
import torch.nn as nn

from .layers import Dense, DenseBlock, activation
from .model_api import Model, as_embedding_extractor  # noqa: F401


class Attention(nn.Module):
    """Softmax-query x sigmoid-value attention summed over time
    (reference multilevel_attention.py:21-42): the query distribution is
    clipped to [1e-7, 1 - 1e-7] and renormalized over time before
    weighting."""

    def __init__(self, in_features, num_units):
        super().__init__()
        self.fc = Dense(in_features, num_units)

    def forward(self, x, mask=None):
        x = self.fc(x)
        query = torch.clamp(torch.softmax(x, dim=-1), 1e-7, 1.0 - 1e-7)
        if mask is not None:
            # padded frames are zeroed before the over-time renormalization
            query = query * mask[..., None].to(query.dtype)
        # an all-False mask row (a silent clip) yields zeros, not 0/0 = NaN
        # that would poison the whole batch loss
        query = query / torch.clamp(query.sum(dim=1, keepdim=True), min=1e-9)
        return torch.sum(query * torch.sigmoid(x), dim=1)


class MultilevelAttention(nn.Module):
    def __init__(self, input_dim, num_outputs, output_activation="log_softmax",
                 L=2, H=512):
        super().__init__()
        self.output_activation = output_activation
        self.L = L
        in_dim = input_dim
        for level in range(1, L + 1):
            self.add_module(f"dense_block{level}", DenseBlock(in_dim, H, 0.4))
            self.add_module(f"attention{level}", Attention(H, num_outputs))
            in_dim = H
        self.outputs = Dense(L * num_outputs, num_outputs)

    def forward(self, x, mask=None, output="logits", generator=None):
        attention_outputs = []
        for level in range(1, self.L + 1):
            x = getattr(self, f"dense_block{level}")(x, generator=generator)
            attention_outputs.append(
                getattr(self, f"attention{level}")(x, mask=mask))
        concat = torch.cat(attention_outputs, dim=-1)
        if output == "embedding":
            return concat
        return activation(self.outputs(concat), self.output_activation)


def create(input_shape, num_outputs, output_activation="log_softmax", L=2,
           H=512, device="cuda"):
    return Model(MultilevelAttention(int(input_shape[-1]), num_outputs,
                                     output_activation=output_activation,
                                     L=L, H=H),
                 input_shape=tuple(input_shape),
                 name="DNN_multilevel_attention", device=device)

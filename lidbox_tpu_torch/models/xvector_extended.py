"""
Extended x-vector, Villalba et al. (2018) "The JHU-MIT System Description
for NIST SRE18". (reference: lidbox/models/xvector_extended.py; JAX
counterpart lidbox_tpu.models.xvector_extended, whose parameter names this
module keeps.)
"""
import torch.nn as nn
import torch.nn.functional as F

from .layers import (Dense, FrameLayer, GlobalMeanStddevPooling1D, activation,
                     subsample_frame_mask)
from .model_api import Model, as_embedding_extractor  # noqa: F401

# (filters, kernel, stride) of the 10 frame layers (reference
# xvector_extended.py:25-34)
FRAMES = ((512, 5, 1), (512, 1, 1), (512, 3, 2), (512, 1, 1), (512, 3, 3),
          (512, 1, 1), (512, 3, 4), (512, 1, 1), (512, 1, 1), (1500, 1, 1))


class XVectorExtended(nn.Module):
    def __init__(self, input_dim, num_outputs,
                 output_activation="log_softmax"):
        super().__init__()
        self.output_activation = output_activation
        in_dim = input_dim
        for i, (filters, k, s) in enumerate(FRAMES, start=1):
            self.add_module(f"frame{i}", FrameLayer(in_dim, filters, k, s))
            in_dim = filters
        self.stats_pooling = GlobalMeanStddevPooling1D()
        self.segment1 = Dense(3000, 512)
        self.segment2 = Dense(512, 512)
        self.output = Dense(512, num_outputs)

    def forward(self, x, mask=None, output="logits", generator=None):
        for i in range(1, len(FRAMES) + 1):
            x = getattr(self, f"frame{i}")(x)
        if mask is not None:
            mask = subsample_frame_mask(mask, 24, x.shape[1])
        x = self.stats_pooling(x, mask=mask)
        x = self.segment1(x)
        if output == "embedding":
            return x
        x = F.relu(x)
        x = F.relu(self.segment2(x))
        return activation(self.output(x), self.output_activation)


def create(input_shape, num_outputs, output_activation="log_softmax",
           device="cuda"):
    return Model(XVectorExtended(int(input_shape[-1]), num_outputs,
                                 output_activation=output_activation),
                 input_shape=tuple(input_shape), name="x-vector-extended",
                 device=device)

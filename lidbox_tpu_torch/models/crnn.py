"""
CRNN, Bartz et al. (2017) "Language identification using deep convolutional
recurrent neural networks". (reference: lidbox/models/crnn.py; JAX
counterpart lidbox_tpu.models.crnn.)

The reference default output activation is plain softmax, not log_softmax
(reference crnn.py:24). The image is [B, 1, F, T] (NCHW with the JAX
package's [B, F, T, 1] meaning: frequency bins first).
"""
import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import (BatchNorm, BidirectionalRNN, Conv2d, Dense, activation,
                     mask_to_lengths)
from .model_api import Model, as_embedding_extractor  # noqa: F401

# (filters, kernel) of the conv stages (reference crnn.py:30-38)
STAGES = ((16, 7), (32, 5), (64, 3), (128, 3), (256, 3))


class CRNN(nn.Module):
    def __init__(self, input_dim, num_outputs, output_activation="softmax",
                 weight_decay=0.001):
        super().__init__()
        self.output_activation = output_activation
        # the reference's kernel_regularizer=l2(0.001) on the conv stack;
        # ModelWrapper.from_config turns it into a coupled decay of the
        # conv kernels
        self.weight_decay = weight_decay
        in_ch = 1
        for i, (f, k) in enumerate(STAGES, start=1):
            self.add_module(f"conv_{i}", Conv2d(in_ch, f, (k, k)))
            self.add_module(f"conv_{i}_bn", BatchNorm(f, axis=1))
            in_ch = f
        freq = input_dim
        for _ in STAGES:
            freq //= 2
        if freq < 1:
            raise ValueError("crnn needs at least 32 frequency bins")
        self.blstm = BidirectionalRNN(freq * in_ch, 256,
                                      return_sequences=False)
        self.output = Dense(512, num_outputs)

    def forward(self, x, mask=None, output="logits", generator=None):
        img = x.transpose(1, 2)[:, None]
        # Valid time-column count per stage: SAME convs keep it, VALID 2x2
        # pools halve it. Zeroing the invalid columns before every conv
        # gives each stage what a trimmed input's SAME zero padding would
        # (eval mode; train-mode batch norm sees the zeroed columns).
        lengths = mask_to_lengths(mask)
        for i in range(1, len(STAGES) + 1):
            if lengths is not None:
                tmask = (torch.arange(img.shape[3], device=img.device)[None, :]
                         < lengths[:, None])
                img = img * tmask[:, None, None, :].to(img.dtype)
            img = F.relu(getattr(self, f"conv_{i}")(img))
            img = getattr(self, f"conv_{i}_bn")(img)
            img = F.max_pool2d(img, 2, 2)
            if lengths is not None:
                lengths = lengths // 2
        # [B, C, F', T'] -> timesteps first, Flax's [B, T', F', C]
        # flattening (crnn.py:43-46)
        b, c, fr, t = img.shape
        seq = img.permute(0, 3, 2, 1).reshape(b, t, fr * c)
        if lengths is not None:
            lengths = torch.clamp(lengths, min=1)
        x = self.blstm(seq, lengths=lengths)
        if output == "embedding":
            return x
        return activation(self.output(x), self.output_activation)


def create(input_shape, num_outputs, output_activation="softmax",
           weight_decay=0.001, device="cuda"):
    return Model(CRNN(int(input_shape[-1]), num_outputs,
                      output_activation=output_activation,
                      weight_decay=weight_decay),
                 input_shape=tuple(input_shape), name="CRNN", device=device)

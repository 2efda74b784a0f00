"""
BLSTM angular-proximity language-vector extractor, Gelly & Gauvain (2017)
"Spoken Language Identification Using LSTM-Based Angular Proximity",
Proc. Interspeech 2017. (reference: lidbox/models/ap_lstm.py; JAX
counterpart lidbox_tpu.models.ap_lstm.)

No classifier head: outputs L2-normalized language vectors of dim
4 * units, trained with ``losses.AngularProximity``, whose ``predict``
scores them (``score_fn`` of the trainer and the serving entry points).
"""
import torch
import torch.nn as nn

from .layers import (BidirectionalRNN, SpatialDropout1D, global_avg_pool_1d,
                     l2_normalize, mask_to_lengths)
from .model_api import Model, as_embedding_extractor  # noqa: F401


class APLSTM(nn.Module):
    def __init__(self, input_dim, num_lstm_units=62, alpha1=1.0, alpha2=1.0,
                 channel_dropout_rate=0.0):
        super().__init__()
        self.alpha1, self.alpha2 = alpha1, alpha2
        self.channel_dropout = (SpatialDropout1D(channel_dropout_rate)
                                if channel_dropout_rate > 0 else None)
        self.blstm_1 = BidirectionalRNN(input_dim, num_lstm_units)
        self.blstm_2 = BidirectionalRNN(2 * num_lstm_units, num_lstm_units)

    def forward(self, x, mask=None, output="logits", generator=None):
        if self.channel_dropout is not None:
            x = self.channel_dropout(x, generator=generator)
        lengths = mask_to_lengths(mask)
        blstm_1 = self.blstm_1(x, lengths=lengths)
        blstm_2 = self.blstm_2(blstm_1, lengths=lengths)
        concat = torch.cat([self.alpha1 * blstm_1, self.alpha2 * blstm_2],
                           dim=-1)
        return l2_normalize(global_avg_pool_1d(concat, mask=mask), dim=1)


def create(input_shape, num_lstm_units=62, alpha1=1.0, alpha2=1.0,
           channel_dropout_rate=0, num_outputs=None, device="cuda"):
    # num_outputs accepted for registry uniformity; the extractor has no head
    return Model(APLSTM(int(input_shape[-1]), num_lstm_units=num_lstm_units,
                        alpha1=alpha1, alpha2=alpha2,
                        channel_dropout_rate=channel_dropout_rate),
                 input_shape=tuple(input_shape),
                 name="angular_proximity_lstm", device=device)

"""
Simple time-distributed DNN (reference: lidbox/models/dnn.py; JAX
counterpart lidbox_tpu.models.dnn).
"""
import torch.nn as nn
import torch.nn.functional as F

from .layers import Dense, global_avg_pool_1d
from .model_api import Model, as_embedding_extractor  # noqa: F401


class DNN(nn.Module):
    def __init__(self, input_dim, num_outputs):
        super().__init__()
        self.fc_1 = Dense(input_dim, 200)
        self.fc_2 = Dense(200, 400)
        self.fc_3 = Dense(400, 600)
        self.fc_4 = Dense(600, 800)
        self.output = Dense(800, num_outputs)

    def forward(self, x, mask=None, output="logits", generator=None):
        x = F.relu(self.fc_1(x))
        x = F.relu(self.fc_2(x))
        x = F.relu(self.fc_3(x))
        x = F.relu(self.fc_4(x))
        x = global_avg_pool_1d(x, mask=mask)
        if output == "embedding":
            return x
        return self.output(x).log_softmax(dim=-1)


def create(input_shape, num_outputs, device="cuda"):
    return Model(DNN(int(input_shape[-1]), num_outputs),
                 input_shape=tuple(input_shape), name="DNN", device=device)

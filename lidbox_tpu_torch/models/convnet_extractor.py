"""
ResNet50V2 / MobileNetV2 trunk over spectrogram-as-image for training
embedding spaces (reference: lidbox/models/convnet_extractor.py; JAX
counterpart lidbox_tpu.models.convnet_extractor, whose parameter names
this module keeps).

The trunks are the JAX package's compact implementations of the Keras
architectures the reference instantiates with ``weights=None``:

- ResNet50V2: pre-activation bottleneck ResNet, stage depths (3, 4, 6, 3)
  (He et al. 2016, "Identity Mappings in Deep Residual Networks").
- MobileNetV2: inverted residual bottlenecks with expansion 6
  (Sandler et al. 2018).

Images are NCHW, [B, 1, T, F] for the JAX package's [B, T, F, 1]; the
``SAME`` convs and pools pad on Flax's asymmetric split
(``layers.same_padding``), so a strided stage keeps the JAX grid.
"""
import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import (BatchNorm, Conv2d, Dense, SpatialDropout1D, activation,
                     global_avg_pool_1d, max_pool_same)
from .model_api import Model, as_embedding_extractor  # noqa: F401

# both trunks halve each image axis 5 times (SAME: ceil)
TOTAL_STRIDE = 32


class BottleneckV2(nn.Module):
    """Pre-activation bottleneck: BN-relu -> 1x1 -> 3x3 -> 1x1, identity or
    projection shortcut."""

    def __init__(self, in_channels, filters, stride=1, project=False):
        super().__init__()
        self.preact_bn = BatchNorm(in_channels, axis=1)
        self.shortcut = None
        if project or stride > 1 or in_channels != 4 * filters:
            self.shortcut = Conv2d(in_channels, 4 * filters, (1, 1),
                                   (stride, stride))
        self.conv1 = Conv2d(in_channels, filters, (1, 1), bias=False)
        self.bn1 = BatchNorm(filters, axis=1)
        self.conv2 = Conv2d(filters, filters, (3, 3), (stride, stride),
                            bias=False)
        self.bn2 = BatchNorm(filters, axis=1)
        self.conv3 = Conv2d(filters, 4 * filters, (1, 1))

    def forward(self, x):
        pre = F.relu(self.preact_bn(x))
        shortcut = x if self.shortcut is None else self.shortcut(pre)
        y = F.relu(self.bn1(self.conv1(pre)))
        y = F.relu(self.bn2(self.conv2(y)))
        return shortcut + self.conv3(y)


class ResNet50V2(nn.Module):
    out_channels = 2048

    def __init__(self, stage_sizes=(3, 4, 6, 3)):
        super().__init__()
        self.stem_conv = Conv2d(1, 64, (7, 7), (2, 2))
        in_ch = 64
        self.block_names = []
        for stage, blocks in enumerate(stage_sizes):
            filters = 64 * 2 ** stage
            for block in range(blocks):
                stride = 2 if (block == blocks - 1 and stage < 3) else 1
                name = f"stage{stage + 1}_block{block + 1}"
                self.add_module(name, BottleneckV2(in_ch, filters, stride,
                                                   project=block == 0))
                self.block_names.append(name)
                in_ch = 4 * filters
        self.post_bn = BatchNorm(in_ch, axis=1)

    def forward(self, x):
        x = max_pool_same(self.stem_conv(x), (3, 3), (2, 2))
        for name in self.block_names:
            x = getattr(self, name)(x)
        return F.relu(self.post_bn(x))


class InvertedResidual(nn.Module):
    def __init__(self, in_channels, filters, stride=1, expansion=6):
        super().__init__()
        self.residual = stride == 1 and in_channels == filters
        hidden = expansion * in_channels if expansion != 1 else in_channels
        self.expand = None
        if expansion != 1:
            self.expand = Conv2d(in_channels, hidden, (1, 1), bias=False)
            self.expand_bn = BatchNorm(hidden, axis=1)
        self.depthwise = Conv2d(hidden, hidden, (3, 3), (stride, stride),
                                groups=hidden, bias=False)
        self.depthwise_bn = BatchNorm(hidden, axis=1)
        self.project = Conv2d(hidden, filters, (1, 1), bias=False)
        self.project_bn = BatchNorm(filters, axis=1)

    def forward(self, x):
        y = x
        if self.expand is not None:
            y = F.relu6(self.expand_bn(self.expand(y)))
        y = F.relu6(self.depthwise_bn(self.depthwise(y)))
        y = self.project_bn(self.project(y))
        return x + y if self.residual else y


class MobileNetV2(nn.Module):
    out_channels = 1280
    # (expansion, filters, repeats, first-stride)
    CONFIG = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
              (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1))

    def __init__(self):
        super().__init__()
        self.stem_conv = Conv2d(1, 32, (3, 3), (2, 2), bias=False)
        self.stem_bn = BatchNorm(32, axis=1)
        in_ch = 32
        self.block_names = []
        for i, (t, c, n, s) in enumerate(self.CONFIG):
            for j in range(n):
                name = f"block{i + 1}_{j + 1}"
                self.add_module(name, InvertedResidual(
                    in_ch, c, stride=s if j == 0 else 1, expansion=t))
                self.block_names.append(name)
                in_ch = c
        self.head_conv = Conv2d(in_ch, 1280, (1, 1), bias=False)
        self.head_bn = BatchNorm(1280, axis=1)

    def forward(self, x):
        x = F.relu6(self.stem_bn(self.stem_conv(x)))
        for name in self.block_names:
            x = getattr(self, name)(x)
        return F.relu6(self.head_bn(self.head_conv(x)))


TRUNKS = {"resnet50_v2": ResNet50V2, "mobilenet_v2": MobileNetV2}


class ConvnetExtractor(nn.Module):
    def __init__(self, input_dim, num_outputs, core="resnet50_v2",
                 embedding_dim=512, output_activation="log_softmax",
                 channel_dropout_rate=0.0):
        super().__init__()
        self.core = core
        self.output_activation = output_activation
        self.channel_dropout = (SpatialDropout1D(channel_dropout_rate)
                                if channel_dropout_rate > 0 else None)
        trunk = TRUNKS[core]()
        self.add_module(core, trunk)
        freq = -(-input_dim // TOTAL_STRIDE)
        self.embedding = Dense(freq * trunk.out_channels, embedding_dim)
        self.embedding_bn = BatchNorm(embedding_dim)
        self.output = Dense(embedding_dim, num_outputs)

    def forward(self, x, mask=None, output="logits", generator=None):
        """``mask`` support is approximate for this model (unlike the
        causal zoo, which is masked-vs-trimmed exact), as in the JAX
        package: the SAME-padded 2-D convs make frames within one
        receptive field of the pad edge differ from a trimmed forward.
        Padded input frames are zeroed, and the final pooling runs over
        the frames whose window holds a valid input frame."""
        if self.channel_dropout is not None:
            x = self.channel_dropout(x, generator=generator)
        if mask is not None:
            x = x * mask[..., None].to(x.dtype)
        img = getattr(self, self.core)(x[:, None])
        # [B, C, T', F'] -> [B, T', F' * C], Flax's [B, T', F', C] order
        b, c, t, f = img.shape
        seq = img.permute(0, 2, 3, 1).reshape(b, t, f * c)
        pooled_mask = None
        if mask is not None:
            # a coarse frame is valid iff any of its input frames is valid
            t_in = mask.shape[-1]
            m = F.pad(mask.to(torch.int32),
                      (0, max(t * TOTAL_STRIDE - t_in, 0)))
            pooled_mask = m[:, :t * TOTAL_STRIDE].reshape(
                b, t, TOTAL_STRIDE).amax(dim=2) > 0
        # Time-distributed embedding layer (reference
        # convnet_extractor.py:38-42).
        emb = self.embedding(seq)
        if output == "embedding":
            # the reference cuts at the "embedding" layer, keeping the
            # timesteps (convnet_extractor.py:52-54); pooled here to a
            # fixed-size vector
            return global_avg_pool_1d(emb, mask=pooled_mask)
        emb = self.embedding_bn(F.relu(emb))
        pooled = global_avg_pool_1d(emb, mask=pooled_mask)
        return activation(self.output(pooled), self.output_activation)


def create(input_shape, num_outputs, core="resnet50_v2", embedding_dim=512,
           output_activation="log_softmax", channel_dropout_rate=0,
           device="cuda"):
    return Model(ConvnetExtractor(int(input_shape[-1]), num_outputs,
                                  core=core, embedding_dim=embedding_dim,
                                  output_activation=output_activation,
                                  channel_dropout_rate=channel_dropout_rate),
                 input_shape=tuple(input_shape), name=f"{core}_extractor",
                 device=device)

"""The x-vector (Snyder et al. 2018, Odyssey; lidbox/models/xvector.py):
causal frame convolutions with ReLU, mean and standard deviation pooling
over time, segment layers (the first with ReLU after its embedding), and a
log-softmax output. Widths, kernels and strides come from the
configuration's ``frame_layers`` and ``segment_layers``."""
import torch

from . import nn


def param_specs(config):
    """[(name, shape, init)] in the benchmark's weight layout; init is
    ("fan_in", n) for a normal weight of variance 1 / n, or "zeros"."""
    specs, width = [], config["features"]["num_mel_bins"]
    for i, layer in enumerate(config["frame_layers"], 1):
        k = layer["kernel"]
        specs += [(f"frame{i}.conv.weight", (layer["filters"], width, k),
                   ("fan_in", width * k)),
                  (f"frame{i}.conv.bias", (layer["filters"],), "zeros")]
        width = layer["filters"]
    width *= 2  # mean and standard deviation
    names = [f"segment{i}" for i in range(1, len(config["segment_layers"]) + 1)]
    for name, units in zip(names + ["outputs"],
                           config["segment_layers"] + [config["num_outputs"]]):
        specs += [(f"{name}.weight", (units, width), ("fan_in", width)),
                  (f"{name}.bias", (units,), "zeros")]
        width = units
    return specs


def frames_after_strides(num_frames, config):
    for layer in config["frame_layers"]:
        num_frames = -(-num_frames // layer["stride"])
    return num_frames


def forward(params, feats, config, lengths=None):
    """Log-probabilities [B, num_outputs] of [B, T, num_mel_bins] features,
    every frame valid (``lengths`` must be None: a variable-length batch
    goes one utterance at a time)."""
    if lengths is not None:
        raise ValueError("the x-vector reference takes unpadded utterances")
    x = feats
    for i, layer in enumerate(config["frame_layers"], 1):
        x = torch.relu(nn.causal_conv(x, params[f"frame{i}.conv.weight"],
                                      params[f"frame{i}.conv.bias"],
                                      layer["stride"]))
    x = nn.mean_stddev_pooling(x)
    for i in range(1, len(config["segment_layers"]) + 1):
        x = torch.relu(nn.dense(x, params, f"segment{i}"))
    return torch.log_softmax(nn.dense(x, params, "outputs"), dim=-1)


def macs(config, frames):
    """(forward multiply-adds of one utterance of ``frames`` frames, those
    of the first layer)."""
    width, t, total, first = config["features"]["num_mel_bins"], frames, 0, None
    for layer in config["frame_layers"]:
        t = -(-t // layer["stride"])
        layer_macs = t * layer["kernel"] * width * layer["filters"]
        first = layer_macs if first is None else first
        total += layer_macs
        width = layer["filters"]
    width *= 2
    for units in config["segment_layers"] + [config["num_outputs"]]:
        total += width * units
        width = units
    return total, first

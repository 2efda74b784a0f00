"""The Bi-GRU (Mateju et al. 2018, Interspeech; lidbox/models/bi_gru.py):
bidirectional GRU layers (the last one returns the forward direction's last
valid step and the backward direction's first), batch normalization, dense
ReLU layers each followed by batch normalization, and a log-softmax output.
Batch normalization uses the batch's statistics, as in training. Widths
come from the configuration's ``rnn_layers`` and ``dense_layers``."""
import torch

from . import nn

CELLS = ("GRUCell_0", "GRUCell_1")


def param_specs(config):
    """[(name, shape, init)] in the benchmark's weight layout; init is
    ("fan_in", n), "zeros" or "ones"."""
    specs, width = [], config["features"]["num_mel_bins"]
    for i, layer in enumerate(config["rnn_layers"], 1):
        units = layer["units"]
        for cell in CELLS:
            p = f"BGRU_{i}.{cell}"
            for g in "rzn":
                specs += [(f"{p}.i{g}.weight", (units, width), ("fan_in", width)),
                          (f"{p}.i{g}.bias", (units,), "zeros"),
                          (f"{p}.h{g}.weight", (units, units), ("fan_in", units))]
            specs.append((f"{p}.hn.bias", (units,), "zeros"))
        width = 2 * units
    last = f"BGRU_{len(config['rnn_layers'])}_bn"
    norms = [last] + [f"fc_relu_{i}_bn"
                      for i in range(1, len(config["dense_layers"]) + 1)]
    specs += _norm(last, width)
    for i, units in enumerate(config["dense_layers"], 1):
        specs += [(f"fc_relu_{i}.weight", (units, width), ("fan_in", width)),
                  (f"fc_relu_{i}.bias", (units,), "zeros")]
        specs += _norm(norms[i], units)
        width = units
    specs += [("output.weight", (config["num_outputs"], width),
               ("fan_in", width)),
              ("output.bias", (config["num_outputs"],), "zeros")]
    return specs


def _norm(name, width):
    return [(f"{name}.scale", (width,), "ones"),
            (f"{name}.bias", (width,), "zeros"),
            (f"{name}.mean", (width,), "zeros"),
            (f"{name}.var", (width,), "ones")]


def forward(params, feats, config, lengths=None):
    """Log-probabilities [B, num_outputs] of [B, T, num_mel_bins] features
    whose row b has ``lengths[b]`` valid frames (all T when None)."""
    if lengths is None:
        lengths = [feats.shape[1]] * feats.shape[0]
    x = feats
    layers = config["rnn_layers"]
    for i in range(1, len(layers) + 1):
        seq, last = nn.bidirectional_gru(x, lengths, params, f"BGRU_{i}",
                                         CELLS)
        x = seq if i < len(layers) else last
    x = nn.batch_norm_train(x, params, f"BGRU_{len(layers)}_bn")
    for i in range(1, len(config["dense_layers"]) + 1):
        x = torch.relu(nn.dense(x, params, f"fc_relu_{i}"))
        x = nn.batch_norm_train(x, params, f"fc_relu_{i}_bn")
    return torch.log_softmax(nn.dense(x, params, "output"), dim=-1)


def macs(config, frames):
    """(forward multiply-adds of one utterance over ``frames`` valid
    frames, those of the first layer): both directions' three gates over
    [input + units] x units per frame, then the dense and output
    layers."""
    width, total, first = config["features"]["num_mel_bins"], 0, None
    for layer in config["rnn_layers"]:
        u = layer["units"]
        total += 2 * frames * 3 * u * (width + u)
        first = 2 * frames * 3 * u * width if first is None else first
        width = 2 * u
    for units in config["dense_layers"] + [config["num_outputs"]]:
        total += width * units
        width = units
    return total, first

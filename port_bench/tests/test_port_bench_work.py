"""The benchmark's work counts against hand-worked values."""
import json
import os
import sys

import pytest
import torch

from port_bench import program, reference, work

CONFIGS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs")


def config(name):
    with open(os.path.join(CONFIGS, name + ".json")) as f:
        return json.load(f)


def test_logmel_geometry_and_work():
    f = config("xvector")["features"]
    # 64 bands over 0-8000 Hz with lidbox's linspace (divides by 66): the
    # last band tops at mel(8000) * 65/66 = 2797.0 mel (7674 Hz); bin 246
    # (7657.6 Hz, 2794.9 mel) is inside it, bin 247 (7688.7 Hz) is not
    assert work.logmel_geometry(f) == (400, 160, 400, 247, 64)
    # [32, 48000]: 1 + (48000 - 400) // 160 = 298 frames; per frame
    # 2 * (400 * 2 * 247 + 247 * 64) = 426,816 operations
    assert work.logmel_work(32, 48000, f) == (32 * 298 * 426816,
                                              4 * 32 * 48000
                                              + 4 * 32 * 298 * 64)
    assert work.logmel_work(32, 48000, f) == (4070117376, 8585216)
    seconds, by = work.logmel_bound(32, 48000, f)
    assert by == "operations"
    assert seconds == pytest.approx(3 * 4070117376 / 495e12)


def test_xvector_counts():
    c = config("xvector")
    # multiply-adds of one 298-frame utterance: frame layers at 298, 149,
    # 50, 50, 50 frames, then the segment and output layers
    layers = [5 * 64 * 512 * 298, 3 * 512 * 512 * 149, 3 * 512 * 512 * 50,
              512 * 512 * 50, 512 * 1500 * 50,
              3000 * 512, 512 * 512, 512 * 14]
    assert sum(layers) == 258636800
    assert work.forward_flops(c, 298) == 2 * 258636800
    # forward, weight gradients, and input gradients but the first layer's
    assert work.train_flops(c, 298) == 2 * (3 * 258636800 - 48824320)


def test_bi_gru_counts():
    c = config("bi_gru")
    # per valid frame, both directions: 3 gates of [in + units] x units
    per_frame = 2 * 3 * 512 * (64 + 512) + 2 * 3 * 512 * (1024 + 512)
    assert per_frame == 6488064
    dense = 1024 * 1024 + 1024 * 1024 + 1024 * 14
    assert work.forward_flops(c, 1) == 2 * (per_frame + dense) == 17199104
    first = 2 * 3 * 512 * 64
    assert work.train_flops(c, 246) == 2 * (
        3 * (246 * per_frame + dense) - 246 * first)


def test_peaks():
    assert work.model_peak(config("xvector")) == 67e12
    assert work.model_peak(dict(config("xvector"), tf32=True)) == 495e12


STANDIN = '''"""A stand-in plain model: one dense layer over the frames' mean."""
import torch


def param_specs(config):
    n, w = config["num_outputs"], config["features"]["num_mel_bins"]
    return [("out.weight", (n, w), ("fan_in", w)), ("out.bias", (n,), "zeros")]


def forward(params, feats, config, lengths=None):
    x = feats.mean(dim=1) @ params["out.weight"].T + params["out.bias"]
    return torch.log_softmax(x, dim=-1)


def macs(config, frames):
    first = config["features"]["num_mel_bins"] * config["num_outputs"]
    return first, first
'''


def test_plain_model_added_as_a_file(tmp_path, monkeypatch):
    """A configuration whose ``reference`` names a module that exists only
    as a new file beside the plain models is found by its name, with its
    weights and its counts, and no file of the benchmark edited."""
    (tmp_path / "standin.py").write_text(STANDIN)
    monkeypatch.setattr(reference, "__path__",
                        [*reference.__path__, str(tmp_path)])
    name = reference.__name__ + ".standin"
    try:
        c = dict(config("xvector"), reference="standin")
        module = program.reference_model(c)
        assert module.__file__ == str(tmp_path / "standin.py")
        assert work.forward_flops(c, 298) == 2 * 64 * 14
        assert work.train_flops(c, 298) == 2 * (3 * 64 * 14 - 64 * 14)
        w = program.weights(c, 2 ** 31 + 7, torch.device("cpu"))
        assert {k: tuple(v.shape) for k, v in w.items()} == {
            "out.weight": (14, 64), "out.bias": (14,)}
        out = module.forward(w, torch.zeros(2, 5, 64), c)
        assert out.shape == (2, 14)
    finally:
        sys.modules.pop(name, None)

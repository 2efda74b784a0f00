"""What the ECAPA-TDNN configuration adds to the benchmark, on the CPU:
``masked_stats_share`` on made-up span records (beside the other readers
of the program's spans, ``test_port_bench_spans.py``), the attentive
pooling's operations and bytes (``metrics/asp_roofline.py``) and the
reference's multiply-adds against hand counts, and the reference's weight
layout loading into the package's module whole."""
import importlib.util
import json
import os

import pytest
import torch

from port_bench import common, program, reference
from test_port_bench_spans import END, make_run, read, record

CONFIGS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs")


def config(name="ecapa_tdnn"):
    with open(os.path.join(CONFIGS, name + ".json")) as f:
        return json.load(f)


def graph_runs(*counts):
    """A graph span a (name, masked, full), 10 ms apart in the stretch."""
    return [record(name, END + 0.01 * (i + 1), 0.001, kind="fused",
                   launches={}, stats_masked=masked, stats_full=full)
            for i, (name, masked, full) in enumerate(counts)]


def test_masked_stats_share(monkeypatch):
    run = make_run(graph_runs(*[("lidbox.graph.replay", 36, 0)] * 4),
                   monkeypatch)
    assert read("masked_stats_share", run) == 100.0
    records = graph_runs(("lidbox.graph.capture", 108, 0),
                         ("lidbox.graph.replay", 36, 0),
                         ("lidbox.graph.eager", 0, 36),
                         ("lidbox.graph.replay", 36, 0))
    # a span outside the graph runs carries nothing that counts
    records.append(record("lidbox.step", END + 0.02, 0.001, stats_full=9))
    assert read("masked_stats_share", make_run(records, monkeypatch)) == \
        pytest.approx(100 * 180 / 216)
    # the x-vector's replays count nothing; no spans at all
    plain = [record("lidbox.graph.replay", END + 0.01 * i, 0.001,
                    kind="fused", launches={"logmel_kernel": 1})
             for i in range(1, 4)]
    assert read("masked_stats_share", make_run(plain, monkeypatch)) is None
    assert read("masked_stats_share", make_run([], monkeypatch)) is None


def asp_module():
    path = os.path.join(common.HERE, "metrics", "asp_roofline.py")
    spec = importlib.util.spec_from_file_location("asp_roofline", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_asp_work_and_bound():
    asp = asp_module()
    # [32, 3072, 298], 128 attention channels. Forward products per frame:
    # 9216 x 128 + 128 x 3072 = 1,572,864 multiply-adds; two weighted sums
    # of 2 operations per channel and frame; backward twice the forward
    frames = 32 * 298
    forward = 2 * frames * 1572864 + 4 * 3072 * frames
    flops, nbytes = asp.asp_work(32, 3072, 298, 128)
    assert flops == 3 * forward == 90_344_521_728
    # h, the 9216-channel context, the attention weights: 5 x [32, 3072,
    # 298] float32; the [32, 6144] output
    assert nbytes == 4 * (5 * 32 * 3072 * 298 + 32 * 6144) == 586_678_272
    seconds, by = asp.asp_bound(32, 3072, 298, 128, config())
    assert by == "operations"
    assert seconds == pytest.approx(flops / 67e12)


def test_reference_macs():
    c = config()
    macs, first = reference.model("ecapa_tdnn").macs(c, 298)
    # per frame: block 0 60 x 5 x 1024; each SE-Res2Net block 2 x 1024^2 +
    # 7 x 128^2 x 3; MFA 3072^2; the pooling 9216 x 128 + 128 x 3072
    per_frame = (307200 + 3 * (2 * 1024 ** 2 + 7 * 128 * 128 * 3)
                 + 3072 ** 2 + 9216 * 128 + 128 * 3072)
    assert per_frame == 18_640_896
    # once an utterance: 3 squeezes 2 x 1024 x 128, the embedding 6144 x
    # 256, the classifier 256 x 512 + 512 x 107
    once = 3 * 2 * 1024 * 128 + 6144 * 256 + 256 * 512 + 512 * 107
    assert (macs, first) == (298 * per_frame + once, 298 * 307200)


def test_reference_weights_load_into_the_package_strictly():
    from lidbox_tpu_torch import models
    c = config()
    specs = reference.model("ecapa_tdnn").param_specs(c)
    m = models.create(c["model"], (None, c["features"]["num_mel_bins"]),
                      c["num_outputs"], device="cpu")
    weights = common.make_weights(specs, 7, torch.device("cpu"))
    program.load_weights(m.module, weights)
    state = m.module.state_dict()
    assert all(torch.equal(state[k], v) for k, v in weights.items())
    assert m.num_params() == c["parameters"]

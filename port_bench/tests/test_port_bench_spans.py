"""The readers of the program's spans (``spans.py`` and the metrics that
read it) on made-up span records: the traced stretch keeps the spans that
started in it and no other and none once spans were dropped, each reader
returns None with no spans, ``feed_wait_share`` counts a feed's first wait
alone, a capture in the stretch lowers ``replay_share`` and
``logmel_traced_roofline`` divides by the launches the spans carry."""
import collections
import types

import pytest

from lidbox_tpu_torch.train import observability
from port_bench import run as bench_run
from port_bench import spans, work

FEATURES = {"sample_rate": 16000, "frame_length_ms": 25, "frame_step_ms": 10,
            "fft_length": 512, "num_mel_bins": 64, "fmin": 20.0,
            "fmax": 7600.0, "precision": "highest"}
SPAN_READERS = ("feed_wait_share", "stage_ms", "step_dispatch_ms",
                "chunk_dispatch_ms", "chunk_readback_ms", "replay_share",
                "logmel_traced_roofline")
# the window ends at 100 s on the host clock; the traced stretch is 0.5 s
END, TRACED = 100.0, 0.5
_ids = iter(range(1, 10 ** 6))


def record(name, start_s, length_s, parent=None, **attrs):
    return types.SimpleNamespace(
        name=name, id=next(_ids), parent=parent, request=None, thread=1,
        start_ns=round(start_s * 1e9), end_ns=round((start_s + length_s) * 1e9),
        attrs=attrs)


def make_run(records, monkeypatch, kernels=None, shapes=((32, 48000),),
             dropped=0):
    monkeypatch.setattr(observability, "spans", lambda: list(records))
    monkeypatch.setattr(observability, "dropped_spans", lambda: dropped)
    return types.SimpleNamespace(
        window={"start": END - 20.0, "seconds": 20.0},
        trace={"window_s": TRACED, "kernels": collections.Counter(
            kernels or {})},
        cell=types.SimpleNamespace(kernel_shapes=set(shapes)),
        config={"features": FEATURES})


def read(name, run):
    return bench_run.load_reader(name + ".x")(run)


def test_stretch_keeps_only_the_traced_spans(monkeypatch):
    # the profiler starts 0.2 s after the window: the first span marks it
    first = END + 0.2
    inside = [record("lidbox.step", first, 0.001),
              record("lidbox.step", first + 0.3, 0.001),
              record("lidbox.step", first + TRACED - 0.001, 0.001)]
    before = record("lidbox.step", END - 1.0, 0.001)
    after = record("lidbox.step", first + TRACED + 0.01, 0.001)
    unfinished = record("lidbox.step", first + 0.1, 0.0)
    unfinished.end_ns = None
    run = make_run([before] + inside + [unfinished, after], monkeypatch)
    assert spans.stretch(run) == inside
    assert spans.stretch(types.SimpleNamespace(trace=None)) == []
    # a full list cut the records short: no stretch rather than part of one
    run = make_run(inside, monkeypatch, dropped=1)
    assert spans.stretch(run) == []


@pytest.mark.parametrize("name", SPAN_READERS)
def test_readers_return_none_without_spans(name, monkeypatch):
    run = make_run([], monkeypatch, kernels={"logmel_kernel<0>": 0.01})
    assert read(name, run) is None
    # a package that records no spans at all (an older one)
    monkeypatch.delattr(observability, "spans")
    monkeypatch.delattr(observability, "dropped_spans")
    assert read(name, run) is None


def test_span_means_and_shares(monkeypatch):
    t = END + 0.01
    # the card waits at a feed's first wait only: it runs queued steps
    # through the later ones
    waits = [record("lidbox.feed.wait", t, 0.010, first=True),
             record("lidbox.feed.wait", t + 0.1, 0.030, first=False),
             record("lidbox.feed.wait", t + 0.4, 0.005, first=True)]
    stages = [record("lidbox.feed.stage", t, 0.004),
              record("lidbox.feed.stage", t + 0.05, 0.006)]
    steps = [record("lidbox.step", t + 0.2, 0.0002),
             record("lidbox.step", t + 0.21, 0.0004)]
    chunk1 = record("lidbox.serve.chunk", t + 0.3, 0.0005)
    chunk2 = record("lidbox.serve.chunk", t + 0.31, 0.0007)
    readbacks = [record("lidbox.serve.readback", t + 0.3003, 0.0002,
                        parent=chunk1.id),
                 record("lidbox.serve.readback", t + 0.3104, 0.0002,
                        parent=chunk2.id)]
    run = make_run(waits + stages + steps + [chunk1, chunk2] + readbacks,
                   monkeypatch)
    assert read("feed_wait_share", run) == pytest.approx(100 * 0.015 / TRACED)
    assert read("stage_ms", run) == pytest.approx(5.0)
    assert read("step_dispatch_ms", run) == pytest.approx(0.3)
    assert read("chunk_readback_ms", run) == pytest.approx(0.2)
    assert read("chunk_dispatch_ms", run) == pytest.approx(0.4)


def test_replay_share_falls_with_a_capture(monkeypatch):
    t = END + 0.01
    replays = [record("lidbox.graph.replay", t + 0.01 * i, 0.0001)
               for i in range(3)]
    run = make_run(replays, monkeypatch)
    assert read("replay_share", run) == 100.0
    capture = record("lidbox.graph.capture", t + 0.05, 0.1)
    eager = record("lidbox.graph.eager", t + 0.2, 0.01)
    run = make_run(replays + [capture, eager], monkeypatch)
    assert read("replay_share", run) == pytest.approx(60.0)


def test_traced_roofline_divides_by_the_carried_launches(monkeypatch):
    t = END + 0.01
    one = {"logmel_kernel": 1}
    graph_runs = [record("lidbox.graph.replay", t + 0.01 * i, 0.0001,
                         launches=one) for i in range(4)]
    graph_runs.append(record("lidbox.graph.capture", t + 0.1, 0.01,
                             launches={"logmel_kernel": 2}))
    graph_runs.append(record("lidbox.graph.eager", t + 0.2, 0.01,
                             launches={}))
    others = [record("lidbox.step", t, 0.001, launches=one)]
    kernels = {"void (anonymous namespace)::logmel_kernel<false, 2>": 6e-4,
               "void logmel_reduce": 6e-5, "sgemm": 1.0}
    run = make_run(graph_runs + others, monkeypatch, kernels=kernels,
                   shapes=((32, 48000), (8, 16000)))
    bound = work.logmel_bound(32, 48000, FEATURES)[0]
    per_launch = (6e-4 + 6e-5) / 6
    assert read("logmel_traced_roofline", run) == pytest.approx(
        100 * bound / per_launch)
    run.trace["kernels"] = collections.Counter({"sgemm": 1.0})
    assert read("logmel_traced_roofline", run) is None
    run.trace["kernels"] = collections.Counter(kernels)
    run.cell.kernel_shapes = set()
    assert read("logmel_traced_roofline", run) is None

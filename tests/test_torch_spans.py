"""
The port's spans (``train.observability.span``), on the CPU:

- with no profiler running a span records nothing and never enters
  ``torch.profiler.record_function``;
- under ``torch.profiler.profile`` spans nest with their parents, threads
  and requests, the names of those on the profiled thread are among the
  profiler's events, and a full list counts what it drops;
- ``fit_fused`` records ``lidbox.feed.stage`` on the staging thread and
  ``lidbox.feed.wait``, ``lidbox.step`` and ``lidbox.graph.eager`` on the
  training thread, with bytes and steps, the feed's first wait marked;
- ``StreamingClassifier.feed`` records ``lidbox.serve.feed`` >
  ``lidbox.serve.chunk`` > ``lidbox.features.pin``, ``lidbox.graph.eager``
  and ``lidbox.serve.readback``, one request a feed;
- ``observability.profiler(dir)`` writes a Chrome trace that holds them.
"""
import glob
import json
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import lidbox_tpu_torch.models as tmodels
import lidbox_tpu_torch.serve as tserve
from lidbox_tpu_torch.models.model_utils import ModelWrapper
from lidbox_tpu_torch.train import observability

torch.set_num_threads(2)

RATE = 16000
MEL = 24
LABELS = ["aa", "bb", "cc"]
FC = {"type": "logmelspectrogram", "melspectrogram": {"num_mel_bins": MEL}}


@pytest.fixture(autouse=True)
def cleared():
    observability.clear_spans()
    yield
    observability.clear_spans()


def cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def named(records, name):
    return [r for r in records if r.name == name]


def test_off_records_nothing_and_enters_no_profiler_scope(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    with observability.span("lidbox.test", rows=3) as span:
        assert span is None
        with observability.span("lidbox.test.inner"):
            pass
    model = tmodels.create("xvector", (None, MEL), len(LABELS), device="cpu")
    stream = tserve.StreamingClassifier(model, LABELS, feature_config=FC,
                                        device="cpu", chunk_seconds=0.5,
                                        hop_seconds=0.5)
    assert stream.feed(np.zeros(RATE // 2, np.float32)) is not None
    assert observability.spans() == []
    assert observability.dropped_spans() == 0


def test_spans_nest_by_thread_and_reach_the_profiler():
    seen = {}

    def worker():
        with observability.span("lidbox.test.worker", rows=2) as span:
            seen["worker"] = span
    with cpu_profile() as prof:
        with observability.span("lidbox.test.outer", request="r1") as outer:
            with observability.span("lidbox.test.inner", bytes=8) as inner:
                torch.ones(4).sum()
                inner.attrs["more"] = 1
            thread = threading.Thread(target=worker)
            thread.start()
            thread.join(timeout=30)
            assert not thread.is_alive()
        with observability.span("lidbox.test.root") as root:
            pass
    records = observability.spans()
    assert [r.name for r in records] == [
        "lidbox.test.outer", "lidbox.test.inner", "lidbox.test.worker",
        "lidbox.test.root"]
    main = threading.get_ident()
    assert outer.parent is None and outer.request == "r1"
    assert inner.parent == outer.id and inner.request == "r1"
    assert inner.attrs == {"bytes": 8, "more": 1}
    assert outer.thread == inner.thread == root.thread == main
    worker_span = seen["worker"]
    assert worker_span.thread != main and worker_span.parent is None
    assert worker_span.request == worker_span.id
    assert worker_span.attrs == {"rows": 2}
    assert root.parent is None and root.request == root.id
    for r in records:
        assert r.start_ns <= r.end_ns
    assert outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns
    # the profiler follows the threads it started on: a thread started
    # under it records its spans in the list alone
    names = {e.name for e in prof.events()}
    assert {r.name for r in records if r.thread == main} <= names
    # after the profiler stops, spans are off again
    with observability.span("lidbox.test.after") as span:
        assert span is None
    assert len(observability.spans()) == 4


def test_a_full_list_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(observability, "MAX_SPANS", 2)
    with cpu_profile():
        for _ in range(5):
            with observability.span("lidbox.test") as span:
                assert span is not None
    assert len(observability.spans()) == 2
    assert observability.dropped_spans() == 3
    observability.clear_spans()
    assert observability.spans() == [] and observability.dropped_spans() == 0


def noisy_sines(n_batches, seed, rows=4, samples=8000):
    rng = np.random.default_rng(seed)
    time = np.arange(samples) / RATE
    out = []
    for _ in range(n_batches):
        y = rng.integers(0, len(LABELS), rows)
        x = (np.sin(2 * np.pi * (200.0 + 300.0 * y[:, None]) * time)
             + 0.3 * rng.normal(0, 1, (rows, samples)))
        out.append(((0.5 * x / np.abs(x).max()).astype(np.float32),
                    y.astype(np.int32)))
    return out


def test_fit_fused_records_the_feed_and_the_steps(tmp_path):
    wrapper = ModelWrapper.from_config({
        "features": {"type": "logmelspectrogram", "sample_rate": RATE,
                     "melspectrogram": {"num_mel_bins": MEL},
                     "stft_method": "pallas", "on_device_augment": {}},
        "experiment": {
            "cache_directory": str(tmp_path), "name": "spans",
            "input_shape": [None, MEL], "output_shape": [len(LABELS)],
            "model": {"key": "xvector"},
            "optimizer": {"cls": "Adam", "kwargs": {"learning_rate": 1e-4}},
            "loss": {"cls": "SparseCategoricalCrossentropy"},
            "metrics": [], "callbacks": [],
            "feed": {"stage_dtype": "int16", "steps_per_dispatch": 2}}},
        device="cpu")
    batches = noisy_sines(4, seed=3)
    with cpu_profile():
        wrapper.fit_fused(lambda: batches, epochs=1, verbose=False)
    records = observability.spans()
    main = threading.get_ident()
    stages = named(records, "lidbox.feed.stage")
    # two groups of two [4, 8000] batches, packed: int16 [2, 5, 8000]
    assert [s.attrs for s in stages] == [{"bytes": 2 * 5 * 8000 * 2}] * 2
    assert all(s.thread != main and s.parent is None for s in stages)
    waits = named(records, "lidbox.feed.wait")
    assert len(waits) == 3  # two groups and the end of the feed
    assert all(w.thread == main for w in waits)
    assert [w.attrs for w in waits] == [{"first": True}] + [
        {"first": False}] * 2
    steps = named(records, "lidbox.step")
    assert [(s.attrs["step"], s.request) for s in steps] == [
        (i, i) for i in range(4)]
    assert all(s.attrs == {"kind": "fused", "step": s.request}
               and s.thread == main for s in steps)
    eager = named(records, "lidbox.graph.eager")
    assert [e.parent for e in eager] == [s.id for s in steps]
    assert [e.request for e in eager] == list(range(4))
    # the CPU runs the kernel's plain version: no launches
    assert all(e.attrs == {"kind": "fused", "launches": {}} for e in eager)
    assert not named(records, "lidbox.graph.replay")
    for s in records:
        assert s.start_ns <= s.end_ns


@pytest.fixture(scope="module")
def stream():
    model = tmodels.create("xvector", (None, MEL), len(LABELS), device="cpu")
    return tserve.StreamingClassifier(model, LABELS, feature_config=FC,
                                      device="cpu", chunk_seconds=1.0,
                                      hop_seconds=0.5)


def test_stream_feed_records_its_chunks(stream):
    stream.reset()
    signal = noisy_sines(1, seed=5, rows=1, samples=2 * RATE)[0][0][0]
    with cpu_profile():
        assert stream.feed(signal[:RATE // 2]) is None
        stream.feed(signal[RATE // 2:])
    records = observability.spans()
    feeds = named(records, "lidbox.serve.feed")
    assert [f.attrs for f in feeds] == [
        {"samples": RATE // 2, "chunks": 0},
        {"samples": 3 * RATE // 2, "chunks": 3}]
    chunks = named(records, "lidbox.serve.chunk")
    assert len(chunks) == 3
    assert all(c.parent == feeds[1].id for c in chunks)
    for name, attrs in (("lidbox.features.pin", {"bytes": 4 * RATE}),
                        ("lidbox.graph.eager", {"kind": "stream",
                                                "launches": {}}),
                        ("lidbox.serve.readback", {})):
        inner = named(records, name)
        assert [r.parent for r in inner] == [c.id for c in chunks]
        assert all(r.attrs == attrs for r in inner)
    feed_ids = {f.id for f in feeds}
    assert {r.request for r in records} == feed_ids
    for c in chunks:
        kids = [r for r in records if r.parent == c.id]
        assert [r.name for r in kids] == [
            "lidbox.features.pin", "lidbox.graph.eager",
            "lidbox.serve.readback"]
        assert c.start_ns <= kids[0].start_ns
        assert kids[-1].end_ns <= c.end_ns


def test_profiler_scope_writes_the_spans_to_its_trace(stream, tmp_path):
    stream.reset()
    with observability.profiler(str(tmp_path)):
        stream.feed(np.zeros(RATE, np.float32))
    (path,) = glob.glob(str(tmp_path / "*.pt.trace.json"))
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"lidbox.serve.feed", "lidbox.serve.chunk",
            "lidbox.features.pin", "lidbox.graph.eager",
            "lidbox.serve.readback"} <= names

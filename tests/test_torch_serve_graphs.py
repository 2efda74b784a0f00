"""
The port's served and evaluated forwards as one program per input signature
(``graphs.ForwardProgram``) on the CPU, against the eager forwards they
replace and against lidbox_tpu.

A stand-in graph plays the CUDA graph: its capture runs the warm-up steps
and keeps the static buffers, the body's outputs and the cached constants
the body read, and its replay runs the body on the static buffers and
writes the outputs into the kept ones (what a CUDA graph replays), so the
host side of a replay (input copies, signatures, the weights' identity,
the output clones, the eval step's buffers, the held constants) runs
here.

- Same bits: ``serve.Classifier`` whole and chunked, ``StreamingClassifier``
  (fused chunk, and the 2-step ``validate_finite`` path), the feature
  extractor (equal-length and ragged), ``Trainer.evaluate`` with and
  without ``example_mask`` and from the staged cache, ``Trainer.predict``
  and ``steps.extract_embeddings``, replayed against ``eager=True`` (or the
  CPU's eager run); the in-place eval step against the functional one.
- The JAX package: the port's scores within 1e-4 of ``lidbox_tpu.serve`` on
  the same wavs and converted weights, a stream with ``stft_method:
  "pallas"`` too (the JAX kernel in interpret mode), and ``predict_with_model`` on ragged
  batches within 1e-4 of the JAX package's.
- Captures: one per signature and one more for a ragged last batch;
  weights changed in place are served by the next replay, replaced
  tensors are captured anew, ``refresh()`` drops the graphs, the eval
  step's warm-ups leave its sums as they were, and the cached device
  constants a capture read outlive their caches while the graph lives.
- Eager by rule, logged once: only a mesh of several ranks. A
  frame-masked BiGRU and a one-rank mesh's ``predict`` and ``evaluate``
  are captured.
- A one-rank mesh (``parallel.get_mesh(device="cpu")``): its batch predict
  fn reaches the program with no reason and captures one graph of
  ``batch_size`` rows, with and without a frame mask: replayed == eager
  at every size, == mesh-less at a full batch, within rtol 1e-5 of it at
  a partial batch (read 0 here), within 1e-4 of the JAX package's on a
  one-device mesh; ``refresh()`` drops its graphs, so a replaced parameter
  is served; a stream on it runs the fused "stream" program and scores as
  the mesh-less stream, bit for bit.
- ``predict_with_model`` of each recurrent model on ragged batches (frame
  masks): replayed == eager, bit for bit, one capture per padded batch.
- The 2-deep pipeline of ``predict_with_model``: the serial loop's order
  and values, a custom ``predict_fn``, an exception of batch 2, a mesh's
  collective calls on one thread in order.
- ``reset_global_loglevel`` and ``get_package_root`` as the JAX package's.
"""
import gc
import logging
import os
import threading
import time
import types
import weakref

import numpy as np
import pytest
import torch

import jax
from jax.experimental.pallas import tpu as pltpu

import lidbox_tpu
import lidbox_tpu.models as jmodels
import lidbox_tpu.parallel as jparallel
import lidbox_tpu.serve as jserve
import lidbox_tpu.util as jutil
from lidbox_tpu.data.dataset import Dataset as JDataset
import lidbox_tpu_torch
import lidbox_tpu_torch.models as tmodels
import lidbox_tpu_torch.serve as tserve
import lidbox_tpu_torch.util as tutil
from lidbox_tpu_torch import losses as tlosses
from lidbox_tpu_torch import metrics as tmetrics
from lidbox_tpu_torch import parallel
from lidbox_tpu_torch import testutil as ttestutil
from lidbox_tpu_torch.data import steps as tsteps
from lidbox_tpu_torch.data.dataset import Dataset as TDataset
from lidbox_tpu_torch.data.device_pipeline import DeviceFeatureExtractor
from lidbox_tpu_torch.features import audio as taudio
from lidbox_tpu_torch.ops import logmel as tlogmel
from lidbox_tpu_torch.train import feed as tfeed
from lidbox_tpu_torch.train import checkpoint as tckpt
from lidbox_tpu_torch.train import graphs
from lidbox_tpu_torch.train import loop as tloop
from lidbox_tpu_torch.train import optimizers as topt
from torch_init_cache import memoized

torch.set_num_threads(2)

RATE = 16000
MEL = 24
LABELS = ["aa", "bb", "cc"]
FC = {"type": "logmelspectrogram", "melspectrogram": {"num_mel_bins": MEL}}
ATOL = 1e-4
B, FRAMES = 4, 40


# -- the stand-in graph -----------------------------------------------------------

def _flat(output):
    if output is None:
        return []
    if isinstance(output, (tuple, list)):
        return [t for v in output for t in _flat(v)]
    return [output]


class FakeGraph:
    def __init__(self, run):
        self.run = run
        self.replays = 0

    def replay(self):
        self.replays += 1
        self.run()


def fake_graph(program, device, warm, body, generators=()):
    """A stand-in capture: the warm-up steps, then the body's outputs kept
    as the graph's, with the cached constants it read held as a capture
    holds them and no launches or recurrent layer runs tallied; a replay
    runs the body and writes its outputs there."""
    for _ in range(graphs.WARMUP_STEPS):
        warm()
    with tlogmel.holding_operands([]) as operands:
        kept = body()
    graphs.captures[program.kind] += 1

    def run():
        for dst, src in zip(_flat(kept), _flat(body())):
            dst.copy_(src)
    return FakeGraph(run), operands, kept, {}, {}


@pytest.fixture
def replayed(monkeypatch):
    monkeypatch.setattr(graphs.ForwardProgram, "_graphed",
                        lambda self, device: True)
    monkeypatch.setattr(graphs.ForwardProgram, "_graph", fake_graph)


def captured(before):
    return {k: graphs.captures[k] - before.get(k, 0)
            for k in set(graphs.captures) | set(before)
            if graphs.captures[k] != before.get(k, 0)}


# -- fixtures ---------------------------------------------------------------------

@pytest.fixture(scope="module", autouse=True)
def memoized_init():
    """Each model structure and seed draws its weights once in this file."""
    with memoized():
        yield


@pytest.fixture(scope="module")
def pair():
    frames = 1 + (3 * RATE - 400) // 160
    jm = jmodels.create("xvector", (frames, MEL), len(LABELS)).init()
    tm = tmodels.create("xvector", (frames, MEL), len(LABELS), device="cpu")
    tm.load_flax_params(jax.tree_util.tree_map(np.asarray,
                                               jm.variables["params"]))
    return jm, tm


@pytest.fixture(scope="module")
def small_pair():
    """The x-vector at (FRAMES, MEL) in both packages, one set of weights."""
    jm = jmodels.create("xvector", (FRAMES, MEL), len(LABELS)).init()
    tm = tmodels.create("xvector", (FRAMES, MEL), len(LABELS), device="cpu")
    tm.load_flax_params(jax.tree_util.tree_map(np.asarray,
                                               jm.variables["params"]))
    return jm, tm


@pytest.fixture(scope="module")
def wavs(audio_fixtures):
    return [str(p) for p in audio_fixtures.values()], list(audio_fixtures)


def scores_of(table):
    return np.stack([table[f"score_{lab}"] for lab in LABELS], axis=1)


def feature_batches(n, seed, batch=B, frames=FRAMES, masked=False):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        y = rng.integers(0, len(LABELS), batch).astype(np.int32)
        x = rng.normal(0, 1, (batch, frames, MEL)).astype(np.float32)
        for i, k in enumerate(y):
            x[i, :, 6 * k:6 * k + 6] += 1.0
        b = {"input": x, "target": y}
        if masked:
            b["example_mask"] = np.arange(batch) < batch - 1
        out.append(b)
    return out


@pytest.fixture(scope="module")
def small_trainer():
    model = tmodels.create("xvector", (FRAMES, MEL), len(LABELS),
                           device="cpu")
    cavg = tmetrics.SparseAverageDetectionCost(
        len(LABELS), tmetrics.cavg_thresholds(20, -3.0, 0.0))
    trainer = tloop.Trainer(model, topt.adam(1e-3), tlosses.nll_loss,
                            metrics={"C_avg": cavg}, device="cpu")
    trainer.create_state()
    return trainer


# -- the classifiers ---------------------------------------------------------------

@pytest.mark.parametrize("chunked", [False, True], ids=["whole", "chunked"])
def test_classifier_replays_equal_eager_and_jax(replayed, pair, wavs,
                                                chunked):
    jm, tm = pair
    paths, ids = wavs
    kw = dict(feature_config=FC, batch_size=4)
    if chunked:
        kw.update(chunk_length_ms=2000, chunk_step_ms=1000)
    before = dict(graphs.captures)
    graphed = tserve.Classifier(tm, LABELS, device="cpu", **kw)
    ours = graphed.classify(paths, ids)
    counts = captured(before)
    eager = tserve.Classifier(tm, LABELS, device="cpu", eager=True,
                              **kw).classify(paths, ids)
    assert captured(before) == counts  # eager=True captures nothing
    assert ours["id"] == eager["id"]
    assert np.array_equal(scores_of(ours), scores_of(eager))
    # 5 wavs in batches of 4: batch buckets 8 and 1 of features, forwards
    # of 4 and 1; 10 chunks: the batches of 4, 4 and 2 share bucket 8.
    # Each captured once
    assert counts == {"features": 1 if chunked else 2, "forward": 2}, counts
    again = graphed.classify(paths, ids)
    assert np.array_equal(scores_of(again), scores_of(ours))
    assert captured(before) == counts  # replayed, not captured again
    ref = jserve.Classifier(jm, LABELS, **kw).classify(paths, ids)
    assert ours["id"] == list(ref.index)
    for lab in LABELS:
        np.testing.assert_allclose(ours[f"score_{lab}"],
                                   ref[f"score_{lab}"].to_numpy(), atol=ATOL)


def test_streaming_pallas_matches_jax_interpret(replayed, pair):
    """``stft_method: "pallas"``: the port's fused chunk program (the
    kernel's plain version on the CPU) against lidbox_tpu.serve's fused
    chunk with the JAX kernel in interpret mode."""
    jm, tm = pair
    sig = lidbox_tpu.testutil.noisy_sinewave(200, RATE, 0.1, 1.5, seed=9)
    kw = dict(feature_config=dict(FC, stft_method="pallas"),
              chunk_seconds=1.0, hop_seconds=0.5)
    before = dict(graphs.captures)
    ours = tserve.StreamingClassifier(tm, LABELS, device="cpu", **kw)
    ours.feed(sig)
    assert captured(before) == {"stream": 1}
    assert ours._num_chunks == 2
    saved = os.environ.get("LIDBOX_PALLAS_INTERPRET")
    os.environ["LIDBOX_PALLAS_INTERPRET"] = "1"
    try:
        with pltpu.force_tpu_interpret_mode():
            ref = jserve.StreamingClassifier(jm, LABELS, **kw)
            ref.feed(sig)
    finally:
        if saved is None:
            del os.environ["LIDBOX_PALLAS_INTERPRET"]
        else:
            os.environ["LIDBOX_PALLAS_INTERPRET"] = saved
    np.testing.assert_allclose(ours.scores(), ref.scores(), atol=ATOL)
    assert ours.label() == ref.label()


@pytest.mark.parametrize("validate", [False, True],
                         ids=["fused", "validate_finite"])
def test_streaming_replays_equal_eager_and_jax(replayed, pair, validate):
    jm, tm = pair
    sig = lidbox_tpu.testutil.noisy_sinewave(300, RATE, 0.1, 2.3, seed=7)
    fc = dict(FC, validate_finite=validate)
    kw = dict(chunk_seconds=1.0, hop_seconds=0.5)
    before = dict(graphs.captures)
    ours = tserve.StreamingClassifier(tm, LABELS, feature_config=fc,
                                      device="cpu", **kw)
    eager = tserve.StreamingClassifier(tm, LABELS, feature_config=fc,
                                       device="cpu", eager=True, **kw)
    pos = 0
    for b in (1234, 7000, 333, 20000, sig.size):
        ours.feed(sig[pos:pos + b])
        eager.feed(sig[pos:pos + b])
        pos += b
    assert ours._num_chunks == eager._num_chunks == 3
    assert np.array_equal(ours.scores(), eager.scores())
    # one program for the chunk shape, or the features and the forward
    assert captured(before) == ({"features": 1, "forward": 1} if validate
                                else {"stream": 1})
    chunks = [sig[i:i + RATE] for i in range(0, sig.size - RATE + 1,
                                             RATE // 2)]
    with torch.inference_mode():
        offline = tm.apply(torch.as_tensor(eager.extractor(np.stack(chunks),
                                                           RATE))).numpy()
    np.testing.assert_allclose(ours.scores(), offline.mean(axis=0), atol=1e-6)
    ref = jserve.StreamingClassifier(jm, LABELS, feature_config=fc, **kw)
    ref.feed(sig)
    np.testing.assert_allclose(ours.scores(), ref.scores(), atol=ATOL)


def test_extractor_replays_per_signature(replayed):
    config = dict(FC, window_normalization={"window_len": 31},
                  signal_buckets=[8000, 16000], batch_buckets=[2, 4])
    rng = np.random.default_rng(5)
    signals = [rng.uniform(-0.5, 0.5, n).astype(np.float32)
               for n in (9000, 12000, 15000, 7000, 16000)]
    graphed = DeviceFeatureExtractor(config, device="cpu")
    eager = DeviceFeatureExtractor(config, device="cpu", eager=True)
    before = dict(graphs.captures)
    for extractor in (graphed, eager):
        equal = np.stack([x[:9000] for x in signals[:2]])
        extractor.out = [extractor(equal, RATE), extractor(equal, 8000),
                         extractor.extract_ragged(signals[:3], RATE),
                         extractor.extract_ragged(signals[1:4], RATE),
                         extractor.extract_ragged(signals[2:4], RATE)]
    # per (rate, masked, shapes): [2, 9000] at two rates, then the ragged
    # batches in their buckets, [4, 16000] twice and [2, 16000]
    assert captured(before) == {"features": 4}
    replays = sorted((sig[1], dict((v[0], v[1:]) for v in sig[0])["signals"],
                      entry.graph.replays)
                     for sig, entry in graphed.program._captured.items())
    assert replays == [(8000, ((2, 9000), torch.float32), 1),
                       (16000, ((2, 9000), torch.float32), 1),
                       (16000, ((2, 16000), torch.float32), 1),
                       (16000, ((4, 16000), torch.float32), 2)]
    for a, b in zip(graphed.out, eager.out):
        for x, y in zip(a, b):
            assert np.array_equal(x, y)


# -- captures and weights ------------------------------------------------------------

def test_predict_fn_captures_weights_and_refresh(replayed):
    model = tmodels.create("xvector", (FRAMES, MEL), len(LABELS),
                           device="cpu")
    predict = tutil.make_batch_predict_fn(model)
    eager = tutil.make_batch_predict_fn(model, eager=True)
    x = feature_batches(1, 3)[0]["input"]
    before = dict(graphs.captures)
    out = predict(x)
    assert np.array_equal(out, eager(x))
    assert np.array_equal(predict(x[:3]), eager(x[:3]))  # ragged last batch
    mask = np.arange(FRAMES)[None, :] < np.array([40, 30, 20, 35])[:, None]
    assert np.array_equal(predict(x, mask), eager(x, mask))
    assert np.array_equal(predict(x), out)
    assert captured(before) == {"forward": 3}
    # weights written in place: served by the next replay
    weight = model.module.state_dict(keep_vars=True)
    name = next(k for k, v in weight.items() if v.dim() == 2)
    with torch.no_grad():
        weight[name].mul_(0.5)
    changed = predict(x)
    assert not np.array_equal(changed, out)
    assert np.array_equal(changed, eager(x))
    assert captured(before) == {"forward": 3}
    # replaced tensors (a restore that builds new ones): captured anew
    owner, attr = name.rsplit(".", 1)
    sub = model.module.get_submodule(owner)
    setattr(sub, attr, torch.nn.Parameter(getattr(sub, attr).detach() * 2.0))
    replaced = predict(x)
    assert np.array_equal(replaced, eager(x))
    assert captured(before) == {"forward": 4}
    predict.refresh()
    assert np.array_equal(predict(x), replaced)
    assert captured(before) == {"forward": 5}


# -- one-rank meshes -------------------------------------------------------------------

# a partial batch on a mesh runs padded to batch_size, mesh-less on its own
# rows: another batch size, whose convolutions may sum in another order
PARTIAL_RTOL, PARTIAL_ATOL = 1e-5, 1e-6


@pytest.fixture
def program_reasons(monkeypatch):
    """The ``reason`` of every ForwardProgram call."""
    reasons = []
    call = graphs.ForwardProgram.__call__

    def recording(self, fn, inputs, device, held=(), key=(), reason=None):
        reasons.append(reason)
        return call(self, fn, inputs, device, held=held, key=key,
                    reason=reason)
    monkeypatch.setattr(graphs.ForwardProgram, "__call__", recording)
    return reasons


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked"])
def test_one_rank_mesh_predict_fn_is_the_meshless_graph(
        replayed, program_reasons, small_pair, masked):
    """The one-rank mesh's forward is captured, one graph per (staged dtype,
    mask) on [batch_size, ...]: bit-equal to its eager form at every size
    and to the mesh-less graph at a full batch, within PARTIAL_RTOL of it at
    a partial one, and within ATOL of the JAX package's predict fn on a
    one-device mesh."""
    jm, tm = small_pair
    mesh = parallel.get_mesh(device="cpu")
    assert mesh.size == 1 and graphs.forward_reason(mesh) is None
    x = feature_batches(1, 21, batch=11)[0]["input"]
    mask = None
    if masked:
        lengths = np.random.default_rng(22).integers(12, FRAMES + 1, 11)
        mask = np.arange(FRAMES)[None, :] < lengths[:, None]
        x = np.where(mask[:, :, None], x, 0.0).astype(np.float32)

    def rows(n):
        return x[:n], None if mask is None else mask[:n]
    before = dict(graphs.captures)
    on_mesh = tutil.make_batch_predict_fn(tm, batch_size=8, mesh=mesh)
    eager = tutil.make_batch_predict_fn(tm, batch_size=8, mesh=mesh,
                                        eager=True)
    meshless = tutil.make_batch_predict_fn(tm, batch_size=8)
    full = on_mesh(*rows(8))
    assert np.array_equal(full, eager(*rows(8)))
    assert np.array_equal(full, meshless(*rows(8)))
    part = on_mesh(*rows(3))
    assert np.array_equal(part, eager(*rows(3)))
    np.testing.assert_allclose(part, meshless(*rows(3)), rtol=PARTIAL_RTOL,
                               atol=PARTIAL_ATOL)
    np.testing.assert_array_equal(part, full[:3])  # the same padded batch
    oversized = on_mesh(*rows(11))  # batches of 8 and 3
    assert np.array_equal(oversized, np.concatenate([full, eager(
        x[8:], None if mask is None else mask[8:])]))
    # one capture for the mesh (every batch padded to 8), two mesh-less
    assert captured(before) == {"forward": 3}
    assert set(program_reasons) == {None}
    ref = jutil.make_batch_predict_fn(jm, batch_size=8,
                                      mesh=jparallel.get_mesh(num_devices=1))
    np.testing.assert_allclose(oversized, ref(*rows(11)), atol=ATOL)


def test_mesh_predict_fn_refresh_releases_its_graphs(replayed):
    """``refresh()`` drops the one-rank mesh's graphs: after a parameter is
    replaced, the next call serves the new weights."""
    model = tmodels.create("xvector", (FRAMES, MEL), len(LABELS),
                           device="cpu")
    mesh = parallel.get_mesh(device="cpu")
    predict = tutil.make_batch_predict_fn(model, batch_size=4, mesh=mesh)
    eager = tutil.make_batch_predict_fn(model, batch_size=4, mesh=mesh,
                                        eager=True)
    program = predict.refresh.__self__
    x = feature_batches(1, 23)[0]["input"]
    before = dict(graphs.captures)
    out = predict(x)
    assert program._captured and captured(before) == {"forward": 1}
    name, weight = next((k, v) for k, v in model.module.named_parameters()
                        if v.dim() > 1)
    owner, attr = name.rsplit(".", 1)
    setattr(model.module.get_submodule(owner), attr,
            torch.nn.Parameter(weight.detach() * 0.5))
    predict.refresh()
    assert not program._captured
    refreshed = predict(x)
    assert not np.array_equal(refreshed, out)
    assert np.array_equal(refreshed, eager(x))
    assert captured(before) == {"forward": 2}


def test_one_rank_mesh_stream_is_the_meshless_stream(replayed, pair):
    """A ``StreamingClassifier`` on a one-rank mesh runs each chunk through
    the fused "stream" program (no feature readback, no mesh predict fn)
    and scores the stream exactly as without a mesh."""
    jm, tm = pair
    mesh = parallel.get_mesh(device="cpu")
    sig = ttestutil.noisy_sinewave(250, RATE, 0.1, 2.6, seed=11)
    kw = dict(feature_config=FC, chunk_seconds=1.0, hop_seconds=0.5)
    before = dict(graphs.captures)
    meshless = tserve.StreamingClassifier(tm, LABELS, device="cpu", **kw)
    on_mesh = tserve.StreamingClassifier(tm, LABELS, device="cpu", mesh=mesh,
                                         **kw)
    assert on_mesh._mesh_predict is None
    pos = 0
    for b in (5000, 11000, 333, sig.size):
        for service in (meshless, on_mesh):
            service.feed(sig[pos:pos + b])
        pos += b
    assert on_mesh._num_chunks == meshless._num_chunks == 4
    assert np.array_equal(on_mesh.scores(), meshless.scores())
    assert captured(before) == {"stream": 2}  # one program each


def test_metric_updates_in_place_same_bits():
    """The graphed eval step's in-place accumulation (``_eval_step_into``)
    against the functional ``_eval_step``, for a dense and a sparse C_avg,
    with and without example weights."""
    model = tmodels.create("xvector", (FRAMES, MEL), len(LABELS),
                           device="cpu")
    thresholds = tmetrics.cavg_thresholds(10, -3.0, 1.0)
    metrics = {"dense": tmetrics.AverageDetectionCost(3, thresholds),
               "sparse": tmetrics.SparseAverageDetectionCost(3, thresholds)}
    trainer = tloop.Trainer(model, topt.adam(1e-3), tlosses.nll_loss,
                            metrics=metrics, device="cpu")
    trainer.create_state()
    for masked in (False, True):
        batches = [{k: torch.as_tensor(v) for k, v in b.items()}
                   for b in feature_batches(2, 2, masked=masked)]
        functional = {name: m.init_state("cpu") for name, m in metrics.items()}
        total = count = None
        sums = {"loss": torch.zeros(()), "count": torch.zeros(()),
                "metrics": {name: m.init_state("cpu")
                            for name, m in metrics.items()}}
        held = graphs.tensors_of(sums)
        for batch in batches:
            loss_sum, n, functional = trainer._eval_step(trainer.state, batch,
                                                         functional)
            total = loss_sum if total is None else total + loss_sum
            count = n if count is None else count + n
            trainer._eval_step_into(trainer.state, sums, **batch)
        assert all(a is b for a, b in zip(graphs.tensors_of(sums), held))
        assert torch.equal(sums["loss"], total)
        assert float(sums["count"]) == float(count)
        for name in metrics:
            assert all(torch.equal(functional[name][k], sums["metrics"][name][k])
                       for k in functional[name])


def test_captures_hold_cached_constants(replayed, small_trainer):
    """The cached device constants a capture reads (the log-Mel matmul
    bases, the C_avg thresholds) are held by its graph: evicted from their
    caches, they live while the graph does, and the replay equals eager."""
    def held_refs(program):
        (entry,) = program._captured.values()
        held = {id(t): t for t in graphs.tensors_of(entry.operands)}
        return [weakref.ref(t) for t in held.values()]

    def clear_caches():
        for fn in (taudio._basis_tensor, taudio._mel_tensor,
                   taudio._dct_tensor, tmetrics._thresholds_on):
            fn.cache_clear()
        gc.collect()

    x = np.random.default_rng(8).uniform(-0.5, 0.5, (2, 9000)).astype(
        np.float32)
    extractor = DeviceFeatureExtractor(FC, device="cpu")
    eager = DeviceFeatureExtractor(FC, device="cpu", eager=True)
    first = extractor(x, RATE)
    refs = held_refs(extractor.program)
    assert len(refs) >= 2  # the DFT basis and the mel matrix
    clear_caches()
    assert all(r() is not None for r in refs)
    assert np.array_equal(extractor(x, RATE), first)
    assert np.array_equal(first, eager(x, RATE))
    extractor.program.release()
    gc.collect()
    assert all(r() is None for r in refs)  # nothing but the graph held them

    trainer = small_trainer
    batches = feature_batches(2, 16)
    trainer.release_graphs()
    graphed = trainer.evaluate(batches)
    refs = held_refs(trainer.forward_program("eval"))
    assert len(refs) >= 1  # the threshold grid
    clear_caches()
    assert all(r() is not None for r in refs)
    assert trainer.evaluate(batches) == graphed
    assert graphed == trainer.evaluate(batches, eager=True)
    trainer.release_graphs()
    gc.collect()
    assert all(r() is None for r in refs)


# -- the trainer ------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["plain", "example_mask", "staged"])
def test_evaluate_replays_equal_eager(replayed, small_trainer, case):
    trainer = small_trainer
    batches = feature_batches(3, 11, masked=case == "example_mask")
    batches += feature_batches(1, 12, batch=3,
                               masked=case == "example_mask")  # ragged
    if case == "staged":
        entries = list(trainer._staged(batches))
        feed, staged = tfeed.consolidate(entries), True
        assert len(feed) == 2  # two stacks: every step a replay
    else:
        feed, staged = batches, False
    before = dict(graphs.captures)
    graphed = trainer.evaluate(feed, staged=staged)
    again = trainer.evaluate(feed, staged=staged)
    assert captured(before) == {"eval": 2}  # full and ragged batches
    eager = trainer.evaluate(feed, staged=staged, eager=True)
    assert graphed == again == eager
    assert np.isfinite(list(graphed.values())).all()
    # the CPU's own run: the same in-place step, eagerly
    trainer.release_graphs()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(graphs.ForwardProgram, "_graphed",
                   lambda self, device: False)
        assert trainer.evaluate(feed, staged=staged) == eager


def test_trainer_predict_replays_equal_eager(replayed, small_trainer):
    trainer = small_trainer
    batches = feature_batches(2, 13) + feature_batches(1, 14, batch=2)
    before = dict(graphs.captures)
    out = trainer.predict(lambda: batches)
    assert captured(before) == {"forward": 2}
    eager = trainer.predict(lambda: batches, eager=True)
    assert out.shape == (10, len(LABELS))
    assert np.array_equal(out, eager)
    # a restore builds new state tensors: captured anew
    trainer.state = trainer.state.replace(params={
        k: v.clone() for k, v in trainer.state.params.items()})
    assert np.array_equal(trainer.predict(lambda: batches), eager)
    assert captured(before) == {"forward": 4}


def test_extract_embeddings_replays(replayed, tmp_path):
    frames = 30
    model = tmodels.create("xvector", (frames, MEL), len(LABELS),
                           device="cpu")
    state = types.SimpleNamespace(
        step=0, params={k: v.detach() for k, v in
                        model.module.named_parameters()},
        batch_stats={}, opt_state={})
    tckpt.save_checkpoint(str(tmp_path / "xvector" / "exp" / "checkpoints"),
                          state, epoch=1, val_loss=0.5)
    config = {"cache_directory": str(tmp_path), "model": {"key": "xvector"},
              "experiment_name": "exp", "input_shape": [frames, MEL],
              "output_shape": [len(LABELS)],
              "best_checkpoint": {"monitor": "val_loss", "mode": "min"}}
    x = np.random.default_rng(3).normal(0, 1, (6, frames, MEL)).astype(
        np.float32)
    elements = [{"id": str(i), "input": row} for i, row in enumerate(x)]

    def embeddings():
        ds = tsteps.extract_embeddings(TDataset.from_elements(elements), {
            "extractors": [config], "batch_size": 4}, device="cpu")
        return np.stack([e["embedding"] for e in ds])
    before = dict(graphs.captures)
    graphed = embeddings()
    assert captured(before) == {"forward": 2}  # batches of 4 and of 2
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(graphs.ForwardProgram, "_graphed",
                   lambda self, device: False)
        eager = embeddings()
    assert graphed.shape == (6, 512)
    assert np.array_equal(graphed, eager)


# -- eager by rule -------------------------------------------------------------------------

def test_eager_by_rule_is_logged_once(replayed, caplog):
    x = feature_batches(1, 4)[0]["input"]
    mask = np.arange(FRAMES)[None, :] < np.array([40, 30, 20, 35])[:, None]
    bigru = tmodels.create("bi_gru", (FRAMES, MEL), len(LABELS),
                           device="cpu")
    predict = tutil.make_batch_predict_fn(bigru)
    eager = tutil.make_batch_predict_fn(bigru, eager=True)
    model = tmodels.create("xvector", (FRAMES, MEL), len(LABELS),
                           device="cpu")
    trainer = tloop.Trainer(model, topt.adam(1e-3), tlosses.nll_loss,
                            mesh=parallel.get_mesh(device="cpu"),
                            device="cpu")
    assert trainer.mesh.size == 1
    batches = feature_batches(1, 5)
    program = graphs.ForwardProgram("forward")
    two_ranks = types.SimpleNamespace(size=2)  # the rule reads its size
    before = dict(graphs.captures)
    with caplog.at_level(logging.INFO, logger="lidbox_tpu_torch"):
        assert np.array_equal(predict(x), eager(x))       # no mask: captured
        for _ in range(2):                                 # masked: captured
            assert np.array_equal(predict(x, mask), eager(x, mask))
        on_mesh = [trainer.predict(lambda: batches) for _ in range(2)]
        logs = [trainer.evaluate(lambda: batches) for _ in range(2)]
        for _ in range(2):                                 # eager by rule
            assert torch.equal(program(
                lambda v: 2 * v, {"v": torch.ones(3)}, "cpu",
                reason=graphs.forward_reason(two_ranks)), torch.full((3,), 2.))
    assert np.array_equal(*on_mesh) and logs[0] == logs[1]
    assert np.array_equal(on_mesh[0], trainer.predict(lambda: batches,
                                                      eager=True))
    assert logs[0] == trainer.evaluate(lambda: batches, eager=True)
    # the BiGRU's two signatures, the one-rank mesh's predict and eval step
    assert captured(before) == {"forward": 3, "eval": 1}
    logged = [r.getMessage() for r in caplog.records
              if "runs eagerly" in r.getMessage()]
    assert len(logged) == 1, logged
    assert logged[0].startswith("forward program") and "several ranks" in (
        logged[0])
    assert graphs.forward_reason(trainer.mesh) is None


# -- the 2-deep pipeline --------------------------------------------------------------------

def ragged_elements(n, seed):
    rng = np.random.default_rng(seed)
    return [{"id": f"u{i:02d}", "input": rng.normal(
        0, 1, (int(rng.integers(20, FRAMES + 1)), MEL)).astype(np.float32)}
        for i in range(n)]


def serial_predictions(predict_fn, elements, batch_size):
    """The loop without a pipeline: one batch at a time, read back before
    the next."""
    ids, preds = [], []
    for i in range(0, len(elements), batch_size):
        batch = elements[i:i + batch_size]
        inputs, mask = tutil._batch_arrays(batch, None)
        for e, p in zip(batch, predict_fn(inputs, mask)):
            ids.append(e["id"])
            preds.append(p)
    return tutil.predictions_table(ids, preds)


def test_pipeline_order_values_and_custom_fn(replayed):
    model = tmodels.create("xvector", (FRAMES, MEL), len(LABELS),
                           device="cpu")
    elements = ragged_elements(11, 6)
    predict = tutil.make_batch_predict_fn(model)
    table = tutil.predict_with_model(model, TDataset.from_elements(elements),
                                     predict_fn=predict, batch_size=4)
    serial = serial_predictions(tutil.make_batch_predict_fn(model,
                                                            eager=True),
                                elements, 4)
    assert table["id"] == serial["id"] == sorted(e["id"] for e in elements)
    assert np.array_equal(table["prediction"], serial["prediction"])
    calls = []

    def custom(inputs, mask):  # on the worker threads
        calls.append(len(inputs))
        return np.asarray(inputs[:, :, :2].sum(axis=1))
    out = tutil.predict_with_model(model, TDataset.from_elements(elements),
                                   predict_fn=custom, batch_size=4)
    assert sorted(calls) == [3, 4, 4]
    expected = {e["id"]: e["input"][:, :2].sum(axis=0) for e in elements}
    np.testing.assert_allclose(out["prediction"],
                               np.stack([expected[i] for i in out["id"]]),
                               rtol=1e-6)


@pytest.mark.parametrize("route", ["custom", "launch"])
def test_pipeline_raises_from_batch_2(replayed, route):
    model = tmodels.create("xvector", (FRAMES, MEL), len(LABELS),
                           device="cpu")
    elements = ragged_elements(12, 7)
    calls = []
    if route == "custom":
        def predict(inputs, mask):
            calls.append(len(calls))
            if len(calls) == 2:
                raise RuntimeError("batch 2 failed")
            return np.zeros((len(inputs), 3), np.float32)
    else:  # the port's predict fn, launching its captured forward
        predict = tutil.make_batch_predict_fn(model)
        # batch 2's features have the wrong width: its forward raises
        for e in elements[4:8]:
            e["input"] = np.zeros((FRAMES, MEL + 1), np.float32)
    with pytest.raises(RuntimeError):
        tutil.predict_with_model(model, TDataset.from_elements(elements),
                                 predict_fn=predict, batch_size=4)
    if route == "custom":
        assert len(calls) >= 2


def test_pipeline_runs_a_mesh_fn_in_order():
    """A mesh's predict fn is a collective: the pipeline makes its calls
    on one thread, in batch order, as every rank must."""
    model = tmodels.create("xvector", (FRAMES, MEL), len(LABELS),
                           device="cpu")
    mesh = parallel.get_mesh(device="cpu")
    assert tutil.make_batch_predict_fn(model, mesh=mesh).mesh is mesh
    assert tutil.make_batch_predict_fn(model).mesh is None
    elements = ragged_elements(12, 9)
    calls = []

    def collective(inputs, mask):
        calls.append((threading.get_ident(), float(inputs[0, 0, 0])))
        time.sleep(0.01)  # a later batch would overtake on a second thread
        return np.zeros((len(inputs), 3), np.float32)
    collective.mesh = mesh
    tutil.predict_with_model(model, TDataset.from_elements(elements),
                             predict_fn=collective, batch_size=2)
    assert len({t for t, _ in calls}) == 1
    assert [v for _, v in calls] == [float(e["input"][0, 0])
                                     for e in elements[::2]]


def test_pipeline_ragged_matches_jax(replayed, small_pair):
    jm, tm = small_pair
    elements = ragged_elements(10, 8)
    ours = tutil.predict_with_model(tm, TDataset.from_elements(elements),
                                    batch_size=4, pad_buckets=[32, 48])
    ref = jutil.predict_with_model(jm, JDataset.from_elements(elements),
                                   batch_size=4, pad_buckets=[32, 48])
    assert ours["id"] == list(ref.index)
    np.testing.assert_allclose(ours["prediction"],
                               np.stack(list(ref["prediction"])), atol=ATOL)


RNN_FEATURES = 32  # crnn's five 2 x 2 pools need 32 bins


@pytest.mark.parametrize("key", ["lstm", "bi_gru", "crnn", "ap_lstm"])
def test_pipeline_ragged_recurrent_replays_equal_eager(replayed, key):
    """``predict_with_model`` of a recurrent model on ragged elements, so
    its padded batches carry frame masks: replayed (one capture per padded
    batch signature) equals eager bit for bit."""
    model = tmodels.create(key, (FRAMES, RNN_FEATURES), len(LABELS),
                           device="cpu")
    rng = np.random.default_rng(12)
    elements = [{"id": f"u{i:02d}", "input": rng.normal(
        0, 1, (int(n), RNN_FEATURES)).astype(np.float32)}
        for i, n in enumerate(rng.integers(20, FRAMES + 1, 10))]
    signatures = set()
    for i in range(0, len(elements), 4):
        inputs, mask = tutil._batch_arrays(elements[i:i + 4], [32, 48])
        assert mask is not None
        signatures.add(inputs.shape)
    before = dict(graphs.captures)
    graphed = tutil.predict_with_model(
        model, TDataset.from_elements(elements), batch_size=4,
        pad_buckets=[32, 48])
    assert captured(before) == {"forward": len(signatures)}
    eager = tutil.predict_with_model(
        model, TDataset.from_elements(elements),
        predict_fn=tutil.make_batch_predict_fn(model, eager=True),
        batch_size=4, pad_buckets=[32, 48])
    assert graphed["id"] == eager["id"] == [e["id"] for e in elements]
    ours = np.stack(graphed["prediction"])
    assert np.isfinite(ours).all()
    assert np.array_equal(ours, np.stack(eager["prediction"]))


# -- the package helpers ----------------------------------------------------------------------

def test_package_helpers_match_jax():
    logger = lidbox_tpu_torch.get_logger()
    jlogger = lidbox_tpu.get_logger()
    saved = logger.level, jlogger.level
    try:
        for level in ("debug", "WARNING", logging.ERROR):
            lidbox_tpu_torch.reset_global_loglevel(level)
            lidbox_tpu.reset_global_loglevel(level)
            assert logger.level == jlogger.level
            assert (lidbox_tpu_torch.get_logger("x.y").getEffectiveLevel()
                    == logger.level)
    finally:
        logger.setLevel(saved[0])
        jlogger.setLevel(saved[1])
    root = lidbox_tpu_torch.get_package_root()
    assert root == os.path.dirname(os.path.abspath(lidbox_tpu_torch.__file__))
    assert os.path.basename(root) == "lidbox_tpu_torch"
    assert (os.path.dirname(root)
            == os.path.dirname(lidbox_tpu.get_package_root()))


def test_checkpoint_restore_recaptures_eval(replayed, small_trainer):
    """A state with other tensors (a restore) drops the eval graphs and
    captures anew; the same tensors updated in place replay."""
    trainer = small_trainer
    batches = feature_batches(2, 15)
    trainer.evaluate(batches)
    before = dict(graphs.captures)
    first = trainer.evaluate(batches)
    with torch.no_grad():
        for v in trainer.state.params.values():
            v.mul_(0.9)
    changed = trainer.evaluate(batches)
    assert captured(before) == {}
    assert changed == trainer.evaluate(batches, eager=True) != first
    trainer.state = trainer.state.replace(params={
        k: v.clone() for k, v in trainer.state.params.items()})
    assert trainer.evaluate(batches) == changed
    assert captured(before) == {"eval": 1}

"""
The port's serving path against lidbox_tpu.serve: the same wavs and the
same x-vector weights (converted from Flax) through ``Classifier`` and
``StreamingClassifier`` of both packages give the same labels and scores
within 1e-4; the port's tables keep the JAX DataFrames' id order and
column names.
"""
import numpy as np
import pytest
import torch

import jax

import lidbox_tpu.models as jmodels
import lidbox_tpu.serve as jserve
import lidbox_tpu_torch.models as tmodels
import lidbox_tpu_torch.serve as tserve
from lidbox_tpu import testutil
from lidbox_tpu_torch.features import io as tio

torch.set_num_threads(2)

RATE = 16000
MEL = 24
LABELS = ["aa", "bb", "cc"]
FC = {"type": "logmelspectrogram", "melspectrogram": {"num_mel_bins": MEL}}
ATOL = 1e-4


@pytest.fixture(scope="module")
def pair():
    frames = 1 + (3 * RATE - 400) // 160
    jm = jmodels.create("xvector", (frames, MEL), len(LABELS)).init()
    tm = tmodels.create("xvector", (frames, MEL), len(LABELS), device="cpu")
    tm.load_flax_params(jax.tree_util.tree_map(np.asarray,
                                               jm.variables["params"]))
    return jm, tm


def _inputs(audio_fixtures):
    return [str(p) for p in audio_fixtures.values()], list(audio_fixtures)


def _assert_same(ours, ref):
    assert ours["id"] == list(ref.index)
    assert ours["label"] == list(ref["label"])
    assert list(ours) == ["id"] + list(ref.columns)
    for lab in LABELS:
        np.testing.assert_allclose(ours[f"score_{lab}"],
                                   ref[f"score_{lab}"].to_numpy(), atol=ATOL)


def test_classify_whole_utterances(pair, audio_fixtures):
    jm, tm = pair
    paths, ids = _inputs(audio_fixtures)
    ref = jserve.Classifier(jm, LABELS, feature_config=FC).classify(paths, ids)
    ours = tserve.Classifier(tm, LABELS, feature_config=FC,
                             device="cpu").classify(paths, ids)
    _assert_same(ours, ref)
    fused = tserve.Classifier(tm, LABELS, device="cpu",
                              feature_config=dict(FC, stft_method="pallas"))
    for lab in LABELS:
        np.testing.assert_allclose(fused.classify(paths, ids)[f"score_{lab}"],
                                   ours[f"score_{lab}"], atol=1e-5)


def test_classify_chunked_merges_to_utterances(pair, audio_fixtures):
    jm, tm = pair
    paths, ids = _inputs(audio_fixtures)
    kw = dict(feature_config=FC, chunk_length_ms=1000, chunk_step_ms=500)
    ref = jserve.Classifier(jm, LABELS, **kw).classify(paths[:3], ids[:3])
    ours = tserve.Classifier(tm, LABELS, device="cpu", **kw).classify(
        paths[:3], ids[:3])
    assert ours["id"] == sorted(ids[:3])
    _assert_same(ours, ref)


def test_classify_pads_sub_chunk_utterances(pair, audio_fixtures, tmp_path):
    jm, tm = pair
    paths, ids = _inputs(audio_fixtures)
    short = tmp_path / "short.wav"
    tio.write_mono_wav(short, testutil.noisy_sinewave(150, RATE, 0.1, 1.2,
                                                      seed=42), RATE)
    kw = dict(feature_config=FC, chunk_length_ms=2000, chunk_step_ms=1000)
    args = ([paths[0], str(short)], ["long", "short"])
    ref = jserve.Classifier(jm, LABELS, **kw).classify(*args)
    ours = tserve.Classifier(tm, LABELS, device="cpu", **kw).classify(*args)
    assert ours["id"] == ["long", "short"]
    _assert_same(ours, ref)


def test_streaming_equals_offline_chunking_and_jax(pair):
    jm, tm = pair
    sig = testutil.noisy_sinewave(300, RATE, 0.1, 2.3, seed=7)
    kw = dict(feature_config=FC, chunk_seconds=1.0, hop_seconds=0.5)
    ours = tserve.StreamingClassifier(tm, LABELS, device="cpu", **kw)
    ref = jserve.StreamingClassifier(jm, LABELS, **kw)
    assert ours.feed(sig[:RATE // 2]) is None and ours.label() is None
    pos = RATE // 2
    for b in (1234, 7000, 333, 20000):
        ours.feed(sig[pos:pos + b])
        pos += b
    ours.feed(sig[pos:])
    ref.feed(sig)
    chunks = [sig[i:i + RATE] for i in range(0, sig.size - RATE + 1, RATE // 2)]
    with torch.inference_mode():
        offline = tm.apply(torch.as_tensor(ours.extractor(np.stack(chunks),
                                                          RATE))).numpy()
    assert ours._num_chunks == len(chunks) == 3
    np.testing.assert_allclose(ours.scores(), offline.mean(axis=0), atol=1e-6)
    np.testing.assert_allclose(ours.scores(), ref.scores(), atol=ATOL)
    assert ours.label() == ref.label()
    ours.reset()
    assert ours.scores() is None and ours._buffer.size == 0


def test_devices_and_unported_options(pair):
    _, tm = pair
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tserve.Classifier(tm, LABELS, device="cpu", stage_dtype="bfloat16")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tserve.Classifier(tm, LABELS, device="cpu", mesh=object())
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tserve.StreamingClassifier(tm, LABELS, device="cpu",
                                   score_fn=lambda s: s)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tserve.Classifier(tm, LABELS)  # device defaults to "cuda"

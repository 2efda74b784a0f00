"""
Training and serving the model zoo in the port against lidbox_tpu, on the
CPU.

- ``ModelWrapper.from_config`` and ``Trainer.fit`` for xvector_2d
  (BatchNorm after every 2-D conv) and crnn (BatchNorm, a BLSTM and the
  coupled L2 decay of its conv kernels) from the same weights, 3 Adam
  steps of b4 x 32 bins: step losses within rtol 1e-4, the params and
  batch stats after the steps within rtol 1e-4 + atol 1e-5 of the JAX
  run's and of the port's own run in float64. The frame counts (40 for
  xvector_2d, 64 for crnn: two BLSTM steps) are ones where the JAX
  package's float32 run also stays with float64: its one-pass batch
  variance cancels at some shapes (xvector_2d at 64 frames: 2.4e-3 off,
  ROADMAP section 3);
  the JAX run's msgpack checkpoint (batch stats and the masked decay's
  optimizer state included) restores in the port to the JAX state and
  trains on to the JAX package's next step;
- ``steps_per_dispatch: 2`` equals one step per dispatch on a BatchNorm
  model, batch stats included, bit for bit;
- ap_lstm served with ``score_fn`` (``AngularProximity.predict``) through
  ``serve.Classifier``, ``StreamingClassifier`` and
  ``util.evaluate_testset_with_model``, against the JAX package's.
"""
import os

import numpy as np
import pandas as pd
import pytest
import torch

import jax

import lidbox_tpu.models as jmodels
import lidbox_tpu.serve as jserve
import lidbox_tpu.util as jutil
from lidbox_tpu import losses as jlosses
from lidbox_tpu import testutil
from lidbox_tpu.data.dataset import Dataset as JDataset
from lidbox_tpu.models.model_utils import ModelWrapper as JWrapper
import lidbox_tpu_torch.serve as tserve
import lidbox_tpu_torch.util as tutil
from lidbox_tpu_torch import losses as tlosses
from lidbox_tpu_torch.data.dataset import Dataset as TDataset
from lidbox_tpu_torch.models.model_api import params_from_flax
from lidbox_tpu_torch.models.model_utils import ModelWrapper as TWrapper
from torch_zoo_common import ATOL, RTOL, flax_variables, port_model

torch.set_num_threads(2)

B, T, FEAT, N = 4, 64, 32, 5
RATE, MEL = 16000, 24
LABELS = ["aa", "bb", "cc"]
FC = {"type": "logmelspectrogram", "melspectrogram": {"num_mel_bins": MEL}}
SERVE_ATOL = 1e-4  # the serving tests' feature budget (test_torch_serve.py)
# frames per key of the trajectory comparison (see the module docstring)
TRAINED = {"xvector_2d": 40, "crnn": 64}


def config(root, key, name, frames=T):
    return {"experiment": {
        "cache_directory": str(root), "name": name,
        "input_shape": [frames, FEAT], "output_shape": [N],
        "model": {"key": key},
        # eps 1e-4 keeps the parameter comparison about the gradients, not
        # about Adam's first lr * g / |g| (tests/test_torch_train.py)
        "optimizer": {"cls": "Adam", "kwargs": {"learning_rate": 1e-3,
                                                "epsilon": 1e-4}},
        "loss": {"cls": "SparseCategoricalCrossentropy"},
        "callbacks": [{"cls": "ModelCheckpoint",
                       "kwargs": {"monitor": "val_loss", "mode": "min"}}]}}


def feature_batches(n, seed, frames=T):
    """Class-separable features: class k has mean +1 in bins 4k..4k+3."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        y = rng.integers(0, N, B).astype(np.int32)
        x = rng.normal(0, 1, (B, frames, FEAT)).astype(np.float32)
        for i, k in enumerate(y):
            x[i, :, 4 * k:4 * k + 4] += 1.0
        out.append({"input": x, "target": y})
    return out


def one_per_epoch(batches):
    it = iter(batches)
    return lambda: [next(it)]


def state_numpy(trainer, jax_side):
    state = trainer.state
    if jax_side:
        tree = jax.device_get({"params": state.params,
                               "batch_stats": state.batch_stats})
        out = params_from_flax(tree["params"])
        out.update(params_from_flax(tree["batch_stats"]))
    else:
        out = {**state.params, **state.batch_stats}
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.fixture(scope="module")
def trainer_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("zoo_train")
    out = {}
    for key, frames in TRAINED.items():
        train = feature_batches(4, seed=0, frames=frames)
        val = feature_batches(1, seed=1, frames=frames)
        wrappers = {
            "torch": TWrapper.from_config(
                config(root / "torch", key, key, frames), device="cpu"),
            "float64": TWrapper.from_config(
                config(root / "float64", key, key, frames), device="cpu"),
            "jax": JWrapper.from_config(config(root / "jax", key, key,
                                               frames))}
        for side in ("torch", "float64"):
            wrappers[side].model.init(torch.Generator().manual_seed(11))
        wrappers["float64"].trainer.compute_dtype = torch.float64
        wrappers["jax"].model.variables = flax_variables(
            wrappers["torch"].model)
        runs = {}
        for side, wrapper in wrappers.items():
            h = wrapper.fit(one_per_epoch(train[:3]), lambda: val, epochs=3,
                            verbose=False)
            runs[side] = {"losses": [e["loss"] for e in h],
                          "val_loss": [e["val_loss"] for e in h],
                          "state": state_numpy(wrapper.trainer,
                                               side == "jax"),
                          "wrapper": wrapper}
        out[key] = (train, runs)
    return root, out


@pytest.mark.parametrize("key", TRAINED)
def test_trainer_trajectory_matches_jax(trainer_runs, key):
    _, out = trainer_runs
    runs = out[key][1]
    ours = runs["torch"]
    assert len(ours["losses"]) == 3
    for ref in (runs["jax"], runs["float64"]):
        np.testing.assert_allclose(ours["losses"], ref["losses"], rtol=RTOL)
        np.testing.assert_allclose(ours["val_loss"], ref["val_loss"],
                                   rtol=RTOL)
        assert set(ours["state"]) == set(ref["state"])
        for k, v in ours["state"].items():
            np.testing.assert_allclose(v, ref["state"][k], rtol=RTOL,
                                       atol=ATOL, err_msg=k)
    stats = [k for k in ours["state"] if k.endswith((".mean", ".var"))]
    assert stats
    model = ours["wrapper"].model
    for k in stats:  # trained stats reach the served model
        b = dict(model.module.named_buffers())[k].numpy()
        np.testing.assert_array_equal(b, ours["state"][k])
        assert not np.allclose(b, 0.0 if k.endswith(".mean") else 1.0)


def test_crnn_decay_is_in_the_optimizer(trainer_runs):
    """crnn's from_config chains the masked coupled decay ahead of Adam;
    the x-vector's optimizer is Adam alone."""
    _, out = trainer_runs
    state = out["crnn"][1]["torch"]["wrapper"].trainer.state.opt_state
    assert state[0] == {"inner_state": {}}
    assert state[1][0]["count"] == 3
    plain = out["xvector_2d"][1]["torch"]["wrapper"].trainer.state.opt_state
    assert plain[0]["count"] == 3


@pytest.mark.parametrize("key", TRAINED)
def test_jax_checkpoint_restores_and_trains_on(trainer_runs, key):
    """The JAX run's last msgpack checkpoint restores in the port to the
    JAX package's state (params, batch stats, optimizer moments), and one
    more step from it matches the JAX Trainer's."""
    root, out = trainer_runs
    train, runs = out[key]
    jw = runs["jax"]["wrapper"]
    ckpt_dir = os.path.join(root, "jax", key, key, "checkpoints")
    path = os.path.join(ckpt_dir, sorted(os.listdir(ckpt_dir))[-1])
    assert path.endswith(".ckpt") and "epoch000003" in path
    fresh = TWrapper.from_config(config(root / "restore", key, key,
                                        TRAINED[key]), device="cpu")
    fresh.trainer.restore(path)
    assert fresh.initial_epoch == 3 and fresh.trainer.state.step == 3
    restored = state_numpy(fresh.trainer, False)
    for k, v in runs["jax"]["state"].items():
        np.testing.assert_array_equal(restored[k], v, err_msg=k)
    ours = fresh.fit(one_per_epoch(train[3:]), None, epochs=4, verbose=False)
    jw.initial_epoch = 3
    ref = jw.fit(one_per_epoch(train[3:]), None, epochs=4, verbose=False)
    np.testing.assert_allclose([h["loss"] for h in ours],
                               [h["loss"] for h in ref], rtol=RTOL)


def test_grouped_dispatch_equals_single_steps_with_batch_norm(tmp_path):
    batches = feature_batches(4, seed=3)
    runs = []
    for spd in (1, 2):
        w = TWrapper.from_config(config(tmp_path / str(spd), "xvector_2d",
                                        "spd"), device="cpu")
        h = w.fit(lambda: batches, None, epochs=1, verbose=False,
                  steps_per_dispatch=spd)
        runs.append((h[0]["loss"], w.trainer.state))
    (l1, s1), (l2, s2) = runs
    assert l1 == l2 and s1.step == s2.step == 4
    for k in s1.batch_stats:
        assert torch.equal(s1.batch_stats[k], s2.batch_stats[k]), k
    for k in s1.params:
        assert torch.equal(s1.params[k], s2.params[k]), k


@pytest.fixture(scope="module")
def ap_pair():
    tm = port_model("ap_lstm", (None, MEL), None, {}, seed=5)
    jm = jmodels.create("ap_lstm", (None, MEL), None).with_variables(
        flax_variables(tm))
    return jm, tm


def test_ap_lstm_classifier_scores_with_score_fn(ap_pair, audio_fixtures):
    """Language vectors scored by ``AngularProximity.predict``: the port's
    Classifier (whole and chunked) and evaluation report equal the JAX
    package's."""
    jm, tm = ap_pair
    jscore = jlosses.AngularProximity(len(LABELS), 4 * 62).predict
    tscore = tlosses.AngularProximity(len(LABELS), 4 * 62).predict
    paths = [str(p) for p in audio_fixtures.values()]
    ids = list(audio_fixtures)
    for kw in ({}, {"chunk_length_ms": 1000, "chunk_step_ms": 500}):
        ref = jserve.Classifier(jm, LABELS, feature_config=FC,
                                score_fn=jscore, **kw).classify(paths, ids)
        ours = tserve.Classifier(tm, LABELS, feature_config=FC,
                                 score_fn=tscore, device="cpu",
                                 **kw).classify(paths, ids)
        assert ours["id"] == list(ref.index)
        assert ours["label"] == list(ref["label"])
        for lab in LABELS:
            scores = ours[f"score_{lab}"]
            assert (scores <= 0).all()  # -theta
            np.testing.assert_allclose(scores, ref[f"score_{lab}"].to_numpy(),
                                       atol=SERVE_ATOL)
    rng = np.random.default_rng(6)
    elems = [{"id": f"u{i}", "input": rng.normal(0, 1, (30 + 7 * i, MEL))
              .astype(np.float32)} for i in range(5)]
    targets = np.array([0, 1, 2, 1, 0], np.int32)
    label2target = {lab: i for i, lab in enumerate(LABELS)}
    ours = tutil.evaluate_testset_with_model(
        tm, TDataset.from_elements(elems),
        {"id": [e["id"] for e in elems], "target": targets}, label2target,
        score_fn=tscore)
    ref = jutil.evaluate_testset_with_model(
        jm, JDataset.from_elements(elems),
        pd.DataFrame({"id": [e["id"] for e in elems],
                      "target": targets}).set_index("id"),
        label2target, score_fn=jscore)
    # score_fn also maps a caller's own predict_fn, as in the JAX package
    scored = tutil.predict_with_model(tm, TDataset.from_elements(elems),
                                      score_fn=tscore)
    mapped = tutil.predict_with_model(
        tm, TDataset.from_elements(elems),
        predict_fn=tutil.make_batch_predict_fn(tm), score_fn=tscore)
    np.testing.assert_allclose(mapped["prediction"], scored["prediction"],
                               rtol=1e-6)
    for lab in LABELS:
        for metric in ("precision", "recall", "f1-score", "support"):
            assert ours[lab][metric] == pytest.approx(ref[lab][metric])
    assert ours["avg_detection_cost"] == pytest.approx(
        ref["avg_detection_cost"], abs=1e-6)


def test_ap_lstm_streaming_with_score_fn(ap_pair):
    jm, tm = ap_pair
    sig = testutil.noisy_sinewave(250, RATE, 0.1, 2.3, seed=9)
    kw = dict(feature_config=FC, chunk_seconds=1.0, hop_seconds=0.5)
    ours = tserve.StreamingClassifier(
        tm, LABELS, device="cpu",
        score_fn=tlosses.AngularProximity(len(LABELS), 248).predict, **kw)
    ref = jserve.StreamingClassifier(
        jm, LABELS, score_fn=jlosses.AngularProximity(len(LABELS),
                                                      248).predict, **kw)
    ours.feed(sig)
    ref.feed(sig)
    assert ours.scores().shape == (len(LABELS),)
    np.testing.assert_allclose(ours.scores(), ref.scores(), atol=SERVE_ATOL)
    assert ours.label() == ref.label()

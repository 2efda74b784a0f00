"""
The port's back-end against lidbox_tpu's and scikit-learn, on the CPU.

- ``train.serialization``: bytes equal to ``flax.serialization.to_bytes``
  on the same tree, and flax's bytes read back to the same leaves.
- ``embed.plda.PLDA`` with and without PCA: transform, predict and
  log-probabilities within rtol 1e-9 in float64 of the JAX package's PLDA
  (which calls ``sklearn.decomposition.PCA``); the SVD PCA within 1e-9 of
  scikit-learn's, signs included.
- ``StandardScaler``, ``normalize``, ``GaussianNB`` and
  ``LinearDiscriminantAnalysis`` within 1e-9 of scikit-learn's, in float32
  and float64, binary and multiclass.
- ``fit_classifier`` -> ``predict_with_trained_classifier`` against the
  JAX functions (with scikit-learn's GaussianNB) on the same embeddings;
  the pickled pipeline reloads to the same predictions.
- ``util.classification_report`` equal to the JAX report: every per-class
  entry, accuracy and both averages exact, C_avg within 1e-6, EER exact,
  the confusion matrix equal, including a test set with an absent class
  and one with a single class.
- ``util.evaluate_testset_with_model`` on chunked ids against the JAX
  function with the same weights (``params_from_flax``).
- ``train.observability.MetricsLogger``: the JSONL log and its TensorBoard
  mirror, which the config's ``TensorBoard`` callback turns on.
"""
import math
import sys

import numpy as np
import pandas as pd
import pytest
import sklearn.decomposition
import sklearn.discriminant_analysis
import sklearn.naive_bayes
import sklearn.preprocessing
import torch
from flax import serialization

import jax

import lidbox_tpu.models as jmodels
import lidbox_tpu_torch.models as tmodels
from lidbox_tpu import system as jsystem
from lidbox_tpu import util as jutil
from lidbox_tpu.data.dataset import Dataset as JDataset
from lidbox_tpu.embed import plda as jplda
from lidbox_tpu.embed import sklearn_utils as jsk
from lidbox_tpu_torch import system as tsystem
from lidbox_tpu_torch import util as tutil
from lidbox_tpu_torch.data.dataset import Dataset as TDataset
from lidbox_tpu_torch.embed import plda as tplda
from lidbox_tpu_torch.embed import sklearn_utils as tsk
from lidbox_tpu_torch.models.model_api import params_from_flax
from lidbox_tpu_torch.models.model_utils import ModelWrapper
from lidbox_tpu_torch.train import serialization as tser
from lidbox_tpu_torch.train.observability import MetricsLogger

torch.set_num_threads(2)

RTOL = 1e-9
CAVG_ATOL = 1e-6
LABEL2TARGET = {"aa": 0, "bb": 1, "cc": 2, "dd": 3}


def embeddings(seed, n_per_class=40, dim=32, classes=4, dtype=np.float64):
    """Class-clustered embeddings: class k shifted along its own
    direction."""
    rng = np.random.default_rng(seed)
    y = np.repeat(np.arange(classes), n_per_class)
    centers = rng.normal(0, 2.0, (classes, dim))
    X = rng.normal(0, 1, (len(y), dim)) + centers[y]
    order = rng.permutation(len(y))
    return X[order].astype(dtype), y[order]


# -- msgpack ---------------------------------------------------------------

def _tree(rng):
    return {
        "params": {"dense": {"kernel": rng.normal(size=(5, 3)).astype(np.float32),
                             "bias": np.zeros(3, np.float32)},
                   "conv": {"kernel": rng.normal(size=(3, 4, 2))}},
        "step": np.int32(7),
        "count": np.asarray(300, np.int64),
        "opt_state": ({"mu": {"w": np.arange(40, dtype=np.uint8)}}, {}),
        "scalars": [0, 1, 127, 128, -1, -32, -33, 255, 256, 65536, -70000,
                    2 ** 40, -(2 ** 40), 1.5, -0.0, "k" * 40, "é", None,
                    True, False, b"\x01" * 300, 2 + 3j],
        "many": {str(i): i for i in range(20)},
        "empty": np.zeros((0, 3), np.float32),
    }


def test_msgpack_bytes_equal_flax():
    tree = _tree(np.random.default_rng(0))
    assert tser.to_bytes(tree) == serialization.to_bytes(tree)


def test_msgpack_reads_what_flax_writes():
    tree = _tree(np.random.default_rng(1))
    data = serialization.to_bytes(tree)
    ours = tser.msgpack_restore(data)
    ref = serialization.msgpack_restore(data)
    a, tree_a = jax.tree_util.tree_flatten(ours)
    b, tree_b = jax.tree_util.tree_flatten(ref)
    assert tree_a == tree_b
    for x, y in zip(a, b):
        assert type(x) is type(y)
        assert np.array_equal(np.asarray(x), np.asarray(y))
        assert np.asarray(x).dtype == np.asarray(y).dtype


# -- PLDA and the estimators -------------------------------------------------

@pytest.mark.parametrize("n_components", [None, 12])
def test_plda_matches_jax(n_components):
    X, y = embeddings(2)
    test_X, _ = embeddings(3)
    ref = jplda.PLDA().fit(X, y, n_components=n_components)
    ours = tplda.PLDA().fit(X, y, n_components=n_components)
    assert str(ours) == str(ref)
    np.testing.assert_allclose(ours.transform(test_X), ref.transform(test_X),
                               rtol=RTOL, atol=1e-12)
    lp_ref, lp = ref.predict_log_proba(test_X), ours.predict_log_proba(test_X)
    np.testing.assert_allclose(lp, lp_ref, rtol=RTOL, atol=1e-12)
    assert np.array_equal(ours.predict(test_X)[0], ref.predict(test_X)[0])


@pytest.mark.parametrize("shape", [(120, 40), (30, 40), (500, 20)],
                         ids=["full", "wide", "covariance_eigh"])
def test_pca_matches_sklearn(shape):
    X = np.random.default_rng(4).normal(size=shape) @ np.diag(
        np.linspace(3.0, 0.5, shape[1]))
    ref = sklearn.decomposition.PCA(n_components=5)
    ours = tsk.PCA(n_components=5)
    np.testing.assert_allclose(ours.fit_transform(X), ref.fit_transform(X),
                               rtol=RTOL, atol=1e-12)
    np.testing.assert_allclose(ours.components_, ref.components_,
                               rtol=RTOL, atol=1e-12)
    Z = np.random.default_rng(5).normal(size=(7, shape[1]))
    np.testing.assert_allclose(ours.transform(Z), ref.transform(Z),
                               rtol=RTOL, atol=1e-12)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_scaler_and_normalize_match_sklearn(dtype):
    X, _ = embeddings(6, dtype=dtype)
    X[:, 3] = 2.5  # a constant feature: scale 1
    ref = sklearn.preprocessing.StandardScaler().fit(X)
    ours = tsk.StandardScaler().fit(X)
    out, expected = ours.transform(X), ref.transform(X)
    assert out.dtype == expected.dtype == dtype
    np.testing.assert_allclose(out, expected, rtol=RTOL, atol=0)
    np.testing.assert_allclose(ours.scale_, ref.scale_, rtol=RTOL)
    np.testing.assert_allclose(tsk.normalize(X),
                               sklearn.preprocessing.normalize(X),
                               rtol=RTOL, atol=0)
    zero = np.zeros((2, 4), dtype)
    assert np.array_equal(tsk.normalize(zero), zero)


@pytest.mark.parametrize("classes", [2, 4])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("name", ["GaussianNB", "LinearDiscriminantAnalysis"])
def test_classifiers_match_sklearn(name, dtype, classes):
    X, y = embeddings(7, classes=classes, dtype=dtype)
    test_X, _ = embeddings(8, classes=classes, dtype=dtype)
    sk_cls = (sklearn.naive_bayes.GaussianNB if name == "GaussianNB"
              else sklearn.discriminant_analysis.LinearDiscriminantAnalysis)
    ref = sk_cls().fit(X, y)
    ours = getattr(tsk, name)().fit(X, y)
    assert np.array_equal(ours.predict(test_X), ref.predict(test_X))
    np.testing.assert_allclose(ours.predict_log_proba(test_X),
                               ref.predict_log_proba(test_X),
                               rtol=RTOL, atol=1e-12)


def test_lda_scores_match_jax():
    X, y = embeddings(9)
    tX, ty = embeddings(10)
    ref = jsk.get_lda_scores(jsk.fit_lda({"X": X, "y": y}, {"X": tX, "y": ty}),
                             {"X": tX, "y": ty})
    ours = tsk.get_lda_scores(tsk.fit_lda({"X": X, "y": y},
                                          {"X": tX, "y": ty}),
                              {"X": tX, "y": ty})
    assert ours[0] == ref[0]
    assert ours[1] == pytest.approx(ref[1], rel=RTOL)


def test_draw_random_sample_matches_jax():
    X, y = embeddings(11)
    t2l = {v: k for k, v in LABEL2TARGET.items()}
    data = {"X": X, "y": y}
    ref = jsk.draw_random_sample(data, data, list(LABEL2TARGET), t2l,
                                 sample_size=10)
    ours = tsk.draw_random_sample(data, data, list(LABEL2TARGET), t2l,
                                  sample_size=10)
    for split in ("train", "test"):
        assert list(ours[split]) == list(ref[split])
        for label in ref[split]:
            assert np.array_equal(ours[split][label], ref[split][label])


@pytest.mark.parametrize("n_plda_coefs", [None, 16])
def test_fit_classifier_matches_jax(tmp_path, n_plda_coefs):
    """The whole back-end on float32 embeddings (as extraction gives them):
    scaler -> PLDA -> normalize -> GaussianNB, then the predictions on the
    test set, and the pickled pipeline reloaded."""
    X, y = embeddings(12, dtype=np.float32)
    tX, ty = embeddings(13, dtype=np.float32)
    labels = list(LABEL2TARGET)
    t2l = {v: k for k, v in LABEL2TARGET.items()}
    config = {"sklearn_experiment": {"cache_directory": str(tmp_path),
                                     "model": {"key": "xvector"},
                                     "name": "be"}}
    ref_pipe = jsk.fit_classifier(
        {"X": X.copy(), "y": y}, {"X": tX.copy(), "y": ty}, labels, config,
        t2l, sklearn.naive_bayes.GaussianNB, n_plda_coefs=n_plda_coefs,
        plot_demo=False)
    pipe = tsk.fit_classifier(
        {"X": X.copy(), "y": y}, {"X": tX.copy(), "y": ty}, labels, config,
        t2l, tsk.GaussianNB, n_plda_coefs=n_plda_coefs, plot_demo=False)
    ref = jsk.predict_with_trained_classifier({"X": tX}, config, t2l, ref_pipe)
    ours = tsk.predict_with_trained_classifier({"X": tX}, config, t2l, pipe)
    np.testing.assert_allclose(ours, ref, rtol=1e-7, atol=1e-9)
    assert np.array_equal(ours.argmax(1), ref.argmax(1))
    directory = tsk.pipeline_to_disk(config, pipe)
    assert sorted(p.name for p in tmp_path.rglob("*.pkl")) == [
        "classifier.pkl", "dim_reducer.pkl", "scaler.pkl"]
    assert directory == tsk.joblib_dir_from_config(config)
    again = tsk.predict_with_trained_classifier(
        {"X": tX}, config, t2l, tsk.pipeline_from_disk(config))
    assert np.array_equal(again, ours)


# -- the report ------------------------------------------------------------

REPORT_CASES = ("random", "separable", "absent_class", "single_class")


def _report_case(case):
    rng = np.random.default_rng(20 + REPORT_CASES.index(case))
    n = 60
    y = rng.integers(0, 4, n)
    if case == "absent_class":
        y[y == 2] = 0
    if case == "single_class":
        y[:] = 1
    scores = np.log(rng.dirichlet(np.ones(4), n)).astype(np.float32)
    if case == "separable":
        scores[np.arange(n), y] += 3.0
    return y, scores


def _assert_reports_equal(ours, ref):
    assert list(ours) == list(ref)
    for key, value in ref.items():
        if key == "confusion_matrix":
            assert np.array_equal(ours[key], value)
            assert ours[key].shape == (len(LABEL2TARGET),) * 2
        elif key == "avg_detection_cost":
            assert abs(ours[key] - value) <= CAVG_ATOL
        elif isinstance(value, dict):
            assert list(ours[key]) == list(value)
            for k, v in value.items():
                same_nan = (isinstance(v, float) and math.isnan(v)
                            and math.isnan(ours[key][k]))
                assert same_nan or ours[key][k] == v, (key, k, ours[key][k], v)
        else:
            assert ours[key] == value or (math.isnan(value)
                                          and math.isnan(ours[key]))


@pytest.mark.parametrize("convention", ["fpr", "midpoint"])
@pytest.mark.parametrize("case", REPORT_CASES)
def test_classification_report_matches_jax(case, convention):
    y, scores = _report_case(case)
    ref = jutil.classification_report(y, scores, LABEL2TARGET,
                                      eer_convention=convention)
    ours = tutil.classification_report(y, scores, LABEL2TARGET,
                                       eer_convention=convention)
    _assert_reports_equal(ours, ref)


@pytest.fixture(scope="module")
def model_pair():
    """The JAX x-vector at [None, 16] with its weights in the port's."""
    jm = jmodels.create("xvector", (None, 16), 4)
    jm.init(jax.random.PRNGKey(3))
    tm = tmodels.create("xvector", (None, 16), 4, device="cpu")
    tm.module.load_state_dict(params_from_flax(
        jax.device_get(jm.variables["params"])))
    return jm, tm


def test_evaluate_testset_with_chunked_ids(model_pair):
    """Chunk predictions merge back to utterances before the join; a test
    set whose ids differ raises."""
    jm, tm = model_pair
    rng = np.random.default_rng(30)
    utts = [f"u{i:02d}" for i in range(10)]
    elements = [{"id": f"{u}-{c:06d}",
                 "input": rng.normal(0, 1, (20, 16)).astype(np.float32)}
                for u in utts for c in range(3)]
    targets = rng.integers(0, 4, len(utts)).astype(np.int32)
    def ids_and_inputs(dataset_cls):
        return dataset_cls.from_dict_of_lists(
            {"id": [e["id"] for e in elements],
             "input": [e["input"] for e in elements]})
    ref = jutil.evaluate_testset_with_model(
        jm, ids_and_inputs(JDataset),
        pd.DataFrame({"target": targets}, index=pd.Index(utts, name="id")),
        LABEL2TARGET)
    ours = tutil.evaluate_testset_with_model(
        tm, ids_and_inputs(TDataset), {"id": utts, "target": targets},
        LABEL2TARGET)
    _assert_reports_equal(ours, ref)
    with pytest.raises(AssertionError, match="id sets differ"):
        tutil.evaluate_testset_with_model(
            tm, ids_and_inputs(TDataset),
            {"id": utts[:-1], "target": targets[:-1]}, LABEL2TARGET)


# -- metric logs -------------------------------------------------------------

def test_metrics_log_and_tensorboard_mirror(tmp_path):
    """The port's MetricsLogger mirrors its records to TensorBoard; both
    packages' iter_log_events read the JSONL log alike, and the port's
    reads the event file back."""
    logger = MetricsLogger(tmp_path, tensorboard=True)
    logger.log(1, {"loss": 0.5, "val_loss": 0.75})
    logger.log(2, {"loss": 0.25, "val_loss": 0.5})
    logger.close()
    jsonl = list(tsystem.iter_log_events(tmp_path / "events.jsonl"))
    assert jsonl == [(w, s, t, v) for w, s, t, v in
                     jsystem.iter_log_events(tmp_path / "events.jsonl")]
    expected = [(1, "loss", 0.5), (1, "val_loss", 0.75), (2, "loss", 0.25),
                (2, "val_loss", 0.5)]
    assert [(s, t, v) for _, s, t, v in jsonl] == expected
    events = list((tmp_path / "tensorboard").glob("*tfevents*"))
    assert len(events) == 1
    mirrored = [(s, t, v) for _, s, t, v in
                tsystem.iter_log_events(events[0])]
    assert mirrored == expected
    config = {"experiment": {
        "cache_directory": str(tmp_path / "cache"), "name": "tb",
        "input_shape": [None, 8], "output_shape": [2],
        "model": {"key": "xvector"},
        "optimizer": {"cls": "Adam"},
        "loss": {"cls": "SparseCategoricalCrossentropy"},
        "callbacks": [{"cls": "TensorBoard"}]}}
    wrapper = ModelWrapper.from_config(config, device="cpu")
    assert wrapper.trainer.metrics_logger._tb_writer is not None
    assert (tmp_path / "cache" / "xvector" / "tb" / "logs"
            / "tensorboard").is_dir()


def test_metrics_logger_without_tensorboard_warns_and_logs(tmp_path,
                                                           monkeypatch,
                                                           caplog):
    """Where torch.utils.tensorboard cannot import (the card's machine has
    no tensorboard), the logger warns and keeps its JSONL log."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    with caplog.at_level("WARNING", logger="lidbox_tpu_torch"):
        logger = MetricsLogger(tmp_path, tensorboard=True)
    assert "tensorboard mirroring off" in caplog.text
    logger.log(1, {"loss": 0.5})
    logger.close()
    assert [(s, t, v) for _, s, t, v in tsystem.iter_log_events(
        tmp_path / "events.jsonl")] == [(1, "loss", 0.5)]
    assert not (tmp_path / "tensorboard").exists()

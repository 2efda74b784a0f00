"""
Embedding back-end: scaler -> PLDA dimension reduction -> L2 normalize ->
classifier, with pickle persistence and demo plotting (counterpart of
``lidbox_tpu.embed.sklearn_utils``; reference: lidbox/embed/sklearn_utils.py).

The card's machine has no scikit-learn and no joblib, so the estimators the
back-end uses are numpy here, written to scikit-learn's numerics (version
1.9, default arguments):

- ``StandardScaler``: the corrected two-pass mean and population variance
  in float64 accumulators; near-constant features get scale 1,
- ``normalize``: L2 rows,
- ``GaussianNB``: per-class means and population variances plus
  ``var_smoothing`` times the largest feature variance; log-probabilities
  through a stable logsumexp,
- ``LinearDiscriminantAnalysis``: the ``svd`` solver, ``fit``,
  ``predict``, ``predict_proba`` and ``predict_log_proba``,
- ``PCA``: an exact PCA by SVD (or by the covariance's eigendecomposition
  for tall data, as scikit-learn's ``auto`` picks it), component signs by
  scikit-learn's ``svd_flip`` convention (the largest absolute entry of
  each component positive), so ``transform`` agrees in sign. Where
  scikit-learn's ``auto`` would take its randomized solver, this one stays
  exact.

Fitted pipelines persist as one ``pickle`` file per object,
``<key>.pkl``, in the directory the JAX package fills with ``.joblib``
files. Neither package reads the other's: a JAX pipeline pickles
scikit-learn objects, which need scikit-learn to load.
"""
import collections
import os
import pickle

import numpy as np
import scipy.linalg
import scipy.special

from lidbox_tpu_torch import get_logger
from lidbox_tpu_torch.embed.plda import PLDA

logger = get_logger("embed.sklearn")


def _as_float(X):
    """``X`` as a float array, keeping float32 (scikit-learn's
    ``dtype=[float64, float32]`` validation)."""
    X = np.asarray(X)
    if X.dtype not in (np.float32, np.float64):
        X = X.astype(np.float64)
    return X


def _zeros_to_one(scale, constant_mask=None):
    """scikit-learn's ``_handle_zeros_in_scale``."""
    scale = np.array(scale, copy=True)
    if constant_mask is None:
        constant_mask = scale < 10 * np.finfo(scale.dtype).eps
    scale[constant_mask] = 1.0
    return scale


class StandardScaler:
    """Standardize features by removing the mean and scaling to unit
    (population) variance."""

    def fit(self, X, y=None):
        X = _as_float(X)
        n = X.shape[0]
        total = np.sum(X, axis=0, dtype=np.float64)
        self.mean_ = total / n
        temp = X - total / n
        correction = np.sum(temp, axis=0, dtype=np.float64)
        temp **= 2
        unnormalized = np.sum(temp, axis=0, dtype=np.float64)
        unnormalized -= correction ** 2 / n
        self.var_ = unnormalized / n
        self.n_samples_seen_ = n
        eps = np.finfo(np.float64).eps
        constant = self.var_ <= (n * eps * self.var_
                                 + (n * self.mean_ * eps) ** 2)
        self.scale_ = _zeros_to_one(np.sqrt(self.var_), constant)
        return self

    def transform(self, X):
        X = np.array(_as_float(X), copy=True)
        X -= self.mean_.astype(X.dtype)
        X /= self.scale_.astype(X.dtype)
        return X

    def fit_transform(self, X, y=None):
        return self.fit(X).transform(X)


def normalize(X):
    """Rows of ``X`` scaled to unit L2 norm (zero rows stay zero)."""
    X = np.array(_as_float(X), copy=True)
    norms = _zeros_to_one(np.sqrt(np.einsum("ij,ij->i", X, X)))
    X /= norms[:, None]
    return X


def _logsumexp(a, axis):
    """scikit-learn's ``_logsumexp`` (a simplification of scipy's)."""
    a_max = np.max(a, axis=axis, keepdims=True)
    index_max = a == a_max
    a = np.array(a, copy=True)
    a[index_max] = -np.inf
    m = np.sum(index_max.astype(a.dtype), axis=axis, keepdims=True,
               dtype=a.dtype)
    shift = np.where(np.isfinite(a_max), a_max, 0)
    s = np.sum(np.exp(a - shift), axis=axis, keepdims=True, dtype=a.dtype)
    s = np.where(s == 0, s, s / m)
    out = np.log1p(s) + np.log(m) + a_max
    return np.squeeze(out, axis=axis)


class GaussianNB:
    """Gaussian naive Bayes with empirical class priors."""

    def __init__(self, var_smoothing=1e-9):
        self.var_smoothing = var_smoothing

    def fit(self, X, y):
        X = _as_float(X)
        y = np.asarray(y)
        self.classes_ = np.unique(y)
        self.epsilon_ = self.var_smoothing * np.max(np.var(X, axis=0))
        shape = (len(self.classes_), X.shape[1])
        self.theta_ = np.zeros(shape, X.dtype)
        self.var_ = np.zeros(shape, X.dtype)
        self.class_count_ = np.zeros(len(self.classes_), X.dtype)
        for y_i in self.classes_:
            i = int(np.searchsorted(self.classes_, y_i))
            X_i = X[y == y_i]
            self.var_[i, :] = np.var(X_i, axis=0)
            self.theta_[i, :] = np.mean(X_i, axis=0)
            self.class_count_[i] += X_i.shape[0]
        self.var_[:, :] += self.epsilon_
        self.class_prior_ = self.class_count_ / np.sum(self.class_count_)
        return self

    def _joint_log_likelihood(self, X):
        X = _as_float(X)
        jll = []
        for i in range(len(self.classes_)):
            jointi = np.log(self.class_prior_[i])
            n_ij = -0.5 * np.sum(np.log(2.0 * np.pi * self.var_[i, :]))
            n_ij = n_ij - 0.5 * np.sum(
                ((X - self.theta_[i, :]) ** 2) / (self.var_[i, :]), axis=1)
            jll.append(jointi + n_ij)
        return np.stack(jll).T

    def predict(self, X):
        return self.classes_[np.argmax(self._joint_log_likelihood(X), axis=1)]

    def predict_log_proba(self, X):
        jll = self._joint_log_likelihood(X)
        return jll - np.atleast_2d(_logsumexp(jll, axis=1)).T

    def predict_proba(self, X):
        return np.exp(self.predict_log_proba(X))


class LinearDiscriminantAnalysis:
    """LDA classifier with the ``svd`` solver and empirical priors."""

    def __init__(self, tol=1e-4):
        self.tol = tol

    def fit(self, X, y):
        X = _as_float(X)
        y = np.asarray(y)
        self.classes_, y_idx, counts = np.unique(y, return_inverse=True,
                                                 return_counts=True)
        n_samples, n_features = X.shape
        n_classes = len(self.classes_)
        if n_samples == n_classes:
            raise ValueError("The number of samples must be more than the "
                             "number of classes.")
        self.priors_ = counts.astype(X.dtype) / float(n_samples)
        self._max_components = min(n_classes - 1, n_features)
        means = np.zeros((n_classes, n_features), X.dtype)
        np.add.at(means, y_idx, X)
        means /= np.bincount(y_idx)[:, None]
        self.means_ = means
        Xc = np.concatenate([X[y == group] - means[idx, :]
                             for idx, group in enumerate(self.classes_)])
        self.xbar_ = self.priors_ @ means
        std = np.std(Xc, axis=0)
        std[std == 0] = 1.0
        fac = np.asarray(1.0 / (n_samples - n_classes), dtype=X.dtype)
        _, S, Vt = scipy.linalg.svd(np.sqrt(fac) * (Xc / std),
                                    full_matrices=False)
        rank = int(np.sum(S > self.tol))
        scalings = (Vt[:rank, :] / std).T / S[:rank]
        fac = 1.0 if n_classes == 1 else 1.0 / (n_classes - 1)
        centers = ((np.sqrt((n_samples * self.priors_) * fac))
                   * (means - self.xbar_).T).T @ scalings
        _, S, Vt = scipy.linalg.svd(centers, full_matrices=False)
        self.explained_variance_ratio_ = (
            S ** 2 / np.sum(S ** 2))[:self._max_components]
        rank = int(np.sum(S > self.tol * S[0]))
        self.scalings_ = scalings @ Vt.T[:, :rank]
        coef = (means - self.xbar_) @ self.scalings_
        self.intercept_ = (-0.5 * np.sum(coef ** 2, axis=1)
                           + np.log(self.priors_))
        self.coef_ = coef @ self.scalings_.T
        self.intercept_ -= self.xbar_ @ self.coef_.T
        if n_classes == 2:
            self.coef_ = np.asarray(self.coef_[1, :] - self.coef_[0, :],
                                    X.dtype).reshape(1, -1)
            self.intercept_ = np.asarray(
                self.intercept_[1] - self.intercept_[0], X.dtype).reshape(1)
        return self

    def decision_function(self, X):
        scores = _as_float(X) @ self.coef_.T + self.intercept_
        return scores.reshape(-1) if scores.shape[1] == 1 else scores

    def predict(self, X):
        scores = self.decision_function(X)
        if scores.ndim == 1:
            return self.classes_[(scores > 0).astype(np.intp)]
        return self.classes_[np.argmax(scores, axis=1)]

    def predict_proba(self, X):
        decision = self.decision_function(X)
        if len(self.classes_) == 2:
            proba = scipy.special.expit(decision)
            return np.stack([1 - proba, proba], axis=1)
        decision = np.array(decision, copy=True)
        decision -= np.max(decision, axis=1).reshape(-1, 1)
        np.exp(decision, out=decision)
        decision /= np.sum(decision, axis=1).reshape(-1, 1)
        return decision

    def predict_log_proba(self, X):
        prediction = self.predict_proba(X)
        prediction[prediction == 0.0] += np.finfo(prediction.dtype).smallest_normal
        return np.log(prediction)


class PCA:
    """Principal component analysis to ``n_components`` dimensions."""

    def __init__(self, n_components):
        self.n_components = n_components

    def _fit(self, X):
        X = _as_float(X)
        n_samples, n_features = X.shape
        n = self.n_components
        self.mean_ = np.mean(X, axis=0)
        U = None
        if n_features <= 1000 and n_samples >= 10 * n_features:
            C = X.T @ X
            C -= n_samples * self.mean_[:, None] * self.mean_[None, :]
            C /= n_samples - 1
            eigenvals, eigenvecs = np.linalg.eigh(C)
            eigenvals = np.flip(eigenvals)
            eigenvecs = np.flip(eigenvecs, axis=1)
            eigenvals[eigenvals < 0.0] = 0.0
            explained = eigenvals
            S = np.sqrt(eigenvals * (n_samples - 1))
            Vt = eigenvecs.T
        else:
            U, S, Vt = scipy.linalg.svd(X - self.mean_, full_matrices=False)
            explained = S ** 2 / (n_samples - 1)
        signs = np.sign(Vt[np.arange(Vt.shape[0]),
                           np.argmax(np.abs(Vt), axis=1)])
        Vt = Vt * signs[:, None]
        if U is not None:
            U = U * signs[None, :]
        self.components_ = Vt[:n].copy()
        self.explained_variance_ = explained[:n].copy()
        self.explained_variance_ratio_ = (explained / np.sum(explained))[:n]
        self.singular_values_ = S[:n].copy()
        self.n_components_ = n
        return U, S, X

    def fit(self, X, y=None):
        self._fit(X)
        return self

    def transform(self, X):
        X = _as_float(X)
        out = X @ self.components_.T
        out -= self.mean_.reshape(1, -1) @ self.components_.T
        return out

    def fit_transform(self, X, y=None):
        U, S, X = self._fit(X)
        if U is None:
            return self.transform(X)
        return U[:, :self.n_components] * S[:self.n_components]


def _sparse_cce(y_true, log_pred):
    """Mean categorical cross entropy from log-probabilities (replaces the
    reference's tf.keras.losses call at sklearn_utils.py:108-109). Log
    probabilities are clamped at -100 like the reference's prediction path
    (sklearn_utils.py:243) so degenerate classifiers score finitely."""
    picked = np.maximum(
        log_pred[np.arange(len(y_true)), np.asarray(y_true, int)], -100.0)
    return float(-picked.mean())


def get_lda_scores(lda, test):
    """(accuracy, categorical crossentropy) of a fitted back-end on a test
    dict {"X", "y"} (reference: sklearn_utils.py:103-111)."""
    if isinstance(lda, PLDA):
        pred, log_pred = lda.predict(test["X"])
    else:
        pred = lda.predict(test["X"])
        log_pred = lda.predict_log_proba(test["X"])
    accuracy = float((pred == test["y"]).mean())
    return accuracy, _sparse_cce(test["y"], log_pred)


def fit_lda(train, test):
    """(reference: sklearn_utils.py:114-122)"""
    lda = LinearDiscriminantAnalysis()
    lda.fit(train["X"], train["y"])
    acc, cce = get_lda_scores(lda, test)
    logger.info("Fitted LDA: accuracy %.3f, crossentropy %.3f", acc, cce)
    return lda


def fit_plda(train, test, n_components=None):
    """(reference: sklearn_utils.py:125-137)"""
    plda = PLDA()
    plda.fit(train["X"], train["y"], n_components=n_components)
    acc, cce = get_lda_scores(plda, test)
    logger.info("Fitted %s: accuracy %.3f, crossentropy %.3f", plda, acc, cce)
    return plda


def fit_plda_gridsearch(train, test, grid):
    """Grid search over PCA component counts, selecting by test
    crossentropy (reference: sklearn_utils.py:140-149)."""
    best_plda, best_loss = None, float("inf")
    for n in grid:
        plda = fit_plda(train, test, n_components=n)
        _, cce = get_lda_scores(plda, test)
        if cce < best_loss:
            best_plda, best_loss = plda, cce
    return best_plda


def reduce_dimensions(train, test, dim_reducer):
    """(reference: sklearn_utils.py:152-159)"""
    train["X"] = dim_reducer.transform(train["X"])
    test["X"] = dim_reducer.transform(test["X"])


def draw_random_sample(train, test, labels, target2label, sample_size=100,
                       seed=0):
    """Per-label random embedding samples for the demo plots
    (reference: sklearn_utils.py:162-176)."""
    rng = np.random.default_rng(seed)
    label2sample = {}
    for split, data in (("train", train), ("test", test)):
        label2vecs = collections.defaultdict(list)
        for x, y in zip(data["X"], data["y"]):
            label2vecs[target2label[int(y)]].append(x)
        sampled = {}
        for l, vecs in label2vecs.items():
            vecs = np.stack(vecs)
            take = min(sample_size, len(vecs))
            sampled[l] = vecs[rng.choice(len(vecs), size=take, replace=False)]
        label2sample[split] = collections.OrderedDict(
            (l, sampled[l]) for l in sorted(labels) if l in sampled)
    return label2sample


def pca_scatterplot_by_label(label2sample, pca):
    """2D/3D PCA scatter of embeddings (reference: sklearn_utils.py:39-58).
    matplotlib is imported here, only when a plot is drawn."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    assert pca.n_components in (2, 3)
    cmap = plt.get_cmap("tab20").colors
    if pca.n_components == 2:
        fig, ax = plt.subplots(figsize=(12, 12))
        for (label, vecs), color in zip(label2sample.items(), cmap):
            v = pca.transform(vecs)
            ax.scatter(v[:, 0], v[:, 1], c=[color], label=label, s=60, alpha=0.7)
        ax.set_title("Embeddings in PLDA model space, 2-dim PCA")
    else:
        fig = plt.figure(figsize=(12, 12))
        ax = fig.add_subplot(projection="3d")
        for (label, vecs), color in zip(label2sample.items(), cmap):
            v = pca.transform(vecs)
            ax.scatter3D(v[:, 0], v[:, 1], zs=v[:, 2], c=[color], label=label,
                         s=60, alpha=0.7)
        ax.set_title("Embeddings in PLDA model space, 3-dim PCA")
    ax.legend()
    return fig


def plot_embedding_demo(data, target2label, label2sample, pca=None,
                        output_figure_dir=None):
    """Embedding heatmaps per label + optional PCA scatters, written as PNG
    (reference: sklearn_utils.py:61-100). matplotlib is imported here."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.colors as mcolors
    import matplotlib.pyplot as plt

    labels = list(label2sample.keys())
    pixel_scaler = mcolors.Normalize(data["X"].min(), data["X"].max())
    fig, axes = plt.subplots(nrows=len(labels), ncols=1, figsize=(12, 12),
                             squeeze=False)
    im = None
    for (label, vecs), ax in zip(label2sample.items(), axes[:, 0]):
        ax.set_yticks([]); ax.set_xticks([])
        ax.set_title(label)
        im = ax.imshow(vecs, cmap="RdBu_r", norm=pixel_scaler, aspect="auto")
    if im is not None:
        fig.colorbar(im, ax=axes[:, 0].tolist())
    figs = {"embeddings-PLDA-model-space.png": fig}
    if pca:
        for dim_key, p in pca.items():
            figs[f"embeddings-PCA-{dim_key}.png"] = \
                pca_scatterplot_by_label(label2sample, p)
    if output_figure_dir is not None:
        os.makedirs(output_figure_dir, exist_ok=True)
        for name, f in figs.items():
            path = os.path.join(output_figure_dir, name)
            f.savefig(path, bbox_inches="tight", dpi=100)
            logger.info("Wrote embedding demo to '%s'", path)
        plt.close("all")
    return figs


def fit_classifier(train, test, labels, config, target2label, Classifier,
                   n_plda_coefs=None, plot_demo=True):
    """Full back-end: StandardScaler -> PLDA reduce -> L2 normalize ->
    classifier (e.g. this module's GaussianNB) (reference:
    sklearn_utils.py:179-227). Mutates train/test dicts in place like the
    reference."""
    scaler = StandardScaler()
    scaler.fit(train["X"])
    train["X"] = scaler.transform(train["X"])
    test["X"] = scaler.transform(test["X"])

    dim_reducer = fit_plda(train, test, n_components=n_plda_coefs)
    reduce_dimensions(train, test, dim_reducer)

    train["X"] = normalize(train["X"])
    test["X"] = normalize(test["X"])

    if plot_demo:
        # U_model has at most (num classes - 1) informative dims, so the
        # demo PCAs are clamped to what the reduced space can support.
        max_dim = min(train["X"].shape)
        pca = {key: PCA(n_components=n)
               for key, n in (("2D", 2), ("3D", 3)) if n <= max_dim}
        for p in pca.values():
            p.fit(train["X"])
        label2sample = draw_random_sample(train, test, labels, target2label)
        demo_dir = os.path.join(
            config["sklearn_experiment"]["cache_directory"],
            config["sklearn_experiment"]["model"]["key"],
            config["sklearn_experiment"]["name"],
            "figures")
        plot_embedding_demo(train, target2label, label2sample["train"], pca,
                            os.path.join(demo_dir, "train"))
        plot_embedding_demo(test, target2label, label2sample["test"], pca,
                            os.path.join(demo_dir, "test"))

    classifier = Classifier()
    classifier.fit(train["X"], train["y"])
    return {"scaler": scaler, "dim_reducer": dim_reducer,
            "classifier": classifier}


def predict_with_trained_classifier(unlabeled, config, target2label, pipeline):
    """Apply a fitted back-end to unlabeled embeddings; log-probs clamped at
    -100 (reference: sklearn_utils.py:230-244)."""
    X = unlabeled["X"]
    if "scaler" in pipeline:
        X = pipeline["scaler"].transform(X)
    if "dim_reducer" in pipeline:
        X = pipeline["dim_reducer"].transform(X)
    X = normalize(X)
    predictions = pipeline["classifier"].predict_log_proba(X)
    return np.maximum(predictions, -100)


def joblib_dir_from_config(config):
    """(reference: sklearn_utils.py:247-252)"""
    return os.path.join(config["sklearn_experiment"]["cache_directory"],
                        config["sklearn_experiment"]["model"]["key"],
                        config["sklearn_experiment"]["name"],
                        "sklearn_objects")


def pipeline_to_disk(config, sklearn_objects):
    """Pickle each fitted object to ``<key>.pkl`` (reference:
    sklearn_utils.py:255-262, which used joblib)."""
    joblib_dir = joblib_dir_from_config(config)
    os.makedirs(joblib_dir, exist_ok=True)
    for key, obj in sklearn_objects.items():
        with open(os.path.join(joblib_dir, key + ".pkl"), "wb") as f:
            pickle.dump(obj, f)
    return joblib_dir


def pipeline_from_disk(config):
    """The objects ``pipeline_to_disk`` wrote (reference:
    sklearn_utils.py:265-277)."""
    joblib_dir = joblib_dir_from_config(config)
    if not os.path.isdir(joblib_dir):
        logger.error("Directory '%s' does not exist", joblib_dir)
        return {}
    out = {}
    for f in os.scandir(joblib_dir):
        if f.name.endswith(".pkl"):
            with open(f.path, "rb") as fh:
                out[f.name[:-len(".pkl")]] = pickle.load(fh)
    return out

"""
Probabilistic Linear Discriminant Analysis (PLDA) back-end.

Self-contained implementation of the two-covariance PLDA of Ioffe (2006),
"Probabilistic Linear Discriminant Analysis", ECCV — the same model the
reference consumed through the external ``plda`` package
(reference: lidbox/embed/sklearn_utils.py:25-36). Model:

    x = m + A u,   u ~ N(v, I),   v ~ N(0, Psi diagonal)

Fitting maximizes likelihood via a generalized eigendecomposition of the
between/within scatter matrices; the latent space ``U`` diagonalizes both,
and ``U_model`` keeps only dimensions with positive between-class variance.

Spaces follow the plda-package naming: D (data) -> X (optional PCA) ->
U (latent) -> U_model (informative subspace).

A copy of ``lidbox_tpu.embed.plda`` whose optional PCA is this package's
SVD PCA (``embed.sklearn_utils.PCA``, sklearn's result and sign
convention) instead of ``sklearn.decomposition.PCA``.
"""
import numpy as np
import scipy.linalg

from lidbox_tpu_torch import get_logger

logger = get_logger("embed.plda")


class PLDA:
    """sklearn-flavoured PLDA classifier (fit / transform / predict /
    predict_log_proba), with optional PCA preprocessing."""

    def __init__(self):
        self.m = None            # data mean [D]
        self.pca = None          # optional PCA (embed.sklearn_utils.PCA)
        self.A_inv = None        # [X, X] map to latent U space
        self.psi = None          # [X] between-class prior variances
        self.relevant = None     # bool [X], psi > 0 (the U_model dims)
        self.class_means_u = None   # [K, X] class means in U space
        self.class_counts = None    # [K]
        self.classes_ = None

    # -- fitting -------------------------------------------------------------

    def fit(self, X, y, n_components=None):
        return self.fit_model(X, y, n_principal_components=n_components)

    def fit_model(self, X, y, n_principal_components=None):
        X = np.asarray(X, np.float64)
        y = np.asarray(y)
        self.classes_, y_idx = np.unique(y, return_inverse=True)
        K = len(self.classes_)
        assert K >= 2, "PLDA needs at least 2 classes"

        self.m = X.mean(axis=0)
        Xc = X - self.m
        if n_principal_components is not None and n_principal_components < X.shape[1]:
            from lidbox_tpu_torch.embed.sklearn_utils import PCA
            self.pca = PCA(n_components=n_principal_components)
            Xc = self.pca.fit_transform(Xc)
        else:
            self.pca = None

        # Scatter matrices.
        counts = np.bincount(y_idx, minlength=K).astype(np.float64)
        dim = Xc.shape[1]
        means = np.zeros((K, dim))
        for k in range(K):
            means[k] = Xc[y_idx == k].mean(axis=0)
        S_b = (counts[:, None] * means).T @ means / len(X)
        diffs = Xc - means[y_idx]
        S_w = diffs.T @ diffs / len(X)
        S_w += 1e-9 * np.eye(dim)   # numerical floor

        # Generalized eigenproblem S_b w = lambda S_w w.
        _, W = scipy.linalg.eigh(S_b, S_w)
        lambda_b = np.diag(W.T @ S_b @ W)
        lambda_w = np.diag(W.T @ S_w @ W)

        n_avg = counts.mean()
        # Maximum-likelihood A and Psi (Ioffe 2006 eq. 12-14, with the
        # n/(n-1) within-class correction used by the plda package).
        scale = np.sqrt(np.maximum(n_avg / (n_avg - 1.0) * lambda_w, 1e-12))
        A = np.linalg.inv(W.T) * scale[None, :]
        self.A_inv = np.linalg.inv(A)
        psi = (n_avg - 1.0) / n_avg * (lambda_b / np.maximum(lambda_w, 1e-12)) \
            - 1.0 / n_avg
        self.psi = np.maximum(psi, 0.0)
        self.relevant = self.psi > 0.0
        if not self.relevant.any():
            # degenerate data: keep the top dimension anyway
            self.relevant = np.zeros_like(self.psi, bool)
            self.relevant[np.argmax(psi)] = True

        U = self._to_u(Xc, centered=True)
        self.class_means_u = np.stack([U[y_idx == k].mean(axis=0)
                                       for k in range(K)])
        self.class_counts = counts
        logger.info("Fitted PLDA %s", self)
        return self

    # -- transforms ------------------------------------------------------------

    def _to_x(self, X):
        Xc = np.asarray(X, np.float64) - self.m
        return self.pca.transform(Xc) if self.pca is not None else Xc

    def _to_u(self, X, centered=False):
        Xc = X if centered else self._to_x(X)
        return Xc @ self.A_inv.T

    def transform(self, X):
        """Data space -> informative latent subspace (D -> U_model), as the
        reference used for dimensionality reduction
        (lidbox/embed/sklearn_utils.py:30-31)."""
        return self._to_u(X)[:, self.relevant]

    # -- scoring ---------------------------------------------------------------

    def _log_likelihoods(self, U):
        """log p(u | class k) with the posterior-predictive Gaussian:
        mean = n_k psi / (n_k psi + 1) * mean_k, var = 1 + psi / (n_k psi + 1),
        over the informative dims."""
        rel = self.relevant
        psi = self.psi[rel]
        u = U[:, rel]
        out = np.empty((len(u), len(self.classes_)))
        for k in range(len(self.classes_)):
            n_k = self.class_counts[k]
            shrink = n_k * psi / (n_k * psi + 1.0)
            mean_k = shrink * self.class_means_u[k][rel]
            var_k = 1.0 + psi / (n_k * psi + 1.0)
            delta = u - mean_k
            out[:, k] = -0.5 * np.sum(delta * delta / var_k + np.log(2 * np.pi * var_k),
                                      axis=1)
        return out

    def predict_log_proba(self, X):
        ll = self._log_likelihoods(self._to_u(X))
        ll = ll - ll.max(axis=1, keepdims=True)
        log_norm = np.log(np.exp(ll).sum(axis=1, keepdims=True))
        return ll - log_norm

    def predict(self, X):
        """Returns (predicted labels, log posteriors) like the plda package's
        Classifier.predict (consumed at reference sklearn_utils.py:105)."""
        log_proba = self.predict_log_proba(X)
        return self.classes_[log_proba.argmax(axis=1)], log_proba

    # -- introspection -----------------------------------------------------------

    def get_dimensionality(self, space):
        if space == "D":
            return len(self.m)
        if space == "X":
            return self.A_inv.shape[0]
        if space == "U":
            return self.A_inv.shape[0]
        if space == "U_model":
            return int(self.relevant.sum())
        raise KeyError(space)

    def __str__(self):
        dims = [self.get_dimensionality(s) for s in ("D", "X", "U", "U_model")]
        pca_n = self.pca.n_components if self.pca is not None else None
        return ("PLDA: {:d} -> {:d} -> {:d} -> {:d} "
                "(PCA preprocessing with {} coefs)".format(*dims, pca_n))

"""
Streaming evaluation metrics as dicts of counter tensors (counterpart of
``lidbox_tpu.metrics``).

AverageDetectionCost implements C_avg, eq. 32 of Li, Ma & Lee (2013)
"Spoken language recognition: from fundamentals to practice", Proc. IEEE
101(5) (reference: lidbox/metrics.py).

The metric state is a dict of fixed-shape float32 counter tensors that
lives on the device of the scores; ``update`` is built from one-hot
products instead of the reference's scatter_nd_add, so a whole evaluation
accumulates on the card and is read back once. States of independent
shards merge with ``merge_states``; the ranks of a data-parallel mesh sum
theirs with ``psum_state``.
"""
import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from lidbox_tpu_torch import parallel
from lidbox_tpu_torch.features import divide_no_nan as _divide_no_nan
from lidbox_tpu_torch.features.audio import device_constant


@device_constant
def _thresholds_on(thresholds, device):
    """The threshold grid as a float32 tensor on ``device``, copied there
    once rather than on every update."""
    return torch.tensor(thresholds, dtype=torch.float32, device=device)


@dataclasses.dataclass(frozen=True)
class AverageDetectionCost:
    """Minimum average detection cost over a set of decision thresholds.

    State: false negative / true positive counters [N, T] per label, and
    false positive / true negative counters [N, N, T] per (true-label,
    scored-label) pair; the l == m diagonal stays zero
    (reference: lidbox/metrics.py:24-45).

    Args:
        N: number of labels (>= 2).
        thresholds: [T] decision scores matched to the model's outputs
            (e.g. log-likelihoods).
    """
    N: int
    thresholds: tuple
    C_miss: float = 1.0
    C_fa: float = 1.0
    P_tar: float = 0.5

    def __post_init__(self):
        if self.N < 2:
            raise ValueError("C_avg is undefined for less than 2 classes")
        object.__setattr__(self, "thresholds",
                           tuple(float(t) for t in self.thresholds))

    @property
    def num_thresholds(self):
        return len(self.thresholds)

    def init_state(self, device=None):
        """Zeroed counters on ``device`` (default: the CPU)."""
        T = self.num_thresholds
        def zeros(*shape):
            return torch.zeros(shape, dtype=torch.float32, device=device)
        return {"fn": zeros(self.N, T), "tp": zeros(self.N, T),
                "fp_pairs": zeros(self.N, self.N, T),
                "tn_pairs": zeros(self.N, self.N, T)}

    def update(self, state, true_positives, predictions, weights=None):
        """Accumulate a batch of one-hot labels [B, N] and scores [B, N]
        (reference: lidbox/metrics.py:51-71).

        ``weights`` [B] scales each example's contribution: 0 for padded
        examples."""
        device = predictions.device
        thresholds = _thresholds_on(self.thresholds, device)         # [T]
        onehot = true_positives.to(torch.float32)                     # [B, N]
        w = (torch.ones(onehot.shape[0], dtype=torch.float32, device=device)
             if weights is None else weights.to(torch.float32))
        # weight the positive and negative masses apart: weighting the
        # one-hot and complementing it (1 - w*onehot) would leave (1-w)
        # fake negative mass on the true class
        weighted_pos = onehot * w[:, None]
        weighted_neg = (1.0 - onehot) * w[:, None]
        scores = predictions.to(torch.float32)[:, :, None]           # [B, N, 1]
        pred_pos = (scores >= thresholds).to(torch.float32)          # [B, N, T]
        pred_neg = 1.0 - pred_pos

        tp = pred_pos * weighted_pos[:, :, None]
        fn = pred_neg * weighted_pos[:, :, None]
        fp = pred_pos * weighted_neg[:, :, None]
        tn = pred_neg * weighted_neg[:, :, None]
        # pair counters are scattered by the raw true-label one-hot (the
        # example weight already rides fp/tn)
        return {
            "fn": state["fn"] + fn.sum(dim=0),
            "tp": state["tp"] + tp.sum(dim=0),
            "fp_pairs": state["fp_pairs"] + torch.einsum("bl,bmt->lmt",
                                                         onehot, fp),
            "tn_pairs": state["tn_pairs"] + torch.einsum("bl,bmt->lmt",
                                                         onehot, tn),
        }

    def update_sparse(self, state, labels, predictions, weights=None):
        """Accumulate sparse integer labels [B]
        (reference: lidbox/metrics.py:114-119)."""
        labels = labels.to(device=predictions.device, dtype=torch.int64)
        onehot = F.one_hot(labels, self.N).to(torch.float32)
        # the dense update explicitly: SparseAverageDetectionCost overrides
        # ``update`` to mean sparse labels
        return AverageDetectionCost.update(self, state, onehot, predictions,
                                           weights=weights)

    def result(self, state):
        """Smallest C_avg over all thresholds, a 0-dim tensor
        (reference: lidbox/metrics.py:73-103)."""
        P_miss = torch.mean(
            _divide_no_nan(state["fn"], state["fn"] + state["tp"]), dim=0)
        pair_rates = _divide_no_nan(state["fp_pairs"],
                                    state["fp_pairs"] + state["tn_pairs"])
        P_fa = torch.mean(pair_rates.sum(dim=1) / float(self.N - 1), dim=0)
        C_avg = (self.C_miss * self.P_tar * P_miss
                 + self.C_fa * (1.0 - self.P_tar) * P_fa)
        return torch.min(C_avg)

    @staticmethod
    def merge_states(*states):
        """Sum counter states from independent shards."""
        return {k: sum(s[k] for s in states) for k in states[0]}

    @staticmethod
    def psum_state(state, mesh):
        """All-reduce (sum) the counter state over a ``parallel.Mesh``'s
        ranks, in one bucketed call; ``mesh`` may also be the data axis's
        name, for the mesh over every rank of the running group."""
        if isinstance(mesh, str):
            if mesh != parallel.DATA_AXIS:
                raise ValueError(f"unknown mesh axis {mesh!r} (the mesh has "
                                 f"one axis, {parallel.DATA_AXIS!r})")
            mesh = parallel.get_mesh()
        return parallel.all_reduce_tree(dict(state), mesh)


class SparseAverageDetectionCost(AverageDetectionCost):
    """Sparse-label alias mirroring the reference class split
    (reference: lidbox/metrics.py:114-119)."""

    def update(self, state, labels, predictions, weights=None):
        return AverageDetectionCost.update_sparse(self, state, labels,
                                                  predictions, weights=weights)


def equal_error_rate(scores, labels, convention="fpr"):
    """Per-class EER from the ROC, numpy on the host. scores: [B] for one
    class, labels: [B] binary (a copy of ``lidbox_tpu.metrics``'s).

    Only distinct scores define thresholds: tied scores collapse to one ROC
    point (as sklearn.metrics.roc_curve does). The all-rejected endpoint
    (fnr=1, fpr=0) is included.

    ``convention`` picks the value reported at the ROC point closest to
    fnr == fpr: ``"fpr"`` (default), the false-positive rate there, the
    reference's convention (reference: lidbox/util.py:91-98); or
    ``"midpoint"``, (fnr + fpr) / 2.
    """
    if convention not in ("fpr", "midpoint"):
        raise ValueError(f"unknown EER convention {convention!r} "
                         "(expected 'fpr' or 'midpoint')")
    scores = np.asarray(scores)
    labels = np.asarray(labels)
    order = np.argsort(-scores, kind="stable")
    s = scores[order]
    labels = labels[order]
    P = labels.sum()
    Nn = len(labels) - P
    if P == 0 or Nn == 0:
        return float("nan")
    tps = np.cumsum(labels)
    fps = np.cumsum(1 - labels)
    distinct = np.r_[s[1:] != s[:-1], True]  # last index of each tie block
    fnr = np.r_[1.0, 1.0 - tps[distinct] / P]  # prepend all-rejected point
    fpr = np.r_[0.0, fps[distinct] / Nn]
    i = np.nanargmin(np.abs(fnr - fpr))
    if convention == "fpr":
        return float(fpr[i])
    return float((fnr[i] + fpr[i]) / 2.0)


def cavg_thresholds(num_thresholds=100, lo=-10.0, hi=0.0):
    """Default threshold grid over log-score range (reference
    keras_utils.py:45-52 uses tf.linspace from config)."""
    return tuple(np.linspace(lo, hi, num_thresholds).tolist())

"""
Training objectives as functions on tensors (counterpart of
``lidbox_tpu.losses``).

- AngularProximity: Gelly & Gauvain (2017) "Spoken Language Identification
  Using LSTM-Based Angular Proximity", Proc. Interspeech 2017, eq. 1-3
  (reference: lidbox/losses.py).
- nll_loss: negative log-likelihood over log-softmax model outputs (the
  Keras sparse_categorical_crossentropy analogue used with the zoo's
  log_softmax heads).

Every loss is differentiable and returns per-example values [B]; the
trainer takes their (masked) mean.
"""
import dataclasses

import torch
import torch.nn.functional as F


def _take_label(values, y_true_sparse):
    """values[b, y_b] for [B, N] values and [B] integer labels -> [B]."""
    index = y_true_sparse.to(device=values.device, dtype=torch.int64)[:, None]
    return torch.gather(values, 1, index)[:, 0]


@dataclasses.dataclass(frozen=True)
class AngularProximity:
    """Angular proximity loss over L2-normalized language vectors.

    N orthogonal reference directions are the one-hot unit vectors in a
    D-dim space (D >= N). theta(z)[l] = acos(z . c_l); the per-example loss
    sums sigmoid(w * (theta_l_true - theta_l')) over l' != l_true
    (reference: lidbox/losses.py:12-40; delta_weight is not in the paper).

    Because the reference directions are one-hot axes, z @ c^T is a slice
    of z's first N components; acos inputs are clipped to (-1, 1) for
    float32 gradient safety.
    """
    N: int
    D: int
    delta_weight: float = 1.0

    def __post_init__(self):
        if self.N < 1:
            raise ValueError("Must have at least 1 class")
        if self.D < self.N:
            raise ValueError("Language vector dimension cannot be less than "
                             "number of classes")
        if self.delta_weight <= 0:
            raise ValueError("Non-positive delta weight would invert the "
                             "loss ordering")

    def theta(self, z):
        """[B, D] language vectors -> [B, N] angular offsets to each class
        direction (eq. 1). Predictions take argmin over classes (eq. 2)."""
        eps = 1e-7
        return torch.acos(torch.clamp(z[:, :self.N], -1.0 + eps, 1.0 - eps))

    def __call__(self, y_true_sparse, z):
        """Per-example loss [B] for sparse labels [B] and vectors [B, D]
        (eq. 3 with the l == l' pair masked out)."""
        theta_all = self.theta(z)                                   # [B, N]
        theta_true = _take_label(theta_all, y_true_sparse)[:, None]  # [B, 1]
        sigmoids = torch.sigmoid(self.delta_weight * (theta_true - theta_all))
        labels = y_true_sparse.to(device=z.device, dtype=torch.int64)
        mask = 1.0 - F.one_hot(labels, self.N).to(sigmoids.dtype)
        return torch.sum(mask * sigmoids, dim=1)

    def predict(self, z):
        """Scores where higher = more likely (negated angular offset,
        reference losses.py:51-52)."""
        return -self.theta(z)


def nll_loss(y_true_sparse, log_probs):
    """Per-example negative log likelihood [B] from log-probability outputs
    [B, N] (the zoo's log_softmax heads) and sparse labels [B]."""
    return -_take_label(log_probs, y_true_sparse)


def cross_entropy_with_logits(y_true_sparse, logits):
    """Per-example softmax cross entropy from raw logits."""
    return nll_loss(y_true_sparse, torch.log_softmax(logits, dim=-1))


def nll_loss_from_probs(y_true_sparse, probs):
    """Per-example negative log likelihood [B] from *probability* outputs
    [B, N] (softmax heads, e.g. the CRNN default). Matches Keras
    SparseCategoricalCrossentropy(from_logits=False): probabilities are
    clipped to [eps, 1-eps] before the log."""
    eps = 1e-7
    return nll_loss(y_true_sparse, torch.log(torch.clamp(probs, eps, 1.0 - eps)))


def _no_kwargs(loss_fn, name):
    """Registry factory for losses that take no construction options:
    unknown config kwargs raise instead of being dropped (a Keras-style
    ``from_logits: true`` carried over from a reference config would
    otherwise train the wrong loss)."""
    def factory(**kw):
        if kw:
            raise TypeError(f"loss {name!r} takes no options, got "
                            f"{sorted(kw)}")
        return loss_fn
    return factory


def _sparse_categorical_crossentropy(from_logits=False, **kw):
    """Keras-kwarg-compatible factory: ``from_logits: true`` selects the
    logits-head cross entropy; the default keeps the lidbox convention of
    log-softmax model outputs (reference keras_utils.py:139-142)."""
    if kw:
        raise TypeError("loss 'sparse_categorical_crossentropy' only "
                        f"accepts from_logits, got {sorted(kw)}")
    return cross_entropy_with_logits if from_logits else nll_loss


LOSS_REGISTRY = {
    "sparse_categorical_crossentropy": _sparse_categorical_crossentropy,
    "nll": _no_kwargs(nll_loss, "nll"),
    "nll_from_probs": _no_kwargs(nll_loss_from_probs, "nll_from_probs"),
    "cross_entropy_with_logits": _no_kwargs(
        cross_entropy_with_logits, "cross_entropy_with_logits"),
    "sparse_angular_proximity": lambda **kw: AngularProximity(**kw),
}


def get_loss(key, **kwargs):
    """Config-driven loss factory (reference: models/keras_utils.py:139-142)."""
    if key not in LOSS_REGISTRY:
        raise KeyError(f"unknown loss {key!r}; valid: {sorted(LOSS_REGISTRY)}")
    return LOSS_REGISTRY[key](**kwargs)

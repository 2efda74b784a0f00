"""
The port's losses and metrics against lidbox_tpu.losses and
lidbox_tpu.metrics, on the same numpy inputs on the CPU.

Losses agree within rtol 1e-6, and ``get_loss`` raises the same errors.
The C_avg counters are sums of 0/1 decisions times dyadic weights, so
the states of both packages are held equal, not close; the result, a
float32 mean of rates summed in another order, within rtol 1e-6. The
host-side EER and threshold grid are copies and match exactly.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import lidbox_tpu.losses as jlosses
import lidbox_tpu.metrics as jmetrics
import lidbox_tpu_torch.losses as tlosses
import lidbox_tpu_torch.metrics as tmetrics
from lidbox_tpu_torch import parallel

torch.set_num_threads(2)

B, N, D = 16, 5, 8


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    logits = rng.normal(0, 3, (B, N)).astype(np.float32)
    logits[0, 0] = 40.0  # a probability that rounds to 1 - eps: the clip
    labels = rng.integers(0, N, B).astype(np.int32)
    z = rng.normal(0, 1, (B, D)).astype(np.float32)
    z /= np.linalg.norm(z, axis=1, keepdims=True)
    z[1, :N] = 0.0
    z[1, 0] = 1.0  # acos input on the clip
    return logits, labels, z


def _probs(logits):
    e = np.exp(logits - logits.max(axis=1, keepdims=True))
    return (e / e.sum(axis=1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("name", ["nll_loss", "cross_entropy_with_logits",
                                  "nll_loss_from_probs"])
def test_losses_match(data, name):
    logits, labels, _ = data
    x = {"nll_loss": np.log(_probs(logits)),
         "cross_entropy_with_logits": logits,
         "nll_loss_from_probs": _probs(logits)}[name]
    ref = np.asarray(getattr(jlosses, name)(jnp.asarray(labels),
                                            jnp.asarray(x)))
    ours = getattr(tlosses, name)(torch.as_tensor(labels),
                                  torch.as_tensor(x)).numpy()
    assert ours.shape == ref.shape == (B,)
    np.testing.assert_allclose(ours, ref, rtol=1e-6)


def test_losses_are_differentiable(data):
    logits, labels, _ = data
    x = torch.as_tensor(logits).requires_grad_(True)
    tlosses.cross_entropy_with_logits(torch.as_tensor(labels), x).sum().backward()
    softmax = _probs(logits)
    softmax[np.arange(B), labels] -= 1.0
    np.testing.assert_allclose(x.grad.numpy(), softmax, atol=1e-6)


@pytest.mark.parametrize("delta_weight", [1.0, 2.5])
def test_angular_proximity_matches(data, delta_weight):
    _, labels, z = data
    jl = jlosses.AngularProximity(N, D, delta_weight)
    tl = tlosses.AngularProximity(N, D, delta_weight)
    ref = np.asarray(jl(jnp.asarray(labels), jnp.asarray(z)))
    ours = tl(torch.as_tensor(labels), torch.as_tensor(z)).numpy()
    np.testing.assert_allclose(ours, ref, rtol=1e-6)
    np.testing.assert_allclose(tl.predict(torch.as_tensor(z)).numpy(),
                               np.asarray(jl.predict(jnp.asarray(z))),
                               rtol=1e-6)


@pytest.mark.parametrize("key,kwargs", [
    ("no_such_loss", {}),
    ("nll", {"from_logits": True}),
    ("sparse_categorical_crossentropy", {"reduction": "sum"}),
    ("sparse_angular_proximity", {"N": 3}),
])
def test_get_loss_raises_the_same_errors(key, kwargs):
    with pytest.raises(Exception) as ref:
        jlosses.get_loss(key, **kwargs)
    with pytest.raises(ref.type):
        tlosses.get_loss(key, **kwargs)


def test_get_loss_resolves_the_same_functions():
    for key, kwargs, name in [
            ("sparse_categorical_crossentropy", {}, "nll_loss"),
            ("sparse_categorical_crossentropy", {"from_logits": True},
             "cross_entropy_with_logits"),
            ("nll_from_probs", {}, "nll_loss_from_probs")]:
        assert jlosses.get_loss(key, **kwargs).__name__ == name
        assert tlosses.get_loss(key, **kwargs).__name__ == name
    ap = tlosses.get_loss("sparse_angular_proximity", N=3, D=4)
    assert isinstance(ap, tlosses.AngularProximity) and ap.D == 4


def _batches(seed=1, n_batches=3):
    """Log-probability scores, labels and dyadic weights (0 marks a padded
    example): exact in float32 whatever the summation order."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        scores = np.log(_probs(rng.normal(0, 2, (B, N)))).astype(np.float32)
        labels = rng.integers(0, N, B).astype(np.int32)
        weights = rng.choice([0.0, 0.25, 0.5, 1.0], B).astype(np.float32)
        out.append((scores, labels, weights))
    return out


THRESHOLDS = jmetrics.cavg_thresholds(20, -6.0, 0.0)


@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("weighted", [False, True])
def test_cavg_state_and_result_equal_jax(sparse, weighted):
    jm = (jmetrics.SparseAverageDetectionCost if sparse
          else jmetrics.AverageDetectionCost)(N, THRESHOLDS)
    tm = (tmetrics.SparseAverageDetectionCost if sparse
          else tmetrics.AverageDetectionCost)(N, THRESHOLDS)
    js, ts = jm.init_state(), tm.init_state()
    for scores, labels, weights in _batches():
        y = labels if sparse else np.eye(N, dtype=np.float32)[labels]
        w = weights if weighted else None
        js = jm.update(js, jnp.asarray(y), jnp.asarray(scores),
                       weights=None if w is None else jnp.asarray(w))
        ts = tm.update(ts, torch.as_tensor(y), torch.as_tensor(scores),
                       weights=None if w is None else torch.as_tensor(w))
    assert set(ts) == set(js)
    for k in js:
        np.testing.assert_array_equal(ts[k].numpy(), np.asarray(js[k]),
                                      err_msg=k)
    np.testing.assert_allclose(float(tm.result(ts)), float(jm.result(js)),
                               rtol=1e-6)
    assert 0.0 < float(tm.result(ts)) < 1.0


def test_cavg_merge_states_equal_jax():
    jm = jmetrics.AverageDetectionCost(N, THRESHOLDS)
    tm = tmetrics.AverageDetectionCost(N, THRESHOLDS)
    jstates, tstates = [], []
    for scores, labels, weights in _batches(seed=2):
        jstates.append(jm.update_sparse(jm.init_state(), jnp.asarray(labels),
                                        jnp.asarray(scores),
                                        weights=jnp.asarray(weights)))
        tstates.append(tm.update_sparse(tm.init_state(),
                                        torch.as_tensor(labels),
                                        torch.as_tensor(scores),
                                        weights=torch.as_tensor(weights)))
    jmerged, tmerged = jm.merge_states(*jstates), tm.merge_states(*tstates)
    for k in jmerged:
        np.testing.assert_array_equal(tmerged[k].numpy(),
                                      np.asarray(jmerged[k]), err_msg=k)
    np.testing.assert_allclose(float(tm.result(tmerged)),
                               float(jm.result(jmerged)), rtol=1e-6)
    # psum_state runs (a 1-rank mesh here: the sum is the state itself;
    # two ranks in tests/test_torch_parallel.py)
    mesh = parallel.get_mesh(device="cpu")
    for axis in (mesh, "data"):
        summed = tm.psum_state(tmerged, axis)
        for k in tmerged:
            np.testing.assert_array_equal(summed[k].numpy(),
                                          mesh.size * tmerged[k].numpy())
    with pytest.raises(ValueError, match="axis"):
        tm.psum_state(tmerged, "model")
    with pytest.raises(ValueError):
        tmetrics.AverageDetectionCost(1, THRESHOLDS)


@pytest.mark.parametrize("convention", ["fpr", "midpoint"])
def test_equal_error_rate_matches(convention):
    rng = np.random.default_rng(3)
    for trial in range(5):
        scores = np.round(rng.normal(0, 1, 50), 1)  # ties on purpose
        labels = (rng.random(50) < 0.3).astype(np.int64)
        assert (tmetrics.equal_error_rate(scores, labels, convention)
                == jmetrics.equal_error_rate(scores, labels, convention))
    assert np.isnan(tmetrics.equal_error_rate(scores, np.zeros(50)))
    with pytest.raises(ValueError):
        tmetrics.equal_error_rate(scores, labels, "median")


def test_cavg_thresholds_match():
    assert tmetrics.cavg_thresholds() == jmetrics.cavg_thresholds()
    assert (tmetrics.cavg_thresholds(7, -3.0, 1.0)
            == jmetrics.cavg_thresholds(7, -3.0, 1.0))

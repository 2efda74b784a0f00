"""
The port's last public helpers and ``visualize`` against lidbox_tpu's, on
the CPU.

- ``features.audio.blackman_window`` (periodic and symmetric, several
  alphas and lengths), ``drop_frequency_bins`` and
  ``features.window_normalization_numpy`` on the cases of
  tests/test_features_audio.py:71, :278 and tests/test_features.py:226,
  within 1e-6 of the JAX functions (float32 rounding of the same float64
  or float32 arithmetic); ``drop_frequency_bins`` sees a tensor changed in
  place, and ``mfcc`` builds its DCT basis once.
- ``predict_fn.refresh`` exists on every predict fn (mesh-less and on a
  1-rank mesh) and leaves the outputs as they are.
- ``export_program(platforms=)``: ``cpu`` writes a program that
  ``load_program`` returns on the CPU and refuses for a device it did not
  name; ``tpu`` and unknown names are refused, and ``gpu`` (``cuda``)
  needs CUDA to be checked.
- The 8 plots of ``visualize`` hold the artist data (texts, image arrays,
  line, bar and scatter data, titles, figure sizes) of
  ``lidbox_tpu.visualize`` on the same inputs, dicts of columns where the
  JAX package takes DataFrames; the two seaborn plots raise ImportError
  naming seaborn when it is absent.
"""
import sys

import matplotlib
matplotlib.use("Agg")

import numpy as np
import pandas as pd
import pytest
import torch

import jax.numpy as jnp

from lidbox_tpu import features as jfeatures
from lidbox_tpu import visualize as jvis
from lidbox_tpu.features import audio as jaudio
from lidbox_tpu_torch import export as texport
from lidbox_tpu_torch import features as tfeatures
from lidbox_tpu_torch import models as tmodels
from lidbox_tpu_torch import parallel
from lidbox_tpu_torch import util as tutil
from lidbox_tpu_torch import visualize as tvis
from lidbox_tpu_torch.features import audio as taudio

RATE = 16000


@pytest.fixture(autouse=True)
def _close_figs():
    import matplotlib.pyplot as plt
    plt.close("all")
    yield
    plt.close("all")


# -- helpers -----------------------------------------------------------------

@pytest.mark.parametrize("periodic", [True, False])
@pytest.mark.parametrize("alpha", [0.16, 0.0, 0.5])
def test_blackman_window_matches_jax(periodic, alpha):
    for n in (400, 401, 512, 2):
        ours = taudio.blackman_window(n, periodic=periodic, alpha=alpha)
        ref = np.asarray(jaudio.blackman_window(n, periodic=periodic,
                                                alpha=alpha))
        assert ours.dtype == torch.float32 and ours.shape == (n,)
        np.testing.assert_allclose(ours.numpy(), ref, atol=1e-6, rtol=0)
    w = taudio.blackman_window(400)  # tests/test_features_audio.py:71
    assert torch.isfinite(w).all() and abs(float(w[0])) <= 1e-7
    with pytest.raises(ValueError):
        taudio.blackman_window(1)


@pytest.mark.parametrize("band", [(300.0, 4000.0), (0.0, 8000.0),
                                  (20.0, 7000.0)])
def test_drop_frequency_bins_matches_jax(band):
    """tests/test_features_audio.py:278: a [2, frames, 257] spectrogram."""
    S = np.random.default_rng(0).random((2, 98, 257)).astype(np.float32)
    ours = taudio.drop_frequency_bins(torch.as_tensor(S), RATE, 512, *band)
    ref = np.asarray(jaudio.drop_frequency_bins(jnp.asarray(S), RATE, 512,
                                                *band))
    freqs = np.linspace(0, 8000, 257)
    keep = ((freqs >= band[0]) & (freqs <= band[1])).sum()
    assert ours.shape == (2, 98, keep)
    np.testing.assert_array_equal(ours.numpy(), ref)


def test_drop_frequency_bins_follows_in_place_changes():
    """Only the band is cached: a tensor changed in place between two calls
    gives the second call its new values."""
    S = torch.as_tensor(np.random.default_rng(2).random((2, 10, 257)),
                        dtype=torch.float32)
    first = taudio.drop_frequency_bins(S, RATE, 512, 300.0, 4000.0)
    S.mul_(2.0)
    second = taudio.drop_frequency_bins(S, RATE, 512, 300.0, 4000.0)
    assert second is not first
    torch.testing.assert_close(second, 2.0 * first, rtol=0, atol=0)


def test_dct_basis_is_cached_across_mfcc_calls():
    taudio._dct_tensor.cache_clear()
    log_mel = torch.zeros(2, 5, 40)
    for _ in range(3):
        taudio.mfcc(log_mel)
    info = taudio._dct_tensor.cache_info()
    assert (info.misses, info.hits) == (1, 2)


@pytest.mark.parametrize("window_len", [8, 100, -1, 5])
@pytest.mark.parametrize("normalize_variance", [True, False])
def test_window_normalization_numpy_matches_jax(window_len,
                                                normalize_variance):
    """tests/test_features.py:226's [2, 40, 6] features (100: the
    whole-tensor fallback)."""
    X = np.random.default_rng(1).normal(2.0, 3.0, (2, 40, 6)).astype(
        np.float32)
    ours = tfeatures.window_normalization_numpy(
        X, window_len=window_len, normalize_variance=normalize_variance)
    ref = jfeatures.window_normalization_numpy(
        X, window_len=window_len, normalize_variance=normalize_variance)
    assert ours.dtype == np.float32 and ours.shape == X.shape
    np.testing.assert_allclose(ours, ref, atol=1e-6, rtol=0)


def test_predict_fn_refresh_exists_on_every_predict_fn():
    model = tmodels.create("xvector", (48, 24), 3, device="cpu")
    x = np.random.default_rng(2).normal(0, 1, (3, 48, 24)).astype(np.float32)
    for mesh in (None, parallel.get_mesh(device="cpu")):
        predict = tutil.make_batch_predict_fn(model, batch_size=4, mesh=mesh)
        before = predict(x)
        assert predict.refresh() is None
        np.testing.assert_array_equal(predict(x), before)


def test_export_platforms(tmp_path):
    model = tmodels.create("xvector", (48, 24), 3, device="cpu")
    path = texport.export_program(model, str(tmp_path), platforms=["cpu"])
    program = texport.load_program(path, device="cpu")
    x = torch.randn(2, 48, 24, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        np.testing.assert_allclose(program(x).numpy(),
                                   model.apply(x).numpy(), atol=1e-5,
                                   rtol=1e-5)
    with pytest.raises(ValueError, match="exported for"):
        texport.load_program(path, device="cuda")
    assert texport.torch_platforms(["gpu", "CPU", "cuda"]) == ["cuda", "cpu"]
    with pytest.raises(ValueError, match="tpu"):
        texport.export_program(model, str(tmp_path), platforms=["tpu"])
    with pytest.raises(ValueError, match="unknown platform"):
        texport.torch_platforms(["rocm"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            texport.export_program(model, str(tmp_path / "gpu"),
                                   platforms=["gpu"])


# -- visualize ---------------------------------------------------------------

def patch_data(patch):
    if hasattr(patch, "get_height"):  # a bar
        return (type(patch).__name__, np.array([
            patch.get_x(), patch.get_y(), patch.get_width(),
            patch.get_height()]))
    return type(patch).__name__, np.asarray(patch.get_path().vertices)


def artists(figure):
    """What a figure shows, as plain data: its size, and per axes its
    title, labels, tick labels, texts, images, lines, patches, scatter
    offsets and legend."""
    out = [tuple(figure.get_size_inches())]
    for ax in figure.axes:
        legend = ax.get_legend()
        out.append({
            "title": ax.get_title(), "xlabel": ax.get_xlabel(),
            "ylabel": ax.get_ylabel(),
            "xticks": [t.get_text() for t in ax.get_xticklabels()],
            "yticks": [t.get_text() for t in ax.get_yticklabels()],
            "texts": [(t.get_text(), tuple(t.get_position()), t.get_color())
                      for t in ax.texts],
            "images": [(np.asarray(im.get_array()), im.get_cmap().name,
                        im.origin) for im in ax.images],
            "lines": [np.asarray(line.get_xydata()) for line in ax.lines],
            "patches": [patch_data(p) for p in ax.patches],
            "collections": [np.asarray(getattr(c, "_offsets3d", None)
                                       or c.get_offsets())
                            for c in ax.collections],
            "legend": (None if legend is None
                       else [t.get_text() for t in legend.get_texts()]),
        })
    return out


def assert_same(x, y, where="figure"):
    if isinstance(x, dict):
        assert x.keys() == y.keys(), where
        for k in x:
            assert_same(x[k], y[k], f"{where}.{k}")
    elif isinstance(x, (list, tuple)):
        assert len(x) == len(y), where
        for i, (u, v) in enumerate(zip(x, y)):
            assert_same(u, v, f"{where}[{i}]")
    elif isinstance(x, np.ndarray):
        np.testing.assert_array_equal(x, y, err_msg=where)
    else:
        assert x == y, where


def assert_same_artists(ours, ref):
    assert_same(artists(ours), artists(ref))


def test_confusion_matrix_matches_jax():
    cm = np.array([[8, 1, 1], [2, 7, 1], [0, 0, 10]])
    for kw in ({"title": "t"}, {"no_legend": False}):
        ours = tvis.draw_confusion_matrix(cm, ["aa", "bb", "cc"], **kw)
        ref = jvis.draw_confusion_matrix(cm, ["aa", "bb", "cc"], **kw)
        assert_same_artists(ours[0], ref[0])
    texts = [t.get_text() for t in ours[1].texts]
    assert "0.80" in texts and "1.00" in texts
    with pytest.raises(ValueError):
        tvis.draw_confusion_matrix(np.eye(2), ["a", "b", "c"])


META = {"split": ["train", "train", "test", "test", "train"],
        "label": ["fi", "sv", "fi", "sv", "fi"],
        "duration": [1.0, 2.0, 1.5, 2.5, 3.0]}


def test_distribution_plots_match_jax():
    import matplotlib.pyplot as plt
    ours = tvis.plot_sample_distribution(META)
    plt.close("all")
    ref = jvis.plot_sample_distribution(pd.DataFrame(META))
    assert_same_artists(ours, ref)
    plt.close("all")
    ours = tvis.plot_duration_distribution(META)
    ref = jvis.plot_duration_distribution(pd.DataFrame(META))
    for a, b in zip(ours, ref):
        assert_same_artists(a, b)


def test_signal_and_feature_plots_match_jax():
    rng = np.random.default_rng(0)
    signal = rng.normal(0, 1, 1000)
    S = rng.normal(0, 1, (100, 40))
    cepstra = rng.normal(0, 1, (100, 12))
    vector = rng.normal(0, 1, 256)
    assert_same_artists(tvis.plot_signal(torch.as_tensor(signal)),
                        jvis.plot_signal(signal))
    assert_same_artists(tvis.plot_spectrogram(S), jvis.plot_spectrogram(S))
    assert_same_artists(tvis.plot_cepstra(cepstra), jvis.plot_cepstra(cepstra))
    assert_same_artists(tvis.plot_embedding_vector(vector),
                        jvis.plot_embedding_vector(vector))
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots()
    assert tvis.plot_spectrogram(S, ax=ax) is fig


def test_3d_pca_scatter_matches_jax():
    data = np.random.default_rng(0).normal(0, 1, (30, 3))
    labels = ["b"] * 10 + ["a"] * 15 + ["c"] * 5
    ours = tvis.draw_3d_pca_scatterplot(data, labels)
    ref = jvis.draw_3d_pca_scatterplot(data, labels)
    assert_same_artists(ours[0], ref[0])
    assert [t.get_text() for t in ours[1].get_legend().get_texts()] == [
        "a", "b", "c"]


def test_distribution_plots_raise_cleanly_without_seaborn(monkeypatch):
    monkeypatch.setitem(sys.modules, "seaborn", None)
    with pytest.raises(ImportError, match="seaborn"):
        tvis.plot_sample_distribution(META)
    with pytest.raises(ImportError, match="seaborn"):
        tvis.plot_duration_distribution(META)

"""
The fused log-Mel port against the JAX package's Pallas kernel.

On the CPU ``fused_logmel`` computes its plain version, ``logmel_plain``;
both are held to ``lidbox_tpu.ops.fused_logmel_packed`` run in interpret
mode (as tests/test_ops.py runs it) and to ``logmel_reference``, on the
cases of tests/test_ops.py: float32 within 1e-4, bf16 within the JAX
package's mean/median budget. The CUDA kernel itself runs only on the
card: chip_smoke.py holds it to ``logmel_plain`` there.
"""
import logging

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

import lidbox_tpu_torch.features as TF
from lidbox_tpu import testutil
from lidbox_tpu.ops import fused_logmel_packed, logmel_reference
from lidbox_tpu_torch.ops import logmel

torch.set_num_threads(2)

RATE = 16000


def _signals(batch=2, seconds=1.5, rate=RATE):
    return np.stack([testutil.noisy_sinewave(150 * (i + 1), rate, 0.1,
                                             seconds, seed=i)
                     for i in range(batch)])


def _port(x, rate=RATE, **kw):
    """Both port entry points on a CPU tensor; they must agree exactly."""
    before = logmel.fused_logmel.launches
    t = torch.as_tensor(x)
    plain = logmel.logmel_plain(t, rate, **kw).numpy()
    fused = logmel.fused_logmel(t, rate, **kw).numpy()
    assert logmel.fused_logmel.launches == before  # no kernel on the CPU
    np.testing.assert_array_equal(fused, plain)
    return plain


@pytest.mark.parametrize("seconds,tile", [(1.5, 32), (2.3456, 32), (1.0, 64)])
def test_matches_pallas_kernel_and_reference(seconds, tile):
    x = _signals(2, seconds)
    with pltpu.force_tpu_interpret_mode():
        kernel = np.asarray(fused_logmel_packed(jnp.asarray(x), RATE,
                                                frames_per_tile=tile))
    ref = np.asarray(logmel_reference(jnp.asarray(x), RATE))
    ours = _port(x)
    assert ours.shape == kernel.shape == ref.shape
    np.testing.assert_allclose(ours, kernel, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("mel,fmin,fmax", [(40, 20.0, 7000.0),
                                           (80, 0.0, 8000.0)])
def test_mel_options(mel, fmin, fmax):
    x = _signals(1, 1.0)
    kw = dict(num_mel_bins=mel, fmin=fmin, fmax=fmax)
    with pltpu.force_tpu_interpret_mode():
        kernel = np.asarray(fused_logmel_packed(jnp.asarray(x), RATE, **kw))
    ours = _port(x, **kw)
    assert ours.shape == kernel.shape == (1, 98, mel)
    np.testing.assert_allclose(ours, kernel, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("rate,kw", [
    (8000, {}),                       # fmax 8000 above Nyquist: bin kept
    (RATE, {"fft_length": 256}),      # fft_length < frame_length
    (RATE, {"frame_step_ms": 2}),     # 25/2 ms steep ratio
])
def test_geometries_the_tpu_kernel_hands_to_the_reference(rate, kw):
    x = _signals(1, 1.0, rate)
    ref = np.asarray(fused_logmel_packed(jnp.asarray(x), rate, **kw))
    np.testing.assert_allclose(_port(x, rate, **kw), ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("seconds", [1.5, 2.3456])
def test_bf16_mode_within_training_grade_budget(seconds):
    x = _signals(2, seconds)
    ref = np.asarray(logmel_reference(jnp.asarray(x), RATE))
    out = _port(x, precision="bf16")
    assert out.dtype == np.float32 and out.shape == ref.shape
    err = np.abs(out - ref)
    assert err.mean() < 5e-2, err.mean()
    assert np.median(err) < 3e-2, np.median(err)


@pytest.mark.parametrize("rate,fl,fft,mel,fmax,nyquist_kept", [
    (16000, 400, 512, 64, 8000.0, False),
    (8000, 200, 512, 64, 8000.0, True),
    (16000, 400, 256, 40, 7000.0, False),
])
def test_kernel_bases_keep_every_weighted_bin(rate, fl, fft, mel, fmax,
                                              nyquist_kept):
    """The kernel computes only bins with nonzero mel weight; the dropped
    bins must contribute exactly zero, and the Nyquist bin must be kept
    when fmax is above the Nyquist rate."""
    from lidbox_tpu_torch.features import mel_ops
    W, M = logmel.kernel_bases(fl, fft, mel, rate, 0.0, fmax, False)
    full = mel_ops.linear_to_mel_weight_matrix(mel, fft // 2 + 1, rate, 0.0,
                                               fmax)
    assert W.shape == (min(fl, fft), 2 * M.shape[0])
    assert np.abs(full).sum() == np.abs(M).sum()
    assert (np.abs(full[-1]).sum() > 0) == nyquist_kept


GEOMETRIES = [(16000, 400, 512, 64, 8000.0), (8000, 200, 512, 64, 8000.0),
              (16000, 400, 256, 40, 7000.0)]


def _weighted_bins(rate, fl, fft, mel, fmax):
    """PR 1's kernel operands: W [L, 2 * NB] as cos | sin, M [NB, mel]."""
    from lidbox_tpu_torch.features import audio, mel_ops
    cos_b, sin_b = audio._windowed_dft_basis(fl, fft)
    full = mel_ops.linear_to_mel_weight_matrix(mel, fft // 2 + 1, rate, 0.0,
                                               fmax)
    used = np.flatnonzero(np.any(full != 0.0, axis=1))
    k0, k1, rows = used[0], used[-1] + 1, min(fl, fft)
    return cos_b[:rows, k0:k1], sin_b[:rows, k0:k1], full[k0:k1]


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("rate,fl,fft,mel,fmax", GEOMETRIES)
def test_kernel_operands_are_the_padded_interleaved_basis(rate, fl, fft, mel,
                                                           fmax, bf16):
    """The padded, interleaved operands map back exactly to the unpadded
    cos | sin basis and mel matrix; every padding row and column is zero;
    in "highest" the TF32 split recovers W within 2^-21 relative."""
    cos_b, sin_b, mel_w = _weighted_bins(rate, fl, fft, mel, fmax)
    rows, nb = cos_b.shape
    W, M = logmel.kernel_bases(fl, fft, mel, rate, 0.0, fmax, bf16)
    depth = 16 if bf16 else 8
    assert W.shape[0] % depth == 0 and W.shape[0] - rows < depth
    assert M.shape[0] % depth == 0 and M.shape[0] - nb < depth
    assert W.shape[1] == 2 * M.shape[0] and M.shape[1] % 8 == 0
    rnd = ((lambda a: torch.from_numpy(a).to(torch.bfloat16).float().numpy())
           if bf16 else (lambda a: a))
    np.testing.assert_array_equal(W[:rows, 0:2 * nb:2], rnd(cos_b))
    np.testing.assert_array_equal(W[:rows, 1:2 * nb:2], rnd(sin_b))
    np.testing.assert_array_equal(M[:nb, :mel], rnd(mel_w))
    for pad in (W[rows:], W[:, 2 * nb:], M[nb:], M[:, mel:]):
        assert not pad.any()
    if not bf16:
        hi, lo = logmel.split_tf32(W)
        assert not (hi.view(np.uint32) & 0x1FFF).any()  # 10 mantissa bits
        assert not (lo.view(np.uint32) & 0x1FFF).any()
        assert (np.abs(hi.astype(np.float64) + lo - W)
                <= 2.0 ** -21 * np.abs(W)).all()


@pytest.mark.parametrize("bf16", [False, True])
def test_mma_fragments_follow_the_ptx_lane_maps(bf16):
    """Lane 4g + t of (k-step s, tile j) holds the B-fragment elements of
    PTX's mma.sync tables: column 8j + g; rows t, t + 4 (m16n8k8 TF32, as
    hi then lo) or 2t, 2t + 1, 2t + 8, 2t + 9 (m16n8k16 bf16)."""
    depth = 16 if bf16 else 8
    X = np.random.default_rng(0).standard_normal((3 * depth, 24)).astype(
        np.float32)
    F = logmel.mma_fragments(X, bf16).float().numpy()
    assert F.shape == (3, 3, 32, 4)
    s, j, lane = np.meshgrid(np.arange(3), np.arange(3), np.arange(32),
                             indexing="ij")
    t, col = lane % 4, 8 * j + lane // 4
    if bf16:
        Xb = torch.from_numpy(X).to(torch.bfloat16).float().numpy()
        for e, row in enumerate((2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9)):
            np.testing.assert_array_equal(F[..., e], Xb[depth * s + row, col])
    else:
        hi, lo = logmel.split_tf32(X)
        for e, (part, row) in enumerate(((hi, t), (hi, t + 4), (lo, t),
                                         (lo, t + 4))):
            np.testing.assert_array_equal(F[..., e], part[depth * s + row, col])


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("rate,fl,fft,mel,fmax", GEOMETRIES)
def test_device_operands_come_in_whole_kernel_loops(rate, fl, fft, mel, fmax,
                                                    bf16):
    """The fragments the kernel reads are kernel_bases zero-padded to whole
    chunks, passes and mel rounds, so its loops need no guard."""
    key = (fl, fft, mel, rate, 0.0, fmax, bf16)
    W, M = logmel.kernel_bases(*key)
    Wf, Mf, K, NB = logmel._device_bases(key, torch.device("cpu"))
    rows, bins, mels = logmel.KERNEL_PADDING
    assert K % rows == 0 and NB % bins == 0 and K - W.shape[0] < rows
    assert tuple(Wf.shape) == (K // (16 if bf16 else 8), NB // 4, 32, 4)
    assert Mf.shape[1] * 8 % mels == 0 and Mf.shape[1] * 8 - mel < mels
    Wp = np.zeros((K, 2 * NB), np.float32)
    Wp[:W.shape[0], :W.shape[1]] = W
    Mp = np.zeros((NB, Mf.shape[1] * 8), np.float32)
    Mp[:M.shape[0], :M.shape[1]] = M
    assert torch.equal(logmel.mma_fragments(Wp, bf16), Wf)
    assert torch.equal(logmel.mma_fragments(Mp, bf16), Mf)


def _tf32_product(a, b, products):
    """float32 a @ b as the kernel's mma.sync computes it: operands split by
    TF32 round-to-nearest-away, each product of TF32 values exact, float32
    accumulation; 3 products (hi*hi, and lo*hi + hi*lo summed apart and
    added last) or 1 (hi*hi)."""
    ah, al = (torch.from_numpy(v) for v in logmel.split_tf32(a))
    bh, bl = (torch.from_numpy(v) for v in logmel.split_tf32(b))
    if products == 1:
        return (ah @ bh).numpy()
    return (ah @ bh + (al @ bh + ah @ bl)).numpy()


def _kernel_emulation(x, rate, fl, fs, fft, mel, fmax, products):
    W, M = logmel.kernel_bases(fl, fft, mel, rate, 0.0, fmax, False)
    frames = torch.as_tensor(x).unfold(1, fl, fs)[..., :min(fl, fft)].numpy()
    A = np.zeros(frames.shape[:2] + (W.shape[0],), np.float32)
    A[..., :frames.shape[-1]] = frames
    Y = _tf32_product(A, W, products)
    power = Y[..., 0::2] * Y[..., 0::2] + Y[..., 1::2] * Y[..., 1::2]
    return np.log(_tf32_product(power, M, products)[..., :mel] + 1e-6)


@pytest.mark.parametrize("rate,fl,fft,mel,fmax", GEOMETRIES)
def test_3xtf32_product_holds_the_float32_budget(rate, fl, fft, mel, fmax):
    """The kernel's "highest" numerics, emulated on the CPU: 3xTF32 agrees
    with logmel_plain within the float32 budget of chip_smoke.py (atol 1e-4
    + rtol 1e-4), and is closer to a float64 evaluation than one TF32
    product."""
    x = _signals(2, 1.0, rate)
    fs = rate // 100
    kw = dict(fft_length=fft, num_mel_bins=mel, fmax=fmax)
    plain = logmel.logmel_plain(torch.as_tensor(x), rate, **kw).numpy()
    three = _kernel_emulation(x, rate, fl, fs, fft, mel, fmax, 3)
    one = _kernel_emulation(x, rate, fl, fs, fft, mel, fmax, 1)
    W, M = logmel.kernel_bases(fl, fft, mel, rate, 0.0, fmax, False)
    frames = np.lib.stride_tricks.sliding_window_view(
        x.astype(np.float64), fl, axis=1)[:, ::fs, :W.shape[0]]
    Y = frames @ W[:frames.shape[-1]].astype(np.float64)
    exact = np.log((Y[..., 0::2] ** 2 + Y[..., 1::2] ** 2)
                   @ M.astype(np.float64)[:, :mel] + 1e-6)
    assert three.shape == plain.shape == exact.shape
    np.testing.assert_allclose(three, plain, rtol=1e-4, atol=1e-4)
    err3, err1 = (np.abs(v - exact).max() for v in (three, one))
    assert err3 < err1, (err3, err1)


def test_pallas_request_reaches_fused_wrapper(monkeypatch):
    """Canary: stft_method="pallas" must reach ops.logmel.fused_logmel
    (the CUDA kernel on a CUDA tensor); the test fails if the dispatcher
    stops routing there."""
    calls = []
    real = logmel.fused_logmel

    def counting(*args, **kw):
        calls.append(kw.get("precision"))
        return real(*args, **kw)

    monkeypatch.setattr(logmel, "fused_logmel", counting)
    x = torch.as_tensor(_signals(2, 1.0))
    for feature_type in ("logmelspectrogram", "mfcc"):
        out = TF.extract_features(x, RATE, feature_type=feature_type,
                                  melspectrogram={"num_mel_bins": 40},
                                  stft_method="pallas")
        ref = TF.extract_features(x, RATE, feature_type=feature_type,
                                  melspectrogram={"num_mel_bins": 40},
                                  stft_method="matmul")
        np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-5)
    assert calls == ["highest", "highest"]


def test_unsupported_request_logs_and_takes_matmul(monkeypatch, caplog):
    monkeypatch.setattr(logmel, "fused_logmel", None)  # must not be reached
    x = torch.as_tensor(_signals(1, 1.0))
    kw = dict(feature_type="logmelspectrogram", spectrogram={"power": 1.0},
              melspectrogram={"num_mel_bins": 40})
    with caplog.at_level(logging.INFO, logger="lidbox_tpu_torch"):
        out = TF.extract_features(x, RATE, stft_method="pallas", **kw)
    assert "stft_method='pallas' unavailable for this request" in caplog.text
    ref = TF.extract_features(x, RATE, stft_method="matmul", **kw)
    np.testing.assert_array_equal(out.numpy(), ref.numpy())
    # a split mode the kernel lacks takes the matmul path the same way
    caplog.clear()
    with caplog.at_level(logging.INFO, logger="lidbox_tpu_torch"):
        out = TF.extract_features(x, RATE, stft_method="pallas",
                                  feature_type="logmelspectrogram",
                                  precision="bf16_3x")
    assert "precision=bf16_3x" in caplog.text
    ref = TF.extract_features(x, RATE, stft_method="matmul",
                              feature_type="logmelspectrogram",
                              precision="bf16_3x")
    np.testing.assert_array_equal(out.numpy(), ref.numpy())
    monkeypatch.undo()
    with pytest.raises(ValueError, match="bf16_3x"):  # the kernel lacks it
        logmel.fused_logmel(x, RATE, precision="bf16_3x")


class _ClaimsCuda(torch.Tensor):
    @property
    def device(self):
        return torch.device("cuda")


def test_cuda_request_never_takes_the_plain_path(monkeypatch):
    """A CUDA tensor launches the kernel or raises: with the library
    unavailable the wrapper must raise, never compute the plain version."""
    def no_library():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(logmel, "_load_library", no_library)
    monkeypatch.setattr(logmel, "logmel_plain", None)
    x = torch.Tensor._make_subclass(_ClaimsCuda, torch.zeros(2, 16000))
    assert x.device.type == "cuda"
    with pytest.raises(RuntimeError, match="nvcc"):
        logmel.fused_logmel(x, RATE)
    with pytest.raises(ValueError, match="cpu or cuda"):
        logmel.fused_logmel(torch.zeros(2, 16000, device="meta"), RATE)


def test_wrapper_rejects_bad_inputs():
    with pytest.raises(ValueError, match="float32"):
        logmel.fused_logmel(torch.zeros(2, 16000, dtype=torch.float64), RATE)
    with pytest.raises(ValueError, match="batch, samples"):
        logmel.fused_logmel(torch.zeros(16000), RATE)
    with pytest.raises(ValueError, match="shorter than one"):
        logmel.fused_logmel(torch.zeros(1, 399), RATE)
    with pytest.raises(ValueError, match="precision"):
        logmel.fused_logmel(torch.zeros(1, 16000), RATE, precision="bf16_3x")


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """A missing compiler is an error, never a silent plain fallback."""
    monkeypatch.setattr(logmel, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(logmel, "LIBRARY", str(tmp_path / "liblogmel.so"))
    monkeypatch.setattr(logmel.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        logmel.build()

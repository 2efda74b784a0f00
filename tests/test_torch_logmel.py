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
from unittest import mock

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

import lidbox_tpu_torch.features as TF
from lidbox_tpu import testutil
from lidbox_tpu_torch.features import audio
from lidbox_tpu.ops import fused_logmel_packed, logmel_reference
from lidbox_tpu_torch.ops import logmel

torch.set_num_threads(2)

RATE = 16000


def _signals(batch=2, seconds=1.5, rate=RATE):
    return np.stack([testutil.noisy_sinewave(150 * (i + 1), rate, 0.1,
                                             seconds, seed=i)
                     for i in range(batch)])


def no_kernel():
    """Within it, reaching the kernels' library fails: the CPU launches no
    kernel."""
    def load():
        raise AssertionError("a CPU tensor reached the CUDA kernel")
    return mock.patch.object(logmel, "_load_library", load)


def _port(x, rate=RATE, **kw):
    """Both port entry points on a CPU tensor; they must agree exactly."""
    t = torch.as_tensor(x)
    plain = logmel.logmel_plain(t, rate, **kw).numpy()
    with no_kernel():
        fused = logmel.fused_logmel(t, rate, **kw).numpy()
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


def _decode(flat, N, Kc, bf16):
    """[..., N * Kc] in core_matrix_order -> [..., N, Kc] by the addressing of
    a no-swizzle K-major wgmma descriptor: k-steps 2 * LBO apart, K halves
    LBO = N / 8 * 128 bytes apart, 8-column groups SBO = 128 bytes apart,
    columns 16 bytes apart within a core matrix."""
    size = 2 if bf16 else 4
    half = 16 // size
    n, k = np.arange(N)[:, None], np.arange(Kc)[None, :]
    lbo = N // 8 * 128
    byte = (k // (2 * half) * 2 * lbo + k % (2 * half) // half * lbo
            + n // 8 * 128 + n % 8 * 16 + k % half * size)
    return np.asarray(flat)[..., byte // size]


def _as_float(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else t


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("rate,fl,fft,mel,fmax", GEOMETRIES)
def test_wgmma_tiles_map_back_to_kernel_bases(rate, fl, fft, mel, fmax, bf16):
    """The streams the kernel bulk-copies, read back through its descriptors'
    addressing, are kernel_bases' W and M: W^T tiles per (pass, 32-row
    chunk), hi then lo of split_tf32 in "highest"; M's rows per pass,
    permuted within each k-step by mel_row_order; zero padding beyond."""
    W, M = logmel.kernel_bases(fl, fft, mel, rate, 0.0, fmax, bf16)
    mc, rounds = logmel.mel_layout(mel)
    wt = _as_float(logmel.basis_tiles(W, bf16))
    mt = _as_float(logmel.mel_tiles(M, bf16, mc, rounds))
    passes = -(-M.shape[0] // logmel.PASS_BINS)
    chunks = -(-W.shape[0] // logmel.CHUNK)
    parts, size, msize = (1 if bf16 else 2), 64 * 32, mc * 32 * 32
    elem = 2 if bf16 else 4
    assert wt.shape == (passes, chunks, parts * size)
    assert parts * size * elem == logmel.TILE_BYTES[bf16]
    assert mt.shape == (rounds, passes, parts * msize)
    assert parts * msize * elem == mc * logmel.MEL_CHUNK_BYTES[bf16]
    Wp = np.zeros((chunks * 32, passes * 64), np.float32)
    Wp[:W.shape[0], :W.shape[1]] = W
    Mp = np.zeros((passes * 32, rounds * mc * 32), np.float32)
    Mp[:M.shape[0], :M.shape[1]] = M
    want = [Wp] if bf16 else list(logmel.split_tf32(Wp))
    wantm = [Mp] if bf16 else list(logmel.split_tf32(Mp))
    depth = logmel.MMA_DEPTH[bf16]
    order = logmel.mel_row_order(bf16)
    k = np.arange(passes * 32)
    for part in range(parts):
        tiles = _decode(wt[..., part * size:(part + 1) * size], 64, 32, bf16)
        got = tiles.transpose(1, 3, 0, 2).reshape(chunks * 32, passes * 64)
        np.testing.assert_array_equal(got, want[part])
        mtiles = _decode(mt[..., part * msize:(part + 1) * msize], mc * 32,
                         32, bf16)  # [rounds, passes, columns, k]
        rows = mtiles.transpose(1, 3, 0, 2).reshape(passes * 32,
                                                    rounds * mc * 32)
        np.testing.assert_array_equal(
            rows, wantm[part][k // depth * depth + order[k % depth]])


@pytest.mark.parametrize("bf16", [False, True])
def test_dft_accumulator_is_the_mel_a_fragment(bf16):
    """The kernel hands each pass's power from the DFT accumulator straight
    to the mel product's A fragment (csrc/logmel.cu, the end of a pass).
    PTX's wgmma tables: accumulator register 4i + 2h + e of lane 4g + t holds
    row g + 8h, column 8i + 2t + e, so registers 4i + 2h, 4i + 2h + 1 (cos,
    sin) give the power of bin 4i + t at row g + 8h. The tf32 k8 A fragment's
    register r holds row g + 8 (r & 1), k t + 4 (r >> 1); the bf16 k16
    fragment's register r, half e holds row g + 8 (r & 1), k 2t + e + 8 (r >>
    1). At every lane and register the bin the kernel puts there must be the
    bin mel_row_order puts at that k of M's rows."""
    order = logmel.mel_row_order(bf16)
    for lane in range(32):
        g, t = divmod(lane, 4)
        cols = {reg: (g + 8 * (reg % 4 // 2), 8 * (reg // 4) + 2 * t + reg % 2)
                for reg in range(32)}  # the accumulator of a 64-column pass
        power = {(i, h): (cols[4 * i + 2 * h][0], cols[4 * i + 2 * h][1] // 2)
                 for i in range(8) for h in range(2)}
        assert all(cols[4 * i + 2 * h + 1] == (power[i, h][0],
                                               2 * power[i, h][1] + 1)
                   for i in range(8) for h in range(2))
        if not bf16:  # k8 step q: {pw[2q][0], pw[2q][1], pw[2q+1][0], pw[2q+1][1]}
            for q in range(4):
                fed = [power[2 * q, 0], power[2 * q, 1], power[2 * q + 1, 0],
                       power[2 * q + 1, 1]]
                for r in range(4):
                    row, k = g + 8 * (r & 1), t + 4 * (r >> 1)
                    assert fed[r] == (row, 8 * q + order[k])
        else:  # k16 step q: register r, half e from group 4q + 2 (r >> 1) + e
            for q in range(2):
                for r in range(4):
                    for e in range(2):
                        fed = power[4 * q + 2 * (r >> 1) + e, r & 1]
                        row, k = g + 8 * (r & 1), 2 * t + e + 8 * (r >> 1)
                        assert fed == (row, 16 * q + order[k])


def _geometry(rate, kw, bf16):
    fl = audio.ms_to_frames(rate, kw.get("frame_length_ms", 25))
    step = audio.ms_to_frames(rate, kw.get("frame_step_ms", 10))
    fft, n_mel = kw.get("fft_length", 512), kw.get("num_mel_bins", 64)
    W, M = logmel.kernel_bases(fl, fft, n_mel, rate, kw.get("fmin", 0.0),
                               kw.get("fmax", 8000.0), bf16)
    return fl, step, min(fl, fft), n_mel, W, M


def _emulate_kernel(x, rate, kw, bf16, max_smem, sms):
    """The kernel's tiling in float64, from its own host layouts: blocks of
    nwg 64-frame tiles, the span staged in rows of `step` samples at `pitch`
    and read at the offset table's (k // step) * pitch + k % step, bin
    passes split over blocks, the basis and mel tiles read through the
    descriptors' addressing, the power in the A fragment's bin order, each
    pass's mel sums added in pass order (in the block; where split, the
    first split's sum and each later pass's sums by the reduction). Returns
    (log-Mel, how often each output was written, plan)."""
    fl, step, L, n_mel, W, M = _geometry(rate, kw, bf16)
    B, T = x.shape
    F = audio.num_frames(T, fl, step)
    plan = logmel.kernel_plan(B, T, F, step, L, M.shape[0], n_mel, bf16, sms,
                              max_smem)
    mc, rounds, P = plan["mc"], plan["rounds"], plan["pitch"]
    wt = _decode(logmel.core_matrix_order(
        logmel.basis_blocks(W.astype(np.float64)), bf16), 64, 32, bf16)
    mt = _decode(logmel.core_matrix_order(
        logmel.mel_blocks(M.astype(np.float64), bf16, mc, rounds), bf16),
        mc * 32, 32, bf16)
    depth, order = logmel.MMA_DEPTH[bf16], logmel.mel_row_order(bf16)
    k = np.arange(plan["K"])
    koff = k // step * P + k % step
    assert koff.max() + 63 * P < plan["rows"] * P  # reads stay in the span
    out = np.zeros((B, F, n_mel))
    partial = np.zeros((logmel.partial_slices(plan), B, F, n_mel))
    written = np.zeros((B, F, n_mel), np.int64)
    nwg, tpr, total = plan["nwg"], plan["tiles_per_row"], plan["total_tiles"]
    bins = np.arange(32)
    bins = bins // depth * depth + order[bins % depth]
    for bx in range(-(-total // nwg)):
        for sy in range(plan["splits"]):
            for rz in range(rounds):
                for cw in range(min(nwg, total - bx * nwg)):
                    tile = bx * nwg + cw
                    b, f0 = tile // tpr, tile % tpr * 64
                    span = np.zeros(plan["span_floats"])
                    for r in range(plan["rows"]):
                        s_ = (f0 + r) * step + np.arange(plan["cols"])
                        span[r * P:r * P + plan["cols"]] = np.where(
                            s_ < T, x[b, np.minimum(s_, T - 1)], 0.0)
                    A = span[np.arange(64)[:, None] * P + koff[None, :]]
                    nf = min(64, F - f0)
                    m0 = rz * mc * 32
                    m1 = min(n_mel, m0 + mc * 32)
                    mel = np.zeros((64, mc * 32))
                    for p in range(sy * plan["pps"],
                                   min(plan["passes"], (sy + 1) * plan["pps"])):
                        acc = np.zeros((64, 64))
                        for c in range(plan["nchunks"]):
                            acc += A[:, 32 * c:32 * c + 32] @ wt[p, c].T
                        power = acc[:, 0::2] ** 2 + acc[:, 1::2] ** 2
                        part = power[:, bins] @ mt[rz, p].T
                        if sy == 0:
                            mel += part
                        else:  # a later split: each pass's sums
                            partial[p - plan["pps"] + 1, b, f0:f0 + nf,
                                    m0:m1] = part[:nf, :m1 - m0]
                            written[b, f0:f0 + nf, m0:m1] += 1
                    if sy == 0:
                        written[b, f0:f0 + nf, m0:m1] += 1
                        if plan["splits"] == 1:
                            out[b, f0:f0 + nf, m0:m1] = np.log(
                                mel[:nf, :m1 - m0] + 1e-6)
                        else:
                            partial[0, b, f0:f0 + nf, m0:m1] = mel[:nf,
                                                                  :m1 - m0]
    if plan["splits"] > 1:
        out = logmel.split_reduce_plain(torch.from_numpy(partial)).numpy()
    return out, written, plan


@pytest.mark.parametrize("batch,seconds,rate,kw,bf16,smem,sms,splits", [
    (1, 2.3456, RATE, {}, False, 232448, 132, 8),  # odd T, one pass a split
    (3, 2.0, RATE, {}, False, 232448, 132, 8),     # tile pairs across rows
    (2, 1.0, 8000, {}, True, 232448, 132, 8),      # the Nyquist bin kept
    (1, 0.5, RATE, {"frame_step_ms": 2}, False, 232448, 132, 8),  # step < L
    (2, 1.0, RATE, {"fft_length": 256}, True, 232448, 132, 4),
    (1, 0.5, RATE, {"fft_length": 2048}, False, 232448, 132, 31),
    (1, 0.5, RATE, {"fft_length": 4096}, True, 232448, 132, 62),
    (2, 1.0, RATE, {"num_mel_bins": 200}, False, 232448, 4, 1),  # mel rounds
    (2, 1.0, 11025, {}, False, 190000, 12, 3),  # step 110, one consumer
    (2, 1.0, RATE, {"num_mel_bins": 40, "fmin": 20.0, "fmax": 7000.0}, True,
     232448, 2, 1),
])
def test_kernel_tiling_reproduces_the_function_in_float64(
        batch, seconds, rate, kw, bf16, smem, sms, splits):
    """Every (row, frame, mel) is written once, or once to each slice of the
    partial sums where the passes are split over blocks, ragged last tiles
    and tiles that end past T included, and the tiling, the layouts and the
    ordered reduction of the slices give the function itself: float64
    within 1e-9 of the plain formula on kernel_bases' operands."""
    x = _signals(batch, seconds, rate).astype(np.float64)
    out, written, plan = _emulate_kernel(x, rate, kw, bf16, smem, sms)
    assert plan["splits"] == splits
    assert (written == logmel.partial_slices(plan)
            if plan["splits"] > 1 else written == 1).all()
    if smem < 232448:  # the span fits the block once only
        assert plan["nwg"] == 1
    fl, step, L, n_mel, W, M = _geometry(rate, kw, bf16)
    frames = np.lib.stride_tricks.sliding_window_view(x, fl, axis=1)[
        :, ::step, :L]
    Y = frames @ W[:L].astype(np.float64)
    ref = np.log((Y[..., 0::2] ** 2 + Y[..., 1::2] ** 2)
                 @ M.astype(np.float64)[:, :n_mel] + 1e-6)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-9)


def _plan(B, T, bf16=False, sms=132, smem=232448, **kw):
    F = 1 + (T - 400) // 160
    return logmel.kernel_plan(B, T, F, 160, 400, 246, 64, bf16, sms, smem,
                              **kw)


def test_kernel_plan_fills_the_card_and_bounds_the_basis_stream():
    """The split count follows the SM count: a streaming chunk (4 tiles of
    [1, 32000]) spreads its 8 passes over 16 blocks; a served batch of [32,
    64000] is one wave of 112 unsplit blocks whose basis stream is at most
    220 MB (the 32-frame blocks read 709 MB); splits partition the passes."""
    p1 = _plan(1, 32000)
    assert (p1["splits"], p1["pps"], p1["total_tiles"]) == (8, 1, 4)
    assert logmel.plan_stats(p1, False, 132)["blocks"] == 16
    p32 = _plan(32, 64000)
    st = logmel.plan_stats(p32, False, 132)
    assert p32["splits"] == 1 and st["blocks"] == st["sms_used"] == 112
    assert st["basis_bytes"] <= 220e6
    assert abs(st["padded_frames"] - (1 - 398 / 448)) < 1e-12
    for B, T in ((32, 48000), (32, 32000), (3, 32000), (64, 32000)):
        for bf16 in (False, True):
            p = _plan(B, T, bf16)
            covered = sorted(q for s_ in range(p["splits"])
                             for q in range(s_ * p["pps"],
                                            min(p["passes"],
                                                (s_ + 1) * p["pps"])))
            assert covered == list(range(p["passes"]))


def test_kernel_plan_sizes_shared_memory():
    """The plan's bytes are the library's layout (rings, mel slots, a span,
    an offset table and the mel sums per consumer, barriers); two consumers
    fall back to one where both do not fit, and none fitting raises."""
    p = _plan(2, 16000)
    stages = logmel.ring_stages(False)
    assert p["smem"] == (stages * 2 * logmel.TILE_BYTES[False]
                         + 2 * p["mc"] * logmel.MEL_CHUNK_BYTES[False]
                         + p["nwg"] * (p["span_floats"] + p["K"]
                                       + 128 * 16 * p["mc"]) * 4
                         + (2 * stages + 4) * 8)
    assert p["pitch"] % 32 == logmel.PITCH_MOD[False]
    assert _plan(2, 16000, True)["pitch"] % 32 == logmel.PITCH_MOD[True]
    assert len(logmel.GEO_FIELDS) == 20 and set(logmel.GEO_FIELDS) <= set(p)
    assert _plan(32, 64000, smem=200000)["nwg"] == 1
    with pytest.raises(ValueError, match="shared memory"):
        _plan(32, 64000, smem=60000)


def test_split_reduce_adds_the_splits_in_order():
    """On the CPU split_reduce is its plain version: the splits added one
    after another, then log(. + 1e-6); no kernel is counted."""
    rng = np.random.default_rng(3)
    part = torch.as_tensor(rng.uniform(0, 2, (5, 2, 7, 3)).astype(np.float32))
    with no_kernel():
        out = logmel.split_reduce(part)
    total = part[0].clone()
    for s_ in range(1, 5):
        total = total + part[s_]
    assert torch.equal(out, torch.log(total + 1e-6))
    with pytest.raises(ValueError, match="partial"):
        logmel.split_reduce(part[0])


def _tf32_parts(a):
    return [torch.from_numpy(v) for v in logmel.split_tf32(a)]


def _kernel_emulation(x, rate, fl, fs, fft, mel, fmax, products):
    """The kernel's "highest" numerics, one 32-bin pass at a time as it runs
    them: operands split by TF32 round-to-nearest-away, each product of TF32
    values exact, float32 accumulation. 3 products: hi*hi in one
    accumulator and lo*hi + hi*lo in another, added when the pass ends; the
    pass's power times its rows of M as lo*hi, hi*lo, hi*hi in one
    accumulator from zero, added to the passes before. 1 product: hi*hi
    alone."""
    W, M = logmel.kernel_bases(fl, fft, mel, rate, 0.0, fmax, False)
    frames = torch.as_tensor(x).unfold(1, fl, fs)[..., :min(fl, fft)].numpy()
    A = np.zeros(frames.shape[:2] + (W.shape[0],), np.float32)
    A[..., :frames.shape[-1]] = frames
    ah, al = _tf32_parts(A)
    total = torch.zeros(A.shape[:2] + (M.shape[1],))
    for p in range(0, M.shape[0], logmel.PASS_BINS):
        wh, wl = _tf32_parts(W[:, 2 * p:2 * p + 2 * logmel.PASS_BINS])
        mh, ml = _tf32_parts(M[p:p + logmel.PASS_BINS])
        Y = ah @ wh if products == 1 else ah @ wh + (al @ wh + ah @ wl)
        power = Y[..., 0::2] * Y[..., 0::2] + Y[..., 1::2] * Y[..., 1::2]
        ph, pl = _tf32_parts(power.numpy())
        part = ph @ mh if products == 1 else pl @ mh + ph @ ml + ph @ mh
        total = total + part
    return np.log(total.numpy()[..., :mel] + 1e-6)


@pytest.mark.parametrize("rate,fl,fft,mel,fmax", GEOMETRIES)
def test_3xtf32_product_holds_the_float32_budget(rate, fl, fft, mel, fmax):
    """The kernel's "highest" numerics, emulated on the CPU in its order of
    passes and accumulators: 3xTF32 agrees with logmel_plain within the
    float32 budget of chip_smoke.py (atol 1e-4 + rtol 1e-4), and is closer to
    a float64 evaluation than one TF32 product."""
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

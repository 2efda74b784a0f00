#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``lidbox_tpu_torch``) on one GPU.

Run from the repository root on a machine with an NVIDIA H100 (sm_90a):

    python3 chip_smoke.py

Phases, each of which fails the run:

1. device and build: the card's name and power limit, then the fused
   log-Mel CUDA kernel built with nvcc from ``lidbox_tpu_torch/csrc``, and
   the instruction each precision mode runs, as the library reports it;
2. kernel vs plain on the geometry cases of the tests (odd lengths, mel
   ranges, 8 kHz, fft < frame length, 25/2 ms) and on fft 2048 and 4096,
   whose power tiles take the kernel's smaller frame tiles;
3. serving, the main path: a full-width x-vector (random weights from a
   seed) behind ``serve.Classifier`` with ``stft_method: "pallas"``
   classifies 32 whole 3 s wavs and the same wavs in 2 s / 1 s chunks, and
   ``StreamingClassifier`` scores one of them online. The launch count is
   zeroed just before and read just after, and every signal batch the
   feature extractor hands on is kept. Scores must match the matmul
   feature path on the card and the plain CPU path, and streaming must
   match the offline chunked scores;
4. training, the second main path: ``ModelWrapper.from_config`` builds the
   full-width x-vector (weights from the seed), Adam 1e-3, the NLL loss, a
   C_avg metric, ``ModelCheckpoint`` and ``EarlyStopping``, and
   ``fit_fused`` trains it with ``stft_method: "pallas"`` for 3 epochs of 8
   batches of 32 class-separable 3 s noisy sines, validating on 2 batches.
   The launch count is zeroed just before and read just after: one launch
   per train step and per validation batch (3 x 8 + 2). The epoch loss
   must fall, val_loss and C_avg be finite, the checkpoints carry the JAX
   package's names, and the last one, restored into a fresh Trainer,
   must evaluate exactly as the trained state does. The first 3 step
   losses must match a run with ``stft_method: "matmul"`` on the card and
   the first 2 those of a run on the CPU (the plain version), within rtol
   1e-3. cuDNN runs its deterministic algorithms in this phase;
5. kernel vs plain at the main paths' shapes: ``fused_logmel`` against
   ``logmel_plain`` on the very batches kept in phase 3 (bucketed: a 3 s
   batch is padded to the 4 s bucket) and on a training batch, [32, 48000]
   (fixed-length crops, no bucket); kernel, plain and bound times per
   shape, the largest one in the kernel table. The bound of "highest" is
   its 3xTF32 tensor-core work (3 products at 495 TFLOP/s), with the
   float32 CUDA-core bound printed beside it; ``dft_gemm_ms`` is one cuBLAS
   float32 product of the unfolded frames by the DFT basis, a yardstick
   for the bulk of the work;
6. the steady train step at [32, 48000]: the median of 30 steps on CUDA
   events, split into features, forward + backward and optimizer, beside
   the kernel's time at that shape and its share of the step, and the
   device's busy time over 5 steps under ``torch.profiler``;
7. the kernel table as one JSON line, the card line, and the result line.

Every comparison of the kernel with its plain version holds float32 within
atol 1e-4 + rtol 1e-4 (the allclose of the tests; the distance of each from
a float64 evaluation is printed beside it), bfloat16 against the float32
plain output within the JAX package's
mean/median budget, and bfloat16 against the bfloat16 plain output (the
same rounding points) within a budget set from chip readings.

TF32 is turned off for matmuls and cuDNN convolutions, so float32 means
float32 throughout. Served utterances/s is a smoke figure, not a benchmark.
Exits non-zero without a CUDA device or without the package beside it.
"""
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SEED = 1234
RATE = 16000
LABELS = ["l0", "l1", "l2", "l3", "l4"]
FEATURES_PALLAS = {"type": "logmelspectrogram",
                   "melspectrogram": {"num_mel_bins": 64},
                   "stft_method": "pallas"}
# what extract_features hands fused_logmel for FEATURES_PALLAS
KERNEL_KW = {"num_mel_bins": 64}
# Published H100 SXM peaks (NVIDIA data sheet, 700 W).
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
# Tensor-core products per float32 product, and their peak: "highest" runs
# as 3xTF32, "bf16" as one bf16 product.
PRODUCTS = {"highest": (3, PEAK_TF32_FLOPS), "bf16": (1, PEAK_BF16_FLOPS)}
# float32: |kernel - plain| <= atol + rtol * |plain|, the allclose of
# tests/test_ops.py. Two float32 summation orders differ most at low-energy
# mel bins (large negative log values), hence the relative term.
F32_ATOL = F32_RTOL = 1e-4
BF16_MEAN, BF16_MEDIAN = 5e-2, 3e-2             # vs float32 plain
BF16_PLAIN_MEAN, BF16_PLAIN_MEDIAN = 1e-4, 1e-5  # vs bfloat16 plain
SERVE_ATOL = 1e-4
STREAM_ATOL = 1e-5
# Training: 3 epochs of 8 batches of 32 x 3 s, 2 validation batches. The
# first step losses of the kernel, matmul and CPU runs agree within
# TRAIN_RTOL, not exactly: their features differ in float32 rounding, and
# Adam's first updates (about lr * sign(g)) amplify that wherever a gradient
# sits near zero. cuDNN runs its deterministic algorithms in that phase, so
# the comparison reads the same on every run of one tree.
TRAIN_BATCHES, VAL_BATCHES, TRAIN_EPOCHS = 8, 2, 3
TRAIN_BATCH, TRAIN_SECONDS = 32, 3.0
TRAIN_RTOL = 1e-3
CKPT_NAME = re.compile(r"^epoch\d{6}__val_loss-?\d+\.\d{12}\.ckpt$")


def check(ok, message):
    if not ok:
        raise RuntimeError(message)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def noisy_sines(rng, batch, seconds, rate):
    t = np.arange(int(rate * seconds)) / rate
    freqs = rng.uniform(100.0, 1000.0, (batch, 1))
    sig = np.sin(2 * np.pi * freqs * t) + 0.1 * rng.uniform(-1, 1, (batch, t.size))
    return (0.7 * sig / np.abs(sig).max(axis=1, keepdims=True)).astype(np.float32)


def cuda_ms(fn, reps=7, iters=20):
    """Median over ``reps`` of the mean time of ``iters`` launches."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return float(np.median(times))


def geometry(logmel, rate, kw):
    """(frame length, frame step, L, NB, W, M) of one fused_logmel call: L
    basis rows and NB weighted bins (unpadded), W [L, 2 * NB] (bin i's cos
    and sin at columns 2i, 2i + 1) and M [NB, n_mel], float32."""
    from lidbox_tpu_torch.features import audio
    fl = audio.ms_to_frames(rate, kw.get("frame_length_ms", 25))
    fs = audio.ms_to_frames(rate, kw.get("frame_step_ms", 10))
    fft, n_mel = kw.get("fft_length", 512), kw.get("num_mel_bins", 64)
    W, M = logmel.kernel_bases(fl, fft, n_mel, rate, kw.get("fmin", 0.0),
                               kw.get("fmax", 8000.0), False)
    L, NB = min(fl, fft), int(np.flatnonzero(M.any(axis=1))[-1]) + 1
    return fl, fs, L, NB, W[:L, :2 * NB], M[:NB, :n_mel]


def logmel_work(logmel, batch, samples, rate, kw):
    """(operations, bytes) of one call: the two products over the bins the
    kernel computes (nonzero mel weight); signal in once, log-Mel out once."""
    fl, fs, L, NB, _, M = geometry(logmel, rate, kw)
    frames = 1 + (samples - fl) // fs
    flops = 2 * batch * frames * (L * 2 * NB + NB * M.shape[1])
    return flops, 4 * batch * samples + 4 * batch * frames * M.shape[1]


def bound(flops, nbytes, peak):
    """Least time the card could take: the larger of operations over their
    peak rate and bytes over the memory rate."""
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def logmel_bound(logmel, batch, samples, rate, precision, kw):
    """The bound of the kernel's own arithmetic: 3xTF32 tensor-core products
    in "highest", one bf16 product in "bf16"."""
    flops, nbytes = logmel_work(logmel, batch, samples, rate, kw)
    products, peak = PRODUCTS[precision]
    return bound(products * flops, nbytes, peak)


def logmel_f64(logmel, x, rate, kw):
    """The kernel's function evaluated in float64 on the card: how far each
    float32 evaluation is from the exact value."""
    fl, fs, L, _, W, M = geometry(logmel, rate, kw)
    W = torch.as_tensor(W, dtype=torch.float64, device=x.device)
    M = torch.as_tensor(M, dtype=torch.float64, device=x.device)
    y = x.double().unfold(1, fl, fs)[..., :L] @ W
    return torch.log((y[..., 0::2] ** 2 + y[..., 1::2] ** 2) @ M + 1e-6)


def dft_gemm_ms(logmel, x, rate, kw):
    """Yardstick for the bulk of the work: one cuBLAS float32 product of the
    unfolded frames [B * frames, L] by W [L, 2 * NB] (TF32 off). Not a call
    the port makes, and not the whole function."""
    fl, fs, L, _, W, _ = geometry(logmel, rate, kw)
    frames = x.unfold(1, fl, fs)[..., :L].reshape(-1, L).contiguous()
    W = torch.as_tensor(W, device=x.device).contiguous()
    return cuda_ms(lambda: torch.matmul(frames, W))


def compare(logmel, name, x, rate, kw):
    """fused_logmel against logmel_plain on one CUDA tensor, both modes.
    Returns the float32 max abs error."""
    ref = logmel.logmel_plain(x, rate, **kw)
    out = logmel.fused_logmel(x, rate, **kw)
    exact = logmel_f64(logmel, x, rate, kw)
    torch.cuda.synchronize()
    check(out.shape == ref.shape, f"{name}: shape {out.shape} != {ref.shape}")
    diff = (out - ref).abs()
    err = diff.max().item()
    excess = (diff / (F32_ATOL + F32_RTOL * ref.abs())).max().item()
    check(excess <= 1.0, f"{name}: float32 max abs error {err} beyond atol "
                         f"{F32_ATOL} + rtol {F32_RTOL}")
    out16 = logmel.fused_logmel(x, rate, precision="bf16", **kw)
    ref16 = logmel.logmel_plain(x, rate, precision="bf16", **kw)
    torch.cuda.synchronize()
    e16, p16 = (out16 - ref).abs(), (out16 - ref16).abs()
    mean16, median16 = e16.mean().item(), e16.median().item()
    pmean, pmedian = p16.mean().item(), p16.median().item()
    check(mean16 < BF16_MEAN and median16 < BF16_MEDIAN,
          f"{name}: bf16 vs float32 plain mean {mean16} median {median16}")
    check(pmean < BF16_PLAIN_MEAN and pmedian < BF16_PLAIN_MEDIAN,
          f"{name}: bf16 vs bf16 plain mean {pmean} median {pmedian}")
    print(f"kernel case {name}: shape {tuple(out.shape)} float32 max abs "
          f"err {err:.3e} ({excess:.2f} of tolerance), vs float64: kernel "
          f"{(out - exact).abs().max().item():.3e} plain "
          f"{(ref - exact).abs().max().item():.3e}; bf16 vs float32 plain "
          f"mean {mean16:.3e} median {median16:.3e}; bf16 vs bf16 plain mean "
          f"{pmean:.3e} median {pmedian:.3e} max {p16.max().item():.3e}")
    return err


def phase_geometry(logmel, rng):
    cases = [  # name, batch, seconds, rate, kwargs
        ("1.5s", 2, 1.5, 16000, {}),
        ("2.3456s", 2, 2.3456, 16000, {}),
        ("40mel_20-7000Hz", 2, 1.0, 16000,
         {"num_mel_bins": 40, "fmin": 20.0, "fmax": 7000.0}),
        ("80mel_0-8000Hz", 2, 1.0, 16000, {"num_mel_bins": 80}),
        ("8kHz_fmax8000", 2, 1.0, 8000, {}),
        ("fft256_frame400", 2, 1.0, 16000, {"fft_length": 256}),
        ("25/2ms", 2, 0.5, 16000, {"frame_step_ms": 2}),
        # power tiles of 1024 and 2048 bins: the 32- and 16-frame tiles
        ("fft2048", 2, 1.0, 16000, {"fft_length": 2048}),
        ("fft4096", 2, 1.0, 16000, {"fft_length": 4096}),
    ]
    worst = 0.0
    for name, batch, seconds, rate, kw in cases:
        x = torch.as_tensor(noisy_sines(rng, batch, seconds, rate),
                            device="cuda")
        worst = max(worst, compare(logmel, name, x, rate, kw))
    return worst


def phase_path_kernel(logmel, batches):
    """The kernel on the signal batches the main paths handed it: each one
    compared with the plain version, each shape timed. Returns the worst
    float32 error and {(B, T, precision): (ms, plain_ms, bound_ms,
    bound_by)}."""
    worst = 0.0
    timing = {}
    with torch.inference_mode():
        for i, (x, rate) in enumerate(batches):
            name = f"path{i}_{x.shape[0]}x{x.shape[1]}"
            worst = max(worst, compare(logmel, name, x, rate, KERNEL_KW))
        for x, rate in {tuple(x.shape): (x, rate) for x, rate in batches}.values():
            B, T = x.shape
            flops, nbytes = logmel_work(logmel, B, T, rate, KERNEL_KW)
            cores_ms, _ = bound(flops, nbytes, PEAK_F32_FLOPS)
            gemm = (f", dft_gemm_ms "
                    f"{dft_gemm_ms(logmel, x, rate, KERNEL_KW):.4f}"
                    if B > 1 else "")
            print(f"fused_logmel [{B}, {T}]: {flops / 1e9:.3f} GFLOP, "
                  f"{nbytes / 1e6:.2f} MB; float32 CUDA-core bound "
                  f"{cores_ms:.4f} ms{gemm}")
            for precision in ("highest", "bf16"):
                kw = dict(KERNEL_KW, precision=precision)
                ms = cuda_ms(lambda: logmel.fused_logmel(x, rate, **kw))
                plain_ms = cuda_ms(lambda: logmel.logmel_plain(x, rate, **kw))
                bound_ms, bound_by = logmel_bound(logmel, B, T, rate,
                                                  precision, KERNEL_KW)
                timing[(B, T, precision)] = (ms, plain_ms, bound_ms, bound_by)
                cores = (f"; {cores_ms / ms:.1%} of the float32 CUDA-core "
                         f"bound" if precision == "highest" else "")
                print(f"fused_logmel [{B}, {T}] 64 mel precision={precision}: "
                      f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                      f"{bound_ms:.4f} ms ({bound_by}), {bound_ms / ms:.1%} "
                      f"of bound{cores}")
    return worst, timing


def write_wavs(io, root, rng, n, seconds):
    paths = []
    for i, sig in enumerate(noisy_sines(rng, n, seconds, RATE)):
        p = os.path.join(root, f"utt{i:03d}.wav")
        io.write_mono_wav(p, sig, RATE)
        paths.append(p)
    return paths


def phase_serve(root, rng):
    """Drives the main path; returns the kernel's launch count over it and
    the signal batches the feature extractor handed on."""
    from lidbox_tpu_torch import models, serve
    from lidbox_tpu_torch.data.device_pipeline import DeviceFeatureExtractor
    from lidbox_tpu_torch.features import io
    from lidbox_tpu_torch.ops import logmel

    n = 32
    paths = write_wavs(io, root, rng, n, 3.0)
    ids = [f"utt{i:03d}" for i in range(n)]
    frames = 1 + (3 * RATE - 400) // 160

    def model(device):
        return models.create("xvector", (frames, 64), len(LABELS),
                             device=device).init(
            torch.Generator().manual_seed(SEED))

    gpu_model = model("cuda")
    print(f"x-vector: {gpu_model.num_params()} parameters, 64 mel, "
          f"{len(LABELS)} labels")
    whole = serve.Classifier(gpu_model, LABELS, feature_config=FEATURES_PALLAS,
                             batch_size=32, device="cuda")
    chunked = serve.Classifier(gpu_model, LABELS, feature_config=FEATURES_PALLAS,
                               chunk_length_ms=2000, chunk_step_ms=1000,
                               batch_size=32, device="cuda")
    stream = serve.StreamingClassifier(gpu_model, LABELS,
                                       feature_config=FEATURES_PALLAS,
                                       sample_rate=RATE, chunk_seconds=2.0,
                                       hop_seconds=1.0, device="cuda")
    signal, _ = io.read_wav(paths[0])
    whole.classify(paths[:4], ids=ids[:4])  # warm-up: cuDNN, allocator

    batches = []
    extract = DeviceFeatureExtractor.extract

    def keeping(self, signals, sample_rate, **kw):
        batches.append((signals.clone(), int(sample_rate)))
        return extract(self, signals, sample_rate, **kw)

    DeviceFeatureExtractor.extract = keeping
    try:
        logmel.fused_logmel.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = whole.classify(paths, ids=ids)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out_chunked = chunked.classify(paths, ids=ids)
        for block in np.array_split(signal, [1234, 20000, 20333]):
            stream.feed(block)
        torch.cuda.synchronize()
        launches = logmel.fused_logmel.launches
    finally:
        DeviceFeatureExtractor.extract = extract

    check(launches > 0, "serving never launched the log-Mel kernel")
    check(launches == len(batches),
          f"{launches} kernel launches for {len(batches)} feature batches")
    check(out["id"] == ids and out_chunked["id"] == ids, "ids lost or reordered")
    scores = np.stack([out[f"score_{l}"] for l in LABELS], axis=1)
    scores_chunked = np.stack([out_chunked[f"score_{l}"] for l in LABELS], axis=1)
    for name, s in (("whole", scores), ("chunked", scores_chunked)):
        check(s.shape == (n, len(LABELS)) and np.isfinite(s).all(),
              f"{name}: scores not finite of shape ({n}, {len(LABELS)})")
        check(np.allclose(np.exp(s).sum(axis=1), 1.0, atol=1e-4),
              f"{name}: log-probabilities do not sum to 1")
    shapes = [tuple(x.shape) for x, _ in batches]
    print(f"serving: {n} whole 3 s utterances in {t1 - t0:.4f} s "
          f"({n / (t1 - t0):.1f} utt/s, smoke figure, not a benchmark); "
          f"kernel launches over whole + chunked + streaming: {launches}, "
          f"signal batches {shapes}")

    matmul_cfg = dict(FEATURES_PALLAS, stft_method="matmul")
    ref = serve.Classifier(gpu_model, LABELS, feature_config=matmul_cfg,
                           batch_size=32, device="cuda").scores(paths, ids=ids)
    ref_chunked = serve.Classifier(
        gpu_model, LABELS, feature_config=matmul_cfg, chunk_length_ms=2000,
        chunk_step_ms=1000, batch_size=32, device="cuda").scores(paths, ids=ids)
    err_mm = max(np.abs(scores - ref["prediction"]).max(),
                 np.abs(scores_chunked - ref_chunked["prediction"]).max())
    check(err_mm <= SERVE_ATOL, f"pallas vs matmul scores differ by {err_mm}")

    cpu = serve.Classifier(model("cpu"), LABELS, feature_config=FEATURES_PALLAS,
                           batch_size=32, device="cpu").scores(paths[:4],
                                                               ids=ids[:4])
    err_cpu = np.abs(scores[:4] - cpu["prediction"]).max()
    check(err_cpu <= SERVE_ATOL, f"card vs CPU plain scores differ by {err_cpu}")
    print(f"serving scores: kernel vs matmul path max abs diff {err_mm:.3e}, "
          f"card vs CPU plain path {err_cpu:.3e} (tolerance {SERVE_ATOL})")

    err_stream = np.abs(stream.scores() - scores_chunked[0]).max()
    check(err_stream <= STREAM_ATOL,
          f"streaming vs offline chunked scores differ by {err_stream}")
    print(f"streaming vs offline chunked: max abs diff {err_stream:.3e} "
          f"(tolerance {STREAM_ATOL}), {stream._num_chunks} chunks")
    return launches, batches


def train_config(root, stft_method="pallas"):
    return {
        "features": dict(FEATURES_PALLAS, sample_rate=RATE,
                         stft_method=stft_method, on_device_augment={}),
        "experiment": {
            "cache_directory": root, "name": f"smoke_{stft_method}",
            "input_shape": [None, 64], "output_shape": [len(LABELS)],
            "model": {"key": "xvector"},
            "optimizer": {"cls": "Adam", "kwargs": {"learning_rate": 1e-3}},
            "loss": {"cls": "SparseCategoricalCrossentropy"},
            "metrics": [{"cls": "SparseAverageDetectionCost", "name": "C_avg",
                         "N": len(LABELS),
                         "threshold_linspace": {"start": -10.0, "stop": 0.0,
                                                "num": 50}}],
            "callbacks": [
                {"cls": "ModelCheckpoint",
                 "kwargs": {"monitor": "val_loss", "mode": "min"}},
                {"cls": "EarlyStopping",
                 "kwargs": {"monitor": "val_loss", "patience": 5}}]}}


def class_sines(rng, n_batches, batch=TRAIN_BATCH, seconds=TRAIN_SECONDS):
    """(signals [batch, samples] float32, labels [batch] int32) pairs that a
    classifier can separate: class k is a tone at 200 + 300 k Hz (+-20 Hz,
    random phase) in white noise of twice the tone's amplitude: hard
    enough that 3 epochs of Adam 1e-3 do not drive the loss to ~0, where
    Adam's steps on vanishing gradients can spike the loss."""
    t = np.arange(int(RATE * seconds)) / RATE
    out = []
    for _ in range(n_batches):
        y = rng.integers(0, len(LABELS), batch)
        f = 200.0 + 300.0 * y + rng.uniform(-20.0, 20.0, batch)
        sig = (np.sin(2 * np.pi * f[:, None] * t
                      + rng.uniform(0, 2 * np.pi, (batch, 1)))
               + 2.0 * rng.normal(0, 1, (batch, t.size)))
        sig = 0.5 * sig / np.abs(sig).max(axis=1, keepdims=True)
        out.append((sig.astype(np.float32), y.astype(np.int32)))
    return out


def new_wrapper(root, device, stft_method="pallas"):
    """ModelWrapper.from_config with the x-vector's weights drawn from SEED
    (on the CPU, so every device starts from the same weights)."""
    from lidbox_tpu_torch.models.model_utils import ModelWrapper
    wrapper = ModelWrapper.from_config(train_config(root, stft_method),
                                       device=device)
    wrapper.model.init(torch.Generator().manual_seed(SEED))
    return wrapper


def first_step_losses(root, device, stft_method, batches):
    """The losses of a fresh wrapper's first fused train steps, one per
    batch (make_fused_train_step, the step fit_fused runs)."""
    from lidbox_tpu_torch.data import on_device
    from lidbox_tpu_torch.train.loop import to_device
    wrapper = new_wrapper(root, device, stft_method)
    trainer = wrapper.trainer
    trainer.create_state()
    step = on_device.make_fused_train_step(
        trainer, on_device.feature_fn_from_config(
            RATE, wrapper.config["features"]))
    losses = []
    for signals, targets in batches:
        trainer.state, loss = step(
            trainer.state, to_device(signals, trainer.device),
            to_device(targets.astype(np.int64), trainer.device),
            trainer.generator)
        losses.append(loss)
    return [float(loss) for loss in losses]


def xvector_train_flops(batch, frames, n_mel=64, n_out=len(LABELS)):
    """Operations of one x-vector forward + backward (3x the forward's
    multiply-adds): causal frame convs 512/512/512/512/1500 at strides
    1/2/3/1/1, stats pooling, dense 3000->512->512->n_out."""
    t1 = frames
    t2 = -(-t1 // 2)
    t3 = -(-t2 // 3)
    macs = (5 * n_mel * 512 * t1 + 3 * 512 * 512 * t2 + 3 * 512 * 512 * t3
            + 512 * 512 * t3 + 512 * 1500 * t3
            + 3000 * 512 + 512 * 512 + 512 * n_out)
    return 3 * 2 * macs * batch


def phase_train(root, rng):
    """The training path: fit_fused of the full-width x-vector from
    waveform batches with stft_method "pallas". Returns the kernel's
    launch count over the fit, one training signal batch, and the
    wrapper."""
    from lidbox_tpu_torch.data import on_device
    from lidbox_tpu_torch.models.model_utils import experiment_cache_from_config
    from lidbox_tpu_torch.ops import logmel
    from lidbox_tpu_torch.train.loop import to_device

    train = class_sines(rng, TRAIN_BATCHES)
    val = class_sines(rng, VAL_BATCHES)
    print(f"training data: seed {SEED + 1}")
    wrapper = new_wrapper(root, "cuda")
    trainer = wrapper.trainer
    print(f"training: x-vector {wrapper.count_params()} parameters, "
          f"{TRAIN_EPOCHS} epochs of {TRAIN_BATCHES} batches of "
          f"[{TRAIN_BATCH}, {int(RATE * TRAIN_SECONDS)}], {VAL_BATCHES} "
          "validation batches, Adam 1e-3")
    step_losses = []
    train_step = trainer._train_step

    def recording(*args, **kw):
        state, loss = train_step(*args, **kw)
        step_losses.append(loss)
        return state, loss

    trainer._train_step = recording
    try:
        logmel.fused_logmel.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        history = wrapper.fit_fused(lambda: train, epochs=TRAIN_EPOCHS,
                                    val_signal_batches=lambda: val)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        launches = logmel.fused_logmel.launches
    finally:
        del trainer._train_step
    expected = TRAIN_EPOCHS * TRAIN_BATCHES + VAL_BATCHES
    check(launches == expected, f"training launched the log-Mel kernel "
                                f"{launches} times, not {expected}")
    losses = [h["loss"] for h in history]
    check(len(history) == TRAIN_EPOCHS, f"{len(history)} epochs trained")
    check(losses[-1] < losses[0], f"epoch loss did not fall: {losses}")
    for h in history:
        check(np.isfinite(h["val_loss"]) and np.isfinite(h["val_C_avg"]),
              f"validation not finite: {h}")
    print(f"training: fit_fused {TRAIN_EPOCHS} epochs in {t1 - t0:.2f} s "
          "(smoke figure), epoch loss "
          + ", ".join(f"{v:.4f}" for v in losses) + "; val_loss "
          + ", ".join(f"{h['val_loss']:.4f}" for h in history) + "; C_avg "
          + ", ".join(f"{h['val_C_avg']:.4f}" for h in history)
          + f"; kernel launches {launches} = {TRAIN_EPOCHS} x "
          f"{TRAIN_BATCHES} steps + {VAL_BATCHES} validation batches")

    ckpt_dir = os.path.join(experiment_cache_from_config(wrapper.config),
                            "checkpoints")
    names = sorted(os.listdir(ckpt_dir))
    check(len(names) == TRAIN_EPOCHS and all(CKPT_NAME.match(n)
                                             for n in names),
          f"checkpoints {names} are not the JAX package's name scheme")
    features = {k: v for k, v in wrapper.config["features"].items()
                if k != "on_device_augment"}
    feature_fn = on_device.feature_fn_from_config(RATE, features)
    val_features = [{"input": feature_fn(None, to_device(s, trainer.device)),
                     "target": to_device(y.astype(np.int64), trainer.device)}
                    for s, y in val]
    fresh = new_wrapper(root, "cuda")
    fresh.trainer.restore(os.path.join(ckpt_dir, names[-1]))
    ours = trainer.evaluate(val_features)
    restored = fresh.trainer.evaluate(val_features)
    check(restored == ours, f"restored checkpoint evaluates to {restored}, "
                            f"the trained state to {ours}")
    print(f"checkpoints {names}; {names[-1]} restored into a fresh Trainer: "
          f"val_loss {restored['val_loss']!r} == {ours['val_loss']!r}")

    main = [float(loss) for loss in step_losses[:3]]
    matmul = first_step_losses(root, "cuda", "matmul", train[:3])
    cpu = first_step_losses(root, "cpu", "pallas", train[:2])
    err_mm = max(abs(a - b) / abs(b) for a, b in zip(main, matmul))
    err_cpu = max(abs(a - b) / abs(b) for a, b in zip(main, cpu))
    check(err_mm <= TRAIN_RTOL and err_cpu <= TRAIN_RTOL,
          f"first step losses {main} vs matmul {matmul} (rel {err_mm}) vs "
          f"CPU {cpu} (rel {err_cpu}) beyond rtol {TRAIN_RTOL}")
    print(f"first step losses: kernel {main}, matmul path {matmul} (max rel "
          f"diff {err_mm:.3e}), CPU plain path {cpu} (max rel diff "
          f"{err_cpu:.3e}), rtol {TRAIN_RTOL}")
    return launches, train[0], wrapper


def phase_train_step_timing(wrapper, batch, kernel_ms, steps=30, warmup=5):
    """The steady fused train step at [32, 48000]: CUDA events around the
    features (the kernel), forward + backward, and the optimizer update of
    each step, the body of make_fused_train_step split at its parts."""
    from lidbox_tpu_torch.data import on_device
    from lidbox_tpu_torch.train.loop import to_device
    trainer = wrapper.trainer
    feature_fn = on_device.feature_fn_from_config(RATE,
                                                  wrapper.config["features"])
    x = to_device(batch[0], trainer.device)
    y = to_device(batch[1].astype(np.int64), trainer.device)
    state, gen = trainer.state, trainer.generator

    def step(state, events=None):
        if events:
            events[0].record()
        feats = feature_fn(gen, x)
        if events:
            events[1].record()
        loss, grads, bs = trainer._loss_and_grads(
            state, {"input": feats, "target": y}, gen)
        if events:
            events[2].record()
        state = trainer._apply_gradients(state, grads, bs)
        if events:
            events[3].record()
        return state

    for _ in range(warmup):
        state = step(state)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        state = step(state)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / steps * 1e3
    timed = [[torch.cuda.Event(enable_timing=True) for _ in range(4)]
             for _ in range(steps)]
    for events in timed:
        state = step(state, events)
    torch.cuda.synchronize()

    def median(i, j):
        return float(np.median([e[i].elapsed_time(e[j]) for e in timed]))

    # device busy time: the kernels' own time in a short profiled window
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            state = step(state)
        torch.cuda.synchronize()
    # the device's own events only: a CPU op's device time repeats its
    # kernels'
    kernels = [(getattr(e, "self_device_time_total",
                        getattr(e, "self_cuda_time_total", 0.0)) / 5e3, e.key)
               for e in prof.key_averages()
               if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    kernels = sorted((k for k in kernels if k[0] > 0), reverse=True)
    busy_ms = sum(ms for ms, _ in kernels)

    B, T = x.shape
    frames = 1 + (T - 400) // 160
    fb_flops = xvector_train_flops(B, frames)
    parts = {"step": median(0, 3), "features": median(0, 1),
             "forward_backward": median(1, 2), "optimizer": median(2, 3)}
    print(f"train step [{B}, {T}] ({frames} frames): median {parts['step']:.4f} "
          f"ms on the device (features {parts['features']:.4f}, forward + "
          f"backward {parts['forward_backward']:.4f}, optimizer "
          f"{parts['optimizer']:.4f}); host wall {wall_ms:.4f} ms/step over "
          f"{steps} steps; fused_logmel alone {kernel_ms:.4f} ms = "
          f"{kernel_ms / parts['step']:.1%} of the step; forward + backward "
          f"{fb_flops / 1e9:.1f} GFLOP, float32 CUDA-core bound "
          f"{fb_flops / PEAK_F32_FLOPS * 1e3:.4f} ms")
    if busy_ms:
        print(f"train step profile (torch.profiler, 5 steps): device busy "
              f"{busy_ms:.4f} ms/step, {1 - busy_ms / parts['step']:.1%} of "
              f"the step median idle; {len(kernels)} device ops, the top: "
              + "; ".join(f"{ms:.4f} ms {name[:60]}"
                          for ms, name in kernels[:6]))
    else:
        print("train step profile: torch.profiler saw no device time")
    return parts


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("TF32 off for matmuls and cuDNN convolutions")
    from lidbox_tpu_torch.ops import logmel

    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    logmel.build()
    print(f"build: {logmel.LIBRARY} in {time.perf_counter() - t0:.2f} s")
    for precision in ("highest", "bf16"):
        print(f"kernel variant {precision}: {logmel.kernel_variant(precision)}")

    rng = np.random.default_rng(SEED)
    geometry_err = phase_geometry(logmel, rng)
    with tempfile.TemporaryDirectory() as root:
        serve_launches, batches = phase_serve(root, rng)
        # the training data has its own stream: phases before it do not
        # shift its draw
        torch.backends.cudnn.deterministic = True
        try:
            train_launches, train_batch, wrapper = phase_train(
                root, np.random.default_rng(SEED + 1))
        finally:
            torch.backends.cudnn.deterministic = False
        train_x = torch.as_tensor(train_batch[0], device="cuda")
        path_err, timing = phase_path_kernel(logmel,
                                             batches + [(train_x, RATE)])
        phase_train_step_timing(
            wrapper, train_batch, timing[(*train_x.shape, "highest")][0])
    largest = max((k for k in timing if k[2] == "highest"),
                  key=lambda k: k[0] * k[1])
    ms, plain_ms, bound_ms, bound_by = timing[largest]
    print(f"kernel line: [{largest[0]}, {largest[1]}] highest; launches "
          f"{serve_launches} serving + {train_launches} training")

    print(json.dumps({"kernels": [{
        "name": "fused_logmel",
        "route": "cuda",
        "source": "lidbox_tpu_torch/csrc/logmel.cu",
        "replaces": "lidbox_tpu/ops/logmel.py:154",
        "launches": serve_launches + train_launches,
        "max_abs_err": max(geometry_err, path_err),
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

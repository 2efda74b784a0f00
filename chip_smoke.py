#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``lidbox_tpu_torch``) on one GPU.

Run from the repository root on a machine with an NVIDIA H100 (sm_90a):

    python3 chip_smoke.py

The launch counts are the kernels' own: each launch of ``logmel_kernel``
and ``logmel_reduce`` adds one to a counter on the card
(``logmel.launch_counts``), and each of ``tdnn_norm_forward`` and
``tdnn_norm_backward`` to one of its own (``tdnn_norm.launch_counts``),
eager or replayed from a CUDA graph. Where a
part below is "zeroed just before and read just after"
(``launch_window``), its prediction also counts the launches of the
capture warm-ups: ``graphs.WARMUP_STEPS`` for each fused step or log-Mel
feature program captured, tallied on the host as they launch. Phases 3,
6, 7, 8, 11, 12, 13, 16 and 17 predict their captures from the shapes
they feed, and fail unless the tally equals the warm-ups of those
captures.

Phases, each of which fails the run:

1. device and build: the card's name and power limit, then the fused
   log-Mel CUDA kernel built with nvcc from ``lidbox_tpu_torch/csrc``, and
   the instruction each precision mode runs, as the library reports it;
2. kernel vs plain on the geometry cases of the tests (odd lengths, mel
   ranges, 8 kHz, fft < frame length, 25/2 ms), on fft 2048 and 4096 (32
   and 64 bin passes), and at batch 1 and 3 (the bin passes split over
   blocks and added by the reduction kernel; a block's two frame tiles
   from two rows); then batch invariance: rows of [32, 48000] alone, in
   half the batch and in the whole batch give the same bits, split or not.
   The last three on a random stream of their own;
3. serving, the main path: a full-width x-vector (random weights from a
   seed) behind ``serve.Classifier`` with ``stft_method: "pallas"``
   classifies 32 whole 3 s wavs and the same wavs in 2 s / 1 s chunks, and
   ``StreamingClassifier`` scores one of them online, each a CUDA graph
   replay per shape (``graphs.ForwardProgram``). The launch count is
   zeroed just before and read just after (one launch per signal batch
   and the capture warm-ups), and every signal batch the feature
   programs hand on is kept. Scores must match the matmul feature path
   on the card and the plain CPU path, and streaming must match the
   offline chunked scores;
4. training, the second main path: ``ModelWrapper.from_config`` builds the
   full-width x-vector (weights from the seed), Adam 1e-3, the NLL loss, a
   C_avg metric, ``ModelCheckpoint`` and ``EarlyStopping``, and
   ``fit_fused`` trains it with ``stft_method: "pallas"`` for 3 epochs of 8
   batches of 32 class-separable 3 s noisy sines, validating on 2 batches.
   The launch count is zeroed just before and read just after: one launch
   per train step and per validation batch (3 x 8 + 2) and the warm-ups. The epoch loss
   must fall, val_loss and C_avg be finite, the checkpoints carry the JAX
   package's names, and the last one, restored into a fresh Trainer,
   must evaluate exactly as the trained state does. Every step is one CUDA
   graph replay (``train/graphs.py``); the same fit with the eager
   functional steps (``fit_signals(..., eager=True)``) must give the same
   step losses, epoch logs and final state bit for bit. The first 3 step
   losses must match a run with ``stft_method: "matmul"`` on the card and
   the first 2 those of a run on the CPU (the plain version), within rtol
   1e-3. cuDNN runs its deterministic algorithms in this phase;
5. augmented training, the third main path: ``fit_fused`` of the same
   x-vector through the whole on-device chain (energy VAD, speed change
   [0.9, 1.1], noise from a bank of 4 x 10 s wavs at SNR [5, 20] dB, FIR
   of 10 taps, the kernel, SpecAugment 2 + 2 masks; augment_prob 0.5) with
   ``feed {stage_dtype: int16, steps_per_dispatch: 2, cache_staged: true,
   cache_shuffle: rows}``, 3 epochs of 8 batches of 3 s sines with a
   0.35-0.8 s pause per row (a stream of its own, seed 1236) and 2 clean
   validation batches. The launch count is zeroed just before and read
   just after (3 x 8 + 2: replayed epochs featurize every step, each step
   one CUDA graph replay); the epoch loss must fall, validation be finite,
   epochs 2-3 transfer no signals (they replay the cache), the eager
   functional steps give the same losses, logs and state bit for bit, and
   the first 4 step losses equal, bit for bit, those of a run with one
   step per dispatch. The kernel is held to its plain version on the first
   augmented batch of each epoch (kept from the eager run);
6. the config-driven pipeline, the fourth main path: the configuration of
   docs/config.md (filters, RMS VAD, repeat, additive noise from a
   synthetic MUSAN-style directory and random resampling for the train
   split, 2 s chunks, log-Mel 64 bins over 20-7000 Hz, window
   normalization, ``group_by_input_length`` at 64, ``stft_method:
   "pallas"``, CMVN, shuffle) on 100 train / 20 test noisy-sine wavs of 3-5
   s, compiled by ``pipelines.create_dataset`` and run by
   ``from_steps(steps, device="cuda")``; ``ModelWrapper.fit`` trains the
   full-width x-vector on it for 3 epochs and ``steps.extract_embeddings``
   embeds the test split from the best checkpoint. The launch count is
   zeroed just before and read just after each: one launch per group per
   pass, the groups counted from the host steps alone. The kernel is held
   to its plain version on the full and the remainder groups the pipeline
   handed it; the test split and the first train groups equal those of the
   same pipeline with ``device="cpu"`` (ids, targets, order, shapes; inputs
   within PIPE_ATOL + PIPE_RTOL); the loss must fall, the checkpoints carry
   the JAX names, and one batch of embeddings equals the restored
   extractor's bit for bit. Prints elements/s through the pipeline and the
   kernel's times at [64, 32000] with this mel geometry;
7. the command line, the fifth main path: ``python -m lidbox_tpu_torch``
   driven in-process through ``cli.main`` on phase 6's corpus and
   configuration with a ``metadata`` CSV: ``utils --validate-config``,
   ``train`` for 2 epochs and ``train --resume`` to 3, ``evaluate``,
   ``extract-embeddings`` of both splits, the numpy back-end (scaler,
   PLDA, GaussianNB, report) on those embeddings, ``classify`` of 8 test
   wavs whole and in 2 s chunks, and ``export --torch-export``. The launch
   count is zeroed just before and read just after each command: phase
   6's groups per pass for train, evaluate and extraction. The epochs
   number 1, 2, 3 with a falling loss and the JAX checkpoint names; the
   report equals ``util.evaluate_testset_with_model`` on the CPU
   (predictions within PIPE_ATOL + PIPE_RTOL, confusion matrix and
   supports equal); the test embeddings equal ``steps.extract_embeddings``
   bit for bit; the back-end gives equal results twice; the CSV equals
   ``serve.Classifier``; the exported model and program reproduce the
   live model at batch 1, 2 and 32 (atol 1e-5 + rtol 1e-5). The kernel
   is held to its plain version on the groups the commands handed it;
8. the model zoo: the 13 registry keys besides the x-vector at their
   published widths, plus clstm with ``use_conv2d`` and with
   ``use_attention`` + ``use_lstm`` and convnet_extractor's MobileNetV2
   trunk (16 configurations, weights from the seed). Each trains through
   ``ModelWrapper.from_config(config, device="cuda").fit_fused`` for 2
   steps and 1 validation batch of [32, 48000] (a stream of its own, seed
   1238) with the launch count zeroed just before and read just after
   (one launch per step and per validation batch), a finite loss and
   every BatchNorm running statistic moved; its first step's loss is
   held to the CPU's from the same weights and batch (rtol 1e-3; in eval
   mode for clstm and multilevel_attention, whose noise and dropout draw
   from the device's generator), then ``serve.Classifier`` scores 4 wavs
   (``score_fn`` for ap_lstm: AngularProximity's -theta) within 1e-3 of
   the CPU's with one launch. The kernel is held to its plain version on
   a zoo batch; each configuration prints its parameters, forward and
   train-step ms on CUDA events and device busy ms under torch.profiler
   at [32, 298, 64], the train step eager (``_train_step``) and graphed
   (``_fit_step``, a CUDA graph replay);
9. kernel vs plain at the main paths' shapes: ``fused_logmel`` against
   ``logmel_plain`` on the very batches kept in phase 3 (bucketed: a 3 s
   batch is padded to the 4 s bucket) and on a training batch, [32, 48000]
   (fixed-length crops, no bucket); kernel, plain and bound times per
   shape, the largest one in the kernel table (its device time under
   torch.profiler after a warm-up step, with the launches the profiler
   saw, beside a window without the warm-up step). The bound of "highest" is
   its 3xTF32 tensor-core work (3 products at 495 TFLOP/s), with the
   float32 CUDA-core bound printed beside it; ``dft_gemm_ms`` is one cuBLAS
   product of the unfolded frames by the DFT basis (float32, and bfloat16
   for "bf16"), a yardstick for the bulk of the work. Each shape also
   prints the kernel's launch plan (blocks, the SMs they occupy, split
   count, the share of computed frames that is padding, the basis bytes
   its blocks read from L2 and the implied L2 rate), its time as a CUDA
   graph of 20 launches and its device time under torch.profiler. The
   split reduction kernel is held to its plain version and timed at the
   serving path's split shapes;
10. the steady train step at [32, 48000]: the median of 30 steps on CUDA
   events, split into features, forward + backward and optimizer, beside
   the kernel's time at that shape and its share of the step, and the
   device's busy time over 5 steps under ``torch.profiler`` with the
   kernel's own device time inside the step; then the
   augmented step the same way, split at each stage of the chain; then
   each whole step (int16 packed for the augmented one) eager and graphed
   in turns (eager, graphed, graphed, eager): median on CUDA events, host
   wall and device busy ms, so the idle share of each form can be read;
11. data parallelism (``lidbox_tpu_torch.parallel``): the full-width
   x-vector and crnn through ``ModelWrapper.from_config(..., mesh=)
   .fit_fused``, 3 steps of [32, 48000] and 1 validation batch (a stream
   of its own, seed 1239). (a) In this process, mesh-less and on a 1-rank
   NCCL mesh (``parallel.get_mesh()``, captured like the mesh-less
   step): the x-vector's step losses and validation must be equal;
   the NCCL all-reduce of the 18 MB gradient bucket and the step with and
   without the mesh are timed. (b) Two ranks
   of this script (``--dp-rank``) share the card over gloo (NCCL refuses
   one card twice: a probe pair prints its refusal), each feeding its
   [16, 48000] rows: their step losses within rtol 1e-3 of (a)'s
   mesh-less run, parameters and batch statistics bit-equal across ranks,
   one kernel launch per step and validation batch on each rank, each
   rank's batch held to the plain version, ``Classifier(mesh=)`` within
   SERVE_ATOL of the mesh-less scores, the gloo all-reduce, the feed
   guard and the step timed; (c) an uneven feed raises on both ranks. A
   rank that fails, or outlives its time limit, fails the run;
12. tensor parallelism (``parallel.get_mesh_2d`` +
   ``parallel.column_parallel_rule``): the full-width x-vector through
   ``fit_fused`` (Adam 1e-4), 3 steps of [32, 48000] and 1 validation
   batch (a stream of its own, seed 1240). (a) In this process: mesh-less
   and on a 1 x 1 NCCL mesh with the rule, step losses and validation
   equal; one process on signals one ulp away, the comparison's floor;
   ``remat`` with channel dropout 0.5 against the plain step (rtol 1e-6);
   the 1 x 1 mesh and remat captured;
   the ``bf16_3x`` / ``bf16_6x`` log-Mel of a training batch against
   float64 (the JAX package's 1.5e-3 budget), timed, and their pallas
   request on the matmul path. (b) Two ranks of this script
   (``--tp-rank``) share the card over gloo as data 1 x model 2, each on
   the whole batch: step losses and validation within rtol 1e-3 of (a)'s
   mesh-less run, synced weights and features bit-equal across the
   ranks, half of each split weight on a rank, one kernel launch per step
   and validation batch on each rank, each rank's batch held to the plain
   version; the step, and in one instrumented step the model group's
   gathers and all-reduces with their bytes, timed. A rank that fails,
   or outlives its time limit, fails the run;
13. Orbax checkpoints and deployment: whether zstandard, orbax and
   tensorstore import (none does on the card's machine) and the zstd
   decoder's build (``native/zstd.cpp``); the full-width x-vector through
   ``fit_fused`` for 2 epochs of 4 batches of [32, 48000] and 1
   validation batch (a stream of its own, seed 1241) with
   ``ModelCheckpoint(backend="orbax")``: the directories carry the msgpack
   backend's names, the best restores bit-equal to the live state of its
   epoch (step, params, batch stats, Adam moments), and one epoch resumed
   from the last equals the live trainer's next epoch bit for bit; the
   write (save to wait), its bytes and the read timed on the host clock;
   the committed JAX checkpoint (``tests/data/orbax_jax_xvector_small``,
   OCDBT + zstd, written by the JAX package) restored bit-equal to its
   msgpack copy and served (4 wavs, ``serve.Classifier`` on the kernel,
   within SERVE_ATOL of the CPU), the decoder's MB/s; ``export --platforms
   cuda,cpu`` through ``cli.main``, the program loaded on each device
   within atol 1e-5 + rtol 1e-5 of the live model there at batch 1, 2 and
   32. The launch count, zeroed before each driven part and read after,
   must equal the prediction (ORBAX_LAUNCHES). cuDNN runs its
   deterministic algorithms here;
14. the one-program train step (``train/graphs.py``), after phase 10: one
   generator registered with a CUDA graph and re-seeded before each
   replay draws what ``keyed_generator`` draws; every optimizer of
   ``optimizer_from_config`` (with and without a schedule) updates alike
   with its per-step scalars in device buffers and as the host's floats;
   xvector_2d and clstm's conv2d variant (BatchNorm; clstm also noise and
   dropout) through ``fit_fused`` 2 epochs of 4 batches of [32, 48000] with
   grouped dispatch and the rows replay and 1 validation batch (a stream
   of its own, seed 1242), graphed (the launch count zeroed just before
   and read just after: 9 each and the warm-ups) and eager, bit for bit;
   3 replays of the clean and the augmented step under
   ``set_sync_debug_mode("error")`` (deterministic cuDNN), then one
   replay after the kernel's caches dropped the tiles the graph reads,
   against the eager step, bit for bit;
   the eager and graphed times of phases 10 and 8;
15. the kernel table as one JSON line (after phase 6's [64, 32000] kernel
   line again), the card line, and the result line.
16. the one-program served path (``graphs.ForwardProgram``), right after
   phase 4 under deterministic cuDNN: the full-width x-vector (weights
   from the seed) behind ``Classifier`` on 32 whole 3 s wavs and on 2 s
   chunks and behind ``StreamingClassifier`` (a stream of its own, seed
   1244), graphed and with ``eager=True``: scores bit for bit, the stream
   within STREAM_ATOL of the offline chunks, the launches of each part
   (zeroed just before, read just after) equal to a prediction printed
   first, warm-ups included, and the kernel held to its plain version on
   the batches the captured programs handed it; phase 4's
   ``Trainer.evaluate`` graphed and eager bit for bit; a weight changed
   in place served by the next replay, a replaced one captured anew; the
   served forward [32, 298, 64], a stream chunk [1, 32000], features +
   forward of 32 decoded 3 s signals and ``evaluate`` timed eager and
   graphed in turns on CUDA events, the host clock and torch.profiler.
17. the masked recurrent, remat and one-rank-mesh steps, captured, last and
   under deterministic cuDNN (a stream of its own, seed 1245): (a) lstm,
   bi_gru, crnn and ap_lstm at their published widths through
   ``fit_fused`` with ``stft_method: "pallas"`` on phase 5's
   length-tracking chain (energy VAD and speed change [0.9, 1.1], so every
   batch carries a frame mask), 4 steps of [32, 48000] and 1 validation
   batch, graphed and eager: step losses, epoch logs and final state bit
   for bit, the launches of each fit (zeroed just before, read just after)
   equal to the prediction printed first (a step and a validation batch
   each, and one capture's warm-ups); 3 replays under
   ``set_sync_debug_mode("error")``; the first step's loss against the
   CPU's on the same weights and draws (rtol 1e-3); each masked step timed
   eager and graphed in turns (CUDA events, torch.profiler's busy time and
   idle share); crnn and bi_gru behind ``serve.Classifier`` on 8 ragged
   wavs of 2-4 s (one masked batch), graphed == eager bit for bit and
   within SERVE_ATOL of the CPU; the kernel held to its plain version on
   the first masked batch. (b) The full-width x-vector with channel
   dropout 0.5 and ``remat``, 4 steps: graphed == eager bit for bit,
   within rtol 1e-6 of the plain step, the step timed and the peak device
   memory of each fit with and without remat. (c) The x-vector mesh-less,
   on ``parallel.get_mesh()`` (NCCL, one rank) and on a 1 x 1
   ``get_mesh_2d`` with ``column_parallel_rule``, all three captured:
   step losses and validation bit for bit, the step timed. Then served on
   the 1-rank mesh (``one_rank_serving``): the batch predict fn on [32,
   298, 64] and on 8 ragged rows with a frame mask, one capture a
   signature, graphed == eager bit for bit, == mesh-less bit for bit at
   the full batch and within rtol 1e-5 at the partial one; a
   ``serve.Classifier(mesh=)`` pass over phase 3's wavs == mesh-less; a
   ``StreamingClassifier(mesh=)`` of 8 chunks through the fused "stream"
   program alone == the mesh-less stream bit for bit; the launches of
   each part as predicted; each form timed in turns with the mesh-less
   graph (CUDA events, idle share).
18. ECAPA's TDNN tail (``ops/tdnn_norm.py``), after phase 17 (alone:
   ``python3 chip_smoke.py --tdnn-norm``): at [32, C, 298] for C = 128,
   1024, 3072 (VAD-like lengths, one row empty) ``tdnn_norm.tdnn_norm``
   (the ``TdnnNorm`` function ``TDNN`` calls) forward and autograd's
   backward within 1e-4 of the plain form in float64 (relative to each
   output's largest magnitude), the empty row zero, the launch counts
   zeroed just before and read just after one of each; then each kernel
   timed from a CUDA graph beside the composed tail and the bound of its
   passes. Then ``fit_fused`` of the full-width ECAPA-TDNN with the energy
   VAD, 4 steps, each a CUDA graph replay, under torch.profiler: the
   kernels' launches, zeroed just before and read just after, equal the
   ``norm_fused`` counts that the ``lidbox.graph.*`` spans carry (those
   the benchmark's ``fused_norm_share`` reads) for the warm-up steps and
   the replays, forward and backward alike, and no span counts
   ``norm_composed``; against the same fit with the composed tail, the
   first step's loss within 5e-6 and its gradient's norm per parameter
   within 6e-3 (the cell's limits against its float64 reference).

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
import collections
import contextlib
import copy
import functools
import json
import os
import re
import subprocess
import sys
import tempfile
import time
import weakref

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
# The config-driven pipeline: 100 train / 20 test wavs, groups of at most
# 64 chunks of 2 s (198 frames) for the kernel, 64 mel bins over 20-7000 Hz.
PIPE_TRAIN, PIPE_TEST, PIPE_GROUP, PIPE_FRAMES = 100, 20, 64, 198
PIPE_KW = {"num_mel_bins": 64, "fmin": 20.0, "fmax": 7000.0}
# Card vs CPU pipeline inputs, after window normalization (CMVN over the
# 198 frames: fewer than its 300-frame window) and the CMVN of
# post_process: the log-Mel's float32 budget (1e-4 + 1e-4 |x|, |x| up to
# ~15 at the quietest bins) divided by each bin's standard deviation over
# the chunk, itself computed from the two log-Mels.
PIPE_ATOL = PIPE_RTOL = 1e-3
# ECAPA's TDNN tail (phase 18): its widths at [32, C, 298], VAD-like valid
# lengths (216-276 frames) and one row empty. The kernels against the plain
# form in float64: each output within TDNN_TOL of its largest magnitude.
TDNN_WIDTHS = (128, 1024, 3072)
TDNN_LENGTHS = [0] + [216 + (37 * i) % 61 for i in range(1, 32)]
TDNN_TOL = 1e-4
# the training-mode TDNNs of one ECAPA-TDNN forward (block 0; per
# SE-Res2Net block tdnn1, 7 Res2Net chunks and tdnn2; MFA; the pooling's
# attention) and the steps of phase 18's fit
ECAPA_TDNNS = 1 + 3 * (1 + 7 + 1) + 1 + 1
TDNN_FIT_BATCHES = 4
# phase 18's fit against the same fit with the composed tail: the first
# step's relative loss gap and the worst parameter's gap of the first
# gradient's norm (over the larger of its norm and the median parameter's),
# held to the limits of ecapa_tdnn.train-vad against its float64 reference
# (port_bench/limits). Later steps are not compared: Adam's first steps
# turn rounding into updates of +-lr on parameters with near-zero
# gradients, so two float32 fits drift apart by percents within 4 steps.
TDNN_FIT_LOSS_TOL, TDNN_FIT_GRAD_TOL = 5e-6, 6e-3
# the spans of a program's runs, which carry what the run counted
GRAPH_RUNS = ("lidbox.graph.replay", "lidbox.graph.capture",
              "lidbox.graph.eager")


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


def graph_ms(fn, n=20, reps=5):
    """Median time of one call of ``fn`` replayed as a CUDA graph of ``n``
    calls: the device's time without the host's launch overhead."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    return float(np.median(times))


def kernel_device_ms(kernels, name):
    """Device ms per call of the device ops whose name holds ``name``, from
    ``device_ops``; None when the profiler saw none."""
    found = [ms for ms, key in kernels if name in key]
    return sum(found) if found else None


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


def dft_gemm_ms(logmel, x, rate, kw, dtype=torch.float32):
    """Yardstick for the bulk of the work: one cuBLAS product of the unfolded
    frames [B * frames, L] by W [L, 2 * NB] in ``dtype`` (float32 with TF32
    off, or bfloat16). Not a call the port makes, and not the whole
    function."""
    fl, fs, L, _, W, _ = geometry(logmel, rate, kw)
    frames = x.unfold(1, fl, fs)[..., :L].reshape(-1, L).to(dtype).contiguous()
    W = torch.as_tensor(W, device=x.device).to(dtype).contiguous()
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
    # the split passes (batch 1: 4 tiles, 16 blocks) and tile pairs across
    # rows (batch 3: 4 tiles a row); a stream of their own, so the served
    # data below is the draw it always was
    own = np.random.default_rng(SEED + 8)
    for name, batch in (("batch1_2s", 1), ("batch3_2s", 3)):
        x = torch.as_tensor(noisy_sines(own, batch, 2.0, RATE), device="cuda")
        plan, _ = logmel.launch_plan(batch, x.shape[1], RATE)
        check(plan["splits"] > 1, f"{name}: the plan does not split")
        with launch_window() as counted:
            worst = max(worst, compare(logmel, name, x, RATE, {}))
        check(counted["logmel_reduce"] == 2,
              f"{name}: the split reduction ran "
              f"{counted['logmel_reduce']} times, not 2")
    # a row's log-Mel does not depend on its batch: [32, 48000] runs
    # unsplit, its first 16 rows split in 3, row 5 alone split in 8
    x = torch.as_tensor(noisy_sines(own, 32, 3.0, RATE), device="cuda")
    for precision in ("highest", "bf16"):
        whole = logmel.fused_logmel(x, RATE, precision=precision)
        splits = [logmel.launch_plan(*x.shape, RATE, precision=precision)[0]
                  ["splits"]]
        for rows in (slice(0, 16), slice(5, 6)):
            part = logmel.fused_logmel(x[rows].contiguous(), RATE,
                                       precision=precision)
            splits.append(logmel.launch_plan(*x[rows].shape, RATE,
                                             precision=precision)[0]["splits"])
            check(torch.equal(part, whole[rows]),
                  f"{precision}: rows {rows} alone differ from the same rows "
                  f"in the batch by {(part - whole[rows]).abs().max().item()}")
        print(f"batch invariance {precision}: [32, 48000] (splits "
              f"{splits[0]}), its rows 0-15 (splits {splits[1]}) and row 5 "
              f"alone (splits {splits[2]}) bit-equal")
    return worst


def phase_path_kernel(logmel, batches):
    """The kernel on the signal batches the main paths handed it: each one
    compared with the plain version, each shape timed (back to back on CUDA
    events, as a CUDA graph, and its device time under torch.profiler) with
    its launch plan. Returns the worst float32 error and {(B, T,
    precision): (ms, plain_ms, bound_ms, bound_by)}."""
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
            gemm = (f", dft_gemm_ms {dft_gemm_ms(logmel, x, rate, KERNEL_KW):.4f} "
                    f"(bf16 {dft_gemm_ms(logmel, x, rate, KERNEL_KW, torch.bfloat16):.4f})"
                    if B > 1 else "")
            print(f"fused_logmel [{B}, {T}]: {flops / 1e9:.3f} GFLOP, "
                  f"{nbytes / 1e6:.2f} MB; float32 CUDA-core bound "
                  f"{cores_ms:.4f} ms{gemm}")
            for precision in ("highest", "bf16"):
                kw = dict(KERNEL_KW, precision=precision)
                run = lambda: logmel.fused_logmel(x, rate, **kw)
                ms = cuda_ms(run)
                plain_ms = cuda_ms(lambda: logmel.logmel_plain(x, rate, **kw))
                g_ms = graph_ms(run)
                run()
                torch.cuda.synchronize()
                seen = {}
                ops = device_ops(run, calls=10, counts=seen)
                # the mean over the launches the profiler recorded: it
                # may drop some, and the sum over 10 calls then reads low
                n_seen, dev = kernel_launches_seen(seen, "logmel_kernel")
                red = kernel_launches_seen(seen, "logmel_reduce")[1]
                per_call = kernel_device_ms(ops, "logmel_kernel")
                check(dev is None or 0 < n_seen <= 10,
                      f"fused_logmel [{B}, {T}] {precision}: the profiler "
                      f"saw {n_seen} launches of 10")
                bound_ms, bound_by = logmel_bound(logmel, B, T, rate,
                                                  precision, KERNEL_KW)
                timing[(B, T, precision)] = (ms, plain_ms, bound_ms, bound_by)
                plan, st = logmel.launch_plan(B, T, rate, **kw)
                cores = (f"; {cores_ms / ms:.1%} of the float32 CUDA-core "
                         f"bound" if precision == "highest" else "")
                l2 = (f", {st['basis_bytes'] / dev / 1e9:.2f} TB/s from L2"
                      if dev else "")
                print(f"fused_logmel [{B}, {T}] 64 mel precision={precision}: "
                      f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                      f"{bound_ms:.4f} ms ({bound_by}), {bound_ms / ms:.1%} "
                      f"of bound{cores}; CUDA graph {g_ms:.4f} ms; device "
                      f"{dev if dev is None else f'{dev:.4f}'} ms a launch "
                      f"(torch.profiler recorded {n_seen} of 10; their sum "
                      f"over 10 reads {per_call})"
                      + (f" + reduction {red:.4f} ms" if red else "")
                      + f"; plan: {st['blocks']} blocks on {st['sms_used']} "
                      f"SMs, {plan['nwg']} x 64-frame tiles a block, "
                      f"{plan['splits']} split(s) of {plan['passes']} bin "
                      f"passes, {st['padded_frames']:.1%} of computed frames "
                      f"padding, basis + mel {st['basis_bytes'] / 1e6:.1f} MB "
                      f"from L2{l2}")
    return worst, timing


def phase_split_reduce(logmel, batches):
    """The split reduction kernel against its plain version at the split
    shapes of the serving path ([slices, B, frames, 64] partial mel sums,
    positive, from a stream of their own), timed. Returns the kernels-line
    fields: max_abs_err, ms, plain_ms, bound_ms, bound_by."""
    rng = np.random.default_rng(SEED + 9)
    plans = [logmel.launch_plan(*x.shape, rate)[0] for x, rate in batches]
    shapes = sorted({(logmel.partial_slices(p), p["B"], p["F"])
                     for p in plans if p["splits"] > 1})
    check(shapes, "no split shape on the serving path")
    worst, fields = 0.0, None
    for S, B, F in shapes:
        part = torch.as_tensor(rng.uniform(0.0, 4.0, (S, B, F, 64)).astype(
            np.float32), device="cuda")
        with launch_window() as counted:
            out = logmel.split_reduce(part)
        ref = logmel.split_reduce_plain(part)
        torch.cuda.synchronize()
        check(counted["logmel_reduce"] == 1,
              f"split_reduce's kernel counted {counted['logmel_reduce']} "
              "launches, not 1")
        err = (out - ref).abs().max().item()
        check(err <= 1e-6, f"split reduction [{S}, {B}, {F}, 64]: max abs "
                           f"error {err} beyond 1e-6 of its plain version")
        worst = max(worst, err)
        ms = cuda_ms(lambda: logmel.split_reduce(part))
        plain_ms = cuda_ms(lambda: logmel.split_reduce_plain(part))
        n = B * F * 64
        bound_ms, bound_by = bound(n * S, 4 * (S + 1) * n, PEAK_F32_FLOPS)
        print(f"split reduction [{S}, {B}, {F}, 64]: max abs err {err:.3e} "
              f"(tolerance 1e-6: the same additions in the same order, logf "
              f"against torch.log); kernel {ms:.4f} ms, plain {plain_ms:.4f} "
              f"ms, bound {bound_ms:.4f} ms ({bound_by})")
        if fields is None or n * S > fields[-1]:
            fields = (ms, plain_ms, bound_ms, bound_by, n * S)
    return (worst,) + fields[:4]


def write_wavs(io, root, rng, n, seconds):
    paths = []
    for i, sig in enumerate(noisy_sines(rng, n, seconds, RATE)):
        p = os.path.join(root, f"utt{i:03d}.wav")
        io.write_mono_wav(p, sig, RATE)
        paths.append(p)
    return paths


def keep_served_batches():
    """Keep every signal batch the feature programs hand the kernel: the
    extractor's (``DeviceFeatureExtractor.extract``) and the streaming
    chunk program's (``StreamingClassifier._score_chunk``), each copied to
    the card before its call. Returns (the list of (signals, rate) it
    fills, a function that undoes it)."""
    from lidbox_tpu_torch import serve
    from lidbox_tpu_torch.data.device_pipeline import DeviceFeatureExtractor
    batches = []
    extract = DeviceFeatureExtractor.extract
    score_chunk = serve.StreamingClassifier._score_chunk

    def keeping(self, signals, sample_rate, **kw):
        batches.append((signals.to("cuda", copy=True), int(sample_rate)))
        return extract(self, signals, sample_rate, **kw)

    def keeping_chunk(self, chunk):
        batches.append((torch.as_tensor(chunk[None, :], device="cuda"),
                        self.sample_rate))
        return score_chunk(self, chunk)

    def restore():
        DeviceFeatureExtractor.extract = extract
        serve.StreamingClassifier._score_chunk = score_chunk

    DeviceFeatureExtractor.extract = keeping
    serve.StreamingClassifier._score_chunk = keeping_chunk
    return batches, restore


def phase_serve(root, rng):
    """Drives the main path; returns the kernel's launch count over it and
    the signal batches the feature extractor handed on."""
    from lidbox_tpu_torch import models, serve
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

    # one feature program for each new shape (the whole wavs' and the
    # chunks'), and the stream's chunk program
    captures = [served_shape(n, 3 * RATE), (n, 2 * RATE), (1, 2 * RATE)]
    batches, restore = keep_served_batches()
    try:
        with launch_window(captures=captures) as counted:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = whole.classify(paths, ids=ids)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out_chunked = chunked.classify(paths, ids=ids)
            for block in np.array_split(signal, [1234, 20000, 20333]):
                stream.feed(block)
            torch.cuda.synchronize()
        launches = counted["logmel_kernel"]
        reductions = counted["logmel_reduce"]
    finally:
        restore()

    check(launches > 0, "serving never launched the log-Mel kernel")
    check(launches == len(batches) + counted["warmup"],
          f"{launches} kernel launches for {len(batches)} feature batches "
          f"and {counted['warmup']} capture warm-up launches")
    split = sum(logmel.launch_plan(*x.shape, rate)[0]["splits"] > 1
                for x, rate in batches)
    check(reductions > 0 and reductions == split + counted["warmup_reduce"],
          f"serving ran the split reduction {reductions} times, not once for "
          f"each of the {split} split batches and "
          f"{counted['warmup_reduce']} warm-up launches")
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
          f"({n / (t1 - t0):.1f} utt/s with the captures, smoke figure, not "
          f"a benchmark); kernel launches over whole + chunked + streaming: "
          f"{launches} ({counted['warmup']} of them capture warm-ups), split "
          f"reductions {reductions} ({counted['warmup_reduce']} warm-ups), "
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
    return launches, reductions, batches


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
    recorded = []
    with recording_losses(recorded), launch_window() as counted:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        history = wrapper.fit_fused(lambda: train, epochs=TRAIN_EPOCHS,
                                    val_signal_batches=lambda: val)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
    launches, warmup = counted["logmel_kernel"], counted["warmup"]
    step_losses = step_losses_of(recorded)
    expected = TRAIN_EPOCHS * TRAIN_BATCHES + VAL_BATCHES + warmup
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
          f"{TRAIN_BATCHES} steps + {VAL_BATCHES} validation batches + "
          f"{warmup} capture warm-up steps")

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

    # the graphed run against the eager (functional) steps, from the seed
    eager = new_wrapper(os.path.join(root, "eager"), "cuda")
    eager_recorded = []
    with recording_losses(eager_recorded), eager_steps():
        eager_history = eager.fit_fused(lambda: train, epochs=TRAIN_EPOCHS,
                                        val_signal_batches=lambda: val)
    n = check_same_run((step_losses, history, trainer),
                       (step_losses_of(eager_recorded), eager_history,
                        eager.trainer), "training")
    print(f"training graphed == eager, bit for bit: {len(step_losses)} step "
          f"losses, {TRAIN_EPOCHS} epochs' logs, {n} state tensors")

    main = step_losses[:3]
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
    return launches, train[0], wrapper, val_features


def device_ops(run, calls=5, counts=None):
    """(ms per call, name) of each device op of ``calls`` calls of ``run``
    under torch.profiler, largest first: the device's own events only (a
    CPU op's device time repeats its kernels'). ``counts`` (a dict)
    receives each op's (events recorded, device ms in all): the profiler
    may drop launches from a window, which a mean per call hides."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            run()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None)
              == torch.autograd.DeviceType.CUDA]
    totals = [getattr(e, "self_device_time_total",
                      getattr(e, "self_cuda_time_total", 0.0)) / 1e3
              for e in events]
    if counts is not None:
        counts.update((e.key, (e.count, ms)) for e, ms in zip(events, totals))
    return sorted(((ms / calls, e.key) for e, ms in zip(events, totals)
                   if ms > 0), reverse=True)


def capture_warmups(captures):
    """(logmel_kernel, logmel_reduce) launches that the capture warm-ups of
    one program for each entry of ``captures`` make: ``graphs.WARMUP_STEPS``
    each, and as many of the reduction where the kernel's launch at that
    shape splits. An entry is the [B, T] signal shape a program
    featurizes at RATE, or (B, T, the kernel's keyword arguments), by
    default KERNEL_KW."""
    from lidbox_tpu_torch.ops import logmel
    from lidbox_tpu_torch.train import graphs
    split = 0
    for entry in captures:
        b, t, kw = (*entry, KERNEL_KW)[:3]
        split += logmel.launch_plan(b, t, RATE, **kw)[0]["splits"] > 1
    return graphs.WARMUP_STEPS * len(captures), graphs.WARMUP_STEPS * split


@contextlib.contextmanager
def launch_window(device="cuda", captures=None):
    """Counts the kernels' launches on ``device`` within the block. Yields a
    dict that holds after it "logmel_kernel" and "logmel_reduce", the
    counts the launches keep on the card (``logmel.launch_counts``, zeroed
    before the block: eager launches and launches replayed from a CUDA
    graph alike), and "warmup" and "warmup_reduce", the launches of each
    that the capture warm-ups within it made (``graphs.WARMUP_STEPS`` for
    each fused step or log-Mel feature program captured: each warm-up step
    featurizes its batch once), which the predictions add. The host
    tallies them as they launch (``graphs.warmup_launches``).
    ``captures``: the programs predicted to be captured within the block,
    one entry of ``capture_warmups`` each; on the card the block then
    fails unless the tally equals their warm-ups."""
    from lidbox_tpu_torch.ops import logmel
    from lidbox_tpu_torch.train import graphs
    counts = {}
    before = dict(graphs.warmup_launches)
    logmel.reset_launch_counts(device)
    yield counts
    counts.update(logmel.launch_counts(device))
    tally = tuple(graphs.warmup_launches[name] - before.get(name, 0)
                  for name in ("logmel_kernel", "logmel_reduce"))
    if captures is not None and torch.device(device).type == "cuda":
        predicted = capture_warmups(captures)
        check(tally == predicted,
              f"capture warm-ups launched (logmel_kernel, logmel_reduce) "
              f"{tally}, predicted {predicted} for one capture of each of "
              f"{list(captures)}")
    counts["warmup"], counts["warmup_reduce"] = tally


def served_shape(n, samples):
    """The [B, T] signal batch the feature extractor hands the kernel for
    ``n`` signals of ``samples`` samples: both padded to the extractor's
    default buckets."""
    from lidbox_tpu_torch.data.dataset import pick_bucket
    from lidbox_tpu_torch.data.device_pipeline import (
        DEFAULT_BATCH_BUCKETS, DEFAULT_SIGNAL_BUCKETS)
    return (pick_bucket(n, DEFAULT_BATCH_BUCKETS),
            pick_bucket(samples, DEFAULT_SIGNAL_BUCKETS))


def group_shapes(elements, samples):
    """The ``capture_warmups`` entries of the distinct [B, T] shapes of
    ``group_by_input_length`` groups of at most PIPE_GROUP of ``elements``
    equal signals, the pipeline's features: one feature program each."""
    sizes = {min(PIPE_GROUP, elements - i)
             for i in range(0, elements, PIPE_GROUP)}
    return [(b, samples, PIPE_KW) for b in sorted(sizes)]


def kernel_launches_seen(counts, name):
    """(events recorded, device ms per recorded event) of the device ops
    whose name holds ``name`` in a ``device_ops`` window; (0, None) when
    the profiler saw none."""
    seen = [v for key, v in counts.items() if name in key]
    n = sum(c for c, _ in seen)
    return n, (sum(ms for _, ms in seen) / n if n else None)


@contextlib.contextmanager
def recording_losses(sink):
    """Append every fused train step's loss (0-dim or [K] device tensors,
    read after the run: ``step_losses_of``) to ``sink`` while the step
    builders of ``on_device`` build the steps that fit_fused runs, graphed
    or eager."""
    from lidbox_tpu_torch.data import on_device
    names = ("make_fused_train_step", "make_fused_multi_step",
             "make_fused_replay_step", "make_fused_replay_rows_step")
    originals = {name: getattr(on_device, name) for name in names}

    def recorded(make):
        @functools.wraps(make)
        def build(*args, **kw):
            step = make(*args, **kw)

            def run(*a, **k):
                state, loss = step(*a, **k)
                sink.append(loss)
                return state, loss
            return run
        return build

    for name, make in originals.items():
        setattr(on_device, name, recorded(make))
    try:
        yield sink
    finally:
        for name, make in originals.items():
            setattr(on_device, name, make)


def step_losses_of(sink):
    """The step losses ``recording_losses`` kept, as floats in order."""
    return [float(v) for loss in sink for v in loss.reshape(-1).cpu()]


@contextlib.contextmanager
def eager_steps():
    """fit_fused with the functional eager steps (``fit_signals(...,
    eager=True)``): the captured graphs' reference."""
    from lidbox_tpu_torch.data import on_device
    fit = on_device.fit_signals
    on_device.fit_signals = functools.partial(fit, eager=True)
    try:
        yield
    finally:
        on_device.fit_signals = fit


def check_same_run(graphed, eager, what):
    """Two runs from one seed, (step losses, history, trainer) each, graphed
    and eager: step losses, epoch logs and every tensor of the final state
    bit for bit. Returns the number of state tensors compared."""
    from lidbox_tpu_torch.train import graphs
    (l_g, h_g, t_g), (l_e, h_e, t_e) = graphed, eager
    check(len(l_g) == len(l_e) and l_g == l_e,
          f"{what}: graphed step losses {l_g} != eager {l_e}")

    def values(history):  # the epochs' results, without the throughputs
        return [{k: v for k, v in h.items()
                 if k not in ("examples_per_sec", "audio_rtf")}
                if isinstance(h, dict) else h for h in history]
    check(values(h_g) == values(h_e),
          f"{what}: graphed epochs {values(h_g)} != eager {values(h_e)}")
    a, b = graphs.state_tensors(t_g.state), graphs.state_tensors(t_e.state)
    check(t_g.state.step == t_e.state.step and len(a) == len(b),
          f"{what}: the states differ in step or structure")
    diff = [i for i, (x, y) in enumerate(zip(a, b)) if not torch.equal(x, y)]
    check(not diff, f"{what}: {len(diff)} of {len(a)} state tensors differ "
                    "between the graphed and the eager run")
    return len(a)


def whole_step_times(step, state, inputs, steps=30, warmup=5, profiled=5):
    """One fused train step form (``step(state, *inputs) -> (state,
    loss)``, from ``make_fused_train_step``) on one batch: (median ms on
    CUDA events, host wall ms a step, device busy ms a step over
    ``profiled`` steps under torch.profiler, the log-Mel launches it
    recorded of those). The warm-up captures a graphed step."""
    holder = [state]

    def one():
        holder[0], _ = step(holder[0], *inputs)

    for _ in range(warmup):
        one()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(steps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        one()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    median = float(np.median([a.elapsed_time(b) for a, b in pairs]))
    t0 = time.perf_counter()
    for _ in range(steps):
        one()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / steps * 1e3
    seen = {}
    busy = sum(ms for ms, _ in device_ops(one, calls=profiled, counts=seen))
    return median, wall, busy, kernel_launches_seen(seen, "logmel_kernel")[0]


def eager_and_graphed(trainer, feature_fn, inputs, what, steps=30,
                      profiled=5):
    """The whole fused step eager (the functional step) and graphed (one
    CUDA graph replay) on the same inputs, timed in turns (eager, graphed,
    graphed, eager: whole_step_times): {"eager": [(median, wall, busy),
    ...], "graphed": [...]}, printed with the idle shares."""
    from lidbox_tpu_torch.data import on_device
    forms = {"eager": on_device.make_fused_train_step(trainer, feature_fn,
                                                      eager=True),
             "graphed": on_device.make_fused_train_step(trainer, feature_fn)}
    out = {"eager": [], "graphed": []}
    for form in ("eager", "graphed", "graphed", "eager"):
        out[form].append(whole_step_times(forms[form], trainer.state,
                                          inputs, steps=steps,
                                          profiled=profiled))
    for form, runs in out.items():
        print(f"{what}, whole step {form}: " + "; ".join(
            f"median {m:.4f} ms on CUDA events, host wall {w:.4f} ms, device "
            f"busy {b:.4f} ms ({1 - b / m:.1%} of the median idle; the "
            f"profiler recorded {n} of {profiled} kernel launches)"
            for m, w, b, n in runs))
    return out


def served_times(run, reps=20, warmup=3):
    """(median ms on CUDA events, host wall ms a call, device busy ms a call
    over 5 calls under torch.profiler) of one served call ``run()``, which
    ends in its readback."""
    for _ in range(warmup):
        run()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        run()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    median = float(np.median([a.elapsed_time(b) for a, b in pairs]))
    t0 = time.perf_counter()
    for _ in range(reps):
        run()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / reps * 1e3
    busy = sum(ms for ms, _ in device_ops(run))
    return median, wall, busy


def served_turns(what, forms, card, per_call=None,
                 order=("eager", "graphed", "graphed", "eager"), reps=20):
    """``forms`` (by default "eager" and "graphed") timed in the turns of
    ``order`` (``served_times`` of ``reps`` calls) and printed with the
    card line and each form's idle share; ``per_call`` (utterances a call)
    adds utt/s. Returns {form: [(median, wall, busy), ...]}."""
    out = {form: [] for form in order}
    for form in order:
        out[form].append(served_times(forms[form], reps=reps))
    for form, runs in out.items():
        print(f"served graphs, {what} {form} ({card}): " + "; ".join(
            f"median {m:.4f} ms on CUDA events, host wall {w:.4f} ms, "
            f"device busy {b:.4f} ms ({1 - b / m:.1%} of the median idle)"
            + (f", {per_call / m * 1e3:.1f} utt/s" if per_call else "")
            for m, w, b in runs))
    return out


def phase_served_graphs(root, logmel, trainer, val_features):
    """The one-program served path (phase 16, after phase 4): the
    full-width x-vector (weights from the seed) behind ``serve.Classifier``
    (32 whole 3 s wavs, and the same in 2 s chunks) and
    ``StreamingClassifier`` (one of them online), graphed and with
    ``eager=True``, and phase 4's ``Trainer.evaluate``, graphed and eager.
    The kernel's launches of each part are predicted and printed first,
    warm-ups included, and read on the card; graphed equals eager bit for
    bit; the stream equals the offline chunked scores within STREAM_ATOL;
    the kernel is held to its plain version on the batches the captured
    programs handed it; a weight changed in place is served by the next
    replay, replaced weights are captured anew. Then each served form is
    timed eager and graphed in turns. Returns the launches of each kernel
    read on the card over the driven parts, and the worst float32 error."""
    from lidbox_tpu_torch import models, serve
    from lidbox_tpu_torch.features import io
    from lidbox_tpu_torch.train import graphs

    card = card_line()
    rng = np.random.default_rng(SEED + 10)
    served = os.path.join(root, "served")
    os.makedirs(served)
    n = 32
    paths = write_wavs(io, served, rng, n, 3.0)
    ids = [f"utt{i:03d}" for i in range(n)]
    frames = 1 + (3 * RATE - 400) // 160
    model = models.create("xvector", (frames, 64), len(LABELS),
                          device="cuda").init(
        torch.Generator().manual_seed(SEED))

    def services(eager):
        kw = dict(feature_config=FEATURES_PALLAS, batch_size=n,
                  device="cuda", eager=eager)
        return {"whole": serve.Classifier(model, LABELS, **kw),
                "chunked": serve.Classifier(model, LABELS,
                                            chunk_length_ms=2000,
                                            chunk_step_ms=1000, **kw),
                "stream": serve.StreamingClassifier(
                    model, LABELS, feature_config=FEATURES_PALLAS,
                    sample_rate=RATE, chunk_seconds=2.0, hop_seconds=1.0,
                    device="cuda", eager=eager)}
    signal, _ = io.read_wav(paths[0])

    def drive(part, service):
        if part == "stream":
            service.reset()
            for block in np.array_split(signal, [1234, 20000, 20333]):
                service.feed(block)
            return service.scores()
        return service.scores(paths, ids=ids)["prediction"]

    # the prediction, from the shapes alone: 3 s wavs pad to the 4 s
    # signal bucket, 2 s chunks at a 1 s hop give 2 a wav (64: 2 batches of
    # 32) and 2 of the stream; a captured program's warm-ups launch too
    chunks = (3 * RATE - 2 * RATE) // RATE + 1
    calls = {"whole": ((n, 4 * RATE), 1),
             "chunked": ((n, 2 * RATE), chunks),  # n * chunks in batches of n
             "stream": ((1, 2 * RATE), chunks)}
    predicted = {}
    for part, (shape, k) in calls.items():
        split = logmel.launch_plan(*shape, RATE)[0]["splits"] > 1
        for form, warm in (("graphed", graphs.WARMUP_STEPS), ("eager", 0)):
            predicted[part, form] = (k + warm, (k + warm) * split)
    print("served graphs: predicted launches (logmel_kernel, logmel_reduce),"
          " warm-ups included: " + ", ".join(
              f"{part} {form} {v}" for (part, form), v in predicted.items()))

    forms = {"graphed": services(False), "eager": services(True)}
    results, kept = {}, {}
    launched = np.zeros(2, np.int64)
    batches, restore = keep_served_batches()
    try:
        for form in ("graphed", "eager"):
            for part in ("whole", "chunked", "stream"):
                start = len(batches)
                # the graphed forms capture one program for their shape
                captures = [calls[part][0]] if form == "graphed" else []
                with launch_window(captures=captures) as counted:
                    results[part, form] = drive(part, forms[form][part])
                    torch.cuda.synchronize()
                got = (counted["logmel_kernel"], counted["logmel_reduce"])
                check(got == predicted[part, form],
                      f"served {part} {form}: launches {got}, predicted "
                      f"{predicted[part, form]}")
                launched += got
                kept[part, form] = batches[start:]
    finally:
        restore()
    for part in ("whole", "chunked", "stream"):
        g, e = results[part, "graphed"], results[part, "eager"]
        check(np.isfinite(g).all() and np.array_equal(g, e),
              f"served {part}: graphed scores differ from eager by "
              f"{np.abs(g - e).max()}")
    err_stream = np.abs(results["stream", "graphed"]
                        - results["chunked", "graphed"][0]).max()
    check(err_stream <= STREAM_ATOL,
          f"graphed stream vs offline chunked scores differ by {err_stream}")
    print(f"served graphs: Classifier whole {results['whole', 'graphed'].shape}"
          f" and chunked, StreamingClassifier ({chunks} chunks) graphed == "
          f"eager bit for bit; launches as predicted; stream vs offline "
          f"chunked {err_stream:.3e} (tolerance {STREAM_ATOL})")

    # the kernel against its plain version on what the programs handed it
    worst = 0.0
    shapes = {}
    for part in ("whole", "chunked", "stream"):
        for x, rate in kept[part, "graphed"]:
            shapes.setdefault(tuple(x.shape), (part, x, rate))
    with torch.inference_mode():
        for shape, (part, x, rate) in shapes.items():
            worst = max(worst, compare(logmel, f"served_{part}_{shape[0]}x"
                                       f"{shape[1]}", x, rate, KERNEL_KW))

    # evaluation: phase 4's validation batches, graphed and eager
    with launch_window(captures=[]) as counted:  # features: no kernel
        graphed_eval = trainer.evaluate(val_features)
    check(counted["logmel_kernel"] == 0,
          "evaluate on feature batches launched the kernel")
    eager_eval = trainer.evaluate(val_features, eager=True)
    check(graphed_eval == eager_eval,
          f"graphed evaluate {graphed_eval} != eager {eager_eval}")
    print(f"served graphs: Trainer.evaluate of {len(val_features)} batches "
          f"graphed == eager bit for bit: {graphed_eval}")

    # the timed forms
    x = val_features[0]["input"].cpu().numpy()
    predict = {f: forms[f]["whole"]._predict_fn for f in forms}
    served_turns(f"forward {list(x.shape)}",
                 {f: functools.partial(predict[f], x) for f in forms}, card)
    chunk = np.ascontiguousarray(signal[:2 * RATE], np.float32)
    served_turns(f"stream chunk [1, {2 * RATE}]",
                 {f: functools.partial(forms[f]["stream"]._score_chunk, chunk)
                  for f in forms}, card)
    signals = [io.read_wav(p)[0] for p in paths]

    def features_and_forward(form):
        feats = forms[form]["whole"].extractor.extract_ragged(signals, RATE)
        return predict[form](np.stack(feats))
    served_turns(f"features + forward of {n} decoded 3 s signals",
                 {f: functools.partial(features_and_forward, f)
                  for f in forms}, card, per_call=n)
    served_turns(f"evaluate of {len(val_features)} batches",
                 {"graphed": lambda: trainer.evaluate(val_features),
                  "eager": lambda: trainer.evaluate(val_features,
                                                    eager=True)}, card)

    # weights: changed in place, then replaced
    before = predict["graphed"](x)
    check(np.array_equal(before, predict["eager"](x)),
          "graphed forward differs from eager")
    name, weight = next((k, v) for k, v in model.module.named_parameters()
                        if v.dim() > 1)
    with torch.no_grad():
        weight.mul_(0.5)
    captured = graphs.captures["forward"]
    changed = predict["graphed"](x)
    check(not np.array_equal(changed, before)
          and np.array_equal(changed, predict["eager"](x))
          and graphs.captures["forward"] == captured,
          "a weight changed in place was not served by the next replay")
    owner, attr = name.rsplit(".", 1)
    sub = model.module.get_submodule(owner)
    setattr(sub, attr, torch.nn.Parameter(weight.detach() * 4.0))
    replaced = predict["graphed"](x)
    check(np.array_equal(replaced, predict["eager"](x))
          and not np.array_equal(replaced, changed)
          and graphs.captures["forward"] == captured + 1,
          "replaced weights were not captured anew")
    print(f"served graphs: {name} halved in place served by the next replay "
          "(no capture); replaced by a new tensor, captured anew; both "
          "equal eager bit for bit")
    return int(launched[0]), int(launched[1]), worst


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
    holder = [state]
    seen = {}
    kernels = device_ops(lambda: holder.__setitem__(0, step(holder[0])),
                         counts=seen)
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
        n_in, in_step = kernel_launches_seen(seen, "logmel_kernel")
        print(f"train step profile (torch.profiler, 5 steps): device busy "
              f"{busy_ms:.4f} ms/step, {1 - busy_ms / parts['step']:.1%} of "
              f"the step median idle; {len(kernels)} device ops, the top: "
              + "; ".join(f"{ms:.4f} ms {name[:60]}"
                          for ms, name in kernels[:6]))
        print(f"fused_logmel inside the train step: "
              f"{in_step if in_step is None else f'{in_step:.4f}'} ms of "
              f"device time a launch (torch.profiler, {n_in} of 5 launches "
              f"recorded) against {kernel_ms:.4f} ms back to back (CUDA "
              "events, phase 9)")
    else:
        print("train step profile: torch.profiler saw no device time")
    parts["forms"] = eager_and_graphed(
        trainer, feature_fn, (x, y, gen), f"train step [{B}, {T}]")
    return parts


def class_sines_with_pauses(rng, n_batches, batch=TRAIN_BATCH,
                            seconds=TRAIN_SECONDS):
    """class_sines with one silent stretch of 0.35-0.8 s per row, longer
    than the energy VAD's 300 ms smoothing, so the VAD compacts every row
    and leaves it a zero tail."""
    out = []
    for sig, y in class_sines(rng, n_batches, batch, seconds):
        sig = sig.copy()
        for row in sig:
            width = int(RATE * rng.uniform(0.35, 0.8))
            start = int(rng.integers(0, row.size - width))
            row[start:start + width] = 0.0
        out.append((sig, y))
    return out


def augmented_config(root, feed):
    """train_config with the whole on-device chain and the feed options."""
    cfg = train_config(root)
    cfg["features"]["on_device_augment"] = {
        "noise_datadir": os.path.join(root, "noise"),
        "snr_range": [5, 20], "augment_prob": 0.5, "fir_coefs": 10,
        "speed_range": [0.9, 1.1], "vad": True,
        "specaug": {"time_masks": 2, "freq_masks": 2}}
    cfg["experiment"]["name"] = "smoke_augmented_" + "_".join(
        f"{k}{v}" for k, v in sorted(feed.items()))
    cfg["experiment"]["feed"] = dict(feed)
    cfg["experiment"]["callbacks"] = []
    return cfg


def augmented_wrapper(root, feed):
    from lidbox_tpu_torch.models.model_utils import ModelWrapper
    wrapper = ModelWrapper.from_config(augmented_config(root, feed),
                                       device="cuda")
    wrapper.model.init(torch.Generator().manual_seed(SEED))
    return wrapper


def phase_augmented_train(root, rng, logmel):
    """The augmented training path: fit_fused of the full-width x-vector
    through the whole on-device chain (VAD -> speed -> noise -> FIR ->
    fused_logmel -> SpecAugment) with int16 staging, 2 steps per dispatch
    and the cache replayed with the rows reshuffle. Returns the kernel's
    launch count over the fit, the float32 errors of the kernel on the
    augmented batches it was handed, one raw training batch and the
    wrapper."""
    import lidbox_tpu_torch.features as features
    from lidbox_tpu_torch.data import on_device
    from lidbox_tpu_torch.features import io
    from lidbox_tpu_torch.train.loop import Callback

    os.makedirs(os.path.join(root, "noise"))
    for i in range(4):  # the noise bank: 4 x 10 s of coloured noise
        noise = np.cumsum(rng.normal(0, 1, RATE * 10)) * 0.02
        noise = noise - np.convolve(noise, np.ones(64) / 64, mode="same")
        io.write_mono_wav(os.path.join(root, "noise", f"n{i}.wav"),
                          (0.5 * noise / np.abs(noise).max()).astype(
                              np.float32), RATE)
    train = class_sines_with_pauses(rng, TRAIN_BATCHES)
    val = class_sines_with_pauses(rng, VAL_BATCHES)
    feed = {"stage_dtype": "int16", "steps_per_dispatch": 2,
            "cache_staged": True, "cache_shuffle": "rows"}
    wrapper = augmented_wrapper(root, feed)
    trainer = wrapper.trainer
    print(f"augmented training: data seed {SEED + 2}; chain VAD (300 ms) -> "
          "speed [0.9, 1.1] -> noise bank 4 x 10 s at SNR [5, 20] dB -> FIR "
          "10 taps -> fused_logmel -> SpecAugment 2 + 2 masks, augment_prob "
          f"0.5; feed {feed}")

    recorded, kept, transfers = [], [], {}
    epoch, first = [0], [False]
    extract, to_device = features.extract_features, on_device.to_device

    def keeping(signals, *args, **kw):
        # each epoch's first train batch (validation is featurized clean,
        # without lengths), in the eager run: a graph calls this only
        # while it is captured
        if kw.get("lengths") is not None and first[0]:
            kept.append(signals.clone())
            first[0] = False
        return extract(signals, *args, **kw)

    def counting(value, device):
        if np.shape(value)[-1] == int(RATE * TRAIN_SECONDS):
            transfers[epoch[0]] = transfers.get(epoch[0], 0) + 1
        return to_device(value, device)

    class Epochs(Callback):
        def on_epoch_begin(self, trainer, e):
            epoch[0], first[0] = e, True

    trainer.callbacks.append(Epochs())
    on_device.to_device = counting
    try:
        with recording_losses(recorded), launch_window() as counted:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            history = wrapper.fit_fused(lambda: train, epochs=TRAIN_EPOCHS,
                                        val_signal_batches=lambda: val)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
    finally:
        on_device.to_device = to_device
    launches, warmup = counted["logmel_kernel"], counted["warmup"]
    step_losses = step_losses_of(recorded)
    expected = TRAIN_EPOCHS * TRAIN_BATCHES + VAL_BATCHES + warmup
    check(launches == expected, f"augmented training launched the log-Mel "
                                f"kernel {launches} times, not {expected}")
    losses = [h["loss"] for h in history]
    check(len(history) == TRAIN_EPOCHS, f"{len(history)} epochs trained")
    check(losses[-1] < losses[0], f"augmented epoch loss did not fall: "
                                  f"{losses}")
    for h in history:
        check(np.isfinite(h["val_loss"]) and np.isfinite(h["val_C_avg"]),
              f"validation not finite: {h}")
    # epoch 1: one transfer per group of 2 steps, and the validation
    # signals (featurized once); later epochs replay the cache
    check(transfers == {1: TRAIN_BATCHES // 2 + VAL_BATCHES},
          f"signal transfers per epoch {transfers}: epochs 2-"
          f"{TRAIN_EPOCHS} must run from the cache")
    print(f"augmented training: fit_fused {TRAIN_EPOCHS} epochs in "
          f"{t1 - t0:.2f} s (smoke figure), epoch loss "
          + ", ".join(f"{v:.4f}" for v in losses) + "; val_loss "
          + ", ".join(f"{h['val_loss']:.4f}" for h in history) + "; C_avg "
          + ", ".join(f"{h['val_C_avg']:.4f}" for h in history)
          + f"; kernel launches {launches} = {TRAIN_EPOCHS} x {TRAIN_BATCHES}"
          f" steps + {VAL_BATCHES} validation batches + {warmup} capture "
          "warm-up steps; signal transfers per "
          f"epoch {transfers} (epochs 2-{TRAIN_EPOCHS} from the cache)")

    # the graphed run against the eager (functional) steps, from the seed,
    # which also keeps each epoch's first augmented batch for the kernel
    eager = augmented_wrapper(root, feed)
    eager.trainer.callbacks.append(Epochs())
    eager_recorded = []
    features.extract_features = keeping
    try:
        with recording_losses(eager_recorded), eager_steps():
            eager_history = eager.fit_fused(lambda: train,
                                            epochs=TRAIN_EPOCHS,
                                            val_signal_batches=lambda: val)
    finally:
        features.extract_features = extract
    n = check_same_run((step_losses, history, trainer),
                       (step_losses_of(eager_recorded), eager_history,
                        eager.trainer), "augmented training")
    print(f"augmented training graphed == eager, bit for bit: "
          f"{len(step_losses)} step losses, {TRAIN_EPOCHS} epochs' logs, "
          f"{n} state tensors")

    # grouped dispatch against one step per dispatch: bit for bit
    single = augmented_wrapper(root, {"stage_dtype": "int16"})
    single_recorded = []
    with recording_losses(single_recorded):
        single.fit_fused(lambda: train[:4], epochs=1, verbose=False)
    grouped = step_losses[:4]
    per_step = step_losses_of(single_recorded)
    check(grouped == per_step, f"first step losses with steps_per_dispatch "
                               f"2 {grouped} != with 1 {per_step}")
    print(f"first 4 step losses, 2 steps per dispatch == 1 per dispatch, bit "
          f"for bit: {grouped}")

    errors = [compare(logmel, f"augmented_epoch{i + 1}_{tuple(x.shape)}", x,
                      RATE, KERNEL_KW) for i, x in enumerate(kept)]
    check(len(kept) == TRAIN_EPOCHS, f"kept {len(kept)} augmented batches")
    return launches, max(errors), train[0], wrapper


def pipeline_corpus(io, root, rng):
    """The pipeline phase's corpus: 3-5 s noisy sines at 16 kHz with one
    0.35-0.8 s pause each (label k: a tone at 200 + 300 k Hz in white
    noise of its amplitude), and a noise directory of the three MUSAN types
    with its id2label and id2path files. Returns ({split: init_data},
    noise_dir)."""
    wavs = os.path.join(root, "pipeline_wavs")
    noise_dir = os.path.join(root, "pipeline_noise")
    os.makedirs(wavs)
    os.makedirs(noise_dir)
    init = {}
    for split, n in (("train", PIPE_TRAIN), ("test", PIPE_TEST)):
        rows = {"id": [], "path": [], "label": []}
        for i in range(n):
            k = int(rng.integers(0, len(LABELS)))
            t = np.arange(int(RATE * rng.uniform(3.0, 5.0))) / RATE
            f = 200.0 + 300.0 * k + rng.uniform(-20.0, 20.0)
            sig = (np.sin(2 * np.pi * f * t + rng.uniform(0, 2 * np.pi))
                   + rng.normal(0, 1, t.size))
            width = int(RATE * rng.uniform(0.35, 0.8))
            start = int(rng.integers(0, t.size - width))
            sig[start:start + width] = 0.0
            uid = f"{split}{i:03d}"
            path = os.path.join(wavs, uid + ".wav")
            io.write_mono_wav(path, (0.5 * sig / np.abs(sig).max()).astype(
                np.float32), RATE)
            rows["id"].append(uid)
            rows["path"].append(path)
            rows["label"].append(LABELS[k])
        init[split] = rows
    with open(os.path.join(noise_dir, "id2label"), "w") as f_label, \
            open(os.path.join(noise_dir, "id2path"), "w") as f_path:
        for j, kind in enumerate(("noise", "speech", "music") * 2):
            noise = rng.normal(0, 1, RATE * 2)
            if kind != "noise":  # coloured: a running sum, high-passed
                noise = np.cumsum(noise)
                noise -= np.convolve(noise, np.ones(64) / 64, mode="same")
            path = os.path.join(noise_dir, f"{kind}{j}.wav")
            io.write_mono_wav(path, (0.5 * noise / np.abs(noise).max()).astype(
                np.float32), RATE)
            f_label.write(f"{kind}{j} {kind}\n")
            f_path.write(f"{kind}{j} {path}\n")
    return init, noise_dir


def pipeline_config(root, noise_dir):
    """The configuration of docs/config.md as far as this machine runs it.
    Left out: ``post_process.chunks`` (length 200 would drop every
    198-frame chunk), ``post_process.tensorboard`` (no writer here), and the
    ``embeddings`` section, which the extraction pass adds (a pipeline
    built with it restores a checkpoint, so it comes after training)."""
    return {
        "pre_process": {
            "filters": {"equal": {"key": "sample_rate", "value": RATE},
                        "min_signal_length_ms": 500},
            "rms_vad": {"strength": 0.1, "vad_frame_length_ms": 10,
                        "min_non_speech_length_ms": 300},
            "repeat_too_short_signals": {"min_length_ms": 2000},
            "augment": [
                {"type": "additive_noise", "split": "train",
                 "noise_datadir": noise_dir,
                 "snr_list": [["noise", 5, 15], ["speech", 15, 20],
                              ["music", 10, 20]]},
                {"type": "random_resampling", "split": "train",
                 "min": 0.9, "max": 1.1}],
            "chunks": {"length_ms": 2000, "step_ms": 1000, "max_pad_ms": 200},
        },
        "features": {
            "type": "logmelspectrogram",
            "melspectrogram": {"num_mel_bins": 64, "fmin": 20.0,
                               "fmax": 7000.0},
            "window_normalization": {"window_len": 300},
            "group_by_input_length": {"max_batch_size": PIPE_GROUP},
            "stft_method": "pallas",
        },
        "post_process": {"normalize": {"key": "input"},
                         "shuffle_buffer_size": 1000},
        "experiment": {
            "cache_directory": root, "name": "smoke_pipeline",
            "input_shape": [PIPE_FRAMES, 64], "output_shape": [len(LABELS)],
            "model": {"key": "xvector"},
            "optimizer": {"cls": "Adam", "kwargs": {"learning_rate": 1e-3}},
            "loss": {"cls": "SparseCategoricalCrossentropy"},
            "metrics": [{"cls": "SparseAverageDetectionCost", "name": "C_avg",
                         "N": len(LABELS),
                         "threshold_linspace": {"start": -10.0, "stop": 0.0,
                                                "num": 50}}],
            "callbacks": [{"cls": "ModelCheckpoint",
                           "kwargs": {"monitor": "val_loss", "mode": "min"}}],
            "data": {"train": {"split": "train", "batch_size": PIPE_GROUP},
                     "test": {"split": "test"}},
        },
    }


def embeddings_section(config):
    return {"extractors": [{
        "cache_directory": config["experiment"]["cache_directory"],
        "model": {"key": "xvector"},
        "experiment_name": config["experiment"]["name"],
        "input_shape": [PIPE_FRAMES, 64], "output_shape": [len(LABELS)],
        "best_checkpoint": {"monitor": "val_loss", "mode": "min"}}],
        "batch_size": PIPE_GROUP}


def phase_pipeline(root, rng, logmel, device="cuda"):
    """The config-driven pipeline: create_dataset -> from_steps(device=...)
    -> ModelWrapper.fit on the full-width x-vector -> checkpoints ->
    steps.extract_embeddings from the best checkpoint. Returns the kernel's
    launch count over fit and extraction, its worst float32 error on the
    groups the pipeline handed it, and the timing line's numbers."""
    from lidbox_tpu_torch import models
    from lidbox_tpu_torch.data import from_steps
    from lidbox_tpu_torch.data.device_pipeline import DeviceFeatureExtractor
    from lidbox_tpu_torch.data.pipelines import create_dataset
    from lidbox_tpu_torch.features import io
    from lidbox_tpu_torch.models.model_api import as_embedding_extractor
    from lidbox_tpu_torch.models.model_utils import (
        ModelWrapper, best_model_checkpoint_from_config,
        experiment_cache_from_config)
    from lidbox_tpu_torch.train import batches_from_dataset

    on_card = torch.device(device).type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    init, noise_dir = pipeline_corpus(io, root, rng)
    config = pipeline_config(root, noise_dir)

    def pipeline(split, dev=device, cfg=config):
        return from_steps(create_dataset(split, LABELS, init[split], cfg),
                          device=dev)

    # the group count, independently of the feature step: the host steps
    # alone (up to the chunks) give the elements; one length and one rate,
    # so ceil(elements / max_batch_size) groups
    groups, elements, shapes = {}, {}, {}
    for split in ("train", "test"):
        steps = create_dataset(split, LABELS, init[split], config)
        host = steps[:[s.key for s in steps].index("extract_features")]
        chunks = list(from_steps(host, device=device))
        keys = {(x["signal"].size, int(x["sample_rate"])) for x in chunks}
        check(keys == {(2 * RATE, RATE)}, f"{split}: chunk keys {keys}")
        elements[split] = len(chunks)
        groups[split] = -(-len(chunks) // PIPE_GROUP)
        shapes[split] = group_shapes(len(chunks), 2 * RATE)
    print(f"pipeline: {PIPE_TRAIN} train / {PIPE_TEST} test wavs of 3-5 s -> "
          f"{elements['train']} / {elements['test']} chunks of 2 s -> "
          f"{groups['train']} / {groups['test']} groups of at most "
          f"{PIPE_GROUP} per pass (from the host steps alone)")

    kept, calls = {}, []
    extract, call = DeviceFeatureExtractor.extract, DeviceFeatureExtractor.__call__

    def keeping(self, signals, sample_rate, **kw):
        key = (tuple(signals.shape), int(sample_rate))
        if key not in kept and not kw:
            kept[key] = signals.to(device, copy=True)
        return extract(self, signals, sample_rate, **kw)

    def timed_call(self, signals, sample_rate):
        t0 = time.perf_counter()
        out = call(self, signals, sample_rate)  # ends in a readback
        calls.append(time.perf_counter() - t0)
        return out

    DeviceFeatureExtractor.extract = keeping
    DeviceFeatureExtractor.__call__ = timed_call
    try:
        train_ds, test_ds = pipeline("train"), pipeline("test")
        sync()
        t0 = time.perf_counter()
        n_timed = sum(1 for _ in train_ds)
        pass_s = time.perf_counter() - t0
        check(n_timed == elements["train"] and len(calls) == groups["train"],
              f"timed pass: {n_timed} elements, {len(calls)} groups")
        group_call_ms = 1e3 * float(np.median(calls))

        wrapper = ModelWrapper.from_config(config, device=device)
        wrapper.model.init(torch.Generator().manual_seed(SEED))
        # the timed pass captured the train split's feature programs
        with launch_window(device, captures=shapes["test"]) as counted:
            sync()
            t0 = time.perf_counter()
            history = wrapper.fit(batches_from_dataset(train_ds, PIPE_GROUP),
                                  batches_from_dataset(test_ds, PIPE_GROUP),
                                  epochs=TRAIN_EPOCHS)
            sync()
            fit_s = time.perf_counter() - t0
        fit_launches = counted["logmel_kernel"]
    finally:
        DeviceFeatureExtractor.extract = extract
        DeviceFeatureExtractor.__call__ = call
    # fit's steps take feature batches: their warm-ups launch no kernel;
    # the pipelines' feature programs do
    expected = (TRAIN_EPOCHS * (groups["train"] + groups["test"])
                + counted["warmup"])
    if on_card:
        check(fit_launches == expected,
              f"fit launched the log-Mel kernel {fit_launches} times, not "
              f"{TRAIN_EPOCHS} x ({groups['train']} + {groups['test']}) + "
              f"{counted['warmup']} capture warm-ups")
    losses = [h["loss"] for h in history]
    check(len(history) == TRAIN_EPOCHS, f"{len(history)} epochs trained")
    check(losses[-1] < losses[0], f"pipeline epoch loss did not fall: {losses}")
    for h in history:
        check(np.isfinite(h["val_loss"]) and np.isfinite(h["val_C_avg"]),
              f"validation not finite: {h}")
    ckpt_dir = os.path.join(experiment_cache_from_config(config), "checkpoints")
    names = sorted(os.listdir(ckpt_dir))
    check(len(names) == TRAIN_EPOCHS and all(CKPT_NAME.match(n) for n in names),
          f"checkpoints {names} are not the JAX package's name scheme")
    print(f"pipeline training: fit {TRAIN_EPOCHS} epochs in {fit_s:.2f} s "
          "(smoke figure), epoch loss " + ", ".join(f"{v:.4f}" for v in losses)
          + "; val_loss " + ", ".join(f"{h['val_loss']:.4f}" for h in history)
          + "; C_avg " + ", ".join(f"{h['val_C_avg']:.4f}" for h in history)
          + f"; kernel launches {fit_launches} = {TRAIN_EPOCHS} x "
          f"({groups['train']} train + {groups['test']} test groups) + "
          f"{counted['warmup']} capture warm-ups; "
          f"checkpoints {names}")

    # embeddings through the config's embeddings section, from the best
    # checkpoint; one batch against the restored model's extractor
    emb_config = dict(config, embeddings=embeddings_section(config))
    with launch_window(device, captures=shapes["test"]) as counted:
        sync()
        embedded = pipeline("test", cfg=emb_config).collect()
        sync()
    emb_launches = counted["logmel_kernel"]
    if on_card:
        check(emb_launches == groups["test"] + counted["warmup"],
              f"extraction launched the kernel {emb_launches} times, not "
              f"{groups['test']} + {counted['warmup']} capture warm-ups")
    emb = np.stack([x["embedding"] for x in embedded])
    check(emb.shape == (elements["test"], 512) and np.isfinite(emb).all(),
          f"embeddings of shape {emb.shape}, finite {np.isfinite(emb).all()}")
    best = best_model_checkpoint_from_config(config)
    restored = ModelWrapper.from_config(config, device=device)
    restored.trainer.restore(best)
    first = embedded[:PIPE_GROUP]
    with torch.inference_mode():
        direct = as_embedding_extractor(restored.model).apply(torch.as_tensor(
            np.stack([x["input"] for x in first]), device=device)).cpu().numpy()
    check(np.array_equal(direct, emb[:len(first)]),
          "extract_embeddings differs from the restored best checkpoint's "
          f"extractor by {np.abs(direct - emb[:len(first)]).max()}")
    print(f"pipeline embeddings: {emb.shape} finite from {os.path.basename(best)}"
          f"; kernel launches {emb_launches} = {groups['test']} test groups "
          f"+ {counted['warmup']} capture warm-ups; the "
          f"first batch of {len(first)} equals as_embedding_extractor(restored "
          "best).apply bit for bit")

    # the same pipeline with device="cpu": the plain version
    if on_card:
        for split, take in (("test", None), ("train", 2 * PIPE_GROUP)):
            card, cpu = pipeline(split), pipeline(split, dev="cpu")
            if take:
                card, cpu = card.take(take), cpu.take(take)
            card, cpu = card.collect(), cpu.collect()
            for name in ("id", "target", "label"):
                check([x[name] for x in card] == [x[name] for x in cpu],
                      f"{split}: {name} differ between the card and the CPU")
            a = np.stack([x["input"] for x in card])
            b = np.stack([x["input"] for x in cpu])
            check(a.shape == b.shape == (len(card), PIPE_FRAMES, 64),
                  f"{split}: shapes {a.shape} vs {b.shape}")
            diff = np.abs(a - b)
            excess = (diff / (PIPE_ATOL + PIPE_RTOL * np.abs(b))).max()
            check(excess <= 1.0, f"{split}: card vs CPU pipeline inputs differ "
                                 f"by {diff.max()}")
            print(f"pipeline card vs CPU ({split}, {len(card)} elements): ids, "
                  f"targets, order and shapes equal; input max abs diff "
                  f"{diff.max():.3e}, 99.99th percentile "
                  f"{np.percentile(diff, 99.99):.3e} ({excess:.2f} of atol "
                  f"{PIPE_ATOL} + rtol {PIPE_RTOL})")

    errors, timing = [], None
    if on_card:
        with torch.inference_mode():
            for (shape, rate), x in sorted(kept.items(), reverse=True):
                errors.append(compare(logmel, f"pipeline_{shape[0]}x{shape[1]}",
                                      x, rate, PIPE_KW))
        check(any(s[0] == PIPE_GROUP for s, _ in kept)
              and any(s[0] < PIPE_GROUP for s, _ in kept),
              f"kept groups {sorted(kept)}: no full and remainder group")
        x = kept[((PIPE_GROUP, 2 * RATE), RATE)]
        kw = dict(PIPE_KW, precision="highest")
        with torch.inference_mode():
            ms = cuda_ms(lambda: logmel.fused_logmel(x, RATE, **kw))
            plain_ms = cuda_ms(lambda: logmel.logmel_plain(x, RATE, **kw))
            gemm_ms = dft_gemm_ms(logmel, x, RATE, PIPE_KW)
        bound_ms, bound_by = logmel_bound(logmel, PIPE_GROUP, 2 * RATE, RATE,
                                          "highest", PIPE_KW)
        timing = (ms, plain_ms, bound_ms, bound_by, gemm_ms)
        print(f"fused_logmel [{PIPE_GROUP}, {2 * RATE}] 64 mel 20-7000 Hz "
              f"precision=highest: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"bound {bound_ms:.4f} ms ({bound_by}), {bound_ms / ms:.1%} of "
              f"bound, dft_gemm_ms {gemm_ms:.4f}")
        print(f"pipeline throughput: {n_timed} train elements in {pass_s:.3f} s "
              f"= {n_timed / pass_s:.1f} elements/s through the whole train "
              f"pipeline (host clock, one pass); {1e3 * pass_s / len(calls):.3f}"
              f" ms of pipeline per group, of which the extractor call "
              f"(transfer, kernel, normalization, readback) {group_call_ms:.3f}"
              f" ms median, the kernel alone {ms:.4f} ms")
    return (fit_launches + emb_launches, max(errors, default=0.0), timing,
            (init, noise_dir, groups, shapes))


def cli_config(root, init, noise_dir):
    """The pipeline phase's configuration under a cache of its own, with a
    ``metadata`` section: a CSV of both splits (id, path, label, split).
    Returns (config, {id: label})."""
    csv_path = os.path.join(root, "cli_meta.csv")
    id2label = {}
    with open(csv_path, "w", encoding="utf-8") as f:
        f.write("id,path,label,split\n")
        for split, rows in init.items():
            for uid, path, label in zip(rows["id"], rows["path"],
                                        rows["label"]):
                f.write(f"{uid},{path},{label},{split}\n")
                id2label[uid] = label
    config = pipeline_config(root, noise_dir)
    config["metadata"] = {"csv": csv_path}
    config["experiment"] = dict(config["experiment"],
                                cache_directory=os.path.join(root, "cli"),
                                name="smoke_cli", epochs=2)
    return config, id2label


def write_json(config, path):
    with open(path, "w", encoding="utf-8") as f:
        json.dump(config, f)
    return path


def phase_cli(root, logmel, pipeline_data, device="cuda"):
    """``python -m lidbox_tpu_torch`` on the pipeline phase's corpus and
    configuration, each command driven in-process through ``cli.main`` with
    the launch count zeroed just before and read just after: utils
    --validate-config, train 2 epochs, train --resume to 3, evaluate,
    extract-embeddings of both splits, the numpy back-end on them, classify
    whole and in 2 s chunks, export --torch-export. Every output is held to
    the Python entry points. Returns the kernel's launches over the
    commands, its worst float32 error on the groups the CLI handed it, the
    commands' wall times and the argv of its whole-wav ``classify`` (phase
    17 runs it again). With ``device="cpu"`` it rehearses the phase
    on the plain version (the launch counts and the kernel checks need the
    card)."""
    import contextlib
    import io
    from lidbox_tpu_torch import cli, export, serve, util
    from lidbox_tpu_torch.data import from_steps
    from lidbox_tpu_torch.data import steps as steps_mod
    from lidbox_tpu_torch.data.device_pipeline import DeviceFeatureExtractor
    from lidbox_tpu_torch.data.pipelines import create_dataset
    from lidbox_tpu_torch.embed import sklearn_utils as backend
    from lidbox_tpu_torch.meta import generate_label2target
    from lidbox_tpu_torch.models.model_utils import (
        ModelWrapper, best_model_checkpoint_from_config,
        experiment_cache_from_config)

    on_card = torch.device(device).type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def check_launches(name, expected):
        if on_card:
            expected += warmups[name]
            check(launches[name] == expected,
                  f"{name} launched the kernel {launches[name]} times, not "
                  f"{expected}")

    init, noise_dir, groups, shapes = pipeline_data
    config, id2label = cli_config(root, init, noise_dir)
    path = write_json(config, os.path.join(root, "cli.json"))
    cache = experiment_cache_from_config(config)
    walls, launches, warmups = {}, {}, {}
    kept = {}
    extract = DeviceFeatureExtractor.extract

    def keeping(self, signals, sample_rate, **kw):
        key = (tuple(signals.shape), int(sample_rate))
        if key not in kept and not kw:
            kept[key] = signals.to(device, copy=True)
        return extract(self, signals, sample_rate, **kw)

    def command(name, argv, captures=None):
        """Run one command, which captures the feature programs of
        ``captures`` (``launch_window``); returns its standard output. Each
        command builds its datasets, and their programs, anew."""
        out = io.StringIO()
        with launch_window(device, captures=captures) as counted:
            sync()
            t0 = time.perf_counter()
            DeviceFeatureExtractor.extract = keeping
            try:
                with contextlib.redirect_stdout(out):
                    code = cli.main(argv, device=device)
            finally:
                DeviceFeatureExtractor.extract = extract
            sync()
            walls[name] = time.perf_counter() - t0
        launches[name] = counted["logmel_kernel"]
        warmups[name] = counted["warmup"]
        check(code == 0, f"{name}: exit code {code}")
        return out.getvalue()

    def epoch_logs():
        with open(os.path.join(cache, "logs", "events.jsonl")) as f:
            return [json.loads(line) for line in f]

    out = command("utils", ["utils", "--validate-config", path])
    check(out.strip() == "config ok", f"validate-config printed {out!r}")

    per_epoch = groups["train"] + groups["test"]
    command("train", ["train", path],
            captures=shapes["train"] + shapes["test"])
    check_launches("train", 2 * per_epoch)
    check([r["step"] for r in epoch_logs()] == [1, 2],
          f"train ran epochs {[r['step'] for r in epoch_logs()]}, not 1, 2")
    path = write_json(dict(config, experiment=dict(config["experiment"],
                                                   epochs=3)), path)
    command("train --resume", ["train", path, "--resume"],
            captures=shapes["train"] + shapes["test"])
    check_launches("train --resume", per_epoch)
    logs = epoch_logs()
    losses = [r["metrics"]["loss"] for r in logs]
    names = sorted(os.listdir(os.path.join(cache, "checkpoints")))
    check([r["step"] for r in logs] == [1, 2, 3],
          f"epoch numbering {[r['step'] for r in logs]} is not 1, 2, 3")
    check(losses[-1] < losses[0], f"CLI epoch loss did not fall: {losses}")
    check(len(names) == 3 and all(CKPT_NAME.match(n) for n in names)
          and [n[:11] for n in names] == [f"epoch00000{e}" for e in (1, 2, 3)],
          f"checkpoints {names} are not the JAX package's name scheme")
    print(f"cli train: 2 epochs then --resume to 3, epoch loss "
          + ", ".join(f"{v:.4f}" for v in losses) + f"; kernel launches "
          f"{launches['train']} + {launches['train --resume']} = 3 x "
          f"({groups['train']} + {groups['test']}); checkpoints {names}")

    # evaluate: the report against util.evaluate_testset_with_model on the
    # CPU from the same checkpoint; predictions caught on their way in
    reports = []
    classification_report = util.classification_report

    def catching(true, pred, *args, **kw):
        reports.append((np.asarray(true), np.asarray(pred)))
        return classification_report(true, pred, *args, **kw)
    util.classification_report = catching
    try:
        report = json.loads(command("evaluate", ["evaluate", path],
                                    captures=shapes["test"]))
        meta, label2target = generate_label2target(cli.load_metadata(config)[0])
        rows = [i for i, s in enumerate(meta["split"]) if s == "test"]
        test_meta = {"id": [meta["id"][i] for i in rows],
                     "target": meta["target"][rows]}
        cpu = ModelWrapper.from_config(config, device="cpu")
        cpu.trainer.restore(best_model_checkpoint_from_config(config))
        cpu_ds = from_steps(create_dataset("test", LABELS, init["test"],
                                           config), device="cpu")
        cpu_report = util.evaluate_testset_with_model(
            cpu.model, cpu_ds, test_meta, label2target)
    finally:
        util.classification_report = classification_report
    check_launches("evaluate", groups["test"])
    (true, pred), (cpu_true, cpu_pred) = reports
    diff = np.abs(pred - cpu_pred)
    check(np.array_equal(true, cpu_true)
          and (diff <= PIPE_ATOL + PIPE_RTOL * np.abs(cpu_pred)).all(),
          f"evaluate: predictions differ from the CPU's by {diff.max()}")
    check(report["confusion_matrix"] == cpu_report["confusion_matrix"].tolist()
          and all(report[l]["support"] == cpu_report[l]["support"]
                  for l in LABELS),
          "evaluate: confusion matrix or supports differ from the CPU's")
    print(f"cli evaluate: accuracy {report['accuracy']:.4f}, C_avg "
          f"{report['avg_detection_cost']:.4f}, EER "
          f"{report['avg_equal_error_rate']:.4f} ({len(true)} utterances); "
          f"predictions within {diff.max():.3e} of the CPU's, confusion "
          f"matrix and supports equal; kernel launches "
          f"{launches['evaluate']} = {groups['test']} test groups")

    # extract-embeddings, both splits; the test split against
    # steps.extract_embeddings on the card from the same checkpoint
    emb = embeddings_section(config)
    emb_path = write_json(dict(config, embeddings=emb),
                          os.path.join(root, "cli_emb.json"))
    npz = {}
    for split in ("train", "test"):
        name = f"extract-embeddings {split}"
        npz[split] = os.path.join(root, f"cli_{split}.npz")
        command(name, ["extract-embeddings", emb_path, npz[split],
                       "--split", split], captures=shapes[split])
        check_launches(name, groups[split])
    data = {s: np.load(p) for s, p in npz.items()}
    direct = steps_mod.extract_embeddings(
        from_steps(create_dataset("test", LABELS, init["test"], config),
                   device=device), emb, device=device).collect()
    check([str(x["id"]) for x in direct] == list(data["test"]["ids"])
          and np.array_equal(np.stack([x["embedding"] for x in direct]),
                             data["test"]["embeddings"]),
          "extract-embeddings differs from steps.extract_embeddings")
    print(f"cli extract-embeddings: train {data['train']['embeddings'].shape}, "
          f"test {data['test']['embeddings'].shape}; the test file equals "
          "steps.extract_embeddings bit for bit; kernel launches "
          f"{launches['extract-embeddings train']} + "
          f"{launches['extract-embeddings test']}")

    # the numpy back-end on those embeddings, twice
    target2label = {t: l for l, t in label2target.items()}

    def as_xy(split):
        # chunk ids of augmented copies read "augmented-<id>-noise-...-<n>"
        labels = [id2label[re.search(r"(train|test)\d{3}", str(i)).group(0)]
                  for i in data[split]["ids"]]
        return {"X": data[split]["embeddings"].copy(),
                "y": np.asarray([label2target[l] for l in labels])}

    def backend_report():
        t0 = time.perf_counter()
        pipe = backend.fit_classifier(
            as_xy("train"), as_xy("test"), LABELS,
            {"sklearn_experiment": {"cache_directory": root,
                                    "model": {"key": "xvector"},
                                    "name": "smoke_cli"}},
            target2label, backend.GaussianNB, plot_demo=False)
        scores = backend.predict_with_trained_classifier(
            as_xy("test"), None, None, pipe)
        rep = util.classification_report(as_xy("test")["y"], scores,
                                         label2target)
        return scores, rep, time.perf_counter() - t0
    scores, be_report, walls["back-end"] = backend_report()
    scores2, be_report2, _ = backend_report()
    check(np.array_equal(scores, scores2) and np.array_equal(
        be_report["confusion_matrix"], be_report2["confusion_matrix"])
          and be_report["avg_detection_cost"]
          == be_report2["avg_detection_cost"],
          "the back-end differs between two runs on the same embeddings")
    print(f"cli back-end (StandardScaler -> PLDA -> normalize -> GaussianNB, "
          f"numpy): accuracy {be_report['accuracy']:.4f}, C_avg "
          f"{be_report['avg_detection_cost']:.4f} on "
          f"{len(scores)} test chunks; a second run on the same embeddings "
          "equal")

    # classify 8 test wavs, whole and in 2 s chunks, against
    # serve.Classifier called directly
    wavs = init["test"]["path"][:8]
    wrapper = ModelWrapper.from_config(config, device=device)
    wrapper.trainer.restore(best_model_checkpoint_from_config(config))
    for chunk_ms in (None, 2000):
        name = "classify" + (f" {chunk_ms} ms chunks" if chunk_ms else "")
        argv = ["classify", path] + wavs
        if chunk_ms:
            argv += ["--chunk-length-ms", str(chunk_ms)]
        text = command(name, argv)
        rows = [line.split(",") for line in text.strip().splitlines()]
        table = serve.Classifier(wrapper.model, LABELS,
                                 feature_config=config["features"],
                                 chunk_length_ms=chunk_ms,
                                 device=device).classify(wavs)
        columns = ["id", "label"] + [f"score_{l}" for l in LABELS]
        check(rows[0] == columns and [r[:2] for r in rows[1:]]
              == [[i, l] for i, l in zip(table["id"], table["label"])],
              f"{name}: header, ids or labels differ from serve.Classifier")
        csv_scores = np.asarray([r[2:] for r in rows[1:]], np.float32)
        direct_scores = np.stack([table[c] for c in columns[2:]], axis=1)
        check(np.array_equal(csv_scores, direct_scores),
              f"{name}: CSV scores differ from serve.Classifier by "
              f"{np.abs(csv_scores - direct_scores).max()}")
        check(launches[name] > 0 or not on_card, f"{name} launched no kernel")
        print(f"cli {name}: {len(rows) - 1} rows equal to serve.Classifier; "
              f"kernel launches {launches[name]}")

    # export --torch-export: the saved model and program against the live
    # model, and the weights read back
    out_dir = os.path.join(root, "cli_deploy")
    command("export", ["export", path, out_dir, "--torch-export"])
    loaded = export.load_model(out_dir, device=device)
    program = export.load_program(os.path.join(out_dir, export.PROGRAM_NAME))
    live = dict(wrapper.model.module.state_dict())
    check(all(torch.equal(v, live[k])
              for k, v in loaded.module.state_dict().items()),
          "export: the saved weights differ from the checkpoint's")
    worst = 0.0
    gen = torch.Generator(device=device).manual_seed(SEED)
    with torch.inference_mode():
        for batch in (1, 2, 32):
            x = torch.randn(batch, PIPE_FRAMES, 64, device=device,
                            generator=gen)
            ref = wrapper.model.apply(x)
            for got in (loaded.apply(x), program(x)):
                err = (got - ref).abs()
                check((err <= 1e-5 + 1e-5 * ref.abs()).all(),
                      f"export: batch {batch} differs by {err.max().item()}")
                worst = max(worst, err.max().item())
    print(f"cli export: model.json + variables.msgpack + forward.pt2; "
          f"load_model and load_program reproduce the live model at batch 1, "
          f"2 and 32 within {worst:.3e} (atol 1e-5 + rtol 1e-5)")

    errors = []
    if on_card:
        with torch.inference_mode():
            errors = [compare(logmel, f"cli_{shape[0]}x{shape[1]}", x, rate,
                              PIPE_KW) for (shape, rate), x
                      in sorted(kept.items(), reverse=True)]
        check(errors, "the CLI handed the kernel no signal batch")
    where = card_line() if on_card else "cpu"
    print(f"cli wall times on {where} (s, host clock, the kernel's build "
          "excluded): " + ", ".join(f"{k} {v:.2f}" for k, v in walls.items()))
    return (sum(launches.values()), max(errors, default=0.0), walls,
            ["classify", path] + wavs)


# The model zoo: the 13 keys of the registry besides the x-vector (phases
# 3-7) at their published widths, plus clstm's two options and
# convnet_extractor's MobileNetV2 trunk, trained by fit_fused on
# train_config's features ([32, 48000] -> [32, 298, 64]).
ZOO = [(key, {}) for key in (
    "ap_lstm", "bi_gru", "clstm", "cnn", "convnet_extractor", "crnn", "dnn",
    "lstm", "multilevel_attention", "spherespeaker", "xvector_2d",
    "xvector_extended", "xvector_freq_attention")] + [
    ("clstm", {"use_conv2d": True}),
    ("clstm", {"use_attention": True, "use_lstm": True}),
    ("convnet_extractor", {"core": "mobilenet_v2"})]
# Noise and dropout draw from the device's generator, so their training
# forwards differ between the card and the CPU: their losses are compared
# in eval mode.
ZOO_STOCHASTIC = ("clstm", "multilevel_attention")
ZOO_BATCHES, ZOO_VAL_BATCHES, ZOO_WAVS = 2, 1, 4
ZOO_BATCH, ZOO_SECONDS = TRAIN_BATCH, TRAIN_SECONDS
# Card vs CPU: the first step's loss and the served scores. The features
# differ within the kernel's float32 budget, and 16-50 layers carry that
# difference to the outputs.
ZOO_RTOL = ZOO_ATOL = 1e-3


def sync(device):
    if device == "cuda":
        torch.cuda.synchronize()


def zoo_name(key, kw):
    return key + "".join(f"+{k}={v}" for k, v in kw.items())


def zoo_config(root, key, kw):
    config = train_config(root)
    experiment = config["experiment"]
    experiment["name"] = "zoo_" + zoo_name(key, kw).replace("=", "_")
    experiment["model"] = {"key": key, "kwargs": dict(kw)}
    experiment["callbacks"] = []
    if key == "ap_lstm":  # language vectors, 4 x 62 wide, and their loss
        experiment["loss"] = {"cls": "AngularProximity",
                              "kwargs": {"N": len(LABELS), "D": 4 * 62}}
    return config


def zoo_wrapper(root, key, kw, device):
    """ModelWrapper.from_config of one zoo configuration, weights drawn
    from SEED on the CPU (so every device starts from the same ones)."""
    from lidbox_tpu_torch.models.model_utils import ModelWrapper
    wrapper = ModelWrapper.from_config(zoo_config(root, key, kw),
                                       device=device)
    wrapper.model.init(torch.Generator().manual_seed(SEED))
    return wrapper


def zoo_first_loss(wrapper, signals, targets, train):
    """The loss of a fresh wrapper's first step on one signal batch: the
    kernel (or, on the CPU, the plain version) then the model in training
    mode (eval mode for ZOO_STOCHASTIC), before any update."""
    from lidbox_tpu_torch.data import on_device
    from lidbox_tpu_torch.train.loop import to_device
    trainer = wrapper.trainer
    trainer.create_state()
    features = on_device.feature_fn_from_config(
        RATE, wrapper.config["features"], device=trainer.device)
    batch = {"input": features(None, to_device(signals, trainer.device)),
             "target": to_device(targets.astype(np.int64), trainer.device)}
    with torch.no_grad():
        out, _ = trainer._apply(trainer.state.params,
                                trainer.state.batch_stats, batch, train=train,
                                generator=trainer.generator)
        return float(trainer._masked_mean(trainer.loss_fn(batch["target"],
                                                          out), batch))


def zoo_times(wrapper, feats, targets, reps=5, warmup=2):
    """(forward ms, eager train step ms, its device busy ms, graphed train
    step ms, its device busy ms) at [32, 298, 64]: CUDA events around one
    eval forward and one train step (forward, backward, update) on the
    features, the functional ``_train_step`` and fit's step (a CUDA graph
    replay, ``Trainer._fit_step``), medians of ``reps``; the busy times
    from 3 steps under torch.profiler."""
    trainer, model = wrapper.trainer, wrapper.model
    batch = {"input": feats, "target": targets}
    state = trainer.state

    def step():
        trainer._train_step(state, batch, trainer.generator)

    def graphed():
        trainer.state, _ = trainer._fit_step(trainer.state, batch,
                                             trainer.generator)

    def forward():
        with torch.inference_mode():
            model.apply(feats)

    out = []
    for fn in (forward, step, graphed):
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        out.append(float(np.median(times)))
    busy = sum(ms for ms, _ in device_ops(step, calls=3))
    graphed_busy = sum(ms for ms, _ in device_ops(graphed, calls=3))
    return out[0], out[1], busy, out[2], graphed_busy


def phase_zoo(root, rng, logmel, device="cuda"):
    """Every zoo configuration on the fused training path: fit_fused for
    ZOO_BATCHES steps and ZOO_VAL_BATCHES validation batch of [32, 48000]
    with the launch count zeroed just before and read just after (one
    launch per step and per validation batch), a finite loss, BatchNorm
    running statistics moved off their init, the first step's loss against
    the CPU's from the same weights and batch, and serve.Classifier on
    ZOO_WAVS wavs (score_fn for ap_lstm) against the CPU's scores, one
    launch per feature batch. Returns (launches, the kernel's error on a
    zoo batch, the per-configuration rows).

    ``device="cpu"`` rehearses the phase on the plain version (set
    ZOO_BATCH and ZOO_SECONDS small first): the launch counts, the kernel
    check and the timing need the card and are skipped."""
    from lidbox_tpu_torch import serve
    from lidbox_tpu_torch.data import on_device
    from lidbox_tpu_torch.features import io
    from lidbox_tpu_torch.train import graphs
    from lidbox_tpu_torch.train.loop import to_device

    on_card = device == "cuda"
    train = class_sines(rng, ZOO_BATCHES, ZOO_BATCH, ZOO_SECONDS)
    val = class_sines(rng, ZOO_VAL_BATCHES, ZOO_BATCH, ZOO_SECONDS)
    wav_root = os.path.join(root, "zoo_wavs")
    os.makedirs(wav_root)
    paths = write_wavs(io, wav_root, rng, ZOO_WAVS, ZOO_SECONDS)
    print(f"zoo: {len(ZOO)} configurations, fit_fused {ZOO_BATCHES} steps + "
          f"{ZOO_VAL_BATCHES} validation batch of [{ZOO_BATCH}, "
          f"{int(RATE * ZOO_SECONDS)}], then serve.Classifier on "
          f"{ZOO_WAVS} wavs of {ZOO_SECONDS} s; data seed {SEED + 4}")
    x = torch.as_tensor(train[0][0], device=device)
    kernel_err = (compare(logmel, "zoo batch", x, RATE, KERNEL_KW)
                  if on_card else 0.0)
    total, rows = 0, []
    for key, kw in ZOO:
        name = zoo_name(key, kw)
        wrapper = zoo_wrapper(root, key, kw, device)
        trainer = wrapper.trainer
        stochastic = key in ZOO_STOCHASTIC
        first = zoo_first_loss(wrapper, *train[0], train=not stochastic)
        cpu = zoo_first_loss(zoo_wrapper(root, key, kw, "cpu"), *train[0],
                             train=not stochastic)
        loss_err = abs(first - cpu) / abs(cpu)
        check(np.isfinite(first) and loss_err <= ZOO_RTOL,
              f"zoo {name}: first step loss {first} on the card, {cpu} on "
              f"the CPU (rel {loss_err}) beyond rtol {ZOO_RTOL}")
        init_stats = {k: v.clone() for k, v in trainer.state.batch_stats.items()}
        with launch_window(device, captures=[] if graphs.eager_reason(
                trainer) else [(ZOO_BATCH, int(RATE * ZOO_SECONDS))]
                           ) as counted:
            history = wrapper.fit_fused(lambda: train, epochs=1,
                                        val_signal_batches=lambda: val,
                                        verbose=False)
            sync(device)
        launches = counted["logmel_kernel"]
        expected = ZOO_BATCHES + ZOO_VAL_BATCHES + counted["warmup"]
        check(launches == expected or not on_card,
              f"zoo {name}: {launches} kernel launches over fit_fused, not "
              f"{expected}")
        check(np.isfinite(history[0]["loss"])
              and np.isfinite(history[0]["val_loss"]),
              f"zoo {name}: loss not finite: {history}")
        moved = [k for k, v in trainer.state.batch_stats.items()
                 if not torch.equal(v, init_stats[k])]
        check(len(moved) == len(init_stats),
              f"zoo {name}: {len(init_stats) - len(moved)} of "
              f"{len(init_stats)} BatchNorm statistics did not move")
        # serving: the trained weights on the card and copied to the CPU
        cpu_model = zoo_wrapper(root, key, kw, "cpu").model
        cpu_model.module.load_state_dict(
            {k: v.cpu() for k, v in wrapper.model.module.state_dict().items()})
        clf_kw = {"feature_config": FEATURES_PALLAS,
                  "score_fn": wrapper.score_fn}
        with launch_window(device, captures=[served_shape(
                ZOO_WAVS, int(RATE * ZOO_SECONDS))]) as counted:
            ours = serve.Classifier(wrapper.model, LABELS, device=device,
                                    **clf_kw).classify(paths)
            sync(device)
        serve_launches = counted["logmel_kernel"]
        check(serve_launches == 1 + counted["warmup"] or not on_card,
              f"zoo {name}: serving launched the kernel {serve_launches} "
              f"times, not 1 + {counted['warmup']} capture warm-ups")
        ref = serve.Classifier(cpu_model, LABELS, device="cpu",
                               **clf_kw).classify(paths)
        serve_err = max(float(np.abs(ours[f"score_{lab}"]
                                     - ref[f"score_{lab}"]).max())
                        for lab in LABELS)
        check(ours["id"] == ref["id"] and serve_err <= ZOO_ATOL,
              f"zoo {name}: served scores {serve_err} from the CPU's, beyond "
              f"{ZOO_ATOL}")
        features = on_device.feature_fn_from_config(
            RATE, {k: v for k, v in wrapper.config["features"].items()
                   if k != "on_device_augment"}, device=trainer.device)
        feats = features(None, x)
        targets = to_device(train[0][1].astype(np.int64), trainer.device)
        fwd_ms = step_ms = busy_ms = graphed_ms = graph_busy = float("nan")
        if on_card:
            fwd_ms, step_ms, busy_ms, graphed_ms, graph_busy = zoo_times(
                wrapper, feats, targets)
        total += launches + serve_launches
        row = {"config": name, "params": wrapper.count_params(),
               "forward_ms": fwd_ms, "train_step_ms": step_ms,
               "busy_ms": busy_ms, "graphed_step_ms": graphed_ms,
               "graphed_busy_ms": graph_busy, "loss_rel_err": loss_err,
               "serve_max_err": serve_err,
               "launches": launches + serve_launches,
               "batch_norms": len(init_stats) // 2,
               "first_loss": first, "compared_in": "eval" if stochastic
               else "train"}
        rows.append(row)
        print(f"zoo {name}: {row['params']} parameters; forward "
              f"{fwd_ms:.3f} ms, train step eager {step_ms:.3f} ms (device "
              f"busy {busy_ms:.3f} ms), graphed {graphed_ms:.3f} ms (busy "
              f"{graph_busy:.3f} ms) per step at [{ZOO_BATCH}, "
              f"{feats.shape[1]}, {feats.shape[2]}]; first loss {first:.6f} "
              f"vs CPU {cpu:.6f} ({row['compared_in']} mode, rel "
              f"{loss_err:.2e}); served scores max |card - CPU| "
              f"{serve_err:.2e}; {len(moved)} BatchNorm statistics moved; "
              f"kernel launches {launches} fit + {serve_launches} serving")
        freed = weakref.ref(trainer)
        del wrapper, trainer, cpu_model
        # no reference cycle holds a trainer and its captured steps: they
        # go with the last reference, without the cyclic collector
        check(freed() is None, f"zoo {name}: the trainer outlived its "
                               "last reference")
        if on_card:
            torch.cuda.empty_cache()
    print(f"zoo table ({card_line() if on_card else 'CPU rehearsal'}): "
          + json.dumps(rows))
    return total, kernel_err, rows


STAGES = ("draw", "vad", "speed", "noise", "fir", "features", "specaug")


def phase_augmented_step_timing(wrapper, batch, steps=30, warmup=5):
    """The steady augmented train step at [32, 48000]: CUDA events after
    each stage of the chain (the feature fn's on_stage marks), after
    forward + backward and after the optimizer; each step draws from its
    own keyed generator as make_fused_train_step does. Returns the
    per-part medians."""
    from lidbox_tpu_torch.data import on_device
    from lidbox_tpu_torch.train.loop import keyed_generator, to_device
    trainer = wrapper.trainer
    feature_fn = on_device.feature_fn_from_config(
        RATE, wrapper.config["features"], device=trainer.device)
    x = on_device.signals_to_float(to_device(
        on_device.stage_signals(batch[0], "int16"), trainer.device))
    y = to_device(batch[1].astype(np.int64), trainer.device)
    state = trainer.state

    def step(state, events=None):
        mark = None
        if events is not None:
            events["start"].record()

            def mark(name):
                events[name].record()
        gen = keyed_generator(x.device, trainer.seed, state.step, 7)
        feats, mask = feature_fn(gen, x, on_stage=mark)
        loss, grads, bs = trainer._loss_and_grads(
            state, {"input": feats, "input_mask": mask, "target": y},
            trainer.generator)
        if events is not None:
            events["forward_backward"].record()
        state = trainer._apply_gradients(state, grads, bs)
        if events is not None:
            events["optimizer"].record()
        return state

    for _ in range(warmup):
        state = step(state)
    torch.cuda.synchronize()
    # the chain must not wait for the device: every draw and length stays
    # there (CUDA's sync debug mode warns on each synchronizing call)
    import warnings
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            feature_fn(keyed_generator(x.device, trainer.seed, 0, 7), x)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    # (the mode's own notice that it is a prototype is not a sync)
    syncs = [str(w.message) for w in caught
             if "called a synchronizing CUDA operation" in str(w.message)]
    check(not syncs, f"the augmentation chain synchronized with the host: "
                     f"{syncs[:3]}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        state = step(state)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / steps * 1e3
    names = ("start",) + STAGES + ("forward_backward", "optimizer")
    timed = [{n: torch.cuda.Event(enable_timing=True) for n in names}
             for _ in range(steps)]
    for events in timed:
        state = step(state, events)
    torch.cuda.synchronize()
    parts = {}
    for a, b in zip(names, names[1:]):
        parts[b] = float(np.median([e[a].elapsed_time(e[b]) for e in timed]))
    parts["step"] = float(np.median([e["start"].elapsed_time(e["optimizer"])
                                     for e in timed]))

    holder = [state]
    kernels = device_ops(lambda: holder.__setitem__(0, step(holder[0])))
    busy_ms = sum(ms for ms, _ in kernels)
    chain = device_ops(lambda: feature_fn(
        keyed_generator(x.device, trainer.seed, 0, 7), x))
    B, T = x.shape
    print(f"augmented chain alone (torch.profiler, 5 calls): device busy "
          f"{sum(ms for ms, _ in chain):.4f} ms/call over {len(chain)} device "
          "ops, the top: " + "; ".join(f"{ms:.4f} ms {name[:50]}"
                                       for ms, name in chain[:8])
          + "; no host synchronization in the chain (sync debug mode)")
    print(f"augmented train step [{B}, {T}]: median {parts['step']:.4f} ms on "
          "the device; " + ", ".join(f"{n} {parts[n]:.4f}" for n in STAGES)
          + f" (features = fused_logmel + masking), forward + backward "
          f"{parts['forward_backward']:.4f}, optimizer "
          f"{parts['optimizer']:.4f}; host wall {wall_ms:.4f} ms/step over "
          f"{steps} steps")
    if busy_ms:
        print(f"augmented train step profile (torch.profiler, 5 steps): "
              f"device busy {busy_ms:.4f} ms/step, "
              f"{1 - busy_ms / parts['step']:.1%} of the step median idle; "
              f"{len(kernels)} device ops, the top: "
              + "; ".join(f"{ms:.4f} ms {name[:60]}"
                          for ms, name in kernels[:8]))
    else:
        print("augmented train step profile: torch.profiler saw no device "
              "time")
    # the main path's form: int16 staging, the targets packed in a row
    packed = to_device(on_device.pack_targets_int16(
        on_device.stage_signals(batch[0], "int16"),
        batch[1].astype(np.int64)), trainer.device)
    parts["forms"] = eager_and_graphed(
        trainer, feature_fn, (packed, None, trainer.generator),
        f"augmented train step [{B}, {T}]")
    return parts


# The graph phase (14): two BatchNorm zoo configurations through fit_fused
# graphed and eager (clstm's conv2d variant also draws noise and dropout
# from the trainer's generator), GRAPH_EPOCHS epochs of GRAPH_BATCHES
# batches of [32, 48000] with grouped dispatch and the rows replay, and one
# validation batch (a stream of its own, seed 1242).
GRAPH_ZOO = (("xvector_2d", {}), ("clstm", {"use_conv2d": True}))
GRAPH_FEED = {"steps_per_dispatch": 2, "cache_staged": True,
              "cache_shuffle": "rows"}
GRAPH_BATCHES, GRAPH_EPOCHS = 4, 2
# every configuration optimizer_from_config builds, without and with a
# schedule
GRAPH_OPTIMIZERS = [("Adam", {}), ("AdamW", {"weight_decay": 0.05}),
                    ("SGD", {}), ("SGD", {"momentum": 0.9, "nesterov": True}),
                    ("RMSprop", {"momentum": 0.5}), ("Adagrad", {})]


def graph_generator_check(augmented):
    """The augmented phase's draws (draw_augmentation, draw_spec_augment
    at [32, 48000] and [32, 298, 64]) from one generator registered with a
    CUDA graph and re-seeded with ``key_seed`` before each replay, against
    a fresh ``keyed_generator`` of the same key: the steps' draws of a
    captured augmented step. Returns the keys checked."""
    from lidbox_tpu_torch.data import on_device
    from lidbox_tpu_torch.train.loop import key_seed, keyed_generator
    aug = on_device.augment_config_from_dict(
        augmented.config["features"]["on_device_augment"])
    bank = torch.randn(4, 10 * RATE, device="cuda",
                       generator=torch.Generator("cuda").manual_seed(SEED))

    def draws(generator):
        d = on_device.draw_augmentation(generator, aug, TRAIN_BATCH,
                                        int(RATE * TRAIN_SECONDS), bank,
                                        "cuda")
        spec = on_device.draw_spec_augment(generator, aug,
                                           (TRAIN_BATCH, 298, 64), "cuda")
        return [d["gate"], d["speed"], *d["noise"], d["fir"], *spec]

    generator = torch.Generator(device="cuda")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        draws(generator.manual_seed(1))
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    graph.register_generator_state(generator)
    with torch.cuda.graph(graph, stream=side):
        static = draws(generator)
    steps = (0, 1, 7, 23, 1000, 1)
    for step in steps:
        generator.manual_seed(key_seed(SEED, step, 7))
        graph.replay()
        fresh = draws(keyed_generator("cuda", SEED, step, 7))
        check(all(torch.equal(a, b) for a, b in zip(static, fresh)),
              f"the re-seeded registered generator's draws of step {step} "
              "differ from keyed_generator's")
    return steps


def graph_optimizer_check(steps=4):
    """Every optimizer (GRAPH_OPTIMIZERS, each with and without a decay
    schedule) on x-vector-sized tensors on the card: ``update`` with the
    per-step scalars as 0-dim float32 device tensors (a graph's buffers)
    against ``update`` with them as the host's floats, ``steps`` updates,
    bit for bit. Returns the number of configurations."""
    from lidbox_tpu_torch.train import optimizers
    gen = torch.Generator("cuda").manual_seed(SEED)
    shapes = {"w": (512, 1500), "b": (1500,), "v": (64, 5, 512)}
    n = 0
    for cls, kwargs in GRAPH_OPTIMIZERS:
        for schedule in (None, {"cls": "ExponentialDecay", "kwargs": {
                "initial_learning_rate": 1e-3, "decay_steps": 2,
                "decay_rate": 0.7}}):
            kw = dict(kwargs, learning_rate=1e-3)
            if schedule is not None:
                kw["lr_scheduler"] = schedule
            opt, _ = optimizers.optimizer_from_config({"cls": cls,
                                                       "kwargs": kw})
            params = {k: torch.randn(v, device="cuda", generator=gen)
                      for k, v in shapes.items()}
            host = device = opt.init(params)
            for _ in range(steps):
                grads = {k: torch.randn(v.shape, device="cuda",
                                        generator=gen)
                         for k, v in params.items()}
                scalars = [torch.tensor(v, dtype=torch.float32,
                                        device="cuda")
                           for v in opt.scalars(device)]
                a, host = opt.update(grads, host, params)
                b, device = opt.update(grads, device, params,
                                       scalars=scalars)
                check(all(torch.equal(a[k], b[k]) for k in a),
                      f"{cls} {kw}: the update with device scalars differs "
                      "from the update with the host's floats")
            n += 1
    return n


def graph_operands_check(logmel, trainer, program, step, eager, args, what):
    """A captured fused step (``program``'s, run by ``step``) holds the
    addresses of the kernel's basis and mel tiles, which come from caches
    that may drop them: its graphs must keep them. Drops the caches,
    allocates the tiles' sizes filled with 0xFF bytes (NaN in float32 and
    bfloat16; where freed tiles would be reused), then one replay against one ``eager`` step from
    a copy of the state and the dropout generator, bit for bit. Returns the
    number of tiles the graphs hold."""
    from lidbox_tpu_torch.train import graphs
    held = [t for entry in program._captured.values()
            for pair in entry.operands for t in pair]
    check(held, f"graphs: the captured {what} step holds no kernel operands")
    sizes = [t.numel() * t.element_size() for t in held]
    del held
    logmel._launch_config.cache_clear()
    logmel._device_bases.cache_clear()
    junk = [torch.full((n,), 255, dtype=torch.uint8, device="cuda")
            for n in sizes]
    ref = graphs._clone_state(trainer.state)
    gen = torch.Generator(device="cuda")
    gen.set_state(trainer.generator.get_state())
    ref, ref_loss = eager(ref, *args, gen)
    trainer.state, loss = step(trainer.state, *args, trainer.generator)
    same = torch.equal(loss, ref_loss) and all(
        torch.equal(a, b) for a, b in zip(graphs.state_tensors(trainer.state),
                                          graphs.state_tensors(ref)))
    check(same, f"graphs: with the kernel's caches dropped the {what} "
                "step's replay differs from the eager step")
    del junk
    return len(sizes)


def phase_graphs(root, rng, logmel, clean, augmented, timings, zoo_rows):
    """Phase 14: the one-program train step. (a) The re-seeded registered
    generator against keyed_generator; (b) every optimizer's update with
    device scalars against the host's floats; (c) GRAPH_ZOO through
    fit_fused graphed (the launch count zeroed just before and read just
    after) and eager from one seed, bit for bit (losses, logs, state; a
    second eager run tells a nondeterministic model from a graph fault);
    (d) 3 replays each of the clean and the augmented x-vector step under
    ``torch.cuda.set_sync_debug_mode("error")``: no host synchronization;
    (e) the eager and graphed step times of phases 10 and 8. Returns the
    kernel's launches in (c)'s graphed runs."""
    from lidbox_tpu_torch.data import on_device
    from lidbox_tpu_torch.models.model_utils import ModelWrapper
    from lidbox_tpu_torch.train.loop import to_device

    keys = graph_generator_check(augmented)
    print(f"graphs: one generator registered with a CUDA graph, re-seeded "
          f"before each replay, draws what keyed_generator(device, {SEED}, "
          f"step, 7) draws for steps {keys} (gate, speed, noise, FIR, "
          "SpecAugment)")
    n_opt = graph_optimizer_check()
    print(f"graphs: {n_opt} optimizer configurations, 4 updates each with "
          "the per-step scalars in device buffers == with the host's floats, "
          "bit for bit")

    train = class_sines(rng, GRAPH_BATCHES)
    val = class_sines(rng, 1)
    launches = 0
    torch.backends.cudnn.deterministic = True
    try:
        for key, kw in GRAPH_ZOO:
            name = zoo_name(key, kw)
            runs = []
            for form in ("graphed", "eager", "eager again"):
                config = zoo_config(os.path.join(root, "graphs", form), key,
                                    kw)
                config["experiment"]["feed"] = dict(GRAPH_FEED)
                wrapper = ModelWrapper.from_config(config, device="cuda")
                wrapper.model.init(torch.Generator().manual_seed(SEED))
                recorded = []
                with contextlib.ExitStack() as stack:
                    stack.enter_context(recording_losses(recorded))
                    if form != "graphed":
                        stack.enter_context(eager_steps())
                    counted = stack.enter_context(launch_window())
                    history = wrapper.fit_fused(
                        lambda: train, epochs=GRAPH_EPOCHS,
                        val_signal_batches=lambda: val, verbose=False)
                    torch.cuda.synchronize()
                if form == "graphed":
                    n = counted["logmel_kernel"]
                    expected = (GRAPH_EPOCHS * GRAPH_BATCHES + 1
                                + counted["warmup"])
                    check(n == expected, f"graphs {name}: {n} kernel "
                          f"launches over the graphed fit, not {expected}")
                    launches += n
                runs.append((step_losses_of(recorded), history,
                             wrapper.trainer))
                if form == "eager":
                    try:
                        n_state = check_same_run(runs[0], runs[1],
                                                 f"graphs {name}")
                        break
                    except RuntimeError as fault:
                        failure = fault  # decided after another eager run
            else:
                same = runs[1][0] == runs[2][0]
                raise RuntimeError(
                    f"{failure}; a second eager run "
                    + ("gives the first one's losses: the graph differs"
                       if same else "differs from the first: the model's "
                       "eager steps are not deterministic"))
            losses = runs[0][0]
            print(f"graphs {name}: fit_fused {GRAPH_EPOCHS} epochs of "
                  f"{GRAPH_BATCHES} batches ({GRAPH_FEED}) graphed == eager "
                  f"bit for bit: {len(losses)} step losses (last "
                  f"{losses[-1]!r}), epoch logs, {n_state} state tensors "
                  f"(BatchNorm statistics included); {expected} kernel "
                  "launches")
    finally:
        torch.backends.cudnn.deterministic = False

    # deterministic cuDNN: the graphs below are held to eager steps bit for
    # bit (graph_operands_check)
    torch.backends.cudnn.deterministic = True
    try:
        for what, wrapper, inputs in (
                ("clean", clean, lambda t: (
                    to_device(timings["clean_batch"][0], t.device),
                    to_device(timings["clean_batch"][1].astype(np.int64),
                              t.device))),
                ("augmented", augmented, lambda t: (
                    to_device(on_device.pack_targets_int16(
                        on_device.stage_signals(
                            timings["augmented_batch"][0], "int16"),
                        timings["augmented_batch"][1].astype(np.int64)),
                        t.device), None))):
            trainer = wrapper.trainer
            feature_fn = on_device.feature_fn_from_config(
                RATE, wrapper.config["features"], device=trainer.device)
            step = on_device.make_fused_train_step(trainer, feature_fn)
            program = trainer._programs["fused"][2]
            args = inputs(trainer)
            for _ in range(2):  # capture
                trainer.state, _ = step(trainer.state, *args,
                                        trainer.generator)
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                for _ in range(3):
                    trainer.state, loss = step(trainer.state, *args,
                                               trainer.generator)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            check(np.isfinite(float(loss)),
                  f"graphs: {what} replays not finite")
            print(f"graphs: 3 replays of the {what} step under "
                  "set_sync_debug_mode('error'): no host synchronization")
            eager = on_device.make_fused_train_step(trainer, feature_fn,
                                                    eager=True)
            n_held = graph_operands_check(logmel, trainer, program, step,
                                          eager, args, what)
            print(f"graphs: the captured {what} step holds the kernel's "
                  f"{n_held} cached operand tiles; with the caches dropped "
                  "and their sizes allocated anew (0xFF bytes), a replay "
                  "equals the eager step bit for bit")
    finally:
        torch.backends.cudnn.deterministic = False

    for what in ("clean", "augmented"):
        forms = timings[what]["forms"]
        print(f"graphs, phase 10 {what} step [32, 48000] ({card_line()}): "
              + "; ".join(f"{form} " + ", ".join(
                  f"{m:.4f} ms ({1 - b / m:.1%} idle)" for m, _, b, _ in runs)
                          for form, runs in forms.items()))
    print("graphs, phase 8 train steps at [32, 298, 64], eager -> graphed "
          "ms: " + "; ".join(f"{r['config']} {r['train_step_ms']:.3f} -> "
                            f"{r['graphed_step_ms']:.3f}" for r in zoo_rows))
    return launches


# Data parallelism (phase 11): the x-vector and crnn through fit_fused, 3
# steps of [32, 48000] and 1 validation batch (a stream of its own, seed
# 1239): mesh-less and on a 1-rank NCCL mesh in this process, then on 2
# ranks sharing the card over gloo (NCCL refuses one card twice), each
# feeding its [16, 48000] rows of every batch.
DP_KEYS = ("xvector", "crnn")
DP_STEPS, DP_BATCH, DP_SECONDS = 3, TRAIN_BATCH, TRAIN_SECONDS
DP_RANKS, DP_WAVS = 2, 8
DP_RTOL = 1e-3
DP_COLLECTIVE_TIMEOUT_S, DP_RANK_TIMEOUT_S = 120, 420


def dp_config(root, key, name):
    """The training phase's config for ``key``, with Adam's epsilon at
    1e-4 (as tests/test_torch_train.py): two ranks sum the gradient in
    another order than one process, and with Keras' 1e-7 Adam's first
    updates (about lr * sign(g)) turn that float32 noise into 1e-4 to
    1e-3 of loss wherever a gradient sits near zero (crnn, on the card)."""
    config = train_config(root)
    config["experiment"].update(
        name=name, model={"key": key},
        optimizer={"cls": "Adam", "kwargs": {"learning_rate": 1e-3,
                                             "epsilon": 1e-4}})
    return config


def dp_fit(root, key, name, train, val, mesh=None, device="cuda"):
    """fit_fused of ``key`` (weights from SEED) for one epoch of ``train``
    with ``val`` validating (``fit_wrapper``)."""
    from lidbox_tpu_torch.models.model_utils import ModelWrapper
    return fit_wrapper(ModelWrapper.from_config(dp_config(root, key, name),
                                                mesh=mesh, device=device),
                       train, val, mesh, device)


def fit_wrapper(wrapper, train, val, mesh, device):
    """fit_fused of ``wrapper`` (weights from SEED) for one epoch of
    ``train`` with ``val`` validating: (step losses, epoch logs, the
    kernel's launches over the fit, the wrapper). Under a mesh of several
    ranks each rank feeds its rows of every batch
    (``parallel.local_batches``)."""
    from lidbox_tpu_torch import parallel
    from lidbox_tpu_torch.train import graphs
    wrapper.model.init(torch.Generator().manual_seed(SEED))
    losses = []
    # the fused step is captured once, unless it runs eagerly by rule (a
    # mesh of several ranks)
    captures = ([] if graphs.eager_reason(wrapper.trainer)
                else [np.shape(train[0][0])])
    feed, val_feed = (lambda: train), (lambda: val)
    if parallel.mesh_spans_processes(mesh):
        feed = parallel.local_batches(train, mesh)
        val_feed = parallel.local_batches(val, mesh)
    with recording_losses(losses), launch_window(
            device, captures=captures) as counted:
        history = wrapper.fit_fused(feed, epochs=1, verbose=False,
                                    val_signal_batches=val_feed)
        sync(device)
    launches = counted["logmel_kernel"]
    # a step and a validation batch each, and the capture warm-ups (the
    # steps of a mesh of several ranks run eagerly: none)
    expected = len(train) + len(val) + counted["warmup"]
    check(launches == expected or device != "cuda",
          f"fit_fused launched the kernel {launches} times, not {expected}")
    return step_losses_of(losses), history[0], launches, wrapper


def dp_digest(tensors):
    """A 60-bit digest of a dict of tensors' bytes, in key order."""
    import hashlib
    h = hashlib.sha256()
    for k in sorted(tensors):
        h.update(tensors[k].detach().cpu().contiguous().numpy().tobytes())
    return int(h.hexdigest()[:15], 16)


def dp_step_ms(wrapper, signals, targets, steps=8, warmup=3):
    """The median fused train step (features + forward, backward, the
    collectives and the update) on CUDA events."""
    from lidbox_tpu_torch.data import on_device
    from lidbox_tpu_torch.train.loop import to_device
    trainer = wrapper.trainer
    step = on_device.make_fused_train_step(
        trainer, on_device.feature_fn_from_config(RATE,
                                                  wrapper.config["features"]))
    x = to_device(signals, trainer.device)
    y = to_device(targets.astype(np.int64), trainer.device)
    state, times = trainer.state, []
    for i in range(warmup + steps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        state, _ = step(state, x, y, trainer.generator)
        end.record()
        torch.cuda.synchronize()
        if i >= warmup:
            times.append(start.elapsed_time(end))
    return float(np.median(times))


def dp_allreduce_ms(mesh, numel, reps=10):
    """The median all-reduce of a float32 buffer of ``numel`` (the
    gradient's bucket) over the mesh's device group, on CUDA events."""
    import torch.distributed as dist
    buf = torch.zeros(numel, device=mesh.device)
    times = []
    for i in range(reps + 2):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        dist.all_reduce(buf, group=mesh.group)
        end.record()
        torch.cuda.synchronize()
        if i >= 2:
            times.append(start.elapsed_time(end))
    return float(np.median(times))


def dp_guard_ms(mesh, reps=20):
    """The feed-parity guard's per-step agreement: one allgather of two
    int64 over the CPU group, median on the host clock."""
    from lidbox_tpu_torch import parallel
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        parallel.host_allgather(np.int64([1, 0]), mesh)
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def dp_classifier(mesh, device):
    from lidbox_tpu_torch import models, serve
    model = models.create("xvector", (None, 64), len(LABELS),
                          device=device).init(
        torch.Generator().manual_seed(SEED))
    return serve.Classifier(model, LABELS, feature_config=FEATURES_PALLAS,
                            batch_size=DP_WAVS, mesh=mesh, device=device)


def dp_rank_main(workdir):
    """One rank of phase 11b (``chip_smoke.py --dp-rank DIR``, started by
    phase_data_parallel with the launcher variables): both models through
    fit_fused on this rank's rows, digests of the parameters and batch
    statistics, this rank's training batch held to the plain version,
    serve.Classifier(mesh=), the collectives' times and an uneven feed.
    Writes dp_rank<r>.json to DIR."""
    from lidbox_tpu_torch import parallel
    from lidbox_tpu_torch.ops import logmel
    device = os.environ["LIDBOX_SMOKE_DEVICE"]
    on_card = device == "cuda"
    if on_card:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
    parallel.initialize_distributed(backend="gloo",
                                    device="cuda:0" if on_card else "cpu",
                                    timeout=DP_COLLECTIVE_TIMEOUT_S)
    mesh = parallel.get_mesh()
    data = np.load(os.path.join(workdir, "dp_data.npz"))
    train = list(zip(data["train_x"], data["train_y"]))
    val = list(zip(data["val_x"], data["val_y"]))
    out = {"rank": mesh.rank, "size": mesh.size, "allreduce_ms": {}}
    for key in DP_KEYS:
        losses, logs, launches, wrapper = dp_fit(
            workdir, key, f"dp2_{key}", train, val, mesh, device)
        state = wrapper.trainer.state
        out[key] = {
            "losses": losses, "val_loss": logs["val_loss"],
            "val_C_avg": logs["val_C_avg"], "launches": launches,
            "params": parallel.host_allgather(
                np.int64(dp_digest(state.params)), mesh)[:, 0].tolist(),
            "stats": parallel.host_allgather(
                np.int64(dp_digest(state.batch_stats)), mesh)[:, 0].tolist(),
            "num_stats": len(state.batch_stats)}
        if on_card:
            x, y = parallel.local_slice(train[0], mesh)[:2]
            out[key]["step_ms"] = dp_step_ms(wrapper, x, y)
            numel = sum(p.numel() for p in state.params.values())
            out["allreduce_ms"][f"{numel * 4 / 1e6:.2f} MB ({key})"] = \
                dp_allreduce_ms(mesh, numel)
    clf = dp_classifier(mesh, device)
    paths = [os.path.join(workdir, f"dp{i}.wav") for i in range(DP_WAVS)]
    with launch_window(device, captures=[served_shape(DP_WAVS, 3 * RATE)]
                       ) as counted:
        scores = clf.scores(paths, ids=[f"dp{i}" for i in range(DP_WAVS)])
        sync(device)
    out["serve_launches"] = counted["logmel_kernel"]
    out["serve_warmup"] = counted["warmup"]
    out["scores"] = np.asarray(scores["prediction"]).tolist()
    if on_card:
        out["kernel_err"] = compare(
            logmel, f"rank {mesh.rank} training batch",
            torch.as_tensor(parallel.local_slice(train[0], mesh)[0],
                            device="cuda"), RATE, KERNEL_KW)
        out["guard_ms"] = dp_guard_ms(mesh)
    # an uneven feed: rank 0 has a third batch, rank 1 two
    from lidbox_tpu_torch.models.model_utils import ModelWrapper
    wrapper = ModelWrapper.from_config(dp_config(workdir, "xvector",
                                                 "dp2_uneven"),
                                       mesh=mesh, device=device)
    local = parallel.local_slice(train[0], mesh)
    try:
        wrapper.fit_fused(lambda: [local] * (3 if mesh.rank == 0 else 2),
                          epochs=1, verbose=False)
        out["uneven"] = "no error"
    except RuntimeError as e:
        out["uneven"] = str(e)
    with open(os.path.join(workdir, f"dp_rank{mesh.rank}.json"), "w") as f:
        json.dump(out, f)
    parallel.shutdown_distributed()
    return 0


def dp_start_ranks(workdir, device, flag="--dp-rank", ranks=DP_RANKS):
    """Start ``ranks`` copies of this script with ``flag`` (``--dp-rank``,
    ``--dp-nccl-probe``, ``--tp-rank``) as the ranks of a group that
    rendezvous through a file under ``workdir``."""
    env = dict(os.environ, LIDBOX_SMOKE_DEVICE=device,
               PYTHONPATH=os.path.dirname(os.path.abspath(__file__)),
               COORDINATOR_ADDRESS="file://" + os.path.join(
                   workdir, f"{flag[2:]}_store"),
               NUM_PROCESSES=str(ranks))
    procs = []
    for rank in range(ranks):
        log = open(os.path.join(workdir, f"{flag[2:]}{rank}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), flag, workdir],
            env=dict(env, PROCESS_ID=str(rank)), stdout=log,
            stderr=subprocess.STDOUT), log))
    return procs


def dp_wait(procs, timeout):
    """The ranks' exit codes; every rank still running at ``timeout`` (or
    after another's failure) is killed."""
    codes = []
    deadline = time.perf_counter() + timeout
    try:
        for p, _ in procs:
            try:
                codes.append(p.wait(timeout=max(1.0, deadline
                                                - time.perf_counter())))
            except subprocess.TimeoutExpired:
                codes.append(None)
                break
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    return codes


def dp_nccl_probe_main(workdir):
    """Two NCCL ranks on one card: the group must refuse to start."""
    from lidbox_tpu_torch import parallel
    try:
        parallel.initialize_distributed(device="cuda:0", timeout=60)
    except Exception as e:  # the refusal this probe looks for
        print(f"NCCL_REFUSED {type(e).__name__}: {str(e)[:300]}")
        return 0
    print("NCCL_STARTED")
    parallel.shutdown_distributed()
    return 0


def phase_data_parallel(root, rng, logmel, device="cuda"):
    """Phase 11: (a) both models mesh-less and the x-vector on a 1-rank
    mesh of this process (NCCL on the card), whose step losses and
    validation must equal the mesh-less ones bit for bit; (b) 2 ranks on
    the one card over gloo, each feeding [16, 48000]: their step losses
    within DP_RTOL of (a)'s mesh-less run, parameters and batch statistics
    bit-equal across ranks, one kernel launch per step and validation
    batch on each rank, each rank's batch held to the plain version, and
    serve.Classifier(mesh=) within SERVE_ATOL of the mesh-less scores;
    (c) an uneven feed raises on both ranks. Returns (launches, the
    kernel's worst error on the ranks' batches).

    ``device="cpu"`` rehearses it on the plain version over gloo (set
    DP_BATCH and DP_SECONDS small first); the NCCL mesh, the launch
    counts, the kernel check and the timing need the card."""
    from lidbox_tpu_torch import parallel
    from lidbox_tpu_torch.features import io
    on_card = device == "cuda"
    train = class_sines(rng, DP_STEPS, DP_BATCH, DP_SECONDS)
    val = class_sines(rng, 1, DP_BATCH, DP_SECONDS)
    workdir = os.path.join(root, "dp")
    os.makedirs(workdir)
    np.savez(os.path.join(workdir, "dp_data.npz"),
             train_x=np.stack([x for x, _ in train]),
             train_y=np.stack([y for _, y in train]),
             val_x=np.stack([x for x, _ in val]),
             val_y=np.stack([y for _, y in val]))
    paths = []
    for i, sig in enumerate(noisy_sines(rng, DP_WAVS, 3.0, RATE)):
        paths.append(os.path.join(workdir, f"dp{i}.wav"))
        io.write_mono_wav(paths[-1], sig, RATE)
    print(f"data parallel: seed {SEED + 5}, {DP_STEPS} steps of "
          f"[{DP_BATCH}, {int(RATE * DP_SECONDS)}] + 1 validation batch")

    # (a) mesh-less, then a 1-rank mesh in this process
    ref, launches = {}, 0
    for key in DP_KEYS:
        ref[key] = dp_fit(root, key, f"dp0_{key}", train, val, None, device)
        launches += ref[key][2]  # checked by fit_wrapper
    mesh = parallel.get_mesh(device=device)
    check(mesh.size == 1, f"a {mesh.size}-rank group in this process")
    losses1, logs1, launches1, wrapper1 = dp_fit(
        root, "xvector", "dp1_xvector", train, val, mesh, device)
    launches += launches1
    losses0, logs0 = ref["xvector"][:2]
    check(losses1 == losses0 and logs1["val_loss"] == logs0["val_loss"]
          and logs1["val_C_avg"] == logs0["val_C_avg"],
          f"1-rank mesh: step losses {losses1}, val {logs1} != mesh-less "
          f"{losses0}, {logs0}")
    print(f"data parallel (a): 1-rank {mesh.backend} mesh step losses "
          f"{losses1} == mesh-less {losses0}; val_loss "
          f"{logs1['val_loss']!r} == {logs0['val_loss']!r}")
    timing = {}
    if on_card:
        numel = sum(p.numel() for p in wrapper1.trainer.state.params.values())
        timing["allreduce_1"] = dp_allreduce_ms(mesh, numel)
        x, y = train[0]
        timing["step_meshless"] = dp_step_ms(ref["xvector"][3], x, y)
        timing["step_mesh1"] = dp_step_ms(wrapper1, x, y)
        timing["crnn_meshless"] = dp_step_ms(ref["crnn"][3], x, y)
        print(f"data parallel timing (a): NCCL all-reduce of the "
              f"{numel * 4 / 1e6:.2f} MB gradient bucket at 1 rank "
              f"{timing['allreduce_1']:.4f} ms; x-vector fused train step "
              f"[{DP_BATCH}, {int(RATE * DP_SECONDS)}] mesh-less "
              f"{timing['step_meshless']:.4f} ms, 1-rank mesh "
              f"{timing['step_mesh1']:.4f} ms; crnn mesh-less "
              f"{timing['crnn_meshless']:.4f} ms (CUDA events, medians)")
    scores0 = dp_classifier(None, device).scores(
        paths, ids=[f"dp{i}" for i in range(DP_WAVS)])["prediction"]
    parallel.shutdown_distributed()

    # (b) two ranks on the card over gloo, and (c) an uneven feed
    if on_card:
        torch.cuda.empty_cache()  # the card's memory for the ranks
    t0 = time.perf_counter()
    codes = dp_wait(dp_start_ranks(workdir, device), DP_RANK_TIMEOUT_S)
    if codes != [0] * DP_RANKS:
        for r in range(DP_RANKS):
            with open(os.path.join(workdir, f"dp-rank{r}.log")) as f:
                print(f"--- rank {r} ---\n" + f.read()[-4000:])
        check(False, f"data parallel ranks exited {codes}")
    ranks = []
    for r in range(DP_RANKS):
        with open(os.path.join(workdir, f"dp_rank{r}.json")) as f:
            ranks.append(json.load(f))
    print(f"data parallel (b): {DP_RANKS} ranks on one card over gloo in "
          f"{time.perf_counter() - t0:.1f} s")
    err = 0.0
    for key in DP_KEYS:
        losses0, logs0 = ref[key][:2]
        for out in ranks:
            ours = out[key]
            rel = max(abs(a - b) / abs(b) for a, b in zip(ours["losses"],
                                                          losses0))
            check(len(ours["losses"]) == DP_STEPS and rel <= DP_RTOL,
                  f"{key} rank {out['rank']}: step losses {ours['losses']} "
                  f"vs one process {losses0} (rel {rel})")
            vrel = abs(ours["val_loss"] - logs0["val_loss"]) / abs(
                logs0["val_loss"])
            check(vrel <= DP_RTOL, f"{key}: val_loss {ours['val_loss']} vs "
                                   f"{logs0['val_loss']}")
            check(len(set(ours["params"])) == 1 and len(set(ours["stats"]))
                  == 1, f"{key}: replicas differ: parameter digests "
                        f"{ours['params']}, statistics {ours['stats']}")
            check(ours["launches"] == DP_STEPS + 1 or not on_card,
                  f"{key} rank {out['rank']}: {ours['launches']} kernel "
                  f"launches, not {DP_STEPS + 1}")
            launches += ours["launches"]
        rel = max(abs(a - b) / abs(b) for out in ranks
                  for a, b in zip(out[key]["losses"] + [out[key]["val_loss"]],
                                  losses0 + [logs0["val_loss"]]))
        print(f"data parallel (b) {key}: max rel diff {rel:.3e} from one "
              f"process (rtol {DP_RTOL}); step losses rank 0 "
              f"{ranks[0][key]['losses']} rank 1 {ranks[1][key]['losses']} "
              f"vs one process {losses0} (rtol {DP_RTOL}); val_loss "
              f"{ranks[0][key]['val_loss']!r} vs {logs0['val_loss']!r}; "
              f"parameters bit-equal across ranks, "
              f"{ranks[0][key]['num_stats']} batch statistics bit-equal; "
              f"kernel launches per rank "
              f"{[out[key]['launches'] for out in ranks]}")
    for out in ranks:
        s_err = np.abs(np.asarray(out["scores"]) - scores0).max()
        check(s_err <= SERVE_ATOL, f"rank {out['rank']}: Classifier(mesh=) "
                                   f"scores {s_err} from the mesh-less ones")
        check(out["serve_launches"] == 1 + out["serve_warmup"]
              or not on_card,
              f"serving launched the kernel {out['serve_launches']} times, "
              f"not 1 + {out['serve_warmup']} capture warm-ups")
        launches += out["serve_launches"]
        check("uneven multi-process training feed" in out["uneven"]
              and "after 2 batches" in out["uneven"],
              f"rank {out['rank']}: uneven feed gave {out['uneven']!r}")
        if on_card:
            err = max(err, out["kernel_err"])
    print(f"data parallel (b): Classifier(mesh=) scores within "
          f"{max(np.abs(np.asarray(o['scores']) - scores0).max() for o in ranks):.3e}"
          f" of the mesh-less ones (tolerance {SERVE_ATOL}); (c) an uneven "
          f"feed raised on both ranks: {ranks[0]['uneven'][:80]!r}")
    if on_card:
        errs = ", ".join(f"{o['kernel_err']:.3e}" for o in ranks)
        print(f"data parallel (b): each rank's [{DP_BATCH // DP_RANKS}, "
              f"{int(RATE * DP_SECONDS)}] training batch, fused_logmel vs "
              f"logmel_plain float32 max abs err {errs} (atol {F32_ATOL} + "
              f"rtol {F32_RTOL})")
        print(f"data parallel timing (b): gloo all-reduce of the gradient "
              f"bucket at 2 ranks, ms per rank: "
              + "; ".join(f"{k} {[round(o['allreduce_ms'][k], 4) for o in ranks]}"
                          for k in ranks[0]["allreduce_ms"])
              + "; guard "
              f"allgather {[round(o['guard_ms'], 4) for o in ranks]} ms per "
              f"step; fused train step [{DP_BATCH // DP_RANKS}, "
              f"{int(RATE * DP_SECONDS)}] per rank: x-vector "
              f"{[round(o['xvector']['step_ms'], 4) for o in ranks]} ms, "
              f"crnn {[round(o['crnn']['step_ms'], 4) for o in ranks]} ms "
              "(CUDA events, medians)")
        codes = dp_wait(dp_start_ranks(workdir, device,
                                       flag="--dp-nccl-probe"), 90)
        seen = []
        for r in range(DP_RANKS):
            with open(os.path.join(workdir, f"dp-nccl-probe{r}.log")) as f:
                seen += [l.strip() for l in f if l.startswith("NCCL_")]
        print(f"data parallel: 2 NCCL ranks on one card: exit codes {codes}, "
              f"{seen[:2]}")
    return launches, err



# Tensor parallelism (phase 12): the full-width x-vector through fit_fused,
# 3 steps of [32, 48000] and 1 validation batch (a stream of its own, seed
# 1240), over a 2-D (data, model) mesh with the column-parallel rule:
# mesh-less, on a 1 x 1 NCCL mesh in this process and on 1 x 2 over gloo
# (two ranks of this script sharing the card), with remat and the DSP split
# modes beside it.
TP_STEPS, TP_BATCH, TP_SECONDS = 3, TRAIN_BATCH, TRAIN_SECONDS
TP_RANKS = 2
TP_RTOL = 1e-3
# Adam at 1e-4 (epsilon 1e-4, dp_config's): at 1e-3 the x-vector's first
# steps on this stream overshoot (the loss rises at step 2), and one
# process's validation after 3 steps moved by 2.3e-5 under a one-ulp
# change of its features on the CPU, 1.3e-6 at 1e-4: at 1e-3 the
# comparison reads the trajectory's amplification of float32 rounding,
# not the mesh (on an H100 at 1e-3 the 2-rank validation read 1.2e-3 from
# one process, its step losses 1.6e-6).
TP_LEARNING_RATE = 1e-4
REMAT_RTOL = 1e-6
# the JAX package's budget for its split modes: a log-Mel error of about
# 1.5e-3 against float64 (lidbox_tpu/features/audio.py:199-210)
SPLIT_BUDGET = 1.5e-3
TP_COLLECTIVE_TIMEOUT_S, TP_RANK_TIMEOUT_S = 120, 300


def tp_wrapper(root, name, mesh=None, device="cuda", remat=False,
               dropout=0.0):
    """The x-vector's wrapper (channel dropout ``dropout``, Adam at
    TP_LEARNING_RATE) with ``remat``; on a ``mesh`` (a 1-D mesh replicates
    the parameters, a 2-D one splits them with
    ``parallel.column_parallel_rule``)."""
    from lidbox_tpu_torch import parallel
    from lidbox_tpu_torch.models.model_utils import ModelWrapper
    from lidbox_tpu_torch.train.loop import Trainer
    config = dp_config(root, "xvector", name)
    config["experiment"]["model"]["kwargs"] = {
        "channel_dropout_rate": dropout}
    config["experiment"]["optimizer"]["kwargs"]["learning_rate"] = \
        TP_LEARNING_RATE
    wrapper = ModelWrapper.from_config(config, device=device)
    t = wrapper.trainer
    if mesh is not None:
        wrapper.trainer = Trainer(
            t.model, t.optimizer, t.loss_fn, metrics=t.metrics, mesh=mesh,
            param_sharding=parallel.column_parallel_rule(mesh)
            if parallel.MODEL_AXIS in mesh.axis_names else None,
            device=device)
    wrapper.trainer.remat = remat
    return wrapper


def tp_fit(root, name, train, val, mesh=None, device="cuda", remat=False,
           dropout=0.0):
    """fit_wrapper's run of ``tp_wrapper``: (step losses, epoch logs, the
    kernel's launches over the fit, the wrapper)."""
    return fit_wrapper(tp_wrapper(root, name, mesh, device, remat, dropout),
                       train, val, mesh, device)


def tp_collectives(wrapper, signals, targets):
    """One fused train step with every model-group collective timed on
    CUDA events: (gather ms, gathered MB, all-reduce ms, all-reduced MB).
    Each collective is synchronized alone, so the step itself is slower
    than a plain one."""
    import torch.distributed as dist
    from lidbox_tpu_torch import parallel
    gather, reduce = parallel.all_gather_rows, dist.all_reduce
    spent = {"gather": [0.0, 0], "reduce": [0.0, 0]}

    def timed(kind, fn, nbytes):
        def run(x, *args, **kw):
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            out = fn(x, *args, **kw)
            end.record()
            end.synchronize()
            spent[kind][0] += start.elapsed_time(end)
            spent[kind][1] += nbytes(x, out)
            return out
        return run

    parallel.all_gather_rows = timed(
        "gather", gather, lambda x, out: out.numel() * out.element_size())
    dist.all_reduce = timed(
        "reduce", reduce, lambda x, out: x.numel() * x.element_size())
    try:
        dp_step_ms(wrapper, signals, targets, steps=1, warmup=0)
    finally:
        parallel.all_gather_rows, dist.all_reduce = gather, reduce
    return (spent["gather"][0], spent["gather"][1] / 1e6,
            spent["reduce"][0], spent["reduce"][1] / 1e6)


def tp_rank_main(workdir):
    """One rank of phase 12b (``chip_smoke.py --tp-rank DIR``): the
    x-vector through fit_fused on a 1 x 2 (data, model) mesh over gloo,
    digests of its synced weights and of its first batch's features, that
    batch held to the plain version, and the step and its collectives
    timed. Writes tp_rank<r>.json to DIR."""
    from lidbox_tpu_torch import parallel
    from lidbox_tpu_torch.ops import logmel
    device = os.environ["LIDBOX_SMOKE_DEVICE"]
    on_card = device == "cuda"
    if on_card:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
    parallel.initialize_distributed(backend="gloo",
                                    device="cuda:0" if on_card else "cpu",
                                    timeout=TP_COLLECTIVE_TIMEOUT_S)
    mesh = parallel.get_mesh_2d(data_size=1, model_size=TP_RANKS)
    data = np.load(os.path.join(workdir, "tp_data.npz"))
    train = list(zip(data["train_x"], data["train_y"]))
    val = list(zip(data["val_x"], data["val_y"]))
    losses, logs, launches, wrapper = tp_fit(workdir, "tp2", train, val,
                                             mesh, device)
    trainer = wrapper.trainer
    x = torch.as_tensor(parallel.local_slice(train[0], mesh)[0],
                        device=trainer.device)
    feats = logmel.fused_logmel(x, RATE, **KERNEL_KW)
    out = {"rank": mesh.rank, "coords": [mesh.data_index, mesh.model_index],
           "losses": losses, "val_loss": logs["val_loss"],
           "val_C_avg": logs["val_C_avg"], "launches": launches,
           "split": sorted(trainer.param_specs),
           "shards": {k: list(trainer.state.params[k].shape)
                      for k in trainer.param_specs},
           "weights": parallel.host_allgather(np.int64(dp_digest(
               wrapper.model.module.state_dict())), mesh)[:, 0].tolist(),
           "features": parallel.host_allgather(np.int64(dp_digest(
               {"f": feats})), mesh)[:, 0].tolist()}
    if on_card:
        y = parallel.local_slice(train[0], mesh)[1]
        out["kernel_err"] = compare(logmel, f"tp rank {mesh.rank} batch", x,
                                    RATE, KERNEL_KW)
        out["step_ms"] = dp_step_ms(wrapper, x.cpu().numpy(), y, steps=5,
                                    warmup=2)
        out["collectives"] = tp_collectives(wrapper, x.cpu().numpy(), y)
    with open(os.path.join(workdir, f"tp_rank{mesh.rank}.json"), "w") as f:
        json.dump(out, f)
    parallel.shutdown_distributed()
    return 0


def tp_gather_mb(batch, samples):
    """The activations the x-vector's column-parallel layers gather per
    forward, from its shapes: frame layers of 512, 512, 512, 512 and 1500
    channels over the frames each leaves (strides 1, 2, 3, 1, 1), then
    segment1 and segment2 (512 each), float32, in MB."""
    frames = 1 + (samples - 400) // 160
    f2 = -(-frames // 2)
    f3 = -(-f2 // 3)
    per_row = (512 * frames + 512 * f2 + 512 * f3 * 2 + 1500 * f3
               + 512 * 2)
    return 4 * batch * per_row / 1e6


def phase_tensor_parallel(root, rng, logmel, device="cuda"):
    """Phase 12: (a) the x-vector mesh-less and on a 1 x 1 NCCL mesh with
    the column-parallel rule in this process: equal step losses and
    validation; with remat (channel dropout 0.5) against the plain step
    (REMAT_RTOL); the split DSP modes' log-Mel of a training batch against
    float64 (SPLIT_BUDGET) and their pallas request on the matmul path;
    (b) 2 ranks on the card over gloo as data 1 x model 2, each on the
    whole batch: step losses and validation within TP_RTOL of (a)'s
    mesh-less run, the synced weights and the first batch's features
    bit-equal across the ranks, one kernel launch per step and validation
    batch on each rank, each rank's batch held to the plain version, and
    the step and its model-group collectives timed. Returns (launches,
    the kernel's worst error on the ranks' batches).

    ``device="cpu"`` rehearses it on the plain version over gloo (set
    TP_BATCH and TP_SECONDS small first); the NCCL mesh, the launch
    counts, the kernel check and the timing need the card."""
    from lidbox_tpu_torch import features, parallel
    on_card = device == "cuda"
    train = class_sines(rng, TP_STEPS, TP_BATCH, TP_SECONDS)
    val = class_sines(rng, 1, TP_BATCH, TP_SECONDS)
    workdir = os.path.join(root, "tp")
    os.makedirs(workdir)
    np.savez(os.path.join(workdir, "tp_data.npz"),
             train_x=np.stack([x for x, _ in train]),
             train_y=np.stack([y for _, y in train]),
             val_x=np.stack([x for x, _ in val]),
             val_y=np.stack([y for _, y in val]))
    samples = int(RATE * TP_SECONDS)
    print(f"tensor parallel: seed {SEED + 6}, {TP_STEPS} steps of "
          f"[{TP_BATCH}, {samples}] + 1 validation batch")

    # (a) mesh-less, a 1 x 1 mesh, remat, the split modes
    losses0, logs0, launches, wrapper0 = tp_fit(root, "tp0", train, val,
                                                None, device)
    # fit_wrapper checked the launches: TP_STEPS + 1 and the warm-ups
    # the comparison's floor: one process on signals one ulp away
    nudged = [(x * np.float32(1 + 2 ** -23), y) for x, y in train]
    losses_u, logs_u, n, _ = tp_fit(root, "tp_ulp", nudged, val, None,
                                    device)
    launches += n
    floor = max(abs(a - b) / abs(b) for a, b in zip(
        losses_u + [logs_u["val_loss"]], losses0 + [logs0["val_loss"]]))
    mesh = parallel.get_mesh_2d(data_size=1, model_size=1, device=device)
    losses1, logs1, n, wrapper1 = tp_fit(root, "tp1", train, val, mesh,
                                         device)
    launches += n
    check(losses1 == losses0 and logs1["val_loss"] == logs0["val_loss"],
          f"1 x 1 mesh: step losses {losses1}, val {logs1['val_loss']} != "
          f"mesh-less {losses0}, {logs0['val_loss']}")
    print(f"tensor parallel (a): 1 x 1 {mesh.backend} mesh with the "
          f"column-parallel rule ({len(wrapper1.trainer.param_specs)} "
          f"parameters split) step losses {losses1} == mesh-less {losses0}; "
          f"val_loss {logs1['val_loss']!r} == {logs0['val_loss']!r}")
    remat = {}
    for on in (False, True):
        remat[on] = tp_fit(root, f"tp_remat{int(on)}", train, val, None,
                           device, remat=on, dropout=0.5)
        launches += remat[on][2]
    rel = max(abs(a - b) / abs(b) for a, b in zip(remat[True][0],
                                                  remat[False][0]))
    check(rel <= REMAT_RTOL, f"remat step losses {remat[True][0]} vs plain "
                             f"{remat[False][0]} (rel {rel})")
    print(f"tensor parallel (a): remat with channel dropout 0.5, step "
          f"losses {remat[True][0]} vs plain {remat[False][0]}: max rel "
          f"diff {rel:.3e} (rtol {REMAT_RTOL})")
    x = torch.as_tensor(train[0][0], device=device)
    exact = logmel_f64(logmel, x, RATE, KERNEL_KW) if on_card else None
    split = {}
    for mode in ("highest", "bf16_3x", "bf16_6x"):
        kw = dict(feature_type="logmelspectrogram", precision=mode,
                  melspectrogram=KERNEL_KW)
        out = features.extract_features(x, RATE, stft_method="matmul", **kw)
        if mode != "highest":
            logmel.reset_launch_counts(device)
            routed = features.extract_features(x, RATE, stft_method="pallas",
                                               **kw)
            check(logmel.launch_counts(device)["logmel_kernel"] == 0
                  and torch.equal(routed, out),
                  f"{mode}: the pallas request did not take the matmul path")
        if on_card:
            err = (out.double() - exact).abs().max().item()
            check(mode == "highest" or err <= SPLIT_BUDGET,
                  f"{mode}: log-Mel {err} from float64 (budget "
                  f"{SPLIT_BUDGET})")
            split[mode] = (err, cuda_ms(lambda: features.extract_features(
                x, RATE, stft_method="matmul", **kw), reps=3, iters=5))
        else:
            split[mode] = (float("nan"), float("nan"))
    print("tensor parallel (a): DSP modes on the matmul path at "
          f"[{TP_BATCH}, {samples}], max abs log-Mel error vs float64 "
          f"(budget {SPLIT_BUDGET} for the split modes) and ms (CUDA "
          "events): " + "; ".join(f"{m} {e:.3e} {t:.4f} ms"
                                  for m, (e, t) in split.items())
          + "; a pallas request in a split mode takes the matmul path")
    timing = {}
    if on_card:
        x, y = train[0]
        timing["meshless"] = dp_step_ms(wrapper0, x, y)
        timing["mesh11"] = dp_step_ms(wrapper1, x, y)
        timing["remat"] = dp_step_ms(remat[True][3], x, y)
        timing["plain_dropout"] = dp_step_ms(remat[False][3], x, y)
        print(f"tensor parallel timing (a): fused train step [{TP_BATCH}, "
              f"{samples}] model 1: mesh-less {timing['meshless']:.4f} ms, "
              f"1 x 1 mesh {timing['mesh11']:.4f} ms; with channel dropout "
              f"plain {timing['plain_dropout']:.4f} ms, remat "
              f"{timing['remat']:.4f} ms (CUDA events, medians)")
    parallel.shutdown_distributed()

    # (b) 1 x 2 over gloo, two ranks on the card
    if on_card:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    codes = dp_wait(dp_start_ranks(workdir, device, flag="--tp-rank",
                                   ranks=TP_RANKS), TP_RANK_TIMEOUT_S)
    if codes != [0] * TP_RANKS:
        for r in range(TP_RANKS):
            with open(os.path.join(workdir, f"tp-rank{r}.log")) as f:
                print(f"--- rank {r} ---\n" + f.read()[-4000:])
        check(False, f"tensor parallel ranks exited {codes}")
    ranks = []
    for r in range(TP_RANKS):
        with open(os.path.join(workdir, f"tp_rank{r}.json")) as f:
            ranks.append(json.load(f))
    print(f"tensor parallel (b): {TP_RANKS} ranks on one card over gloo "
          f"in {time.perf_counter() - t0:.1f} s")
    err = 0.0
    for out in ranks:
        rel = max(abs(a - b) / abs(b) for a, b in zip(
            out["losses"] + [out["val_loss"]], losses0 + [logs0["val_loss"]]))
        check(len(out["losses"]) == TP_STEPS and rel <= TP_RTOL,
              f"rank {out['rank']}: step losses {out['losses']}, val "
              f"{out['val_loss']} vs one process {losses0}, "
              f"{logs0['val_loss']} (rel {rel})")
        check(len(set(out["weights"])) == 1 and len(set(out["features"]))
              == 1, f"rank {out['rank']}: ranks differ: weights "
                    f"{out['weights']}, features {out['features']}")
        check(out["split"] and all(s[0] * TP_RANKS == dict(
            wrapper0.model.module.named_parameters())[k].shape[0]
            for k, s in out["shards"].items()),
            f"rank {out['rank']}: shards {out['shards']}")
        check(out["launches"] == TP_STEPS + 1 or not on_card,
              f"rank {out['rank']}: {out['launches']} kernel launches, not "
              f"{TP_STEPS + 1}")
        launches += out["launches"]
        if on_card:
            err = max(err, out["kernel_err"])
    rel = max(abs(a - b) / abs(b) for out in ranks for a, b in zip(
        out["losses"] + [out["val_loss"]], losses0 + [logs0["val_loss"]]))
    print(f"tensor parallel (b): 1 x {TP_RANKS} mesh, "
          f"{len(ranks[0]['split'])} parameters split (half of each on a "
          f"rank); max rel diff {rel:.3e} from one process (rtol "
          f"{TP_RTOL}; one process on signals one ulp away: {floor:.3e}); "
          f"step losses rank 0 {ranks[0]['losses']} rank 1 "
          f"{ranks[1]['losses']} vs one process {losses0}; val_loss "
          f"{ranks[0]['val_loss']!r} vs {logs0['val_loss']!r}; synced "
          f"weights and features bit-equal across ranks; kernel launches "
          f"per rank {[o['launches'] for o in ranks]}")
    if on_card:
        gathered = tp_gather_mb(TP_BATCH, samples)
        print(f"tensor parallel (b): each rank's [{TP_BATCH}, {samples}] "
              f"batch, fused_logmel vs logmel_plain float32 max abs err "
              + ", ".join(f"{o['kernel_err']:.3e}" for o in ranks)
              + f" (atol {F32_ATOL} + rtol {F32_RTOL})")
        print(f"tensor parallel timing (b): fused train step [{TP_BATCH}, "
              f"{samples}] model 2: "
              f"{[round(o['step_ms'], 4) for o in ranks]} ms per rank "
              f"(model 1 mesh-less {timing['meshless']:.4f} ms); one "
              "instrumented step, model-group collectives on CUDA events: "
              "gathers " + ", ".join(
                  f"{o['collectives'][0]:.4f} ms / {o['collectives'][1]:.2f} "
                  "MB" for o in ranks)
              + "; all-reduces " + ", ".join(
                  f"{o['collectives'][2]:.4f} ms / {o['collectives'][3]:.2f} "
                  "MB" for o in ranks)
              + f" per rank (the forward's gathers are {gathered:.2f} MB by "
              "the x-vector's shapes; gloo carries them through host "
              "memory, far from what NVLink between cards would give)")
    return launches, err

# Orbax checkpoints and deployment (phase 13): the full-width x-vector
# trained ORBAX_EPOCHS epochs of ORBAX_BATCHES batches of [32, 48000] plus
# ORBAX_VAL validation batches with ModelCheckpoint(backend="orbax"), then
# resumed one epoch; the committed JAX fixture (a narrow x-vector, 40 mel
# bins in, 5 classes, tests/test_torch_orbax.py::make_fixture) served;
# export --platforms held at phase 7's tolerance.
ORBAX_EPOCHS, ORBAX_BATCHES, ORBAX_VAL = 2, 4, 1
ORBAX_BATCH, ORBAX_SECONDS = 32, 3.0
ORBAX_FIXTURE = os.path.join("tests", "data", "orbax_jax_xvector_small",
                             "epoch000002__val_loss0.500000000000")
ORBAX_FIXTURE_FEATURES = {"type": "logmelspectrogram",
                          "melspectrogram": {"num_mel_bins": 40},
                          "stft_method": "pallas"}
ORBAX_WAVS = 4
EXPORT_ATOL = EXPORT_RTOL = 1e-5  # phase 7's export check
# predicted before the first card run (PERF.md): 2 x 4 steps + 1
# validation batch, the live run's and the resumed run's third epoch (4 +
# 1 each), and one served batch of the fixture's 4 wavs
ORBAX_LAUNCHES = (ORBAX_EPOCHS * ORBAX_BATCHES + ORBAX_VAL
                  + 2 * (ORBAX_BATCHES + ORBAX_VAL) + 1)


def narrow_xvector(device):
    """The committed fixture's model: the x-vector's layers and names at
    widths 32 (64 before the pooling), 40 mel bins in, 5 classes."""
    from lidbox_tpu_torch import models
    from lidbox_tpu_torch.models.layers import Dense, FrameLayer
    model = models.create("xvector", (None, 40), len(LABELS), device="cpu")
    m = model.module
    m.frame1, m.frame2 = FrameLayer(40, 32, 5, 1), FrameLayer(32, 32, 3, 2)
    m.frame3, m.frame4 = FrameLayer(32, 32, 3, 3), FrameLayer(32, 32, 1, 1)
    m.frame5 = FrameLayer(32, 64, 1, 1)
    m.segment1, m.segment2 = Dense(128, 32), Dense(32, 32)
    m.outputs = Dense(32, len(LABELS))
    model.module = m.to(device).eval()
    model.device = torch.device(device)
    return model


def state_leaves(state):
    """(name, value) of every part of a train state or raw state dict."""
    get = state.get if isinstance(state, dict) else \
        (lambda k: getattr(state, k))
    out = [("step", int(get("step")))]
    for key in ("params", "batch_stats"):
        out += sorted((f"{key}.{k}", v) for k, v in get(key).items())

    def walk(node, where):
        if isinstance(node, dict):
            for k in node:
                walk(node[k], f"{where}.{k}")
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{where}[{i}]")
        else:
            out.append((where, node))
    walk(get("opt_state"), "opt_state")
    return out


def check_same_state(a, b, what):
    la, lb = state_leaves(a), state_leaves(b)
    check([n for n, _ in la] == [n for n, _ in lb],
          f"{what}: the states' structures differ")
    for (name, x), (_, y) in zip(la, lb):
        if isinstance(x, torch.Tensor):
            check(torch.equal(x.cpu(), y.cpu()), f"{what}: {name} differs")
        else:
            check(x == y, f"{what}: {name} {x} != {y}")
    return len(la)


def phase_orbax(root, rng, logmel, device="cuda"):
    """Phase 13: (a) whether zstandard, orbax and tensorstore import here,
    and the zstd decoder's build; (b) the full-width x-vector through
    ``ModelWrapper.from_config(...).fit_fused`` with
    ``ModelCheckpoint(backend="orbax")`` (a msgpack ModelCheckpoint beside
    it in another directory): the directory names equal the msgpack
    names, the best directory restores into a fresh trainer bit-equal to
    the live state of its epoch, and one epoch resumed from the last
    directory is bit-equal to the live trainer's next epoch; the write,
    its bytes and the read timed; (c) the committed JAX fixture (OCDBT +
    zstd) restored bit-equal to its msgpack copy and served through
    ``serve.Classifier`` on the kernel, the decoder's MB/s; (d) ``export
    --platforms`` from (b)'s best directory through ``cli.main``, the
    program on each device held to the live model there at batch 1, 2
    and 32. Returns (launches, the kernel's worst error).

    ``device="cpu"`` rehearses it on the plain version (set ORBAX_BATCH
    and ORBAX_SECONDS small first); the launch count, the kernel check,
    the cuda platform and the timing need the card."""
    import importlib.util
    import io
    from lidbox_tpu_torch import cli, export, serve
    from lidbox_tpu_torch.features import io as audio_io
    from lidbox_tpu_torch.models.model_utils import (
        ModelWrapper, best_model_checkpoint_from_config,
        experiment_cache_from_config)
    from lidbox_tpu_torch.native import zstd
    from lidbox_tpu_torch.train import checkpoint as ckpt
    from lidbox_tpu_torch.train import orbax
    from lidbox_tpu_torch.train.loop import Callback, ModelCheckpoint

    on_card = device == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    # (a)
    probes = {name: importlib.util.find_spec(name) is not None
              for name in ("zstandard", "orbax", "tensorstore")}
    print("orbax probe: " + ", ".join(
        f"{k} {'imports' if v else 'absent'}" for k, v in probes.items()))
    t0 = time.perf_counter()
    zstd.load_library()
    print(f"orbax: zstd decoder {zstd._LIB} built and loaded in "
          f"{time.perf_counter() - t0:.2f} s")

    # (b)
    train = class_sines(rng, ORBAX_BATCHES, ORBAX_BATCH, ORBAX_SECONDS)
    val = class_sines(rng, ORBAX_VAL, ORBAX_BATCH, ORBAX_SECONDS)
    config = train_config(root)
    config["experiment"]["name"] = "smoke_orbax"
    config["experiment"]["callbacks"] = [{"cls": "ModelCheckpoint", "kwargs": {
        "monitor": "val_loss", "mode": "min", "backend": "orbax"}}]
    resumed_config = copy.deepcopy(config)
    resumed_config["experiment"]["name"] = "smoke_orbax_resumed"

    def wrapper_for(cfg):
        wrapper = ModelWrapper.from_config(cfg, device=device)
        wrapper.model.init(torch.Generator().manual_seed(SEED))
        return wrapper

    class Snapshots(Callback):
        """A copy of the live state at each epoch's end (the train steps
        write the state in place)."""
        def __init__(self):
            self.states = {}

        def on_epoch_end(self, trainer, epoch, logs):
            self.states[epoch] = copy.deepcopy(trainer.state)

    wrapper = wrapper_for(config)
    snaps = Snapshots()
    msgpack_dir = os.path.join(root, "orbax_msgpack")
    wrapper.trainer.callbacks += [ModelCheckpoint(msgpack_dir), snaps]
    step_shape = (ORBAX_BATCH, int(RATE * ORBAX_SECONDS))
    with launch_window(device, captures=[step_shape]) as counted:
        sync()
        t0 = time.perf_counter()
        history = wrapper.fit_fused(lambda: train, epochs=ORBAX_EPOCHS,
                                    val_signal_batches=lambda: val)
        sync()
        fit_s = time.perf_counter() - t0
    launches, warmup = counted["logmel_kernel"], counted["warmup"]
    ckpt_dir = os.path.join(experiment_cache_from_config(config),
                            "checkpoints")
    names = sorted(os.listdir(ckpt_dir))
    check(names == sorted(n[:-len(".ckpt")]
                          for n in os.listdir(msgpack_dir)),
          f"orbax directories {names} differ from the msgpack names "
          f"{sorted(os.listdir(msgpack_dir))}")
    check(len(names) == ORBAX_EPOCHS and all(
        os.path.isdir(os.path.join(ckpt_dir, n)) for n in names),
          f"orbax checkpoints {names}")
    best = best_model_checkpoint_from_config(config)
    epoch = ckpt.initial_epoch_from_path(best)
    fresh = wrapper_for(config)
    fresh.trainer.restore(best)
    n_leaves = check_same_state(fresh.trainer.state, snaps.states[epoch],
                                f"restore of {os.path.basename(best)}")
    print(f"orbax: fit_fused {ORBAX_EPOCHS} epochs in {fit_s:.2f} s, loss "
          + ", ".join(f"{h['loss']:.4f}" for h in history) + "; "
          f"directories {names} (the msgpack names); the best, epoch "
          f"{epoch}, restored bit-equal to the live state ({n_leaves} "
          "leaves: step, params, batch stats, Adam moments)")

    last = os.path.join(ckpt_dir, names[-1])
    resumed = wrapper_for(resumed_config)
    resumed.trainer.restore(last)
    # each fit_fused captures its step anew (fit_signals frees its graphs)
    with launch_window(device, captures=[step_shape] * 2) as counted:
        wrapper.trainer.initial_epoch = ORBAX_EPOCHS
        live_next = wrapper.fit_fused(lambda: train,
                                      epochs=ORBAX_EPOCHS + 1,
                                      val_signal_batches=lambda: val)
        resumed_next = resumed.fit_fused(lambda: train,
                                         epochs=ORBAX_EPOCHS + 1,
                                         val_signal_batches=lambda: val)
        sync()
    launches += counted["logmel_kernel"]
    warmup += counted["warmup"]
    check(len(live_next) == len(resumed_next) == 1
          and live_next[0]["loss"] == resumed_next[0]["loss"]
          and live_next[0]["val_loss"] == resumed_next[0]["val_loss"],
          f"resumed epoch {resumed_next} != the live trainer's {live_next}")
    check_same_state(resumed.trainer.state, wrapper.trainer.state,
                     "the resumed epoch")
    print(f"orbax: epoch {ORBAX_EPOCHS + 1} resumed from {names[-1]}: loss "
          f"{resumed_next[0]['loss']!r}, val_loss "
          f"{resumed_next[0]['val_loss']!r}, bit-equal to the live "
          "trainer's (state included)")

    writer = ckpt.OrbaxCheckpointer()
    state = wrapper.trainer.state
    timed = os.path.join(root, "orbax_timed")
    sync()
    t0 = time.perf_counter()
    path = writer.save(timed, state, epoch=9, val_loss=0.0)
    writer.wait()
    write_s = time.perf_counter() - t0
    nbytes = sum(os.path.getsize(os.path.join(d, f))
                 for d, _, files in os.walk(path) for f in files)
    t0 = time.perf_counter()
    orbax.read_checkpoint(path)
    read_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    raw = ckpt.load_raw_checkpoint(path, params=state.params)
    load_s = time.perf_counter() - t0
    check_same_state(raw, state, "the timed checkpoint")
    t0 = time.perf_counter()
    mpath = ckpt.save_checkpoint(timed, state, epoch=9, val_loss=0.0)
    msave_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ckpt.load_raw_checkpoint(mpath)
    mload_s = time.perf_counter() - t0
    where = card_line() if on_card else "cpu"
    print(f"orbax checkpoint of the full-width x-vector train state on "
          f"{where} (host clock): write {write_s:.3f} s (save() to wait(), "
          f"the device-to-host copy included) for {nbytes} bytes; read "
          f"{read_s:.3f} s (read_checkpoint), {load_s:.3f} s with the "
          f"conversion (load_raw_checkpoint); torch.save checkpoint "
          f"{msave_s:.3f} s, its load {mload_s:.3f} s")

    # (c)
    fixture = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           ORBAX_FIXTURE)
    t0 = time.perf_counter()
    jax_state = ckpt.load_raw_checkpoint(fixture)
    fixture_s = time.perf_counter() - t0
    n_leaves = check_same_state(jax_state, ckpt.load_raw_checkpoint(
        fixture + ".ckpt"), "the JAX fixture's Orbax and msgpack copies")
    store = orbax.OcdbtStore(fixture)
    chunks = [store.get(k) for k in store.keys()
              if not k.endswith(".zarray")]
    out_bytes = sum(len(zstd.decompress(c)) for c in chunks)
    reps = 20
    t0 = time.perf_counter()
    for _ in range(reps):
        for c in chunks:
            zstd.decompress(c)
    decode_s = (time.perf_counter() - t0) / reps
    print(f"orbax: the JAX fixture (OCDBT + zstd, {len(chunks)} zstd "
          f"chunks, {sum(map(len, chunks))} -> {out_bytes} bytes) restored "
          f"in {fixture_s:.3f} s, bit-equal to its msgpack copy "
          f"({n_leaves} leaves); zstd decode {out_bytes / decode_s / 1e6:.1f} "
          f"MB/s on the host of {where} (every chunk, one thread, mean of "
          f"{reps} passes)")
    model = narrow_xvector(device)
    model.module.load_state_dict({**jax_state["params"],
                                  **jax_state["batch_stats"]})
    paths = write_wavs(audio_io, root, rng, ORBAX_WAVS, ORBAX_SECONDS)
    with launch_window(device, captures=[(
            *served_shape(ORBAX_WAVS, int(RATE * ORBAX_SECONDS)),
            {"num_mel_bins": 40})]) as counted:
        sync()
        scores = serve.Classifier(model, LABELS,
                                  feature_config=ORBAX_FIXTURE_FEATURES,
                                  batch_size=ORBAX_WAVS,
                                  device=device).classify(paths)
        sync()
    launches += counted["logmel_kernel"]
    warmup += counted["warmup"]
    table = np.stack([scores[f"score_{label}"] for label in LABELS], axis=1)
    cpu_model = narrow_xvector("cpu")
    cpu_model.module.load_state_dict(model.module.state_dict())
    cpu_scores = serve.Classifier(cpu_model, LABELS,
                                  feature_config=ORBAX_FIXTURE_FEATURES,
                                  batch_size=ORBAX_WAVS,
                                  device="cpu").classify(paths)
    cpu_table = np.stack([cpu_scores[f"score_{label}"] for label in LABELS],
                         axis=1)
    check(table.shape == (ORBAX_WAVS, len(LABELS))
          and np.isfinite(table).all(), f"fixture scores {table}")
    check(np.abs(table - cpu_table).max() <= SERVE_ATOL,
          f"fixture scores differ from the CPU's by "
          f"{np.abs(table - cpu_table).max()}")
    print(f"orbax: the fixture's narrow x-vector serves {ORBAX_WAVS} wavs "
          f"through serve.Classifier, within "
          f"{np.abs(table - cpu_table).max():.3e} of the CPU (SERVE_ATOL)")

    # (d)
    platforms = ["cuda", "cpu"] if on_card else ["cpu"]
    cfg_path = write_json(config, os.path.join(root, "orbax.json"))
    out_dir = os.path.join(root, "orbax_deploy")
    with contextlib.redirect_stdout(io.StringIO()):
        code = cli.main(["export", cfg_path, out_dir, "--platforms",
                         ",".join(platforms)], device=device)
    check(code == 0, f"export --platforms: exit code {code}")
    program_path = os.path.join(out_dir, export.PROGRAM_NAME)
    best = best_model_checkpoint_from_config(config)  # epoch 3's included
    deployed = wrapper_for(config)
    deployed.trainer.restore(best)
    live = {device: deployed.model}
    if on_card:
        cpu = ModelWrapper.from_config(config, device="cpu")
        cpu.model.module.load_state_dict(deployed.model.module.state_dict())
        live["cpu"] = cpu.model
    frames = 1 + (int(RATE * ORBAX_SECONDS) - 400) // 160
    gen = torch.Generator().manual_seed(SEED)
    xs = [torch.randn(b, frames, 64, generator=gen) for b in (1, 2, 32)]
    worst, cross = {}, 0.0
    with torch.inference_mode():
        for platform in platforms:
            program = export.load_program(program_path, device=platform)
            worst[platform] = 0.0
            for x in xs:
                x = x.to(platform)
                ref = live[platform].apply(x)
                got = program(x)
                err = (got - ref).abs()
                check((err <= EXPORT_ATOL + EXPORT_RTOL * ref.abs()).all(),
                      f"export on {platform}: batch {x.shape[0]} differs by "
                      f"{err.max().item()}")
                worst[platform] = max(worst[platform], err.max().item())
                cross = max(cross, (got.cpu() - live[device].apply(
                    x.to(device)).cpu()).abs().max().item())
    print(f"orbax: export --platforms {','.join(platforms)} from "
          f"{os.path.basename(best)}: the program on each device holds the "
          f"live model there at batch 1, 2 and 32 ("
          + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
          + f"; atol {EXPORT_ATOL} + rtol {EXPORT_RTOL}); across devices "
          f"{cross:.3e}")

    errors = []
    if on_card:
        check(launches == ORBAX_LAUNCHES + warmup,
              f"phase 13 launched the kernel {launches} times, not the "
              f"predicted {ORBAX_LAUNCHES} + {warmup} capture warm-up "
              "steps")
        with torch.inference_mode():
            errors.append(compare(logmel, "orbax_train",
                                  torch.as_tensor(train[0][0], device=device),
                                  RATE, KERNEL_KW))
        print(f"orbax: kernel launches {launches} (predicted "
              f"{ORBAX_LAUNCHES} + {warmup} capture warm-up steps)")
    return launches, max(errors, default=0.0)


# Phase 17: the masked recurrent, remat and one-rank-mesh steps. (a) The
# four recurrent models at their published widths through the
# length-tracking chain of phase 5 (energy VAD and speed change [0.9, 1.1]:
# every batch carries a frame mask), MASKED_BATCHES steps of [32, 48000] and
# 1 validation batch (a stream of its own, seed 1245); crnn and bi_gru served
# on MASKED_WAVS ragged wavs of 2-4 s; the two-direction layers of
# MASKED_FORKED, which the port runs concurrently under a capture (two
# streams, two cuDNN handles), against a serial composition built here
# (serial_route), and bi_gru served in bfloat16, which the port runs
# serially, against it too. (b) remat with channel dropout 0.5,
# 4 steps. (c) the x-vector on a 1-rank and a 1 x 1 NCCL mesh, 4 steps, and
# served on the 1-rank mesh.
MASKED_KEYS = ("lstm", "bi_gru", "crnn", "ap_lstm")
MASKED_SERVED = ("crnn", "bi_gru")
MASKED_FORKED = ("bi_gru", "crnn", "ap_lstm")
# held to the serial composition bit for bit: a layer's outputs and
# gradients, and the state after FORKED_STEPS steps
MASKED_FORKED_EXACT = ("bi_gru", "ap_lstm")
# served in bfloat16, which cuDNN refuses: the port's layers run serially
MASKED_BF16 = "bi_gru"
FORKED_STEPS = 3
MASKED_CHAIN = {"speed_range": [0.9, 1.1], "vad": True}
MASKED_BATCHES, MASKED_BATCH, MASKED_SECONDS = 4, TRAIN_BATCH, TRAIN_SECONDS
MASKED_WAVS = 8
# steady steps timed per turn (eager, graphed, graphed, eager), and steps
# under torch.profiler per turn (its cost grows with the recurrent layers'
# launches: one or more per time step)
MASKED_TIMED_STEPS, MASKED_PROFILED_STEPS = 10, 2


def masked_wrapper(root, key, device):
    """zoo_config of ``key`` (its published widths) with the
    length-tracking chain, weights from SEED."""
    from lidbox_tpu_torch.models.model_utils import ModelWrapper
    config = zoo_config(os.path.join(root, "masked"), key, {})
    config["features"]["on_device_augment"] = dict(MASKED_CHAIN)
    wrapper = ModelWrapper.from_config(config, device=device)
    wrapper.model.init(torch.Generator().manual_seed(SEED))
    return wrapper


def fit_forms(make, train, val, what, device, forms=("graphed", "eager")):
    """fit_fused of a fresh ``make()`` wrapper for one epoch of ``train``,
    validating on ``val``, in each of ``forms``: "graphed" (one capture
    predicted) and "eager" (``fit_signals(..., eager=True)``: none). The
    launch count is zeroed just before each fit and read just after: one
    launch per step and validation batch and the capture's warm-ups. The
    graphed and the eager run must agree bit for bit (``check_same_run``;
    on a difference a second eager run tells a nondeterministic model
    from a graph fault). Returns {form: (step losses, history, trainer,
    launches, the fit's peak device MB above what it started with,
    wrapper)}."""
    on_card = device == "cuda"
    runs = {}
    for form in forms:
        wrapper = make()
        losses = []
        base = 0
        if on_card:
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        with contextlib.ExitStack() as stack:
            stack.enter_context(recording_losses(losses))
            if form != "graphed":
                stack.enter_context(eager_steps())
            counted = stack.enter_context(launch_window(
                device, captures=[np.shape(train[0][0])]
                if form == "graphed" else []))
            history = wrapper.fit_fused(lambda: train, epochs=1,
                                        val_signal_batches=lambda: val,
                                        verbose=False)
            sync(device)
        peak = ((torch.cuda.max_memory_allocated() - base) / 2 ** 20
                if on_card else float("nan"))
        n = counted["logmel_kernel"]
        expected = len(train) + len(val) + counted["warmup"]
        check(n == expected or not on_card,
              f"{what} {form}: {n} kernel launches over the fit, not "
              f"{expected}")
        runs[form] = (step_losses_of(losses), history, wrapper.trainer, n,
                      peak, wrapper)
    if "eager" in runs:
        try:
            check_same_run(runs["graphed"][:3], runs["eager"][:3], what)
        except RuntimeError as fault:
            again = fit_forms(make, train, val, what, device,
                              forms=("eager",))["eager"]
            same = again[0] == runs["eager"][0]
            raise RuntimeError(
                f"{fault}; a second eager run "
                + ("gives the first one's losses: the graph differs" if same
                   else "differs from the first: the model's eager steps "
                   "are not deterministic")) from None
    return runs


def masked_first_loss(root, key, signals, targets, draws, device):
    """The training-mode loss of a fresh ``key`` wrapper's first step on
    one signal batch through the length-tracking chain with ``draws``
    (drawn on the card, so both devices augment alike), before any
    update."""
    from lidbox_tpu_torch.data import on_device
    from lidbox_tpu_torch.train.loop import to_device
    wrapper = masked_wrapper(root, key, device)
    trainer = wrapper.trainer
    trainer.create_state()
    fn = on_device.feature_fn_from_config(RATE, wrapper.config["features"],
                                          device=trainer.device)
    feats, mask = fn(None, to_device(signals, trainer.device), draws={
        k: v.to(trainer.device) for k, v in draws.items()})
    batch = {"input": feats, "input_mask": mask,
             "target": to_device(targets.astype(np.int64), trainer.device)}
    with torch.no_grad():
        out, _ = trainer._apply(trainer.state.params,
                                trainer.state.batch_stats, batch, train=True,
                                generator=trainer.generator)
        return float(trainer._masked_mean(trainer.loss_fn(batch["target"],
                                                          out), batch))


def serial_rnn(run_rnn):
    """``run_rnn`` (``layers.run_rnn``) with each frame-masked layer of two
    directions composed here instead, one direction after the other on the
    current stream: a single-direction cuDNN call of the forward cell, and
    one of the backward cell over each row's valid prefix reversed
    (``layers._flip_prefixes``) and flipped back, concatenated and zeroed
    past each row's length."""
    from lidbox_tpu_torch.models import layers

    def one_direction(cell, x):
        h0 = x.new_zeros(1, x.shape[0], cell.units)
        args = (cell.flat_weights(), True, 1, 0.0, torch.is_grad_enabled(),
                False, True)
        if cell.kind == "lstm":
            return torch.lstm(x, (h0, h0), *args)[0]
        return torch.gru(x, h0, *args)[0]

    def run(cells, x, lengths=None):
        if lengths is None or len(cells) != 2:
            return run_rnn(cells, x, lengths)
        n = torch.clamp(lengths.to(device=x.device, dtype=torch.int64),
                        min=1)
        y = torch.cat([one_direction(cells[0], x), layers._flip_prefixes(
            one_direction(cells[1], layers._flip_prefixes(x, n)), n)], dim=-1)
        valid = torch.arange(x.shape[1], device=x.device) < n[:, None]
        return torch.where(valid[..., None], y, y.new_zeros(()))
    return run


@contextlib.contextmanager
def serial_route():
    """Within it the models' recurrent layers run ``serial_rnn``: a step
    captured within is the serial composition's graph."""
    from lidbox_tpu_torch.models import layers
    run_rnn = layers.run_rnn
    layers.run_rnn = serial_rnn(run_rnn)
    try:
        yield
    finally:
        layers.run_rnn = run_rnn


def forked_layer_check(model, lengths, device):
    """The first two-direction layer of ``model`` (a copy) on a batch of
    ``lengths`` [B] frames: ``layers.run_rnn`` (on the card captured in a
    CUDA graph, so forked on two streams, after a warm-up run on a side
    stream, which runs serially) against ``serial_rnn`` run eagerly,
    outputs, the input's gradient and every parameter's bit for bit.
    Returns (the number of tensors compared, the port's layer runs by
    route: the warm-up's and the capture's)."""
    from lidbox_tpu_torch.models import layers
    layer = copy.deepcopy(next(m for m in model.modules()
                               if isinstance(m, layers.BidirectionalRNN)))
    cells = tuple(getattr(layer, name) for name in layer.cell_names)
    gate = getattr(cells[0], "i" + cells[0].gates[0])
    gen = torch.Generator(device=device).manual_seed(SEED)
    x = torch.randn(len(lengths), int(lengths.max()) + 22, gate.in_features,
                    device=device, generator=gen)
    w = torch.randn(x.shape[:2] + (2 * cells[0].units,), device=device,
                    generator=gen)

    def grads(run):
        layer.zero_grad(set_to_none=True)
        xr = x.clone().requires_grad_(True)
        y = run(cells, xr, lengths)
        (y * w).sum().backward()
        return ([y.detach(), xr.grad]
                + [p.grad for c in cells for p in c.parameters()])
    with layers.tallying_rnn_runs(collections.Counter()) as routed:
        if device == "cuda":
            side = torch.cuda.Stream(device)
            side.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(side):
                grads(layers.run_rnn)
            torch.cuda.current_stream(device).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, stream=side,
                                  capture_error_mode="thread_local"):
                a = grads(layers.run_rnn)
            graph.replay()
        else:
            a = grads(layers.run_rnn)
    b = grads(serial_rnn(layers.run_rnn))
    sync(device)
    check(len(a) == len(b) and all(t is not None for t in a + b),
          "forked layer: gradients missing")
    differ = [i for i, (p, q) in enumerate(zip(a, b))
              if not torch.equal(p, q)]
    check(not differ, f"the port's layer {dict(routed)} differs from the "
                      f"serial composition in tensors {differ} (0: outputs, "
                      "1: the input's gradient, then the parameters')")
    return len(a), routed


def forked_steps(root, key, x, y, device):
    """FORKED_STEPS graphed fused steps of a fresh ``key`` wrapper on the
    signal batch ``x``, ``y``, with the port's layers and with
    ``serial_route``'s: step losses and every state tensor bit for bit.
    Returns the port's masked two-direction layer runs by route over its
    steps (on the card: the capture's warm-up steps, serial, and captured
    body, forked)."""
    from lidbox_tpu_torch.data import on_device
    from lidbox_tpu_torch.models import layers
    from lidbox_tpu_torch.train import graphs
    out = {}
    for form in ("port", "serial"):
        wrapper = masked_wrapper(root, key, device)
        trainer = wrapper.trainer
        trainer.create_state()
        step = on_device.make_fused_train_step(
            trainer, on_device.feature_fn_from_config(
                RATE, wrapper.config["features"], device=trainer.device))
        state, losses = trainer.state, []
        with serial_route() if form == "serial" else contextlib.nullcontext(), \
                layers.tallying_rnn_runs(collections.Counter()) as routed:
            for _ in range(FORKED_STEPS):
                state, loss = step(state, x, y, trainer.generator)
                losses.append(loss)
        sync(device)
        out[form] = ([float(v) for v in losses], graphs.state_tensors(state),
                     routed)
    (la, ta, routed), (lb, tb, _) = out["port"], out["serial"]
    check(la == lb, f"masked {key}: step losses {la} with the port's layers, "
                    f"{lb} with the serial composition")
    check(len(ta) == len(tb) and all(torch.equal(p, q)
                                     for p, q in zip(ta, tb)),
          f"masked {key}: the state after {FORKED_STEPS} steps differs "
          "from the serial composition's")
    return routed


def masked_bf16_check(model, paths, ids, device):
    """``model`` served in bfloat16 (``serve.Classifier(compute_dtype=
    "bfloat16")``, graphed on the card) on ``paths``, one masked batch,
    with the port's layers and with ``serial_route``'s: scores bit for
    bit, and no layer run forked (cuDNN takes no bfloat16, so the port's
    calls go to PyTorch's own recurrent kernels, serially, as the serial
    composition's do). The layer runs are counted on every thread: the
    served forwards run on the serving pool's."""
    import threading
    from lidbox_tpu_torch import serve
    from lidbox_tpu_torch.models import layers
    scores, runs, lock = {}, collections.Counter(), threading.Lock()
    count = layers._count_run

    def counting(route):
        with lock:
            runs[route] += 1
        count(route)
    layers._count_run = counting
    try:
        for form in ("port", "serial"):
            with (serial_route() if form == "serial"
                  else contextlib.nullcontext()):
                scores[form] = np.stack(serve.Classifier(
                    model, LABELS, feature_config=FEATURES_PALLAS,
                    batch_size=len(paths), device=device,
                    compute_dtype="bfloat16").scores(paths, ids=ids)[
                        "prediction"])
    finally:
        layers._count_run = count
    # the serial composition counts none
    check(not runs["forked"] and runs["serial"] > 0,
          f"masked bfloat16: the port's layer runs {dict(runs)}")
    check(np.array_equal(scores["port"], scores["serial"]),
          "masked bfloat16: served scores with the port's layers differ from "
          "the serial composition's")
    print(f"masked {MASKED_BF16} served in bfloat16 "
          f"({'graphed' if device == 'cuda' else 'eager'}): == the serial "
          f"composition bit for bit; the port's layer runs {dict(runs)}")


def route_turns(trainer, fn, fresh_fn, inputs, what):
    """The graphed masked step with the port's layers (``fn``'s program,
    captured already) and with ``serial_route``'s (a program of its own on
    ``fresh_fn``, captured in its first turn), timed in turns (port,
    serial, serial, port; ``whole_step_times``): {form: [(median ms, host
    wall ms, device busy ms, log-Mel launches), ...]}, printed with the
    device kernels of one profiled step of each."""
    from lidbox_tpu_torch.data import on_device
    steps = {"port": on_device.make_fused_train_step(trainer, fn),
             "serial": on_device.make_fused_train_step(trainer, fresh_fn)}
    out = {"port": [], "serial": []}
    for form in ("port", "serial", "serial", "port"):
        with serial_route() if form == "serial" else contextlib.nullcontext():
            out[form].append(whole_step_times(
                steps[form], trainer.state, inputs, steps=MASKED_TIMED_STEPS,
                profiled=MASKED_PROFILED_STEPS))
    kernels = {}
    for form, step in steps.items():
        holder, seen = [trainer.state], {}

        def one():
            holder[0], _ = step(holder[0], *inputs)
        device_ops(one, calls=1, counts=seen)
        kernels[form] = sum(n for n, _ in seen.values())
    print(f"{what}, graphed, port (forked) against serial in turns: "
          + "; ".join(f"{form} " + ", ".join(f"{m:.4f}" for m, *_ in runs)
                      + f" ms (CUDA events, medians), {kernels[form]} "
                      "device kernels a step" for form, runs in out.items()))
    return out


def ragged_wavs(io, root, rng, n):
    """``n`` noisy sines of 2-4 s each: their features differ in length,
    so a served batch of them carries a frame mask. Returns (paths, the
    longest's samples)."""
    paths, longest = [], 0
    for i in range(n):
        sig = noisy_sines(rng, 1, float(rng.uniform(2.0, 4.0)), RATE)[0]
        paths.append(os.path.join(root, f"ragged{i:02d}.wav"))
        io.write_mono_wav(paths[-1], sig, RATE)
        longest = max(longest, sig.size)
    return paths, longest


# Phase 17 (c), served: the x-vector behind the 1-rank mesh's batch predict
# fn on [32, 298, 64] (phase 3's wavs' features) and on MESH_PARTIAL_ROWS of
# them made ragged (a frame mask), a Classifier pass over phase 3's wavs and
# a stream of MESH_STREAM_WAVS of them end to end. The mesh pads a partial
# batch to its batch size and the mesh-less predict fn runs its own rows:
# another batch size, so those two agree within MESH_PARTIAL_RTOL (+ ATOL).
MESH_PARTIAL_ROWS = 8
MESH_PARTIAL_RTOL, MESH_PARTIAL_ATOL = 1e-5, 1e-6
MESH_STREAM_WAVS = 3


def one_rank_serving(root, mesh, device="cuda", classify_argv=None):
    """Phase 17 (c), served on the 1-rank ``mesh``: the batch predict fn
    graphed (one capture per input signature, then replays), eager and
    mesh-less on a full and a ragged partial batch, graphed == eager bit
    for bit, == mesh-less bit for bit at the full batch; a
    ``serve.Classifier(mesh=)`` pass over phase 3's wavs == the mesh-less
    scores; a ``StreamingClassifier(mesh=)`` of several chunks through the
    fused "stream" program == the mesh-less stream bit for bit; with
    ``classify_argv`` (phase 7's ``classify`` of 8 wavs), the command
    without and with ``--data-parallel`` in turns, the same CSV and the
    same launches (a feature program a group, captured anew by each
    command), its wall time. The launches of each driven part are
    predicted and printed first, and read; on the card each form is timed
    in turns with the mesh-less graph. Returns the launches of each kernel
    read over the parts."""
    import contextlib
    import io as text_io
    from lidbox_tpu_torch import cli, models, serve, util
    from lidbox_tpu_torch.data.device_pipeline import DeviceFeatureExtractor
    from lidbox_tpu_torch.features import io
    from lidbox_tpu_torch.ops import logmel
    from lidbox_tpu_torch.train import graphs

    on_card = device == "cuda"
    card = card_line() if on_card else "CPU rehearsal"
    t0 = time.perf_counter()
    n = 32
    paths = [os.path.join(root, f"utt{i:03d}.wav") for i in range(n)]
    if not all(os.path.exists(p) for p in paths):  # phase 3 did not run
        paths = write_wavs(io, root, np.random.default_rng(SEED), n, 3.0)
    ids = [f"utt{i:03d}" for i in range(n)]
    signals = [io.read_wav(p)[0] for p in paths]
    frames = 1 + (3 * RATE - 400) // 160
    model = models.create("xvector", (frames, 64), len(LABELS),
                          device=device).init(
        torch.Generator().manual_seed(SEED))
    x = np.stack(DeviceFeatureExtractor(FEATURES_PALLAS, device=device)
                 .extract_ragged(signals, RATE))
    lengths = np.random.default_rng(SEED + 12).integers(
        frames // 2, frames + 1, MESH_PARTIAL_ROWS)
    mask = np.arange(frames)[None, :] < lengths[:, None]
    part = np.where(mask[:, :, None], x[:MESH_PARTIAL_ROWS],
                    0.0).astype(np.float32)
    stream_signal = np.concatenate(signals[:MESH_STREAM_WAVS])
    chunks = (stream_signal.size - 2 * RATE) // RATE + 1
    check(graphs.forward_reason(mesh) is None,
          f"a 1-rank mesh has an eager reason: {graphs.forward_reason(mesh)}")

    def plan_splits(shape):
        return on_card and logmel.launch_plan(*shape, RATE, **KERNEL_KW)[0][
            "splits"] > 1
    served = served_shape(n, 3 * RATE)
    warm = graphs.WARMUP_STEPS
    predicted = {
        "predict fns": (0, 0),
        "classifier": (1 + warm, (1 + warm) * plan_splits(served)),
        "stream": (chunks + warm, (chunks + warm) * plan_splits((1, 2 * RATE)))}
    print(f"masked (c) served ({card}): the x-vector on the 1-rank "
          f"{mesh.backend} mesh; predicted launches (logmel_kernel, "
          f"logmel_reduce), warm-ups included: the predict fns on features "
          f"{predicted['predict fns']}, each Classifier pass over {n} 3 s "
          f"wavs {list(served)} {predicted['classifier']}, each stream of "
          f"{chunks} chunks [1, {2 * RATE}] {predicted['stream']}")
    launched = np.zeros(2, np.int64)

    def read(counted, what, expected):
        got = (counted["logmel_kernel"], counted["logmel_reduce"])
        check(got == expected or not on_card,
              f"masked (c) {what}: launches {got}, predicted {expected}")
        launched[:] += got

    def new_captures(before):
        return {k: graphs.captures[k] - before.get(k, 0)
                for k in graphs.captures
                if graphs.captures[k] != before.get(k, 0)}

    # the batch predict fn: full and partial ragged batches
    predict = {
        "graphed": util.make_batch_predict_fn(model, batch_size=n,
                                              mesh=mesh),
        "eager": util.make_batch_predict_fn(model, batch_size=n, mesh=mesh,
                                            eager=True),
        "mesh-less": util.make_batch_predict_fn(model, batch_size=n)}
    before = dict(graphs.captures)
    with launch_window(device, captures=[]) as counted:
        out = {form: (fn(x), fn(part, mask)) for form, fn in predict.items()}
        sync(device)
    read(counted, "predict fns", predicted["predict fns"])
    # one graph per signature: the mesh's two and the mesh-less two
    check(new_captures(before) == ({"forward": 4} if on_card else {}),
          f"masked (c) predict fns captured {new_captures(before)}")
    again = (predict["graphed"](x), predict["graphed"](part, mask))
    check(new_captures(before) == ({"forward": 4} if on_card else {}),
          "masked (c): the mesh's second calls captured again")
    g, e, m = out["graphed"], out["eager"], out["mesh-less"]
    check(all(np.array_equal(a, b) for a, b in zip(g, e))
          and all(np.array_equal(a, b) for a, b in zip(g, again)),
          "masked (c): the 1-rank mesh's predict fn graphed != eager")
    check(np.isfinite(g[0]).all() and np.array_equal(g[0], m[0]),
          "masked (c): the 1-rank mesh's full batch != mesh-less")
    diff = np.abs(g[1] - m[1])
    rel = float((diff / np.abs(m[1])).max())
    check(bool(np.all(diff <= MESH_PARTIAL_ATOL
                      + MESH_PARTIAL_RTOL * np.abs(m[1]))),
          f"masked (c): the partial batch sits {diff.max()} (rel {rel}) from "
          f"mesh-less (rtol {MESH_PARTIAL_RTOL}, atol {MESH_PARTIAL_ATOL})")
    print(f"masked (c) served: the 1-rank mesh's predict fn on [{n}, "
          f"{frames}, 64] and on [{MESH_PARTIAL_ROWS}, {frames}, 64] with a "
          f"mask ({int(lengths.min())}-{int(lengths.max())} frames): one "
          f"capture a signature, then replays; graphed == eager bit for "
          f"bit; full batch == mesh-less bit for bit; partial batch vs "
          f"mesh-less max abs {float(diff.max()):.3e}, max rel {rel:.3e} "
          f"(rtol {MESH_PARTIAL_RTOL}, atol {MESH_PARTIAL_ATOL})")

    # Classifier passes over phase 3's wavs
    classifiers = {
        "graphed": serve.Classifier(model, LABELS,
                                    feature_config=FEATURES_PALLAS,
                                    batch_size=n, mesh=mesh, device=device),
        "mesh-less": serve.Classifier(model, LABELS,
                                      feature_config=FEATURES_PALLAS,
                                      batch_size=n, device=device)}
    scores = {}
    for form, service in classifiers.items():
        before = dict(graphs.captures)
        with launch_window(device, captures=[served]) as counted:
            scores[form] = service.scores(paths, ids=ids)["prediction"]
            sync(device)
        read(counted, f"Classifier {form}", predicted["classifier"])
        check(new_captures(before) == ({"features": 1, "forward": 1}
                                       if on_card else {}),
              f"masked (c) Classifier {form} captured {new_captures(before)}")
    check(np.isfinite(scores["graphed"]).all()
          and np.array_equal(scores["graphed"], scores["mesh-less"]),
          "masked (c): Classifier(mesh=1-rank) scores != mesh-less")

    # streams, the fused chunk program
    def stream(mesh_, eager=False):
        return serve.StreamingClassifier(
            model, LABELS, feature_config=FEATURES_PALLAS, sample_rate=RATE,
            chunk_seconds=2.0, hop_seconds=1.0, mesh=mesh_, device=device,
            eager=eager)
    streams = {"graphed": stream(mesh), "mesh-less": stream(None)}
    check(streams["graphed"]._mesh_predict is None,
          "masked (c): the 1-rank mesh's stream built a mesh predict fn")
    stream_scores = {}
    for form, service in streams.items():
        before = dict(graphs.captures)
        with launch_window(device, captures=[(1, 2 * RATE)]) as counted:
            for block in np.array_split(stream_signal,
                                        [1234, 20000, 70001, 100000]):
                service.feed(block)
            stream_scores[form] = service.scores()
            sync(device)
        read(counted, f"stream {form}", predicted["stream"])
        check(service._num_chunks == chunks,
              f"masked (c) stream {form}: {service._num_chunks} chunks")
        # the fused program alone: no feature program, no forward program
        check(new_captures(before) == ({"stream": 1} if on_card else {}),
              f"masked (c) stream {form} captured {new_captures(before)}")
    check(np.isfinite(stream_scores["graphed"]).all()
          and np.array_equal(stream_scores["graphed"],
                             stream_scores["mesh-less"]),
          "masked (c): the 1-rank mesh's stream != the mesh-less stream")
    print(f"masked (c) served: Classifier(mesh=1-rank) over {n} 3 s wavs == "
          f"mesh-less bit for bit; a 1-rank mesh stream of {chunks} chunks "
          f"through the fused \"stream\" program (no feature readback) == "
          f"the mesh-less stream bit for bit; launches as predicted: "
          f"{launched.tolist()}")

    if classify_argv is not None:  # the command line, in turns
        outs, walls, counts = {}, {}, {}
        for form in ("mesh-less", "--data-parallel", "--data-parallel",
                     "mesh-less"):
            out = text_io.StringIO()
            argv = list(classify_argv) + (
                [] if form == "mesh-less" else [form])
            with launch_window(device) as counted:
                sync(device)
                t = time.perf_counter()
                with contextlib.redirect_stdout(out):
                    code = cli.main(argv, device=device)
                sync(device)
                walls.setdefault(form, []).append(time.perf_counter() - t)
            check(code == 0, f"masked (c) classify {form}: exit code {code}")
            got = (counted["logmel_kernel"], counted["logmel_reduce"])
            launched[:] += got
            counts.setdefault(form, set()).add(got)
            check(outs.setdefault(form, out.getvalue()) == out.getvalue(),
                  f"masked (c) classify {form}: two runs wrote other CSVs")
        # the mesh pads the 8 wavs' batch to the batch size: the scores
        # agree within the partial batch's tolerance
        rows = {f: [line.split(",") for line in text.strip().splitlines()]
                for f, text in outs.items()}
        a, b = rows["mesh-less"], rows["--data-parallel"]
        scores = [np.asarray([r[2:] for r in t[1:]], np.float64)
                  for t in (a, b)]
        diff = np.abs(scores[1] - scores[0])
        check(len(a) == 9 and [r[:2] for r in a] == [r[:2] for r in b]
              and bool(np.all(diff <= MESH_PARTIAL_ATOL
                              + MESH_PARTIAL_RTOL * np.abs(scores[0]))),
              f"masked (c): classify --data-parallel wrote another table "
              f"(scores {diff.max()} apart)")
        check(len(counts["mesh-less"] | counts["--data-parallel"]) == 1,
              f"masked (c) classify launches differ: {counts}")
        print(f"masked (c) served: classify of 8 wavs and classify "
              f"--data-parallel (the 1-rank mesh) wrote the same ids and "
              f"labels, scores max abs {diff.max():.3e} apart (rtol "
              f"{MESH_PARTIAL_RTOL}, atol {MESH_PARTIAL_ATOL}); launches "
              f"{sorted(counts['mesh-less'])[0]} a command; wall s "
              "(host clock, in turns) " + ", ".join(
                  f"{f} " + " / ".join(f"{w:.3f}" for w in ws)
                  for f, ws in walls.items()))

    if on_card:  # each form in turns with the mesh-less graph
        order = ("eager", "graphed", "mesh-less", "mesh-less", "graphed",
                 "eager")
        served_turns(f"1-rank mesh forward [{n}, {frames}, 64]",
                     {f: functools.partial(fn, x)
                      for f, fn in predict.items()}, card, order=order)
        served_turns(f"1-rank mesh forward [{MESH_PARTIAL_ROWS}, {frames}, "
                     f"64] masked",
                     {f: functools.partial(fn, part, mask)
                      for f, fn in predict.items()}, card, order=order)
        classifiers["eager"] = serve.Classifier(
            model, LABELS, feature_config=FEATURES_PALLAS, batch_size=n,
            mesh=mesh, device=device, eager=True)
        served_turns(f"1-rank mesh Classifier pass over {n} 3 s wavs",
                     {f: functools.partial(c.scores, paths, ids=ids)
                      for f, c in classifiers.items()}, card, per_call=n,
                     order=order, reps=5)
        streams["eager"] = stream(mesh, eager=True)
        chunk = np.ascontiguousarray(stream_signal[:2 * RATE], np.float32)
        served_turns(f"1-rank mesh stream chunk [1, {2 * RATE}]",
                     {f: functools.partial(st._score_chunk, chunk)
                      for f, st in streams.items()}, card, order=order)
    print(f"masked (c) served: {time.perf_counter() - t0:.1f} s")
    return int(launched[0]), int(launched[1])


def phase_masked(root, rng, logmel, device="cuda", classify_argv=None):
    """Phase 17: the masked recurrent, remat and one-rank-mesh steps,
    captured.
    (a) lstm, bi_gru, crnn and ap_lstm through fit_fused on the
    length-tracking chain, graphed and eager bit for bit, the launches of
    each fit as predicted, 3 replays under
    ``set_sync_debug_mode("error")``, the first step's loss against the
    CPU's on the same weights and draws, each masked step timed eager and
    graphed in turns; crnn and bi_gru behind ``serve.Classifier`` on ragged
    wavs graphed and eager bit for bit and within SERVE_ATOL of the CPU;
    the kernel held to its plain version on the first masked batch; for
    MASKED_FORKED_EXACT, the first two-direction layer captured (forked on
    two streams) against a serial composition (``serial_rnn``) bit for
    bit, outputs and gradients, and FORKED_STEPS graphed steps of each,
    their states bit for bit; MASKED_BF16 served in bfloat16 (serial)
    against the serial composition bit for bit; on the card
    MASKED_FORKED's masked steps graphed, forked and serial in turns,
    printed beside the eager (serial) times.
    (b) remat with channel dropout 0.5, graphed and eager bit for bit,
    within REMAT_RTOL of the plain step, the peak memory with and without
    remat. (c) the x-vector mesh-less, on a 1-rank mesh and on a 1 x 1
    mesh with the column-parallel rule, all captured, bit for bit, timed;
    then its served forwards on the 1-rank mesh (``one_rank_serving``;
    ``classify_argv``, phase 7's ``classify``, adds the command line).
    Returns (the launches of each kernel, the kernel's error on the
    masked batch).

    ``device="cpu"`` rehearses it on the plain version (set MASKED_BATCH
    and MASKED_SECONDS small first); the launch counts, the sync check,
    the card-vs-CPU comparisons, the kernel check, the memory and the
    timing need the card."""
    import lidbox_tpu_torch.features as features
    from lidbox_tpu_torch import parallel, serve
    from lidbox_tpu_torch.data import on_device
    from lidbox_tpu_torch.features import io
    from lidbox_tpu_torch.models import layers
    from lidbox_tpu_torch.train import graphs
    from lidbox_tpu_torch.train.loop import keyed_generator, to_device

    on_card = device == "cuda"
    card = card_line() if on_card else "CPU rehearsal"
    samples = int(RATE * MASKED_SECONDS)
    train = class_sines_with_pauses(rng, MASKED_BATCHES, MASKED_BATCH,
                                    MASKED_SECONDS)
    val = class_sines_with_pauses(rng, 1, MASKED_BATCH, MASKED_SECONDS)
    wav_root = os.path.join(root, "masked_wavs")
    os.makedirs(wav_root)
    paths, longest = ragged_wavs(io, wav_root, rng, MASKED_WAVS)
    ids = [f"ragged{i:02d}" for i in range(MASKED_WAVS)]
    predicted = {"graphed": MASKED_BATCHES + 1 + 2 * 1,  # 1 capture
                 "eager": MASKED_BATCHES + 1}
    print(f"masked ({card}): seed {SEED + 11}; chain {MASKED_CHAIN}; "
          f"{MASKED_BATCHES} steps of [{MASKED_BATCH}, {samples}] + 1 "
          f"validation batch; predicted launches per fit: graphed "
          f"{predicted['graphed']} (one capture's 2 warm-ups), eager "
          f"{predicted['eager']}; serving {MASKED_WAVS} ragged wavs: graphed "
          f"1 + its capture's warm-ups, eager 1")
    aug = on_device.augment_config_from_dict(MASKED_CHAIN)
    draws = on_device.draw_augmentation(
        keyed_generator(device, SEED, 0, 7), aug, MASKED_BATCH, samples,
        None, device)
    x = to_device(train[0][0], torch.device(device))
    y = to_device(train[0][1].astype(np.int64), torch.device(device))
    launches, reductions, kept, rows = 0, 0, [], []
    extract = features.extract_features

    def keeping(signals, *args, **kw):
        # the first batch the chain hands the kernel, in the eager run
        if kw.get("lengths") is not None and not kept:
            kept.append(signals.clone())
        return extract(signals, *args, **kw)

    # (a) the recurrent models on frame masks
    for key in MASKED_KEYS:
        marks = [("start", time.perf_counter())]

        def mark(name):
            marks.append((name, time.perf_counter()))

        def spent():
            return ", ".join(f"{b[0]} {b[1] - a[1]:.1f} s"
                             for a, b in zip(marks, marks[1:]))
        if not kept:
            features.extract_features = keeping
        try:
            runs = fit_forms(lambda: masked_wrapper(root, key, device),
                             train, val, f"masked {key}", device)
        finally:
            features.extract_features = extract
        mark("fits")
        for form in ("graphed", "eager"):
            n = runs[form][3]
            check(n == predicted[form] or not on_card,
                  f"masked {key} {form}: {n} launches, predicted "
                  f"{predicted[form]}")
            launches += n
        losses, history, trainer, _, _, wrapper = runs["graphed"]
        check(all(np.isfinite(losses)) and np.isfinite(history[0]["loss"])
              and np.isfinite(history[0]["val_loss"]),
              f"masked {key}: not finite: {losses}, {history}")
        fn = on_device.feature_fn_from_config(
            RATE, wrapper.config["features"], device=trainer.device)
        _, mask = fn(None, x, draws=draws)
        lengths = mask.sum(dim=1)
        check(int(lengths.min()) < mask.shape[1] and
              len(set(lengths.tolist())) > 1,
              f"masked {key}: the batch's frame mask is not ragged")
        row = {"config": key, "params": wrapper.count_params(),
               "losses": losses, "val_loss": history[0]["val_loss"],
               "frames": [int(lengths.min()), int(lengths.max()),
                          int(mask.shape[1])]}
        if on_card:
            cpu = masked_first_loss(root, key, train[0][0], train[0][1],
                                    {k: v.cpu() for k, v in draws.items()},
                                    "cpu")
            first = masked_first_loss(root, key, train[0][0], train[0][1],
                                      draws, device)
            rel = abs(first - cpu) / abs(cpu)
            check(rel <= ZOO_RTOL, f"masked {key}: first loss {first} on the "
                                   f"card, {cpu} on the CPU (rel {rel})")
            row.update(first_loss=first, cpu_loss=cpu, loss_rel=rel)
            mark("card vs CPU")
            step = on_device.make_fused_train_step(trainer, fn)
            for _ in range(2):  # capture
                trainer.state, _ = step(trainer.state, x, y,
                                        trainer.generator)
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                for _ in range(3):
                    trainer.state, loss = step(trainer.state, x, y,
                                               trainer.generator)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            check(np.isfinite(float(loss)),
                  f"masked {key}: the replays are not finite")
            mark("sync check")
            row["forms"] = eager_and_graphed(
                trainer, fn, (x, y, trainer.generator),
                f"masked {key} train step [{MASKED_BATCH}, {samples}]",
                steps=MASKED_TIMED_STEPS, profiled=MASKED_PROFILED_STEPS)
            mark("timing")
            if key in MASKED_FORKED:
                row["routes"] = route_turns(
                    trainer, fn, on_device.feature_fn_from_config(
                        RATE, wrapper.config["features"],
                        device=trainer.device),
                    (x, y, trainer.generator),
                    f"masked {key} train step [{MASKED_BATCH}, {samples}]")
                mark("forked vs serial timing")
        if key in MASKED_FORKED_EXACT:
            compared, layer_runs = forked_layer_check(
                wrapper.model.module, lengths, device)
            # on the card: the warm-up runs serially, the capture forks
            expected = ({"serial": 1, "forked": 1} if on_card
                        else {"serial": 1})
            check(layer_runs == expected,
                  f"masked {key}: the layer's runs {dict(layer_runs)}, "
                  f"predicted {expected}")
            routed = forked_steps(root, key, x, y, device)
            n_layers = sum(isinstance(m, layers.BidirectionalRNN)
                           for m in wrapper.model.module.modules())
            expected = ({"serial": n_layers * graphs.WARMUP_STEPS,
                         "forked": n_layers} if on_card
                        else {"serial": n_layers * FORKED_STEPS})
            check(routed == expected,
                  f"masked {key}: layer runs {dict(routed)} over "
                  f"{FORKED_STEPS} steps, predicted {expected}")
            print(f"masked {key}: the first two-direction layer "
                  f"{'captured, forked,' if on_card else 'eager, serial,'} "
                  f"== the serial composition bit for bit (outputs, the "
                  f"input's gradient, {compared - 2} parameter gradients); "
                  f"{FORKED_STEPS} {'graphed' if on_card else 'eager'} steps "
                  f"== the serial composition's, losses and state bit for "
                  f"bit; layer runs {dict(routed)}"
                  + (" (the capture's warm-ups serial, its body forked)"
                     if on_card else ""))
            mark("forked vs serial")
        print(f"masked {key}: {row['params']} parameters; fit_fused graphed "
              f"== eager bit for bit: step losses {losses}, val_loss "
              f"{row['val_loss']!r}, state; frames per row "
              f"{row['frames'][0]}-{row['frames'][1]} of {row['frames'][2]}"
              + (f"; 3 replays under set_sync_debug_mode('error'): no host "
                 f"synchronization; first loss {row['first_loss']:.6f} vs "
                 f"CPU {row['cpu_loss']:.6f} (rel {row['loss_rel']:.2e}, "
                 f"rtol {ZOO_RTOL})" if on_card else "")
              + f"; {spent()}")
        rows.append(row)

        if key in MASKED_SERVED:
            trainer.sync_model_variables()
            cpu_model = masked_wrapper(root, key, "cpu").model
            cpu_model.module.load_state_dict(
                {k: v.cpu()
                 for k, v in wrapper.model.module.state_dict().items()})
            scores = {}
            for form in ("graphed", "eager"):
                with launch_window(device, captures=[served_shape(
                        MASKED_WAVS, longest)] if form == "graphed"
                        else []) as counted:
                    scores[form] = np.stack(serve.Classifier(
                        wrapper.model, LABELS, feature_config=FEATURES_PALLAS,
                        batch_size=MASKED_WAVS, device=device,
                        eager=form == "eager").scores(paths, ids=ids)[
                            "prediction"])
                    sync(device)
                n = counted["logmel_kernel"]
                check(n == 1 + counted["warmup"] or not on_card,
                      f"masked {key} served {form}: {n} launches, not 1 + "
                      f"{counted['warmup']} capture warm-ups")
                launches += n
                if on_card:  # a split launch adds its reduction
                    split = logmel.launch_plan(
                        *served_shape(MASKED_WAVS, longest), RATE,
                        **KERNEL_KW)[0]["splits"] > 1
                    r = counted["logmel_reduce"]
                    check(r == split + counted["warmup_reduce"],
                          f"masked {key} served {form}: {r} reductions, not "
                          f"{int(split)} + {counted['warmup_reduce']}")
                    reductions += r
            ref = np.stack(serve.Classifier(
                cpu_model, LABELS, feature_config=FEATURES_PALLAS,
                batch_size=MASKED_WAVS, device="cpu").scores(
                    paths, ids=ids)["prediction"])
            err = float(np.abs(scores["graphed"] - ref).max())
            check(np.array_equal(scores["graphed"], scores["eager"]),
                  f"masked {key}: served scores graphed != eager")
            check(err <= SERVE_ATOL, f"masked {key}: served scores {err} "
                                     f"from the CPU's (atol {SERVE_ATOL})")
            print(f"masked {key} served ({MASKED_WAVS} wavs of 2-4 s, one "
                  f"masked batch): graphed == eager bit for bit, max |{device}"
                  f" - CPU| {err:.3e} (atol {SERVE_ATOL}); "
                  f"{time.perf_counter() - marks[-1][1]:.1f} s")
            if key == MASKED_BF16:
                masked_bf16_check(wrapper.model, paths, ids, device)
        del runs, trainer, wrapper
        if on_card:
            torch.cuda.empty_cache()
    err = 0.0
    if on_card:
        check(len(kept) == 1, f"kept {len(kept)} masked batches")
        err = compare(logmel, f"masked batch {tuple(kept[0].shape)}",
                      kept[0], RATE, KERNEL_KW)

    # (b) remat, with channel dropout 0.5
    t0 = time.perf_counter()
    plain_train = class_sines(rng, MASKED_BATCHES, MASKED_BATCH,
                              MASKED_SECONDS)
    plain_val = class_sines(rng, 1, MASKED_BATCH, MASKED_SECONDS)

    def dropout_wrapper(remat):
        wrapper = tp_wrapper(root, f"remat{int(remat)}", device=device,
                             remat=remat, dropout=0.5)
        wrapper.model.init(torch.Generator().manual_seed(SEED))
        wrapper.trainer.callbacks = []  # no checkpoint files
        return wrapper
    remat = fit_forms(lambda: dropout_wrapper(True), plain_train, plain_val,
                      "remat", device)
    plain = fit_forms(lambda: dropout_wrapper(False), plain_train, plain_val,
                      "plain", device)
    for runs in (remat, plain):
        check(all(r[3] == predicted[f] or not on_card
                  for f, r in runs.items()),
              f"remat phase launches {[r[3] for r in runs.values()]}")
        launches += sum(r[3] for r in runs.values())
    rel = max(abs(a - b) / abs(b) for a, b in zip(remat["graphed"][0],
                                                  plain["graphed"][0]))
    check(rel <= REMAT_RTOL, f"remat step losses {remat['graphed'][0]} vs "
                             f"plain {plain['graphed'][0]} (rel {rel})")
    print(f"masked (b): remat with channel dropout 0.5, graphed == eager bit "
          f"for bit: step losses {remat['graphed'][0]}; vs the plain graphed "
          f"step max rel {rel:.3e} (rtol {REMAT_RTOL})")
    if on_card:
        trainer = remat["graphed"][2]
        fn = on_device.feature_fn_from_config(
            RATE, remat["graphed"][5].config["features"],
            device=trainer.device)
        px = to_device(plain_train[0][0], trainer.device)
        py = to_device(plain_train[0][1].astype(np.int64), trainer.device)
        forms = eager_and_graphed(trainer, fn, (px, py, trainer.generator),
                                  f"masked (b) remat step [{MASKED_BATCH}, "
                                  f"{samples}]", steps=MASKED_TIMED_STEPS,
                                  profiled=MASKED_PROFILED_STEPS)
        peaks = {f"{name} {form}": runs[form][4]
                 for name, runs in (("remat", remat), ("plain", plain))
                 for form in ("graphed", "eager")}
        print(f"masked (b) ({card}): peak device memory over each fit above "
              f"its start (torch.cuda.max_memory_allocated): "
              + ", ".join(f"{k} {v:.1f} MB" for k, v in peaks.items())
              + "; remat / plain: graphed "
              f"{peaks['remat graphed'] / peaks['plain graphed']:.3f}, eager "
              f"{peaks['remat eager'] / peaks['plain eager']:.3f}; "
              f"{time.perf_counter() - t0:.1f} s for (b)")
        rows.append({"config": "remat", "forms": forms, "peaks": peaks})
    del remat, plain

    # (c) one-rank meshes, captured
    t0 = time.perf_counter()
    mesh1 = parallel.get_mesh(device=device)
    check(mesh1.size == 1, f"a {mesh1.size}-rank group in this process")
    mesh11 = parallel.get_mesh_2d(data_size=1, model_size=1, device=device)
    fits = {}
    for name, mesh in (("mesh-less", None), ("1-rank", mesh1),
                       ("1 x 1", mesh11)):
        fits[name] = tp_fit(root, f"masked_{name}", plain_train, plain_val,
                            mesh, device)
        launches += fits[name][2]  # fit_wrapper checks: one capture
    base = fits["mesh-less"]
    for name in ("1-rank", "1 x 1"):
        got = fits[name]
        check(got[0] == base[0] and got[1]["val_loss"] == base[1]["val_loss"]
              and got[1]["val_C_avg"] == base[1]["val_C_avg"],
              f"{name} mesh: step losses {got[0]}, val {got[1]} != mesh-less "
              f"{base[0]}, {base[1]}")
    timing = {}
    if on_card:
        xs, ys = plain_train[0]
        for name, got in fits.items():
            timing[name] = dp_step_ms(got[3], xs, ys)
    print(f"masked (c) ({card}): the x-vector on a 1-rank {mesh1.backend} "
          f"mesh and on a 1 x 1 mesh with the column-parallel rule, both "
          f"captured: step losses and validation == mesh-less bit for bit "
          f"({base[0]}, val_loss {base[1]['val_loss']!r})"
          + ("; fused train step [" + f"{MASKED_BATCH}, {samples}] "
             + ", ".join(f"{k} {v:.4f} ms" for k, v in timing.items())
             + " (CUDA events, medians)" if timing else "")
          + f"; {time.perf_counter() - t0:.1f} s for (c)")
    served_launches, served_reductions = one_rank_serving(
        root, mesh1, device, classify_argv)
    launches += served_launches
    reductions += served_reductions
    parallel.shutdown_distributed()
    if on_card:
        print(f"masked steps ({card}), medians in ms on CUDA events: "
              + "; ".join(
                  f"{r['config']} graphed (forked) " + ", ".join(
                      f"{v[0]:.4f}" for v in r["routes"]["port"])
                  + ", graphed serial " + ", ".join(
                      f"{v[0]:.4f}" for v in r["routes"]["serial"])
                  + ", eager (serial) " + ", ".join(
                      f"{v[0]:.4f}" for v in r["forms"]["eager"])
                  for r in rows if "routes" in r))
        print(f"masked table ({card}): " + json.dumps([
            {k: v for k, v in r.items()} for r in rows]))
    print(f"masked: logmel_kernel launches {launches}, logmel_reduce "
          f"{reductions}")
    return launches, reductions, err


def phase_tdnn_norm(device="cuda"):
    """ECAPA's TDNN tail (``ops/tdnn_norm.py``) at each of TDNN_WIDTHS:
    ``tdnn_norm.tdnn_norm`` forward and backward against the plain form in
    float64, one launch of each kernel counted on the card, then the
    device ms of the kernels and of the composed tail (bias add, ReLU,
    masked ``layers.BatchNorm``, the mask), forward and backward (the
    composed backward as its forward and backward less its forward), each
    replayed from a CUDA graph of 20 calls (``graph_ms``: the step replays
    them so), beside the bound of its passes over [32, C, 298] float32
    (forward 2, backward 3) at PEAK_BYTES; then ``tdnn_norm_fit``. Returns
    the kernels-line entries of both kernels: the launches counted, the
    largest absolute error, and the times at the widest channel."""
    from lidbox_tpu_torch.models import ecapa_tdnn, layers
    from lidbox_tpu_torch.ops import tdnn_norm

    t0 = time.perf_counter()
    tdnn_norm.build()
    print(f"build: {tdnn_norm.LIBRARY} in {time.perf_counter() - t0:.2f} s")
    eps = ecapa_tdnn.BN_EPSILON
    mask = (torch.arange(298)[None, :]
            < torch.tensor(TDNN_LENGTHS)[:, None]).to(device)
    one_each = dict.fromkeys(tdnn_norm.KERNELS, 1)
    launches = collections.Counter()
    abs_err = dict.fromkeys(tdnn_norm.KERNELS, 0.0)
    rows = []
    for channels in TDNN_WIDTHS:
        g = torch.Generator(device=device).manual_seed(SEED + channels)
        z = torch.randn(32, channels, 298, generator=g, device=device)
        bias, scale, shift = (
            torch.randn(channels, generator=g, device=device) * spread + mid
            for spread, mid in ((0.3, 0.0), (0.2, 1.0), (0.2, 0.0)))
        dy = torch.randn(z.shape, generator=g, device=device)
        leaves = [t.clone().requires_grad_(True)
                  for t in (z, bias, scale, shift)]
        tdnn_norm.reset_launch_counts(device)
        got = tdnn_norm.tdnn_norm(*leaves, mask, eps)
        got = [t.detach() for t in got] + list(
            torch.autograd.grad(got[0], leaves, dy))
        counted = tdnn_norm.launch_counts(device)
        check(counted == one_each, f"TDNN tail at C={channels}: launches "
              f"{counted}, not one of each kernel")
        launches.update(counted)
        leaves = [t.double().requires_grad_(True)
                  for t in (z, bias, scale, shift)]
        plain = tdnn_norm.tdnn_norm_plain(*leaves, mask, eps)
        plain = [t.detach() for t in plain] + list(
            torch.autograd.grad(plain[0], leaves, dy.double()))
        diffs = [(a.double() - b).abs().max().item()
                 for a, b in zip(got, plain)]
        err = max(d / b.abs().max().item() for d, b in zip(diffs, plain))
        check(err <= TDNN_TOL, f"TDNN tail kernels at C={channels}: "
              f"relative error {err:.3g} > {TDNN_TOL}")
        check(not got[0][0].any() and not got[3][0].any(),
              "the empty row's y and dz are not zero")
        for kernel, part in zip(tdnn_norm.KERNELS, (diffs[:3], diffs[3:])):
            abs_err[kernel] = max(abs_err[kernel], *part)
        _, mean, _, rstd = tdnn_norm.forward(z, bias, scale, shift, mask, eps)
        fwd_ms = graph_ms(lambda: tdnn_norm.forward(z, bias, scale, shift,
                                                    mask, eps))
        bwd_ms = graph_ms(lambda: tdnn_norm.backward(z, dy, bias, scale,
                                                     mean, rstd, mask))
        norm = layers.BatchNorm(channels, axis=1, epsilon=eps,
                                momentum=ecapa_tdnn.BN_MOMENTUM)
        norm = norm.to(device).train()
        zc, bc = (t.clone().requires_grad_(True) for t in (z, bias))
        weight = mask[:, None, :].float()

        def composed():
            return norm(torch.relu(zc + bc[:, None]), mask) * weight

        composed_fwd_ms = graph_ms(composed)
        # autograd's backward captures with its forward: the difference
        composed_bwd_ms = graph_ms(lambda: torch.autograd.grad(
            composed(), [zc, bc, norm.scale, norm.bias], dy)) - composed_fwd_ms
        pass_ms = 4 * z.numel() / PEAK_BYTES * 1e3
        row = {"channels": channels, "max_rel_err": err,
               "forward_ms": fwd_ms, "backward_ms": bwd_ms,
               "composed_forward_ms": composed_fwd_ms,
               "composed_backward_ms": composed_bwd_ms,
               "forward_bound_ms": 2 * pass_ms,
               "backward_bound_ms": 3 * pass_ms}
        print(f"tdnn_norm [32, {channels}, 298]: kernels {fwd_ms:.4f} + "
              f"{bwd_ms:.4f} ms, composed {composed_fwd_ms:.4f} + "
              f"{composed_bwd_ms:.4f} ms, bound {2 * pass_ms:.4f} + "
              f"{3 * pass_ms:.4f} ms (bytes), error {err:.3g}")
        rows.append(row)
    print(json.dumps({"tdnn_norm": rows}))
    with tempfile.TemporaryDirectory() as root:
        launches.update(tdnn_norm_fit(
            root, np.random.default_rng(SEED + 13), device))
    widest = rows[-1]
    return [{
        "name": kernel,
        "route": "cuda",
        "source": "lidbox_tpu_torch/csrc/tdnn_norm.cu",
        "replaces": None,
        "launches": launches[kernel],
        "max_abs_err": abs_err[kernel],
        "ms": widest[f"{part}_ms"],
        "plain_ms": widest[f"composed_{part}_ms"],
        "bound_ms": widest[f"{part}_bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
    } for kernel, part in zip(tdnn_norm.KERNELS, ("forward", "backward"))]


def ecapa_config(root, name):
    """train_config for the full-width ECAPA-TDNN with the energy VAD (so
    every batch comes with a frame mask); no metrics, no callbacks."""
    cfg = train_config(root)
    cfg["features"]["on_device_augment"] = {"vad": True}
    cfg["experiment"].update(name=name, model={"key": "ecapa_tdnn"},
                             metrics=[], callbacks=[])
    return cfg


def tdnn_norm_fit(root, rng, device="cuda"):
    """``fit_fused`` of the full-width ECAPA-TDNN for TDNN_FIT_BATCHES steps
    of class_sines_with_pauses with the energy VAD, each step a CUDA graph
    replay, under torch.profiler (so the program's spans record). The
    kernels' launches, zeroed just before and read just after, must equal
    the ``norm_fused`` counts of the ``lidbox.graph.*`` spans, less the
    captured bodies' (a capture records its body and runs nothing):
    TDNN_FIT_BATCHES replays of ECAPA_TDNNS each and the warm-up steps,
    forward and backward alike; no span counts ``norm_composed``. Then the
    same fit from the same weights with ``tdnn_norm.route`` forced to the
    composed tail: the first step's loss and gradient within
    TDNN_FIT_LOSS_TOL and TDNN_FIT_GRAD_TOL. Returns the launches."""
    from torch.profiler import ProfilerActivity, profile
    from lidbox_tpu_torch.models.model_utils import ModelWrapper
    from lidbox_tpu_torch.ops import tdnn_norm
    from lidbox_tpu_torch.train import graphs, observability

    train = class_sines_with_pauses(rng, TDNN_FIT_BATCHES)
    weights = {}

    def fit(name):
        wrapper = ModelWrapper.from_config(ecapa_config(root, name),
                                           device=device)
        module = wrapper.model.module
        if weights:
            module.load_state_dict(weights)
        else:
            weights.update((k, v.clone())
                           for k, v in module.state_dict().items())
        recorded, first = [], {}
        with recording_losses(recorded), first_step_moments(first):
            wrapper.fit_fused(lambda: train, epochs=1, verbose=False)
        losses = step_losses_of(recorded)
        check(len(losses) == TDNN_FIT_BATCHES
              and all(np.isfinite(losses)), f"ECAPA fit: losses {losses}")
        return losses, first

    observability.clear_spans()
    tdnn_norm.reset_launch_counts(device)
    with profile(activities=[ProfilerActivity.CPU]):
        fused, fused_first = fit("smoke_ecapa_fused")
        torch.cuda.synchronize()
    launched = tdnn_norm.launch_counts(device)
    runs = [r for r in observability.spans() if r.name in GRAPH_RUNS]
    observability.clear_spans()

    def counted(name, key="norm_fused"):
        return sum(r.attrs.get(key, 0) for r in runs if r.name == name)

    replays = [r for r in runs if r.name == "lidbox.graph.replay"]
    captured = counted("lidbox.graph.capture")
    warmed = captured * graphs.WARMUP_STEPS // (graphs.WARMUP_STEPS + 1)
    spans_fused = counted("lidbox.graph.replay") + warmed + counted(
        "lidbox.graph.eager")
    composed = sum(counted(name, "norm_composed") for name in GRAPH_RUNS)
    check(len(replays) == TDNN_FIT_BATCHES and all(
        r.attrs.get("norm_fused") == ECAPA_TDNNS for r in replays),
          f"ECAPA fit: replays counted "
          f"{[r.attrs.get('norm_fused') for r in replays]} fused tails, "
          f"not {TDNN_FIT_BATCHES} x {ECAPA_TDNNS}")
    check(composed == 0, f"ECAPA fit: {composed} composed tails counted")
    want = dict.fromkeys(tdnn_norm.KERNELS, spans_fused)
    check(launched == want, f"ECAPA fit: the card counted launches "
          f"{launched}, the spans' norm_fused {spans_fused} (replays "
          f"{counted('lidbox.graph.replay')}, warm-ups {warmed}, eager "
          f"{counted('lidbox.graph.eager')})")

    original = tdnn_norm.route
    tdnn_norm.route = lambda *args: "composed"
    try:
        plain, plain_first = fit("smoke_ecapa_composed")
    finally:
        tdnn_norm.route = original
    loss_gap = abs(fused[0] - plain[0]) / abs(plain[0])
    g_got, g_ref = ({k: torch.linalg.vector_norm(v.double()).item()
                     for k, v in first["moments"].items()}
                    for first in (fused_first, plain_first))
    g_med = float(np.median(list(g_ref.values())))
    grad_gap, worst = max((abs(g_got[k] - g_ref[k]) / max(g_ref[k], g_med), k)
                          for k in g_ref)
    check(loss_gap <= TDNN_FIT_LOSS_TOL and grad_gap <= TDNN_FIT_GRAD_TOL,
          f"ECAPA fit with the kernels against the composed tail: first "
          f"loss gap {loss_gap:.3g} (limit {TDNN_FIT_LOSS_TOL}), first "
          f"gradient gap {grad_gap:.3g} at {worst} (limit "
          f"{TDNN_FIT_GRAD_TOL})")
    share = 100.0 * spans_fused / (spans_fused + composed)
    print(f"ECAPA fit_fused, {TDNN_FIT_BATCHES} steps with the energy VAD: "
          f"launches {launched} = the spans' norm_fused (replays "
          f"{counted('lidbox.graph.replay')} + warm-ups {warmed}), "
          f"norm_composed 0, fused_norm_share {share:.1f}; against the "
          f"composed tail: first loss gap {loss_gap:.3e}, first gradient "
          f"gap {grad_gap:.3e} ({worst}); step losses {fused} against "
          f"{plain} (later steps drift: Adam)")
    return launched


@contextlib.contextmanager
def first_step_moments(sink):
    """Within it, ``sink["moments"]`` receives Adam's first moments after
    the first ``graphs.StepProgram`` step (parameter name -> tensor: the
    first gradient times 1 - beta_1)."""
    from lidbox_tpu_torch.train import graphs
    call = graphs.StepProgram.__call__

    def recording(program, trainer, state, inputs, generator=None):
        state, loss = call(program, trainer, state, inputs, generator)
        if "moments" not in sink:
            mu = next(s["mu"] for s in state.opt_state
                      if isinstance(s, dict) and "mu" in s)
            sink["moments"] = dict(zip(state.params,
                                       (m.clone() for m in mu)))
        return state, loss

    graphs.StepProgram.__call__ = recording
    try:
        yield sink
    finally:
        graphs.StepProgram.__call__ = call


def tdnn_norm_main():
    """Phase 18 alone (``python3 chip_smoke.py --tdnn-norm``)."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"card: {card_line()}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")
    print(json.dumps({"kernels": phase_tdnn_norm()}))
    return 0


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
        serve_launches, serve_reductions, batches = phase_serve(root, rng)
        # the training data has its own stream: phases before it do not
        # shift its draw
        torch.backends.cudnn.deterministic = True
        try:
            train_launches, train_batch, wrapper, val_features = \
                phase_train(root, np.random.default_rng(SEED + 1))
            served_launches, served_reductions, served_err = \
                phase_served_graphs(root, logmel, wrapper.trainer,
                                    val_features)
            aug_launches, aug_err, aug_batch, aug_wrapper = \
                phase_augmented_train(root, np.random.default_rng(SEED + 2),
                                      logmel)
            pipe_launches, pipe_err, pipe_timing, pipe_data = phase_pipeline(
                root, np.random.default_rng(SEED + 3), logmel)
            cli_launches, cli_err, _, classify_argv = phase_cli(
                root, logmel, pipe_data)
        finally:
            torch.backends.cudnn.deterministic = False
        zoo_launches, zoo_err, zoo_rows = phase_zoo(
            root, np.random.default_rng(SEED + 4), logmel)
        train_x = torch.as_tensor(train_batch[0], device="cuda")
        path_err, timing = phase_path_kernel(logmel,
                                             batches + [(train_x, RATE)])
        reduce_fields = phase_split_reduce(logmel, batches)
        clean_parts = phase_train_step_timing(
            wrapper, train_batch, timing[(*train_x.shape, "highest")][0])
        aug_parts = phase_augmented_step_timing(aug_wrapper, aug_batch)
        graph_launches = phase_graphs(
            root, np.random.default_rng(SEED + 8), logmel, wrapper,
            aug_wrapper, {"clean": clean_parts, "augmented": aug_parts,
                          "clean_batch": train_batch,
                          "augmented_batch": aug_batch}, zoo_rows)
        torch.backends.cudnn.deterministic = True
        try:
            dp_launches, dp_err = phase_data_parallel(
                root, np.random.default_rng(SEED + 5), logmel)
            tp_launches, tp_err = phase_tensor_parallel(
                root, np.random.default_rng(SEED + 6), logmel)
            orbax_launches, orbax_err = phase_orbax(
                root, np.random.default_rng(SEED + 7), logmel)
            masked_launches, masked_reductions, masked_err = phase_masked(
                root, np.random.default_rng(SEED + 11), logmel,
                classify_argv=classify_argv)
        finally:
            torch.backends.cudnn.deterministic = False
    tdnn_kernels = phase_tdnn_norm()
    if pipe_timing is not None:
        ms, plain_ms, bound_ms, bound_by, gemm_ms = pipe_timing
        print(f"fused_logmel [{PIPE_GROUP}, {2 * RATE}] 64 mel 20-7000 Hz "
              f"(phase 6, repeated): kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
              f"dft_gemm_ms {gemm_ms:.4f}")
    largest = max((k for k in timing if k[2] == "highest"),
                  key=lambda k: k[0] * k[1])
    ms, plain_ms, bound_ms, bound_by = timing[largest]
    print(f"kernel line: [{largest[0]}, {largest[1]}] highest; launches "
          f"{serve_launches} serving + {served_launches} served graphs + "
          f"{train_launches} training + "
          f"{aug_launches} augmented training + {pipe_launches} pipeline "
          f"(fit and embedding extraction) + {cli_launches} CLI + "
          f"{zoo_launches} model zoo + {graph_launches} graphs + "
          f"{dp_launches} data parallel + {tp_launches} tensor parallel + "
          f"{orbax_launches} Orbax + {masked_launches} masked, remat and "
          f"one-rank meshes; split reductions {serve_reductions} in "
          f"serving + {served_reductions} in served graphs + "
          f"{masked_reductions} masked and one-rank-mesh serving")

    print(json.dumps({"kernels": [{
        "name": "logmel_kernel",
        "route": "cuda",
        "source": "lidbox_tpu_torch/csrc/logmel.cu",
        "replaces": "lidbox_tpu/ops/logmel.py:154",
        "launches": (serve_launches + served_launches + train_launches
                     + aug_launches
                     + pipe_launches + cli_launches + zoo_launches
                     + graph_launches + dp_launches + tp_launches
                     + orbax_launches + masked_launches),
        "max_abs_err": max(geometry_err, path_err, served_err, aug_err,
                           pipe_err, cli_err, zoo_err, dp_err, tp_err,
                           orbax_err, masked_err),
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }, {
        "name": "logmel_reduce",
        "route": "cuda",
        "source": "lidbox_tpu_torch/csrc/logmel.cu",
        "replaces": "lidbox_tpu/ops/logmel.py:154",
        "launches": serve_reductions + served_reductions + masked_reductions,
        "max_abs_err": reduce_fields[0],
        "ms": reduce_fields[1],
        "plain_ms": reduce_fields[2],
        "bound_ms": reduce_fields[3],
        "bound_by": reduce_fields[4],
        "library_ms": None,
    }] + tdnn_kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-rank"]:
        sys.exit(dp_rank_main(sys.argv[2]))
    if sys.argv[1:2] == ["--dp-nccl-probe"]:
        sys.exit(dp_nccl_probe_main(sys.argv[2]))
    if sys.argv[1:2] == ["--tp-rank"]:
        sys.exit(tp_rank_main(sys.argv[2]))
    if sys.argv[1:2] == ["--tdnn-norm"]:
        sys.exit(tdnn_norm_main())
    sys.exit(main())

"""
The fused training path from raw waveforms, with the on-device
augmentation chain (counterpart of ``lidbox_tpu.data.on_device``).

Each train step takes a staged waveform batch [B, T] on the device and runs
the chain declared in the config's ``features`` section there: energy VAD
-> random speed change -> noise mixing from a device-resident bank -> random
FIR filtering -> features (with ``stft_method: "pallas"`` the fused log-Mel
CUDA kernel of ``ops/logmel.py``, launched once per step) -> SpecAugment,
then the model's forward and backward and the optimizer update. The host
only feeds waveform batches; the chain runs under ``torch.no_grad``. On the
card the whole step is one CUDA graph replay that updates the train state
in place (``train/graphs.py``, the JAX package's jitted step with
``donate=True``): grouped dispatch and a cached epoch are K replays.

Every stochastic stage is split in two: a draw (``draw_augmentation``,
``draw_spec_augment``) of its random values from an explicit
``torch.Generator`` on the batch's device, and a deterministic apply that
takes those values as tensors. torch cannot reproduce ``jax.random``
streams, so the applies are what the parity tests hold to the JAX package,
fed its draws. A train step seeds its generator from (the trainer's seed,
``state.step``) alone (``keyed_generator``), as the JAX package folds the
step into its key: grouped dispatch, cached replay and a restored run take
the same draws as per-step training. A captured step draws from one
generator re-seeded with that key before each replay.

Feed options: int16/bfloat16 staging with the targets packed into the int16
waveform stack, grouped dispatch (``steps_per_dispatch``), and cached replay
of the staged corpus from the device (``cache_staged`` with
``cache_shuffle`` False, True or "rows"), guarded by the device's memory.
Under a ``parallel.Mesh`` on the trainer every rank stages and featurizes
its own rows (the kernel runs on each rank's slice), and the draws are the
global batch's (``parallel.draw_rows``). On a 2-D (data, model) mesh the
ranks of one data row stage the same rows and featurize them alike, as
GSPMD replicates the features over the model axis.
"""
import dataclasses
import functools
import glob
import os
from typing import Optional, Tuple

import numpy as np
import torch

import lidbox_tpu_torch.features as F
from lidbox_tpu_torch import get_device, get_logger, parallel
from lidbox_tpu_torch.features import audio
from lidbox_tpu_torch.features import io as audio_io
from lidbox_tpu_torch.train.feed import Feed, plain_rows
from lidbox_tpu_torch.train.loop import keyed_generator, to_device, torch_dtype
from lidbox_tpu_torch.train.observability import ThroughputMeter

logger = get_logger("data.on_device")


def build_noise_bank(noise_paths, sample_rate, max_seconds=10.0,
                     device="cuda"):
    """Decode noise files into a bank on ``device``: (signals [N, T],
    lengths [N] original sample counts). Each clip is tiled cyclically to
    fill its row (the reference's tile-and-trim, lidbox/data/steps.py:296-302,
    done once), so the mixer takes any contiguous slice of a row."""
    T = int(sample_rate * max_seconds)
    signals = np.zeros((len(noise_paths), T), np.float32)
    lengths = np.zeros(len(noise_paths), np.int32)
    for i, path in enumerate(noise_paths):
        sig, rate = audio_io.read_audio(path)
        if rate != sample_rate:
            raise ValueError(f"noise sample rate {rate} != speech rate "
                             f"{sample_rate} ({path})")
        signals[i] = np.resize(sig, T)  # cyclic tile + trim
        lengths[i] = min(len(sig), T)
    logger.info("Staged noise bank: %d files, %.1f s rows", len(noise_paths),
                max_seconds)
    device = get_device(device)
    return (torch.as_tensor(signals, device=device),
            torch.as_tensor(lengths, device=device))


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    """Which on-device augmentations a fused step applies (the JAX
    package's fields and defaults).

    ``augment_prob < 1`` gates the stochastic stages (speed change, noise,
    FIR, SpecAugment) per example with a Bernoulli draw, so each batch
    interleaves clean and augmented examples (the reference's
    sample_from_datasets([original] + augmented), lidbox/data/steps.py:215-229).
    Energy VAD is preprocessing and is never gated. Noise mixing runs only
    with a noise bank."""
    snr_range: Optional[Tuple[float, float]] = (5.0, 20.0)   # None = no noise
    augment_prob: float = 1.0            # per-example P(apply augmentation)
    fir_coefs: int = 0                   # >0: random-normal FIR filtering
    speed_range: Optional[Tuple[float, float]] = None  # e.g. (0.9, 1.1)
    vad: bool = False                    # energy-VAD silence removal
    vad_frame_ms: int = 10
    vad_min_non_speech_ms: int = 300
    vad_strength: float = 0.1
    specaug_time_masks: int = 0          # SpecAugment time masks
    specaug_time_width: int = 20
    specaug_freq_masks: int = 0          # SpecAugment frequency masks
    specaug_freq_width: int = 8

    @property
    def tracks_lengths(self):
        """VAD and speed change alter each example's valid sample count, so
        the feature fn carries lengths and returns a frame mask."""
        return self.vad or self.speed_range is not None


# -- draws -------------------------------------------------------------------

def draw_augmentation(generator, augment, batch, samples, noise_bank=None,
                      device="cpu"):
    """The random values of one batch's waveform stages, drawn from
    ``generator`` in a fixed order: ``gate`` [B] bool (only when
    augment_prob < 1), ``speed`` ratios [B], ``noise`` (bank rows [B],
    SNRs [B] dB, offsets [B]) and ``fir`` taps [B, K], each only when its
    stage is on. Every bound is a Python number: nothing reads the device."""
    def uniform(lo, hi):
        u = torch.rand(batch, generator=generator, device=device)
        return lo + (hi - lo) * u

    draws = {}
    if augment.augment_prob < 1.0:
        draws["gate"] = (torch.rand(batch, generator=generator, device=device)
                         < augment.augment_prob)
    if augment.speed_range is not None:
        draws["speed"] = uniform(*augment.speed_range)
    if augment.snr_range is not None and noise_bank is not None:
        num_noise, bank_samples = noise_bank.shape
        if bank_samples < samples:
            raise ValueError(
                f"noise bank rows ({bank_samples} samples) shorter than "
                f"signals ({samples}); raise build_noise_bank(max_seconds=...)")
        idx = torch.randint(0, num_noise, (batch,), generator=generator,
                            device=device)
        snr = uniform(*augment.snr_range)
        offsets = torch.randint(0, bank_samples - samples + 1, (batch,),
                                generator=generator, device=device)
        draws["noise"] = (idx, snr, offsets)
    if augment.fir_coefs > 0:
        draws["fir"] = torch.randn(batch, augment.fir_coefs,
                                   generator=generator, device=device)
    return draws


def draw_spec_augment(generator, augment, feats_shape, device="cpu"):
    """SpecAugment's (time starts, time widths, freq starts, freq widths),
    each [B, n_masks] int64 or None when that axis has no masks: starts
    uniform in [0, max(L - 1, 1)), widths in [0, width]."""
    B, T, C = feats_shape

    def masks(n, axis_len, width):
        if n <= 0:
            return None, None
        starts = torch.randint(0, max(axis_len - 1, 1), (B, n),
                               generator=generator, device=device)
        widths = torch.randint(0, width + 1, (B, n), generator=generator,
                               device=device)
        return starts, widths

    return (*masks(augment.specaug_time_masks, T, augment.specaug_time_width),
            *masks(augment.specaug_freq_masks, C, augment.specaug_freq_width))


# -- deterministic applies -----------------------------------------------------

def mix_noise_from_bank(signals, noise_bank, idx, snr, offsets, lengths=None):
    """Mix bank row ``idx`` from sample ``offsets`` into each [B, T] row at
    ``snr`` dB (the reference's MS-SNSD formula, audio.snr_mixer). With
    ``lengths`` the RMS statistics cover the valid samples only and padding
    stays zero."""
    B, T = signals.shape
    # every T-sample window of every bank row, as a view: one gather
    noise = noise_bank.unfold(1, T, 1)[idx, offsets]
    mask = None
    if lengths is not None:
        mask = (torch.arange(T, device=signals.device)[None, :]
                < lengths[:, None])
    return audio.snr_mixer_batch(signals, noise, snr, mask=mask)


def random_speed_change_batch(signals, lengths, ratio):
    """Speed perturbation of [B, T] rows by ``ratio`` [B]: output[i] =
    input(i * ratio), linearly interpolated (the reference resampled from
    ratio * rate to rate, lidbox/data/steps.py:331-352). Returns (signals,
    new lengths floor((n - 1) / ratio) + 1, at most T); samples past the
    new length are zero.

    The positions round as the JAX package's jitted program rounds them.
    It splits i into 64-sample rows j and takes a row start
    floor(float32(j * ratio)); XLA contracts ``i * ratio - 64 * start``
    into a fused multiply-add, which rounds to float32 once. Here the
    product is exact in float64 and the difference is rounded once, which
    is the same value (a position of a sample that is then clipped at 0,
    as the JAX window clips it)."""
    B, T = signals.shape
    i = torch.arange(T, device=signals.device)
    start = torch.floor((i // 64).to(torch.float32)[None, :] * ratio[:, None])
    in_row = (i.to(torch.float64)[None, :] * ratio.to(torch.float64)[:, None]
              - 64.0 * start.to(torch.float64)).to(torch.float32)
    in_row = torch.clamp(in_row, min=0.0)
    floor_in_row = torch.floor(in_row)
    frac = in_row - floor_in_row
    lo = torch.clamp(start.to(torch.int64) * 64 + floor_in_row.to(torch.int64),
                     max=T)
    hi = torch.clamp(lo + 1, max=T)
    padded = torch.nn.functional.pad(signals, (0, 1))
    out = (torch.gather(padded, 1, lo) * (1.0 - frac)
           + torch.gather(padded, 1, hi) * frac)
    new_lengths = torch.floor((lengths.to(torch.float32) - 1.0) / ratio) + 1.0
    new_lengths = torch.clamp(new_lengths, 0, T).to(torch.int32)
    valid = (torch.arange(T, device=signals.device)[None, :]
             < new_lengths[:, None])
    return torch.where(valid, out, torch.zeros_like(out)), new_lengths


def energy_vad_compact_batch(signals, lengths, sample_rate, frame_ms=10,
                             min_non_speech_ms=300, strength=0.1):
    """Batched silence removal: the energy VAD over ``frame_ms`` windows,
    voiced windows compacted to the front of each row (audio.remove_silence
    on every row, reference: lidbox/features/audio.py:332-353). Returns
    (signals [B, T] with zero tails, new lengths)."""
    B, T = signals.shape
    decisions = audio.framewise_rms_energy_vad_decisions_batch(
        signals, lengths, sample_rate, frame_ms,
        min_non_speech_ms=min_non_speech_ms, strength=strength)
    window = audio.ms_to_frames(sample_rate, frame_ms)
    out, keep = audio.compact_voiced(
        audio.frame(signals, window, window, axis=-1), decisions)
    # the windows do not cover a partial tail: keep the shape
    out = torch.nn.functional.pad(out, (0, T - out.shape[1]))
    return out, (keep * window).to(torch.int32)


def random_fir(signals, firs):
    """Channel simulation (reference: lidbox/features/audio.py:63-74): each
    [B, T] row filtered causally by its own taps ``firs`` [B, K]."""
    return audio.fir_filter(signals, firs)


def spec_augment(feats, time_starts=None, time_widths=None, freq_starts=None,
                 freq_widths=None, mask_value=0.0):
    """SpecAugment-style masking (Park et al. 2019) of [B, T, C] features:
    the frames in [start, start + width) of each time mask, and the
    channels of each frequency mask, take ``mask_value``."""
    B, T, C = feats.shape

    def hit(starts, widths, axis_len):
        coords = torch.arange(axis_len, device=feats.device)
        inside = ((coords >= starts[..., None])
                  & (coords < (starts + widths)[..., None]))
        return torch.any(inside, dim=1)             # [B, axis_len]

    fill = torch.full((), mask_value, dtype=feats.dtype, device=feats.device)
    if time_starts is not None:
        feats = torch.where(hit(time_starts, time_widths, T)[:, :, None],
                            fill, feats)
    if freq_starts is not None:
        feats = torch.where(hit(freq_starts, freq_widths, C)[:, None, :],
                            fill, feats)
    return feats


# -- config --------------------------------------------------------------------

def augment_config_from_dict(d):
    """Declarative form of AugmentConfig (the ``on_device_augment``
    features-config subsection)::

        on_device_augment:
          noise_datadir: /data/musan     # or noise_paths: [...]
          snr_range: [5, 20]
          augment_prob: 0.5              # P(example is augmented)
          fir_coefs: 10
          speed_range: [0.9, 1.1]
          vad: true
          specaug: {time_masks: 2, time_width: 20, freq_masks: 2, freq_width: 8}
    """
    spec = d.get("specaug") or {}
    prob = float(d.get("augment_prob", 1.0))
    if not 0.0 <= prob <= 1.0:
        # a typo'd probability (e.g. 5 for 0.5) would silently train
        # all-augmented; refuse instead
        raise ValueError(
            f"on_device_augment.augment_prob must be in [0, 1], got {prob}")
    return AugmentConfig(
        snr_range=tuple(d["snr_range"]) if d.get("snr_range") else None,
        augment_prob=prob,
        fir_coefs=int(d.get("fir_coefs", 0)),
        speed_range=(tuple(d["speed_range"]) if d.get("speed_range")
                     else None),
        vad=bool(d.get("vad", False)),
        vad_frame_ms=int(d.get("vad_frame_ms", 10)),
        vad_min_non_speech_ms=int(d.get("vad_min_non_speech_ms", 300)),
        vad_strength=float(d.get("vad_strength", 0.1)),
        specaug_time_masks=int(spec.get("time_masks", 0)),
        specaug_time_width=int(spec.get("time_width", 20)),
        specaug_freq_masks=int(spec.get("freq_masks", 0)),
        specaug_freq_width=int(spec.get("freq_width", 8)))


def feature_fn_from_config(sample_rate, features_conf, device="cuda"):
    """The fused feature fn straight from a config dict's ``features``
    section (with its ``on_device_augment`` subsection); a noise bank is
    staged on ``device``."""
    features_conf = dict(features_conf)
    aug = dict(features_conf.pop("on_device_augment", None) or {})
    noise_bank = noise_lengths = None
    paths = aug.pop("noise_paths", None)
    datadir = aug.pop("noise_datadir", None)
    max_seconds = float(aug.pop("noise_max_seconds", 10.0))
    if paths is None and datadir:
        paths = sorted(
            p for ext in ("wav", "mp3")
            for p in glob.glob(os.path.join(datadir, "**", f"*.{ext}"),
                               recursive=True))
        if not paths:
            # a configured-but-empty noise dir must not silently train an
            # entire run without the noise augmentation the user asked for
            raise ValueError(
                f"on_device_augment.noise_datadir {datadir!r} contains no "
                "wav/mp3 files (typo in the path?)")
    if paths:
        noise_bank, noise_lengths = build_noise_bank(
            paths, sample_rate, max_seconds=max_seconds, device=device)
    elif aug.get("snr_range") is not None:
        raise ValueError(
            "on_device_augment.snr_range is set but no noise source was "
            "given — configure noise_paths or noise_datadir, or remove "
            "snr_range")
    return make_augmented_feature_fn(
        sample_rate, features_conf, augment_config_from_dict(aug),
        noise_bank=noise_bank, noise_lengths=noise_lengths)


def make_augmented_feature_fn(sample_rate, feature_config, augment: AugmentConfig,
                              noise_bank=None, noise_lengths=None):
    """(generator, signals [B, T], lengths=None, draws=None, on_stage=None)
    -> features [B, frames, C], or (features, frame_mask [B, frames]) when
    the config tracks lengths or lengths are passed: energy VAD -> speed
    change -> noise mix -> FIR -> ``features.extract_features`` (the
    config's ``stft_method``, default "matmul", and ``precision``) ->
    SpecAugment, under ``torch.no_grad``.

    The random values come from ``generator`` (draw_augmentation, then
    draw_spec_augment once the features' shape is known; inside
    ``parallel.data_parallel`` this rank's rows of the global batch's
    draws) unless ``draws`` gives them: the dict draw_augmentation
    returns, with the SpecAugment tuple under "spec". ``on_stage(name)`` is called after each stage that
    ran ("draw", "vad", "speed", "noise", "fir", "features", "specaug"), for
    timing.
    ``noise_lengths`` is unused: the bank's rows are tiled full width."""
    del noise_lengths
    feature_config = dict(feature_config)
    feature_type = feature_config.pop("type", "logmelspectrogram")
    feature_config.pop("validate_finite", None)
    stft_method = feature_config.pop("stft_method", "matmul")
    precision = feature_config.pop("precision", "highest")
    kwargs = {k: v for k, v in feature_config.items()
              if k in ("spectrogram", "melspectrogram", "mfcc",
                       "db_spectrogram", "sample_minmax_scaling",
                       "window_normalization")}
    specaug = augment.specaug_time_masks > 0 or augment.specaug_freq_masks > 0

    @torch.no_grad()
    def fn(generator, signals, lengths=None, draws=None, on_stage=None):
        def done(name):
            if on_stage is not None:
                on_stage(name)

        with_mask = augment.tracks_lengths or lengths is not None
        B, T = signals.shape
        if lengths is None:
            lengths = torch.full((B,), T, dtype=torch.int32,
                                 device=signals.device)
        if draws is None:
            draws = parallel.draw_rows(
                lambda rows: draw_augmentation(generator, augment, rows, T,
                                               noise_bank, signals.device), B)
        done("draw")
        gate = draws.get("gate")

        def gated(new, old):
            if gate is None:
                return new
            return torch.where(gate.view((B,) + (1,) * (new.dim() - 1)),
                               new, old)

        if augment.vad:  # preprocessing, never gated
            signals, lengths = energy_vad_compact_batch(
                signals, lengths, sample_rate, frame_ms=augment.vad_frame_ms,
                min_non_speech_ms=augment.vad_min_non_speech_ms,
                strength=augment.vad_strength)
            done("vad")
        if "speed" in draws:
            sp, sp_len = random_speed_change_batch(signals, lengths,
                                                   draws["speed"])
            signals, lengths = gated(sp, signals), gated(sp_len, lengths)
            done("speed")
        if "noise" in draws:
            mixed = mix_noise_from_bank(
                signals, noise_bank, *draws["noise"],
                lengths=lengths if with_mask else None)
            signals = gated(mixed, signals)
            done("noise")
        if "fir" in draws:
            signals = gated(random_fir(signals, draws["fir"]), signals)
            done("fir")
        feats = F.extract_features(signals, sample_rate,
                                   feature_type=feature_type,
                                   stft_method=stft_method,
                                   precision=precision,
                                   lengths=lengths if with_mask else None,
                                   return_mask=with_mask, **kwargs)
        frame_mask = None
        if with_mask:
            feats, frame_mask = feats  # the mask the features were masked with
        done("features")
        if specaug:
            spec = draws.get("spec")
            if spec is None:
                spec = parallel.draw_rows(
                    lambda rows: draw_spec_augment(
                        generator, augment, (rows,) + feats.shape[1:],
                        feats.device), B)
            feats = gated(spec_augment(feats, *spec), feats)
            done("specaug")
        if with_mask:
            return feats, frame_mask
        return feats
    fn.sample_rate = int(sample_rate)  # observability: fit_signals RTF
    fn.tracks_lengths = augment.tracks_lengths  # its features carry a mask
    return fn


# -- staging -------------------------------------------------------------------

def stage_signals(signals, stage_dtype=None):
    """Host-side waveform staging compression for the fused path.

    ``stage_dtype="int16"`` quantizes [-1, 1] float waveforms to 16-bit PCM
    (half the bytes over the feed link, the quantization most corpora carry
    already); ``"bfloat16"`` halves float traffic for synthetic or >16-bit
    sources. numpy has no bfloat16: that staging returns a CPU torch
    tensor (``to_device`` pins it). The train step rescales int16 and
    upcasts on the device (signals_to_float)."""
    signals = np.asarray(signals)
    if stage_dtype is None:
        return (signals if signals.dtype in (np.float32, np.int16)
                else signals.astype(np.float32))
    dt = torch_dtype(stage_dtype)
    if dt == torch.int16:
        if signals.dtype == np.int16:
            return signals
        return np.clip(np.rint(np.asarray(signals, np.float32) * 32768.0),
                       -32768, 32767).astype(np.int16)
    if signals.dtype == np.int16:
        # raw PCM -> float staging: rescale to [-1, 1] before the cast (the
        # device edge only upcasts floats)
        signals = signals.astype(np.float32) * (1.0 / 32768.0)
    if dt == torch.float32:
        return np.asarray(signals, np.float32)
    return torch.from_numpy(np.ascontiguousarray(signals)).to(dt)


def pack_targets_int16(signals, targets):
    """Append one int16 row carrying the targets to a staged [.., B, T]
    int16 waveform stack (the ``targets=None`` layout of
    make_fused_train_step: row B's first B slots), so signals and targets
    cross to the device as one array. None when the layout does not apply:
    non-int16 staging, B > T, or targets outside [0, 32767] (negative
    ignore-markers take the two-transfer path)."""
    if not isinstance(signals, np.ndarray) or signals.dtype != np.int16:
        return None
    b, t = signals.shape[-2], signals.shape[-1]
    if b > t or targets.max(initial=0) >= 32768 or targets.min(initial=0) < 0:
        return None
    packed = np.empty(signals.shape[:-2] + (b + 1, t), np.int16)
    packed[..., :b, :] = signals
    packed[..., b, :] = 0
    packed[..., b, :b] = targets
    return packed


def signals_to_float(signals):
    """Device-side decompression: int16 PCM scales by 1/32768, any other
    dtype upcasts to float32."""
    if signals.dtype == torch.int16:
        return signals.to(torch.float32) * (1.0 / 32768.0)
    if signals.dtype != torch.float32:
        return signals.to(torch.float32)
    return signals


# -- steps ---------------------------------------------------------------------

def _fused_batch(feature_fn):
    """``batch(trainer, inputs, augment_generator)``: the feature batch of
    one fused step, augmentation and features of ``inputs["signals"]``
    drawn from ``augment_generator`` (``inputs["targets"]`` None: the
    packed layout, int16 [B + 1, T] with the targets in row B's first B
    slots)."""
    def batch(trainer, inputs, augment_generator):
        signals, targets = inputs["signals"], inputs["targets"]
        if targets is None:  # packed layout: the last row carries targets
            b = signals.shape[0] - 1
            targets = signals[-1, :b].to(torch.int64)
            signals = signals[:-1]
        with parallel.data_parallel(trainer.mesh):
            feats = feature_fn(augment_generator, signals_to_float(signals))
        out = {"target": targets}
        if isinstance(feats, tuple):  # length-tracking fn: (feats, mask)
            out["input"], out["input_mask"] = feats
        else:
            out["input"] = feats
        if inputs["example_mask"] is not None:
            out["example_mask"] = inputs["example_mask"]
        return out
    return batch


def _fused_program(trainer, feature_fn, eager=False):
    """The trainer's ``graphs.StepProgram`` of fused steps on
    ``feature_fn``, shared by the step builders below: it draws from a
    generator keyed (trainer seed, state.step, 7)."""
    return trainer.step_program(
        "fused", feature_fn, eager, batch=_fused_batch(feature_fn),
        augment=True)


def _inputs(signals, targets, example_mask):
    return {"signals": signals, "targets": targets,
            "example_mask": example_mask}


def make_fused_train_step(trainer, feature_fn, eager=False):
    """One train step from raw waveforms: augmentation and features (on the
    device) -> model forward/backward -> optimizer update.

    Returns step(state, signals [B, T], targets [B], generator=None,
    example_mask=None) -> (new_state, loss); ``generator`` feeds dropout.
    The augmentation draws from a generator seeded from
    (trainer.seed, state.step) alone. ``targets=None`` selects the packed
    staging layout: ``signals`` is int16 [B + 1, T] with the targets in row
    B's first B slots. Under the trainer's mesh the step runs inside
    ``parallel.data_parallel``: the draws are the global batch's.

    On the card the step is a CUDA graph replay that writes the new state
    into ``state``'s tensors (``graphs.StepProgram``; the CPU runs that
    donating step eagerly); ``eager=True`` builds the functional step,
    whose new state is new tensors (the graph's reference)."""
    program = _fused_program(trainer, feature_fn, eager)

    def step(state, signals, targets, generator=None, example_mask=None):
        return program(trainer, state,
                       _inputs(signals, targets, example_mask), generator)
    return step


def _featurize_val(val_feats, val_batches, device, mesh=None):
    """The validation signal batches ((signals, targets) or (signals,
    targets, example_mask)) as feature batch dicts of ``val_feats`` (on the
    float signals), kept on the device.
    Batch i draws from its own generator, keyed (0, i) as the JAX package
    keys it fold_in(PRNGKey(0), i): an augmenting fn gives each batch its
    own draws, the same on every call (the global batch's under a
    mesh)."""
    eval_batches = []
    vit = val_batches() if callable(val_batches) else val_batches
    for i, (signals, targets, *mask) in enumerate(vit):
        with parallel.data_parallel(mesh):
            out = val_feats(keyed_generator(device, 0, i),
                            signals_to_float(to_device(signals, device)))
        batch = {"target": to_device(np.asarray(targets, np.int64), device)}
        if isinstance(out, tuple):
            batch["input"], batch["input_mask"] = out
        else:
            batch["input"] = out
        if mask and mask[0] is not None:
            batch["example_mask"] = to_device(np.asarray(mask[0], bool),
                                              device)
        eval_batches.append(batch)
    return eval_batches


def _staged_inputs(trainer, signals, targets, mask=None):
    """A host batch (signals [B, T], targets [B], example_mask [B] or None)
    or a [k, ...] stack of them as the fused program's step inputs on the
    trainer's device (``_inputs``): staged (stage_signals), with the targets
    packed into an int16 stack where the layout applies (targets None)."""
    signals = stage_signals(signals, trainer.stage_dtype)
    targets = np.asarray(targets, np.int64)
    mask = None if mask is None else to_device(np.asarray(mask, bool),
                                               trainer.device)
    packed = pack_targets_int16(signals, targets)
    if packed is not None:
        return _inputs(to_device(packed, trainer.device), None, mask)
    return _inputs(to_device(signals, trainer.device),
                   to_device(targets, trainer.device), mask)


def _staged_group(trainer, group):
    """Same-shape host batches as one [k, ...] stack of step inputs."""
    masks = [b[2] if len(b) > 2 else None for b in group]
    return _staged_inputs(trainer, np.stack([b[0] for b in group]),
                          np.stack([b[1] for b in group]),
                          None if masks[0] is None else np.stack(masks))


def _signal_count(batch):
    """(rows, samples) of a host signal batch."""
    return int(np.shape(batch[1])[0]), int(np.prod(np.shape(batch[0])))


def _signal_signature(batch):
    """What the signal batches of one stacked group share."""
    return np.shape(batch[0]), len(batch) > 2 and batch[2] is not None


def _example_rows(stack):
    """``feed.plain_rows`` of a stack of fused step inputs, the packed
    layout (targets None) read in place: the signals at a pitch of B + 1
    rows a batch, the targets from row B's first B slots."""
    if stack["targets"] is not None:
        return plain_rows(stack)
    signals, mask = stack["signals"], stack["example_mask"]
    B = signals.shape[1] - 1
    return B, {
        "signals": (signals.reshape((-1,) + tuple(signals.shape[2:])), B + 1),
        "targets": (signals[:, B, :B].reshape(-1).to(torch.int64), B),
        "example_mask": None if mask is None else (mask.reshape(-1), B)}


def fit_signals(trainer, feature_fn, signal_batches, epochs=1, verbose=True,
                val_batches=None, val_feature_fn=None,
                val_feature_batches=None, steps_per_dispatch=1,
                cache_staged=None, cache_shuffle=True, eager=False):
    """Train directly from raw waveform batches through the fused path:
    every step augments and featurizes its batch on the device and trains
    on it (make_fused_train_step), with no per-step host readback. On the
    card each step is one CUDA graph replay updating ``trainer.state`` in
    place, and each validation step one replay (``Trainer.evaluate``);
    ``eager=True`` runs the functional steps instead, in training and in
    validation (the graphs' reference).

    ``signal_batches``: callable or re-iterable collection of
    (signals [B, T], targets [B]) numpy pairs, or (signals, targets,
    example_mask [B]) triples whose False rows are padding; with
    ``epochs > 1`` a one-shot generator raises after epoch 1 instead of
    silently training on nothing. Validation after every epoch comes from
    either ``val_batches`` (signal pairs or triples, featurized once per
    fit through ``val_feature_fn``, default ``feature_fn``; pass a clean fn
    for standard validation) or ``val_feature_batches`` (already-featurized
    dict batches). Epoch numbering resumes from ``trainer.initial_epoch``
    and ``epochs`` is the absolute target, mirroring Trainer.fit. Returns
    per-epoch dicts with ``loss`` (+ ``val_loss``/metrics) when
    validating, plain float losses otherwise.

    The batches reach the steps through the feed ``Trainer.fit`` uses
    (``train/feed.py``). Staging follows ``trainer.stage_dtype``
    (stage_signals); int16 stacks carry their targets in an extra row
    (pack_targets_int16), one transfer per step. ``steps_per_dispatch=K``
    stages K consecutive same-shape batches as one [K, B(+1), T] transfer
    for K steps, with per-step numerics identical to K single steps.

    ``cache_staged`` (default: the trainer's setting) keeps the staged raw
    waveform batches on the device after epoch 1: later epochs transfer no
    signals while augmentation stays fresh per epoch (it follows the step
    counter). ``cache_shuffle`` re-permutes the cached batch order each
    epoch, drawn from ``np.random.default_rng(RANDOM_SEED + epoch)`` as in
    the JAX package; ``"rows"`` also re-draws batch composition, gathering
    each step's rows from the cached stacks; False replays epoch 1's order.
    The staged corpus is held to the device's memory budget
    (Trainer.cache_bytes_limit): when twice its bytes (consolidation holds
    originals and stacks at once) would exceed it, the cache is released
    with a warning and every epoch streams.

    Under the trainer's mesh each rank feeds its own rows of every global
    batch (``parallel.local_slice``), the staged feeds pass the feed-parity
    guard, every step is the global batch's (``Trainer._loss_and_grads``,
    ``parallel.data_parallel``), and cache_shuffle="rows" replays from the
    global cache, gathered onto every rank after epoch 1."""
    program = _fused_program(trainer, feature_fn, eager)
    feed = Feed(trainer, functools.partial(program, trainer), signal_batches,
                stage=lambda b: _staged_inputs(trainer, *b),
                stage_group=functools.partial(_staged_group, trainer),
                count=_signal_count, signature=_signal_signature,
                rows=_example_rows, steps_per_dispatch=steps_per_dispatch,
                cache_staged=(trainer.cache_staged if cache_staged is None
                              else cache_staged),
                cache_shuffle=cache_shuffle)
    if trainer.state is None:
        trainer.create_state()
    # a fresh fit starts training anew even if a previous fit on this
    # trainer was stopped early (mirrors Trainer.fit / Keras)
    trainer.stop_training = False
    validating = val_batches is not None or val_feature_batches is not None
    eval_cache = None

    def eval_batches():
        """The validation feature batches: ``val_feature_batches``, or
        ``val_batches`` featurized once (each batch's draws are keyed by its
        index, so every epoch would get the same)."""
        nonlocal eval_cache
        if val_feature_batches is not None:
            return list(val_feature_batches() if callable(val_feature_batches)
                        else val_feature_batches)
        if eval_cache is None:
            eval_cache = _featurize_val(
                val_feature_fn if val_feature_fn is not None else feature_fn,
                val_batches, trainer.device, trainer.mesh)
        return eval_cache

    # audio-seconds throughput (RTF): samples / sample_rate, with the rate
    # taken from the feature fn (make_augmented_feature_fn tags it)
    sr = float(getattr(feature_fn, "sample_rate", 0) or 0)
    for cb in trainer.callbacks:
        cb.on_train_begin(trainer)
    history = []
    for epoch in range(trainer.initial_epoch + 1, epochs + 1):
        for cb in trainer.callbacks:
            cb.on_epoch_begin(trainer, epoch)
        losses = []
        meter = ThroughputMeter()
        for loss, n, samples in feed.epoch(epoch):
            losses.append(loss)
            meter.update(n, samples / sr if sr else 0.0)
        if not losses and not validating:
            # a one-shot iterator (generator) exhausts after epoch 1 and
            # would silently "train" on zero batches with loss=nan
            raise ValueError(
                f"fused epoch {epoch} received no training batches — "
                "signal_batches must be a CALLABLE (or re-iterable "
                "collection) when epochs > 1; a generator is consumed by "
                "the first epoch")
        mean_loss = (float(torch.stack(losses).mean()) if losses
                     else float("nan"))
        logs = {"loss": mean_loss, **meter.rates()}
        if validating:
            batches = functools.cache(eval_batches)  # built once at most
            staged = feed.staged_validation(batches)
            logs.update(
                trainer.evaluate(batches(), eager=eager) if staged is None
                else trainer.evaluate(staged, staged=True, eager=eager))
        history.append(logs if validating else mean_loss)
        if trainer.metrics_logger:
            trainer.metrics_logger.log(epoch, logs)
        for cb in trainer.callbacks:
            cb.on_epoch_end(trainer, epoch, logs)
        if verbose and validating:
            logger.info("fused epoch %d/%d: %s", epoch, epochs, logs)
        elif verbose:
            logger.info("fused epoch %d/%d: loss=%.6g", epoch, epochs,
                        mean_loss)
        if trainer.stop_training:
            break
    trainer.release_graphs()
    trainer.sync_model_variables()
    for cb in trainer.callbacks:
        cb.on_train_end(trainer)
    return history

"""
The fused training path from raw waveforms (counterpart of
``lidbox_tpu.data.on_device``).

Each train step takes a staged waveform batch [B, T] on the device, runs
the feature chain declared in the config's ``features`` section there
(with ``stft_method: "pallas"``, the fused log-Mel CUDA kernel of
``ops/logmel.py``, launched once per step), then the model's forward and
backward and the optimizer update. The host only feeds waveform batches.
The features carry no gradient: the chain runs under ``torch.no_grad``.

Ported: the clean chain (every augmentation stage off), its config
parsing, ``make_fused_train_step`` and ``fit_signals`` with one dispatch
per step and validation featurized once per fit.

Not ported yet, and raising (ROADMAP queue 1, item 7): the augmentation
stages (noise bank, random speed change, energy VAD, FIR filtering,
SpecAugment), int16/bfloat16 staging with packed targets, grouped dispatch
(``steps_per_dispatch > 1``) and the cached replay (``cache_staged``).
"""
import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

import lidbox_tpu_torch.features as F
from lidbox_tpu_torch import get_logger
from lidbox_tpu_torch.train.loop import to_device
from lidbox_tpu_torch.train.observability import ThroughputMeter

logger = get_logger("data.on_device")


def _not_ported(name):
    raise NotImplementedError(f"{name} is not ported yet (ROADMAP queue 1, "
                              "item 7)")


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    """Which on-device augmentations a fused step applies (the JAX
    package's fields and defaults). ``augment_prob < 1`` gates the
    stochastic stages per example; noise mixing runs only with a noise
    bank. Every stage is left for ROADMAP queue 1, item 7: a feature fn
    with one of them on raises."""
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


def augment_config_from_dict(d):
    """Declarative form of AugmentConfig (the ``on_device_augment``
    features-config subsection)::

        on_device_augment:
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


def feature_fn_from_config(sample_rate, features_conf):
    """The fused feature fn straight from a config dict's ``features``
    section (with its ``on_device_augment`` subsection)."""
    features_conf = dict(features_conf)
    aug = dict(features_conf.pop("on_device_augment", None) or {})
    paths = aug.pop("noise_paths", None)
    datadir = aug.pop("noise_datadir", None)
    aug.pop("noise_max_seconds", None)
    if paths or datadir:
        _not_ported("on_device_augment noise mixing (noise_paths, "
                    "noise_datadir)")
    if aug.get("snr_range") is not None:
        raise ValueError(
            "on_device_augment.snr_range is set but no noise source was "
            "given — configure noise_paths or noise_datadir, or remove "
            "snr_range")
    return make_augmented_feature_fn(sample_rate, features_conf,
                                     augment_config_from_dict(aug))


def make_augmented_feature_fn(sample_rate, feature_config, augment: AugmentConfig,
                              noise_bank=None, noise_lengths=None):
    """(generator, signals [B, T], lengths=None) -> features
    [B, frames, C], or (features, frame_mask [B, frames]) when lengths
    are passed: ``features.extract_features`` with the config's
    ``stft_method`` (default "matmul") and ``precision``, under
    ``torch.no_grad``. ``generator`` would feed the augmentation stages,
    none of which is ported: one that is on raises here."""
    enabled = [name for name, on in (
        ("noise mixing", noise_bank is not None),
        ("random speed change", augment.speed_range is not None),
        ("energy VAD", augment.vad),
        ("FIR filtering", augment.fir_coefs > 0),
        ("SpecAugment", augment.specaug_time_masks > 0
         or augment.specaug_freq_masks > 0)) if on]
    if enabled:
        _not_ported("on-device augmentation (" + ", ".join(enabled) + ")")
    feature_config = dict(feature_config)
    feature_type = feature_config.pop("type", "logmelspectrogram")
    feature_config.pop("validate_finite", None)
    stft_method = feature_config.pop("stft_method", "matmul")
    precision = feature_config.pop("precision", "highest")
    kwargs = {k: v for k, v in feature_config.items()
              if k in ("spectrogram", "melspectrogram", "mfcc",
                       "db_spectrogram", "sample_minmax_scaling",
                       "window_normalization")}

    @torch.no_grad()
    def fn(generator, signals, lengths=None):
        with_mask = lengths is not None
        return F.extract_features(signals, sample_rate,
                                  feature_type=feature_type,
                                  stft_method=stft_method,
                                  precision=precision,
                                  lengths=lengths, return_mask=with_mask,
                                  **kwargs)
    fn.sample_rate = int(sample_rate)  # observability: fit_signals RTF
    return fn


def signals_to_float(signals):
    """Device-side decompression: int16 PCM scales by 1/32768, any other
    dtype upcasts to float32."""
    if signals.dtype == torch.int16:
        return signals.to(torch.float32) * (1.0 / 32768.0)
    if signals.dtype != torch.float32:
        return signals.to(torch.float32)
    return signals


def make_fused_train_step(trainer, feature_fn):
    """One train step from raw waveforms: features (on the device) ->
    model forward/backward -> optimizer update.

    Returns step(state, signals [B, T], targets [B], generator=None,
    example_mask=None) -> (new_state, loss). ``targets=None`` (the JAX
    package's packed int16 layout) is not ported (ROADMAP queue 1,
    item 7)."""
    def step(state, signals, targets, generator=None, example_mask=None):
        if targets is None:
            _not_ported("the packed int16 staging layout (targets=None)")
        feats = feature_fn(generator, signals_to_float(signals))
        batch = {"target": targets}
        if isinstance(feats, tuple):  # length-tracking fn: (feats, mask)
            batch["input"], batch["input_mask"] = feats
        else:
            batch["input"] = feats
        if example_mask is not None:
            batch["example_mask"] = example_mask
        return trainer._train_step(state, batch, generator)
    return step


def _featurize_val(val_feats, val_batches, device):
    """The validation signal batches as feature batch dicts, kept on the
    device for every later evaluate()."""
    eval_batches = []
    vit = val_batches() if callable(val_batches) else val_batches
    for signals, targets in vit:
        out = val_feats(None, to_device(signals, device))
        batch = {"target": to_device(np.asarray(targets, np.int64), device)}
        if isinstance(out, tuple):
            batch["input"], batch["input_mask"] = out
        else:
            batch["input"] = out
        eval_batches.append(batch)
    return eval_batches


def fit_signals(trainer, feature_fn, signal_batches, epochs=1, verbose=True,
                val_batches=None, val_feature_fn=None,
                val_feature_batches=None, steps_per_dispatch=1,
                cache_staged=None, cache_shuffle=True):
    """Train directly from raw waveform batches through the fused path:
    every step featurizes its batch on the device and trains on it
    (make_fused_train_step), with no per-step host readback.

    ``signal_batches``: callable or re-iterable collection of
    (signals [B, T], targets [B]) numpy pairs; with ``epochs > 1`` a
    one-shot generator raises after epoch 1 instead of silently training
    on nothing. Validation after every epoch comes from either
    ``val_batches`` (same signal-pair shape, featurized once per fit
    through ``val_feature_fn``, default ``feature_fn``) or
    ``val_feature_batches`` (already-featurized dict batches). Epoch
    numbering resumes from ``trainer.initial_epoch`` and ``epochs`` is the
    absolute target, mirroring Trainer.fit. Returns per-epoch dicts with
    ``loss`` (+ ``val_loss``/metrics) when validating, plain float losses
    otherwise.

    Not ported yet (ROADMAP queue 1, item 7): ``steps_per_dispatch > 1``
    and ``cache_staged`` (so ``cache_shuffle`` has nothing to shuffle)."""
    if int(steps_per_dispatch) > 1:
        _not_ported("steps_per_dispatch > 1")
    if cache_staged:
        _not_ported("cache_staged")
    step = make_fused_train_step(trainer, feature_fn)
    if trainer.state is None:
        trainer.create_state()
    # a fresh fit starts training anew even if a previous fit on this
    # trainer was stopped early (mirrors Trainer.fit / Keras)
    trainer.stop_training = False
    validating = val_batches is not None or val_feature_batches is not None
    eval_cache = None
    if val_batches is not None:
        vfn = val_feature_fn if val_feature_fn is not None else feature_fn

        def val_feats(generator, signals):
            return vfn(generator, signals_to_float(signals))

    def stage(batch):
        signals, targets = batch
        if not isinstance(signals, torch.Tensor):
            signals = np.asarray(signals)
            if signals.dtype not in (np.float32, np.int16):
                signals = signals.astype(np.float32)
        return (to_device(signals, trainer.device),
                to_device(np.asarray(targets, np.int64), trainer.device))

    def count(batch):
        signals, targets = batch
        return int(np.shape(targets)[0]), int(np.prod(np.shape(signals)))

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
        staged = trainer._staged(signal_batches, count_fn=count, put=stage)
        try:
            for (n, samples), (signals, targets) in staged:
                trainer.state, loss = step(trainer.state, signals, targets,
                                           trainer.generator)
                losses.append(loss)
                meter.update(n, samples / sr if sr else 0.0)
        finally:
            staged.close()
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
        if not validating:
            epoch_logs = {"loss": mean_loss, **meter.rates()}
            history.append(mean_loss)
            if trainer.metrics_logger:
                trainer.metrics_logger.log(epoch, epoch_logs)
            for cb in trainer.callbacks:
                cb.on_epoch_end(trainer, epoch, epoch_logs)
            if verbose:
                logger.info("fused epoch %d/%d: loss=%.6g", epoch, epochs,
                            mean_loss)
            if trainer.stop_training:
                break
            continue
        if val_feature_batches is not None:
            eval_batches = list(val_feature_batches()
                                if callable(val_feature_batches)
                                else val_feature_batches)
        else:
            # featurize the validation set once: the clean chain gives the
            # same features every epoch
            if eval_cache is None:
                eval_cache = _featurize_val(val_feats, val_batches,
                                            trainer.device)
            eval_batches = eval_cache
        logs = {"loss": mean_loss, **meter.rates(),
                **trainer.evaluate(eval_batches)}
        history.append(logs)
        if trainer.metrics_logger:
            trainer.metrics_logger.log(epoch, logs)
        for cb in trainer.callbacks:
            cb.on_epoch_end(trainer, epoch, logs)
        if verbose:
            logger.info("fused epoch %d/%d: %s", epoch, epochs, logs)
        if trainer.stop_training:
            break
    trainer.sync_model_variables()
    for cb in trainer.callbacks:
        cb.on_train_end(trainer)
    return history

"""
Batched feature extraction on the device (counterpart of
``lidbox_tpu.data.device_pipeline``).

Host numpy signals are padded to a (batch, length) bucket, moved to
``device`` and run through ``features.extract_features`` with their true
lengths, so per-sample statistics see only real frames; the features come
back sliced to each signal's true frame count.

The JAX package jits one program per (sample rate, masked) and shape
(``_jit_by_rate``); here the extraction is one CUDA graph per (sample
rate, masked, batch and signal shape), replayed
(``graphs.ForwardProgram``, kind "features"): the fused log-Mel kernel
and its split reduction run inside it. The signals are copied into the
graph's input buffer from pinned host memory. On the CPU, or with
``eager=True``, the extraction runs eagerly.
"""
import functools

import numpy as np
import torch

import lidbox_tpu_torch.features as F
from lidbox_tpu_torch import get_device
from lidbox_tpu_torch.data.dataset import pick_bucket
from lidbox_tpu_torch.features import audio
from lidbox_tpu_torch.train import graphs

# Signal-length buckets in samples (@16 kHz: 0.5 s .. 64 s, x2 growth)
DEFAULT_SIGNAL_BUCKETS = tuple(8000 * 2 ** i for i in range(8))
DEFAULT_BATCH_BUCKETS = (1, 8, 32, 64)

FEATURE_KWARG_KEYS = ("spectrogram", "melspectrogram", "mfcc", "db_spectrogram",
                      "sample_minmax_scaling", "window_normalization")


class DeviceFeatureExtractor:
    """Maps numpy signal batches to numpy feature batches computed on
    ``device``, one graph replay per shape (``eager=True``: eagerly, the
    graphs' reference)."""

    def __init__(self, config, device="cuda", eager=False):
        config = dict(config)
        self.device = get_device(device)
        self.program = graphs.ForwardProgram("features", eager=eager)
        self.feature_type = config.get("type", "logmelspectrogram")
        # opt-in host check of every extracted batch (the reference's
        # assert_all_finite, lidbox/data/tf_utils.py:173-191)
        self.validate_finite = bool(config.get("validate_finite", False))
        self.stft_method = config.get("stft_method", "matmul")
        self.precision = config.get("precision", "highest")
        spec = config.get("spectrogram") or {}
        self.frame_length_ms = spec.get("frame_length_ms", 25)
        self.frame_step_ms = spec.get("frame_step_ms", 10)
        self.signal_buckets = tuple(config.get("signal_buckets",
                                               DEFAULT_SIGNAL_BUCKETS))
        self.batch_buckets = tuple(config.get("batch_buckets",
                                              DEFAULT_BATCH_BUCKETS))
        self.feature_kwargs = {k: dict(config[k]) for k in FEATURE_KWARG_KEYS
                               if config.get(k)}

    def features(self, signals, sample_rate, lengths=None):
        """The extraction itself, eagerly: [B, T] float32 signals (and
        their [B] lengths) on ``device`` -> [B, frames, C] features."""
        return F.extract_features(signals, int(sample_rate),
                                  feature_type=self.feature_type,
                                  stft_method=self.stft_method,
                                  precision=self.precision, lengths=lengths,
                                  **self.feature_kwargs)

    def extract(self, signals, sample_rate, lengths=None):
        """[B, T] float32 tensor on ``device`` or in (pinned) host memory,
        [B] int64 ``lengths`` likewise -> [B, frames, C] features on
        ``device`` (no host round trip): one graph replay per (sample
        rate, masked, shapes)."""
        rate = int(sample_rate)
        return self.program(
            functools.partial(self.features, sample_rate=rate),
            {"signals": signals, "lengths": lengths}, self.device, key=rate)

    def host_tensor(self, array):
        """A host array as a tensor the extraction copies without a sync:
        pinned when the extraction runs on the card."""
        x = torch.from_numpy(np.ascontiguousarray(array))
        return x.pin_memory() if self.device.type == "cuda" else x

    def to_host(self, feats):
        out = feats.cpu().numpy()
        if self.validate_finite and not np.all(np.isfinite(out)):
            bad = int((~np.isfinite(out)).sum())
            raise FloatingPointError(
                f"feature extraction produced {bad} non-finite values "
                f"(feature_type={self.feature_type})")
        return out

    def num_frames(self, num_samples, sample_rate):
        fl = audio.ms_to_frames(sample_rate, self.frame_length_ms)
        fs = audio.ms_to_frames(sample_rate, self.frame_step_ms)
        return audio.num_frames(num_samples, fl, fs)

    @torch.inference_mode()
    def __call__(self, signals, sample_rate):
        """signals: numpy [B, T] (equal length). -> numpy [B, frames, C]."""
        return self.to_host(self.extract(
            self.host_tensor(np.asarray(signals, np.float32)), sample_rate))

    @torch.inference_mode()
    def extract_ragged(self, signal_list, sample_rate):
        """List of 1-D numpy signals (any lengths) -> list of [frames_i, C]
        feature arrays, through one padded (batch, length) bucket with the
        true lengths threaded in."""
        lengths = [len(s) for s in signal_list]
        t_bucket = pick_bucket(max(lengths), self.signal_buckets)
        b_bucket = pick_bucket(len(signal_list), self.batch_buckets)
        batch = np.zeros((b_bucket, t_bucket), np.float32)
        clipped = np.zeros(b_bucket, np.int64)
        for i, s in enumerate(signal_list):
            clipped[i] = min(len(s), t_bucket)
            batch[i, :clipped[i]] = s[:t_bucket]
        feats = self.to_host(self.extract(self.host_tensor(batch), sample_rate,
                                          lengths=self.host_tensor(clipped)))
        return [feats[i, :self.num_frames(min(n, t_bucket), sample_rate)]
                for i, n in enumerate(lengths)]


@functools.lru_cache(maxsize=8)
def default_extractor(feature_type="logmelspectrogram", num_mel_bins=64,
                      device="cuda"):
    return DeviceFeatureExtractor({
        "type": feature_type,
        "melspectrogram": {"num_mel_bins": num_mel_bins},
    }, device=device)

"""
Batched feature extraction on the device (counterpart of
``lidbox_tpu.data.device_pipeline``).

Host numpy signals are padded to a (batch, length) bucket, moved to
``device`` and run through ``features.extract_features`` with their true
lengths, so per-sample statistics see only real frames; the features come
back sliced to each signal's true frame count. PyTorch runs eagerly, so
the JAX package's per-bucket jit cache has no counterpart here.
"""
import functools

import numpy as np
import torch

import lidbox_tpu_torch.features as F
from lidbox_tpu_torch import get_device
from lidbox_tpu_torch.data.dataset import pick_bucket
from lidbox_tpu_torch.features import audio

# Signal-length buckets in samples (@16 kHz: 0.5 s .. 64 s, x2 growth)
DEFAULT_SIGNAL_BUCKETS = tuple(8000 * 2 ** i for i in range(8))
DEFAULT_BATCH_BUCKETS = (1, 8, 32, 64)

FEATURE_KWARG_KEYS = ("spectrogram", "melspectrogram", "mfcc", "db_spectrogram",
                      "sample_minmax_scaling", "window_normalization")


class DeviceFeatureExtractor:
    """Maps numpy signal batches to numpy feature batches computed on
    ``device``."""

    def __init__(self, config, device="cuda"):
        config = dict(config)
        self.device = get_device(device)
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

    def extract(self, signals, sample_rate, lengths=None):
        """[B, T] float32 tensor on ``device`` -> [B, frames, C] features
        on ``device`` (no host round trip)."""
        return F.extract_features(signals, int(sample_rate),
                                  feature_type=self.feature_type,
                                  stft_method=self.stft_method,
                                  precision=self.precision, lengths=lengths,
                                  **self.feature_kwargs)

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
        x = torch.as_tensor(np.asarray(signals, np.float32), device=self.device)
        return self.to_host(self.extract(x, sample_rate))

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
        feats = self.to_host(self.extract(
            torch.as_tensor(batch, device=self.device), sample_rate,
            lengths=torch.as_tensor(clipped, device=self.device)))
        return [feats[i, :self.num_frames(min(n, t_bucket), sample_rate)]
                for i, n in enumerate(lengths)]


@functools.lru_cache(maxsize=8)
def default_extractor(feature_type="logmelspectrogram", num_mel_bins=64,
                      device="cuda"):
    return DeviceFeatureExtractor({
        "type": feature_type,
        "melspectrogram": {"num_mel_bins": num_mel_bins},
    }, device=device)

"""
Feed-engineered training example on PyTorch and CUDA (``lidbox_tpu_torch``,
the counterpart of examples/fused_feed_training.py): raw waveforms -> one
train step per batch on the card (on-device augmentation, the fused
log-Mel CUDA kernel, x-vector forward, backward and update), fed through
the tuned host->device pipeline:

- int16 PCM staging (half the feed bytes; targets packed into the same
  transfer),
- `steps_per_dispatch`: several train steps per transfer,
- `cache_staged`: epochs 2+ train from device-resident waveforms with no
  feed traffic (augmentation stays fresh per epoch).

Everything is declared in the config's `experiment.feed` section. Runs on
the card by default; `--device cpu` runs the plain PyTorch version:

    python examples/fused_feed_training_torch.py [--device cpu] [--epochs N]
"""
import argparse
import os
import sys
import tempfile

import numpy as np

# runnable without installation: `python examples/fused_feed_training_torch.py`
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

from lidbox_tpu_torch import testutil
from lidbox_tpu_torch.data import on_device
from lidbox_tpu_torch.features import io as audio_io
from lidbox_tpu_torch.models.model_utils import ModelWrapper

SR = 16000
SECONDS = 2.0
LABELS = ("fi", "et", "sv")
BATCH = 16


def synth_corpus(n_per_lang=16):
    """Class-separable synthetic waveform batches (tone + noise)."""
    batches = []
    rng = np.random.default_rng(0)
    sigs, targets = [], []
    for t, _ in enumerate(LABELS):
        for i in range(n_per_lang):
            sigs.append(testutil.noisy_sinewave(220.0 * (t + 1), SR, 0.1,
                                                SECONDS, seed=100 * t + i))
            targets.append(t)
    order = rng.permutation(len(sigs))
    for lo in range(0, len(sigs), BATCH):
        idx = order[lo:lo + BATCH]
        batches.append((np.stack([sigs[i] for i in idx]).astype(np.float32),
                        np.asarray([targets[i] for i in idx], np.int32)))
    return batches


def main(device="cuda", epochs=5):
    """Train with the fused chain on ``device``; returns the epoch
    losses."""
    frames = 1 + (int(SR * SECONDS) - 400) // 160
    cache = tempfile.mkdtemp(prefix="lidbox_fused_torch_")
    # a real noise source for the SNR-mixing stage (snr_range without one
    # is a config error: the stage would otherwise silently not run)
    noise_path = os.path.join(cache, "noise.wav")
    audio_io.write_mono_wav(
        noise_path,
        np.random.default_rng(7).normal(0, 0.1, SR).astype(np.float32), SR)
    features = {
        "type": "logmelspectrogram",
        "sample_rate": SR,
        "melspectrogram": {"num_mel_bins": 40},
        "stft_method": "pallas",  # the fused log-Mel kernel on the card
    }
    config = {
        "features": dict(features, on_device_augment={
            "snr_range": [10, 25],
            "noise_paths": [noise_path],
            "fir_coefs": 10,
            "specaug": {"time_masks": 2, "freq_masks": 2},
        }),
        "experiment": {
            "cache_directory": cache, "name": "fused-feed",
            "input_shape": [frames, 40], "output_shape": [len(LABELS)],
            "model": {"key": "xvector"},
            "optimizer": {"cls": "Adam", "kwargs": {"learning_rate": 2e-3}},
            "loss": {"cls": "SparseCategoricalCrossentropy"},
            # host->device feed tuning, fully declarative:
            "feed": {
                "prefetch": 6,             # staged transfers in flight
                "stage_dtype": "int16",    # PCM staging, targets packed in
                "steps_per_dispatch": 2,   # 2 train steps per transfer
                "cache_staged": True,      # epochs 2+ feed-free
            },
        },
    }
    wrapper = ModelWrapper.from_config(config, device=device)
    batches = synth_corpus()
    print(f"training on {sum(b[1].size for b in batches)} utterances, "
          f"{len(batches)} batches, feed={config['experiment']['feed']}")
    history = wrapper.fit_fused(lambda: batches, epochs=epochs)
    losses = [h if isinstance(h, float) else h["loss"] for h in history]
    print("epoch losses:", " ".join(f"{l:.4f}" for l in losses))
    assert losses[-1] < losses[0], "loss should decrease"

    # serve the trained model directly: fit_fused synced its weights
    clean = on_device.feature_fn_from_config(SR, features, device=device)
    signals = torch.as_tensor(batches[0][0], device=device)
    with torch.inference_mode():
        preds = wrapper.model.apply(clean(None, signals)).cpu().numpy()
    acc = float((preds.argmax(1) == batches[0][1]).mean())
    print(f"train-batch accuracy after {epochs} fused epochs: {acc:.2f}")
    return losses


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--epochs", type=int, default=5)
    args = parser.parse_args()
    main(device=args.device, epochs=args.epochs)

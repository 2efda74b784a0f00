"""The benchmark's inputs, made from the seed: noisy class tones.

Class k is a tone at 200 + 300 k Hz (+-20 Hz, random phase) in white noise
of twice the tone's amplitude, each signal scaled to a peak of 0.5: hard
enough that a classifier does not drive its loss to zero in a few steps.
Bulk arrays are drawn on the device from a ``torch.Generator``; small
decisions (orders, lengths, labels) from ``numpy.random.default_rng``.
"""
import math

import numpy as np
import torch

# purposes the seed is split into, so that each draw has its own stream
WEIGHTS, INPUTS, ORDER, CHECK = range(4)


def sub_seed(seed, purpose):
    """A 64-bit seed of ``purpose`` from the run's seed (any integer)."""
    ss = np.random.SeedSequence([int(seed) % 2 ** 63, purpose])
    return int(ss.generate_state(1, np.uint64)[0])


def generator(seed, purpose, device):
    return torch.Generator(device=device).manual_seed(sub_seed(seed, purpose))


def class_tones(gen, labels, samples, rate, device, noise=2.0, peak=0.5):
    """[N, samples] float32 on ``device``: row i a noisy tone of class
    ``labels[i]``."""
    labels = torch.as_tensor(labels, device=device, dtype=torch.float32)
    n = labels.shape[0]
    t = torch.arange(samples, device=device, dtype=torch.float32) / rate
    f = 200.0 + 300.0 * labels + 40.0 * (
        torch.rand(n, generator=gen, device=device) - 0.5)
    phase = 2 * math.pi * torch.rand(n, generator=gen, device=device)
    x = torch.sin(2 * math.pi * f[:, None] * t[None] + phase[:, None])
    x += noise * torch.randn(n, samples, generator=gen, device=device)
    return peak * x / x.abs().amax(dim=1, keepdim=True)


def with_pauses(gen, signals, rate, min_s, max_s):
    """Each row with one silent stretch of min_s..max_s seconds."""
    n, samples = signals.shape
    device = signals.device
    width = (rate * (min_s + (max_s - min_s)
                     * torch.rand(n, generator=gen, device=device))).long()
    start = ((samples - width)
             * torch.rand(n, generator=gen, device=device)).long()
    i = torch.arange(samples, device=device)[None]
    silent = (i >= start[:, None]) & (i < (start + width)[:, None])
    return torch.where(silent, torch.zeros_like(signals), signals)


def segments(rng, total, min_len, max_len, num_classes):
    """[(start, end, label)] covering [0, total) with segment lengths drawn
    uniformly in [min_len, max_len] (the last one cut)."""
    out, start = [], 0
    while start < total:
        end = min(total, start + int(rng.integers(min_len, max_len + 1)))
        out.append((start, end, int(rng.integers(num_classes))))
        start = end
    return out

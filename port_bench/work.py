"""The benchmark's yardstick: the card's peaks and the work of each
computation, counted from shapes.

Peaks are NVIDIA's data sheet for one H100 SXM at its 700 W limit (dense
rates, no sparsity). Operations count a multiply-add as two. Model counts
are of the products (convolutions, dense layers, recurrent matrices);
elementwise work, pooling and normalization count nothing, so a share of
the peak is a lower bound of the work done.
"""
import numpy as np

from port_bench import reference
from port_bench.reference import logmel as ref_logmel

PEAK_FLOPS = {"float32": 67e12, "tf32": 495e12, "bf16": 989e12}
PEAK_BYTES = 3.35e12
# the log-Mel kernel's products per algorithmic product and their peak:
# "highest" runs each float32 product as 3 TF32 products, "bf16" as one
LOGMEL_PRODUCTS = {"highest": (3, "tf32"), "bf16": (1, "bf16")}


def model_peak(config):
    """Peak FLOP/s of the precision a configuration states."""
    if config["dtype"] == "float32":
        return PEAK_FLOPS["tf32" if config["tf32"] else "float32"]
    return PEAK_FLOPS[config["dtype"]]


def logmel_geometry(features):
    """(frame length, frame step, DFT rows L, weighted bins NB, mel bins):
    L = min(frame length, fft length) samples reach the DFT, and NB is the
    number of bins up to the last one with a nonzero mel weight."""
    rate = features["sample_rate"]
    fl = ref_logmel.ms_to_samples(rate, features["frame_length_ms"])
    fs = ref_logmel.ms_to_samples(rate, features["frame_step_ms"])
    fft = features["fft_length"]
    mel = ref_logmel.mel_matrix(features["num_mel_bins"], fft // 2 + 1, rate,
                                features["fmin"], features["fmax"])
    nb = int(np.flatnonzero(mel.any(axis=1))[-1]) + 1
    return fl, fs, min(fl, fft), nb, features["num_mel_bins"]


def logmel_flops(frames, features):
    """Algorithmic operations of ``frames`` log-Mel frames: the DFT
    product over the weighted bins (cos and sin) and the mel product."""
    _, _, L, nb, n_mel = logmel_geometry(features)
    return 2 * frames * (L * 2 * nb + nb * n_mel)


def logmel_work(batch, samples, features):
    """(operations, bytes) of one kernel call on [batch, samples]: every
    frame of the call; the signal read once and the log-Mel written once,
    float32."""
    fl, fs, _, _, n_mel = logmel_geometry(features)
    frames = ref_logmel.num_frames(samples, fl, fs)
    return (logmel_flops(batch * frames, features),
            4 * batch * samples + 4 * batch * frames * n_mel)


def bound_seconds(flops, nbytes, peak_flops):
    """(least seconds the card could take, "operations" or "bytes")."""
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def logmel_bound(batch, samples, features):
    """The kernel's own bound on [batch, samples]: its tensor-core products
    at their peak, or the bytes at the memory's rate."""
    flops, nbytes = logmel_work(batch, samples, features)
    products, peak = LOGMEL_PRODUCTS[features["precision"]]
    return bound_seconds(products * flops, nbytes, PEAK_FLOPS[peak])


def forward_flops(config, frames):
    """Operations of one utterance's forward over ``frames`` valid
    frames."""
    return 2 * reference.model(config["reference"]).macs(config, frames)[0]


def train_flops(config, frames):
    """Operations of one example's forward and backward over ``frames``
    valid frames: the forward, the weight gradients (as many), and the
    input gradients of every layer but the first, whose input, the
    features, takes none."""
    macs, first = reference.model(config["reference"]).macs(config, frames)
    return 2 * (3 * macs - first)

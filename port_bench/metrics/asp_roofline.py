"""asp_roofline.<part>: percent of the attentive statistics pooling's bound
(``asp_bound``) that the device time of the package's pooling layer
(``models.ecapa_tdnn.AttentiveStatisticsPooling``), forward and backward
in training mode, reaches at the cell's shape: [batch, channels, frames]
of the configuration's pooled channels and the crops' frames, masked to
the first batch's valid frames (the package's VAD), under torch.profiler,
every device operation of the calls counted. None where the package has
no such layer, or the trace recorded no device time."""
import torch

from port_bench import common, program, signals, work
from port_bench.reference import logmel as ref_logmel
from port_bench.reference import wav as ref_wav

CALLS = 10
WARMUP = 3


def asp_work(batch, channels, frames, attention):
    """(operations, bytes) of the pooling's forward and backward on
    [batch, channels, frames] with ``attention`` attention channels. The
    forward's products, the attention TDNN (3 channels -> attention) and
    convolution (attention -> channels) over every frame, and its two
    weighted sums (the mean, then the squared deviations) over every
    channel and frame; the backward, twice the forward (the products'
    weight and input gradients). Bytes: h read, the attention TDNN's
    3 x channels input, the attention weights, the [batch, 2 x channels]
    output, float32, each once."""
    products = 2 * batch * frames * (3 * channels * attention
                                     + attention * channels)
    sums = 2 * 2 * batch * channels * frames
    flops = 3 * (products + sums)
    nbytes = 4 * (batch * channels * frames * (1 + 3 + 1)
                  + batch * 2 * channels)
    return flops, nbytes


def asp_bound(batch, channels, frames, attention, config):
    """(least seconds, "operations" or "bytes") at the configuration's
    peak (``work.model_peak``) or the memory's rate."""
    flops, nbytes = asp_work(batch, channels, frames, attention)
    return work.bound_seconds(flops, nbytes, work.model_peak(config))


def first_batch_frames(run):
    """(frames of a crop, valid frames of each row of the first batch as
    the package's energy VAD keeps them)."""
    f = run.config["features"]
    rate = f["sample_rate"]
    fl = ref_logmel.ms_to_samples(rate, f["frame_length_ms"])
    fs = ref_logmel.ms_to_samples(rate, f["frame_step_ms"])
    x = run.cell.batches[0][0]
    total = ref_logmel.num_frames(x.shape[1], fl, fs)
    vad = run.cell._vad_args()
    if vad is None:
        return total, [total] * x.shape[0]
    q = torch.as_tensor(ref_wav.pcm_values(x), device=run.ctx.device)
    kept = program.vad_lengths(q, rate, vad)
    return total, [ref_logmel.num_frames(n, fl, fs) for n in kept]


def read(run):
    try:
        from lidbox_tpu_torch.models import ecapa_tdnn
    except ImportError:
        return None
    channels = run.config["channels"][-1]
    attention = run.config["attention_channels"]
    device = run.ctx.device
    total, lengths = first_batch_frames(run)
    batch = len(lengths)
    pool = ecapa_tdnn.AttentiveStatisticsPooling(channels, attention).to(
        device).train()
    mask = (torch.arange(total, device=device)[None]
            < torch.as_tensor(lengths, device=device)[:, None])
    frames = ecapa_tdnn.Frames.of(mask, torch.float32)
    gen = signals.generator(run.ctx.seed, signals.CHECK, device)
    h = (torch.randn(batch, channels, total, generator=gen, device=device)
         * frames.weight).requires_grad_(True)
    leaves = [h] + list(pool.parameters())
    grad = torch.ones(batch, 2 * channels, device=device)

    def call():
        torch.autograd.grad(pool(h, frames), leaves, grad_outputs=grad)
    for _ in range(WARMUP):
        call()
    seconds = common.device_seconds_per_call(call, CALLS, ("",))
    if seconds is None:
        return None
    bound = asp_bound(batch, channels, total, attention, run.config)[0]
    return 100.0 * bound / seconds

"""logmel_roofline.<part>: percent of the log-Mel kernel's bound
(``work.logmel_bound``) that its device time reaches on the largest
[batch, samples] the cell launched it with: the device time per call of
the package's public ``fused_logmel`` (the kernel and its split
reduction), under torch.profiler, on the benchmark's tones of that shape.
None where the cell launched no kernel or the trace recorded none."""
import torch

from port_bench import common, program, signals, work

CALLS = 20


def read(run):
    if not run.cell.kernel_shapes:
        return None
    batch, samples = max(run.cell.kernel_shapes, key=lambda s: s[0] * s[1])
    f = run.config["features"]
    x = signals.class_tones(
        signals.generator(run.ctx.seed, signals.CHECK, run.ctx.device),
        [0] * batch, samples, f["sample_rate"], run.ctx.device)
    with torch.no_grad():
        seconds = common.device_seconds_per_call(
            lambda: program.fused_logmel(x, run.config), CALLS,
            ("logmel_kernel", "logmel_reduce"))
    if seconds is None:
        return None
    return 100.0 * work.logmel_bound(batch, samples, f)[0] / seconds

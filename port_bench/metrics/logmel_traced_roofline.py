"""logmel_traced_roofline.<part>: percent of the log-Mel kernel's bound
(``work.logmel_bound``) on the largest [batch, samples] the cell launched
it with that its device time per launch reaches inside the cell's own
steps or chunks: the traced stretch's device seconds of the kernel and its
split reduction (``run.trace["kernels"]``) over the ``logmel_kernel``
launches that the stretch's program runs carry (``launches`` of the
``lidbox.graph.*`` spans). None where the cell launched no kernel, or the
trace or the spans hold none."""
from port_bench import spans, work

KERNELS = ("logmel_kernel", "logmel_reduce")


def read(run):
    if run.trace is None or not run.cell.kernel_shapes:
        return None
    launches = sum((r.attrs.get("launches") or {}).get(KERNELS[0], 0)
                   for r in spans.stretch(run) if r.name in spans.GRAPH_RUNS)
    seconds = sum(s for name, s in run.trace["kernels"].items()
                  if any(k in name for k in KERNELS))
    if not launches or not seconds:
        return None
    batch, samples = max(run.cell.kernel_shapes, key=lambda s: s[0] * s[1])
    bound = work.logmel_bound(batch, samples, run.config["features"])[0]
    return 100.0 * bound / (seconds / launches)

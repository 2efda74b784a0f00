"""mfu.<part>: percent of the configuration's peak that the window's useful
model and log-Mel operations reached over the window's length (the cell's
``useful_flops()``, ``work.model_peak``). None where the cell counts none."""
from port_bench import work


def read(run):
    flops = run.cell.useful_flops()
    if not flops:
        return None
    return 100.0 * flops / run.window["seconds"] / work.model_peak(run.config)

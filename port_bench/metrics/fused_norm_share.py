"""fused_norm_share.<part>: percent of the training-mode TDNN tails (conv
bias, ReLU, masked BatchNorm, frame mask) in the traced stretch's program
runs that ran as the fused kernels of ``ops/tdnn_norm.py``:
``norm_fused`` over ``norm_fused`` + ``norm_composed``, the counts the
``lidbox.graph.*`` spans of ``train/graphs.py`` carry (a replay's, those
of its captured body; ``chip_smoke.py`` phase 18 holds these counts to
the launches the kernels count on the card). None where no such tail ran,
or the program counts none."""
from port_bench import spans


def read(run):
    runs = [r for r in spans.stretch(run) if r.name in spans.GRAPH_RUNS]
    fused = sum(r.attrs.get("norm_fused", 0) for r in runs)
    composed = sum(r.attrs.get("norm_composed", 0) for r in runs)
    if not fused + composed:
        return None
    return 100.0 * fused / (fused + composed)

"""rnn_fork_share.<part>: percent of the frame-masked two-direction
recurrent layer runs in the traced stretch that ran their two directions
concurrently on two CUDA streams: ``rnn_forked`` over ``rnn_forked`` +
``rnn_serial``, the counts the ``lidbox.graph.*`` spans of
``train/graphs.py`` carry (a replay's, those of its captured body). None
where no such layer ran, or the program counts none."""
from port_bench import spans


def read(run):
    runs = [r for r in spans.stretch(run) if r.name in spans.GRAPH_RUNS]
    forked = sum(r.attrs.get("rnn_forked", 0) for r in runs)
    serial = sum(r.attrs.get("rnn_serial", 0) for r in runs)
    if not forked + serial:
        return None
    return 100.0 * forked / (forked + serial)

"""replay_share.<part>: percent of the program runs in the traced stretch
that were replays of a captured graph, of the replays, captures and eager
runs (the ``lidbox.graph.*`` spans of ``train/graphs.py``). Below 100: a
capture or an eager run in the stretch. None where the program recorded
none."""
from port_bench import spans


def read(run):
    runs = [r for r in spans.stretch(run) if r.name in spans.GRAPH_RUNS]
    if not runs:
        return None
    replays = sum(r.name == "lidbox.graph.replay" for r in runs)
    return 100.0 * replays / len(runs)

"""masked_stats_share.<part>: percent of the statistics over frames (a
frame-masked model's input mean, training batch normalizations, squeezes
and pooling) in the traced stretch's program runs that ran over each row's
valid frames alone: ``stats_masked`` over ``stats_masked`` +
``stats_full``, the counts the ``lidbox.graph.*`` spans of
``train/graphs.py`` carry (a replay's, those of its captured body). None
where the program counts none."""
from port_bench import spans


def read(run):
    runs = [r for r in spans.stretch(run) if r.name in spans.GRAPH_RUNS]
    masked = sum(r.attrs.get("stats_masked", 0) for r in runs)
    full = sum(r.attrs.get("stats_full", 0) for r in runs)
    if not masked + full:
        return None
    return 100.0 * masked / (masked + full)

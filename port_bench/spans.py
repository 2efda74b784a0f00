"""The measured package's own spans in a run's traced stretch, which the
readers of ``metrics/`` that read the program's spans share.

The package records a span (``lidbox_tpu_torch.train.observability.span``)
only while a torch.profiler runs, and keeps it in memory
(``observability.spans()``). The traced stretch follows the window: it
starts once the profiler has started, which its first span marks, and
lasts ``run.trace["window_s"]``. A package that records no spans gives
none, and each reader then None; so does a run whose list of spans filled
up (``observability.dropped_spans()``), which would cut the stretch
short."""

# a program's runs: a graph replayed, a graph captured, a body run eagerly
GRAPH_RUNS = ("lidbox.graph.replay", "lidbox.graph.capture",
              "lidbox.graph.eager")


def stretch(run):
    """The spans that started in the run's traced stretch, in the order
    they started; [] without a trace or spans, or with spans dropped."""
    if run.trace is None:
        return []
    from lidbox_tpu_torch.train import observability
    recorded = getattr(observability, "spans", None)
    if recorded is None or observability.dropped_spans():
        return []
    return between(recorded(), run.window["start"] + run.window["seconds"],
                   run.trace["window_s"])


def between(records, after, seconds):
    """The finished ``records`` that started within ``seconds`` of the
    first to start at or after ``after`` (seconds on
    ``time.perf_counter``)."""
    later = [r for r in records
             if r.start_ns >= after * 1e9 and r.end_ns is not None]
    if not later:
        return []
    end = min(r.start_ns for r in later) + seconds * 1e9
    return [r for r in later if r.start_ns <= end]


def seconds(span):
    return (span.end_ns - span.start_ns) * 1e-9


def named(records, name):
    return [r for r in records if r.name == name]


def mean_ms(run, name):
    """The mean length in ms of the stretch's spans ``name``; None
    without one."""
    found = named(stretch(run), name)
    if not found:
        return None
    return 1e3 * sum(map(seconds, found)) / len(found)

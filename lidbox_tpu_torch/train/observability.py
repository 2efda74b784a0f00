"""
Training observability: metric event logs and throughput counters
(counterpart of ``lidbox_tpu.train.observability``; reference:
lidbox/models/keras_utils.py:65-71, lidbox/data/steps.py:460-484).

- MetricsLogger: JSONL event records, one per epoch, the JAX package's
  format, optionally mirrored to TensorBoard through
  ``torch.utils.tensorboard`` (host logging; when the writer cannot be
  imported it warns and carries on, as the JAX version does without
  tensorflow),
- ThroughputMeter: utterances/sec and audio-seconds/sec counters,
- profiler / cprofile: trace scopes, no-ops when disabled,
- span: a named stretch of the program's own work, recorded only while a
  torch.profiler runs (``spans``),
- tallying / count: named counts of what a stretch of work ran, on the
  thread that ran it (what a program's spans carry, ``train/graphs.py``).
"""
import contextlib
import itertools
import json
import os
import threading
import time

import torch
from torch.autograd import profiler as _autograd_profiler

from lidbox_tpu_torch import get_logger

logger = get_logger("train.observability")


class MetricsLogger:
    """Append-only JSONL metric event log, one record per step/epoch."""

    def __init__(self, log_dir, filename="events.jsonl", tensorboard=False):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, filename)
        self._fh = open(self.path, "a", encoding="utf-8")
        self._tb_writer = None
        if tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self._tb_writer = SummaryWriter(
                    os.path.join(log_dir, "tensorboard"))
            except ImportError:
                logger.warning("torch.utils.tensorboard unavailable, "
                               "tensorboard mirroring off")

    def log(self, step, metrics):
        rec = {"wall_time": time.time(), "step": int(step),
               "metrics": {k: float(v) for k, v in metrics.items()}}
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()
        if self._tb_writer is not None:
            for k, v in rec["metrics"].items():
                self._tb_writer.add_scalar(k, v, global_step=int(step),
                                           walltime=rec["wall_time"])
            self._tb_writer.flush()

    def close(self):
        self._fh.close()
        if self._tb_writer is not None:
            self._tb_writer.close()


class ThroughputMeter:
    """Streaming utterances/sec + audio-seconds/sec counter
    (reference counter: lidbox/data/steps.py:460-484). Host clock: the
    rates include whatever the device has not finished when they are read."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.t0 = time.perf_counter()
        self.num_examples = 0
        self.audio_seconds = 0.0

    def update(self, batch_size, audio_seconds=0.0):
        self.num_examples += batch_size
        self.audio_seconds += audio_seconds

    @property
    def elapsed(self):
        return time.perf_counter() - self.t0

    def rates(self):
        dt = max(self.elapsed, 1e-9)
        out = {"examples_per_sec": self.num_examples / dt}
        if self.audio_seconds:
            # only when the feed reported audio durations: a hard 0 would
            # read as a measurement, not a missing signal
            out["audio_rtf"] = self.audio_seconds / dt
        return out


@contextlib.contextmanager
def profiler(log_dir=None, enabled=True):
    """``torch.profiler`` trace scope: host ops, and the device's kernels
    when CUDA is available, written to ``log_dir`` as a Chrome trace
    (Perfetto or chrome://tracing read it). A no-op when disabled or
    without ``log_dir`` (the JAX package's jax.profiler scope; reference
    --run-tf-profiler, __main__.py:26-31)."""
    if not enabled or log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        path = os.path.join(
            log_dir, f"trace.{os.getpid()}.{int(time.time())}.pt.trace.json")
        prof.export_chrome_trace(path)
        logger.info("Wrote profiler trace to %s", path)


@contextlib.contextmanager
def cprofile(output_path="cProfile.log", enabled=True, sort="tottime"):
    """Host-side cProfile scope writing sorted pstats text to
    ``output_path``; a no-op when disabled (reference:
    lidbox/__main__.py:13-20,41-44)."""
    if not enabled:
        yield
        return
    import cProfile
    import pstats
    prof = cProfile.Profile()
    prof.enable()
    try:
        yield
    finally:
        prof.disable()
        with open(output_path, "w") as f:
            pstats.Stats(prof, stream=f).sort_stats(sort).print_stats()
        logger.info("Wrote cProfile stats to %s", output_path)


# spans kept in memory (``spans``); those past it are counted, not kept
MAX_SPANS = 1_000_000


class Span:
    """One recorded span: its ``name``, ``id``, the ``parent`` span's id
    (None at a thread's outermost span), the ``request`` its stretch of
    work serves (given, else the parent's, else its own id), the
    ``thread`` (``threading.get_ident``), ``start_ns`` and ``end_ns`` on
    ``time.perf_counter_ns`` (``end_ns`` None while open) and ``attrs``."""

    __slots__ = ("name", "id", "parent", "request", "thread", "start_ns",
                 "end_ns", "attrs")

    def __init__(self, name, id, parent, request, thread, attrs):
        self.name, self.id, self.parent = name, id, parent
        self.request, self.thread, self.attrs = request, thread, attrs
        self.start_ns = self.end_ns = None


_records = []
_dropped = 0
_ids = itertools.count(1)
_record_lock = threading.Lock()
_open = threading.local()  # .stack: this thread's open spans


class _Off:
    """The span when no profiler runs: enters nothing, yields None."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Recording:
    __slots__ = ("name", "request", "attrs", "span", "scope")

    def __init__(self, name, request, attrs):
        self.name, self.request, self.attrs = name, request, attrs

    def __enter__(self):
        global _dropped
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        parent = stack[-1] if stack else None
        sid = next(_ids)
        request = self.request
        if request is None:
            request = sid if parent is None else parent.request
        span = self.span = Span(self.name, sid,
                                None if parent is None else parent.id,
                                request, threading.get_ident(), self.attrs)
        with _record_lock:
            if len(_records) < MAX_SPANS:
                _records.append(span)
            else:
                _dropped += 1
        stack.append(span)
        self.scope = torch.profiler.record_function(self.name)
        self.scope.__enter__()
        span.start_ns = time.perf_counter_ns()
        return span

    def __exit__(self, *exc):
        self.span.end_ns = time.perf_counter_ns()
        _open.stack.pop()
        return self.scope.__exit__(*exc)


def span(name, request=None, **attrs):
    """A context manager around a stretch of the program's work.

    With no torch.profiler running it costs one check of a global flag and
    yields None. While one runs (the benchmark's trace, ``profiler()``,
    the CLI's ``--run-torch-profiler``) it enters
    ``torch.profiler.record_function(name)``, so the span lies on the
    profiler's host timeline beside the device's events, and yields its
    ``Span`` record, kept in memory (``spans``), whose ``attrs`` the
    caller may add to. ``request``: what the spans of one request share
    (a train step's ``state.step``); by default the enclosing span's, or
    at a thread's outermost span its own id."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Recording(name, request, attrs)


def spans():
    """The spans recorded since the last ``clear_spans``, in the order
    they were entered, at most ``MAX_SPANS``."""
    with _record_lock:
        return list(_records)


def dropped_spans():
    """Spans not kept since the last ``clear_spans``: the list was full."""
    return _dropped


def clear_spans():
    global _dropped
    with _record_lock:
        _records.clear()
        _dropped = 0


_tallies = threading.local()  # .open: this thread's tallies (``tallying``)


@contextlib.contextmanager
def tallying(tally):
    """Within it, every ``count(name, n)`` made on this thread adds ``n``
    to ``tally[name]`` (a ``collections.Counter``), and to the tallies of
    the enclosing calls. Counting costs a look at this thread's open
    tallies, none where none is open."""
    if not hasattr(_tallies, "open"):
        _tallies.open = []
    _tallies.open.append(tally)
    try:
        yield tally
    finally:
        _tallies.open.pop()


def count(name, n=1):
    """Add ``n`` to ``name`` in every tally open on this thread."""
    for tally in getattr(_tallies, "open", ()):
        tally[name] += n

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
- profiler / cprofile: trace scopes, no-ops when disabled.
"""
import contextlib
import json
import os
import time

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
    import torch
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

"""
Training observability: metric event logs and throughput counters
(counterpart of ``lidbox_tpu.train.observability``; reference:
lidbox/models/keras_utils.py:65-71, lidbox/data/steps.py:460-484).

- MetricsLogger: JSONL event records, one per epoch, the JAX package's
  format,
- ThroughputMeter: utterances/sec and audio-seconds/sec counters.

Not ported yet (ROADMAP queue 1, item 11): TensorBoard mirroring and the
profiler / cProfile scopes; they raise.
"""
import json
import os
import time

from lidbox_tpu_torch import get_logger

logger = get_logger("train.observability")


class MetricsLogger:
    """Append-only JSONL metric event log, one record per step/epoch."""

    def __init__(self, log_dir, filename="events.jsonl", tensorboard=False):
        if tensorboard:
            raise NotImplementedError("TensorBoard mirroring is not ported "
                                      "yet (ROADMAP queue 1, item 11)")
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, filename)
        self._fh = open(self.path, "a", encoding="utf-8")

    def log(self, step, metrics):
        rec = {"wall_time": time.time(), "step": int(step),
               "metrics": {k: float(v) for k, v in metrics.items()}}
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()

    def close(self):
        self._fh.close()


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


def profiler(log_dir=None, enabled=True):
    raise NotImplementedError("the profiler scope (torch.profiler) is not "
                              "ported yet (ROADMAP queue 1, item 11)")


def cprofile(output_path="cProfile.log", enabled=True, sort="tottime"):
    raise NotImplementedError("the cProfile scope is not ported yet "
                              "(ROADMAP queue 1, item 11)")

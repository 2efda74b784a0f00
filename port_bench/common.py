"""What every cell of the benchmark shares: the files it is driven by, the
weights made from the seed, the card's description, the device trace of a
stretch of work, and the check that nothing of JAX was loaded."""
import bisect
import collections
import json
import math
import os
import resource
import subprocess
import sys
import time

import torch

from port_bench import signals

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# top-level module names no run may load: JAX, its libraries and the JAX
# package the measured port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "lidbox_tpu")
# host operations looked at, back from a gap's end, to name it, and the
# gaps too short to name one by one
SCAN = 2000
SHORT_GAP_US = 20


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


class Bench:
    """``BENCHMARK.json`` and the files it names: a workload's
    configuration (``configs/<config>.json``), traffic
    (``traffic/<traffic>.json``), limits (``limits/<workload>.json``), its
    driver (``kinds/<traffic kind>.py``) and the readers of its per-layer
    metrics (``metrics/<metric>.py``, or ``metrics/<quantity>.py`` for a
    metric ``<quantity>.<part>``)."""

    def __init__(self, root=ROOT):
        self.spec = load_json(root, "BENCHMARK.json")

    def workload(self, name):
        for cell in self.spec["workloads"]:
            if cell["name"] == name:
                return cell
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, cell):
        for c in self.spec["configs"]:
            if c["name"] == cell["config"]:
                return load_json(ROOT, c["file"])
        raise KeyError(f"no configuration {cell['config']!r}")

    @staticmethod
    def traffic(cell):
        return load_json(HERE, "traffic", cell["traffic"] + ".json")

    @staticmethod
    def limits(cell):
        return load_json(HERE, "limits", cell["name"] + ".json")

    def metrics_of(self, cell, section):
        """The ``section`` ("end_to_end" or "per_layer") metrics a cell
        reports: those listing it, and those that list no cells."""
        return [m for m in self.spec[section]
                if cell["name"] in m.get("workloads", [cell["name"]])]


def make_weights(specs, seed, device, dtype=torch.float32):
    """name -> tensor of each ``(name, shape, init)`` spec, drawn on
    ``device`` from the seed in one call: a normal of variance 1 / fan_in
    for ("fan_in", n), else zeros or ones."""
    drawn = [s for s in specs if isinstance(s[2], (tuple, list))]
    total = sum(math.prod(shape) for _, shape, _ in drawn)
    flat = torch.randn(total, generator=signals.generator(
        seed, signals.WEIGHTS, device), device=device, dtype=dtype)
    out, offset = {}, 0
    for name, shape, init in specs:
        if isinstance(init, (tuple, list)):
            n = math.prod(shape)
            out[name] = (flat[offset:offset + n]
                         * (1.0 / math.sqrt(init[1]))).view(shape)
            offset += n
        else:
            fill = {"zeros": 0.0, "ones": 1.0}[init]
            out[name] = torch.full(shape, fill, device=device, dtype=dtype)
    return out


def set_precision(config, control=False):
    """The float32 products as the configuration states them: TF32 off in
    cuBLAS and cuDNN unless it says otherwise. ``control`` turns TF32 on,
    the step below float32."""
    tf32 = bool(config["tf32"]) or control
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32


def card():
    """(name, power limit as nvidia-smi reads it)."""
    name = torch.cuda.get_device_name(0)
    try:
        limit = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        limit = "unknown"
    return name, limit


def card_state():
    """The card's clocks, power, temperature and active clock-limiting
    reasons, as nvidia-smi reads them now ("unknown" where it cannot)."""
    fields = ("clocks.sm,clocks.max.sm,clocks.mem,power.draw,temperature.gpu,"
              "clocks_event_reasons.active")
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
            check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"
    return f"{fields}: {out}"


def process_cpu_seconds():
    """(user, system) CPU seconds of this process, all its threads."""
    usage = resource.getrusage(resource.RUSAGE_SELF)
    return usage.ru_utime, usage.ru_stime


def forbidden_modules():
    """Top-level names of loaded modules that no run may load, each
    module's name compared up to its first dot, whole."""
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(FORBIDDEN))


class Trace:
    """torch.profiler over one stretch of work: the device's busy time
    (the union of its kernels', copies' and sets' intervals), the
    stretch's host-clock length, the device operations that took most
    time, and the idle gaps between them named by the host operation that
    was running in each (``_host_op``). The spans of ``record_function`` are host
    operations here, not device time."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.window_s = None

    def __enter__(self):
        torch.cuda.synchronize()
        self.prof.start()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self.t0
        self.prof.stop()
        return False

    def summary(self, top=10):
        events = list(self.prof.events())
        host = [e for e in events
                if e.device_type == torch.autograd.DeviceType.CPU]
        # record_function spans also appear on the device's timeline
        spans = {e.name for e in host if getattr(e, "is_user_annotation",
                                                 False)}
        device = [e for e in events
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False)
                  and e.name not in spans]
        by_name = collections.Counter()
        intervals = []
        for e in device:
            start, end = e.time_range.start, e.time_range.end
            if end > start:
                intervals.append((start, end))
                by_name[e.name] += (end - start) * 1e-6
        intervals.sort()
        merged = []
        for start, end in intervals:
            if merged and start <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], end)
            else:
                merged.append([start, end])
        busy_s = sum(end - start for start, end in merged) * 1e-6
        gaps = collections.Counter()
        host.sort(key=lambda e: e.time_range.start)
        starts = [e.time_range.start for e in host]
        for (_, a), (b, _) in zip(merged, merged[1:]):
            name = (self._host_op(host, starts, a, b) if b - a >= SHORT_GAP_US
                    else f"gaps under {SHORT_GAP_US} us")
            gaps[name] += (b - a) * 1e-6
        return {"busy_s": busy_s, "window_s": self.window_s,
                "device_ops": [[n, s] for n, s in by_name.most_common(top)],
                "idle_gaps": [[n, s] for n, s in gaps.most_common(top)],
                "kernels": by_name}

    @staticmethod
    def _host_op(host, starts, a, b):
        """The innermost host operation (the last to start) that overlaps
        half of the gap [a, b] or more; else the one that overlaps it most.
        Looks at the ``SCAN`` operations that started last before b."""
        best, name = 0.0, "no recorded host op"
        k = bisect.bisect_left(starts, b)
        for e in reversed(host[max(0, k - SCAN):k]):
            overlap = min(b, e.time_range.end) - max(a, e.time_range.start)
            if overlap >= 0.5 * (b - a):
                return e.name
            if overlap > best:
                best, name = overlap, e.name
        return name


def device_seconds_per_call(run, calls, names):
    """Device seconds per call of ``run`` spent in operations whose name
    holds one of ``names``, under torch.profiler; None when none was
    recorded."""
    with Trace() as trace:
        for _ in range(calls):
            run()
    kernels = trace.summary()["kernels"]
    total = sum(s for n, s in kernels.items() if any(k in n for k in names))
    return total / calls if total > 0 else None

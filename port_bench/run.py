#!/usr/bin/env python3
"""Runs one cell of the benchmark once, on the card of this machine.

    python3 port_bench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``,
``port_bench/`` and the measured package, ``lidbox_tpu_torch``. It makes
its inputs and weights from the seed, sets up and warms up every shape the
cell uses, measures for ``--seconds``, checks what the timed path produced
against the plain reference (``port_bench/reference``), and prints one JSON
line: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics; with ``--trace 1`` its per-layer ones, read after a
profiled stretch), ``device``, ``breakdown`` when traced, and ``checks``,
each compared number beside its limit, which are also the last lines of
standard error. (``calibrate.py`` reads the numbers on many seeds, and
those of the TF32 control.)

Exits non-zero with no result line without a CUDA card (or with fewer
than the cell's chips), without the package beside it, or when a module
of JAX or of the JAX package was loaded. Compile caches stay inside the
checkout (``lidbox_tpu_torch/_build/``, ``port_bench/.cache/``); files go
under ``TMPDIR``.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import types  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(HERE, ".cache")


def cache_environment(env=os.environ):
    """Every compile and kernel cache at a fixed path inside the checkout,
    and no JAX behind a library's back."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels"),
                     ("CUDA_CACHE_PATH", "nv")):
        env[var] = os.path.join(CACHE, sub)
    env["USE_FLAX"] = "0"
    env["USE_JAX"] = "0"


if __name__ == "__main__":
    cache_environment()
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)

import torch  # noqa: E402

from port_bench import common  # noqa: E402


def load_reader(name):
    """The ``read(run)`` of ``port_bench/metrics/<name>.py``; for a name
    ``<quantity>.<part>`` without a file of its own, that of
    ``metrics/<quantity>.py``, which reads the quantity in every cell (the
    part only keeps apart cells that report different end-to-end
    metrics)."""
    path = os.path.join(HERE, "metrics", name + ".py")
    if not os.path.exists(path):
        path = os.path.join(HERE, "metrics", name.split(".")[0] + ".py")
    spec = importlib.util.spec_from_file_location(
        "port_bench.metrics." + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def run_cell(bench, cell, seed, seconds, trace=False, device=None,
             control=False, start=None, traffic=None):
    """One run of ``cell`` on ``device`` (the card by default): (the
    result object, the compared numbers as (name, value, limit)).
    ``control`` runs the float32 products in TF32, the precision below the
    configuration's (a control whose ``correct`` comes out false);
    ``start`` is when set-up began (the process's start by default);
    ``traffic`` overrides entries of the traffic file (the tests' smaller
    sizes on the CPU)."""
    device = torch.device(device or "cuda")
    config = bench.config(cell)
    traffic = dict(bench.traffic(cell), **(traffic or {}))
    limits = bench.limits(cell)
    common.set_precision(config, control)
    kind = importlib.import_module("port_bench.kinds." + traffic["kind"])
    tmp = tempfile.mkdtemp(prefix="port_bench-")
    ctx = types.SimpleNamespace(config=config, traffic=traffic, seed=seed,
                                device=device, tmp=tmp, workload=cell["name"])
    on_card = device.type == "cuda"
    try:
        c = kind.Cell(ctx)
        c.setup()
        tracer = common.Trace() if trace else None
        cpu_before = common.process_cpu_seconds()
        window = c.window(seconds, tracer)
        user, system = (b - a for a, b in zip(
            cpu_before, common.process_cpu_seconds()))
        print(f"note process CPU over the window: user {user:.2f} s, system "
              f"{system:.2f} s in {window['seconds']:.2f} s", file=sys.stderr)
        if on_card:
            print(f"note card after the window: {common.card_state()}",
                  file=sys.stderr)
        setup_s = window["start"] - (T_START if start is None else start)
        peak = torch.cuda.max_memory_allocated(device) if on_card else 0
        summary = tracer.summary() if trace else None
        run = types.SimpleNamespace(cell=c, window=window, trace=summary,
                                    config=config, ctx=ctx)
        metrics = {}
        if trace:
            for m in bench.metrics_of(cell, "per_layer"):
                value = load_reader(m["name"])(run)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        else:
            for m in bench.metrics_of(cell, "end_to_end"):
                value = (setup_s if m["name"] == "setup_s"
                         else window["metrics"][m["name"]])
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        c.release()
        del run
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        checks = [(name, value, float(limits.get(name, 0.0)))
                  for name, value in c.check()]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    name, power = common.card() if on_card else (str(device), "none")
    dev = {"platform": "gpu" if on_card else device.type, "kind": name,
           "count": cell["chips"], "memory_peak_bytes": int(peak),
           "power_limit": power}
    result = {"correct": all(v <= lim for _, v, lim in checks),
              "attempted": window["attempted"], "failed": window["failed"],
              "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = summary["window_s"]
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    return result, checks


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    try:
        bench = common.Bench()
        cell = bench.workload(args.workload)
    except (OSError, KeyError, ValueError) as e:
        print(f"port_bench: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or (
            torch.cuda.device_count() < cell["chips"]):
        print(f"port_bench: {cell['name']} needs {cell['chips']} CUDA "
              f"card(s), found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    try:
        import lidbox_tpu_torch
    except ImportError as e:
        print(f"port_bench: the measured package is missing: {e}",
              file=sys.stderr)
        return 2
    if not os.path.abspath(lidbox_tpu_torch.__file__).startswith(
            ROOT + os.sep):
        print("port_bench: lidbox_tpu_torch is not this checkout's",
              file=sys.stderr)
        return 2
    result, checks = run_cell(bench, cell, args.seed, args.seconds,
                              bool(args.trace))
    found = common.forbidden_modules()
    if found:
        print(f"port_bench: modules that no run may load were loaded: "
              f"{', '.join(found)}", file=sys.stderr)
        return 3
    for name, value, limit in checks:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

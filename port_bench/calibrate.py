#!/usr/bin/env python3
"""Reads a cell's compared numbers on many seeds in one process: the
program's, with ``--control 1`` the TF32 control's, and with ``--fault``
a planted fault's (``faults.py``); the smallest control or fault reading
bounds a limit from above. Prints one JSON line per run.

    python3 port_bench/calibrate.py --workload <name> --seconds 2 \
        --control 0 1 --seeds 11 12 13 ...

The limits in ``port_bench/limits/`` are set from these readings (PERF.md
gives them); the benchmark's own runs never run the control.
"""
import argparse
import contextlib
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(HERE))
    from port_bench import run as run_module
    run_module.cache_environment()

import torch  # noqa: E402

from port_bench import common, faults  # noqa: E402
from port_bench.run import run_cell  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--control", type=int, nargs="+", default=[0])
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--fault", choices=sorted(faults.FAULTS),
                   help="plant this fault in the program (faults.py)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA card", file=sys.stderr)
        return 2
    bench = common.Bench()
    cell = bench.workload(args.workload)
    for control in args.control:
        for seed in args.seeds:
            t0 = time.perf_counter()
            with (faults.FAULTS[args.fault]() if args.fault
                  else contextlib.nullcontext()):
                result, _ = run_cell(bench, cell, seed, args.seconds,
                                     control=bool(control), start=t0)
            print(json.dumps({"workload": cell["name"], "seed": seed,
                              "control": control, "fault": args.fault,
                              "correct": result["correct"],
                              "checks": result["checks"],
                              "metrics": result["metrics"],
                              "wall_s": time.perf_counter() - t0}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

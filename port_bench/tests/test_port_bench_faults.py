"""``correct`` comes out false when the timed path is broken underneath:
each cell's run, with the look for a card skipped, on the CPU at a small
size (and, marked ``cuda``, the TF32 control on the card at the cell's own
traffic). The limits are the cells' own (``port_bench/limits``)."""
import json
import subprocess
import sys
import time

import pytest

from port_bench import common, faults
from port_bench.run import run_cell

SMALL = {
    "xvector.stream-1s": {"recording_s": 6.0},
    "xvector.train": {"batches": 4, "batch_size": 4, "seconds": 1.0},
    "bi_gru.train-vad": {"batches": 4, "batch_size": 4, "seconds": 1.0},
}
TRAIN = ["xvector.train", "bi_gru.train-vad"]


def run_small(name, seed=2 ** 34 + 5):
    bench = common.Bench()
    result, _ = run_cell(bench, bench.workload(name), seed, 0.3,
                         device="cpu", traffic=SMALL[name],
                         start=time.perf_counter())
    return result


@pytest.mark.parametrize("name", sorted(SMALL))
def test_sound_run_is_correct(name):
    result = run_small(name)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0


@pytest.mark.parametrize("name,fault", [
    ("xvector.stream-1s", "streamed_answer_altered")]
    + [(n, f) for n in TRAIN for f in ("state_unchanged", "half_batch")])
def test_fault_is_not_correct(name, fault):
    with faults.FAULTS[fault]():
        assert not run_small(name)["correct"]


CONTROL = """
import json, sys, time
sys.path.insert(0, {root!r})
from port_bench import common
from port_bench.run import run_cell
bench = common.Bench()
for seed in (2 ** 33 + 1, 2 ** 33 + 2, 2 ** 33 + 3):
    result, _ = run_cell(bench, {cell!r}, seed, 2.0, control=True,
                         start=time.perf_counter())
    print(json.dumps([result["correct"], result["checks"]]), flush=True)
"""


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SMALL))
def test_tf32_control_is_not_correct(name, cuda_device):
    """The control: the cell's own traffic on the card with the float32
    products in TF32, three seeds in a process of its own, as the
    benchmark's runs are. At least one comes out not correct."""
    cell = common.Bench().workload(name)
    out = subprocess.run(
        [sys.executable, "-c", CONTROL.format(root=common.ROOT, cell=cell)],
        capture_output=True, text=True, timeout=900, cwd=common.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    runs = [json.loads(line) for line in out.stdout.splitlines()
            if line.startswith("[")]
    assert len(runs) == 3 and not all(ok for ok, _ in runs), runs

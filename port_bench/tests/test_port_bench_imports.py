"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the measured package. Module names are compared
by their top-level name (the part before the first dot), whole:
``lidbox_tpu_torch`` is the measured package, ``lidbox_tpu`` is not."""
import ast
import os
import subprocess
import sys

import pytest

from port_bench import common

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

DRIVE = r"""
import glob, json, os, sys
sys.path.insert(0, {root!r})
import torch
from port_bench import common, run, signals
from port_bench.kinds import stream, train
for path in sorted(glob.glob(os.path.join({here!r}, "metrics", "*.py"))):
    run.load_reader(os.path.basename(path)[:-3])
cpu = torch.device("cpu")
gen = signals.generator(2 ** 35 + 1, signals.INPUTS, cpu)
x = signals.class_tones(gen, [0, 13], 4000, 16000, cpu)
signals.with_pauses(gen, x, 16000, 0.05, 0.1)
import numpy as np
signals.segments(np.random.default_rng(1), 64000, 32000, 128000, 14)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def loaded_after(code):
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=common.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    import json
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_and_traffic_load_no_jax():
    loaded = loaded_after(DRIVE.format(root=common.ROOT, here=HERE))
    assert not loaded & set(common.FORBIDDEN), loaded & set(common.FORBIDDEN)
    assert "port_bench" in loaded


def test_every_per_layer_metric_has_a_reader():
    from port_bench import run
    for m in common.Bench().spec["per_layer"]:
        assert callable(run.load_reader(m["name"])), m["name"]


def test_reference_loads_nothing_of_the_package():
    code = (f"import json, sys; sys.path.insert(0, {common.ROOT!r})\n"
            "from port_bench.reference import (bi_gru, logmel, nn, train,"
            " vad, wav, xvector)\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    loaded = loaded_after(code)
    assert "lidbox_tpu_torch" not in loaded
    assert not loaded & set(common.FORBIDDEN)


def imports_of(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def python_files(sub=""):
    for dirpath, _, files in os.walk(os.path.join(HERE, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


@pytest.mark.parametrize("path", sorted(python_files()))
def test_no_file_imports_jax(path):
    assert not set(imports_of(path)) & set(common.FORBIDDEN)


@pytest.mark.parametrize("path", sorted(python_files("reference")))
def test_reference_file_imports_no_package(path):
    assert "lidbox_tpu_torch" not in set(imports_of(path))


def test_forbidden_names_compare_whole(monkeypatch):
    for name in list(sys.modules):
        if name.split(".")[0] in common.FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "lidbox_tpu_torch.fake", sys)
    monkeypatch.setitem(sys.modules, "jaxlike", sys)
    assert common.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "lidbox_tpu.fake", sys)
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert common.forbidden_modules() == ["jax", "lidbox_tpu"]

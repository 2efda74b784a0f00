"""
The PyTorch port stands alone: ``lidbox_tpu_torch``, its examples,
``chip_smoke.py`` and ``logmel_compare.py`` import neither jax nor flax nor anything of
``lidbox_tpu``, nor the libraries the card's machine lacks (pandas,
scikit-learn, joblib, msgpack, orbax, tensorstore, zstandard: Orbax
checkpoints read through the port's own decoder); yaml, matplotlib,
seaborn and TensorBoard are imported only inside the functions that need
them.
"""
import os
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "lidbox_tpu_torch"
EXAMPLES = ("examples/end_to_end_torch.py",
            "examples/fused_feed_training_torch.py")
SCRIPTS = ("chip_smoke.py", "logmel_compare.py")
ABSENT = ("jax", "flax", "pandas", "sklearn", "joblib", "msgpack", "orbax",
          "tensorstore", "zstandard")
LAZY = ("yaml", "matplotlib", "seaborn", "tensorboard",
        "torch.utils.tensorboard")

_IMPORT_ALL = r"""
import importlib, importlib.util, pkgutil, sys
for name in %(absent)r:
    sys.modules[name] = None
import lidbox_tpu_torch
for info in pkgutil.walk_packages(lidbox_tpu_torch.__path__, "lidbox_tpu_torch."):
    importlib.import_module(info.name)
for i, path in enumerate(%(scripts)r + %(examples)r):
    spec = importlib.util.spec_from_file_location(f"script{i}", path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
leaked = sorted(m for m in sys.modules
                if m == "lidbox_tpu" or m.startswith("lidbox_tpu."))
print("LEAKED", leaked)
print("EAGER", sorted(m for m in %(lazy)r if m in sys.modules))
print("COUNT", sum(m.startswith("lidbox_tpu_torch.") for m in sys.modules))
"""


def test_package_imports_without_jax_or_lidbox_tpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    script = _IMPORT_ALL % {"absent": ABSENT, "examples": EXAMPLES,
                            "scripts": SCRIPTS, "lazy": LAZY}
    proc = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                          env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "LEAKED []" in proc.stdout, proc.stdout
    assert "EAGER []" in proc.stdout, proc.stdout
    count = int(proc.stdout.split("COUNT")[1].split()[0])
    assert count >= 40, proc.stdout  # every submodule was imported


def test_sources_name_no_jax_flax_or_lidbox_tpu():
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|flax|lidbox_tpu|pandas|sklearn|joblib"
        r"|msgpack|orbax|tensorstore|zstandard)(\.|\s|$)", re.MULTILINE)
    files = (sorted(PACKAGE.rglob("*.py")) + [ROOT / s for s in SCRIPTS]
             + [ROOT / e for e in EXAMPLES])
    assert len(files) >= 42
    offenders = [str(f.relative_to(ROOT)) for f in files
                 if pattern.search(f.read_text())]
    assert offenders == []

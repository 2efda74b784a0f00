"""
The PyTorch port stands alone: ``lidbox_tpu_torch`` and ``chip_smoke.py``
import neither jax nor flax nor anything of ``lidbox_tpu``.
"""
import os
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "lidbox_tpu_torch"

_IMPORT_ALL = r"""
import importlib, importlib.util, pkgutil, sys
sys.modules["jax"] = None
sys.modules["flax"] = None
import lidbox_tpu_torch
for info in pkgutil.walk_packages(lidbox_tpu_torch.__path__, "lidbox_tpu_torch."):
    importlib.import_module(info.name)
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
leaked = sorted(m for m in sys.modules
                if m == "lidbox_tpu" or m.startswith("lidbox_tpu."))
print("LEAKED", leaked)
print("COUNT", sum(m.startswith("lidbox_tpu_torch.") for m in sys.modules))
"""


def test_package_imports_without_jax_or_lidbox_tpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                          env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "LEAKED []" in proc.stdout, proc.stdout
    count = int(proc.stdout.split("COUNT")[1].split()[0])
    assert count >= 28, proc.stdout  # every submodule was imported


def test_sources_name_no_jax_flax_or_lidbox_tpu():
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|flax|lidbox_tpu)(\.|\s|$)", re.MULTILINE)
    files = sorted(PACKAGE.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) >= 30
    offenders = [str(f.relative_to(ROOT)) for f in files
                 if pattern.search(f.read_text())]
    assert offenders == []

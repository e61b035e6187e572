"""The port stands alone: importing every module of ``repro_torch`` (and the
chip smoke script) loads neither ``jax`` nor anything of ``repro``."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]

PROBE = r"""
import importlib, pkgutil, sys
import repro_torch
names = ["repro_torch"] + [
    m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")
]
for name in names:
    importlib.import_module(name)
sys.path.insert(0, ROOT)
import chip_smoke
leaked = sorted(m for m in sys.modules
                if m == "jax" or m.startswith("jax.") or m == "repro" or m.startswith("repro."))
print(len(names), "modules")
print("LEAKED", leaked)
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env["OMP_NUM_THREADS"] = "1"
    return env


def test_port_imports_no_jax_and_no_repro():
    code = f"ROOT = {str(ROOT)!r}\n" + PROBE
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env=_env(), cwd=ROOT, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert "LEAKED []" in out.stdout, out.stdout
    n = int(out.stdout.split()[0])
    assert n >= 49  # every module was walked (serving and training slices), not just the root


def test_chip_smoke_fails_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py")], capture_output=True, text=True,
        env=_env(), cwd=ROOT, timeout=120,
    )
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout

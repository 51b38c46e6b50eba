"""The PyTorch/CUDA port imports no JAX and nothing of the JAX package:
every module of victoriametrics_tpu_torch, and chip_smoke.py, load in a
process where importing jax fails."""

import os
import pkgutil
import subprocess
import sys

import victoriametrics_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = r"""
import importlib, runpy, sys
sys.modules["jax"] = None          # any `import jax` now raises
sys.modules["jaxlib"] = None
mods = sys.argv[1:]
for m in mods:
    importlib.import_module(m)
sys.argv = ["chip_smoke.py", "--help"]
try:
    runpy.run_path("chip_smoke.py", run_name="__main__")
except SystemExit as e:
    assert e.code in (0, None), e.code
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("victoriametrics_tpu", "jax", "jaxlib")
                and sys.modules[m] is not None)
print("LEAKED", leaked)
print("LOADED", len(mods))
"""


def _port_modules():
    pkg = victoriametrics_tpu_torch
    names = [pkg.__name__]
    for info in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
        names.append(info.name)
    return names


def test_port_and_chip_smoke_import_without_jax():
    mods = _port_modules()
    assert "victoriametrics_tpu_torch.query.cuda_engine" in mods
    assert {"victoriametrics_tpu_torch.parallel.mesh",
            "victoriametrics_tpu_torch.parallel.partition"} <= set(mods)
    assert len(mods) >= 15
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", PROBE, *mods], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "LEAKED []" in out.stdout, out.stdout
    assert f"LOADED {len(mods)}" in out.stdout
    assert "usage: chip_smoke.py" in out.stdout

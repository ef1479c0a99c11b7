"""The port stands alone: importing it (and ``chip_smoke.py``) loads no JAX.

Runs in a fresh subprocess so the JAX imports of the parity tests in this
process cannot mask a stray import.
"""

import json
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import repro_torch

ROOT = Path(__file__).resolve().parents[1]

PROBE = """
import importlib, json, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "repro" or m.startswith("repro."))
print(json.dumps({"n": len(names), "bad": bad}))
"""


def _port_modules():
    return [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]


def test_port_and_chip_smoke_import_no_jax_and_no_repro():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-c", PROBE], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["n"] == len(_port_modules()) >= 20
    assert got["bad"] == [], f"the port pulled in {got['bad']}"


def test_port_sources_never_name_jax_or_repro_imports():
    """A static check beside the runtime one: no import line of the port (or
    of chip_smoke.py) names jax or the JAX package."""
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    offenders = []
    for path in files:
        for line in path.read_text().splitlines():
            words = line.strip().split()
            if len(words) >= 2 and words[0] in ("import", "from"):
                mod = words[1].split(".")[0].rstrip(",")
                if mod in ("jax", "jaxlib", "repro", "flax", "optax"):
                    offenders.append(f"{path.relative_to(ROOT)}: {line.strip()}")
    assert not offenders, offenders


def test_chip_smoke_refuses_to_run_without_a_card(tmp_path):
    """Without CUDA the script exits non-zero and prints no result line; a
    directory holding only chip_smoke.py cannot run it either."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=120,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, str(lone)], cwd=tmp_path, env=env, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout

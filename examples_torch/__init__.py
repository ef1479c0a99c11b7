"""The JAX package's examples on the PyTorch/CUDA port (``repro_torch``).

Each module runs as a script (``PYTHONPATH=src python examples_torch/<name>.py``,
on the card by default, ``--device cpu`` for the CPU) and exposes
``main(argv=None)`` plus the functions it is made of, so that other programs
can drive the same flow.
"""

import importlib.util
from pathlib import Path


def load_chaos_smoke():
    """``scripts/chaos_smoke_torch.py`` as a module (``scripts/`` is no package)."""
    path = Path(__file__).resolve().parents[1] / "scripts" / "chaos_smoke_torch.py"
    spec = importlib.util.spec_from_file_location("chaos_smoke_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod

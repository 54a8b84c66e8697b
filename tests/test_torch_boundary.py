"""The port's import boundary: torch and numpy, never jax, the JAX package
or sklearn (the machine with the card has none of them)."""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

_PROBE = """
import sys
import mpitree_tpu_torch
from mpitree_tpu_torch.tree import (
    DecisionTreeClassifier, DecisionTreeRegressor, RandomForestClassifier)
{extra}
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "mpitree_tpu" or m.startswith("mpitree_tpu.")
             or m == "sklearn" or m.startswith("sklearn."))
print(",".join(bad))
"""

_EVERY_MODULE = """
import importlib, pkgutil
for m in pkgutil.walk_packages(mpitree_tpu_torch.__path__, "mpitree_tpu_torch."):
    importlib.import_module(m.name)
"""


def _probe(extra: str) -> str:
    out = subprocess.run(
        [sys.executable, "-c", _PROBE.format(extra=extra)], cwd=REPO,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    return out.stdout.strip()


def test_public_import_pulls_no_jax_jax_package_or_sklearn():
    assert _probe("") == ""


def test_every_port_module_imports_without_them():
    assert _probe(_EVERY_MODULE) == ""

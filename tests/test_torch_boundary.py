"""The port's import boundary: torch and numpy, never jax, the JAX package
or sklearn (the machine with the card has none of them)."""

from __future__ import annotations

import os
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


def test_boosting_import_pulls_none_of_them():
    assert _probe("from mpitree_tpu_torch import ("
                  "GradientBoostingClassifier, GradientBoostingRegressor)"
                  ) == ""


def test_leafwise_and_fused_rounds_import_pulls_none_of_them():
    assert _probe("from mpitree_tpu_torch.core import leafwise_builder\n"
                  "from mpitree_tpu_torch.boosting import fused_rounds") == ""


_BLOCKED = """
import sys
for name in ("jax", "jaxlib", "mpitree_tpu", "sklearn"):
    sys.modules[name] = None  # any import of them raises ImportError
from mpitree_tpu_torch.config import knobs
from mpitree_tpu_torch.obs import metrics
from mpitree_tpu_torch.serving import (
    Scheduler, StreamStage, parse_qos, scheduler, staging)
print(knobs.value("MPITREE_TPU_SERVING_SHED_DEPTH"),
      metrics.metrics_text() == "", len(parse_qos(
          knobs.value("MPITREE_TPU_SERVING_QOS"))))
"""


def test_serving_tier_imports_with_jax_blocked():
    out = subprocess.run(
        [sys.executable, "-c", _BLOCKED], cwd=REPO, capture_output=True,
        text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["4096", "True", "2"]


_MESH_BLOCKED = """
import sys
for name in ("jax", "jaxlib", "mpitree_tpu", "sklearn"):
    sys.modules[name] = None  # any import of them raises ImportError
from mpitree_tpu_torch.parallel import collective, distributed, mesh, partition
from mpitree_tpu_torch.utils import profiling
from mpitree_tpu_torch.tree import ParallelDecisionTreeClassifier
mesh.set_cpu_shards(3)
m = mesh.resolve_mesh(device="cpu", n_devices="all")
print(m.size, partition.match_partition_rules("x_binned"),
      distributed.process_info(device="cpu")["global_devices"],
      profiling.debug_checks_enabled(),
      ParallelDecisionTreeClassifier().n_devices)
"""


def test_mesh_modules_import_with_jax_blocked():
    out = subprocess.run(
        [sys.executable, "-c", _MESH_BLOCKED], cwd=REPO, capture_output=True,
        text=True, timeout=120,
        env={k: v for k, v in os.environ.items()
             if k != "MPITREE_TPU_DEBUG"},
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["3", "row", "3", "False", "all"]

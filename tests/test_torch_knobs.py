"""The port's knob registry (``mpitree_tpu_torch/config/knobs.py``) held
against the JAX package's, its README tables and CLIs, and the env reads
moved onto it.

- every knob of ``mpitree_tpu/config/knobs.py`` is registered in the
  port with the same kind, default, choices, doc line and parse rule
  (the two defaults that differ on purpose are listed here), or listed
  in ``knobs.NOT_ON_THE_CARD`` or ``knobs.NEXT_SLICE`` with its reason;
- no module of the port reads an ``MPITREE_TPU_*`` name from
  ``os.environ`` outside the registry;
- ``python -m mpitree_tpu_torch.config`` and ``python -m
  mpitree_tpu_torch.obs`` pass ``--check`` on the checked-in README,
  ``--write`` repairs a drifted copy, and neither touches the JAX
  package's marker blocks;
- ``MPITREE_TPU_ENGINE``, ``_HIST_SUBTRACTION``,
  ``_ROUNDS_PER_DISPATCH`` and ``_NO_NATIVE`` behave as before the move,
  error texts included.
"""

from __future__ import annotations

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

pytest.importorskip("jax")

import mpitree_tpu  # noqa: E402
from mpitree_tpu.config import knobs as jax_knobs  # noqa: E402

import mpitree_tpu_torch  # noqa: E402
from mpitree_tpu_torch import native  # noqa: E402
from mpitree_tpu_torch.boosting import fused_rounds  # noqa: E402
from mpitree_tpu_torch.config import __main__ as config_cli  # noqa: E402
from mpitree_tpu_torch.config import knobs  # noqa: E402
from mpitree_tpu_torch.core import builder  # noqa: E402
from mpitree_tpu_torch.obs import __main__ as obs_cli  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
README = ROOT / "README.md"
# the defaults that differ on purpose (each entry's comment says why)
DEFAULT_DIFFERS = {"MPITREE_TPU_FOREST_HBM_BUDGET", "MPITREE_TPU_ELASTIC"}
JAX_MARKERS = (("<!-- knob-table:begin -->", "<!-- knob-table:end -->"),
               ("<!-- event-table:begin -->", "<!-- event-table:end -->"))
SAMPLES = ("0", "1", "yes", "7", "2.5")


def _parsed(knob, raw):
    try:
        return ("ok", knob.parse(raw) if knob.parse else raw)
    except Exception as e:  # noqa: BLE001 — the error's type is compared
        return ("raises", type(e).__name__)


@pytest.mark.parametrize("name", [k.name for k in jax_knobs.KNOBS])
def test_every_jax_knob_is_accounted_for(name):
    j = jax_knobs.REGISTRY[name]
    listed = [name in knobs.NOT_ON_THE_CARD, name in knobs.NEXT_SLICE,
              name in knobs.REGISTRY]
    assert sum(listed) == 1, (name, listed)
    if name in knobs.NOT_ON_THE_CARD:
        assert len(knobs.NOT_ON_THE_CARD[name]) > 20
        return
    if name in knobs.NEXT_SLICE:
        assert "18d" in knobs.NEXT_SLICE[name] or \
            "18f" in knobs.NEXT_SLICE[name]
        return
    p = knobs.REGISTRY[name]
    assert (p.kind, p.choices, p.doc) == (j.kind, j.choices, j.doc)
    if name not in DEFAULT_DIFFERS:
        assert p.default == j.default
    for raw in SAMPLES:
        assert _parsed(p, raw) == _parsed(j, raw), (name, raw)


def test_the_port_registers_nothing_jax_lacks():
    assert set(knobs.REGISTRY) <= set(jax_knobs.REGISTRY)
    assert not set(knobs.NOT_ON_THE_CARD) & set(knobs.NEXT_SLICE)
    assert len(knobs.REGISTRY) + len(knobs.NOT_ON_THE_CARD) + len(
        knobs.NEXT_SLICE) == len(jax_knobs.REGISTRY)


def test_no_bare_environ_read_of_a_knob():
    pkg = ROOT / "mpitree_tpu_torch"
    bad = []
    for path in pkg.rglob("*.py"):
        if path.name == "knobs.py":
            continue
        for i, line in enumerate(path.read_text().splitlines(), 1):
            if re.search(r"os\.environ|getenv", line) and \
                    "MPITREE_TPU_" in line:
                bad.append(f"{path.relative_to(ROOT)}:{i}")
    assert not bad, bad


def test_version_equals_jax():
    assert mpitree_tpu_torch.__version__ == mpitree_tpu.__version__


# -- the README tables and their CLIs ------------------------------------------

CLIS = [(config_cli, "mpitree_tpu_torch.config", knobs.markdown_table),
        (obs_cli, "mpitree_tpu_torch.obs", None)]


def _jax_blocks(text: str) -> list:
    out = []
    for b, e in JAX_MARKERS:
        i, j = text.index(b), text.index(e)
        out.append(text[i:j + len(e)])
    return out


@pytest.mark.parametrize("cli", [c[0] for c in CLIS],
                         ids=["config", "obs"])
def test_checked_in_readme_passes_check(cli):
    assert cli.main(["--check", str(README)]) == 0
    text = README.read_text()
    # the port's block lives in the port section, before the JAX tables
    port_at = text.index(cli.BEGIN)
    assert port_at < text.index("## Estimators")
    assert all(text.index(b) > port_at for b, _ in JAX_MARKERS)


@pytest.mark.parametrize("cli", [c[0] for c in CLIS],
                         ids=["config", "obs"])
def test_write_repairs_a_drifted_copy(cli, tmp_path):
    text = README.read_text()
    head, rest = text.split(cli.BEGIN, 1)
    _, tail = rest.split(cli.END, 1)
    drifted = f"{head}{cli.BEGIN}\n| stale | row |\n{cli.END}{tail}"
    path = tmp_path / "README.md"
    path.write_text(drifted)
    assert cli.main(["--check", str(path)]) == 1
    assert cli.main(["--write", str(path)]) == 0
    assert cli.main(["--check", str(path)]) == 0
    assert path.read_text() == text


@pytest.mark.parametrize("cli", [c[0] for c in CLIS],
                         ids=["config", "obs"])
def test_cli_leaves_the_jax_blocks_byte_identical(cli, tmp_path):
    text = README.read_text()
    path = tmp_path / "README.md"
    # the JAX tables drifted and the port's too: --write repairs only its own
    jax_drift = text.replace(
        JAX_MARKERS[0][0], JAX_MARKERS[0][0] + "\n| jax | drift |", 1)
    path.write_text(jax_drift)
    before = _jax_blocks(path.read_text())
    assert cli.main(["--write", str(path)]) == 0
    assert _jax_blocks(path.read_text()) == before
    # and a file with only the JAX markers is refused, not rewritten
    only_jax = tmp_path / "JAX.md"
    only_jax.write_text("\n".join(_jax_blocks(text)))
    assert cli.main(["--check", str(only_jax)]) == 1
    assert cli.main(["--write", str(only_jax)]) == 1
    assert only_jax.read_text() == "\n".join(_jax_blocks(text))


def test_cli_subprocess_smoke():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    for mod in ("mpitree_tpu_torch.config", "mpitree_tpu_torch.obs"):
        out = subprocess.run([sys.executable, "-m", mod, "--markdown"],
                             capture_output=True, text=True, env=env,
                             cwd=ROOT, timeout=120)
        assert out.returncode == 0, out.stderr
        assert out.stdout.startswith("| ")
        chk = subprocess.run([sys.executable, "-m", mod, "--check"],
                             capture_output=True, text=True, env=env,
                             cwd=ROOT, timeout=120)
        assert chk.returncode == 0, chk.stderr


# -- the env reads moved onto the registry -------------------------------------

@pytest.mark.parametrize("raw,want", [
    (None, "auto"), ("", "auto"), ("levelwise", "levelwise"),
    (" Fused ", "fused"), ("bogus", ValueError)])
def test_engine_knob_reads_as_before(monkeypatch, raw, want):
    if raw is None:
        monkeypatch.delenv(builder.ENGINE_ENV, raising=False)
    else:
        monkeypatch.setenv(builder.ENGINE_ENV, raw)
    if want is ValueError:
        with pytest.raises(ValueError, match=r"MPITREE_TPU_ENGINE='bogus'; "
                           r"one of \('auto', 'fused', 'levelwise'\)"):
            builder.resolve_engine(builder.BuildConfig())
        return
    engine = builder.resolve_engine(builder.BuildConfig())
    assert engine == ("levelwise" if want == "levelwise" else "fused")


@pytest.mark.parametrize("raw,want", [
    (None, False), ("on", True), ("off", False), ("auto", False),
    ("maybe", ValueError)])
def test_subtraction_knob_reads_as_before(monkeypatch, raw, want):
    if raw is None:
        monkeypatch.delenv(builder.SUBTRACTION_ENV, raising=False)
    else:
        monkeypatch.setenv(builder.SUBTRACTION_ENV, raw)
    cfg = builder.BuildConfig()
    if want is ValueError:
        with pytest.raises(ValueError,
                           match="MPITREE_TPU_HIST_SUBTRACTION='maybe'"):
            builder.resolve_hist_subtraction(cfg, torch.device("cpu"))
        return
    assert builder.resolve_hist_subtraction(cfg, torch.device("cpu")) is want


@pytest.mark.parametrize("raw,k,note", [
    (None, 1, ""), ("4", 4, "explicit MPITREE_TPU_ROUNDS_PER_DISPATCH=4"),
    ("zero", 1, "invalid (ignored"), ("0", 1, "invalid (ignored")])
def test_rounds_knob_reads_as_before(monkeypatch, raw, k, note):
    if raw is None:
        monkeypatch.delenv(fused_rounds.ROUNDS_ENV, raising=False)
    else:
        monkeypatch.setenv(fused_rounds.ROUNDS_ENV, raw)
    got, reason = fused_rounds.resolve_rounds_per_dispatch(
        "auto", device_type="cpu", loss_kind="squared_error", loss_K=1,
        early_stopping=False, colsample=1.0, max_depth=6,
        max_leaf_nodes=None)
    assert got == k and note in reason


@pytest.mark.parametrize("raw,want", [(None, False), ("", False),
                                      ("0", False), ("1", True),
                                      ("yes", True)])
def test_no_native_knob_reads_as_before(monkeypatch, raw, want):
    if raw is None:
        monkeypatch.delenv("MPITREE_TPU_NO_NATIVE", raising=False)
    else:
        monkeypatch.setenv("MPITREE_TPU_NO_NATIVE", raw)
    assert native.disabled() is want

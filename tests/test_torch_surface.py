"""The port's public surface against the JAX package's, read with ``ast``.

For every module of ``mpitree_tpu/`` the port's module at the same path
must have each public top-level function, class and UPPER_CASE constant,
each public method of a public class (``__init__`` and ``__call__``
included), each parameter name of those, and each name an
``__init__.py`` exports; or ``tests/_torch_surface.ALLOWED`` must name it,
with its reason. An entry that names nothing of the JAX package, or
nothing the port lacks, is stale and fails too. Neither package is
imported: the sources are parsed, so the check takes about a second.

On the CPU: ``python -m pytest tests/test_torch_surface.py``.
"""

from __future__ import annotations

import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))

import _torch_surface as S  # noqa: E402


@pytest.fixture(scope="module")
def lack():
    return S.lacking()


@pytest.fixture(scope="module")
def jax_surface():
    return S.surface(S.JAX_ROOT)


def test_every_jax_public_name_has_a_counterpart_or_a_reason(lack):
    missing = S.missing(lack)
    assert missing == [], (
        "public names of the JAX package the port lacks, with no "
        "ALLOWED entry:\n" + "\n".join(missing))


def test_no_allowlist_entry_is_stale(lack, jax_surface):
    stale = S.stale(lack, jax_surface)
    assert stale == [], (
        "ALLOWED entries naming nothing of the JAX package or nothing the "
        "port lacks (remove them):\n" + "\n".join(stale))


def test_every_entry_gives_its_reason():
    for entry, reason in S.ALLOWED.items():
        assert entry.count(":") <= 2, entry
        assert isinstance(reason, str) and len(reason.split()) >= 3, entry


@pytest.mark.parametrize("key", [
    "serving/registry.py:ModelRegistry.publish:warm",
    "serving/registry.py:ModelRegistry.publish:model",
    "serving/__init__.py:NodeTable",
    "tree/__init__.py:TreeArrays",
    "obs/metrics.py:MetricsRegistry.snapshot",
    "serving/quantize.py:QuantizedState.q_rows_per_tree:table",
    "serving/tables.py:NodeTable.values:build",
    "utils/datasets.py:load_covtype:n_samples",
    "parallel/distributed.py:initialize:timeouts",
    "serving/traversal.py:ACC_KINDS",
    "utils/datasets.py:load_california",
])
def test_the_repaired_names_are_read_and_ported(jax_surface, lack, key):
    """The names this surface check was written for are on the JAX
    package's surface, and the port has each."""
    assert key in jax_surface
    assert key not in lack


def _write(root: Path, files: dict) -> Path:
    for rel, src in files.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(src))
    return root


def test_the_walk_finds_each_kind_of_gap(tmp_path):
    """Two small packages: every kind of entry the port lacks is found,
    and what it has (defined, imported, inherited) is not."""
    jax = _write(tmp_path / "j", {
        "__init__.py": """
            from j.m import Cls, fn
            __all__ = ["Cls", "fn", "LIMIT"]
            """,
        "m.py": """
            LIMIT = 3
            _PRIVATE = 1
            def fn(a, *, b=1, **kw): ...
            def gone(x): ...
            def _hidden(): ...
            class Cls:
                attr = 1
                def __init__(self, n): ...
                def __call__(self, x): ...
                def run(self, a, b): ...
                def inherited(self, q): ...
                def _inner(self): ...
            """,
        "only_jax.py": "def lone(): ...\n",
    })
    port = _write(tmp_path / "p", {
        "__init__.py": """
            from p.m import Cls, fn
            __all__ = ["Cls", "fn"]
            """,
        "m.py": """
            def fn(a, *, b=1): ...
            class Base:
                def inherited(self, q): ...
            class Cls(Base):
                def __init__(self, n): ...
                def run(self, a): ...
            """,
    })
    got = set(S.lacking(jax, port))
    want = {
        "__init__.py:LIMIT", "m.py:LIMIT", "m.py:fn:kw", "m.py:gone",
        "m.py:gone:x", "m.py:Cls.attr", "m.py:Cls.__call__",
        "m.py:Cls.__call__:x", "m.py:Cls.run:b", "only_jax.py:lone",
    }
    assert got == want


def test_covering_and_stale_rules():
    assert S.covers("ops/wide_hist.py", "ops/wide_hist.py:WINDOW")
    assert S.covers("a.py:f", "a.py:f:x")
    assert S.covers("a.py:C", "a.py:C.m:x")
    assert not S.covers("a.py:f", "a.py:fg")
    assert not S.covers("a.py:f:x", "a.py:f")
    saved = dict(S.ALLOWED)
    try:
        S.ALLOWED.clear()
        S.ALLOWED.update({"a.py:f": "r", "a.py:g": "r", "b.py": "r"})
        lack = ["a.py:f:x"]
        surface = {"a.py:f": None, "a.py:f:x": None, "a.py:h": None}
        # g names nothing of the JAX surface; b.py covers nothing lacking
        assert S.stale(lack, surface) == ["a.py:g", "b.py"]
        assert S.missing(lack) == []
        assert S.missing(["a.py:h"]) == ["a.py:h"]
    finally:
        S.ALLOWED.clear()
        S.ALLOWED.update(saved)


def test_the_check_imports_neither_package():
    code = (
        "import sys; sys.path.insert(0, 'tests')\n"
        "import _torch_surface as S\n"
        "lack = S.lacking()\n"
        "assert S.missing(lack) == [] and S.stale(lack) == []\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'torch', 'mpitree_tpu', 'mpitree_tpu_torch'))\n"
        "print(','.join(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=S.REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""

"""The port's native C++ split sweep against the JAX package's.

``mpitree_tpu_torch/native/split_kernel.cpp`` is a byte-identical copy of
``mpitree_tpu/native/split_kernel.cpp``; its loader is the port's own
(``g++`` into ``build/native/``, a hash of source, flags and host CPU in
the name, no quiet fallback). On the same seeded inputs the two bindings
return identical arrays: same source, same flags, same host.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")

from mpitree_tpu_torch import native  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
OUT_KEYS = ("feature", "bin", "cost", "counts", "constant")


@pytest.fixture
def gxx():
    if shutil.which("g++") is None:
        pytest.skip("no g++ on PATH: the native sweep is absent")


def test_split_kernel_source_is_byte_identical():
    ours = (REPO / "mpitree_tpu_torch/native/split_kernel.cpp").read_bytes()
    ref = (REPO / "mpitree_tpu/native/split_kernel.cpp").read_bytes()
    assert ours == ref


def _level_inputs(seed, *, n=3_000, F=7, B=12, C=5, S=9, per_slot=False,
                  weights="none"):
    """One frontier level: bins, classes, a node id per row (some rows
    parked at -1 or past the frontier), candidate counts, weights."""
    rng = np.random.default_rng(seed)
    xb = rng.integers(0, B, size=(n, F)).astype(np.int32)
    xb[:, 2] = 0  # a constant feature
    y = rng.integers(0, C, size=n).astype(np.int32)
    lo = 4
    nid = (lo + rng.integers(-1, S + 2, size=n)).astype(np.int32)
    if per_slot:
        n_cand = rng.integers(0, B, size=(S, F)).astype(np.int32)
    else:
        n_cand = np.full(F, B - 1, np.int32)
        n_cand[3] = 4
    w = {
        "none": None,
        "int": rng.integers(0, 4, size=n).astype(np.float32),
        "frac": (rng.random(n) * 3).astype(np.float32),
    }[weights]
    return dict(xb=xb, y=y, node_id=nid, w=w), dict(
        n_bins=B, n_classes=C, frontier_lo=lo, n_slots=S, n_cand=n_cand,
        n_cand_per_slot=per_slot,
    )


@pytest.mark.parametrize("criterion", ["entropy", "gini"])
@pytest.mark.parametrize("weights", ["none", "int", "frac"])
@pytest.mark.parametrize("per_slot", [False, True],
                         ids=["shared-ncand", "per-slot-ncand"])
@pytest.mark.parametrize("mcw", [0.0, 25.0], ids=["no-floor", "floor"])
def test_best_splits_classification_identical_to_jax(gxx, criterion, weights,
                                                    per_slot, mcw):
    from mpitree_tpu import native as jax_native

    arrays, kw = _level_inputs(
        zlib.crc32(f"{criterion}-{weights}-{per_slot}-{mcw}".encode()),
        per_slot=per_slot, weights=weights,
    )
    args = (arrays["xb"], arrays["y"], arrays["node_id"], arrays["w"])
    ours = native.best_splits_classification(
        *args, criterion=criterion, min_child_weight=mcw, **kw)
    ref = jax_native.best_splits_classification(
        *args, criterion=criterion, min_child_weight=mcw, **kw)
    assert ref is not None and ours is not None
    for k in OUT_KEYS:
        assert ours[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
    assert (ours["feature"] >= 0).any()  # the level really split something


def test_bad_shapes_raise_before_the_call(gxx):
    arrays, kw = _level_inputs(0)
    with pytest.raises(ValueError, match="n_cand"):
        native.best_splits_classification(
            arrays["xb"], arrays["y"], arrays["node_id"], None,
            criterion="entropy", **dict(kw, n_cand=kw["n_cand"][:3]))
    with pytest.raises(ValueError, match="w has shape"):
        native.best_splits_classification(
            arrays["xb"], arrays["y"], arrays["node_id"],
            np.ones(5, np.float32), criterion="entropy", **kw)


@pytest.mark.parametrize("raw,off", [
    ("1", True), ("yes", True), ("0", False), ("", False),
])
def test_no_native_knob(monkeypatch, raw, off):
    """``MPITREE_TPU_NO_NATIVE``: anything but "" or "0" disables, as the
    JAX package's knob does; read on every call."""
    monkeypatch.setenv("MPITREE_TPU_NO_NATIVE", raw)
    assert native.disabled() is off
    if off:
        assert native.lib() is None
        assert native.best_splits_classification(
            *(np.zeros((1, 1), np.int32), np.zeros(1, np.int32),
              np.zeros(1, np.int32), None),
            n_bins=1, n_classes=1, frontier_lo=0, n_slots=1,
            n_cand=np.zeros(1, np.int32), criterion="entropy") is None


def test_no_gxx_means_no_library(monkeypatch):
    monkeypatch.delenv("MPITREE_TPU_NO_NATIVE", raising=False)
    monkeypatch.setattr(native, "_LIB", [])
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    assert native.lib() is None


def test_failed_build_raises_with_the_compiler_output(gxx, monkeypatch,
                                                     tmp_path):
    """g++ present and the build fails: an error, never a quiet move to
    the numpy sweep (which would change every default tree)."""
    bad = tmp_path / "split_kernel.cpp"
    bad.write_text("this is not C++;\n")
    monkeypatch.delenv("MPITREE_TPU_NO_NATIVE", raising=False)
    monkeypatch.setattr(native, "_LIB", [])
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as e:
        native.lib()
    assert "error" in str(e.value)
    assert not list((tmp_path / "build").glob("*.so"))
    assert not list((tmp_path / "build").glob("*.tmp"))


def test_library_name_carries_source_flags_and_host(monkeypatch, tmp_path):
    src = tmp_path / "split_kernel.cpp"
    src.write_bytes(native.SRC.read_bytes())
    monkeypatch.setattr(native, "SRC", src)
    base = native.library_path()
    assert base.parent == native.BUILD_DIR
    assert base.name.startswith("libsplit_kernel-") and base.suffix == ".so"
    src.write_bytes(native.SRC.read_bytes() + b"// edited\n")
    edited = native.library_path()
    monkeypatch.setattr(native, "GXX_FLAGS", native.GXX_FLAGS + ("-g",))
    flagged = native.library_path()
    monkeypatch.setattr(native, "_host_tag", lambda: "other-cpu")
    other_host = native.library_path()
    assert len({base, edited, flagged, other_host}) == 4


_BUILD_ONE = """
import sys
from pathlib import Path
from mpitree_tpu_torch import native
native.BUILD_DIR = Path(sys.argv[1])
lib = native.lib()
print(native.library_path())
assert lib is not None
"""


def test_concurrent_first_builds_all_load(gxx, tmp_path):
    """Several processes building the same library at once (the test run's
    workers) each compile to their own file and move it into place: every
    one loads a whole library and no temporary file is left."""
    env = dict(os.environ)
    env.pop("MPITREE_TPU_NO_NATIVE", None)
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _BUILD_ONE, str(tmp_path)], cwd=REPO,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True,
        )
        for _ in range(4)
    ]
    outs = [p.communicate(timeout=600) for p in procs]
    assert [p.returncode for p in procs] == [0] * 4, [o[1] for o in outs]
    assert len({o[0] for o in outs}) == 1
    assert [p.name for p in tmp_path.iterdir()] == [
        Path(outs[0][0].strip()).name
    ]


_FIT = """
import sys
from mpitree_tpu_torch.obs import stats_view
from mpitree_tpu_torch.tree import DecisionTreeClassifier
from mpitree_tpu_torch.utils.datasets import covtype_like
X, y = covtype_like(6_000, seed=3)
clf = DecisionTreeClassifier(max_depth=12, max_bins=16, backend="host",
                             device="cpu").fit(X, y)
assert stats_view(clf.fit_report_)["refine_engine"] == "batched-native"
sys.stdout.write(clf.export_text())
"""


def test_native_thread_count_does_not_change_trees(gxx):
    """Frontier slots are independent, so ``MPITREE_TPU_NATIVE_THREADS``
    (negative = force threads even on small levels) never changes a tree,
    in the host tier or the refine tail."""
    texts = []
    for threads in ("1", "-4"):
        env = dict(os.environ, MPITREE_TPU_NATIVE_THREADS=threads)
        env.pop("MPITREE_TPU_NO_NATIVE", None)
        out = subprocess.run(
            [sys.executable, "-c", _FIT], cwd=REPO, capture_output=True,
            text=True, env=env, timeout=300,
        )
        assert out.returncode == 0, out.stderr[-2000:]
        texts.append(out.stdout)
    assert texts[0] == texts[1] and texts[0].count("\n") > 50

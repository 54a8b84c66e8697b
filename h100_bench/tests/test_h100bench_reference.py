"""The plain reference against the program on the CPU: it agrees with a
sound fit, rejects its own lower-precision control, and rejects a fit
whose timed path is broken underneath."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from h100_bench import control, harness
from h100_bench.reference import compare
from h100_bench.tests._small import SEED, SMALL

CELLS = list(SMALL)


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _run(cell):
    return harness.run_cell(cell, seed=SEED, seconds=0.0, trace=False,
                            device="cpu", overrides=SMALL[cell])


@pytest.mark.parametrize("cell", CELLS)
def test_reference_agrees_with_the_program(cell):
    res = _run(cell)
    assert res["correct"] is True
    assert all(v["value"] == 0 for v in res["check"].values())


@pytest.mark.parametrize("cell", CELLS)
def test_the_lower_precision_control_is_rejected(cell):
    """Over three data instances the program reads as correct on each and
    the control one precision lower is rejected on one at least: at this
    size the float32 sweep ties the float64 one on some instances."""
    limits = harness.find("checks", harness.cell_spec(cell)[1]["check"]).LIMITS
    rejected = 0
    for seed in (0, 1, 2):
        r = control.readings(cell, seed, device="cpu", overrides=SMALL[cell])
        assert r["data_seed"] == seed
        assert compare.judge(limits, r["program"])[0]
        rejected += not compare.judge(limits, r["control"])[0]
    assert rejected >= 1


def _alter_tree(monkeypatch):
    from mpitree_tpu_torch.core import fused_builder

    real = fused_builder._finalize_tree

    def altered(*a, **k):
        t = real(*a, **k)
        t.count[-1, 0] += 1  # one leaf's count, where the tree is made
        return t

    monkeypatch.setattr(fused_builder, "_finalize_tree", altered)


def _alter_round(monkeypatch):
    from mpitree_tpu_torch.boosting import fused_rounds

    real = fused_rounds._finalize_round_tree

    def altered(*a, **k):
        t = real(*a, **k)
        leaf = int(np.flatnonzero(t.left < 0)[0])
        t.value[leaf] = np.nextafter(t.value[leaf], np.float32(np.inf))
        return t

    monkeypatch.setattr(fused_rounds, "_finalize_round_tree", altered)


def _half_the_rows(monkeypatch):
    from mpitree_tpu_torch.boosting import gradient_boosting
    from mpitree_tpu_torch.models import classifier

    for mod in (classifier, gradient_boosting):
        real = mod.validate_fit_data

        def half(X, y, *a, _real=real, **k):
            n = len(X) // 2
            return _real(X[:n], y[:n], *a, **k)

        monkeypatch.setattr(mod, "validate_fit_data", half)


def _rows_stay(monkeypatch):
    from mpitree_tpu_torch.core.builder import FitInputs

    def stay(self, nids, *a, **k):
        return nids  # the level's step leaves every row where it was

    monkeypatch.setattr(FitInputs, "reroute", stay)


def _margins_stay(monkeypatch):
    from mpitree_tpu_torch.boosting import fused_rounds

    real = fused_rounds._grad_hess
    first = {}

    def stale(kind, raw, y):
        first.setdefault("raw", raw.clone())  # every round the first margins
        return real(kind, first["raw"], y)

    monkeypatch.setattr(fused_rounds, "_grad_hess", stale)


FAULTS = [
    ("covtype_tree.fit", _alter_tree),
    ("covtype_tree.fit_balanced", _alter_tree),
    ("covtype_gbdt.fit", _alter_round),
    ("covtype_tree.fit", _half_the_rows),
    ("covtype_gbdt.fit", _half_the_rows),
    ("covtype_tree.fit", _rows_stay),
    ("covtype_gbdt.fit", _margins_stay),
]


@pytest.mark.parametrize("cell,fault", FAULTS,
                         ids=[f"{c}-{f.__name__[1:]}" for c, f in FAULTS])
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    res = _run(cell)
    assert res["correct"] is False

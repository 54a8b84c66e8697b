"""The port's chaos layer (``resilience/chaos.py``) against the JAX
package's (``mpitree_tpu/resilience/chaos.py``).

- every chaos spec of the JAX tests (``tests/test_resilience*.py``)
  parses to the same plan in both packages, and malformed specs raise
  alike;
- the plans sequence alike: exact steps, ``at_level`` and
  ``clears_after`` arms, several faults at one site, ``corrupt``'s
  ``nan`` and ``skew`` on numpy arrays and tensors;
- what each kind raises is the CUDA / ``torch.distributed`` shape of
  ``resilience/failure.py``'s table, and the port classifies it as that
  table says (``ChaosKilled`` passes every rung);
- the env plan (``MPITREE_TPU_CHAOS``) reaches the seams, and the
  serving tier's seams fire where they should.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from mpitree_tpu.resilience import chaos as jax_chaos  # noqa: E402
from mpitree_tpu_torch.resilience import chaos  # noqa: E402
from mpitree_tpu_torch.resilience.chaos import (  # noqa: E402
    ChaosKilled,
    Fault,
)
from mpitree_tpu_torch.resilience.failure import (  # noqa: E402
    is_device_failure,
    is_oom_failure,
    is_transient_failure,
)

# every spec string the JAX package's resilience tests parse or install
SPECS = [
    "dispatch:3:unavailable;grad_hess:1:nan;round:2:hang:0.01",
    "level:1:deadline",
    "level:1:unavailable:at_level=4;dispatch:1:oom:clears_after=2;"
    "round:2:hang:0.5",
    "dispatch:1:unavailable",
    "fused_rounds:6:kill",
    "serving_dispatch:1:unavailable;sched_dispatch:2:aborted",
    "level:2:internal:arg=0.5:at_level=12",
    " expansion:3:data_loss ; ;dispatch:1:cancelled",
]
BAD = [
    "dispatch:unavailable",
    "dispatch:1:explode",
    "level:1:kill:bogus=1",
    "level:1:hang:at_level=2:0.5",
    "level:1:oom:clears_after=0",
    "level:0:kill",
]
FIELDS = ("site", "at", "kind", "arg", "at_level", "clears_after")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    chaos.clear()
    jax_chaos.clear()
    monkeypatch.delenv("MPITREE_TPU_CHAOS", raising=False)
    yield
    chaos.clear()
    jax_chaos.clear()


@pytest.mark.parametrize("spec", SPECS)
def test_specs_parse_to_the_jax_plan(spec):
    got = [tuple(getattr(f, k) for k in FIELDS)
           for f in chaos.parse_plan(spec).faults]
    want = [tuple(getattr(f, k) for k in FIELDS)
            for f in jax_chaos.parse_plan(spec).faults]
    assert got == want


@pytest.mark.parametrize("spec", BAD)
def test_malformed_specs_raise_alike(spec):
    with pytest.raises(ValueError) as want:
        jax_chaos.parse_plan(spec)
    with pytest.raises(ValueError) as got:
        chaos.parse_plan(spec)
    assert str(got.value) == str(want.value)


def _drive(mod, faults, steps):
    """Step ``mod``'s plan through ``steps`` ((site, level) pairs); the
    step indices that raised and the plan's record."""
    plan = mod.install([mod.Fault(*f[:3], **f[3]) for f in faults])
    raised = []
    for i, (site, level) in enumerate(steps):
        try:
            mod.step(site, level=level)
        except Exception:  # noqa: BLE001 — the injected shape differs
            raised.append(i)
    mod.clear()
    return raised, plan.fired, dict(plan.counts)


@pytest.mark.parametrize("faults,steps", [
    ([("dispatch", 2, "unavailable", {})], [("dispatch", None)] * 3),
    ([("level", 1, "unavailable", {"at_level": 3})],
     [("level", d) for d in (0, 1, 2, 3, 3, 4)]),
    ([("dispatch", 1, "oom", {"clears_after": 2})],
     [("dispatch", None)] * 4),
    ([("dispatch", 1, "unavailable", {}), ("dispatch", 2, "internal", {}),
      ("dispatch", 3, "unavailable", {})], [("dispatch", None)] * 4),
    ([("expansion", 2, "deadline", {"at_level": 5}),
      ("level", 1, "data_loss", {})],
     [("expansion", k) for k in (1, 5, 5, 5)] + [("level", 0)]),
])
def test_plans_sequence_like_jax(faults, steps):
    assert _drive(chaos, faults, steps) == _drive(jax_chaos, faults, steps)


def test_corrupt_nan_and_skew_like_jax():
    g, h = np.arange(1.0, 7.0), np.ones(6)
    for kind, arg in (("nan", None), ("skew", None), ("skew", 3.0)):
        for mod in (chaos, jax_chaos):
            mod.install([mod.Fault("grad_hess", 2, kind, arg=arg)])
        first = chaos.corrupt("grad_hess", g, h)
        jax_chaos.corrupt("grad_hess", g, h)
        assert all(a is b for a, b in zip(first, (g, h)))
        got = chaos.corrupt("grad_hess", g, h)
        want = jax_chaos.corrupt("grad_hess", g, h)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        # tensors too (the fused rounds corrupt their margins), copies
        chaos.install([Fault("grad_hess", 1, kind, arg=arg)])
        t = torch.arange(1.0, 7.0)
        tc = chaos.corrupt("grad_hess", t)
        np.testing.assert_array_equal(tc.numpy(), want[0])
        assert torch.equal(t, torch.arange(1.0, 7.0))
        assert np.isfinite(g).all()


# kind -> (torch type name, device failure, transient, oom)
TABLE = {
    "unavailable": ("DistNetworkError", True, True, False),
    "deadline": ("DistBackendError", True, True, False),
    "aborted": ("DistBackendError", True, False, False),
    "cancelled": ("DistBackendError", True, False, False),
    "internal": ("AcceleratorError", True, False, False),
    "data_loss": ("AcceleratorError", True, False, False),
    "oom": ("OutOfMemoryError", True, False, True),
}


@pytest.mark.parametrize("kind", sorted(TABLE))
def test_injected_shapes_classify_as_the_table_says(kind):
    name, dev, transient, oom = TABLE[kind]
    chaos.install([Fault("dispatch", 1, kind)])
    with pytest.raises(Exception) as ei:
        chaos.step("dispatch")
    e = ei.value
    assert type(e).__name__ == name
    assert isinstance(e, RuntimeError)
    assert "chaos-injected fault at dispatch#1" in str(e)
    assert (is_device_failure(e), is_transient_failure(e),
            is_oom_failure(e)) == (dev, transient, oom)


def test_kill_and_hang():
    chaos.install("round:2:kill;level:1:hang:0.01")
    chaos.step("round")
    with pytest.raises(ChaosKilled):
        chaos.step("round")
    assert not issubclass(ChaosKilled, Exception)
    chaos.step("level")  # sleeps, raises nothing
    chaos.install([Fault("x", 1, "nan")])
    chaos.step("x")  # a corrupt-only kind at a raise seam: ignored


def test_env_plan_reaches_the_seams(monkeypatch):
    monkeypatch.setenv("MPITREE_TPU_CHAOS", "level:2:deadline")
    chaos.step("level")
    with pytest.raises(Exception, match="collective operation timeout"):
        chaos.step("level")
    chaos.step("level")  # exhausted; the env plan keeps its counters
    monkeypatch.setenv("MPITREE_TPU_CHAOS", "level:1:deadline")
    with pytest.raises(Exception, match="collective operation timeout"):
        chaos.step("level")  # a new spec is a new plan


def test_active_block_installs_and_clears():
    with chaos.active(Fault("dispatch", 1, "unavailable")) as plan:
        with pytest.raises(Exception):
            chaos.step("dispatch")
    assert plan.fired == [("dispatch", 1, "unavailable")]
    chaos.step("dispatch")  # cleared: nothing fires

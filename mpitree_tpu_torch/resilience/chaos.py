"""Deterministic fault injection: the chaos layer that proves the ladder.

Counterpart of ``mpitree_tpu/resilience/chaos.py``: the same
:class:`Fault` / :class:`ChaosPlan` / :func:`parse_plan` grammar
(``site:at:kind[:arg][:key=value...];...``, the ``at_level`` and
``clears_after`` arms), the same kinds and sites, the same 1-based
per-plan counting. What differs is what a fault raises: the exception a
real CUDA or ``torch.distributed`` failure of that kind raises, with its
text (``resilience/failure.py``'s table), so the classifier sorts an
injected fault exactly as it sorts a real one:

- ``unavailable``: ``torch.distributed.DistNetworkError`` ("Connection
  reset by peer"), transient;
- ``deadline``: ``DistBackendError`` ("Watchdog caught collective
  operation timeout"), transient;
- ``aborted`` / ``cancelled``: ``DistBackendError`` ("NCCL communicator
  was aborted"), terminal;
- ``internal``: ``torch.AcceleratorError`` ("CUDA error: an illegal
  memory access was encountered"), terminal;
- ``data_loss``: ``torch.AcceleratorError`` ("CUDA error: uncorrectable
  ECC error encountered"), terminal;
- ``oom``: ``torch.OutOfMemoryError`` ("CUDA out of memory"), terminal;
- ``kill``: :class:`ChaosKilled`, a ``BaseException`` that no rung
  catches (a preemption: only the on-disk checkpoint survives);
- ``hang`` sleeps ``arg`` seconds; ``nan`` and ``skew`` corrupt a payload
  at a :func:`corrupt` seam.

An injected fault raises at the seam on the host: it never touches the
card, so the process's CUDA context stays healthy (a real sticky error
does not; ``chip_smoke.py`` phase 31 (d) makes one).

Sites, each a host-side seam that costs one global read with no plan
installed: ``dispatch`` (every attempt of the retry ladder),
``split_dispatch`` / ``counts_dispatch`` / ``update_dispatch`` (the
levelwise engine's split search, terminal sums and reroute,
``core/builder.py``), ``level`` (each level of the levelwise loop),
``leafwise_build`` (before the fused best-first build) and ``expansion``
/ ``expand_dispatch`` (each step of the host-stepped one,
``core/leafwise_builder.py``), ``round`` and ``grad_hess`` (each boosting
round of the host loop, ``boosting/gradient_boosting.py``),
``fused_rounds`` (inside each retried K-round dispatch,
``boosting/fused_rounds.py``), ``serving_dispatch`` (each traversal of
``serving/model.py``) and ``sched_dispatch`` (each coalesced batch of
``serving/scheduler.py``).

Install a plan with :func:`install` / :func:`active`, or through
``MPITREE_TPU_CHAOS`` (parsed once per distinct spec; its counters live
for the process).
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import torch

from mpitree_tpu_torch.config import knobs


class ChaosKilled(BaseException):
    """Simulated preemption. Derives from ``BaseException`` on purpose: no
    recovery rung may swallow it; only the on-disk checkpoint survives."""


def _dist_error(name: str):
    import torch.distributed as dist

    return getattr(dist, name, RuntimeError)


# kind -> (exception type, message head): the shape a real failure of the
# kind takes on CUDA and torch.distributed
_SHAPES = {
    "unavailable": (lambda: _dist_error("DistNetworkError"),
                    "Connection reset by peer"),
    "deadline": (lambda: _dist_error("DistBackendError"),
                 "Watchdog caught collective operation timeout: WorkNCCL "
                 "ran for 600000 milliseconds before timing out"),
    "aborted": (lambda: _dist_error("DistBackendError"),
                "NCCL communicator was aborted on rank 0"),
    "cancelled": (lambda: _dist_error("DistBackendError"),
                  "NCCL communicator was aborted on rank 0 (operation "
                  "cancelled)"),
    "internal": (lambda: getattr(torch, "AcceleratorError", RuntimeError),
                 "CUDA error: an illegal memory access was encountered"),
    "data_loss": (lambda: getattr(torch, "AcceleratorError", RuntimeError),
                  "CUDA error: uncorrectable ECC error encountered"),
    "oom": (lambda: torch.OutOfMemoryError,
            "CUDA out of memory. Tried to allocate 2.00 GiB"),
}

_KINDS = tuple(_SHAPES) + ("nan", "hang", "kill", "skew")


def injected(kind: str, site: str, n: int) -> BaseException:
    """The exception fault ``kind`` raises at step ``n`` of ``site``."""
    make, head = _SHAPES[kind]
    return make()(f"{head} (chaos-injected fault at {site}#{n})")


@dataclasses.dataclass(frozen=True)
class Fault:
    """One planned fault: fire at the ``at``-th (1-based) step of ``site``.

    ``arg``: seconds for ``kind='hang'``, the factor for ``'skew'``.
    ``at_level``: match only steps whose site reported this level or
    expansion (``step(site, level=...)``); ``at`` then counts matching
    steps, so a fault at level 4 fires once and stays quiet when the
    sub-build retry re-runs level 4. ``clears_after``: fire on that many
    consecutive matching steps from ``at``, then clear."""

    site: str
    at: int
    kind: str
    arg: float | None = None
    at_level: int | None = None
    clears_after: int | None = None

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(
                f"unknown chaos fault kind {self.kind!r}; one of {_KINDS}"
            )
        if self.at < 1:
            raise ValueError(f"fault 'at' is 1-based, got {self.at}")
        if self.clears_after is not None and self.clears_after < 1:
            raise ValueError(
                f"fault 'clears_after' must be >= 1, got {self.clears_after}"
            )


class ChaosPlan:
    """A set of faults plus the per-site step counters that sequence them
    (on the plan, so a fresh plan restarts the clock). ``fired`` records
    ``(site, step, kind)`` for every fault that triggered."""

    def __init__(self, faults):
        self.faults = [
            f if isinstance(f, Fault) else Fault(*f) for f in faults
        ]
        self.counts: dict[str, int] = {}
        # per-fault matching-step counters (at_level faults count only the
        # steps whose level matched)
        self.hits: dict[int, int] = {}
        self.fired: list[tuple[str, int, str]] = []

    def step(self, site: str, level: int | None = None) -> Fault | None:
        n = self.counts.get(site, 0) + 1
        self.counts[site] = n
        hit = None
        # every matching fault's clock advances on every step
        for i, f in enumerate(self.faults):
            if f.site != site:
                continue
            if f.at_level is not None and level != f.at_level:
                continue
            h = self.hits.get(i, 0) + 1
            self.hits[i] = h
            if hit is None and (
                h == f.at if f.clears_after is None
                else f.at <= h < f.at + f.clears_after
            ):
                hit = f
        if hit is not None:
            self.fired.append((site, n, hit.kind))
        return hit


_PLAN: ChaosPlan | None = None
_ENV_SPEC: str | None = None
_ENV_PLAN: ChaosPlan | None = None


def parse_plan(spec: str) -> ChaosPlan:
    """Parse ``"site:at:kind[:arg][:key=value...];..."`` into a
    :class:`ChaosPlan`: after the kind, either one positional float
    ``arg`` or ``key=value`` options (``arg``, ``at_level``,
    ``clears_after``)."""
    faults = []
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        bits = part.split(":")
        if len(bits) < 3:
            raise ValueError(
                f"malformed chaos fault {part!r}; expected "
                "site:at:kind[:arg][:key=value...]"
            )
        site, at, kind = bits[0], int(bits[1]), bits[2]
        arg = None
        named: dict = {}
        for bit in bits[3:]:
            if "=" in bit:
                key, _, val = bit.partition("=")
                if key == "arg":
                    named["arg"] = float(val)
                elif key in ("at_level", "clears_after"):
                    named[key] = int(val)
                else:
                    raise ValueError(
                        f"unknown chaos fault option {key!r} in {part!r}; "
                        "one of arg/at_level/clears_after"
                    )
            elif arg is None and not named:
                arg = float(bit)
            else:
                raise ValueError(
                    f"malformed chaos fault {part!r}: positional arg must "
                    "come before (and at most once among) key=value options"
                )
        if arg is not None:
            named["arg"] = arg
        faults.append(Fault(site, at, kind, **named))
    return ChaosPlan(faults)


def install(plan) -> ChaosPlan:
    """Install a plan (a ChaosPlan, an iterable of Faults, or a spec
    string); returns the live plan (for ``.fired``)."""
    global _PLAN
    if isinstance(plan, str):
        plan = parse_plan(plan)
    elif not isinstance(plan, ChaosPlan):
        plan = ChaosPlan(plan)
    _PLAN = plan
    return plan


def clear() -> None:
    """Remove any installed plan and forget the cached env plan."""
    global _PLAN, _ENV_SPEC, _ENV_PLAN
    _PLAN = None
    _ENV_SPEC = None
    _ENV_PLAN = None


@contextlib.contextmanager
def active(*faults):
    """``with chaos.active(Fault(...), ...):`` installs for a block."""
    plan = install(faults)
    try:
        yield plan
    finally:
        clear()


def _current() -> ChaosPlan | None:
    if _PLAN is not None:
        return _PLAN
    spec = knobs.raw("MPITREE_TPU_CHAOS")
    if not spec:
        return None
    global _ENV_SPEC, _ENV_PLAN
    if spec != _ENV_SPEC:
        _ENV_SPEC = spec
        _ENV_PLAN = parse_plan(spec)
    return _ENV_PLAN


def _fire(f: Fault, site: str, n: int) -> None:
    if f.kind in _SHAPES:
        raise injected(f.kind, site, n)
    if f.kind == "kill":
        raise ChaosKilled(f"chaos-injected preemption at {site}#{n}")
    if f.kind == "hang":
        time.sleep(float(f.arg or 0.0))
    # "nan" and "skew" corrupt at a corrupt() seam only


def step(site: str, level: int | None = None) -> None:
    """Advance ``site``'s counter; fire a matching fault if one is
    planned. ``level``: the site's level or expansion, which
    ``Fault(at_level=...)`` matches."""
    plan = _current()
    if plan is None:
        return
    f = plan.step(site, level)
    if f is not None:
        _fire(f, site, plan.counts[site])


def corrupt(site: str, *arrays):
    """Advance ``site``; on a planned ``nan`` fault return copies of
    ``arrays`` (numpy arrays or tensors) with NaN in the first element of
    each, on ``skew`` copies whose first half is scaled by ``arg``
    (default 2); raise and hang kinds act as at :func:`step`."""
    plan = _current()
    if plan is None:
        return arrays if len(arrays) != 1 else arrays[0]
    f = plan.step(site)
    if f is not None:
        if f.kind in ("nan", "skew"):
            out = []
            for a in arrays:
                a = a.clone() if isinstance(a, torch.Tensor) else a.copy()
                flat = a.reshape(-1)
                if f.kind == "nan":
                    flat[0] = float("nan")
                else:
                    flat[: max(len(flat) // 2, 1)] *= float(
                        f.arg if f.arg is not None else 2.0)
                out.append(a)
            arrays = tuple(out)
        else:
            _fire(f, site, plan.counts[site])
    return arrays if len(arrays) != 1 else arrays[0]

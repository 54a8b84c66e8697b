"""Sub-build recovery state: level and expansion snapshots.

Counterpart of ``mpitree_tpu/resilience/recovery.py`` without its
``OomRescue`` (which reads the memory ledger a failed build recorded; the
port has no such ledger before ``ROADMAP.md`` item 18e, so an OOM goes to
the host rung, as the JAX rescue does when it finds no ledger).

:class:`SnapshotSlot` is the handle an engine shares with the retry
ladder (``resilience/retry.py``): the engine saves a
:class:`LevelSnapshot` of its loop carry at each host boundary (the
levelwise engine per level, ``core/builder.py``; the host-stepped
best-first engine per expansion, ``core/leafwise_builder.py``). On a
transient failure the ladder's sub-build rung calls the build again, and
the engine resumes from the last completed boundary instead of from the
root. A snapshot holds references (the carried tensors are replaced,
never written in place, from one boundary to the next, and the host
buffers' writes of a re-run level are the same values again), so saving
one costs a dict.

``MPITREE_TPU_LEVEL_RETRY`` (``auto``, the default, and ``on`` take the
snapshots; ``off`` leaves a blip to the whole-build retry) gates them
(:func:`resolve_level_retry`).
"""

from __future__ import annotations

import dataclasses

from mpitree_tpu_torch.config import knobs

LEVEL_RETRY_ENV = "MPITREE_TPU_LEVEL_RETRY"


def resolve_level_retry() -> bool:
    """Whether the engines snapshot: ``MPITREE_TPU_LEVEL_RETRY`` is not
    "off" (the JAX package's ``resolve_level_retry("auto")``; the port's
    ``BuildConfig`` has no field to override it)."""
    v = knobs.value(LEVEL_RETRY_ENV)
    if v not in ("auto", "on", "off"):
        raise ValueError(f"unknown level_retry {v!r}")
    return v != "off"


@dataclasses.dataclass
class LevelSnapshot:
    """One resumable boundary: ``kind`` ("level" or "expansion"),
    ``position`` (the index to run next) and ``state``, the
    engine's resume payload, opaque to the ladder."""

    kind: str
    position: int
    state: dict


class SnapshotSlot:
    """The mutable handle shared between a build closure and the ladder.

    The engine :meth:`save`\\ s at every boundary and :meth:`clear`\\ s on
    success; the ladder's sub-build rung reads ``snapshot`` and accounts
    its retries through :meth:`note_retry`. The retry budget is per
    position: progress resets it, so a long fit survives separate faults
    at many levels, while a dead card spends it at one position and the
    ladder falls through to its next rung, with the slot cleared so that
    rung starts from the root."""

    def __init__(self):
        self.snapshot: LevelSnapshot | None = None
        self.retries = 0          # consecutive retries at one position
        self.total_retries = 0    # over the whole fit
        self._retry_key: tuple | None = None

    def save(self, kind: str, position: int, state: dict) -> None:
        self.snapshot = LevelSnapshot(kind, int(position), state)

    def take(self, kind: str) -> dict | None:
        """The resume payload when a snapshot of ``kind`` is pending."""
        s = self.snapshot
        return s.state if s is not None and s.kind == kind else None

    def clear(self) -> None:
        self.snapshot = None
        self._retry_key = None
        self.retries = 0

    def note_retry(self, budget: int) -> bool:
        """Account one sub-build retry; False when this position's budget
        is spent (and the slot is cleared)."""
        s = self.snapshot
        key = None if s is None else (s.kind, s.position)
        if key != self._retry_key:
            self._retry_key = key
            self.retries = 0
        if self.retries >= budget:
            self.clear()
            return False
        self.retries += 1
        self.total_retries += 1
        return True

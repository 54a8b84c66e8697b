"""Sub-build recovery state: level and expansion snapshots, and the OOM
rescue.

Counterpart of ``mpitree_tpu/resilience/recovery.py``.

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

:class:`OomRescue` is the rung between "retry on the card" and "the
host": when a launch runs the card out of memory
(``torch.OutOfMemoryError``) and the memory ledger the build recorded
(``obs/memory.py``, ``record.memory``) names a chunk-scaled array among
its largest, it shrinks the knob that array scales with (halve
``max_frontier_chunk``; ``hist_subtraction`` -> ``"off"``;
``rounds_per_dispatch`` -> 1) and the build runs again on the card,
bounded at :data:`MAX_SHRINKS` shrinks, each a typed ``oom_rescue`` event
naming the knob and the bytes. The build applies the shrinks to its
``BuildConfig`` on every (re-)dispatch (:meth:`OomRescue.apply`), so the
engine's own ``ledger_and_preflight`` re-prices the shrunk plan, and
re-refuses it if it still cannot fit, before its first launch. Neither
knob changes a tree: the chunk width is batching, and subtraction is
exact on both histogram routes. A resident-array OOM (the bins, the
per-row state) has no shrink: only a wider mesh or the host rung helps.
"""

from __future__ import annotations

import dataclasses

from mpitree_tpu_torch.config import knobs

LEVEL_RETRY_ENV = "MPITREE_TPU_LEVEL_RETRY"
# The OOM rescue's bound: shrinks per fit, across its re-dispatches.
MAX_SHRINKS = 3


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


class OomRescue:
    """The bounded shrink ladder between "retry on the card" and "the
    host" (the JAX package's ``:141-257``); built per fit by the
    estimator, consulted by ``retry.py`` when ``is_oom_failure`` fires.

    :meth:`attempt` reads the ledger the failed build recorded
    (``obs.record.memory``), maps the first chunk-scaled array among its
    five largest to its knob (``obs/memory.shrink_knob``), records the
    shrink in :attr:`overrides` and a typed ``oom_rescue`` event. The
    build closure applies :meth:`apply` to its config on every dispatch.
    ``snapshot_slot`` is cleared on every rescue: a snapshot holds
    tensors shaped by the old plan, so a rescued build starts over."""

    def __init__(self, obs=None, snapshot_slot: SnapshotSlot | None = None,
                 max_shrinks: int = MAX_SHRINKS):
        self.obs = obs
        self.slot = snapshot_slot
        self.max_shrinks = int(max_shrinks)
        self.shrinks = 0
        self.overrides: dict = {}

    # -- the build closure's side ------------------------------------------
    def apply(self, cfg):
        """``cfg`` with the shrinks so far (``BuildConfig`` fields only;
        ``rounds_per_dispatch`` is the fused boosting loop's, read from
        :attr:`rounds_per_dispatch`)."""
        kw = {k: v for k, v in self.overrides.items()
              if k in ("max_frontier_chunk", "hist_subtraction")}
        return dataclasses.replace(cfg, **kw) if kw else cfg

    @property
    def rounds_per_dispatch(self) -> int | None:
        return self.overrides.get("rounds_per_dispatch")

    # -- the ladder's side --------------------------------------------------
    def attempt(self, exc: BaseException, *, what: str) -> bool:
        """Propose and record one shrink; True means "run the build again
        on the card". False when the ladder is spent, no plan was
        recorded, or no chunk-scaled array is among the largest (a
        resident-array OOM)."""
        from mpitree_tpu_torch.obs import memory as memory_lib

        if self.shrinks >= self.max_shrinks:
            return False
        rec = getattr(self.obs, "record", None)
        mem = getattr(rec, "memory", None) or {}
        arrays = mem.get("arrays") or []
        if not arrays:
            return False
        top = sorted(arrays,
                     key=lambda a: -int(a.get("bytes_per_device", 0)))[:5]
        inputs = mem.get("inputs") or {}
        engine = inputs.get("engine")
        pick = None
        for a in top:
            knob = memory_lib.shrink_knob(str(a.get("name")), engine=engine)
            if knob is None:
                continue
            old_bytes = int(a.get("bytes_per_device", 0))
            if knob == "max_frontier_chunk":
                cur = self.overrides.get("max_frontier_chunk",
                                         inputs.get("chunk_slots"))
                cur = int(cur) if cur else 0
                if cur <= 1:
                    continue  # nothing left to halve
                pick = (knob, a, old_bytes, max(cur // 2, 1),
                        old_bytes // 2)
            elif knob == "hist_subtraction":
                if self.overrides.get("hist_subtraction") == "off":
                    continue
                pick = (knob, a, old_bytes, "off", 0)
            else:  # rounds_per_dispatch -> 1
                if self.overrides.get("rounds_per_dispatch") == 1:
                    continue
                pick = (knob, a, old_bytes, 1, None)
            break
        if pick is None:
            return False
        knob, arr, old_bytes, new_value, new_bytes = pick
        self.overrides[knob] = new_value
        self.shrinks += 1
        if self.slot is not None:
            self.slot.clear()
        if self.obs is not None:
            self.obs.counter("oom_rescues")
            self.obs.event(
                "oom_rescue",
                f"device OOM during {what} ({type(exc).__name__}: "
                f"{str(exc)[:160]}); the memory ledger prices "
                f"{arr.get('name')!r} as the binding chunk-scaled array — "
                f"shrinking {knob} to {new_value!r} and re-dispatching "
                f"on-device (rung {self.shrinks}/{self.max_shrinks}; "
                "preflight re-prices the shrunk plan before the next "
                "dispatch commits)",
                knob=knob,
                new_value=new_value,
                binding_array=arr.get("name"),
                old_bytes=old_bytes,
                new_bytes=new_bytes,
                shrink=self.shrinks,
                hbm_peak_bytes=mem.get("hbm_peak_bytes"),
            )
        return True

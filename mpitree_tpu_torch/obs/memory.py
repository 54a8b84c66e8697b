"""Host arithmetic of the streaming ingest: the chunk size a stream is cut
into, derived from a host-RAM budget, and the host's resident set.

Counterpart of the ingest subset of ``mpitree_tpu/obs/memory.py``
(``HOST_BUDGET_ENV`` ``:62-63``, ``host_ingest_budget`` /
``ingest_row_bytes`` / ``sketch_budget_bytes`` / ``ingest_chunk_rows``
``:180-216``, ``host_rss_bytes`` ``:1033-1046``), with the same formulas,
so a stream is cut where the JAX package cuts it. The planner around
them (``plan_ingest``, ``plan_fit`` and the rest of the memory ledger)
prices device memory in TPU terms there; its H100 form is ``ROADMAP.md``
Queue 1 item 18, and until then nothing here prices the card.
"""

from __future__ import annotations

import os

from mpitree_tpu_torch.config import knobs

HOST_BUDGET_ENV = "MPITREE_TPU_HOST_BYTES"
HOST_INGEST_BUDGET_DEFAULT = 1 << 30


def host_ingest_budget() -> int:
    """The host-RAM budget streamed chunk sizing derives from
    (``MPITREE_TPU_HOST_BYTES``, default 1 GiB, at least 1 MiB)."""
    env = knobs.raw(HOST_BUDGET_ENV)
    if env:
        try:
            return max(int(env), 1 << 20)
        except ValueError:
            pass
    return HOST_INGEST_BUDGET_DEFAULT


def ingest_row_bytes(features: int) -> int:
    """Peak host bytes one streamed row costs while its chunk is live: the
    raw float32 slice and its int32 bins, doubled for the binning pass's
    transposed copies."""
    return 2 * max(int(features), 1) * (4 + 4)


def sketch_budget_bytes(features: int, capacity: int) -> int:
    """A-priori bound on the merged sketches' host bytes: (float32 value,
    int64 count) pairs at full capacity per feature, doubled for a
    merge's concatenation."""
    return 2 * max(int(features), 1) * max(int(capacity), 1) * (4 + 8)


def ingest_chunk_rows(features: int, *, budget: int | None = None,
                      floor: int = 1024, cap: int = 1 << 22) -> int:
    """The chunk size of a stream that lets the pipeline choose: the most
    rows whose working set (:func:`ingest_row_bytes`) fits the budget,
    clamped to ``[floor, cap]``."""
    b = int(budget) if budget else host_ingest_budget()
    rows = b // ingest_row_bytes(features)
    return int(min(max(rows, int(floor)), int(cap)))


def host_rss_bytes() -> int | None:
    """This process's resident set in bytes, or None where unreadable."""
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        pass
    try:
        import resource

        return int(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss) * 1024
    except Exception:  # noqa: BLE001 — no reading is a None, not a failure
        return None

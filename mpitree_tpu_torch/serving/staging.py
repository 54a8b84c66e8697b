"""Bounded, overlapped request staging for streaming inference.

Counterpart of ``mpitree_tpu/serving/staging.py``: while batch *k* runs on
the card, batch *k+1*'s host-to-device copy should already be in flight.
``CompiledModel.raw_async`` on CUDA allows that overlap once two batches
are in flight (where the host keeps ahead of the card): it writes a batch
into a pinned slot, copies it on the model's copy stream and queues the
traversal behind that copy's event, without waiting. This stage adds the
bounded pipeline that keeps at most ``depth`` results outstanding
(backpressure materializes the oldest, so a burst cannot queue device
work without limit). Results come back in submission order as owned numpy
arrays (``CompiledModel.finalize``), so no pinned slot escapes to the
caller.
"""

from __future__ import annotations

from collections import deque


class StreamStage:
    """Bounded async pipeline over a :class:`~.model.CompiledModel`.

    >>> stage = StreamStage(model, depth=2)
    >>> for batch in batches:
    ...     for ticket, out in stage.submit(batch):
    ...         handle(ticket, out)
    >>> for ticket, out in stage.drain():
    ...     handle(ticket, out)
    """

    def __init__(self, model, *, depth: int = 2):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self.model = model
        self.depth = int(depth)
        self._inflight: deque = deque()
        self._next_ticket = 0
        # streaming callers skip raw()'s latency clock: the outstanding-
        # batch gauge and the staged-batch counter are their metrics
        self._m_depth = model.metrics.gauge("mpitree_serving_inflight")
        self._m_staged = model.metrics.counter(
            "mpitree_serving_staged_batches_total"
        )

    def _materialize(self, entry) -> tuple:
        ticket, out, n = entry
        return ticket, self.model.finalize(out, n)

    def submit(self, X) -> list:
        """Stage + dispatch one batch; returns any results whose slots
        this submission displaced (ready-or-forced, oldest first)."""
        done = []
        while len(self._inflight) >= self.depth:
            done.append(self._materialize(self._inflight.popleft()))
        out, n = self.model.raw_async(X)
        self._inflight.append((self._next_ticket, out, n))
        self._next_ticket += 1
        self._m_staged.inc()
        self._m_depth.set(len(self._inflight))
        return done

    def drain(self) -> list:
        """Block on everything still in flight (oldest first)."""
        done = []
        while self._inflight:
            done.append(self._materialize(self._inflight.popleft()))
        self._m_depth.set(0)
        return done

"""Phase timers, device traces and the replication check of a build.

Counterpart of ``mpitree_tpu/utils/profiling.py``:

- :class:`PhaseTimer` collects per-phase wall-clock seconds and calls for
  a build; estimators expose its summary as ``fit_stats_`` when
  ``MPITREE_TPU_PROFILE=1`` (None otherwise). Its no-op hooks are the
  channels ``mpitree_tpu_torch.obs.BuildObserver`` overrides, so a plain
  timer passed to a builder pays nothing for the record.
- :func:`trace` wraps ``torch.profiler`` for device-level traces
  (Chrome-trace JSON, viewable in Perfetto or TensorBoard), with the JAX
  package's entry-failure contract.
- :func:`assert_replicated`: every process of a mesh sweeps its own copy
  of the reduced histogram, as every JAX device does; under
  ``BuildConfig.debug`` the engines hold each level's decisions to be the
  same bits on every process, as the JAX builder does
  (``mpitree_tpu/core/builder.py:1400-1411``), and a fit whose processes
  diverge raises.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch

from mpitree_tpu_torch.config import knobs

DEBUG_ENV = "MPITREE_TPU_DEBUG"
PROFILE_ENV = "MPITREE_TPU_PROFILE"


def profiling_enabled() -> bool:
    """``MPITREE_TPU_PROFILE`` (unset, empty or ``"0"`` is off)."""
    return knobs.value(PROFILE_ENV)


def debug_checks_enabled() -> bool:
    """``MPITREE_TPU_DEBUG`` as the JAX package reads it: unset or empty
    is off, every other value but ``"0"`` on. The estimators' fits then
    build with ``BuildConfig(debug=True)``."""
    return knobs.value(DEBUG_ENV)


class PhaseTimer:
    """Accumulates wall-clock seconds and call counts per named phase.

    Also the base of the observability API: the no-op hooks below are the
    record channels :class:`mpitree_tpu_torch.obs.BuildObserver` overrides
    (counters, decisions, typed events, per-level rows, collective and
    compile accounting, fingerprints). The engines call them
    unconditionally, so a plain timer keeps working and pays nothing.
    ``device``: where a span's device work runs; on a CUDA device an
    enabled span ends with ``torch.cuda.synchronize``, so it times the
    work and not its launches. A disabled timer never synchronises.
    """

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.device = None
        self.seconds: dict = defaultdict(float)
        self.calls: dict = defaultdict(int)

    def _idle(self) -> None:
        dev = self.device
        if dev is not None and torch.device(dev).type == "cuda":
            torch.cuda.synchronize(dev)

    @contextlib.contextmanager
    def phase(self, name: str):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        ok = False
        try:
            yield
            ok = True
        finally:
            if ok:
                # not after a failure: a faulted card must see no more
                # CUDA calls from the span that saw the fault
                self._idle()
            self.seconds[name] += time.perf_counter() - t0
            self.calls[name] += 1

    # obs-native alias: ``with timer.span("bin"):`` == ``timer.phase``.
    span = phase

    # -- observability hooks (no-ops; see obs.BuildObserver) ---------------
    def counter(self, name: str, inc=1) -> None:
        pass

    def event(self, kind: str, message: str, **data) -> None:
        pass

    def decision(self, key: str, value, reason: str | None = None,
                 **inputs) -> None:
        pass

    def set_mesh(self, mesh, device=None) -> None:
        pass

    def level(self, **row) -> None:
        pass

    def collective(self, site: str, *, calls: int = 1,
                   nbytes: int = 0) -> None:
        pass

    def compile_note(self, entry: str, key, cache_size: int = 64, *,
                     churn: bool = True) -> bool:
        return False

    def memory_plan(self, plan) -> None:
        """No-op twin of BuildObserver.memory_plan."""

    def price_dispatch(self, entry: str, key, cost_fn) -> None:
        """No-op twin of BuildObserver.price_dispatch."""

    # Engines compute per-level state fingerprints (obs/fingerprint.py)
    # only when the timer wants them; a plain PhaseTimer doesn't.
    wants_fingerprints = False

    def fingerprint_tree(self, rows) -> None:
        """No-op twin of BuildObserver.fingerprint_tree."""

    @contextlib.contextmanager
    def compile_attribution(self, entry: str, fresh: bool = True):
        """No-op twin of BuildObserver.compile_attribution."""
        yield

    def round(self, **row) -> None:
        pass

    def summary(self) -> dict:
        return {
            name: {"seconds": round(self.seconds[name], 4),
                   "calls": self.calls[name]}
            for name in sorted(self.seconds)
        }

    def __repr__(self):
        total = sum(self.seconds.values())
        rows = [
            f"  {name:<12} {self.seconds[name]:8.3f}s  x{self.calls[name]}"
            for name in sorted(self.seconds, key=self.seconds.get,
                               reverse=True)
        ]
        body = "\n".join(rows)
        return f"PhaseTimer(total={total:.3f}s\n{body}\n)"


def _stop_profiler() -> None:
    """Stop a profiler session left running by a failed start."""
    try:
        if torch.autograd._profiler_enabled():
            torch.autograd._disable_profiler()
    except Exception:  # noqa: BLE001 — nothing was started
        pass


@contextlib.contextmanager
def trace(log_dir: str, on_event=None):
    """Device-level ``torch.profiler`` trace of the block: CPU activity,
    and CUDA kernels and copies where CUDA is available, written as a
    Chrome-trace JSON file (``*.pt.trace.json``) into ``log_dir`` when the
    block ends. Exceptions raised by the block propagate unchanged.

    The JAX package's entry-failure contract (``:134-163``): starting can
    fail after the profiler half-started (an unwritable ``log_dir``, a
    profiler already active), which would leave it running and every
    later ``trace`` failing. On entry failure the half-started session is
    stopped and a ``trace_unavailable`` event is reported through
    ``on_event(kind, message)`` (e.g. ``BuildObserver.event``); the block
    then runs untraced.
    """
    prof = None
    entered = False
    try:
        from torch.profiler import (
            ProfilerActivity,
            profile,
            tensorboard_trace_handler,
        )

        os.makedirs(str(log_dir), exist_ok=True)
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts,
                       on_trace_ready=tensorboard_trace_handler(str(log_dir)))
        prof.__enter__()
        entered = True
    except Exception as e:  # noqa: BLE001 — reported, the block still runs
        _stop_profiler()
        if on_event is not None:
            on_event("trace_unavailable", f"{type(e).__name__}: {e}")
    try:
        yield
    finally:
        if entered:
            prof.__exit__(None, None, None)


def replication_fingerprint(t: torch.Tensor) -> torch.Tensor:
    """An order-sensitive fingerprint of ``t``'s bits (0-d int64 in
    ``[0, 2**62)``, on ``t``'s device): its 32-bit words, each times
    ``(index % 8191) + 1``, summed in int64 (wrapping, deterministic).
    Equal bits give equal fingerprints on every process and device."""
    words = t.detach().contiguous().reshape(-1).view(torch.uint8)
    pad = (-words.numel()) % 4
    if pad:
        words = torch.cat([words, words.new_zeros(pad)])
    w = words.view(torch.int32).to(torch.int64)
    idx = torch.arange(w.numel(), dtype=torch.int64, device=w.device)
    return (w * (idx % 8191 + 1)).sum() % (1 << 62)


def assert_replicated(t: torch.Tensor, mesh, *, what: str = "") -> None:
    """Raise ``RuntimeError`` unless ``t`` (a level's decision buffer on
    the lead shard) holds the same bits on every process of ``mesh``: its
    fingerprint's maximum and minimum over the processes (one
    ``all_reduce`` MAX of ``(fp, -fp)``) must agree. A no-op without a
    process group (the local shards share one sweep); each check counts
    in ``mesh.stats["replication_checks"]``."""
    if mesh is None or mesh.group is None:
        return
    import torch.distributed as dist

    fp = replication_fingerprint(t)
    both = torch.stack([fp, -fp])
    dist.all_reduce(both, op=dist.ReduceOp.MAX, group=mesh.group)
    hi, neg_lo = (int(v) for v in both.cpu())
    if hi != -neg_lo:
        raise RuntimeError(
            f"replication check failed: split decisions diverged across "
            f"processes ({what}; fingerprints {-neg_lo} .. {hi})")
    mesh.stats["replication_checks"] += 1

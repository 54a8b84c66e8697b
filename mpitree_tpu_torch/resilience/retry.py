"""The retry, backoff and failover ladder around the card's builds and
dispatches.

Counterpart of ``mpitree_tpu/resilience/retry.py``, rung by rung, with
its warning texts:

1. **Sub-build retry** (``resume=``, a
   :class:`~mpitree_tpu_torch.resilience.recovery.SnapshotSlot`): a
   transient failure while an engine snapshot is pending calls the build
   again, and the engine resumes from its last completed level or
   expansion. Counter: ``level_retries``.
2. **Retry in place** (:func:`retry_device`, and the same rung in
   :func:`device_failover`): a transient failure
   (``failure.is_transient_failure``: a lost peer, a timed-out
   collective) runs the closure again after exponential backoff with
   deterministic jitter, up to ``ResilienceConfig.max_retries`` times.
   Counter: ``device_retries``.
3. **OOM rescue** (``rescue=``): the JAX package's on-device shrink
   ladder. It reads a memory ledger the port does not have yet
   (``ROADMAP.md`` item 18e); the parameter stays so that item only
   plugs a rescue in. With None an OOM falls through.
4. **Host failover** (the last rung of :func:`device_failover`), only
   with ``MPITREE_TPU_ELASTIC=1`` (``config.host_failover_enabled``):
   every budget spent, or a terminal failure (a sticky CUDA error, an
   aborted communicator, OOM). ``host_fn`` builds the same tree on the
   host tier (up to an exact cost tie, ``ROADMAP.md`` R3) from host
   copies of the inputs, with no CUDA call. Counter:
   ``device_failovers``. Where the knob is unset (the port's default;
   the JAX package's is on), the classified error raises instead, so a
   fit asked for on the card finishes there or fails.

``obs`` is the fit's stats sink: a dict (``fit_stats_``, whose counters
take the JAX package's names) or anything with ``counter(name)``. The
JAX package's typed events come with ``ROADMAP.md`` item 18a. User errors
re-raise from every rung, and ``MPITREE_TPU_ELASTIC=0`` turns the ladder
off. The budgets are read from the knobs (``ResilienceConfig.from_env``)
once per ladder. A ``chaos.ChaosKilled`` (a ``BaseException``) passes every rung.

CUDA errors surface at the next synchronising call, so every closure the
ladder runs on the card ends in one (its result's copy to the host, or
:func:`sync`): a fault of the dispatch is raised inside the ladder, not
after it.
"""

from __future__ import annotations

import time
import warnings

import torch

from mpitree_tpu_torch.resilience import chaos
from mpitree_tpu_torch.resilience.config import (
    ResilienceConfig,
    backoff_delay,
    elastic_enabled,
    host_failover_enabled,
)
from mpitree_tpu_torch.resilience.failure import (
    is_device_failure,
    is_oom_failure,
    is_transient_failure,
)


def count(obs, name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` of the sink ``obs`` (a dict, an
    object with ``counter``, or None)."""
    if obs is None:
        return
    if isinstance(obs, dict):
        obs[name] = obs.get(name, 0) + n
    else:
        obs.counter(name, n)


def sync(device) -> None:
    """Wait for ``device`` (a CUDA device; a no-op on the CPU), so that an
    asynchronous CUDA fault of the work queued there raises here."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _transient_retry(e: BaseException, attempt: int, cfg: ResilienceConfig,
                     what: str, obs) -> bool:
    """One retry-rung step: classify, count, warn, back off. True means
    "run the closure again" (the sleep happened)."""
    if not (elastic_enabled() and is_transient_failure(e)
            and attempt < cfg.max_retries):
        return False
    delay = backoff_delay(cfg, attempt, salt=what)
    n = attempt + 1
    count(obs, "device_retries")
    warnings.warn(
        f"transient device failure during {what} "
        f"({type(e).__name__}: {str(e)[:160]}); retrying on the device "
        f"tier in {delay:.2f}s ({n}/{cfg.max_retries})",
        stacklevel=3,
    )
    time.sleep(delay)
    return True


def _subbuild_retry(e: BaseException, resume, cfg: ResilienceConfig,
                    what: str, obs) -> bool:
    """The sub-build rung: a transient failure with a pending snapshot
    calls the build again, which resumes from the snapshot. False (no
    snapshot, not transient, or this position's budget spent, which
    clears the slot) falls through to the whole-build rungs."""
    if resume is None or resume.snapshot is None:
        return False
    if not (elastic_enabled() and is_transient_failure(e)):
        return False
    snap = resume.snapshot
    if not resume.note_retry(cfg.max_retries):
        return False
    delay = backoff_delay(cfg, resume.retries - 1, salt=f"{what}#sub")
    count(obs, "level_retries")
    warnings.warn(
        f"transient device failure during {what} "
        f"({type(e).__name__}: {str(e)[:160]}); resuming from "
        f"{snap.kind} {snap.position} in {delay:.2f}s "
        f"({resume.retries}/{cfg.max_retries})",
        stacklevel=3,
    )
    time.sleep(delay)
    return True


def _oom_rescue(e: BaseException, rescue, what: str) -> bool:
    if rescue is None or not (elastic_enabled() and is_oom_failure(e)):
        return False
    return rescue.attempt(e, what=what)


def retry_device(device_fn, *, what: str, obs=None, resume=None,
                 rescue=None):
    """Run ``device_fn`` with the device-side rungs only (sub-build
    resume, transient retry, OOM rescue); re-raise when they are spent.
    For work with no host twin: the boosting rounds, a best-first build,
    a streamed fit, a serving dispatch."""
    cfg = ResilienceConfig.from_env()
    attempt = 0
    while True:
        try:
            chaos.step("dispatch")
            return device_fn()
        except Exception as e:  # noqa: BLE001 — classified, not swallowed
            if _subbuild_retry(e, resume, cfg, what, obs):
                continue
            if _transient_retry(e, attempt, cfg, what, obs):
                attempt += 1
                continue
            if _oom_rescue(e, rescue, what):
                continue
            raise


def device_failover(device_fn, host_fn, *, what: str, obs=None,
                    resume=None, rescue=None):
    """Run ``device_fn`` through the whole ladder; ``host_fn`` is the last
    rung, reached only through a device failure of the classes in
    ``resilience/failure.py`` and only with ``MPITREE_TPU_ELASTIC=1``
    (user errors and unclassified errors re-raise; so does a spent or
    terminal failure while the knob is unset, and everything with
    ``MPITREE_TPU_ELASTIC=0``)."""
    cfg = ResilienceConfig.from_env()
    attempt = 0
    while True:
        try:
            chaos.step("dispatch")
            return device_fn()
        except Exception as e:  # noqa: BLE001 — classified, not swallowed
            if not (elastic_enabled() and is_device_failure(e)):
                raise
            if _subbuild_retry(e, resume, cfg, what, obs):
                continue
            if _transient_retry(e, attempt, cfg, what, obs):
                attempt += 1
                continue
            if _oom_rescue(e, rescue, what):
                continue
            if not host_failover_enabled():
                raise
            count(obs, "device_failovers")
            warnings.warn(
                f"device failure during {what} ({type(e).__name__}: "
                f"{str(e)[:200]}); rebuilding on the host tier"
                + (f" after {attempt} device retries" if attempt else ""),
                stacklevel=2,
            )
            return host_fn()

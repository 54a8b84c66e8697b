"""Failure classification: which exceptions mean the card or its links
failed.

Counterpart of ``mpitree_tpu/resilience/failure.py``, with its three
predicates and its bounded chain walk (``:98-156``). The JAX package
matches gRPC statuses in the messages of a tunnelled PJRT client; on an
H100 the failures have other shapes, so the classes below are designed
for CUDA and ``torch.distributed``:

==============  ======================  ====================================  ==========
chaos kind      JAX status              CUDA / torch.distributed shape        class
==============  ======================  ====================================  ==========
``unavailable`` UNAVAILABLE             ``DistNetworkError``, or a gloo or    transient
                                        NCCL peer lost ("Connection reset
                                        by peer", "remote process exited or
                                        there was a network error")
``deadline``    DEADLINE_EXCEEDED       ``DistBackendError`` "Watchdog caught transient
                                        collective operation timeout"
``aborted``,    ABORTED, CANCELLED      ``DistBackendError`` "NCCL            terminal
``cancelled``                           communicator was aborted"
``internal``    INTERNAL                ``torch.AcceleratorError`` "CUDA      terminal
                                        error: an illegal memory access was
                                        encountered" / "unspecified launch
                                        failure" (sticky)
``data_loss``   DATA_LOSS               ``torch.AcceleratorError`` "CUDA      terminal
                                        error: uncorrectable ECC error
                                        encountered" (sticky)
``oom``         RESOURCE_EXHAUSTED      ``torch.OutOfMemoryError`` "CUDA out  terminal,
                                        of memory" (not sticky)               OOM
==============  ======================  ====================================  ==========

Why the rows differ from the JAX package's:

- **aborted is terminal.** JAX retries ABORTED. Here it means an aborted
  NCCL communicator, and a retry re-runs its collective on that same
  communicator (the ladder does not rebuild the process group: every
  process would have to take part, and ``parallel/distributed.shutdown``
  tears the whole world down), which hangs or fails again. So it goes to
  the host rung, which needs no collective.
- **A sticky error is terminal.** After an illegal address, a launch
  failure or an uncorrectable ECC error every CUDA call of the process
  fails (the context is lost), so a retry on the card cannot succeed;
  the host rung must run on host copies made before the dispatch.
- **OOM is terminal,** as in JAX: the same program on the same live state
  fails the same way, so no retry rung runs it again as it was. The OOM
  rescue (``recovery.OomRescue``) runs a shrunk plan instead where the
  memory ledger names a chunk-scaled array; otherwise an OOM goes to the
  host rung, or raises where there is none.
- **A device-side assert is not a device failure.** It is what an
  out-of-range index does: a program bug, which must re-raise like any
  other (it is sticky all the same). So are CUDA errors of a bad launch
  ("invalid argument", "invalid configuration argument").

The walk follows ``__cause__`` (else ``__context__`` unless suppressed)
at most :data:`_MAX_CHAIN_DEPTH` links, cycle-safe, and stops at a
user-error link (``ValueError`` and friends): a bug raised while handling
a device failure is still a bug the caller must see.
"""

from __future__ import annotations

# Sticky CUDA errors (cudaGetErrorString's text): the process's context
# is lost, so these are terminal device failures.
_STICKY_CUDA_MARKERS = (
    "an illegal memory access was encountered",
    "unspecified launch failure",
    "uncorrectable ECC error encountered",
    "an illegal instruction was encountered",
    "misaligned address",
    "hardware stack error",
    "the launch timed out and was terminated",
    "invalid program counter",
)

# Allocator exhaustion: the caching allocator's message, or a CUDA call's
# cudaErrorMemoryAllocation.
_OOM_MARKERS = ("CUDA out of memory", "CUDA error: out of memory")

# An aborted communicator: terminal (see the module docstring).
_ABORT_MARKERS = (
    "communicator was aborted",
    "NCCL communicator was aborted",
)

# A lost peer or a timed-out collective, as gloo and NCCL word them:
# transient.
_LINK_MARKERS = (
    "Connection reset by peer",
    "Connection closed by peer",
    "Connection closed by remote peer",
    "Connection refused",
    "Broken pipe",
    "remote process exited or there was a network error",
    "collective operation timeout",
    "Timed out waiting",
)

# Definite user-error/program-bug types: never classified, and the chain
# walk stops rather than looking past them.
_USER_ERROR_TYPES = (
    ValueError,
    TypeError,
    KeyError,
    IndexError,
    AttributeError,
    AssertionError,
    NotImplementedError,
)

# Real wrap chains are 2-3 deep; a deeper one is pathological.
_MAX_CHAIN_DEPTH = 8

TRANSIENT, TERMINAL, OOM = "transient", "terminal", "oom"


def _chain(exc: BaseException):
    """Yield ``exc`` then its causes/contexts, bounded and cycle-safe
    (``__cause__`` wins over ``__context__``; ``raise ... from None``
    ends the walk)."""
    seen: set[int] = set()
    node: BaseException | None = exc
    for _ in range(_MAX_CHAIN_DEPTH):
        if node is None or id(node) in seen:
            return
        seen.add(id(node))
        yield node
        if node is not exc and isinstance(node, _USER_ERROR_TYPES):
            return
        if node.__cause__ is not None:
            node = node.__cause__
        elif node.__suppress_context__:
            return
        else:
            node = node.__context__


def _names(exc: BaseException) -> set:
    return {t.__name__ for t in type(exc).__mro__}


def classify(exc: BaseException) -> str | None:
    """The class of one link (no chain walk): :data:`OOM`,
    :data:`TERMINAL`, :data:`TRANSIENT` or None (not a device failure).
    Types are matched by name, so a torch without ``AcceleratorError``
    (whose CUDA errors are plain ``RuntimeError`` "CUDA error: ...")
    classifies alike."""
    if isinstance(exc, _USER_ERROR_TYPES):
        return None
    names = _names(exc)
    msg = str(exc)
    if "OutOfMemoryError" in names or (
            isinstance(exc, RuntimeError)
            and any(m in msg for m in _OOM_MARKERS)):
        return OOM
    if "AcceleratorError" in names or (
            isinstance(exc, RuntimeError) and "CUDA error:" in msg):
        return (TERMINAL if any(m in msg for m in _STICKY_CUDA_MARKERS)
                else None)
    if isinstance(exc, ConnectionError):
        return TRANSIENT  # reset, refused, aborted: a lost peer
    if "DistError" in names or isinstance(exc, (RuntimeError, OSError)):
        if any(m in msg for m in _ABORT_MARKERS):
            return TERMINAL
        if "DistNetworkError" in names or any(m in msg
                                              for m in _LINK_MARKERS):
            return TRANSIENT
    return None


def is_device_failure(exc: BaseException) -> bool:
    """True when ``exc`` (or a chained cause/context) is a card, CUDA or
    collective-link failure of the table above; a user error never is."""
    if isinstance(exc, _USER_ERROR_TYPES):
        return False
    return any(classify(e) is not None for e in _chain(exc))


def is_oom_failure(exc: BaseException) -> bool:
    """True when the failure is allocator exhaustion anywhere down the
    chain: terminal by class."""
    if isinstance(exc, _USER_ERROR_TYPES):
        return False
    return any(classify(e) == OOM for e in _chain(exc))


def is_transient_failure(exc: BaseException) -> bool:
    """True when ``exc`` is a device failure a bounded retry can heal (a
    lost peer, a timed-out collective); sticky CUDA errors, an aborted
    communicator and OOM skip straight to the host rung."""
    if isinstance(exc, _USER_ERROR_TYPES):
        return False
    return any(classify(e) == TRANSIENT for e in _chain(exc))

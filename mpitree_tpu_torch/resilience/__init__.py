"""mpitree_tpu_torch.resilience: the failure-handling subsystem on the card.

Counterpart of ``mpitree_tpu/resilience/``, with its public names (less
``OomRescue``, which waits for the memory ledger of ``ROADMAP.md`` item
18e). The ladder:

1. **retry in place**: a transient failure (a lost peer, a timed-out
   collective) runs the build or dispatch again on the card, with
   bounded exponential backoff, from the last completed level or
   expansion where the engine snapshotted one (``retry``, ``recovery``);
2. **checkpoint at natural barriers**: forest tree groups and boosting
   round groups persist as they complete and resume to the same model
   (``checkpoint``);
3. **degrade last, when asked**: with ``MPITREE_TPU_ELASTIC=1``, a
   terminal failure (a sticky CUDA error, an aborted communicator, OOM)
   or a spent retry budget rebuilds on the host tier, which grows the
   same tree (up to an exact cost tie, ``ROADMAP.md`` R3) from host
   copies of the inputs (``retry.device_failover``). Unset, the failure
   raises: a fit asked for on the card never finishes on the CPU by
   itself.

``failure`` sorts CUDA and ``torch.distributed`` exceptions into these
classes; ``chaos`` injects exceptions of the same shapes at fixed seams,
deterministically, to prove every rung without a failing card.

Knobs: ``MPITREE_TPU_RETRIES``, ``MPITREE_TPU_BACKOFF_S``,
``MPITREE_TPU_ELASTIC``, ``MPITREE_TPU_LEVEL_RETRY``,
``MPITREE_TPU_CHAOS`` (``config/knobs.py``).
"""

from mpitree_tpu_torch.resilience import chaos
from mpitree_tpu_torch.resilience.checkpoint import (
    BoostCheckpoint,
    BuildCheckpoint,
    ForestCheckpoint,
)
from mpitree_tpu_torch.resilience.config import (
    ResilienceConfig,
    backoff_delay,
    elastic_enabled,
)
from mpitree_tpu_torch.resilience.failure import (
    is_device_failure,
    is_oom_failure,
    is_transient_failure,
)
from mpitree_tpu_torch.resilience.recovery import (
    SnapshotSlot,
    resolve_level_retry,
)
from mpitree_tpu_torch.resilience.retry import device_failover, retry_device

__all__ = [
    "BoostCheckpoint",
    "BuildCheckpoint",
    "ForestCheckpoint",
    "ResilienceConfig",
    "SnapshotSlot",
    "backoff_delay",
    "chaos",
    "device_failover",
    "elastic_enabled",
    "is_device_failure",
    "is_oom_failure",
    "is_transient_failure",
    "resolve_level_retry",
    "retry_device",
]

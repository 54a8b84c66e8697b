"""ResilienceConfig: the knobs of the retry, backoff and failover ladder.

Counterpart of ``mpitree_tpu/resilience/config.py``, with its names,
defaults and parse rules. An explicit ``ResilienceConfig`` passed by a
caller wins; otherwise :meth:`ResilienceConfig.from_env` reads the
registry (``config/knobs.py``) once per ladder:

- ``MPITREE_TPU_RETRIES``: transient device retries before the next rung
  (default 2; 0 disables the retry rung);
- ``MPITREE_TPU_BACKOFF_S``: base backoff in seconds (default 0.5; retry
  ``a`` sleeps ``base * 2**a`` plus deterministic jitter, capped);
- ``MPITREE_TPU_ELASTIC``: ``0`` switches the whole ladder off, so device
  failures raise; ``1`` adds the host rung (``retry.device_failover``).
  Unset, the retry rungs run and a terminal failure raises: unlike the
  JAX package, the port moves a fit off the card only when asked.

A malformed value warns and falls back to the default rather than
failing a fit over a typo.
"""

from __future__ import annotations

import dataclasses
import hashlib
import warnings

from mpitree_tpu_torch.config import knobs


def elastic_enabled() -> bool:
    """The ladder's device rungs: on unless ``MPITREE_TPU_ELASTIC=0``."""
    return knobs.value("MPITREE_TPU_ELASTIC") is not False


def host_failover_enabled() -> bool:
    """The host rung: only where ``MPITREE_TPU_ELASTIC`` is set, and not
    to ``0``."""
    return knobs.value("MPITREE_TPU_ELASTIC") is True


def _env_number(name: str, cast, default):
    raw = knobs.raw(name)
    if raw is None or raw == "":
        return default
    try:
        v = cast(raw)
        if v < 0:
            raise ValueError(v)
        return v
    except (TypeError, ValueError):
        warnings.warn(
            f"ignoring malformed {name}={raw!r} (expected a non-negative "
            f"{cast.__name__}); using the default {default!r}",
            stacklevel=3,
        )
        return default


@dataclasses.dataclass(frozen=True)
class ResilienceConfig:
    """Bounded retry-with-exponential-backoff parameters.

    ``jitter_key`` seeds the deterministic jitter (a hash, never
    ``random``): two processes retrying the same fault spread out, and a
    rerun of the same config sleeps the same schedule."""

    max_retries: int = 2
    backoff_base_s: float = 0.5
    backoff_cap_s: float = 8.0
    jitter_key: int = 0

    @classmethod
    def from_env(cls) -> "ResilienceConfig":
        return cls(
            max_retries=_env_number("MPITREE_TPU_RETRIES", int, 2),
            backoff_base_s=_env_number("MPITREE_TPU_BACKOFF_S", float, 0.5),
        )


def backoff_delay(cfg: ResilienceConfig, attempt: int, salt: str = "") -> float:
    """Seconds to sleep before retry ``attempt`` (0-based): the base times
    ``2**attempt``, capped, plus up to 25% jitter from (``jitter_key``,
    ``salt``, ``attempt``): the JAX package's numbers for the same salt."""
    base = min(cfg.backoff_base_s * (2.0 ** attempt), cfg.backoff_cap_s)
    h = hashlib.sha256(
        f"{cfg.jitter_key}:{salt}:{attempt}".encode()
    ).digest()
    frac = int.from_bytes(h[:4], "big") / 2.0**32
    return base * (1.0 + 0.25 * frac)

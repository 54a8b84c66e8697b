"""The replication check of a build over several processes.

Counterpart of ``debug_checks_enabled``, ``replication_fingerprint`` and
``assert_replicated`` (``mpitree_tpu/utils/profiling.py:37-38``,
``:167-188``), the only parts of that module ported so far (its timers
and traces are ``ROADMAP.md`` item 18).
Every process of a mesh sweeps its own copy of the reduced histogram, as
every JAX device does; under ``BuildConfig.debug`` the engines hold each
level's decisions to be the same bits on every process, as the JAX
builder does (``mpitree_tpu/core/builder.py:1400-1411``), and a fit whose
processes diverge raises.
"""

from __future__ import annotations

import os

import torch

DEBUG_ENV = "MPITREE_TPU_DEBUG"


def debug_checks_enabled() -> bool:
    """``MPITREE_TPU_DEBUG`` as the JAX package reads it: unset or empty
    is off, every other value but ``"0"`` on. The estimators' fits then
    build with ``BuildConfig(debug=True)``. Read here until the knob
    registry takes it (``ROADMAP.md`` item 18)."""
    raw = os.environ.get(DEBUG_ENV, "")
    return raw not in ("", "0")


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

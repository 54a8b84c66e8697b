"""Joining several processes: the ``mpirun`` replacement.

Counterpart of ``mpitree_tpu/parallel/distributed.py``, on
``torch.distributed`` instead of ``jax.distributed``. Every process of a
job calls :func:`initialize` with the same coordinator address and
process count and its own index, then fits with ``n_devices="all"``: the
mesh (``parallel/mesh.resolve_mesh``) then spans every process's shards,
and the histogram reductions cross processes (``parallel/collective``)::

    from mpitree_tpu_torch.parallel import distributed
    distributed.initialize("10.0.0.1:29500", num_processes=2, process_id=r)
    clf = ParallelDecisionTreeClassifier().fit(X, y)  # n_devices="all"

The backend is NCCL where CUDA is available and gloo otherwise; a caller
may name gloo for CUDA shards too (several processes sharing one card).
The mesh code uses only ``all_reduce`` and ``broadcast``, the collectives
gloo offers for CUDA tensors, so one path serves every backend.

Failures are bounded, as the JAX package's are
(``tests/test_distributed_failures.py``): a process that never arrives
fails every present process's :func:`initialize` within ``timeout``
seconds, and a collective with a peer that died raises in the survivors
(gloo: when the connection drops, at the latest after ``timeout``).
"""

from __future__ import annotations

import datetime
import os

import torch


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, *,
               backend: str | None = None,
               timeout: float = 300.0) -> None:
    """Join the job's process group (idempotent).

    ``coordinator_address`` ``"host:port"`` (process 0 listens there),
    ``num_processes`` and ``process_id`` as ``jax.distributed.initialize``
    takes them. With no arguments, a launcher's environment
    (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, as
    ``torchrun`` sets it) is read; on a single process with neither this
    is a no-op. ``backend`` None is NCCL when CUDA is available, else
    gloo. ``timeout`` (seconds) bounds the join and every collective."""
    import torch.distributed as dist

    if dist.is_initialized():
        return
    env = os.environ.get("MASTER_ADDR") and os.environ.get("MASTER_PORT")
    if coordinator_address is None and num_processes in (None, 1) \
            and not env:
        return  # one process, nothing to join
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    kw = {"backend": backend,
          "timeout": datetime.timedelta(seconds=float(timeout))}
    if coordinator_address is None:
        kw["init_method"] = "env://"
    else:
        kw.update(init_method=f"tcp://{coordinator_address}",
                  world_size=int(num_processes), rank=int(process_id))
    dist.init_process_group(**kw)


def shutdown() -> None:
    """Leave the process group (a no-op when none was joined) and forget
    the mesh axes' subgroups of its world, which die with it."""
    import torch.distributed as dist

    from mpitree_tpu_torch.parallel import mesh

    if dist.is_initialized():
        dist.destroy_process_group()
    mesh._subgroups.clear()


def process_info(device=None) -> dict:
    """Rank and size, the keys of the JAX package's ``process_info``
    (``:75-82``): ``process_index``, ``process_count``, ``local_devices``
    (the shards this process offers for ``device``: its CUDA cards, or
    ``mesh.cpu_shards()`` where ``device`` is the CPU; None is CUDA when
    available, else the CPU) and ``global_devices`` (the local count times
    the processes)."""
    import torch.distributed as dist

    from mpitree_tpu_torch.parallel.mesh import local_devices

    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    joined = dist.is_available() and dist.is_initialized()
    count = dist.get_world_size() if joined else 1
    local = len(local_devices(device))
    return {
        "process_index": dist.get_rank() if joined else 0,
        "process_count": count,
        "local_devices": local,
        "global_devices": local * count,
    }

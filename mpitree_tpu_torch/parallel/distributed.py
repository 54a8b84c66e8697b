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
:func:`initialize` also takes the JAX package's names for the two bounds
(``jax.distributed.initialize``'s ``initialization_timeout`` for the join
and ``heartbeat_timeout_seconds`` for the collectives) and refuses any
other keyword with a ``TypeError``. The join is torch's own rendezvous
(``env://`` or ``tcp://``, so a ``torchrun`` agent's store is joined as a
client), bounded by the first.
"""

from __future__ import annotations

import datetime
import os

import torch


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, *,
               backend: str | None = None,
               timeout: float = 300.0, **timeouts) -> None:
    """Join the job's process group (idempotent).

    ``coordinator_address`` ``"host:port"`` (process 0 listens there),
    ``num_processes`` and ``process_id`` as ``jax.distributed.initialize``
    takes them. With no arguments, a launcher's environment
    (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, as
    ``torchrun`` sets it) is read; on a single process with neither this
    is a no-op. ``backend`` None is NCCL when CUDA is available, else
    gloo. ``timeout`` (seconds) bounds the join and every collective.
    ``timeouts`` are ``jax.distributed.initialize``'s names for the two
    bounds: ``heartbeat_timeout_seconds`` is ``timeout``, and
    ``initialization_timeout`` bounds the join alone; any other name
    raises ``TypeError``."""
    import torch.distributed as dist

    timeout = float(timeouts.pop("heartbeat_timeout_seconds", timeout))
    join = float(timeouts.pop("initialization_timeout", timeout))
    if timeouts:
        raise TypeError(
            f"initialize() got unexpected keyword argument(s) "
            f"{', '.join(map(repr, sorted(timeouts)))}: of jax.distributed."
            f"initialize's timeouts the port reads initialization_timeout "
            f"and heartbeat_timeout_seconds")
    if dist.is_initialized():
        return
    env = os.environ.get("MASTER_ADDR") and os.environ.get("MASTER_PORT")
    if coordinator_address is None and num_processes in (None, 1) \
            and not env:
        return  # one process, nothing to join
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if coordinator_address is None:
        url, rank, world = "env://", -1, -1
    else:
        url = f"tcp://{coordinator_address}"
        rank, world = int(process_id), int(num_processes)
    # what init_process_group(init_method=url) does, with the join bounded
    # by ``join`` and the store then by ``timeout``
    store, rank, world = next(dist.rendezvous(
        url, rank, world, timeout=datetime.timedelta(seconds=join)))
    store.set_timeout(datetime.timedelta(seconds=timeout))
    dist.init_process_group(
        backend, store=dist.PrefixStore("default_pg", store), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=timeout))


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

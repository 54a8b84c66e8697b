"""The 1-D data mesh: rows sharded over devices and processes.

Counterpart of the 1-D part of ``mpitree_tpu/parallel/mesh.py``. PyTorch
has no ``shard_map``; a :class:`Mesh` has two levels instead:

- **local shards**, a tuple of ``torch.device`` in this process: on the
  card ``cuda:i … cuda:i+n-1``; with ``device="cpu"`` ``n`` logical
  shards that all live on ``cpu`` (:func:`set_cpu_shards` sets how many
  there are, the counterpart of the JAX tests'
  ``--xla_force_host_platform_device_count``);
- an optional **process group** (``torch.distributed``, joined by
  ``parallel/distributed.initialize``, the counterpart of
  ``jax.distributed.initialize``): every process holds the same local
  shard count, and global shard ``g = rank * n_local + i``.

Rows pad to a multiple of the global shard count (:func:`pad_rows`) and
shard ``g`` holds padded rows ``[g * per, (g + 1) * per)``. Padding rows
carry ``node_id = -1`` and weight 0, so no histogram, count or range sees
them (:func:`pad_row_arrays`). The reductions over the mesh are in
``parallel/collective.py``. The tree and feature axes (forests' ``(tree,
data)`` mesh, the 2-D ``(data, feature)`` mesh) are ``ROADMAP.md`` item 14's
later parts; a ``(dr, df)`` request with ``df > 1`` raises.
"""

from __future__ import annotations

import numpy as np
import torch

DATA_AXIS = "data"
TREE_AXIS = "tree"
FEATURE_AXIS = "feature"

_cpu_shards = 1


def set_cpu_shards(n: int) -> int:
    """Set how many logical shards ``device="cpu"`` offers (default 1);
    returns the previous count. The CPU tests set 8, as the JAX tests
    force 8 virtual CPU devices."""
    global _cpu_shards
    n = int(n)
    if n < 1:
        raise ValueError(f"the CPU shard count must be >= 1, got {n}")
    prev, _cpu_shards = _cpu_shards, n
    return prev


def cpu_shards() -> int:
    """The logical shard count of ``device="cpu"`` (:func:`set_cpu_shards`)."""
    return _cpu_shards


def _process_group():
    """The default process group when ``torch.distributed`` is
    initialized, else None."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.group.WORLD
    return None


def local_devices(device: torch.device) -> list:
    """Every shard device this process offers for ``device``'s type: the
    CUDA cards from ``device``'s index on, or :func:`cpu_shards` logical
    shards on the CPU."""
    if device.type == "cpu":
        return [torch.device("cpu")] * cpu_shards()
    start = device.index if device.index is not None else \
        torch.cuda.current_device()
    return [torch.device("cuda", i)
            for i in range(start, torch.cuda.device_count())]


class Mesh:
    """A 1-D data mesh: local shard devices (``devices``, the first the
    lead, which holds the tree state) and an optional process group.
    ``stats`` counts the fit's reductions (``parallel/collective.psum``)
    and replication checks (``utils/profiling.assert_replicated``)."""

    def __init__(self, devices, group=None):
        import torch.distributed as dist

        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.group = group
        self.rank = dist.get_rank(group) if group is not None else 0
        self.n_procs = dist.get_world_size(group) if group is not None else 1
        self.stats = {"allreduce_calls": 0, "allreduce_bytes": 0,
                      "allreduce_seconds": 0.0, "replication_checks": 0}

    @property
    def lead(self) -> torch.device:
        return self.devices[0]

    @property
    def n_local(self) -> int:
        return len(self.devices)

    @property
    def size(self) -> int:
        """Global shard count: local shards times processes."""
        return self.n_local * self.n_procs

    @property
    def reduces(self) -> bool:
        """Whether a reduction does anything: several local shards or a
        process group (a group of one still runs its collectives)."""
        return self.n_local > 1 or self.group is not None

    def shard_index(self, i: int) -> int:
        """The global index of local shard ``i``."""
        return self.rank * self.n_local + i



def resolve_mesh(*, device=None, n_devices=None) -> Mesh:
    """The mesh for ``n_devices``, with the JAX package's grammar
    (``mpitree_tpu/parallel/mesh.py:100-134``): None or 1 -> one shard of
    this process (no process group); ``"all"`` or -1 -> every visible
    device of this process, times the process count; an int -> that many
    shards (more than the visible devices raise ``ValueError``; across
    processes it must divide evenly among them); a ``(dr, 1)`` tuple ->
    ``dr`` shards; ``(dr, df)`` with ``df > 1`` -> ``NotImplementedError``
    (the 2-D mesh, ``ROADMAP.md`` item 14d). ``device`` is the shards'
    type and first card (``_device.resolve_device``: CUDA unless
    ``"cpu"``, raising without CUDA)."""
    from mpitree_tpu_torch._device import resolve_device

    if isinstance(n_devices, tuple):
        dr, df = (int(v) for v in n_devices)
        if df != 1:
            raise NotImplementedError(
                f"n_devices={n_devices!r}: the 2-D (data, feature) mesh is "
                "not ported yet (ROADMAP.md Queue 1 item 14d)")
        n_devices = dr
    dev = resolve_device(device)
    local = local_devices(dev)
    if n_devices in (None, 1):
        return Mesh(local[:1])
    import torch.distributed as dist

    group = _process_group()
    n_procs = 1 if group is None else dist.get_world_size(group)
    if group is not None and dev.type == "cpu":
        if dist.get_backend(group) != "gloo":
            raise ValueError(
                f"CPU shards need a gloo process group; this one is "
                f"{dist.get_backend(group)!r} (initialize with "
                "backend='gloo')")
    if n_devices in ("all", -1):
        return Mesh(local, group)
    n = int(n_devices)
    if n < 1 or n > len(local) * n_procs:
        raise ValueError(
            f"n_devices={n} requested but only {len(local) * n_procs} "
            f"devices are visible for device={str(dev)!r}")
    if n % n_procs:
        raise ValueError(
            f"n_devices={n} does not divide over {n_procs} processes")
    return Mesh(local[:n // n_procs], group)


def data_shards(mesh: Mesh) -> int:
    """Width of the mesh's data axis: every shard of every process."""
    return mesh.size


def feature_shards(mesh: Mesh) -> int:
    """Width of the mesh's feature axis: always 1 on the 1-D data mesh."""
    return 1


def pad_rows(n: int, n_devices: int) -> int:
    """Rows of padding needed so ``n`` divides evenly across devices."""
    return (-n) % n_devices


def pad_row_arrays(xb, y, w, nid, n_shards: int):
    """Pad ``(xb, y, w, nid)`` so rows divide ``n_shards`` evenly, as
    ``mpitree_tpu/parallel/mesh.py:265-291``: padding rows carry bins 0,
    target 0, weight 0 and ``node_id = -1``. ``w`` may be (N,) or a
    stacked (T, N) per-tree weight matrix; ``xb=None`` pads only the row
    state. ``xb`` may be a numpy array or a tensor (padded on its
    device)."""
    pad = pad_rows(len(y), n_shards)
    if not pad:
        return xb, y, w, nid
    if xb is not None:
        if isinstance(xb, torch.Tensor):
            xb = torch.cat([xb, xb.new_zeros((pad, xb.shape[1]))])
        else:
            xb = np.concatenate([xb, np.zeros((pad, xb.shape[1]),
                                              xb.dtype)])
    y = np.concatenate([y, np.zeros(pad, y.dtype)])
    if w.ndim == 1:
        w = np.concatenate([w, np.zeros(pad, np.float32)])
    else:
        w = np.concatenate([w, np.zeros((w.shape[0], pad), np.float32)],
                           axis=1)
    nid = np.concatenate([nid, np.full(pad, -1, np.int32)])
    return xb, y, w, nid


def shard_build_inputs(mesh: Mesh, x_binned: torch.Tensor, y: np.ndarray,
                       sample_weight) -> list:
    """This process's shards of a build: the rows padded to the mesh
    (:func:`pad_row_arrays`), then per local shard a dict of ``x_binned``
    (rows on the shard's device), ``y``, ``weight`` (float32, 0 on
    padding) and ``node_id`` (int32, -1 on padding), placed by the
    partition table (``parallel/partition.place``). ``x_binned`` is the
    whole (N, F) matrix, ``y`` and ``sample_weight`` (None = 1) every
    row's, as every process holds them."""
    from mpitree_tpu_torch.parallel import partition

    n = int(x_binned.shape[0])
    w = (np.ones(n, np.float32) if sample_weight is None
         else np.asarray(sample_weight, np.float32))
    xb, y, w, nid = pad_row_arrays(x_binned, np.asarray(y), w,
                                   np.zeros(n, np.int32), mesh.size)
    return partition.place(mesh, {"x_binned": xb, "y": y, "weight": w,
                                  "node_id": nid})

"""Device meshes: rows, trees and features sharded over devices and
processes.

Counterpart of ``mpitree_tpu/parallel/mesh.py``. PyTorch has no
``shard_map``; a :class:`Mesh` has two levels instead:

- **local shards**, a tuple of ``torch.device`` in this process: on the
  card ``cuda:i … cuda:i+n-1``; with ``device="cpu"`` ``n`` logical
  shards that all live on ``cpu`` (:func:`set_cpu_shards` sets how many
  there are, the counterpart of the JAX tests'
  ``--xla_force_host_platform_device_count``);
- an optional **process group** (``torch.distributed``, joined by
  ``parallel/distributed.initialize``, the counterpart of
  ``jax.distributed.initialize``): every process holds the same local
  shard count, and global shard ``g = rank * n_local + i``.

The global shards lie row-major on the mesh's ``shape``, one axis name
per dimension, as JAX reshapes its device array: the 1-D ``(data,)``
mesh of a tree fit, the forests' ``(tree, data)`` mesh
(:func:`as_tree_data_mesh`, shape from :func:`tree_data_shape`) and the
2-D ``(data, feature)`` mesh of a feature-sharded fit
(:func:`resolve_mesh` with ``(dr, df)``, or :func:`resolve_mesh_2d`'s
policy). A reduction along one axis runs on that axis's sub-mesh
(:meth:`Mesh.axis_mesh`): the local shards of the same axis group, and
the process subgroup that holds that group's other shards, made with
``dist.new_group`` once per mesh by every process in the same order. A
group lies inside one process or spans whole processes' shards of it:
the inner axis's width divides the local shard count or is a multiple
of it (else :class:`Mesh` raises).

Rows pad to a multiple of the data axis (:func:`pad_rows`) and data
index ``d`` holds padded rows ``[d * per, (d + 1) * per)``. Padding rows
carry ``node_id = -1`` and weight 0, so no histogram, count or range sees
them (:func:`pad_row_arrays`); padding features of a feature axis have no
candidate bin, so no split lands there. The reductions over the mesh are
in ``parallel/collective.py``.
"""

from __future__ import annotations

import os

import numpy as np
import torch

DATA_AXIS = "data"
TREE_AXIS = "tree"
FEATURE_AXIS = "feature"
FOREST_HBM_BUDGET_ENV = "MPITREE_TPU_FOREST_HBM_BUDGET"

_cpu_shards = 1
_subgroups: dict = {}


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


def _subgroup(ranks: tuple):
    """The process group of the world ranks ``ranks`` (sorted): None for
    one process, the world for all of them, else a ``dist.new_group``
    made once per rank set. Every process must call this for every rank
    set in the same order, members or not (``new_group``'s contract)."""
    import torch.distributed as dist

    if len(ranks) == 1:
        return None
    if len(ranks) == dist.get_world_size():
        return dist.group.WORLD
    if ranks not in _subgroups:
        _subgroups[ranks] = dist.new_group(list(ranks))
    return _subgroups[ranks]


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


def new_stats() -> dict:
    """A mesh's counters: every reduction (``allreduce_*``), the feature
    axis's winner gathers (``gather_*``, ``collective.select_global``) and
    row-route sums (``route_*``, ``collective.route_psum``), the streamed
    matrix's rows a forest's tree groups receive from other processes
    (``exchange_*``, ``ingest/place.regroup_matrix``), the forests' tree
    exchange (``tree_exchange_*``) and the replication checks."""
    st = {"replication_checks": 0}
    for kind in ("allreduce", "gather", "route", "exchange",
                 "tree_exchange"):
        st.update({f"{kind}_calls": 0, f"{kind}_bytes": 0,
                   f"{kind}_seconds": 0.0})
    return st


class Mesh:
    """Local shard devices (``devices``, the first the lead, which holds
    the tree state) and an optional process group, laid out row-major on
    ``shape`` with one name per axis in ``axis_names`` (default the 1-D
    data mesh). ``stats`` counts the fit's collectives
    (``parallel/collective``) and replication checks
    (``utils/profiling.assert_replicated``); the sub-meshes of
    :meth:`axis_mesh` share it.

    ``index`` (a sub-mesh's) gives each local shard's position on the
    mesh instead of ``rank * n_local + i``."""

    def __init__(self, devices, group=None, *, shape=None,
                 axis_names=(DATA_AXIS,), index=None, stats=None):
        import torch.distributed as dist

        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.group = group
        self.rank = dist.get_rank(group) if group is not None else 0
        self.n_procs = dist.get_world_size(group) if group is not None else 1
        self.shape = (self.size,) if shape is None else tuple(
            int(s) for s in shape)
        self.axis_names = tuple(axis_names)
        if (len(self.shape) != len(self.axis_names)
                or int(np.prod(self.shape)) != self.size):
            raise ValueError(f"mesh shape {self.shape} over "
                             f"{self.axis_names} for {self.size} shards")
        self._index = (list(index) if index is not None else
                       [self.rank * self.n_local + i
                        for i in range(self.n_local)])
        self.stats = new_stats() if stats is None else stats
        # the local shards' indices on the parent mesh (a sub-mesh's)
        self.local = list(range(self.n_local))
        self._axis_groups = {}
        if len(self.shape) > 1:
            self._make_axis_groups()

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
        return self._index[i]

    def axis_size(self, axis: str) -> int:
        """Width of axis ``axis`` (1 where the mesh lacks it)."""
        if axis not in self.axis_names:
            return 1
        return self.shape[self.axis_names.index(axis)]

    def coords(self, i: int) -> tuple:
        """Local shard ``i``'s coordinates on the mesh's axes."""
        return tuple(int(c) for c in np.unravel_index(self.shard_index(i),
                                                      self.shape))

    def _groups_of(self, a: int) -> list:
        """Every group of axis ``a``: per combination of the other axes'
        coordinates (in order), the global shards along ``a``."""
        grid = np.arange(self.size).reshape(self.shape)
        lines = np.moveaxis(grid, a, -1).reshape(-1, self.shape[a])
        return [tuple(int(g) for g in line) for line in lines]

    def _make_axis_groups(self) -> None:
        """Each axis's groups' process subgroups, made by every process in
        the same order; checks that each group lies inside one process or
        spans whole processes' shards of it alike."""
        n = self.n_local
        for a, name in enumerate(self.axis_names):
            for line in self._groups_of(a):
                procs = sorted({g // n for g in line})
                per = [sum(1 for g in line if g // n == p) for p in procs]
                if len(set(per)) != 1:
                    raise ValueError(
                        f"mesh shape {self.shape} ({self.axis_names}) does "
                        f"not align with {n} shards per process: a "
                        f"{name!r} group holds {per} shards of its "
                        "processes")
                group = (None if self.group is None
                         else _subgroup(tuple(procs)))
                for g in line:
                    self._axis_groups[(name, g)] = (line, group)

    def axis_mesh(self, axis: str, i: int = 0) -> "Mesh":
        """The 1-D sub-mesh along ``axis`` through local shard ``i``: the
        local shards of its group, their positions along ``axis``, and
        the subgroup of the processes that hold the group (None for one
        process). A 1-D mesh's only axis is the mesh itself."""
        if len(self.shape) == 1:
            if axis not in self.axis_names:
                raise ValueError(f"no {axis!r} axis on {self.axis_names}")
            return self
        a = self.axis_names.index(axis)
        line, group = self._axis_groups[(axis, self.shard_index(i))]
        mine = [j for j in range(self.n_local)
                if self.shard_index(j) in line]
        sub = Mesh([self.devices[j] for j in mine], group,
                   axis_names=(axis,),
                   index=[self.coords(j)[a] for j in mine],
                   stats=self.stats)
        want = [sub.rank * sub.n_local + k for k in range(sub.n_local)]
        if sub._index != want or sub.size != self.shape[a]:
            raise ValueError(f"mesh shape {self.shape} does not align "
                             f"with {self.n_local} shards per process")
        sub.local = mine
        return sub

    def axis_groups(self, axis: str) -> list:
        """This process's sub-meshes along ``axis``, one per local group,
        in the order of their first local shard."""
        out, seen = [], set()
        for i in range(self.n_local):
            if i not in seen:
                sub = self.axis_mesh(axis, i)
                seen.update(sub.local)
                out.append(sub)
        return out


def _shaped(mesh: Mesh, shape: tuple, axes: tuple) -> Mesh:
    return Mesh(mesh.devices, mesh.group, shape=shape, axis_names=axes,
                stats=mesh.stats)


def as_tree_mesh(mesh: Mesh) -> Mesh:
    """Same shards on a 1-D ``tree`` axis (ensemble parallelism)."""
    return _shaped(mesh, (mesh.size,), (TREE_AXIS,))


def as_tree_data_mesh(mesh: Mesh, shape: tuple) -> Mesh:
    """Same shards on a 2-D ``(tree, data)`` mesh of ``shape``: global
    shard ``g`` is tree group ``g // shape[1]``, data index
    ``g % shape[1]`` (JAX's row-major reshape)."""
    return _shaped(mesh, tuple(shape), (TREE_AXIS, DATA_AXIS))


def slab_bytes(n_slots: int, n_features: int, n_channels: int,
               n_bins: int, *, itemsize: int = 4) -> int:
    """One resident (S, F, C, B) histogram slab in bytes
    (``mpitree_tpu/obs/memory.py:116-122``): the feature policy's unit."""
    return (int(n_slots) * int(n_features) * int(n_channels)
            * int(n_bins) * int(itemsize))


def feature_shards_for_budget(hist_bytes: int, hist_budget,
                              usable: list) -> int:
    """The 2-D policy's feature-shard count
    (``mpitree_tpu/obs/memory.py:322-334``): the narrowest usable divisor
    whose slab ``hist_bytes / f`` fits ``hist_budget``, else the widest
    (it degrades, never refuses)."""
    f = 1
    if hist_budget:
        while f < max(usable) and int(hist_bytes) > int(hist_budget) * f:
            f = min(k for k in usable if k > f)
    return f


def tree_shards_for_budget(tree_shards: int, dataset_bytes: int,
                           hbm_budget, divisors: list,
                           n_devices: int) -> int:
    """The forest policy's memory guard
    (``mpitree_tpu/obs/memory.py:337-350``): trade tree-axis width for row
    sharding while one device's share of the binned matrix exceeds the
    budget."""
    t = int(tree_shards)
    if hbm_budget:
        while t > 1 and int(dataset_bytes) > int(hbm_budget) * (
                int(n_devices) // t):
            t = max(k for k in divisors if k < t)
    return t


def tree_data_shape(n_devices: int, n_trees: int, *, dataset_bytes: int = 0,
                    hbm_budget: int | None = None) -> tuple:
    """``(tree_shards, data_shards)`` for a forest, JAX's policy
    (``mpitree_tpu/parallel/mesh.py:56-81``): the tree axis is the widest
    divisor of ``n_devices`` the ensemble can fill (``<= n_trees``), the
    rest a data axis that row-shards each tree group's builds; then the
    guard (:func:`tree_shards_for_budget`) trades tree width for rows
    while ``dataset_bytes`` exceeds ``hbm_budget`` per device."""
    d = max(int(n_devices), 1)
    divisors = [k for k in range(1, d + 1) if d % k == 0]
    t = max(k for k in divisors if k <= max(int(n_trees), 1))
    t = tree_shards_for_budget(t, dataset_bytes, hbm_budget, divisors, d)
    return t, d // t


def forest_hbm_budget(device: torch.device) -> int:
    """The per-device budget (bytes) for a forest's binned matrix:
    ``MPITREE_TPU_FOREST_HBM_BUDGET`` (``config/knobs.py``) when set,
    else half the device's memory: half the card's ``total_memory``, or
    half the host's on the CPU. The JAX package's default, 8 GiB, is half
    of a TPU v5e chip's 16 GiB HBM; the same rule here."""
    from mpitree_tpu_torch.config import knobs

    v = knobs.value(FOREST_HBM_BUDGET_ENV)
    if v is not None:
        return int(v)
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).total_memory // 2
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES") // 2


def data_feature_shape(n_devices: int, n_features: int, *,
                       hist_bytes: int = 0,
                       hist_budget: int | None = None) -> tuple:
    """``(data_shards, feature_shards)`` for a single-tree fit, JAX's
    policy (``mpitree_tpu/parallel/mesh.py:137-167``): the data axis is
    as wide as it can be, and the feature axis takes the narrowest
    divisor (at most ``n_features``) whose per-shard slab
    ``hist_bytes / df`` fits ``hist_budget``."""
    d = max(int(n_devices), 1)
    divisors = [k for k in range(1, d + 1) if d % k == 0]
    usable = [k for k in divisors if k <= max(int(n_features), 1)]
    f = feature_shards_for_budget(hist_bytes, hist_budget, usable)
    return d // f, f


def resolve_mesh_2d(*, n_features: int, hist_bytes: int = 0,
                    hist_budget: int | None = None, device=None,
                    n_devices=None, chunk_slots: int | None = None,
                    n_classes: int | None = None,
                    n_bins: int | None = None) -> Mesh:
    """The ``(data, feature)`` mesh with :func:`data_feature_shape`'s
    split of ``n_devices`` (:func:`resolve_mesh`'s grammar for a total;
    an explicit ``(dr, df)`` bypasses the policy). ``chunk_slots``,
    ``n_classes`` and ``n_bins`` price ``hist_bytes`` by
    :func:`slab_bytes` when it is not given. JAX's resolver first asks
    its advisor for stored A/B evidence (``:206-226``, ``ROADMAP.md``
    item 18); with none stored it returns None there and the policy split
    stands, which is what this does."""
    if isinstance(n_devices, (tuple, list)):
        return resolve_mesh(device=device, n_devices=n_devices)
    if not hist_bytes and chunk_slots and n_bins:
        hist_bytes = slab_bytes(chunk_slots, n_features, n_classes or 2,
                                n_bins)
    n = resolve_mesh(device=device, n_devices=n_devices).size
    shape = data_feature_shape(n, n_features, hist_bytes=hist_bytes,
                               hist_budget=hist_budget)
    return resolve_mesh(device=device, n_devices=shape)


def resolve_mesh(*, device=None, n_devices=None) -> Mesh:
    """The mesh for ``n_devices``, with the JAX package's grammar
    (``mpitree_tpu/parallel/mesh.py:100-134``): None or 1 -> one shard of
    this process (no process group); ``"all"`` or -1 -> every visible
    device of this process, times the process count; an int -> that many
    shards (more than the visible devices raise ``ValueError``; across
    processes it must divide evenly among them); a ``(dr, 1)`` tuple ->
    ``dr`` shards; ``(dr, df)`` -> the 2-D ``(data, feature)`` mesh of
    ``dr * df`` shards. ``device`` is the shards' type and first card
    (``_device.resolve_device``: CUDA unless ``"cpu"``, raising without
    CUDA)."""
    from mpitree_tpu_torch._device import resolve_device

    shape = None
    if isinstance(n_devices, (tuple, list)):  # a model file's JSON list
        dr, df = (int(v) for v in n_devices)
        if dr < 1 or df < 1:
            raise ValueError(f"mesh shape n_devices={n_devices!r} needs "
                             "positive axes")
        n_devices = dr * df
        if df > 1:
            shape = (dr, df)
    dev = resolve_device(device)
    local = local_devices(dev)
    if n_devices in (None, 1) and shape is None:
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
    if shape is not None:
        return Mesh(local[:n // n_procs], group, shape=shape,
                    axis_names=(DATA_AXIS, FEATURE_AXIS))
    return Mesh(local[:n // n_procs], group)


def data_shards(mesh: Mesh) -> int:
    """Width of the mesh's data axis."""
    return mesh.axis_size(DATA_AXIS)


def feature_shards(mesh: Mesh) -> int:
    """Width of the mesh's feature axis (1 on a 1-D data mesh)."""
    return mesh.axis_size(FEATURE_AXIS)


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


def pad_features(xb, cand: np.ndarray, n_shards: int) -> tuple:
    """Pad the binned matrix's columns and the (F, B) candidate mask to a
    multiple of the feature axis (``mpitree_tpu/parallel/mesh.py:332-339``):
    padding columns hold bin 0 and no candidate, so they are inert.
    ``xb=None`` pads only the mask."""
    fpad = (-cand.shape[0]) % n_shards
    if not fpad:
        return xb, cand
    if xb is None:
        pass
    elif isinstance(xb, torch.Tensor):
        xb = torch.cat([xb, xb.new_zeros((xb.shape[0], fpad))], dim=1)
    else:
        xb = np.concatenate([xb, np.zeros((len(xb), fpad), xb.dtype)],
                            axis=1)
    return xb, np.concatenate([cand, np.zeros((fpad, cand.shape[1]), bool)])


def check_placed(binned, mesh: Mesh) -> None:
    """Hold a ``StreamedBinnedData``'s shards to ``mesh``
    (``mpitree_tpu/parallel/mesh.py:327-336``): its padded extents must be
    the ones this mesh pads its real extents to, with one shard per local
    device of the mesh's block shape, on that device."""
    N, F = binned.n_samples, binned.n_features
    dr, df = data_shards(mesh), feature_shards(mesh)
    want = (N + pad_rows(N, dr), F + (-F) % df)
    have = (binned.rows_pad, binned.feat_pad)
    block = (want[0] // dr, want[1] // df)
    if have != want or len(binned.x_binned) != mesh.n_local or any(
            tuple(x.shape) != block or x.device != torch.device(d)
            for x, d in zip(binned.x_binned, mesh.devices)):
        raise ValueError(
            f"pre-placed x_binned has shape {have}; this mesh pads "
            f"({N}, {F}) to {want} — the ingest assembly and the build "
            "must use the same mesh"
        )


def shard_build_inputs(mesh: Mesh, x_binned, y: np.ndarray, sample_weight,
                       cand_mask=None) -> list:
    """This process's shards of a build: the rows padded to the data axis
    (:func:`pad_row_arrays`; on a feature axis the columns and
    ``cand_mask`` too, :func:`pad_features`), then per local shard a
    dict of ``x_binned`` (its rows, and its feature slab, on the shard's
    device), ``y``, ``weight`` (float32, 0 on padding), ``node_id``
    (int32, -1 on padding) and, when given, ``cand_mask`` (its slab),
    placed by the partition table (``parallel/partition.place``).
    ``x_binned`` is the whole (N, F) matrix (None: the row state only),
    ``y`` and ``sample_weight`` (None = 1) every row's, as every process
    holds them."""
    from mpitree_tpu_torch.parallel import partition

    n = len(y)
    w = (np.ones(n, np.float32) if sample_weight is None
         else np.asarray(sample_weight, np.float32))
    xb, y, w, nid = pad_row_arrays(x_binned, np.asarray(y), w,
                                   np.zeros(n, np.int32), data_shards(mesh))
    state = {"y": y, "weight": w, "node_id": nid}
    if xb is not None:
        state["x_binned"] = xb
    if cand_mask is not None:
        xb, state["cand_mask"] = pad_features(
            xb, np.asarray(cand_mask, bool), feature_shards(mesh))
        if xb is not None:
            state["x_binned"] = xb
    return partition.place(mesh, state)

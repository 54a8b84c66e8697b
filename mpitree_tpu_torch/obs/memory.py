"""obs.memory — the card's memory ledger and preflight capacity planner.

Counterpart of ``mpitree_tpu/obs/memory.py``, with its surface
(:class:`MemoryPlan`, :class:`MemoryPlanError`, :func:`plan_fit`,
:func:`plan_forest`, :func:`plan_serve`, :func:`plan_ingest`,
:func:`aggregate_plans`, :func:`shrink_knob`, :func:`preflight`,
:class:`MemWatch`, :func:`drift_check`) and its record schema
(``record.memory``, :data:`MEMORY_SCHEMA`). It prices the port's own
buffers, the ones its engines allocate, under the JAX package's array
names wherever the port holds the same quantity (``x_binned``,
``split_hist_chunk``, ``parent_hist``, ``pool_hist``, ...), so that
:func:`shrink_knob` and the OOM rescue (``resilience/recovery.OomRescue``)
read the same names. Three layers ride the one pricing source:

- **the analytical ledger** (:func:`plan_fit` and its twins): per-array
  bytes per device with per-phase watermarks, recorded under
  ``record.memory`` by every engine before its first launch;
- **live watermarks** (:class:`MemWatch`, ``MPITREE_TPU_MEM_SAMPLE=1``):
  on the card the caching allocator's bytes and its peak since the last
  sample, read at span closes (source :data:`ALLOCATOR_SOURCE`); on the
  CPU the bytes of the live tensors on the device (source
  :data:`LIVE_TENSORS_SOURCE`); the observer checks the ledger against
  them (:func:`drift_check`, typed ``mem_estimate_drift``);
- **the preflight** (:func:`preflight`, :meth:`MemoryPlan.check`): a fit
  whose predicted peak exceeds the card's budget
  (``MPITREE_TPU_HBM_BYTES``, else the capacity ``torch.cuda`` reports)
  refuses before any launch, with a typed ``oom_predicted`` event naming
  the binding array.

This module is the port's one copy of every pricing formula: the chunk
width (``core/builder._chunk_size`` reads :func:`chunk_bytes_per_slot`
and :func:`widest_frontier`), the fused rounds' leaf-pool guard
(:func:`pool_capacity`, :func:`pool_hist_bytes`), the mesh shape policy
(:func:`feature_shards_for_budget`, :func:`tree_shards_for_budget`,
:func:`slab_bytes`) and the serving tiles' shared memory
(:func:`serve_smem_bytes`, :func:`margin_smem_bytes`);
``tests/test_torch_memory.py`` pins each decision. It also keeps the streaming ingest's host arithmetic
(:func:`ingest_chunk_rows` and its budget), with the JAX formulas.

Import cost: stdlib and the knob registry at module level; torch and the
partition table load lazily, when a budget or live bytes are read.
"""

from __future__ import annotations

import dataclasses
import math
import os

from mpitree_tpu_torch.config import knobs

# record.memory's own sub-schema version, the JAX package's
MEMORY_SCHEMA = 1

HBM_BUDGET_ENV = "MPITREE_TPU_HBM_BYTES"       # per-device preflight budget
MEM_SAMPLE_ENV = "MPITREE_TPU_MEM_SAMPLE"      # "1" = span-close sampling
DRIFT_TOL_ENV = "MPITREE_TPU_MEM_DRIFT_TOL"    # drift-event threshold (x)
HOST_BUDGET_ENV = "MPITREE_TPU_HOST_BYTES"
HOST_INGEST_BUDGET_DEFAULT = 1 << 30

# The analytical peak prices transient working sets that span-close
# samples of resident bytes cannot see; a drift event fires when the two
# diverge by more than this factor (an underestimate always counts).
DRIFT_TOL_DEFAULT = 8.0

# Live-byte sources. The allocator's is exact (its peak sees every
# transient); the live-tensor sum sees only tensors Python holds at a
# span close, so an overestimate against it is expected, not drift.
ALLOCATOR_SOURCE = "cuda_allocator"
LIVE_TENSORS_SOURCE = "live_tensors"
EXACT_SOURCES = (ALLOCATOR_SOURCE,)

RESIDENT = "resident"
# Phases the fit ledger prices on top of the resident set: the observer's
# span names ("bin" is the device binning's transient, which the JAX
# package prices on the host; "counts" the terminal sums).
FIT_PHASES = ("bin", "shard", "split", "counts", "update", "leafwise",
              "fused_rounds")

# Bytes per (row, feature) cell of the device binning's working set
# (ops/binning.bin_dataset_torch): the transposed float32 rows, their
# sort (values, int64 indices and the sort's scratch of both), the
# searchsorted int64 bin ids and their int32 transpose.
BIN_CELL_BYTES = 40
# Bytes per row of one level's row order on the sorted histogram route
# (ops/hist_kernel.slot_segments: the int32 slot keys and the int64
# order) and of the reroute's new node ids.
ROW_ORDER_BYTES = 4 + 8 + 4
# Byte-wide bins are padded to this many features (ops/hist_kernel).
LANE_FEATURES = 16
# (K, F, B) float64 buffers the split sweep holds at its peak
# (ops/impurity.cost_sweep_f64, inside its class loop): the side weights
# and their clamped divisors (4), the two accumulators (2), one class's
# left and right cumsums and fractions (4) and the entropy term's
# transients; 18 in all is what the caching allocator showed at the peak
# of phase 3's and phase 5's builds on an H100 (chip_smoke.py phase 33
# (a)). The chunk width is sized from the leaner chunk_bytes_per_slot
# (8 of them); the ledger prices what is allocated.
SWEEP_F64_LIVE = 18
# The caching allocator keeps a large block's tail (under 1 MiB) with the
# block rather than splitting it off; a served model's arrays are a few
# MiB each, where that shows (plan_serve prices it).
ALLOC_TAIL = 1 << 20


def _round_up(x: int, m: int) -> int:
    return -(-int(x) // int(m)) * int(m)


# ---------------------------------------------------------------------------
# pricing formulas: the one copy each consumer reads
# ---------------------------------------------------------------------------

def chunk_bytes_per_slot(n_feat: int, n_bins: int, n_chan: int,
                         cell_bytes: int = 4) -> int:
    """Live device bytes per frontier slot: the (F, C, B) histogram
    (float32 cells, or the fixed-point route's 8-byte int64 ones) plus ~8
    (F, B) float64 accumulators of the f64 cost sweep. ``core/builder``
    sizes the frontier chunk from exactly this number."""
    return int(n_feat) * int(n_bins) * (int(n_chan) * int(cell_bytes)
                                        + 8 * 8)


def widest_frontier(n_samples: int, max_depth) -> int:
    """The widest frontier a build can reach: ``2**max_depth`` when the
    depth is capped (below 31), else the row count."""
    widest = int(n_samples)
    if max_depth is not None and int(max_depth) < 31:
        widest = min(widest, 2 ** int(max_depth))
    return max(widest, 1)


def default_chunk_slots(n_samples: int, n_feat: int, n_bins: int,
                        n_chan: int, *, hist_budget_bytes: int,
                        max_frontier_chunk: int, max_depth,
                        cell_bytes: int = 4) -> int:
    """Frontier-chunk slot count K, a power of two: bounded by the
    histogram budget over :func:`chunk_bytes_per_slot`, the widest
    frontier and ``max_frontier_chunk`` (``core/builder._chunk_size``)."""
    per_node = chunk_bytes_per_slot(n_feat, n_bins, n_chan, cell_bytes)
    cap = max(1, int(hist_budget_bytes) // max(per_node, 1))
    cap = min(cap, int(max_frontier_chunk))
    widest = widest_frontier(n_samples, max_depth)
    want = 1 << max(0, math.ceil(math.log2(max(widest, 1))))
    return min(want, 1 << int(math.log2(cap)))


def default_table_slots(n_samples: int, max_depth,
                        max_table_slots: int) -> int:
    """Per-level table width of the reroute and the terminal counts."""
    widest = min(widest_frontier(n_samples, max_depth), int(max_table_slots))
    return 1 << max(0, math.ceil(math.log2(widest)))


def split_bytes_per_slot(n_feat: int, n_bins: int, n_chan: int,
                         cell_bytes: int = 4) -> int:
    """What one frontier slot of a split chunk holds on the card at the
    sweep's peak: its (F, C, B) histogram, the (F, B) float32 class sum
    and :data:`SWEEP_F64_LIVE` (F, B) float64 sweep buffers."""
    return int(n_feat) * int(n_bins) * (
        int(n_chan) * int(cell_bytes) + 4 + SWEEP_F64_LIVE * 8)


def slab_bytes(n_slots: int, n_features: int, n_channels: int,
               n_bins: int, *, itemsize: int = 4) -> int:
    """One resident (S, F, C, B) histogram slab: the subtraction carry's
    per-chunk buffer and the 2-D mesh policy's per-shard unit."""
    return (int(n_slots) * int(n_features) * int(n_channels)
            * int(n_bins) * int(itemsize))


def pool_capacity(max_leaf_nodes: int, max_depth, n_samples: int) -> int:
    """Open-leaf pool width ``P`` of best-first growth: the budget, cut
    to ``2**d`` leaves of a depth-``d`` tree and to ``N`` non-empty ones;
    the node capacity is ``2P - 1``."""
    p = int(max_leaf_nodes)
    if max_depth is not None and int(max_depth) < 31:
        p = min(p, 2 ** max(int(max_depth), 0))
    return max(min(p, max(int(n_samples), 1)), 1)


def pool_hist_bytes(pool_slots: int, n_features: int, n_bins: int) -> int:
    """The fused-rounds leaf pool's (P, F, 3, B) float32 histograms, the
    JAX package's pricing, which the pool guard of
    ``boosting/fused_rounds.resolve_rounds_per_dispatch`` reads."""
    return int(pool_slots) * max(int(n_features), 1) * 3 * max(
        int(n_bins), 1) * 4


def feature_shards_for_budget(hist_bytes: int, hist_budget,
                              usable: list) -> int:
    """The 2-D mesh policy's feature-shard count: the narrowest usable
    divisor whose slab ``hist_bytes / f`` fits ``hist_budget``, else the
    widest (it degrades, never refuses)."""
    f = 1
    if hist_budget:
        while f < max(usable) and int(hist_bytes) > int(hist_budget) * f:
            f = min(k for k in usable if k > f)
    return f


def tree_shards_for_budget(tree_shards: int, dataset_bytes: int,
                           hbm_budget, divisors: list,
                           n_devices: int) -> int:
    """The forest mesh policy's memory guard: trade tree-axis width for
    row sharding while one device's share of the binned matrix exceeds
    the budget."""
    t = int(tree_shards)
    if hbm_budget:
        while t > 1 and int(dataset_bytes) > int(hbm_budget) * (
                int(n_devices) // t):
            t = max(k for k in divisors if k < t)
    return t


def serve_smem_bytes(rows: int, chunk: int, n_out: int, n_features: int,
                     acc_bytes: int, norm: bool, stage_x: bool) -> int:
    """Dynamic shared memory of one traversal block
    (``serving/serve_kernel.plan``; ``smem_bytes`` in ``csrc/traverse.cu``
    computes the same sum, each array rounded up to 16 bytes):
    accumulators, norm's per-pair divisors, leaf ids, X rows."""
    def a16(b):
        return -(-b // 16) * 16
    return (a16(rows * n_out * acc_bytes) + (a16(rows * chunk * 8) if norm
                                             else 0)
            + a16(rows * chunk * 4)
            + (a16(rows * n_features * 4) if stage_x else 0))


def margin_smem_bytes(rows: int, trees_per_pass: int, table_bytes: int,
                      x_stride: int, acc_bytes: int, stage_x: bool) -> int:
    """Dynamic shared memory of one block of the boosted-margin body
    (``serving/serve_kernel.plan_margin``; ``smem_bytes`` in
    ``csrc/margin.cu`` computes the same sum, each region rounded up to 16
    bytes): a staged chunk of the margin pack, then K4's float64 terms of
    one pass (``rows x trees_per_pass``) or K5's int32 row sums, then the
    X rows at ``x_stride`` floats a row."""
    def a16(b):
        return -(-b // 16) * 16
    terms = rows * trees_per_pass * 8 if acc_bytes == 8 else rows * 4
    return (a16(table_bytes) + a16(terms)
            + (a16(rows * x_stride * 4) if stage_x else 0))


def table_bytes(n_slots: int, n_channels: int) -> int:
    """The per-level reroute tables (a U-wide bool split mask, the int64
    feature and three int32 columns) and the (U, C) int64 terminal sums."""
    u = int(n_slots)
    return u * (1 + 8 + 3 * 4) + u * max(int(n_channels), 1) * 8


# Chunk-scaled array -> the BuildConfig/boosting knob that shrinks it:
# what the OOM rescue (resilience/recovery.OomRescue) reads to pick a
# priced shrink on the card. Resident arrays have no shrink knob.
_SHRINK_KNOBS = {
    # the K-slot split working set halves with the frontier chunk
    "split_hist_chunk": "max_frontier_chunk",
    # the kept parent histograms go when subtraction degrades to direct
    "parent_hist": "hist_subtraction",
}

# Arrays alive only inside a fused multi-round dispatch: the knob is the
# dispatch width, and rounds_per_dispatch=1 hands the remaining rounds to
# the host round loop.
_FUSED_ROUNDS_KNOBS = {
    "pool_hist": "rounds_per_dispatch",
    "pool_nodes": "rounds_per_dispatch",
    "pool_scalars": "rounds_per_dispatch",
    "pair_hist": "rounds_per_dispatch",
    "margin_carry": "rounds_per_dispatch",
    "grad_hess": "rounds_per_dispatch",
}


def shrink_knob(array_name: str, *, engine=None) -> str | None:
    """The knob that shrinks ``array_name``, or None (not chunk-scaled).
    ``engine``: the plan's engine; the pool maps to
    ``rounds_per_dispatch`` only in the fused rounds, and to the
    subtraction carry in a single best-first build."""
    k = _SHRINK_KNOBS.get(array_name)
    if k is not None:
        return k
    if engine == "fused_rounds":
        return _FUSED_ROUNDS_KNOBS.get(array_name)
    if array_name == "pool_hist":
        return "hist_subtraction"
    return None


# ---------------------------------------------------------------------------
# the streaming ingest's host arithmetic
# ---------------------------------------------------------------------------

def host_ingest_budget() -> int:
    """The host-RAM budget streamed chunk sizing derives from
    (``MPITREE_TPU_HOST_BYTES``, default 1 GiB, at least 1 MiB)."""
    env = knobs.raw(HOST_BUDGET_ENV)
    if env:
        try:
            return max(int(env), 1 << 20)
        except ValueError:
            pass
    return HOST_INGEST_BUDGET_DEFAULT


def ingest_row_bytes(features: int) -> int:
    """Peak host bytes one streamed row costs while its chunk is live: the
    raw float32 slice and its int32 bins, doubled for the binning pass's
    transposed copies."""
    return 2 * max(int(features), 1) * (4 + 4)


def sketch_budget_bytes(features: int, capacity: int) -> int:
    """A-priori bound on the merged sketches' host bytes: (float32 value,
    int64 count) pairs at full capacity per feature, doubled for a
    merge's concatenation."""
    return 2 * max(int(features), 1) * max(int(capacity), 1) * (4 + 8)


def ingest_chunk_rows(features: int, *, budget: int | None = None,
                      floor: int = 1024, cap: int = 1 << 22) -> int:
    """The chunk size of a stream that lets the pipeline choose: the most
    rows whose working set (:func:`ingest_row_bytes`) fits the budget,
    clamped to ``[floor, cap]``."""
    b = int(budget) if budget else host_ingest_budget()
    rows = b // ingest_row_bytes(features)
    return int(min(max(rows, int(floor)), int(cap)))


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

class MemoryPlanError(ValueError):
    """Preflight refusal: the predicted per-device peak exceeds the
    budget. Carries the binding array and the planner's suggestion."""

    def __init__(self, message: str, *, binding_array: str,
                 suggestion: str):
        super().__init__(message)
        self.binding_array = binding_array
        self.suggestion = suggestion


def _axis_widths(mesh_axes) -> dict:
    """``{"data": dr, "feature": df}`` of an axes dict, an int (a 1-D
    data mesh), a ``(dr, df)`` tuple or None (one device)."""
    if mesh_axes is None:
        return {"data": 1, "feature": 1}
    if isinstance(mesh_axes, dict):
        return {
            "data": max(int(mesh_axes.get("data", 1)), 1),
            "feature": max(int(mesh_axes.get("feature", 1)), 1),
        }
    if isinstance(mesh_axes, (tuple, list)):
        dr = int(mesh_axes[0]) if len(mesh_axes) > 0 else 1
        df = int(mesh_axes[1]) if len(mesh_axes) > 1 else 1
        return {"data": max(dr, 1), "feature": max(df, 1)}
    return {"data": max(int(mesh_axes), 1), "feature": 1}


def _spec_axes(name: str, ndim: int) -> tuple:
    """Per-dimension axis names of ``name`` from the partition table
    (``parallel/partition.py``, imported lazily); unknown names price as
    replicated."""
    try:
        from mpitree_tpu_torch.parallel import partition

        spec = partition.spec_for(name, ndim=ndim)
    except Exception:  # noqa: BLE001 — the ledger prices everywhere
        return (None,) * ndim
    axes = tuple(spec) + (None,) * (ndim - len(tuple(spec)))
    return axes[:ndim]


def _per_device_bytes(name: str, shape: tuple, itemsize: int,
                      axes: dict) -> int:
    """Bytes per device of a named array: each dimension its spec shards
    divides (rounded up) by that axis's width."""
    total = int(itemsize)
    for dim, axis in zip(shape, _spec_axes(name, len(shape))):
        w = axes.get(axis, 1) if axis is not None else 1
        total *= -(-int(dim) // max(int(w), 1))
    return total


@dataclasses.dataclass
class MemoryPlan:
    """The priced ledger: per-array rows, per-phase watermarks, peaks.

    ``arrays``: ``{name, shape, itemsize, phase, bytes_per_device}`` rows
    (phase ``"resident"`` = alive for the whole build); ``phases``: per
    phase, resident + that phase's working set; ``hbm_peak_bytes`` the
    largest, ``peak_phase`` its phase; ``host_peak_bytes`` the host RAM
    side."""

    kind: str
    mesh_axes: dict
    arrays: list
    phases: dict
    hbm_peak_bytes: int
    peak_phase: str
    host_peak_bytes: int
    inputs: dict

    def to_dict(self) -> dict:
        return {
            "schema": MEMORY_SCHEMA,
            "kind": self.kind,
            "mesh_axes": dict(self.mesh_axes),
            "arrays": [dict(a) for a in self.arrays],
            "phases": dict(self.phases),
            "hbm_peak_bytes": int(self.hbm_peak_bytes),
            "peak_phase": self.peak_phase,
            "host_peak_bytes": int(self.host_peak_bytes),
            "inputs": dict(self.inputs),
        }

    def top(self, k: int = 5) -> list:
        """The k largest per-device arrays."""
        return sorted(self.arrays, key=lambda a: -a["bytes_per_device"])[:k]

    def binding_array(self) -> dict | None:
        """The largest array alive in the peak phase."""
        live = [
            a for a in self.arrays
            if a["phase"] in (RESIDENT, self.peak_phase)
        ] or self.arrays
        return max(live, key=lambda a: a["bytes_per_device"], default=None)

    def suggestion(self, budget: int) -> str:
        """Smallest workable change: the data-axis widening that brings
        the peak under ``budget``, else a chunk-knob hint."""
        dr = self.mesh_axes.get("data", 1)
        scalable = sum(
            a["bytes_per_device"] for a in self.arrays
            if "data" in _spec_axes(a["name"], len(a["shape"]))
            and a["phase"] in (RESIDENT, self.peak_phase)
        )
        fixed = max(self.hbm_peak_bytes - scalable, 0)
        for widen in (2, 4, 8, 16, 32, 64, 128):
            if fixed + scalable / widen <= budget:
                return (
                    f"widen the data axis to {dr * widen} shards "
                    f"(predicted peak ~{int(fixed + scalable / widen) >> 20}"
                    " MiB/device)"
                )
        return (
            "no data-axis widening (up to 128x) fits; shrink the workload "
            "or lower hist_budget_bytes/max_frontier_chunk so smaller "
            "chunks bound the histogram working set"
        )

    def check(self, budget=None, *, obs=None, what: str = "fit") -> None:
        """Raise :class:`MemoryPlanError` (after a typed ``oom_predicted``
        event on ``obs``) when the predicted peak exceeds ``budget`` (None:
        no known budget, no check)."""
        if not budget or self.hbm_peak_bytes <= int(budget):
            return
        binding = self.binding_array() or {"name": "?", "bytes_per_device": 0}
        suggestion = self.suggestion(int(budget))
        msg = (
            f"predicted per-device peak {self.hbm_peak_bytes >> 20} MiB "
            f"exceeds the {int(budget) >> 20} MiB HBM budget for this "
            f"{what} (peak phase {self.peak_phase!r}; binding array "
            f"{binding['name']!r} at "
            f"{binding['bytes_per_device'] >> 20} MiB/device); "
            f"{suggestion}. Refusing before dispatch — override with a "
            f"larger {HBM_BUDGET_ENV} if the budget is wrong."
        )
        if obs is not None:
            obs.event(
                "oom_predicted", msg,
                binding_array=binding["name"],
                binding_bytes=int(binding["bytes_per_device"]),
                hbm_peak_bytes=int(self.hbm_peak_bytes),
                budget_bytes=int(budget),
                top=[
                    {"name": a["name"], "bytes": int(a["bytes_per_device"])}
                    for a in self.top(5)
                ],
            )
        raise MemoryPlanError(
            msg, binding_array=binding["name"], suggestion=suggestion,
        )


def _ledger(axes: dict):
    """``(arrays, add)``: the row list and its appender."""
    arrays: list = []

    def add(name, shape, itemsize, phase, *, bytes_per_device=None):
        b = (_per_device_bytes(name, shape, itemsize, axes)
             if bytes_per_device is None else int(bytes_per_device))
        arrays.append({
            "name": name, "shape": [int(s) for s in shape],
            "itemsize": int(itemsize), "phase": phase,
            "bytes_per_device": int(b),
        })

    return arrays, add


def _watermarks(arrays: list, phases_in: tuple) -> tuple:
    """``(phases, peak_phase)``: resident + each phase's working set."""
    resident = sum(a["bytes_per_device"] for a in arrays
                   if a["phase"] == RESIDENT)
    phases = {RESIDENT: resident}
    for ph in phases_in:
        extra = sum(a["bytes_per_device"] for a in arrays
                    if a["phase"] == ph)
        if extra:
            phases[ph] = resident + extra
    return phases, max(phases, key=lambda p: phases[p])


def _add_resident(add, *, rows_dev: int, feat_dev: int, bins: int,
                  channels: int, y_itemsize: int, packed: bool,
                  features: int) -> None:
    """The rows every device engine keeps on the card for the build: the
    int32 bins and their byte-wide copy, the targets, the weights, the
    (N, C) float32 payload, the int32 node ids and the candidate mask."""
    add("x_binned", (rows_dev, feat_dev), 4, RESIDENT,
        bytes_per_device=rows_dev * feat_dev * 4)
    if packed:
        pw = _round_up(feat_dev, LANE_FEATURES)
        add("x_packed", (rows_dev, pw), 1, RESIDENT,
            bytes_per_device=rows_dev * pw)
    add("y", (rows_dev,), y_itemsize, RESIDENT,
        bytes_per_device=rows_dev * y_itemsize)
    add("weight", (rows_dev,), 4, RESIDENT, bytes_per_device=rows_dev * 4)
    add("payload", (rows_dev, channels), 4, RESIDENT,
        bytes_per_device=rows_dev * channels * 4)
    add("node_id", (rows_dev,), 4, RESIDENT, bytes_per_device=rows_dev * 4)
    add("cand_mask", (features, bins), 1, RESIDENT,
        bytes_per_device=features * bins)


def plan_fit(*, rows: int, features: int, classes: int = 2,
             bins: int = 256, task: str = "classification",
             max_depth=None, max_leaf_nodes=None, mesh_axes=None,
             gbdt_x64: bool = False, fixed: bool | None = None,
             subtraction: bool = False,
             chunk_slots: int | None = None,
             table_slots: int | None = None,
             hist_budget_bytes: int = 4 << 30,
             max_frontier_chunk: int = 4096,
             max_table_slots: int = 1 << 17,
             rounds_per_dispatch: int = 1,
             n_out: int = 1,
             engine: str | None = None,
             device_bin: bool = False,
             streamed: bool = False,
             streamed_chunk_rows: int | None = None) -> MemoryPlan:
    """Price one fit's device buffers into a :class:`MemoryPlan`.

    Every argument is a static of the fit (nothing here touches a
    device): what ``core/builder.build_tree`` knows before its first
    launch. ``fixed`` is the histogram's route (8-byte int64 cells; None
    takes it from ``task``: regression and boosting always run fixed
    point; ``gbdt_x64`` is the JAX package's name for the same switch).
    ``engine``: ``"fused"``, ``"levelwise"``, ``"leafwise"``,
    ``"fused_rounds"`` or ``"host"``, which picks the working sets.
    ``device_bin``: the estimator bins on the card (a ``"bin"`` phase).
    ``mesh_axes`` as :func:`_axis_widths` takes it.

    Where the port's buffers differ from the JAX package's ledger
    (``mpitree_tpu/obs/memory.py:587``): the byte-wide bins
    (``x_packed``), the (N, C) ``payload`` and int64 class targets, the
    float64 sweep buffers inside ``split_hist_chunk`` and ``pair_hist``
    (:func:`split_bytes_per_slot`), the fused engine's ``node_state``,
    the sorted route's ``row_order``, the terminal sums' int64
    ``payload_q``, the leaf loop's own pool rows, and the device
    binning's ``bin_workspace``.
    """
    axes = _axis_widths(mesh_axes)
    dr, df = axes["data"], axes["feature"]
    C = int(classes) if task == "classification" else 3
    rows, features, bins = int(rows), int(features), int(bins)
    if fixed is None:
        fixed = task != "classification" or bool(gbdt_x64)
    cell = 8 if fixed else 4
    rows_dev = -(-rows // dr)
    f_shard = -(-features // df)
    K = int(chunk_slots) if chunk_slots else default_chunk_slots(
        rows, f_shard, bins, C, hist_budget_bytes=hist_budget_bytes,
        max_frontier_chunk=max_frontier_chunk, max_depth=max_depth,
        cell_bytes=cell)
    widest = widest_frontier(rows, max_depth)
    U = (int(table_slots) if table_slots else
         default_table_slots(rows, max_depth, max_table_slots))
    arrays, add = _ledger(axes)
    host = engine == "host"
    if not host:
        _add_resident(add, rows_dev=rows_dev, feat_dev=f_shard, bins=bins,
                      channels=C, y_itemsize=8 if task == "classification"
                      else 4, packed=bins <= 256, features=f_shard)
        if device_bin:
            add("bin_workspace", (rows, features), BIN_CELL_BYTES, "bin",
                bytes_per_device=rows * features * BIN_CELL_BYTES)
    fused_gbdt = task == "gbdt" and int(rounds_per_dispatch) > 1
    if host:
        pass  # the host tier keeps nothing on the card
    elif max_leaf_nodes is not None:
        # best-first growth: the pool scalars (gain, node, feature, bin,
        # left weight), the (2P - 1)-node state, the pool-resident
        # histograms under subtraction and one sibling pair's histogram
        # (its sweep's accumulators included); inside a fused multi-round
        # dispatch they join the fused_rounds phase
        ph = "fused_rounds" if fused_gbdt else "leafwise"
        Pn = pool_capacity(max_leaf_nodes, max_depth, rows)
        M = 2 * Pn - 1
        add("pool_scalars", (Pn + 1, 5), 4, ph,
            bytes_per_device=(Pn + 1) * (4 + 8 + 4 + 4 + 8))
        add("pool_nodes", (M + 2, 6 + C), 4, ph,
            bytes_per_device=(M + 2) * (5 * 4 + 8 + C * 8))
        if subtraction:
            add("pool_hist", (Pn + 1, f_shard, C, bins), cell, ph,
                bytes_per_device=slab_bytes(Pn + 1, f_shard, C, bins,
                                            itemsize=cell))
        add("pair_hist", (2, f_shard, C, bins), cell, ph,
            bytes_per_device=2 * split_bytes_per_slot(f_shard, bins, C,
                                                      cell))
        add("row_order", (rows_dev,), ROW_ORDER_BYTES, ph,
            bytes_per_device=rows_dev * ROW_ORDER_BYTES)
    else:
        # level-synchronous engines: the K-slot split working set, the
        # level's row order, under subtraction the kept parents (gated by
        # the same hist_budget_bytes), the reroute tables and the
        # terminal sums' int64 payload
        add("split_hist_chunk", (K, f_shard, C, bins), cell, "split",
            bytes_per_device=K * split_bytes_per_slot(f_shard, bins, C,
                                                      cell))
        add("row_order", (rows_dev,), ROW_ORDER_BYTES, "split",
            bytes_per_device=rows_dev * ROW_ORDER_BYTES)
        if subtraction:
            n_chunks = -(-widest // K)
            carry = min(int(hist_budget_bytes),
                        n_chunks * slab_bytes(K, f_shard, C, bins,
                                              itemsize=cell))
            add("parent_hist", (n_chunks, K, f_shard, C, bins), cell,
                "split", bytes_per_device=carry)
        add("update_tables", (U,), 4, "update",
            bytes_per_device=table_bytes(U, C))
        add("payload_q", (rows_dev, C), 8, "counts",
            bytes_per_device=rows_dev * C * 8 + table_bytes(U, C))
        if engine == "fused":
            # the tree on the card: feature, bin, left, parent (int32)
            # and the float64 counts of every node of the capacity
            cap = 2 * max(rows, 1) - 1
            if max_depth is not None and int(max_depth) < 31:
                cap = min(cap, 2 ** (int(max_depth) + 1) - 1)
            cap = (1 << max(0, math.ceil(math.log2(max(cap, 1))))) + K + 2
            add("node_state", (cap, 4 + 2 * C), 4, RESIDENT,
                bytes_per_device=cap * (4 * 4 + C * 8 + 1))
    if fused_gbdt:
        # the margins (float32 and float64), targets, weights and the
        # round's (g, h), per row
        add("margin_carry", (rows_dev, max(int(n_out), 1)), 4,
            "fused_rounds",
            bytes_per_device=rows_dev * max(int(n_out), 1) * (4 + 8))
        add("grad_hess", (rows_dev, 2), 4, "fused_rounds",
            bytes_per_device=rows_dev * (2 * 4 + 2 * 8))
    phases, peak_phase = _watermarks(arrays, FIT_PHASES)
    if streamed:
        K_ing = (int(streamed_chunk_rows) if streamed_chunk_rows
                 else ingest_chunk_rows(features))
        host_peak = rows * 16 + K_ing * ingest_row_bytes(features)
    else:
        host_peak = rows * features * 4 * 2 + rows * 16
    return MemoryPlan(
        kind="fit",
        mesh_axes=axes,
        arrays=arrays,
        phases=phases,
        hbm_peak_bytes=int(phases[peak_phase]),
        peak_phase=peak_phase,
        host_peak_bytes=int(host_peak),
        inputs={
            "rows": rows, "features": features, "classes": int(classes),
            "bins": bins, "task": task,
            "max_depth": None if max_depth is None else int(max_depth),
            "max_leaf_nodes": (
                None if max_leaf_nodes is None else int(max_leaf_nodes)),
            "chunk_slots": int(K), "table_slots": int(U),
            "gbdt_x64": bool(fixed), "subtraction": bool(subtraction),
            "rounds_per_dispatch": int(rounds_per_dispatch),
            "engine": engine,
            **({"streamed": True} if streamed else {}),
        },
    )


def plan_forest(*, n_trees: int, rows: int, features: int,
                classes: int = 2, bins: int = 256,
                task: str = "classification", max_depth=None,
                tree_shards: int = 1, data_shards: int = 1,
                subtraction: bool = False, fixed: bool | None = None,
                chunk_slots: int | None = None,
                node_capacity: int | None = None,
                hist_budget_bytes: int = 4 << 30,
                max_frontier_chunk: int = 4096,
                device_bin: bool = False) -> MemoryPlan:
    """Price a batched forest build (``core/fused_builder.
    build_forest_fused``): the rows once, the per-tree weights and
    candidate masks over the tree axis, every tree's finished node state
    (kept until the one copy to the host), and one tree's split working
    set at a time (the trees grow in sequence on a device)."""
    Dt = max(int(tree_shards), 1)
    Dd = max(int(data_shards), 1)
    axes = {"tree": Dt, "data": Dd}
    C = int(classes) if task == "classification" else 3
    rows, features, bins = int(rows), int(features), int(bins)
    if fixed is None:
        fixed = task != "classification"
    cell = 8 if fixed else 4
    rows_dev = -(-rows // Dd)
    T_dev = -(-int(n_trees) // Dt)
    K = int(chunk_slots) if chunk_slots else default_chunk_slots(
        rows, features, bins, C, hist_budget_bytes=hist_budget_bytes,
        max_frontier_chunk=max_frontier_chunk, max_depth=max_depth,
        cell_bytes=cell)
    M = (int(node_capacity) if node_capacity else min(
        (2 ** (int(max_depth) + 1) - 1) if max_depth is not None
        and int(max_depth) < 31 else 2 * rows - 1, 2 * rows - 1))
    arrays, add = _ledger(axes)
    _add_resident(add, rows_dev=rows_dev, feat_dev=features, bins=bins,
                  channels=C, y_itemsize=8 if task == "classification"
                  else 4, packed=bins <= 256, features=features)
    if device_bin:
        add("bin_workspace", (rows, features), BIN_CELL_BYTES, "bin",
            bytes_per_device=rows * features * BIN_CELL_BYTES)
    add("tree_weights", (T_dev, rows_dev), 4, RESIDENT,
        bytes_per_device=T_dev * rows_dev * 4)
    add("tree_cand_masks", (T_dev, features, bins), 1, RESIDENT,
        bytes_per_device=T_dev * features * bins)
    # every finished tree's (4, n) int32 and (n, C) float64 arrays wait
    # on the card for the one copy; the growing tree's node state
    add("tree_nodes", (T_dev, M, 4 + 2 * C), 4, RESIDENT,
        bytes_per_device=T_dev * M * (4 * 4 + C * 8))
    cap = (1 << max(0, math.ceil(math.log2(max(M, 1))))) + K + 2
    add("node_state", (cap, 4 + 2 * C), 4, "split",
        bytes_per_device=cap * (4 * 4 + C * 8 + 1))
    add("split_hist_chunk", (K, features, C, bins), cell, "split",
        bytes_per_device=K * split_bytes_per_slot(features, bins, C, cell))
    add("row_order", (rows_dev,), ROW_ORDER_BYTES, "split",
        bytes_per_device=rows_dev * ROW_ORDER_BYTES)
    if subtraction:
        widest = widest_frontier(rows, max_depth)
        n_chunks = -(-widest // K)
        add("parent_hist", (n_chunks, K, features, C, bins), cell, "split",
            bytes_per_device=min(int(hist_budget_bytes), n_chunks
                                 * slab_bytes(K, features, C, bins,
                                              itemsize=cell)))
    phases, peak_phase = _watermarks(arrays, ("bin", "split"))
    host_peak = (rows * features * 8 + int(n_trees) * rows * 4 + rows * 16)
    return MemoryPlan(
        kind="forest",
        mesh_axes=axes,
        arrays=arrays,
        phases=phases,
        hbm_peak_bytes=int(phases[peak_phase]),
        peak_phase=peak_phase,
        host_peak_bytes=int(host_peak),
        inputs={
            "n_trees": int(n_trees), "rows": rows, "features": features,
            "classes": int(classes), "bins": bins, "task": task,
            "max_depth": None if max_depth is None else int(max_depth),
            "tree_shards": Dt, "data_shards": Dd,
            "chunk_slots": int(K), "node_capacity": int(M),
            "subtraction": bool(subtraction), "engine": "forest_fused",
        },
    )


def plan_ingest(*, rows: int, features: int, chunk_rows: int,
                sketch_capacity: int, mesh_axes=None,
                max_bins: int = 256,
                spill_bytes: int | None = None) -> MemoryPlan:
    """Price one streamed ingest pass: the host's per-chunk staging, the
    merged sketches and the per-row targets and weights, against each
    device's share of the assembled ``x_binned`` plus one chunk piece in
    flight. ``spill_bytes`` (the spill rung's disk store) is a ``"disk"``
    row outside the host watermarks."""
    axes = _axis_widths(mesh_axes)
    rows, features, K = int(rows), int(features), int(chunk_rows)
    rows_pad = _round_up(rows, axes["data"])
    feat_pad = _round_up(features, axes["feature"])
    arrays = [
        {"name": "chunk_raw", "shape": [K, features], "itemsize": 4,
         "phase": "sketch", "bytes_per_device": 2 * K * features * 4},
        {"name": "chunk_binned", "shape": [K, features], "itemsize": 4,
         "phase": "bin_place", "bytes_per_device": 2 * K * features * 4},
        {"name": "sketch", "shape": [features, int(sketch_capacity)],
         "itemsize": 12, "phase": RESIDENT,
         "bytes_per_device": sketch_budget_bytes(features,
                                                 sketch_capacity)},
        {"name": "y_host", "shape": [rows], "itemsize": 16,
         "phase": RESIDENT, "bytes_per_device": rows * 16},
    ]
    if spill_bytes:
        arrays.append({"name": "spill_store", "shape": [int(spill_bytes)],
                       "itemsize": 1, "phase": "disk",
                       "bytes_per_device": int(spill_bytes)})
    resident = sum(a["bytes_per_device"] for a in arrays
                   if a["phase"] == RESIDENT)
    phases = {
        RESIDENT: resident,
        "sketch": resident + 2 * K * features * 4,
        "bin_place": resident + 4 * K * features * 4,
    }
    peak_phase = max(phases, key=lambda p: phases[p])
    xb_dev = _per_device_bytes("x_binned", (rows_pad, feat_pad), 4, axes)
    return MemoryPlan(
        kind="ingest",
        mesh_axes=axes,
        arrays=arrays,
        phases=phases,
        hbm_peak_bytes=int(xb_dev + K * feat_pad * 4),
        peak_phase=peak_phase,
        host_peak_bytes=int(phases[peak_phase]),
        inputs={
            "rows": rows, "features": features, "chunk_rows": K,
            "sketch_capacity": int(sketch_capacity),
            "max_bins": int(max_bins),
            "host_budget_bytes": host_ingest_budget(),
            "replay_pass_bytes": 2 * K * features * 4,
            **({"spill_bytes": int(spill_bytes)} if spill_bytes else {}),
        },
    )


def aggregate_plans(plans: list) -> dict:
    """The whole-fit plan of a fit that recorded several (the host round
    loop records one a round): each phase's watermark is the most over
    the plans, and the fit's peak adds one more resident generation,
    since round r + 1's buffers are placed before round r's are freed."""
    plans = [p if isinstance(p, dict) else p.to_dict() for p in plans]
    peaks = [int(p.get("hbm_peak_bytes") or 0) for p in plans]
    binding = plans[peaks.index(max(peaks))]
    resident = int((binding.get("phases") or {}).get(RESIDENT, 0))
    phases: dict = {}
    for p in plans:
        for ph, v in (p.get("phases") or {}).items():
            phases[ph] = max(int(phases.get(ph, 0)), int(v))
    return {
        "schema": MEMORY_SCHEMA,
        "kind": "fit_aggregate",
        "rounds": len(plans),
        "phases": phases,
        "hbm_peak_bytes": max(peaks) + resident,
        "peak_phase": binding.get("peak_phase"),
        "host_peak_bytes": max(
            int(p.get("host_peak_bytes") or 0) for p in plans),
        "inputs": dict(binding.get("inputs") or {}),
    }


def _block(nbytes: int) -> int:
    """A served array's allocated bytes: 512-byte granules, and a large
    block's unsplit tail (:data:`ALLOC_TAIL`)."""
    b = _round_up(max(int(nbytes), 1), 512)
    return b + ALLOC_TAIL if b > ALLOC_TAIL else b


def plan_serve(*, n_trees: int, n_nodes_total: int, n_nodes_max: int,
               n_features: int, value_channels: int, n_out: int,
               buckets=(1, 64, 4096), x64: bool = True,
               kernel: bool = False, quantized: bool = False,
               normalized: bool = False, margin=None) -> MemoryPlan:
    """Price a served model's card residency: the flat node table's five
    columns and its leaf values (from publish on), the traversal kernel's
    packed 16-byte node records (``kernel``), and the largest bucket's
    query rows and its float64 (int32 quantized) accumulator. A
    ``normalized`` value channel (a forest's per-tree class fractions) is
    uploaded, then divided into a second copy: both live in the
    ``publish`` phase. Each array is priced in the caching allocator's
    blocks (:func:`_block`). A boosted model the margin body serves
    passes its ``margin`` pack (``serving/serve_kernel.pack_margin``,
    made when the model compiles): each of the pack's tensors is priced as
    allocated in place of the general body's records, and the tile is
    the margin body's, planned from the pack's own chunks
    (``serve_kernel.plan_margin``). ``inputs`` keep the kernel's tiling
    of the largest bucket (``serving/serve_kernel.plan``)."""
    val_item = 8 if x64 else 4
    bmax = max(int(b) for b in buckets) if buckets else 1
    kv = max(int(value_channels), 1)
    M = int(n_nodes_total)
    if quantized:
        # int16 feature ids, bfloat16 thresholds, int32 children and
        # roots; int8 values and their per-channel scale and base
        table = M * (2 + 2 + 4 + 4 + 4)
        value_bytes = M * kv + 2 * kv * 4
    else:
        table = M * 5 * 4
        value_bytes = M * kv * val_item
    acc_item = 4 if quantized else 8
    arrays = [
        {"name": "node_table", "shape": [M, 5], "itemsize": 4,
         "phase": RESIDENT, "bytes_per_device": table},
        {"name": "leaf_values", "shape": [M, kv],
         "itemsize": 1 if quantized else val_item, "phase": RESIDENT,
         "bytes_per_device": value_bytes},
        {"name": "query_batch", "shape": [bmax, int(n_features)],
         "itemsize": 4, "phase": "dispatch",
         "bytes_per_device": bmax * int(n_features) * 4},
        {"name": "accumulator", "shape": [bmax, max(int(n_out), 1)],
         "itemsize": acc_item, "phase": "dispatch",
         "bytes_per_device": bmax * max(int(n_out), 1) * acc_item},
    ]
    if normalized and not quantized:
        arrays.append({"name": "values_upload", "shape": [M, kv],
                       "itemsize": val_item, "phase": "publish",
                       "bytes_per_device": value_bytes})
    tile = None
    if kernel:
        from mpitree_tpu_torch.serving import serve_kernel

        form = "traverse_q" if quantized else "traverse"
        K = max(int(n_out), 1)
        if margin is None:
            arrays.append({"name": "kernel_tables", "shape": [M, 4],
                           "itemsize": 4, "phase": RESIDENT,
                           "bytes_per_device": M * 16})
        else:
            for name, t in margin.tensors().items():
                arrays.append({
                    "name": name, "shape": list(t.shape),
                    "itemsize": t.element_size(), "phase": RESIDENT,
                    "bytes_per_device": t.numel() * t.element_size()})
        try:
            if margin is None:
                p = serve_kernel.plan(form, bmax, int(n_trees), K,
                                      n_features=int(n_features))
            else:
                p = serve_kernel.plan_margin(
                    form, bmax, K, n_features=int(n_features),
                    table_bytes=margin.table_bytes,
                    chunk_trees=margin.chunk_trees)
            tile = {"rows_per_block": int(p["rows_per_block"]),
                    "smem": int(p["smem"]), "stage_x": bool(p["stage_x"])}
            if margin is not None:
                tile["body"] = "margin"
        except ValueError:
            tile = None
    for a in arrays:
        a["bytes_per_device"] = _block(a["bytes_per_device"])
    phases, peak_phase = _watermarks(arrays, ("publish", "dispatch"))
    return MemoryPlan(
        kind="serve",
        mesh_axes={"data": 1, "feature": 1},
        arrays=arrays,
        phases=phases,
        hbm_peak_bytes=int(phases[peak_phase]),
        peak_phase=peak_phase,
        # the int8 tier quantizes a float64 host channel
        host_peak_bytes=int(M) * (5 * 4 + kv * (8 if quantized
                                                else val_item)),
        inputs={
            "n_trees": int(n_trees), "n_nodes_total": M,
            "n_nodes_max": int(n_nodes_max),
            "n_features": int(n_features), "value_channels": kv,
            "n_out": int(n_out), "buckets": [int(b) for b in buckets],
            "x64": bool(x64), "kernel": bool(kernel),
            "quantized": bool(quantized),
            "normalized": bool(normalized),
            "margin_body": margin is not None,
            "kernel_tile": tile,
        },
    )


# ---------------------------------------------------------------------------
# budgets and the preflight
# ---------------------------------------------------------------------------

def device_hbm_budget(device=None) -> int | None:
    """The per-device budget the preflight checks against:
    ``MPITREE_TPU_HBM_BYTES`` when set, else the capacity the card
    reports (``torch.cuda.mem_get_info``'s total); None on the CPU, where
    nothing is refused."""
    env = knobs.raw(HBM_BUDGET_ENV)
    if env:
        try:
            return int(env)
        except ValueError:
            return None
    try:
        import torch

        dev = torch.device("cuda" if device is None else device)
        if dev.type != "cuda" or not torch.cuda.is_available():
            return None
        return int(torch.cuda.mem_get_info(dev)[1])
    except Exception:  # noqa: BLE001 — no reading is no budget
        return None


def preflight(plan: MemoryPlan, *, obs=None, what: str = "fit",
              device=None) -> None:
    """Refuse a plan that cannot fit before anything is launched; a no-op
    when no budget is known."""
    plan.check(device_hbm_budget(device), obs=obs, what=what)


# ---------------------------------------------------------------------------
# live watermarks
# ---------------------------------------------------------------------------

def host_rss_bytes() -> int | None:
    """This process's resident set in bytes, or None where unreadable."""
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        pass
    try:
        import resource

        return int(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss) * 1024
    except Exception:  # noqa: BLE001 — no reading is a None, not a failure
        return None


def live_tensor_bytes(device) -> int:
    """Bytes of the storages of the live tensors on ``device`` (each
    storage once), found through the garbage collector after a collection:
    what Python holds, not what an operation held in between."""
    import gc

    import torch

    gc.collect()
    seen, total = set(), 0
    for obj in gc.get_objects():
        try:
            # type(), not isinstance(): some module objects answer
            # __class__ lazily, with a deprecation warning
            if not issubclass(type(obj), torch.Tensor) \
                    or obj.device != device:
                continue
            st = obj.untyped_storage()
            key = st.data_ptr()
            if key in seen:
                continue
            seen.add(key)
            total += int(st.nbytes())
        except Exception:  # noqa: BLE001 — a tensor mid-teardown
            continue
    return total


def live_hbm_bytes(device=None) -> tuple:
    """``(bytes, peak, source)`` for one device: on the card the caching
    allocator's allocated bytes and its peak since the last reading
    (which this resets; :data:`ALLOCATOR_SOURCE`), else the live tensor
    bytes twice (:data:`LIVE_TENSORS_SOURCE`); ``(0, 0, "none")`` when
    nothing is measurable."""
    try:
        import torch

        dev = torch.device("cpu" if device is None else device)
        if dev.type == "cuda":
            now = int(torch.cuda.memory_allocated(dev))
            peak = int(torch.cuda.max_memory_allocated(dev))
            torch.cuda.reset_peak_memory_stats(dev)
            return now, max(peak, now), ALLOCATOR_SOURCE
        b = live_tensor_bytes(dev)
        return b, b, LIVE_TENSORS_SOURCE
    except Exception:  # noqa: BLE001 — telemetry never aborts a fit
        return 0, 0, "none"


class MemWatch:
    """Span-close live-memory watermarks (``BuildObserver.watch_memory``,
    ``MPITREE_TPU_MEM_SAMPLE=1``): the observer calls :meth:`sample` at
    every span close, and :meth:`summary` lands in
    ``record.memory['live']``. The first sample is the baseline, so
    ``hbm_peak_delta_bytes`` is what this fit added to what the process
    held. On the card each sample reads the allocator's peak since the
    previous one, so transients between span closes count; the span that
    closed gets that peak in ``span_peaks``."""

    def __init__(self, device=None):
        self.device = device
        self.source = "none"
        self.samples = 0
        self.hbm_baseline: int | None = None
        self.hbm_peak = 0
        self.host_peak = 0
        self.hbm_last = 0
        self.host_last = 0
        self.span_peaks: dict = {}

    def sample(self, span: str | None = None) -> None:
        now, peak, source = live_hbm_bytes(self.device)
        if source != "none":
            self.source = source
            self.hbm_last = now
            if self.hbm_baseline is None:
                # the allocator's peak before the baseline is another
                # fit's: only what follows it counts
                self.hbm_baseline = peak = now
            self.hbm_peak = max(self.hbm_peak, peak)
            if span is not None:
                self.span_peaks[span] = max(self.span_peaks.get(span, 0),
                                            peak)
        rss = host_rss_bytes()
        if rss:
            self.host_last = rss
            self.host_peak = max(self.host_peak, rss)
        self.samples += 1

    def summary(self) -> dict:
        base = self.hbm_baseline or 0
        return {
            "source": self.source,
            "samples": int(self.samples),
            "hbm_baseline_bytes": int(base),
            "hbm_peak_bytes": int(self.hbm_peak),
            "hbm_peak_delta_bytes": int(max(self.hbm_peak - base, 0)),
            "host_peak_bytes": int(self.host_peak),
            "span_peaks": {k: int(max(v - base, 0))
                           for k, v in self.span_peaks.items()},
        }


def drift_tolerance() -> float:
    try:
        return float(knobs.value(DRIFT_TOL_ENV))
    except ValueError:
        return DRIFT_TOL_DEFAULT


def drift_check(estimate: int | None, live_delta: int | None,
                source: str = ALLOCATOR_SOURCE) -> dict | None:
    """The ledger against the live watermark: a dict of event fields when
    they diverge, else None. An underestimate (live above 1.25x the
    estimate) counts on every source; an overestimate past the tolerance
    factor counts only on an exact source (:data:`EXACT_SOURCES`), since
    the live-tensor sum misses the transients the ledger prices."""
    if not estimate or live_delta is None or live_delta <= 0:
        return None
    tol = drift_tolerance()
    ratio = estimate / live_delta
    over = source in EXACT_SOURCES and ratio > tol
    under = ratio < 0.8
    if not (over or under):
        return None
    return {
        "estimate_bytes": int(estimate),
        "live_delta_bytes": int(live_delta),
        "ratio": round(ratio, 3),
        "tolerance": tol,
        "source": source,
        "direction": "underestimate" if under else "overestimate",
    }

"""Breadth-first, level-synchronous tree construction on one device or a
data mesh.

Counterpart of ``mpitree_tpu/core/builder.py`` (``build_tree``, ``:703``).
:func:`build_tree` runs one of two engines (:func:`resolve_engine`,
``:808-990`` without the advisor and the leaf-wise reroute): the fused
engine (``core/fused_builder.py``), which keeps the tree on the device,
or the levelwise engine below (its loop from ``:980``), which grows each
level with a few device steps and one host round trip:

1. the rows are ordered by node once (:class:`FrontierHistograms`), and
   for every frontier chunk :func:`collective.split_hist` builds the
   ``(S, F, C, B)`` histogram (the Hopper kernel family on CUDA, which
   reads each chunk's rows through that order and the fit's byte-wide copy
   of the bins) and :func:`collective.split_sweep` picks the best split
   per node; the packed decisions of all chunks come to the host in one
   copy;
2. the host applies the stopping rules to the O(frontier) decision vectors
   and appends node records (struct-of-arrays, contiguous ids per level,
   which is what makes ``slot = node_id - chunk_lo`` work);
3. :func:`collective.update_node_id` advances the on-device row -> node
   assignments.

Terminal levels (``depth == max_depth``) only need per-node sums, an O(N)
scatter. A level's histogram width ``S`` is the narrowest of
``FRONTIER_TIERS`` that holds the frontier, else the chunk width ``K``
that :func:`_chunk_size` sizes from the histogram memory budget; wider
frontiers walk several K-slot chunks, each a full pass over the rows.

Three tasks (``BuildConfig.task``): classification (class counts),
regression (the moments ``(w, w*y, w*y^2)`` of targets the estimator
centred in float32, then the exact float64 leaf means of
:func:`refit_regression_values`) and ``"gbdt"``, one Newton boosting
round (``y`` carries the rows' float32 gradients, ``sample_weight`` their
hessians; the ``(count, g, h)`` payload, the Newton sweep, the stopping
rules of ``mpitree_tpu/core/builder.py:1465-1517``; the boosting loop
refits every node's value in float64). The payload picks the histogram's
route once per fit (``parallel/collective.payload_scale``): class counts with
integer weights take the float32 integer route, every other payload
(fractional weights, every regression, every boosting round) the int64
fixed-point route, whose sums are exact and order-independent, so the
card's tree equals the CPU's and, for fractional weights, the exact
float64 counts of the JAX package's host tier.

Per-node feature sampling and ``splitter="random"`` (``feature_sampler``,
``ops/sampling.py``): the node keys live on the host in a ``KeyStore``
beside the level's host decision, as in the JAX levelwise engine; each
chunk's (S, F) feature masks and bin draws go to the card with the chunk.
``feature_mask`` (a forest tree's fixed subspace) removes features from
the candidates but not from the histogram, so the ``constant`` stop sees
them as the JAX package's does.

Monotonic constraints (``mono_cst``, ``utils/monotonic.py``): the node
bounds live on the host in a ``BoundsStore`` beside the level's decision,
as in the JAX levelwise engine (``:1028-1036``); each chunk's bound
windows go to the card with the chunk, and the winners' child values come
back in the decision buffer to bound the children (``:1551-1554``).

Sibling subtraction (``hist_subtraction``, :func:`resolve_hist_subtraction`)
serves both engines through :class:`FrontierHistograms`: a level keeps its
histograms (one buffer per chunk, while they fit ``hist_budget_bytes``,
``:1185-1264``) and the next accumulates only the smaller child of each
pair, rebuilding the larger as ``parent - small`` (``:1636-1655``). Both
histogram routes subtract exactly, so it never changes a tree.

A ``max_leaf_nodes`` budget sends :func:`build_tree` to the leaf-wise
engines (``core/leafwise_builder.py``). Not here (see ``ROADMAP.md``
item 18): the observability layer.

Resilience (``mpitree_tpu_torch.resilience``, the JAX package's
``:716-726``, ``:980-1001``, ``:1199-1207``, ``:1272-1289``): given a
``snapshot_slot`` the levelwise engine saves its loop carry at every
level (the FitInputs, every shard's node ids, the node buffer and its
length, the key and bound stores, the frontier), and a call with a
pending snapshot resumes at that level, so a transient failure at level
17 re-runs levels 17 and on only. The resumed level rebuilds its
histograms directly (the subtraction carry is dropped: subtraction never
changes a tree). Its chaos seams: ``level`` (each level, reporting its
depth), ``split_dispatch`` (each chunk's split search),
``counts_dispatch`` (a terminal level's sums) and ``update_dispatch``
(each reroute table). ``stats["level_dispatches"]`` counts the levels
run, re-runs included. The fused engine takes no snapshot, as in JAX.

On a data mesh (``mesh=``, ``parallel/mesh.py``; the JAX package's
``shard_map`` over ``DATA_AXIS``) both engines keep the tree state, the
sweep, the stop rules and the allocation on the lead shard, once per
process, and the rows on their shards: :class:`FitInputs` shards them,
:class:`FrontierHistograms` reduces each chunk's histogram over every
shard and process before the sweep (and before a sibling subtraction's
rebuild), the terminal sums and regression's range reduce likewise, and
the split tables go to every shard for the reroute. Every process sweeps
its own copy of the reduced histograms; ``BuildConfig.debug`` holds their
decisions to the same bits every level (``utils/profiling``). The
port's ``backend=None`` is always the device engine, so a multi-device
mesh needs no rule of its own to force it
(``mpitree_tpu/core/builder.py:179-191``). On a ``(data, feature)`` mesh
(``:816-850``) each shard holds its rows of one feature slab:
:class:`SlabHistograms` builds and reduces each slab's histograms over
its data axis, :meth:`FitInputs.sweep` sweeps each slab and merges the
winners over the feature axis, and :meth:`FitInputs.reroute` routes the
rows by the owner broadcast; both engines, with and without sibling
subtraction, grow the one-device tree.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import NamedTuple

import numpy as np
import torch

from mpitree_tpu_torch.core.tree_struct import TreeArrays
from mpitree_tpu_torch.ops import hist_kernel
from mpitree_tpu_torch.ops.binning import BinnedData, StreamedBinnedData
from mpitree_tpu_torch.ops.histogram import (
    class_payload,
    gbdt_payload,
    moment_payload,
    sibling_accumulate_slots,
    sibling_reconstruct,
)
from mpitree_tpu_torch.parallel import collective
from mpitree_tpu_torch.resilience import chaos
from mpitree_tpu_torch.resilience.recovery import resolve_level_retry
from mpitree_tpu_torch.utils.importances import (
    class_node_impurity,
    moment_node_impurity,
)
from mpitree_tpu_torch.utils.monotonic import BoundsStore
from mpitree_tpu_torch.utils.profiling import assert_replicated

TASKS = ("classification", "regression", "gbdt")


HIST_BUDGET_BYTES = 4 << 30  # device memory for one histogram chunk
MAX_FRONTIER_CHUNK = 4096
MAX_TABLE_SLOTS = 1 << 17  # width of per-level update/counts tables
# Histogram widths narrower than the chunk: a frontier that fits tier S
# runs an S-slot histogram and sweep instead of the K-slot one. Tier 1 is
# the root, the one width the histogram's unsorted route serves
# (ops/hist_kernel.py).
FRONTIER_TIERS = (1, 8, 64, 128, 512)
ENGINES = ("auto", "fused", "levelwise")
SUBTRACTION_FLAGS = ("auto", "on", "off")
# Environment knobs that steer the "auto" settings only, read at call time
# (mpitree_tpu/config/knobs.py:68-87).
ENGINE_ENV = "MPITREE_TPU_ENGINE"
SUBTRACTION_ENV = "MPITREE_TPU_HIST_SUBTRACTION"
# What hist_subtraction="auto" resolves to, per device type, in every
# engine: on only where chip_smoke.py measured subtraction faster end to
# end (phase 24 level by level, phase 25 leaf-wise; PERF.md).
SUBTRACTION_AUTO = {"cuda": False, "cpu": False}


@dataclasses.dataclass(frozen=True)
class BuildConfig:
    # classification | regression | gbdt (one Newton boosting round)
    task: str = "classification"
    # entropy | gini (classification); mse (regression); unused by gbdt
    criterion: str = "entropy"
    max_depth: int | None = None
    min_samples_split: int = 2
    # gbdt only: L2 leaf regularization (XGBoost's lambda), the least
    # Newton gain a split must clear, and the least subsampled row count
    # per child.
    reg_lambda: float = 0.0
    min_split_gain: float = 0.0
    min_leaf_rows: float = 0.0
    # Absolute weight floor for each side of a split (sklearn's
    # min_weight_fraction_leaf / min_samples_leaf, resolved by the
    # estimator); 0.0 = unconstrained. For gbdt the per-child HESSIAN
    # floor (XGBoost's min_child_weight), not a weight or row floor.
    min_child_weight: float = 0.0
    # sklearn's min_impurity_decrease pre-scaled by the total fit weight:
    # a split stops when n_t * (imp_t - cost_t) < this value.
    min_decrease_scaled: float = 0.0
    # Device memory for one histogram chunk (the subtraction carry keeps a
    # level's histograms while they fit it too), the chunk's slot cap, and
    # the width of the per-level reroute and terminal-count tables.
    hist_budget_bytes: int = HIST_BUDGET_BYTES
    max_frontier_chunk: int = MAX_FRONTIER_CHUNK
    max_table_slots: int = MAX_TABLE_SLOTS
    frontier_tiers: tuple = FRONTIER_TIERS
    # "fused" keeps the tree on the device and reads one frontier size a
    # level (core/fused_builder.py); "levelwise" decides each level on the
    # host; "auto" is fused, but levelwise for gbdt. MPITREE_TPU_ENGINE
    # steers "auto".
    engine: str = "auto"
    # Sibling subtraction in both engines: "on", "off", or "auto"
    # (SUBTRACTION_AUTO; MPITREE_TPU_HIST_SUBTRACTION steers it).
    hist_subtraction: str = "auto"
    # A leaf budget grows the tree best-first (core/leafwise_builder.py);
    # None grows it level by level.
    max_leaf_nodes: int | None = None
    # On a mesh of several processes, hold every level's decisions to the
    # same bits on every process (utils/profiling.assert_replicated).
    debug: bool = False


def chunk_bytes_per_slot(n_feat: int, n_bins: int, n_chan: int,
                         cell_bytes: int = 4) -> int:
    """Live device bytes per frontier slot: the (F, C, B) histogram
    (float32 cells, or the fixed-point route's 8-byte int64 ones) plus ~8
    (F, B) float64 accumulators of the f64 cost sweep."""
    return n_feat * n_bins * (n_chan * cell_bytes + 8 * 8)


def _widest_frontier(n_samples: int, cfg: BuildConfig) -> int:
    widest = n_samples
    if cfg.max_depth is not None and cfg.max_depth < 31:
        widest = min(widest, 2 ** cfg.max_depth)
    return max(widest, 1)


def _chunk_size(n_samples: int, n_feat: int, n_bins: int, n_chan: int,
                cfg: BuildConfig, cell_bytes: int = 4) -> int:
    """Frontier-chunk slot count K, a power of two fixed for the whole
    build: bounded by the histogram budget, the widest possible frontier
    (``2**max_depth``, or ``n_samples`` when unbounded) and a hard cap."""
    per_node = chunk_bytes_per_slot(n_feat, n_bins, n_chan, cell_bytes)
    cap = max(1, cfg.hist_budget_bytes // max(per_node, 1))
    cap = min(cap, cfg.max_frontier_chunk)
    widest = _widest_frontier(n_samples, cfg)
    want = 1 << max(0, math.ceil(math.log2(max(widest, 1))))
    return min(want, 1 << int(math.log2(cap)))


def _table_slots(n_samples: int, cfg: BuildConfig) -> int:
    """Per-level table width for the reroute and the terminal counts: one
    table serves a whole level in one row pass up to ``max_table_slots``."""
    widest = min(_widest_frontier(n_samples, cfg), cfg.max_table_slots)
    return 1 << max(0, math.ceil(math.log2(widest)))


def valid_tiers(tiers, n_slots: int) -> tuple:
    """Positive tiers no wider than the chunk, sorted."""
    return tuple(sorted(s for s in set(tiers) if 0 < s <= n_slots))


def integer_weights(sample_weight) -> bool:
    """True when raw class counts stay integral (no fractional weights)."""
    return sample_weight is None or np.array_equal(
        sample_weight, np.round(sample_weight)
    )


def _env_flag(name: str, choices: tuple) -> str:
    """An "auto"-steering environment knob, read at call time."""
    value = os.environ.get(name, "auto").strip().lower() or "auto"
    if value not in choices:
        raise ValueError(f"{name}={value!r}; one of {choices}")
    return value


def resolve_engine(cfg: BuildConfig) -> str:
    """``"fused"`` or ``"levelwise"``, as ``mpitree_tpu/core/builder.py``
    resolves it (``:808-990``, without the advisor and the leaf-wise
    reroute) and ``mpitree_tpu/core/leafwise_builder.py:527-545`` for a
    ``max_leaf_nodes`` budget: an explicit ``cfg.engine`` wins,
    ``MPITREE_TPU_ENGINE`` steers ``"auto"``, and ``"auto"`` is fused. A
    level-by-level ``task="gbdt"`` build runs levelwise, and asking for
    the fused engine there raises; the leaf-wise engines take every
    task."""
    engine = cfg.engine
    if engine not in ENGINES:
        raise ValueError(f"unknown build engine {engine!r}")
    if engine == "auto":
        engine = _env_flag(ENGINE_ENV, ENGINES)
    if cfg.task == "gbdt" and cfg.max_leaf_nodes is None:
        if cfg.engine == "fused":
            raise ValueError(
                "the fused engine does not implement task='gbdt'; use "
                "engine='auto' or 'levelwise'"
            )
        return "levelwise"
    return "levelwise" if engine == "levelwise" else "fused"


def resolve_hist_subtraction(cfg: BuildConfig, device: torch.device) -> bool:
    """Whether the engines build the larger sibling's histogram as
    ``parent - small``. An explicit ``cfg.hist_subtraction`` wins,
    ``MPITREE_TPU_HIST_SUBTRACTION`` steers ``"auto"``, and ``"auto"`` is
    :data:`SUBTRACTION_AUTO` for the device type. Unlike the JAX package's
    resolution (``:419-506``) exactness needs no check: both histogram
    routes subtract exactly (``ops/histogram.py``), so every task and
    every weight may take it."""
    flag = cfg.hist_subtraction
    if flag not in SUBTRACTION_FLAGS:
        raise ValueError(f"unknown hist_subtraction {flag!r}")
    if flag == "auto":
        flag = _env_flag(SUBTRACTION_ENV, SUBTRACTION_FLAGS)
    if flag == "auto":
        return SUBTRACTION_AUTO.get(torch.device(device).type, False)
    return flag == "on"


class SubtractionCarry(NamedTuple):
    """What a level hands the next for sibling subtraction: its resident
    histograms ``hist`` ((n_chunks * S, F, C, B), raw route sums, slot 0 =
    its first frontier node) and, per node of the next frontier, whether
    it is the smaller sibling (``small``, ties go left) and its parent's
    slot in ``hist`` (``pslot``)."""

    hist: torch.Tensor
    small: torch.Tensor
    pslot: torch.Tensor


def child_carry(hist, n_left, n, parent_rel) -> SubtractionCarry:
    """The carry to the children of the splitting nodes whose winners'
    left weights are ``n_left`` out of ``n`` (tensors in the decision
    buffer's dtype) and whose slots in ``hist`` are ``parent_rel``:
    children come left/right interleaved, the left child the smaller when
    ``n_left * 2 <= n`` (``mpitree_tpu/core/builder.py:1636-1655``)."""
    left_small = n_left * 2.0 <= n
    small = torch.stack([left_small, ~left_small], dim=1).reshape(-1)
    return SubtractionCarry(hist, small,
                            parent_rel.to(torch.int64).repeat_interleave(2))


class FrontierHistograms:
    """One level's chunk histograms, for either engine: each shard's rows
    ordered by slot once a level, then each chunk's ``(S, F, C, B)``
    histogram built on every shard and reduced over the mesh
    (``collective.psum``, the JAX package's ``lax.psum``) onto the lead
    shard; given a ``carry``, the shards accumulate the smaller siblings
    only into a compact ``S/2``-slot histogram, which is reduced first and
    then rebuilt as ``parent - small`` against the reduced carry
    (``histogram.sibling_reconstruct``; JAX's ``reconstruct(lax.psum(h))``,
    ``mpitree_tpu/parallel/collective.py:412``). With ``keep`` the level's
    histograms stay resident on the lead in ``kept`` for the next level's
    carry. ``nids`` holds every shard's node ids."""

    def __init__(self, fit, nids: list, flo: int, fsz: int, S: int,
                 *, carry: SubtractionCarry | None, keep: bool):
        self.fit, self.S = fit, S
        self.n_chunks = -(-fsz // S)
        width = self.n_chunks * S
        dev = fit.dev
        self.carry = carry if carry is not None and S % 2 == 0 else None
        if self.carry is not None:
            self.acc = S // 2
            self.small = torch.ones(width, dtype=torch.bool, device=dev)
            self.small[:fsz] = carry.small
            self.pslot = torch.zeros(width, dtype=torch.int64, device=dev)
            self.pslot[:fsz] = carry.pslot
            # (rel >> 1) = chunk * S/2 + (slot >> 1): one key for the level
            self.keys = [sibling_accumulate_slots(nid, flo, small,
                                                  n_slots=width)
                         for nid, small in zip(nids, fit.to_shards(
                             self.small))]
        else:
            self.acc = S
            self.keys = [(nid - flo).to(torch.int32) for nid in nids]
        self.orders = self.segs = [None] * len(nids)
        if self.acc > hist_kernel.STREAM_MAX_SLOTS:
            # rows of finished leaves and of large siblings (-1) fall
            # outside every segment
            self.orders, self.segs = zip(*(
                hist_kernel.slot_segments(key, self.n_chunks * self.acc)
                for key in self.keys))
        self.kept = None
        if keep and self.n_chunks > 1:
            self.kept = torch.empty(
                (width, fit.F, fit.C, fit.B), device=dev,
                dtype=torch.int64 if fit.fixed else torch.float32)
        self.keep = keep

    def chunk(self, c: int) -> torch.Tensor:
        fit, S, a = self.fit, self.S, self.acc
        h = collective.psum([
            collective.split_hist(
                sh.xb, sh.payload, None, 0, n_slots=a, n_bins=fit.B,
                packed=sh.packed, order=order, feat_bins=fit.feat_bins,
                seg_start=None if seg is None else seg[c * a: c * a + a + 1],
                scale_exp=fit.scale_exp, slot=key - c * a)
            for sh, key, order, seg in zip(fit.shards, self.keys,
                                           self.orders, self.segs)],
            fit.mesh)
        if self.carry is not None:
            sl = slice(c * S, (c + 1) * S)
            h = sibling_reconstruct(h, self.carry.hist, self.pslot[sl],
                                    self.small[sl])
        if self.keep:
            if self.kept is None:
                self.kept = h
            else:
                self.kept[c * S:(c + 1) * S].copy_(h)
        return h


class SlabHistograms:
    """:class:`FrontierHistograms` on a ``(data, feature)`` mesh: one per
    local feature slab (``fit.slabs``), each over its slab's columns and
    reduced over its data axis only; :meth:`chunk` gives the slabs'
    histograms in slab order and ``kept`` their resident ones, so every
    shard subtracts against its own slab (JAX's ``parent_hist`` spec,
    ``(None, feature, None, None)``)."""

    def __init__(self, fit, nids: list, flo: int, fsz: int, S: int,
                 *, carry: SubtractionCarry | None, keep: bool):
        self.parts = [
            FrontierHistograms(
                sl, [nids[j] for j in sl.mesh.local], flo, fsz, S,
                carry=None if carry is None else carry._replace(
                    hist=carry.hist[k]), keep=keep)
            for k, sl in enumerate(fit.slabs)]

    def chunk(self, c: int) -> list:
        return [p.chunk(c) for p in self.parts]

    @property
    def kept(self) -> list:
        return [p.kept for p in self.parts]


def level_histograms(fit, nids: list, flo: int, fsz: int, S: int, *,
                     carry: SubtractionCarry | None, keep: bool):
    """A level's chunk histograms: :class:`SlabHistograms` on a feature
    axis, else :class:`FrontierHistograms`."""
    cls = FrontierHistograms if fit.slabs is None else SlabHistograms
    return cls(fit, nids, flo, fsz, S, carry=carry, keep=keep)


def keep_level(fit, cfg: BuildConfig, use_sub: bool, S: int,
               n_chunks: int) -> bool:
    """Whether a level keeps its histograms for the next level's
    subtraction: on, a width that holds sibling pairs, and every chunk's
    histogram within ``cfg.hist_budget_bytes``
    (``mpitree_tpu/core/builder.py:1185-1264``); on a feature axis each
    shard keeps its slab's."""
    cell = 8 if fit.fixed else 4
    return (use_sub and S >= 2 and S % 2 == 0
            and n_chunks * S * fit.f_local * fit.C * fit.B * cell
            <= cfg.hist_budget_bytes)


def _on_device(a, dtype, dev) -> torch.Tensor:
    """``a`` (numpy, or a tensor already on the card: the fused boosting
    rounds' gradients) as a ``dtype`` tensor on ``dev``."""
    if isinstance(a, torch.Tensor):
        return a.to(device=dev, dtype=dtype)
    np_dtype = np.float32 if dtype == torch.float32 else np.int64
    return torch.as_tensor(np.asarray(a, np_dtype), device=dev)


class _Shard(NamedTuple):
    """One shard's rows of a fit: on its device, the bins (int32 and the
    byte-wide copy), the targets and the payload (0 on padding rows)."""

    dev: torch.device
    xb: torch.Tensor
    packed: torch.Tensor | None
    y: torch.Tensor
    payload: torch.Tensor


def _task_payload(task: str, y, w_d: torch.Tensor, n_classes,
                  dev: torch.device) -> tuple:
    """``(y, payload)`` of one shard's rows on ``dev``: the targets as the
    sweep reads them and the (n, C) histogram payload of ``task``."""
    if task == "gbdt":
        y_d = _on_device(y, torch.float32, dev)
        return y_d, gbdt_payload(y_d, w_d).contiguous()
    if task == "regression":
        y_d = _on_device(y, torch.float32, dev)
        return y_d, moment_payload(y_d, w_d).contiguous()
    y_d = _on_device(y, torch.int64, dev)
    return y_d, class_payload(y_d, w_d, int(n_classes)).contiguous()


class FitInputs:
    """What both engines prepare once per tree: the bins (int32 and the
    byte-wide copy), the payload and its route, the candidate mask, the
    chunk width ``K``, the table width ``U`` and the tiers. A forest
    passes each tree's ``sample_weight`` as a tensor on the device, its
    ``scale_exp`` (the route, decided for every tree at once) and its
    ``candidate_mask``.

    On a ``mesh`` (``parallel/mesh.Mesh``) the rows are sharded
    (``mesh.shard_build_inputs``; ``binned.x_binned`` is the whole matrix
    on the lead shard, ``y`` and ``sample_weight`` every row's) into
    ``shards``, one per local shard, and the route comes from every
    shard's payload (``collective.payload_scale``); ``N``, ``K`` and
    ``U`` are the global row count's, so every shard and process chunks
    alike. ``x_shards`` (a forest's, :func:`shard_matrix`) hands in the
    shards' bins already placed, as a ``StreamedBinnedData`` on ``mesh``
    does (the local shards the streaming ingest placed). Without a mesh, ``shards`` holds the one
    device's rows. The attributes ``xb``, ``packed``, ``y``, ``payload``
    and ``dev`` are the first (lead) shard's.

    On a ``(data, feature)`` mesh each shard holds its rows of one
    ``f_local``-column slab (the features padded to a multiple of the
    feature axis, padding columns without candidates), and ``slabs``
    holds one view per local slab: a FitInputs over the slab's columns,
    its shards and its data-axis sub-mesh, whose histograms, terminal
    sums, ranges and leaf ids reduce over that axis only. ``fmesh`` is
    the feature axis through the lead shard, over which
    :meth:`sweep` merges the slabs' winners
    (``collective.select_global``) and :meth:`reroute` routes the rows
    (``collective.route_psum``). ``K`` is sized from the slab width, as
    the JAX builder sizes it per device (``:816-850``)."""

    def __init__(self, binned: BinnedData, y, cfg: BuildConfig, *,
                 n_classes=None, sample_weight=None, packed=None,
                 feature_mask=None, scale_exp="auto", candidate_mask=None,
                 mesh=None, x_shards=None):
        from mpitree_tpu_torch.parallel.mesh import (
            DATA_AXIS,
            FEATURE_AXIS,
            feature_shards,
            shard_build_inputs,
        )

        if isinstance(binned, StreamedBinnedData) and x_shards is None:
            # a stream placed its shards on the mesh already
            x_shards = shard_matrix(binned, mesh)
        xb = binned.x_binned
        if x_shards is None and not isinstance(xb, torch.Tensor):
            raise TypeError(
                "build_tree needs BinnedData with a tensor x_binned")
        task = cfg.task
        self.mesh = mesh
        # real extents from the dataclass: a streamed matrix's shards
        # carry the mesh's padding
        self.N, self.F = binned.n_samples, binned.n_features
        self.B = binned.n_bins
        self.feat_bins = [int(v) + 1 for v in binned.n_cand]
        self.C = 3 if task in ("regression", "gbdt") else int(n_classes)
        df = 1 if mesh is None else feature_shards(mesh)
        self.f_local = -(-self.F // df)
        if candidate_mask is None:
            cand = binned.candidate_mask()
            if feature_mask is not None:
                cand = cand & np.asarray(feature_mask, bool)[:, None]
            candidate_mask = torch.from_numpy(cand).to(
                xb.device if mesh is None else mesh.lead)
        self.cand_mask = candidate_mask
        self.slabs = self.fmesh = None
        if mesh is None:
            dev = xb.device
            xb = xb.to(torch.int32).contiguous()
            if sample_weight is None:
                w_d = torch.ones(self.N, dtype=torch.float32, device=dev)
            elif isinstance(sample_weight, torch.Tensor):
                w_d = sample_weight.to(torch.float32)
            else:
                w_d = torch.as_tensor(
                    np.asarray(sample_weight, np.float32), device=dev)
            y_d, payload = _task_payload(task, y, w_d, n_classes, dev)
            self.shards = [_Shard(
                dev, xb, pack_for_fit(binned) if packed is None else packed,
                y_d, payload)]
            self._nid0 = [torch.zeros(self.N, dtype=torch.int32,
                                      device=dev)]
            data = None
        else:
            if isinstance(sample_weight, torch.Tensor):
                sample_weight = sample_weight.cpu().numpy()
            if isinstance(y, torch.Tensor):
                y = y.cpu().numpy()
            parts = shard_build_inputs(
                mesh, xb if x_shards is None else None, y, sample_weight,
                cand_mask=candidate_mask.cpu().numpy() if df > 1 else None)
            self.shards, self._nid0 = [], []
            for i, (part, dev) in enumerate(zip(parts, mesh.devices)):
                if x_shards is None:
                    x_i = part["x_binned"].to(torch.int32).contiguous()
                    p_i = (hist_kernel.pack_bins(x_i, self.B)
                           if self.B <= 256 else None)
                else:
                    x_i, p_i = x_shards[i]
                # weighted by the padded weights (1, or 0 on padding rows,
                # which then add to nothing, not even the route's stats)
                y_d, payload = _task_payload(
                    task, part["y"], torch.as_tensor(part["weight"],
                                                     device=dev),
                    n_classes, dev)
                self.shards.append(_Shard(dev, x_i, p_i, y_d, payload))
                self._nid0.append(torch.as_tensor(part["node_id"],
                                                  device=dev))
            # the route's statistics count every row once: over the data
            # axis through the lead (a feature axis repeats the rows)
            data = mesh.axis_mesh(DATA_AXIS, 0)
            if df > 1:
                self.fmesh = mesh.axis_mesh(FEATURE_AXIS, 0)
                self._slab_cand = [p["cand_mask"] for p in parts]
        lead = self.shards[0]
        self.dev, self.xb, self.packed = lead.dev, lead.xb, lead.packed
        self.y, self.payload = lead.y, lead.payload
        # the histogram's route, once per fit: None = the float32 integer
        # route (one device-to-host copy; a boosting round's g/h change
        # every tree); a forest decides every tree's at once
        if isinstance(scale_exp, str):
            scale_exp = collective.payload_scale(
                [self.shards[j].payload for j in
                 (data.local if data is not None else [0])], data,
                fixed=task in ("regression", "gbdt"), n_rows=self.N)
        self.scale_exp = scale_exp
        self.fixed = scale_exp is not None
        # the terminal sums' int64 payload, made for the first terminal
        # level; exponents 0 on the integer route, whose values are
        # integers already
        self.sum_exp = scale_exp if self.fixed else (0,) * self.C
        self._q = None
        self.K = _chunk_size(self.N, self.f_local, self.B, self.C, cfg,
                             cell_bytes=8 if self.fixed else 4)
        self.U = _table_slots(self.N, cfg)
        self.tiers = valid_tiers(cfg.frontier_tiers, self.K)
        if df > 1:
            self.slabs = [self._slab(sub)
                          for sub in mesh.axis_groups(DATA_AXIS)]

    def _slab(self, sub) -> "FitInputs":
        """The view of one local feature slab: its shards (``sub.local``
        on the mesh) over its data-axis sub-mesh ``sub``, its columns'
        bin counts (1 for padding columns) and its candidate slab."""
        from mpitree_tpu_torch.parallel.mesh import FEATURE_AXIS

        view = object.__new__(FitInputs)
        view.__dict__.update(self.__dict__)
        j = sub.local[0]
        fi = self.mesh.coords(j)[self.mesh.axis_names.index(FEATURE_AXIS)]
        lo = fi * self.f_local
        view.mesh, view.slabs, view.fmesh = sub, None, None
        view.block, view.F = fi, self.f_local
        view.shards = [self.shards[i] for i in sub.local]
        view._nid0 = [self._nid0[i] for i in sub.local]
        view.feat_bins = [self.feat_bins[f] if f < self.F else 1
                          for f in range(lo, lo + self.f_local)]
        view.cand_mask = torch.as_tensor(self._slab_cand[j],
                                         device=self.shards[j].dev)
        head = view.shards[0]
        view.dev, view.xb, view.packed = head.dev, head.xb, head.packed
        view.y, view.payload = head.y, head.payload
        view._q = None
        return view

    def width(self, frontier_size: int) -> int:
        """The level's histogram width: the narrowest tier that holds the
        frontier, else the chunk width ``K``."""
        return next((s for s in self.tiers if frontier_size <= s), self.K)

    def root_nids(self) -> list:
        """Every shard's rows at the root: node 0, padding rows at -1
        (the engines never write node ids in place)."""
        return list(self._nid0)

    def to_shards(self, t: torch.Tensor) -> list:
        """A table on the lead shard, on every shard (``collective.to_shards``)."""
        return collective.to_shards(t, self.mesh)

    def _rows(self, nids: list) -> tuple:
        """The view that counts every row once (the lead slab on a
        feature axis, else this) and its shards' node ids."""
        if self.slabs is None:
            return self, nids
        sl = self.slabs[0]
        return sl, [nids[j] for j in sl.mesh.local]

    def sweep(self, hist, lo: int, **kw) -> torch.Tensor:
        """The packed decisions of a chunk from its reduced histogram
        (``collective.split_sweep``, ``kw`` its keywords); on a feature
        axis ``hist`` holds the slabs' histograms, each swept over its
        candidate slab, and the winners merge over the feature axis
        (``collective.select_global``) before packing."""
        if self.slabs is None:
            return collective.split_sweep(hist, self.cand_mask, None, lo,
                                          scale_exp=self.scale_exp, **kw)
        decs = [collective.sweep_decision(
            h, sl.cand_mask, None, lo, scale_exp=self.scale_exp, **kw)
            for h, sl in zip(hist, self.slabs)]
        dec = collective.select_global(decs, self.fmesh, self.f_local,
                                       [sl.block for sl in self.slabs])
        return collective.pack_decision(
            dec, torch.float32 if self.scale_exp is None else torch.float64)

    def node_sums(self, nids, lo: int, hi: int) -> torch.Tensor:
        """(hi - lo, C) float64 payload sums of frontier nodes [lo, hi)
        for a terminal level, one U-slot table at a time, reduced over the
        mesh's data axis; ``nids`` every shard's node ids (a tensor for
        one shard)."""
        fit, nids = self._rows(collective._parts(nids))
        if fit._q is None:
            fit._q = [hist_kernel.quantize(sh.payload, fit.sum_exp)
                      for sh in fit.shards]
        U = fit.U
        return torch.cat([
            collective.node_sums(fit._q, nids, a, n_slots=U,
                                 scale_exp=fit.sum_exp,
                                 mesh=fit.mesh)[: min(U, hi - a)]
            for a in range(lo, hi, U)
        ]).to(self.dev)

    def y_range(self, nids: list, lo: int, n_slots: int) -> torch.Tensor:
        """Regression's purity signal of the ``n_slots`` nodes from ``lo``
        over every shard's rows (``collective.y_range``), on the lead."""
        fit, nids = self._rows(nids)
        return collective.y_range(
            [sh.y for sh in fit.shards], nids,
            [sh.payload[:, 0] for sh in fit.shards], lo, n_slots=n_slots,
            mesh=fit.mesh).to(self.dev)

    def reroute(self, nids: list, lo: int, *tables) -> list:
        """Every shard's rows through one level's split tables (on the
        lead shard, copied to each shard): ``collective.update_node_id``,
        or on a feature axis the owner broadcast
        (``collective.route_psum``)."""
        if self.slabs is not None:
            return collective.route_psum(
                nids, [sh.xb for sh in self.shards], self.mesh, lo,
                *tables, f_local=self.f_local)
        per = [self.to_shards(t) for t in tables]
        return [collective.update_node_id(nid, sh.xb, lo,
                                          *(p[i] for p in per))
                for i, (nid, sh) in enumerate(zip(nids, self.shards))]

    def leaf_ids(self, nids: list) -> np.ndarray:
        """Every row's node as an (N,) int32 numpy array in the caller's
        row order (``collective.gather_rows``: the local shards' ids in
        shard order, padding dropped, across processes one all-reduce)."""
        fit, nids = self._rows(nids)
        return collective.gather_rows(nids, fit.mesh, self.N).cpu().numpy()

    def row_parts(self, full: torch.Tensor) -> list:
        """A per-row tensor of every row (``(N, ...)`` on the lead) cut
        into the shards' rows of a 1-D mesh, padding rows 0
        (``collective.gather_rows``'s inverse)."""
        if self.mesh is None:
            return [full]
        per = self.shards[0].y.shape[0]
        padded = torch.cat([full, full.new_zeros(
            (per * self.mesh.size - self.N,) + full.shape[1:])])
        return [padded[self.mesh.shard_index(k) * per:
                       (self.mesh.shard_index(k) + 1) * per].to(sh.dev)
                for k, sh in enumerate(self.shards)]


def shard_matrix(binned: BinnedData, mesh) -> list:
    """The ``x_shards`` of a :class:`FitInputs` on ``mesh``: per local
    shard its rows' int32 bins (its feature slab on a feature axis) and
    their byte-wide copy, made once for every tree a forest or a boosted
    ensemble grows on that mesh. A ``StreamedBinnedData`` brings its
    shards placed already (``parallel/mesh.check_placed`` holds them to
    ``mesh``); only their byte-wide copies are made here."""
    from mpitree_tpu_torch.parallel.mesh import (
        check_placed,
        shard_build_inputs,
    )

    def packed(x_i):
        return (hist_kernel.pack_bins(x_i, binned.n_bins)
                if binned.n_bins <= 256 else None)

    if isinstance(binned, StreamedBinnedData):
        check_placed(binned, mesh)
        return [(x_i, packed(x_i)) for x_i in binned.x_binned]
    n, F = binned.n_samples, binned.n_features
    out = []
    for part in shard_build_inputs(mesh, binned.x_binned,
                                   np.zeros(n, np.int32), None,
                                   cand_mask=np.zeros((F, 1), bool)):
        x_i = part["x_binned"].to(torch.int32).contiguous()
        out.append((x_i, packed(x_i)))
    return out


def refit_regression_values(tree: TreeArrays, nid_host: np.ndarray,
                            w64: np.ndarray,
                            refit_targets: np.ndarray) -> None:
    """Exact float64 node means and variances from the rows' final nodes,
    in place: ``refit_regression_values``
    (``mpitree_tpu/core/builder.py:591``). The moment histograms pick the
    splits; the leaf and interior values (and the per-node variances) come
    from this host pass. Children have larger ids than their parent, so
    one descending pass rolls the leaf sums up the whole tree."""
    s = np.bincount(nid_host, weights=refit_targets * w64,
                    minlength=tree.n_nodes)
    s2 = np.bincount(nid_host, weights=refit_targets * refit_targets * w64,
                     minlength=tree.n_nodes)
    ww = np.bincount(nid_host, weights=w64, minlength=tree.n_nodes)
    for i in range(tree.n_nodes - 1, 0, -1):
        p = tree.parent[i]
        if p < 0:
            continue  # multi-root buffer (batched refine): roots end rollup
        s[p] += s[i]
        s2[p] += s2[i]
        ww[p] += ww[i]
    mean = s / np.maximum(ww, 1e-300)
    tree.value = mean.astype(np.float32)
    tree.count = mean[:, None].copy()
    tree.impurity = np.maximum(s2 / np.maximum(ww, 1e-300) - mean * mean, 0.0)


class _TreeBuffer:
    """Growable struct-of-arrays node store (host side)."""

    _GROW_FILL = {"feature": -1, "threshold": np.nan, "left": -1,
                  "right": -1, "parent": -1}

    def __init__(self, n_cols: int, count_dtype, value_dtype=np.int32):
        self.cap = 256
        self.n = 0
        self.feature = np.full(self.cap, -1, np.int32)
        self.threshold = np.full(self.cap, np.nan, np.float32)
        self.left = np.full(self.cap, -1, np.int32)
        self.right = np.full(self.cap, -1, np.int32)
        self.parent = np.full(self.cap, -1, np.int32)
        self.depth = np.zeros(self.cap, np.int32)
        self.value = np.zeros(self.cap, value_dtype)
        self.count = np.zeros((self.cap, n_cols), count_dtype)
        self.n_node_samples = np.zeros(self.cap, np.int64)
        self.impurity = np.zeros(self.cap, np.float64)

    def ensure(self, n: int) -> None:
        if n <= self.cap:
            return
        new_cap = max(n, self.cap * 2)
        for name in ("feature", "threshold", "left", "right", "parent",
                     "depth", "value", "count", "n_node_samples", "impurity"):
            old = getattr(self, name)
            new = np.full((new_cap,) + old.shape[1:],
                          self._GROW_FILL.get(name, 0), old.dtype)
            new[: self.cap] = old
            setattr(self, name, new)
        self.cap = new_cap

    def alloc_children(self, parents: np.ndarray, depth: int):
        """Append 2*len(parents) nodes (left/right interleaved); returns ids."""
        m = len(parents)
        base = self.n
        self.ensure(base + 2 * m)
        lefts = base + 2 * np.arange(m, dtype=np.int32)
        rights = lefts + 1
        self.parent[lefts] = parents
        self.parent[rights] = parents
        self.depth[base: base + 2 * m] = depth
        self.n = base + 2 * m
        return lefts, rights

    def finalize(self) -> TreeArrays:
        s = slice(0, self.n)
        return TreeArrays(
            feature=self.feature[s].copy(),
            threshold=self.threshold[s].copy(),
            left=self.left[s].copy(),
            right=self.right[s].copy(),
            parent=self.parent[s].copy(),
            depth=self.depth[s].copy(),
            value=self.value[s].copy(),
            count=self.count[s].copy(),
            n_node_samples=self.n_node_samples[s].copy(),
            impurity=self.impurity[s].copy(),
        )


def pack_for_fit(binned: BinnedData) -> torch.Tensor | None:
    """The byte-wide copy of the binned matrix the histogram kernels read
    (``hist_kernel.pack_bins``), or None when the bins need more than a
    byte. A forest makes it once and hands it to every tree's build."""
    if binned.n_bins > 256:
        return None
    return hist_kernel.pack_bins(binned.x_binned, binned.n_bins)


def new_tree_buffer(task: str, n_classes: int | None,
                    sample_weight) -> _TreeBuffer:
    """The node store of one build, with the JAX package's dtypes: class
    counts int64 (float64 under fractional weights) and int32 majority
    values; regression (and a boosting round) float32 values and one
    float64 count column."""
    if task in ("regression", "gbdt"):
        return _TreeBuffer(1, np.float64, np.float32)
    return _TreeBuffer(
        int(n_classes),
        np.int64 if integer_weights(sample_weight) else np.float64,
    )


def check_task(cfg: BuildConfig) -> None:
    if cfg.task not in TASKS:
        raise ValueError(f"unknown task {cfg.task!r}; one of {TASKS}")
    if cfg.task == "gbdt":
        return
    ok = ("entropy", "gini") if cfg.task == "classification" else (
        "mse", "squared_error")
    if cfg.criterion not in ok:
        raise ValueError(f"unknown {cfg.task} criterion: {cfg.criterion!r}")


def build_tree(binned: BinnedData, y: np.ndarray, *, config: BuildConfig,
               n_classes: int | None = None,
               sample_weight: np.ndarray | None = None,
               packed: torch.Tensor | None = None,
               return_leaf_ids: bool = False,
               refit_targets: np.ndarray | None = None,
               feature_sampler=None,
               feature_mask: np.ndarray | None = None,
               mono_cst: np.ndarray | None = None,
               stats: dict | None = None, mesh=None, x_shards=None,
               snapshot_slot=None):
    """Grow one tree on the device that holds ``binned.x_binned``, or on
    the data ``mesh`` (``parallel/mesh.Mesh``) whose lead shard holds it;
    returns the host struct-of-arrays tree. The engine comes from
    :func:`resolve_engine`: the fused engine
    (``core/fused_builder.build_tree_fused``, same contract) or the
    levelwise loop below.

    ``y`` (N,) int class indices (classification), float32 centred
    targets (regression) or float32 gradients (gbdt, whose
    ``sample_weight`` holds the hessians, 0 outside the round's
    subsample), ``sample_weight`` (N,) float32 or None,
    ``packed`` :func:`pack_for_fit` of ``binned`` (made here when absent).
    ``refit_targets`` (regression): the (N,) float64 targets whose exact
    means :func:`refit_regression_values` writes into the finished tree.
    With ``return_leaf_ids`` returns ``(tree, leaf_ids)``: every row's
    final node as an (N,) int32 numpy array, one copy from the device
    (rows of leaves that stopped early stay parked at their node), which
    the hybrid refine tail reads instead of descending the crown again.
    ``feature_sampler`` (``ops/sampling.NodeFeatureSampler``) samples
    features per node and draws random splits; ``feature_mask`` (F,) bool
    keeps a tree's subspace. ``mono_cst`` (F,) internal monotonicity signs
    (``utils/monotonic.validate_monotonic_cst``; all zero or None means
    unconstrained) gates every split on its child values.

    A ``cfg.max_leaf_nodes`` budget (at least 2) grows the tree best-first
    instead (``core/leafwise_builder.build_tree_leafwise``, the dispatch of
    ``mpitree_tpu/core/builder.py:757-780``), which records its engine,
    frontier and expansions in ``stats``.

    On a ``mesh`` the rows shard over its shards and processes
    (``FitInputs``; ``x_shards``, :func:`shard_matrix` of ``binned`` on
    ``mesh``, hands in the bins already placed), each level's histograms
    reduce over them, and the tree is the one-device tree field for field; ``return_leaf_ids``
    then gives every row's node in the caller's row order. Every process
    of the mesh passes the same ``binned``, ``y`` and weights. On a
    ``(data, feature)`` mesh each shard sweeps its feature slab and the
    winners merge over the feature axis; ``monotonic_cst``, per-node
    sampling and leaf-wise growth raise there, as in the JAX package.

    ``snapshot_slot`` (``resilience.recovery.SnapshotSlot``): the retry
    ladder's handle, which the levelwise engine and the host-stepped
    best-first engine snapshot into and resume from (see the module
    docstring); the fused engines ignore it.
    """
    cfg = config
    check_task(cfg)
    if cfg.max_leaf_nodes is not None:
        if int(cfg.max_leaf_nodes) < 2:
            raise ValueError(
                f"max_leaf_nodes must be >= 2 or None, got "
                f"{cfg.max_leaf_nodes!r}")
        from mpitree_tpu_torch.core.leafwise_builder import (
            build_tree_leafwise,
        )

        return build_tree_leafwise(
            binned, y, config=cfg, n_classes=n_classes,
            sample_weight=sample_weight, packed=packed,
            return_leaf_ids=return_leaf_ids, refit_targets=refit_targets,
            feature_sampler=feature_sampler, feature_mask=feature_mask,
            mono_cst=mono_cst, stats=stats, mesh=mesh, x_shards=x_shards,
            snapshot_slot=snapshot_slot)
    if mesh is not None:
        from mpitree_tpu_torch.parallel.mesh import feature_shards

        if feature_shards(mesh) > 1:
            # the JAX package's refusals (:837-850): the slabs would need
            # mask-aware merges
            if mono_cst is not None and bool(np.any(
                    np.asarray(mono_cst) != 0)):
                raise ValueError("monotonic_cst is not supported on a "
                                 "(data, feature) mesh")
            if feature_sampler is not None and feature_sampler.active:
                raise ValueError("per-node feature sampling is not "
                                 "supported on a (data, feature) mesh")
    kw = dict(config=cfg, n_classes=n_classes, sample_weight=sample_weight,
              packed=packed, return_leaf_ids=return_leaf_ids,
              refit_targets=refit_targets, feature_sampler=feature_sampler,
              feature_mask=feature_mask, mono_cst=mono_cst, mesh=mesh,
              x_shards=x_shards)
    if resolve_engine(cfg) == "fused":
        from mpitree_tpu_torch.core.fused_builder import build_tree_fused

        return build_tree_fused(binned, y, **kw)
    return _build_levelwise(binned, y, stats=stats,
                            snapshot_slot=snapshot_slot, **kw)


def _build_levelwise(binned: BinnedData, y: np.ndarray, *,
                     config: BuildConfig, n_classes, sample_weight, packed,
                     return_leaf_ids, refit_targets, feature_sampler,
                     feature_mask, mono_cst, mesh=None, x_shards=None,
                     stats=None, snapshot_slot=None):
    """The levelwise engine: one host round trip a level; snapshots its
    carry into ``snapshot_slot`` at every level and resumes from a
    pending one (module docstring)."""
    cfg = config
    regression = cfg.task == "regression"
    gbdt = cfg.task == "gbdt"
    lr_on = snapshot_slot is not None and resolve_level_retry()
    resume = snapshot_slot.take("level") if lr_on else None
    sampling = feature_sampler is not None and feature_sampler.active
    mono = mono_cst is not None and bool(np.any(np.asarray(mono_cst) != 0))
    if resume is None:
        fit = FitInputs(binned, y, cfg, n_classes=n_classes,
                        sample_weight=sample_weight, packed=packed,
                        feature_mask=feature_mask, mesh=mesh,
                        x_shards=x_shards)
        nids = fit.root_nids()
        keys = feature_sampler.key_store() if sampling else None
        bounds = BoundsStore() if mono else None
        tree = new_tree_buffer(cfg.task, fit.C, sample_weight)
        tree.ensure(1)
        tree.n = 1
        frontier_lo, frontier_size, depth = 0, 1, 0
    else:
        # the level's node writes are rewritten with the same values, and
        # tree.n un-allocates the failed level's children
        fit, nids, keys, bounds = (resume["fit"], resume["nids"],
                                   resume["keys"], resume["bounds"])
        tree = resume["tree"]
        tree.n = resume["tree_n"]
        frontier_lo, frontier_size, depth = resume["frontier"]
    dev, N, F, C = fit.dev, fit.N, fit.F, fit.C
    fixed, scale_exp, U = fit.fixed, fit.scale_exp, fit.U
    if mono:
        cst32 = np.ascontiguousarray(mono_cst, np.int32)
        cst_d = torch.from_numpy(cst32).to(dev)
    use_sub = resolve_hist_subtraction(cfg, dev)
    carry = None

    def to_dev(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(dev)

    def sample_args(lo: int, take: int, S: int) -> dict:
        """The node masks and draws of the S-slot chunk at ``lo`` holding
        ``take`` nodes (padded slots: every feature, draw 0), as
        ``mpitree_tpu/core/builder.py:1155-1166``."""
        if not sampling:
            return {}
        nmask = np.ones((S, F), bool)
        nmask[:take] = keys.masks(lo, lo + take)
        out = {"node_mask": to_dev(nmask)}
        if feature_sampler.random_split:
            draws = np.zeros((S, F), np.int64)
            draws[:take] = keys.draws(lo, lo + take)
            out["draws"] = to_dev(draws)
        return out

    def mono_args(lo: int, take: int, S: int) -> dict:
        """The signs and the S-slot chunk's bound windows (padded slots
        unbounded), as ``mpitree_tpu/core/builder.py:1167-1168``."""
        if not mono:
            return {}
        lo_w, hi_w = bounds.window(lo, take, S)
        return {"mono_cst": cst_d, "mono_lo": to_dev(lo_w),
                "mono_hi": to_dev(hi_w)}

    while frontier_size > 0:
        if lr_on:
            snapshot_slot.save("level", depth, dict(
                fit=fit, nids=nids, keys=keys, bounds=bounds, tree=tree,
                tree_n=tree.n, frontier=(frontier_lo, frontier_size, depth)))
        if stats is not None:
            stats["level_dispatches"] = stats.get("level_dispatches", 0) + 1
        chaos.step("level", level=depth)
        terminal = cfg.max_depth is not None and depth == cfg.max_depth
        hi = frontier_lo + frontier_size
        carry_in, carry = carry, None
        if terminal:
            chaos.step("counts_dispatch")
            dec = {"counts": fit.node_sums(nids, frontier_lo, hi).cpu().numpy()}
        else:
            S = fit.width(frontier_size)
            n_chunks = -(-frontier_size // S)
            keep = keep_level(fit, cfg, use_sub, S, n_chunks)
            level = level_histograms(fit, nids, frontier_lo, frontier_size,
                                     S, carry=carry_in, keep=keep)

            def split_chunk(c, lo):
                chaos.step("split_dispatch")
                return fit.sweep(
                    level.chunk(c), lo, criterion=cfg.criterion,
                    min_child_weight=cfg.min_child_weight, task=cfg.task,
                    reg_lambda=cfg.reg_lambda,
                    min_leaf_rows=cfg.min_leaf_rows,
                    yr=fit.y_range(nids, lo, S) if regression else None,
                    **sample_args(lo, min(S, hi - lo), S),
                    **mono_args(lo, min(S, hi - lo), S),
                )[: min(S, hi - lo)]

            decisions = torch.cat([
                split_chunk(c, lo)
                for c, lo in enumerate(range(frontier_lo, hi, S))
            ])
            if cfg.debug:
                assert_replicated(decisions, fit.mesh, what=f"depth {depth}")
            dec = collective.unpack_decision(
                decisions.cpu().numpy(), n_counts=C, y_range=regression,
                mono=mono)

        ids = frontier_lo + np.arange(frontier_size)
        # (frontier, C) class counts, integer-valued f32 from the integer
        # route's sweep, float64 from the fixed-point sweep and from every
        # terminal level; regression's moments; gbdt's (count, G, H)
        counts = dec["counts"]
        if gbdt:
            n = counts[:, 0]
            # the raw Newton value and structure score; the boosting loop
            # refits both in float64 from the rows' final nodes
            denom = np.maximum(counts[:, 2] + cfg.reg_lambda, 1e-12)
            value = (-counts[:, 1] / denom).astype(np.float32)
            node_imp = 0.5 * counts[:, 1] * counts[:, 1] / denom
        elif regression:
            n = counts[:, 0]
            value = (counts[:, 1] / np.maximum(counts[:, 0], 1.0)).astype(
                np.float32)
            node_imp = moment_node_impurity(counts)
        else:
            n = counts.sum(axis=1)
            value = counts.argmax(axis=1).astype(np.int32)
            node_imp = class_node_impurity(counts, cfg.criterion)
        if terminal:
            stop = np.ones(frontier_size, bool)
        else:
            if gbdt:
                # no purity for gradients: a node with no gain stops at
                # the min_split_gain gate (or constant / inf cost)
                pure = np.zeros(frontier_size, bool)
            elif regression:
                pure = dec["y_range"] <= 0.0
            else:
                pure = (counts > 0).sum(axis=1) <= 1
            stop = (
                pure | dec["constant"] | (n < cfg.min_samples_split)
                | np.isinf(dec["cost"])
            )
            if cfg.min_decrease_scaled > 0.0:
                # the fixed-point route's float64 cost against the host
                # tier's node impurity, as the JAX package's host tier
                # compares them; the integer route as its device engine
                imp = node_imp if fixed and cfg.task == "classification" \
                    else dec["impurity"]
                with np.errstate(invalid="ignore"):
                    stop |= (
                        n * (imp - dec["cost"]) < cfg.min_decrease_scaled
                    )
            if gbdt and cfg.min_split_gain > 0.0:
                # impurity - cost is the Newton gain, in float32 as the
                # JAX package's float32 decision buffer holds both
                gain = (dec["impurity"].astype(np.float32)
                        - dec["cost"].astype(np.float32))
                with np.errstate(invalid="ignore"):
                    stop |= gain < np.float32(cfg.min_split_gain)
        tree.feature[ids] = (
            -1 if terminal
            else np.where(stop, -1, dec["feature"]).astype(np.int32)
        )
        tree.value[ids] = value
        tree.n_node_samples[ids] = n.astype(np.int64)
        # regression's and gbdt's float32-accuracy stats: the refit
        # overwrites them
        if regression or gbdt:
            tree.count[ids, 0] = value
        else:
            tree.count[ids] = counts.astype(tree.count.dtype)
        tree.impurity[ids] = node_imp

        split_ids = ids[~stop]
        if len(split_ids):
            feat = dec["feature"][~stop].astype(np.int32)
            bins = dec["bin"][~stop].astype(np.int32)
            tree.threshold[split_ids] = binned.thresholds[feat, bins]
            lefts, rights = tree.alloc_children(
                split_ids.astype(np.int32), depth + 1
            )
            tree.left[split_ids] = lefts
            tree.right[split_ids] = rights
            if sampling:
                keys.assign_children(split_ids, lefts, rights, tree.n)
            if mono:
                bounds.assign_children(
                    split_ids, lefts, rights, dec["v_left"][~stop],
                    dec["v_right"][~stop], cst32[feat], tree.n)
            if not terminal and keep:
                carry = child_carry(
                    level.kept, to_dev(dec["n_left"][~stop]),
                    to_dev(n[~stop]), to_dev(split_ids - frontier_lo))

            # Reroute: one full-row pass per U-slot table (normally one).
            is_split_full = ~stop
            lr = np.zeros(frontier_size, np.int32)
            rr = np.zeros(frontier_size, np.int32)
            lr[is_split_full] = lefts
            rr[is_split_full] = rights
            for lo in range(frontier_lo, hi, U):
                take = min(U, hi - lo)
                sl = slice(lo - frontier_lo, lo - frontier_lo + take)
                if not is_split_full[sl].any():
                    continue
                is_split = np.zeros(U, bool)
                feat_t = np.zeros(U, np.int64)
                bin_t = np.zeros(U, np.int32)
                left_t = np.zeros(U, np.int32)
                right_t = np.zeros(U, np.int32)
                is_split[:take] = is_split_full[sl]
                feat_t[:take] = np.where(is_split_full[sl],
                                         dec["feature"][sl], 0)
                bin_t[:take] = np.where(is_split_full[sl], dec["bin"][sl], 0)
                left_t[:take] = lr[sl]
                right_t[:take] = rr[sl]
                chaos.step("update_dispatch")
                nids = fit.reroute(
                    nids, lo, to_dev(is_split), to_dev(feat_t),
                    to_dev(bin_t), to_dev(left_t), to_dev(right_t),
                )

        frontier_lo = hi
        frontier_size = 2 * len(split_ids)
        depth += 1

    if lr_on:
        # built: a later failure restarts rather than resuming a finished
        # build (and the snapshot's device tensors are released)
        snapshot_slot.clear()
    out = tree.finalize()
    leaf_ids = None
    if regression and refit_targets is not None:
        leaf_ids = fit.leaf_ids(nids)
        w64 = (np.ones(N) if sample_weight is None
               else np.asarray(sample_weight)).astype(np.float64)
        refit_regression_values(out, leaf_ids, w64,
                                np.asarray(refit_targets, np.float64))
    if return_leaf_ids:
        return out, fit.leaf_ids(nids) if leaf_ids is None else leaf_ids
    return out

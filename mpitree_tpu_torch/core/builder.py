"""Breadth-first, level-synchronous tree construction on one device.

Counterpart of the levelwise engine of ``mpitree_tpu/core/builder.py``
(``build_tree``, ``:703``; its loop from ``:980``). Each level of the tree
is grown with a few device steps and one host round trip:

1. the rows are ordered by node once (``hist_kernel.slot_segments``), and
   for every frontier chunk :func:`collective.split_step` builds the
   ``(S, F, C, B)`` histogram (the Hopper kernel family on CUDA, which
   reads each chunk's rows through that order and the fit's byte-wide copy
   of the bins) and picks the best split per node; the packed decisions of
   all chunks come to the host in one copy;
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

Two tasks (``BuildConfig.task``): classification (class counts) and
regression (the moments ``(w, w*y, w*y^2)`` of targets the estimator
centred in float32, then the exact float64 leaf means of
:func:`refit_regression_values`). The payload picks the histogram's route
once per fit (``ops/histogram.payload_scale``): class counts with integer
weights take the float32 integer route, every other payload (fractional
weights, every regression) the int64 fixed-point route, whose sums are
exact and order-independent, so the card's tree equals the CPU's and, for
fractional weights, the exact float64 counts of the JAX package's host
tier.

Not in this engine (see ``ROADMAP.md``): sibling subtraction, the fused
single-program engine, sampling, monotonic constraints, gbdt rounds, the
resilience snapshot and the observability layer.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from mpitree_tpu_torch.core.tree_struct import TreeArrays
from mpitree_tpu_torch.ops import hist_kernel
from mpitree_tpu_torch.ops.binning import BinnedData
from mpitree_tpu_torch.ops.hist_kernel import fixed_point_exponents
from mpitree_tpu_torch.ops.histogram import (
    class_payload,
    moment_payload,
    payload_scale,
)
from mpitree_tpu_torch.parallel import collective
from mpitree_tpu_torch.utils.importances import (
    class_node_impurity,
    moment_node_impurity,
)

TASKS = ("classification", "regression")


@dataclasses.dataclass(frozen=True)
class BuildConfig:
    task: str = "classification"  # classification | regression
    # entropy | gini (classification); mse (regression)
    criterion: str = "entropy"
    max_depth: int | None = None
    min_samples_split: int = 2
    # Absolute weight floor for each side of a split (sklearn's
    # min_weight_fraction_leaf / min_samples_leaf, resolved by the
    # estimator); 0.0 = unconstrained.
    min_child_weight: float = 0.0
    # sklearn's min_impurity_decrease pre-scaled by the total fit weight:
    # a split stops when n_t * (imp_t - cost_t) < this value.
    min_decrease_scaled: float = 0.0


HIST_BUDGET_BYTES = 4 << 30  # device memory for one histogram chunk
MAX_FRONTIER_CHUNK = 4096
MAX_TABLE_SLOTS = 1 << 17  # width of per-level update/counts tables
# Histogram widths narrower than the chunk: a frontier that fits tier S
# runs an S-slot histogram and sweep instead of the K-slot one. Tier 1 is
# the root, the one width the histogram's unsorted route serves
# (ops/hist_kernel.py).
FRONTIER_TIERS = (1, 8, 64, 128, 512)


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
    cap = max(1, HIST_BUDGET_BYTES // max(per_node, 1))
    cap = min(cap, MAX_FRONTIER_CHUNK)
    widest = _widest_frontier(n_samples, cfg)
    want = 1 << max(0, math.ceil(math.log2(max(widest, 1))))
    return min(want, 1 << int(math.log2(cap)))


def _table_slots(n_samples: int, cfg: BuildConfig) -> int:
    """Per-level table width for the reroute and the terminal counts: one
    table serves a whole level in one row pass up to ``MAX_TABLE_SLOTS``."""
    widest = min(_widest_frontier(n_samples, cfg), MAX_TABLE_SLOTS)
    return 1 << max(0, math.ceil(math.log2(widest)))


def valid_tiers(tiers, n_slots: int) -> tuple:
    """Positive tiers no wider than the chunk, sorted."""
    return tuple(sorted(s for s in set(tiers) if 0 < s <= n_slots))


def integer_weights(sample_weight) -> bool:
    """True when raw class counts stay integral (no fractional weights)."""
    return sample_weight is None or np.array_equal(
        sample_weight, np.round(sample_weight)
    )


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
    values; regression float32 means and one float64 count column."""
    if task == "regression":
        return _TreeBuffer(1, np.float64, np.float32)
    return _TreeBuffer(
        int(n_classes),
        np.int64 if integer_weights(sample_weight) else np.float64,
    )


def check_task(cfg: BuildConfig) -> None:
    if cfg.task not in TASKS:
        raise ValueError(f"unknown task {cfg.task!r}; one of {TASKS}")
    ok = ("entropy", "gini") if cfg.task == "classification" else (
        "mse", "squared_error")
    if cfg.criterion not in ok:
        raise ValueError(f"unknown {cfg.task} criterion: {cfg.criterion!r}")


def build_tree(binned: BinnedData, y: np.ndarray, *, config: BuildConfig,
               n_classes: int | None = None,
               sample_weight: np.ndarray | None = None,
               packed: torch.Tensor | None = None,
               return_leaf_ids: bool = False,
               refit_targets: np.ndarray | None = None):
    """Grow one tree level by level on the device that holds
    ``binned.x_binned``; returns the host struct-of-arrays tree.

    ``y`` (N,) int class indices (classification) or float32 centred
    targets (regression), ``sample_weight`` (N,) float32 or None,
    ``packed`` :func:`pack_for_fit` of ``binned`` (made here when absent).
    ``refit_targets`` (regression): the (N,) float64 targets whose exact
    means :func:`refit_regression_values` writes into the finished tree.
    With ``return_leaf_ids`` returns ``(tree, leaf_ids)``: every row's
    final node as an (N,) int32 numpy array, one copy from the device
    (rows of leaves that stopped early stay parked at their node), which
    the hybrid refine tail reads instead of descending the crown again.
    """
    cfg = config
    check_task(cfg)
    regression = cfg.task == "regression"
    xb = binned.x_binned
    if not isinstance(xb, torch.Tensor):
        raise TypeError("build_tree needs BinnedData with a tensor x_binned")
    dev = xb.device
    xb = xb.to(torch.int32).contiguous()
    N, F = xb.shape
    B = binned.n_bins
    if packed is None:
        packed = pack_for_fit(binned)
    feat_bins = [int(v) + 1 for v in binned.n_cand]

    w_d = (torch.ones(N, dtype=torch.float32, device=dev)
           if sample_weight is None
           else torch.from_numpy(np.asarray(sample_weight, np.float32)).to(dev))
    if regression:
        C = 3
        y_d = torch.from_numpy(np.asarray(y, np.float32)).to(dev)
        payload = moment_payload(y_d, w_d).contiguous()
    else:
        C = int(n_classes)
        y_d = torch.from_numpy(np.asarray(y, np.int64)).to(dev)
        payload = class_payload(
            y_d, None if sample_weight is None else w_d, C
        ).contiguous()
    # the histogram's route, once per fit: None = the float32 integer route
    scale_exp = (fixed_point_exponents(payload) if regression
                 else payload_scale(payload))
    fixed = scale_exp is not None
    # the terminal sums' int64 payload, made for the first terminal level;
    # exponents 0 on the integer route, whose values are integers already
    sum_exp = scale_exp if fixed else (0,) * C
    q = None
    nid = torch.zeros(N, dtype=torch.int32, device=dev)
    cand_mask = torch.from_numpy(binned.candidate_mask()).to(dev)

    K = _chunk_size(N, F, B, C, cfg, cell_bytes=8 if fixed else 4)
    U = _table_slots(N, cfg)
    tiers = valid_tiers(FRONTIER_TIERS, K)
    tree = new_tree_buffer(cfg.task, C, sample_weight)
    tree.ensure(1)
    tree.n = 1

    def to_dev(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(dev)

    frontier_lo, frontier_size, depth = 0, 1, 0
    while frontier_size > 0:
        terminal = cfg.max_depth is not None and depth == cfg.max_depth
        hi = frontier_lo + frontier_size
        if terminal:
            if q is None:
                q = hist_kernel.quantize(payload, sum_exp)
            parts = [collective.node_sums(
                q, nid, lo, n_slots=U, scale_exp=sum_exp)
                for lo in range(frontier_lo, hi, U)]
            counts = torch.cat([p[: min(U, hi - lo)] for p, lo in zip(
                parts, range(frontier_lo, hi, U))])
            dec = {"counts": counts.cpu().numpy()}
        else:
            S = next((s for s in tiers if frontier_size <= s), K)
            order = seg = None
            if S > hist_kernel.STREAM_MAX_SLOTS:
                # one sort a level, shared by its chunks; rows parked in
                # finished leaves fall outside every segment
                order, seg = hist_kernel.slot_segments(
                    nid - frontier_lo, math.ceil(frontier_size / S) * S)
            decisions = torch.cat([
                collective.split_step(
                    xb, payload, nid, cand_mask, lo, n_slots=S, n_bins=B,
                    criterion=cfg.criterion,
                    min_child_weight=cfg.min_child_weight, packed=packed,
                    order=order, feat_bins=feat_bins,
                    seg_start=None if seg is None else seg[
                        lo - frontier_lo: lo - frontier_lo + S + 1],
                    scale_exp=scale_exp, task=cfg.task, y=y_d,
                )[: min(S, hi - lo)]
                for lo in range(frontier_lo, hi, S)
            ])
            dec = collective.unpack_decision(decisions.cpu().numpy(),
                                             n_counts=C)

        ids = frontier_lo + np.arange(frontier_size)
        # (frontier, C) class counts, integer-valued f32 from the integer
        # route's sweep, float64 from the fixed-point sweep and from every
        # terminal level; regression's moments
        counts = dec["counts"]
        if regression:
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
            pure = (dec["y_range"] <= 0.0 if regression
                    else (counts > 0).sum(axis=1) <= 1)
            stop = (
                pure | dec["constant"] | (n < cfg.min_samples_split)
                | np.isinf(dec["cost"])
            )
            if cfg.min_decrease_scaled > 0.0:
                # the fixed-point route's float64 cost against the host
                # tier's node impurity, as the JAX package's host tier
                # compares them; the integer route as its device engine
                imp = node_imp if fixed and not regression \
                    else dec["impurity"]
                with np.errstate(invalid="ignore"):
                    stop |= (
                        n * (imp - dec["cost"]) < cfg.min_decrease_scaled
                    )
        tree.feature[ids] = (
            -1 if terminal
            else np.where(stop, -1, dec["feature"]).astype(np.int32)
        )
        tree.value[ids] = value
        tree.n_node_samples[ids] = n.astype(np.int64)
        # regression's float32-accuracy stats: the refit overwrites them
        if regression:
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
                nid = collective.update_node_id(
                    nid, xb, lo, to_dev(is_split), to_dev(feat_t),
                    to_dev(bin_t), to_dev(left_t), to_dev(right_t),
                )

        frontier_lo = hi
        frontier_size = 2 * len(split_ids)
        depth += 1

    out = tree.finalize()
    leaf_ids = None
    if regression and refit_targets is not None:
        leaf_ids = nid.cpu().numpy()
        w64 = (np.ones(N) if sample_weight is None
               else np.asarray(sample_weight)).astype(np.float64)
        refit_regression_values(out, leaf_ids, w64,
                                np.asarray(refit_targets, np.float64))
    if return_leaf_ids:
        return out, nid.cpu().numpy() if leaf_ids is None else leaf_ids
    return out

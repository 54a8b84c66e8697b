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

Three tasks (``BuildConfig.task``): classification (class counts),
regression (the moments ``(w, w*y, w*y^2)`` of targets the estimator
centred in float32, then the exact float64 leaf means of
:func:`refit_regression_values`) and ``"gbdt"``, one Newton boosting
round (``y`` carries the rows' float32 gradients, ``sample_weight`` their
hessians; the ``(count, g, h)`` payload, the Newton sweep, the stopping
rules of ``mpitree_tpu/core/builder.py:1465-1517``; the boosting loop
refits every node's value in float64). The payload picks the histogram's
route once per fit (``ops/histogram.payload_scale``): class counts with
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

Not in this engine (see ``ROADMAP.md``): sibling subtraction, the fused
single-program engine (and with it the fused boosting rounds), the
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
    gbdt_payload,
    moment_payload,
    payload_scale,
)
from mpitree_tpu_torch.parallel import collective
from mpitree_tpu_torch.utils.importances import (
    class_node_impurity,
    moment_node_impurity,
)
from mpitree_tpu_torch.utils.monotonic import BoundsStore

TASKS = ("classification", "regression", "gbdt")


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
               mono_cst: np.ndarray | None = None):
    """Grow one tree level by level on the device that holds
    ``binned.x_binned``; returns the host struct-of-arrays tree.

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
    """
    cfg = config
    check_task(cfg)
    regression = cfg.task == "regression"
    gbdt = cfg.task == "gbdt"
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
    if gbdt:
        C = 3
        y_d = torch.from_numpy(np.asarray(y, np.float32)).to(dev)
        payload = gbdt_payload(y_d, w_d).contiguous()
    elif regression:
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
    # (one device-to-host copy; a boosting round's g/h change every tree)
    scale_exp = (fixed_point_exponents(payload) if regression or gbdt
                 else payload_scale(payload))
    fixed = scale_exp is not None
    # the terminal sums' int64 payload, made for the first terminal level;
    # exponents 0 on the integer route, whose values are integers already
    sum_exp = scale_exp if fixed else (0,) * C
    q = None
    nid = torch.zeros(N, dtype=torch.int32, device=dev)
    cand = binned.candidate_mask()
    if feature_mask is not None:
        cand = cand & np.asarray(feature_mask, bool)[:, None]
    cand_mask = torch.from_numpy(cand).to(dev)
    sampling = feature_sampler is not None and feature_sampler.active
    keys = feature_sampler.key_store() if sampling else None
    mono = mono_cst is not None and bool(np.any(np.asarray(mono_cst) != 0))
    if mono:
        cst32 = np.ascontiguousarray(mono_cst, np.int32)
        cst_d = torch.from_numpy(cst32).to(dev)
        bounds = BoundsStore()

    K = _chunk_size(N, F, B, C, cfg, cell_bytes=8 if fixed else 4)
    U = _table_slots(N, cfg)
    tiers = valid_tiers(FRONTIER_TIERS, K)
    tree = new_tree_buffer(cfg.task, C, sample_weight)
    tree.ensure(1)
    tree.n = 1

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
                    reg_lambda=cfg.reg_lambda,
                    min_leaf_rows=cfg.min_leaf_rows,
                    **sample_args(lo, min(S, hi - lo), S),
                    **mono_args(lo, min(S, hi - lo), S),
                )[: min(S, hi - lo)]
                for lo in range(frontier_lo, hi, S)
            ])
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

"""The fused engine: the whole tree stays on the device while it grows.

Counterpart of ``mpitree_tpu/core/fused_builder.py``. The JAX package
compiles the build into one ``lax.while_loop`` (``:114-697``); PyTorch
launches every operation from the host, which needs a host-side shape per
launch. So the level loop runs on the host, but every piece of tree state
lives on the device at fixed capacity (:func:`_node_capacity`, plus ``K``
slots of slack for the last chunk's windows, ``:180-184``): feature, bin,
counts, parent, left, the rows' node ids, the sampling keys, the
monotonic bounds, the smaller-sibling mask and the parent histograms. Per
level the host reads one 4-byte value, the number of splitting nodes,
which sizes the next level's launches; the stop rules, the child
allocation, the keys, the bounds and the reroute stay on the device. The
host receives the finished arrays once (:func:`_finalize_tree`).

A level (``level_body``, ``:385-653``):

1. the tier chain (``:500-510``): the narrowest frontier tier that holds
   the level, else ``K``-slot chunks (``core/builder.FitInputs.width``);
2. per chunk, the histogram (directly, or by sibling subtraction against
   the carried parent histograms: ``core/builder.FrontierHistograms``,
   shared with the levelwise engine) and the split sweep
   (``parallel/collective.split_sweep``), into the levelwise engine's
   packed decision buffer, which stays on the device;
3. the stop rules and the winners' pieces, in the buffer's dtype, as the
   levelwise engine computes them on the host, so both engines grow the
   same tree bit for bit (regression too: both take the fixed-point
   route);
4. child allocation over the whole frontier (``alloc_chunk``,
   ``:545-614``): ranks by ``cumsum``, children left/right interleaved in
   frontier order, non-splitting lanes scattered into two dump slots;
   children inherit keys (``ops/sampling.child_keys_dev``), bounds
   (``utils/monotonic.child_bounds_dev``) and the smaller-sibling flag;
5. the reroute (``:619-641``, ``collective.update_node_id`` over the
   frontier).

:func:`build_forest_fused` (``:1094``) grows T trees in sequence in one
call on one device from stacked (T, N) weights and (T, F, B) candidate
masks, decides every tree's histogram route with one copy, and copies the
finished trees to the host once; on a mesh it shards the trees over a
``(tree, data)`` mesh and exchanges them (``_make_forest_fn``,
``:758-860``). :func:`build_tree_fused` also grows a tree on a data mesh
(``_make_fused_fn`` with ``psum_axis=DATA_AXIS``, ``:699-756``): the tree
state stays on the lead shard, each shard keeps its rows' node ids, every
chunk's histogram reduces over the mesh
(``core/builder.FrontierHistograms``) and the reroute's split tables are
copied to the shards; still one frontier read a level in each process.
On a ``(data, feature)`` mesh each shard sweeps its slab, the winners
merge over the feature axis and the rows route by the owner broadcast
(``core/builder.FitInputs.sweep``/``reroute``). ``task="gbdt"`` runs the
levelwise engine (the fused boosting rounds grow best-first trees,
``boosting/fused_rounds.py``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from mpitree_tpu_torch.core.builder import (
    BuildConfig,
    FitInputs,
    SubtractionCarry,
    check_task,
    evidence_shape,
    integer_weights,
    keep_level,
    level_histograms,
    note_subtraction,
    refit_regression_values,
    resolve_hist_subtraction,
)
from mpitree_tpu_torch.core.tree_struct import TreeArrays
from mpitree_tpu_torch.obs import accounting as obs_acct
from mpitree_tpu_torch.ops import hist_kernel
from mpitree_tpu_torch.ops.binning import StreamedBinnedData
from mpitree_tpu_torch.ops.sampling import (
    child_keys_dev,
    node_draws_dev,
    node_masks_dev,
)
from mpitree_tpu_torch.parallel import collective
from mpitree_tpu_torch.parallel.mesh import Mesh
from mpitree_tpu_torch.utils.importances import (
    class_node_impurity,
    moment_node_impurity,
)
from mpitree_tpu_torch.utils.monotonic import child_bounds_dev
from mpitree_tpu_torch.utils.profiling import PhaseTimer, assert_replicated

# One per level of every fused build: the host's reads of the frontier
# size, the engine's only device-to-host copies before its results.
frontier_reads = 0


def _node_capacity(n_samples: int, max_depth) -> int:
    """Upper bound on the nodes a build allocates, rounded up to a power
    of two (``mpitree_tpu/core/fused_builder.py:83``): every split has two
    non-empty sides, so ``min(2**(max_depth + 1) - 1, 2N - 1)``."""
    cap = 2 * max(n_samples, 1) - 1
    if max_depth is not None and max_depth < 31:
        cap = min(cap, 2 ** (max_depth + 1) - 1)
    return 1 << max(0, math.ceil(math.log2(max(cap, 1))))


def _sampler_statics(feature_sampler, n_features: int):
    """``(sample_k, random_split, root_key)`` of a NodeFeatureSampler
    (``:97``): ``sample_k`` None when every node keeps every feature,
    ``root_key`` the tree's uint32 path-key seed as an int."""
    if feature_sampler is None or not feature_sampler.active:
        return None, False, 0
    k = feature_sampler.k
    return (k if k < n_features else None,
            bool(feature_sampler.random_split),
            int(feature_sampler.root_key()))


def _row_sum(x: torch.Tensor) -> torch.Tensor:
    """Row sums of ``x`` (S, C) in numpy's order for ``x.sum(axis=1)``
    (its pairwise sum: a left fold below 8 entries, eight interleaved
    partial sums up to 128, halves beyond), so a float64 row sum on the
    device equals the levelwise engine's host sum bit for bit."""
    cols = [x[:, i] for i in range(x.shape[1])]

    def pairwise(a: list) -> torch.Tensor:
        n = len(a)
        if n < 8:
            res = torch.zeros_like(x[:, 0])
            for v in a:
                res = res + v
            return res
        if n <= 128:
            r = list(a[:8])
            i = 8
            while i < n - n % 8:
                r = [r[j] + a[i + j] for j in range(8)]
                i += 8
            res = ((r[0] + r[1]) + (r[2] + r[3])) + ((r[4] + r[5])
                                                     + (r[6] + r[7]))
            for v in a[i:]:
                res = res + v
            return res
        n2 = n // 2
        n2 -= n2 % 8
        return pairwise(a[:n2]) + pairwise(a[n2:])

    return pairwise(cols)


def _class_node_impurity_dev(counts: torch.Tensor,
                             criterion: str) -> torch.Tensor:
    """``utils/importances.class_node_impurity`` on float64 tensors, in
    its order of operations; the fixed-point route's
    ``min_impurity_decrease`` stop compares against it, as the levelwise
    engine compares against the host's."""
    n = _row_sum(counts)[:, None]
    p = counts / n.clamp_min(1.0)
    if criterion == "gini":
        return torch.where(n[:, 0] > 0, 1.0 - _row_sum(p * p),
                           torch.zeros_like(n[:, 0]))
    t = torch.where(counts > 0, p * torch.log2(p.clamp_min(1e-300)),
                    torch.zeros_like(p))
    return -_row_sum(t)


class _Grown(NamedTuple):
    """One tree as it lies on the device when its build ends."""

    n_nodes: int
    levels: list  # (first node, frontier size) per depth
    ints: torch.Tensor  # (4, n_nodes) int32: feature, bin, left, parent
    counts: torch.Tensor  # (n_nodes, C) float64
    nids: list  # every shard's (n,) int32 final node of each row


def _grow(fit: FitInputs, cfg: BuildConfig, *, use_sub: bool,
          sampler=None, mono_cst=None, sizes=None) -> _Grown:
    """Grow one tree with every piece of its state on the device; the host
    reads one frontier size a level (``frontier_reads``). ``sizes`` (a
    measurement's oracle, ``chip_smoke.py`` phase 24: the frontier sizes
    of an earlier build of the same tree, ``[s for _, s in levels]``)
    replaces those reads, so the level loop runs without a
    synchronisation and its cost can be measured."""
    global frontier_reads
    dev, N, F, C, K = fit.dev, fit.N, fit.F, fit.C, fit.K
    regression = cfg.task == "regression"
    sample_k, random_split, root_key = _sampler_statics(sampler, F)
    sampling = sampler is not None and sampler.active
    mono = mono_cst is not None and bool(np.any(np.asarray(mono_cst) != 0))
    # K slots of slack: a chunk's S-slot windows of keys and bounds may
    # reach past the last node; the two slots after them take the
    # allocation's scatter from lanes that do not split
    cap = _node_capacity(N, cfg.max_depth) + K
    dump = cap

    def full(value, dtype, *shape):
        return torch.full((cap + 2,) + shape, value, dtype=dtype, device=dev)

    feat_a = full(-1, torch.int32)
    bin_a = full(0, torch.int32)
    left_a = full(-1, torch.int32)
    parent_a = full(-1, torch.int32)
    counts_a = full(0.0, torch.float64, C)
    if sampling:
        keys_a = full(0, torch.int64)
        keys_a[0] = root_key
    if mono:
        cst_d = torch.as_tensor(np.ascontiguousarray(mono_cst, np.int32),
                                device=dev)
        lo_a = full(-math.inf, torch.float32)
        hi_a = full(math.inf, torch.float32)
    if use_sub:
        small_a = full(True, torch.bool)
    n_head = 7 + int(regression) + 2 * int(mono)
    nids = fit.root_nids()
    flo, fsz, depth, levels, carry = 0, 1, 0, [], None
    while fsz > 0:
        hi = flo + fsz
        levels.append((flo, fsz))
        if cfg.max_depth is not None and depth == cfg.max_depth:
            counts_a[flo:hi] = fit.node_sums(nids, flo, hi)
            flo = hi
            break
        S = fit.width(fsz)
        keep = keep_level(fit, cfg, use_sub, S, -(-fsz // S))
        level = level_histograms(fit, nids, flo, fsz, S, carry=carry,
                                 keep=keep)
        bufs = []
        for c, lo in enumerate(range(flo, hi, S)):
            extra = {}
            if sampling:
                kw = keys_a[lo:lo + S]
                # every feature where sample_k is None, as the levelwise
                # engine's masks
                extra["node_mask"] = node_masks_dev(kw, sample_k or F, F)
                if random_split:
                    extra["draws"] = node_draws_dev(kw, F)
            if mono:
                extra.update(mono_cst=cst_d, mono_lo=lo_a[lo:lo + S],
                             mono_hi=hi_a[lo:lo + S])
            bufs.append(fit.sweep(
                level.chunk(c), lo, criterion=cfg.criterion,
                min_child_weight=cfg.min_child_weight, task=cfg.task,
                yr=fit.y_range(nids, lo, S) if regression else None,
                **extra,
            )[: min(S, hi - lo)])
        buf = torch.cat(bufs)
        if cfg.debug:
            assert_replicated(buf, fit.mesh, what=f"depth {depth}")

        # the stop rules, in the buffer's dtype as the levelwise engine's
        counts = buf[:, n_head:]
        cost = buf[:, 2]
        if regression:
            n = counts[:, 0]
            pure = buf[:, 7] <= 0.0
        else:
            n = _row_sum(counts)
            pure = (counts > 0).sum(dim=1) <= 1
        stop = (pure | (buf[:, 5] > 0) | (n < cfg.min_samples_split)
                | torch.isinf(cost))
        if cfg.min_decrease_scaled > 0.0:
            imp = (_class_node_impurity_dev(counts, cfg.criterion)
                   if fit.fixed and not regression else buf[:, 3])
            stop |= n * (imp - cost) < cfg.min_decrease_scaled
        split = ~stop
        feat_k = torch.where(stop, -1, buf[:, 0].to(torch.int32))
        bin_k = buf[:, 1].to(torch.int32)
        feat_a[flo:hi] = feat_k
        bin_a[flo:hi] = bin_k
        counts_a[flo:hi] = counts.to(torch.float64)

        # child allocation: ids in frontier order, left/right interleaved
        rank = torch.cumsum(split.to(torch.int64), 0)
        lids = hi + 2 * (rank - 1)
        left_a[flo:hi] = torch.where(split, lids, -1).to(torch.int32)
        scat = torch.where(split, lids, dump)
        gidx = torch.arange(flo, hi, dtype=torch.int32, device=dev)
        parent_a[scat] = gidx
        parent_a[scat + 1] = gidx
        if sampling:
            lk, rk = child_keys_dev(keys_a[flo:hi])
            keys_a[scat] = lk
            keys_a[scat + 1] = rk
        if mono:
            llo, lhi, rlo, rhi = child_bounds_dev(
                lo_a[flo:hi], hi_a[flo:hi], buf[:, n_head - 2],
                buf[:, n_head - 1], cst_d[feat_k.clamp(min=0)])
            lo_a[scat], hi_a[scat] = llo, lhi
            lo_a[scat + 1], hi_a[scat + 1] = rlo, rhi
        if use_sub:
            left_small = buf[:, 6] * 2.0 <= n  # ties go left
            small_a[scat] = left_small
            small_a[scat + 1] = ~left_small
        nids = fit.reroute(
            nids, flo, split, feat_k.clamp(min=0).to(torch.int64), bin_k,
            lids.to(torch.int32), (lids + 1).to(torch.int32))

        if sizes is None:
            # the level's one read: 4 bytes
            n_split = int(rank[-1].to(torch.int32))
            frontier_reads += 1
        else:
            n_split = sizes[depth + 1] // 2 if depth + 1 < len(sizes) else 0
        nxt = slice(hi, hi + 2 * n_split)
        carry = SubtractionCarry(
            level.kept, small_a[nxt], (parent_a[nxt] - flo).to(torch.int64),
        ) if keep and n_split else None
        flo, fsz, depth = hi, 2 * n_split, depth + 1
    ints = torch.stack([feat_a[:flo], bin_a[:flo], left_a[:flo],
                        parent_a[:flo]])
    return _Grown(flo, levels, ints, counts_a[:flo], nids)


def _finalize_tree(binned, task: str, criterion: str, n_nodes: int,
                   ints: np.ndarray, counts: np.ndarray, depth: np.ndarray,
                   count_dtype) -> TreeArrays:
    """Device build arrays (host copies) -> the TreeArrays the levelwise
    engine's node store finalizes (``:1041``): the same dtypes, values
    and impurities from the same counts, and every node's ``depth``
    (:func:`_level_depths` of a level-by-level build)."""
    feature, bins, left, parent = (a[:n_nodes] for a in ints)
    counts = counts[:n_nodes]
    threshold = np.full(n_nodes, np.nan, np.float32)
    interior = feature >= 0
    threshold[interior] = binned.thresholds[feature[interior],
                                            bins[interior]]
    if task == "classification":
        n = counts.sum(axis=1)
        value = counts.argmax(axis=1).astype(np.int32)
        count = counts.astype(count_dtype)
        impurity = class_node_impurity(counts, criterion)
    else:
        n = counts[:, 0]
        value = (counts[:, 1] / np.maximum(counts[:, 0], 1.0)).astype(
            np.float32)
        count = value.astype(np.float64)[:, None]
        impurity = moment_node_impurity(counts)
    return TreeArrays(
        feature=feature.astype(np.int32),
        threshold=threshold,
        left=left.astype(np.int32),
        right=np.where(left >= 0, left + 1, -1).astype(np.int32),
        parent=parent.astype(np.int32),
        depth=np.asarray(depth[:n_nodes], np.int32),
        value=value,
        count=count,
        n_node_samples=n.astype(np.int64),
        impurity=impurity,
    )


def _check_fused(cfg: BuildConfig) -> None:
    check_task(cfg)
    if cfg.task == "gbdt":
        raise ValueError(
            "the fused engine does not implement task='gbdt'; use "
            "engine='auto' or 'levelwise'")


def _count_dtype(task: str, weights) -> type:
    return (np.int64 if task == "classification" and integer_weights(weights)
            else np.float64)


def build_tree_fused(binned, y: np.ndarray, *, config: BuildConfig,
                     n_classes: int | None = None,
                     sample_weight: np.ndarray | None = None,
                     packed: torch.Tensor | None = None,
                     return_leaf_ids: bool = False,
                     refit_targets: np.ndarray | None = None,
                     feature_sampler=None,
                     feature_mask: np.ndarray | None = None,
                     mono_cst: np.ndarray | None = None, mesh=None,
                     x_shards=None, timer=None):
    """``core/builder.build_tree``'s contract on the fused engine
    (``mpitree_tpu/core/fused_builder.py:862``): the same tree as the
    levelwise engine, with one frontier-size read a level. With
    ``return_leaf_ids`` (the hybrid crown) also every row's final node.
    On a data ``mesh`` (``_make_fused_fn`` with ``psum_axis=DATA_AXIS``,
    ``:699-756``) the tree state stays on the lead shard and the rows'
    node ids on their shards; still one frontier read a level in each
    process.

    ``timer`` (``core/builder.build_tree``'s) gets the JAX package's
    record of a fused build (``:933-1022``): the spans ``shard``,
    ``fused_build`` and ``host_finalize``, the ``fused_builds`` counter,
    and, replayed from the finished tree (``obs/accounting``), the level
    rows, ``rows_scanned``/``rows_frontier`` and the fingerprint rows;
    nothing of it is read inside the level loop."""
    cfg = config
    _check_fused(cfg)
    timer = timer if timer is not None else PhaseTimer(enabled=False)
    with timer.phase("shard"):
        fit = FitInputs(binned, y, cfg, n_classes=n_classes,
                        sample_weight=sample_weight, packed=packed,
                        feature_mask=feature_mask, mesh=mesh,
                        x_shards=x_shards)
    use_sub = resolve_hist_subtraction(
        cfg, fit.dev, obs=timer,
        shape=evidence_shape(fit.N, fit.F, fit.B))
    timer.set_mesh(mesh, device=fit.dev)
    note_subtraction(timer, use_sub)
    with timer.phase("fused_build"):
        g = _grow(fit, cfg, use_sub=use_sub, sampler=feature_sampler,
                  mono_cst=mono_cst)
    with timer.phase("host_finalize"):
        tree = _finalize_tree(binned, cfg.task, cfg.criterion, g.n_nodes,
                              g.ints.cpu().numpy(), g.counts.cpu().numpy(),
                              _level_depths(g.levels, g.n_nodes),
                              _count_dtype(cfg.task, sample_weight))
    timer.counter("fused_builds")
    replay_record(timer, tree, fit, cfg, use_sub)
    leaf_ids = None
    if cfg.task == "regression" and refit_targets is not None:
        leaf_ids = fit.leaf_ids(g.nids)
        w64 = (np.ones(fit.N) if sample_weight is None
               else np.asarray(sample_weight)).astype(np.float64)
        refit_regression_values(tree, leaf_ids, w64,
                                np.asarray(refit_targets, np.float64))
    if return_leaf_ids:
        return tree, fit.leaf_ids(g.nids) if leaf_ids is None else leaf_ids
    return tree


def replay_record(timer, tree: TreeArrays, fit: FitInputs, cfg: BuildConfig,
                  use_sub: bool) -> None:
    """A fused build's level rows, scan counters and fingerprint rows,
    replayed from its finished ``tree`` (``obs/accounting.
    fused_scan_rows``, ``replay_fingerprints``) into ``timer``."""
    rows, _, counters = obs_acct.fused_scan_rows(
        tree, n_slots=fit.K, tiers=tuple(fit.tiers), n_features=fit.F,
        n_bins=fit.B, n_channels=fit.C, counts_channels=fit.C,
        max_depth=-1 if cfg.max_depth is None else int(cfg.max_depth),
        task=cfg.task, n_rows=fit.N, subtraction=use_sub,
        itemsize=8 if fit.fixed else 4)
    for name, v in counters.items():
        timer.counter(name, v)
    for r in rows:
        timer.level(**r)
    obs_acct.price_levels(timer, "fused_fn", fit, rows)
    if timer.wants_fingerprints:
        timer.fingerprint_tree(obs_acct.replay_fingerprints(tree))


def _forest_routes(task: str, y_d: torch.Tensor, ws: torch.Tensor,
                   n_classes) -> list:
    """Every tree's histogram route with one device-to-host copy: None
    (the float32 integer route) or the fixed-point exponents, as
    ``FitInputs`` would decide each tree's alone
    (``hist_kernel.float32_exact``, ``fixed_point_exponents``)."""
    T, N = ws.shape
    if task == "classification":
        # a class payload w * onehot(y) is float32-exact when every weight
        # is an integer and every class's weight sums below 2**24
        sums = torch.zeros((T, n_classes), dtype=torch.float64,
                           device=ws.device)
        sums.index_add_(1, y_d, ws.abs().double())
        stats = torch.cat([(ws == torch.round(ws)).all(1, keepdim=True)
                           .double(), sums], dim=1).cpu().numpy()
        ok = (stats[:, 0] > 0) & (stats[:, 1:].max(axis=1)
                                  < hist_kernel.FLOAT32_EXACT)
        if ok.all():
            return [None] * T
        tops = torch.stack([(ws.abs() * (y_d == c)).amax(dim=1)
                            for c in range(n_classes)], dim=1)
    else:
        y32 = y_d.to(torch.float32)
        tops = torch.stack([ws.abs().amax(dim=1),
                            (ws * y32).abs().amax(dim=1),
                            (ws * y32 * y32).abs().amax(dim=1)], dim=1)
        ok = np.zeros(T, bool)
    exps = hist_kernel.exponents_from_top(tops.cpu().numpy(), N)
    return [None if ok[t] else exps[t] for t in range(T)]


def build_forest_fused(binned, y: np.ndarray, *, config: BuildConfig,
                       weights: np.ndarray, cand_masks: np.ndarray,
                       n_classes: int | None = None,
                       refit_targets: np.ndarray | None = None,
                       return_leaf_ids: bool = False,
                       min_child_weights: np.ndarray | None = None,
                       min_decrease_scaleds: np.ndarray | None = None,
                       samplers: list | None = None,
                       mono_cst: np.ndarray | None = None, mesh=None,
                       timer=None) -> list:
    """T trees in sequence in one call (``mpitree_tpu/core/
    fused_builder.py:1094``): ``weights`` (T, N) each tree's composed
    bootstrap x user weights, ``cand_masks`` (T, F, B) each tree's
    candidate mask (its subspace), per-tree leaf floors and decrease gates
    (``min_child_weights``, ``min_decrease_scaleds``) and node samplers
    (``samplers``, None entries for none). Each tree is the one
    :func:`build_tree_fused` grows from the same inputs; the finished
    trees come to the host, with the (T, N) leaf ids under
    ``return_leaf_ids``.

    One device is a mesh of one shard (``mesh`` None). The trees shard
    over a ``(tree, data)`` mesh of the mesh's shards (``_make_forest_fn``, ``:758-860``) whose shape
    ``parallel/mesh.tree_data_shape`` picks: the trees pad to a multiple
    of the tree axis and each tree group grows its contiguous block of
    them in sequence, on its shards, its rows sharded over the data axis
    and its histograms reduced over that axis's sub-mesh only. Every
    tree's route and exponents come from all of its rows
    (:func:`_forest_routes`: every process holds every row, so these are
    the global statistics, and the shards' int64 sums add exactly). The
    finished trees then go to every process (:func:`_exchange`) and are
    finalized there as on one device. A ``StreamedBinnedData`` (whose
    shards lie on the ingest's data mesh) gives each tree group's shards
    the row blocks they take, at the ingest's width, from this process's
    shards and, for rows another process placed, only those rows
    (``ingest/place.regroup_matrix``, counted under ``exchange``): where
    the forest's data axis is the ingest's, nothing crosses a process,
    and no device holds more than its group's blocks. ``timer`` gets the
    JAX package's record of a batched forest (``:1187-1380``): the
    ``(tree, data)`` mesh, the ``hist_subtraction`` decision, the spans
    ``shard``, ``forest_build`` and ``host_finalize``, the
    ``forest_fused_builds`` and ``trees_built`` counters and every
    tree's fingerprint rows, replayed from the finished trees."""
    cfg = config
    _check_fused(cfg)
    timer = timer if timer is not None else PhaseTimer(enabled=False)
    T = weights.shape[0]
    task = cfg.task
    dev = (mesh.lead if isinstance(binned, StreamedBinnedData)
           else binned.x_binned.device)
    price = _forest_ledger(binned, y, cfg, weights, n_classes, mesh, dev,
                           timer)
    with timer.phase("shard"):
        ws = torch.as_tensor(np.asarray(weights, np.float32), device=dev)
        cms = torch.as_tensor(np.asarray(cand_masks, bool), device=dev)
        y_d = torch.as_tensor(
            np.asarray(y, np.int64 if task == "classification"
                       else np.float32), device=dev)
        routes = _forest_routes(task, y_d, ws, n_classes)
    use_sub = resolve_hist_subtraction(
        cfg, dev, obs=timer, shape=evidence_shape(
            binned.n_samples, binned.n_features, binned.n_bins))
    note_subtraction(timer, use_sub)
    need_ids = return_leaf_ids or (task == "regression"
                                   and refit_targets is not None)

    def tree_cfg(t):
        if min_child_weights is None:
            return cfg
        return dataclasses.replace(
            cfg, min_child_weight=float(min_child_weights[t]),
            min_decrease_scaled=float(min_decrease_scaleds[t]))

    def sampler(t):
        return None if samplers is None else samplers[t]

    with timer.phase("forest_build"):
        parts, nids = _grow_sharded(
            binned, y, Mesh([dev]) if mesh is None else mesh, T,
            routes=routes, cms=cms, weights=weights, n_classes=n_classes,
            tree_cfg=tree_cfg, sampler=sampler, use_sub=use_sub,
            mono_cst=mono_cst, need_ids=need_ids, timer=timer)
    trees = []
    with timer.phase("host_finalize"):
        for t, (ints_t, counts_t, depth_t) in enumerate(parts):
            tree = _finalize_tree(
                binned, task, cfg.criterion, len(depth_t), ints_t, counts_t,
                depth_t, _count_dtype(task, weights[t]))
            if task == "regression" and refit_targets is not None:
                refit_regression_values(
                    tree, nids[t], weights[t].astype(np.float64),
                    np.asarray(refit_targets, np.float64))
            trees.append(tree)
    timer.counter("forest_fused_builds")
    timer.counter("trees_built", T)
    price(trees)
    if timer.wants_fingerprints:
        for tree in trees:
            timer.fingerprint_tree(obs_acct.replay_fingerprints(tree))
    if return_leaf_ids:
        return trees, nids
    return trees


def _forest_ledger(binned, y, cfg: BuildConfig, weights, n_classes, mesh,
                   dev, timer):
    """The batched forest's memory ledger (``obs/memory.plan_forest``, on
    the ``(tree, data)`` shape :func:`_grow_sharded` takes), recorded and
    preflighted before anything is placed; returns the closure that
    prices the build's ``forest_fn`` dispatch from the finished trees."""
    from types import SimpleNamespace

    from mpitree_tpu_torch.core.builder import (
        _chunk_size,
        fixed_route,
        valid_tiers,
    )
    from mpitree_tpu_torch.obs import memory as memory_lib
    from mpitree_tpu_torch.parallel import mesh as mesh_lib

    task, T = cfg.task, weights.shape[0]
    N, F, B = binned.n_samples, binned.n_features, binned.n_bins
    C = 3 if task in ("regression", "gbdt") else int(n_classes)
    Dt = Dd = 1
    if mesh is not None:
        Dt, Dd = mesh_lib.tree_data_shape(
            mesh.size, T, dataset_bytes=4 * N * F,
            hbm_budget=mesh_lib.forest_hbm_budget(mesh.lead))
    fixed = any(fixed_route(task, y, weights[t], n_classes)
                for t in range(T))
    sub = resolve_hist_subtraction(cfg, dev,
                                   shape=evidence_shape(N, F, B))
    K = _chunk_size(N, F, B, C, cfg, cell_bytes=8 if fixed else 4)
    plan = memory_lib.plan_forest(
        n_trees=T, rows=N, features=F, classes=int(n_classes or 2),
        bins=B, task=task, max_depth=cfg.max_depth, tree_shards=Dt,
        data_shards=Dd, subtraction=sub, fixed=fixed, chunk_slots=K,
        hist_budget_bytes=cfg.hist_budget_bytes,
        max_frontier_chunk=cfg.max_frontier_chunk,
        device_bin=(not isinstance(binned, StreamedBinnedData)
                    and isinstance(binned.x_binned, torch.Tensor)))
    timer.memory_plan(plan)
    memory_lib.preflight(plan, obs=timer, what="forest build", device=dev)

    def price(trees) -> None:
        view = SimpleNamespace(
            N=N, f_local=F, C=C, B=B, fixed=fixed, K=K,
            tiers=valid_tiers(cfg.frontier_tiers, K),
            packed_width=-(-F // hist_kernel.LANE_FEATURES)
            * hist_kernel.LANE_FEATURES if B <= 256 else 4 * F)
        rows = []
        for tree in trees:
            rows += obs_acct.fused_scan_rows(
                tree, n_slots=K, tiers=tuple(view.tiers), n_features=F,
                n_bins=B, n_channels=C, counts_channels=C,
                max_depth=-1 if cfg.max_depth is None
                else int(cfg.max_depth), task=task, n_rows=N,
                subtraction=sub, itemsize=8 if fixed else 4)[0]
        obs_acct.price_levels(timer, "forest_fn", view, rows)

    return price


def _level_depths(levels: list, n_nodes: int) -> np.ndarray:
    """Every node's depth from a level-by-level build's (first node,
    size) levels."""
    depth = np.zeros(n_nodes, np.int32)
    for d, (lo, size) in enumerate(levels):
        depth[lo:lo + size] = d
    return depth


def _grow_sharded(binned, y, mesh, T: int, *, routes, cms, weights,
                  n_classes, tree_cfg, sampler, use_sub: bool, mono_cst,
                  need_ids: bool, timer) -> tuple:
    """The trees of :func:`build_forest_fused` on ``mesh``: the
    ``(tree, data)`` shape, then this process's tree groups in order (a
    group spanning processes runs in each of them), then the exchange.
    Returns every tree's host ``(ints, counts, depth)`` and, with
    ``need_ids``, the (T, N) leaf ids."""
    from mpitree_tpu_torch.core.builder import shard_matrix
    from mpitree_tpu_torch.parallel import mesh as mesh_lib

    Dt, Dd = mesh_lib.tree_data_shape(
        mesh.size, T, dataset_bytes=4 * binned.n_samples * binned.n_features,
        hbm_budget=mesh_lib.forest_hbm_budget(mesh.lead))
    tmesh = mesh_lib.as_tree_data_mesh(mesh, (Dt, Dd))
    timer.set_mesh(tmesh)
    per = -(-T // Dt)  # T_pad / Dt: each tree group's block
    regrouped = None
    if isinstance(binned, StreamedBinnedData):
        # a local shard's block depends on the data axis alone: regrouped
        # once a fit for each width, whatever the calls' tree counts
        regrouped = binned.blocks.get(Dd)
        if regrouped is None:
            from mpitree_tpu_torch.ingest.place import regroup_matrix

            regrouped = binned.blocks[Dd] = [
                (x, hist_kernel.pack_bins(x, binned.n_bins)
                 if binned.n_bins <= 256 else None)
                for x in regroup_matrix(binned, mesh, tmesh)]
    mine = {}
    for sub in tmesh.axis_groups(mesh_lib.DATA_AXIS):
        j = tmesh.coords(sub.local[0])[0]
        block = range(j * per, min((j + 1) * per, T))
        if not len(block):
            continue  # a group of padding trees only
        x_sh = (shard_matrix(binned, sub) if regrouped is None
                else [regrouped[i] for i in sub.local])
        for t in block:
            cfg_t = tree_cfg(t)
            fit = FitInputs(binned, y, cfg_t, n_classes=n_classes,
                            sample_weight=weights[t], scale_exp=routes[t],
                            candidate_mask=cms[t].to(sub.lead), mesh=sub,
                            x_shards=x_sh)
            g = _grow(fit, cfg_t, use_sub=use_sub, sampler=sampler(t),
                      mono_cst=mono_cst)
            ids = fit.leaf_ids(g.nids) if need_ids else None
            if sub.rank == 0:  # the group's first process sends it
                mine[t] = (g.ints.cpu().numpy(), g.counts.cpu().numpy(),
                           _level_depths(g.levels, g.n_nodes), ids)
    return _exchange(mine, mesh, T, binned.n_samples, need_ids)


def _exchange(mine: dict, mesh, T: int, n_rows: int,
              need_ids: bool) -> tuple:
    """Every tree on every process: the trees this process sends
    (``mine``: tree -> host ``(ints (4, n), counts (n, C), depth (n,),
    leaf ids or None)``) and the others' through two all-reduces (SUM) of
    integer buffers over the whole mesh, each tree filled by one process
    only: first the node counts, then every tree's structure, depths and
    counts' float64 bits (int64), and the leaf ids (int32) when needed.
    Bit for bit, since a sum with zeros keeps every word.
    ``utils/profiling.assert_replicated`` then holds the forest to the
    same bits on every process."""
    from mpitree_tpu_torch.utils.profiling import assert_replicated

    # without a process group the reductions are the identity: no copies
    dev = mesh.lead if mesh.group is not None else torch.device("cpu")
    sizes = torch.zeros(T, dtype=torch.int64, device=dev)
    C = next(iter(mine.values()))[1].shape[1] if mine else 0
    for t, (_, counts, _, _) in mine.items():
        sizes[t] = counts.shape[0]
    head = torch.cat([sizes, torch.tensor([C], dtype=torch.int64,
                                          device=dev)])
    head = collective.psum([head], mesh, "max", kind="tree_exchange",
                           site="tree_exchange").cpu()
    sizes, C = head[:T].numpy(), int(head[T])
    stride = 5 + C
    offs = np.concatenate([[0], np.cumsum(sizes * stride)])
    buf = np.zeros(int(offs[-1]), np.int64)
    ids = np.zeros((T, n_rows), np.int32) if need_ids else None
    for t, (ints, counts, depth, leaf) in mine.items():
        n = int(sizes[t])
        seg = buf[offs[t]:offs[t + 1]].reshape(stride, n)
        seg[:4] = ints
        seg[4] = depth
        seg[5:] = np.ascontiguousarray(counts.T).view(np.int64)
        if need_ids:
            ids[t] = leaf
    full = collective.psum([torch.from_numpy(buf).to(dev)], mesh,
                           kind="tree_exchange",
                           site="tree_exchange")
    assert_replicated(full, mesh, what="forest exchange")
    full = full.cpu().numpy()
    if need_ids:
        ids = collective.psum([torch.from_numpy(ids).to(dev)], mesh,
                              kind="tree_exchange",
                              site="tree_exchange").cpu().numpy()
    parts = []
    for t in range(T):
        n = int(sizes[t])
        seg = full[offs[t]:offs[t + 1]].reshape(stride, n)
        parts.append((seg[:4].astype(np.int32),
                      np.ascontiguousarray(seg[5:]).view(np.float64).T,
                      seg[4].astype(np.int32)))
    return parts, ids

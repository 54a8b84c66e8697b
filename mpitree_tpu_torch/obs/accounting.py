"""Static-shape accounting: reduction payloads and replayed level rows.

Counterpart of ``mpitree_tpu/obs/accounting.py:31-343``, with the
memory ledger's assembly point (:func:`build_memory_plan`). Everything here is host arithmetic on static shapes and the finished
tree's host arrays: no device work. The levelwise engines account live
(they own a host loop); the fused engines, which read one frontier size
a level, and the CUDA-graph leaf loop, whose expansions run inside a
graph replay, get their per-level rows and payloads replayed after the
fact from the finished tree: every allocated node was once a frontier
member at its depth, so ``bincount(tree.depth)`` is the frontier
trajectory, and the tier routing below mirrors the fused engine's
(``core/fused_builder._grow``: the narrowest tier that holds the level,
else ``K``-slot chunks).

The payloads are the port's own buffers' (``itemsize``: 4-byte cells on
the integer histogram route, 8-byte on the fixed-point one).
"""

from __future__ import annotations

import math

import numpy as np

from mpitree_tpu_torch.obs import fingerprint as fingerprint_mod
from mpitree_tpu_torch.obs import memory as memory_mod
from mpitree_tpu_torch.parallel.collective import (
    counts_psum_bytes,
    gbdt_leaf_psum_bytes,
    select_global_bytes,
    split_psum_bytes,
)


def replay_fingerprints(tree) -> list:
    """Per-level build-state fingerprint rows replayed from a finished
    tree: the fused engines' twin of the levelwise loop's live hashing.
    Both hash the same bytes from the same host arrays."""
    return fingerprint_mod.tree_fingerprints(tree)


def build_memory_plan(*, mesh=None, mesh_axes=None,
                      **statics) -> memory_mod.MemoryPlan:
    """The memory ledger of one build (``mpitree_tpu/obs/accounting.py:41``):
    the fused engines and the CUDA-graph leaf loops run their levels and
    expansions with no per-phase host view, so their per-phase watermarks
    are replayed from the same statics the levelwise loop prices (the
    memory twin of :func:`fused_level_rows`): one assembly point, so the
    engines cannot drift in what they price. ``mesh``: a
    ``parallel/mesh.Mesh`` (its data and feature widths are read off it);
    ``mesh_axes`` the normalized alternative; the rest goes to
    ``obs.memory.plan_fit``."""
    if mesh is not None and mesh_axes is None:
        from mpitree_tpu_torch.parallel.mesh import (
            data_shards,
            feature_shards,
        )

        mesh_axes = {"data": data_shards(mesh),
                     "feature": feature_shards(mesh)}
    return memory_mod.plan_fit(mesh_axes=mesh_axes, **statics)


def _fit_statics(fit) -> dict:
    """The shapes a build's launches read (a ``core/builder.FitInputs``):
    per-shard rows are the global rows over the record's shard count."""
    packed = getattr(fit, "packed", None)
    pw = getattr(fit, "packed_width", None)
    if pw is None:
        pw = (int(packed.shape[1]) if packed is not None
              else 4 * int(fit.f_local))
    return dict(
        n_rows=int(fit.N), n_features=int(fit.f_local),
        n_channels=int(fit.C), n_bins=int(fit.B),
        cell=8 if fit.fixed else 4, packed_width=int(pw))


def price_levels(timer, entry: str, fit, levels: list, *,
                 dispatches: int = 1) -> None:
    """Price ``entry``'s dispatch from a level-by-level build's rows
    (``obs/cost.levels_cost`` of its histogram launches and sweeps, split
    evenly over ``dispatches``), once per static key of the build."""
    from mpitree_tpu_torch.obs import cost as cost_mod
    from mpitree_tpu_torch.ops import hist_kernel

    st = _fit_statics(fit)
    key = (tuple(sorted(st.items())), int(fit.K), tuple(fit.tiers))

    def count():
        c = cost_mod.levels_cost(
            levels, tiers=tuple(fit.tiers), n_slots=int(fit.K),
            stream_max_slots=hist_kernel.STREAM_MAX_SLOTS, **st)
        n = max(int(dispatches), 1)
        return {"flops": c["flops"] / n, "bytes": c["bytes"] / n,
                "note": cost_mod.SWEEP_NOTE}

    timer.price_dispatch(entry, key, count)


def price_leafwise(timer, entry: str, fit, counters: dict, *,
                   expansions: int, subtraction: bool,
                   dispatches: int = 1, trees: int = 1) -> None:
    """Price ``entry``'s dispatch from best-first builds' replayed
    counters (``obs/cost.leafwise_cost``): ``trees`` builds of
    ``expansions`` in all, split evenly over ``dispatches``."""
    from mpitree_tpu_torch.obs import cost as cost_mod

    st = _fit_statics(fit)
    key = (tuple(sorted(st.items())), bool(subtraction))

    def count():
        c = cost_mod.leafwise_cost(
            expansions=int(expansions),
            rows_scanned=float(counters.get("rows_scanned", st["n_rows"])),
            subtraction=subtraction, **st)
        # each tree's root launch past the first
        c["bytes"] += (int(trees) - 1) * st["n_rows"] * 4
        n = max(int(dispatches), 1)
        return {"flops": c["flops"] / n, "bytes": c["bytes"] / n,
                "note": cost_mod.SWEEP_NOTE}

    timer.price_dispatch(entry, key, count)


def effective_tiers(tiers: tuple, max_depth: int) -> tuple:
    """Tiers reachable under a depth cap (``max_depth < 0`` = unbounded).

    The trim the JAX package's fused program applies (its tiers only):
    depth-capped builds bound every interior frontier at
    ``2^(max_depth-1)``, so tiers that can never be the narrowest fit are
    dropped. ``tiers`` must already be normalized (sorted ascending,
    bounded by the chunk width — ``builder.valid_tiers``).
    """
    max_interior = (
        2 ** max(int(max_depth) - 1, 0) if max_depth >= 0 else None
    )
    if max_interior is None or not tiers:
        return tuple(tiers)
    kept, prev = [], 0
    for t in tiers:
        if prev < max_interior:
            kept.append(t)
        prev = t
    return tuple(kept)


def fused_level_rows(
    node_depths: np.ndarray,
    *,
    n_slots: int,
    tiers: tuple,
    n_features: int,
    n_bins: int,
    n_channels: int,
    counts_channels: int,
    max_depth: int,
    task: str,
    feature_shards: int = 1,
    data_shards: int = 1,
    n_rows: int | None = None,
    subtraction: bool = False,
    itemsize: int = 4,
    node_samples: np.ndarray | None = None,
    node_left: np.ndarray | None = None,
    node_right: np.ndarray | None = None,
) -> tuple:
    """(level_rows, collectives) replayed from a fused build's finished tree.

    ``node_depths``: the host ``tree.depth`` array. ``tiers`` must be the
    EFFECTIVE tier tuple the compiled program used
    (:func:`effective_tiers` of the valid tiers). ``n_channels`` is the
    histogram payload width (C for classification, 3 moment channels
    otherwise); ``counts_channels`` the terminal counts width.
    ``max_depth < 0`` = unbounded. ``itemsize``: the histogram cell
    width (4 on the integer route, 8 on the fixed-point one). ``subtraction`` replays the
    sibling-subtraction routing (``fused_builder``'s ``sub_ok`` carry): an
    interior level below the root whose frontier AND parent frontier each
    fit one chunk psums only the compact half-width small-child buffer.
    Returns per-level row dicts (seconds ``None`` — one compiled program
    has no per-level host clock) and a ``{site: {"calls", "bytes"}}``
    dict of logical psum/gather payloads.

    ``node_samples``/``node_left``/``node_right`` (the finished tree's
    per-node weights and child links) make the replay EXACT for realized
    work: every allocated node was once a frontier member at its depth,
    so the per-level frontier weight is ``bincount(depth, weights=n)``,
    and a subtraction level accumulates only each pair's smaller sibling
    — ``min(n[left], n[right])`` binned by child depth. Without them the
    per-row ``rows_scanned``/``small_child_fraction`` stay ``None``
    (the depth histogram alone carries no row counts).
    """
    # On a 2-D (data, feature) mesh the psum'd histogram is each shard's
    # PADDED feature slab — the logical payload divides by the feature-
    # axis width, which is the whole point of the sharding (per-level ICI
    # payload independent of F). Mirrors the levelwise engine's live
    # accounting (builder.build_tree's f_shard).
    fs = max(int(feature_shards), 1)
    f_slab = (n_features + ((-n_features) % fs)) // fs
    depths_a = np.asarray(node_depths, np.int64)
    frontiers = np.bincount(depths_a)
    wlev = minlev = None
    # All-or-nothing: without the child links a subtraction level cannot
    # price its smaller siblings, and a zeros placeholder would claim
    # ZERO realized work — keep the documented None contract instead.
    if (node_samples is not None and node_left is not None
            and node_right is not None):
        n = np.asarray(node_samples, np.float64)
        wlev = np.bincount(depths_a, weights=n, minlength=len(frontiers))
        minlev = np.zeros(len(frontiers) + 1)
        li = np.asarray(node_left)
        ids = np.flatnonzero(li >= 0)
        if len(ids):
            mw = np.minimum(
                n[li[ids]], n[np.asarray(node_right)[ids]]
            )
            minlev = np.bincount(
                depths_a[ids] + 1, weights=mw,
                minlength=len(frontiers) + 1,
            )
    rows: list = []
    coll: dict = {}

    def add(site, calls, nbytes):
        entry = coll.setdefault(site, {"calls": 0, "bytes": 0})
        entry["calls"] += calls
        entry["bytes"] += nbytes

    K = n_slots
    prev_one_chunk = False  # the root has no parent histogram above it
    for d, f in enumerate(frontiers.tolist()):
        if f == 0:
            continue
        splits = (
            int(frontiers[d + 1]) // 2 if d + 1 < len(frontiers) else 0
        )
        terminal = max_depth >= 0 and d == max_depth
        scanned = small_frac = None
        if terminal:
            chunks = math.ceil(f / K)
            nbytes = chunks * counts_psum_bytes(
                n_slots=K, n_channels=counts_channels, itemsize=itemsize
            )
            add("counts_psum", chunks, nbytes)
            hist_bytes = 0
            psum_bytes = nbytes
            prev_one_chunk = False
        else:
            S = next((s for s in tiers if f <= s), K)
            chunks = 1 if S < K else math.ceil(f / K)
            sub_here = subtraction and chunks == 1 and prev_one_chunk
            per_chunk = split_psum_bytes(
                n_slots=S // 2 if sub_here else S,
                n_features=f_slab, n_bins=n_bins,
                n_channels=n_channels, itemsize=itemsize,
            )
            hist_bytes = chunks * per_chunk
            psum_bytes = chunks * per_chunk
            add("split_hist_psum", chunks, chunks * per_chunk)
            if task == "regression":
                yb = chunks * 2 * S * 4  # pmin/pmax of per-slot f32 y range
                add("y_range_pminmax", chunks, yb)
                psum_bytes += yb
            if feature_shards > 1:
                # select_global's stacked winner gather per chunk, plus
                # the per-level row-routing psum of child ids — per-RING
                # payloads (each feature ring reduces one data-shard's
                # local row block; wire_estimate scales by the concurrent
                # group count), matching the levelwise live accounting.
                gb = chunks * select_global_bytes(n_slots=S)
                add("feature_merge_all_gather", chunks, gb)
                if n_rows is not None:
                    add("route_psum", 1,
                        -(-n_rows // max(int(data_shards), 1)) * 4)
            if wlev is not None:
                fw = float(wlev[d])
                scanned = float(minlev[d]) if sub_here and d > 0 else fw
                small_frac = round(scanned / fw, 6) if fw else None
            prev_one_chunk = chunks == 1
        rows.append({
            "level": d,
            "frontier": int(f),
            "splits": splits,
            "hist_bytes": int(hist_bytes),
            "psum_bytes": int(psum_bytes),
            "rows_scanned": scanned,
            "small_child_fraction": small_frac,
            "seconds": None,
            "new_lowerings": 0,
        })
    return rows, coll


def fused_scan_rows(tree, **kwargs) -> tuple:
    """(rows, coll, counters): :func:`fused_level_rows` with the exact
    realized-work replay wired up from the finished ``TreeArrays``.

    The always-on ``rows_scanned``/``rows_frontier`` counters mirror the
    host-stepped levelwise loop's live accounting (``builder.build_tree``)
    so every engine reports the same counter names: scanned = weight actually accumulated into split
    histograms (small siblings only at subtraction levels), frontier =
    what direct accumulation would have scanned. Terminal counts-only
    levels pay no split histogram and count toward neither.
    """
    rows, coll = fused_level_rows(
        tree.depth, node_samples=tree.n_node_samples,
        node_left=tree.left, node_right=tree.right, **kwargs,
    )
    wlev = np.bincount(
        np.asarray(tree.depth, np.int64),
        weights=np.asarray(tree.n_node_samples, np.float64),
    )
    live = [r for r in rows if r["rows_scanned"] is not None]
    counters = {}
    if live:
        counters = {
            "rows_scanned": int(round(sum(
                r["rows_scanned"] for r in live
            ))),
            "rows_frontier": int(round(sum(
                float(wlev[r["level"]]) for r in live
            ))),
        }
    return rows, coll, counters


def leafwise_scan_rows(tree, *, n_features: int, n_bins: int,
                       n_channels: int, task: str, subtraction: bool,
                       gbdt_x64: bool = False, itemsize: int = 4,
                       gbdt_leaf_slots: int | None = None) -> tuple:
    """(rows, collectives, counters) replayed from a leaf-wise build.

    Unlike the level-wise replay, the finished tree carries EXACT
    per-expansion work: each interior node was expanded exactly once,
    paying one sibling-pair histogram whose accumulated weight is both
    children (direct) or the smaller child (``subtraction``) — plus the
    root bootstrap, which always scans everything. ``rows_scanned`` /
    ``rows_frontier`` therefore come out exact (the realized-savings
    counters, comparable with the
    level-wise engines' live counters); per-depth aggregate rows stand in
    for the expansion order, which the finished structure cannot replay
    (the host-stepped engine emits true per-expansion rows live instead).
    """
    n = np.asarray(tree.n_node_samples, np.float64)
    interior = tree.left >= 0
    exp_ids = np.flatnonzero(interior)
    nl = n[tree.left[exp_ids]] if len(exp_ids) else np.zeros(0)
    nr = n[tree.right[exp_ids]] if len(exp_ids) else np.zeros(0)
    acc = np.minimum(nl, nr) if subtraction else nl + nr
    rows_scanned = float(n[0]) + float(acc.sum())
    rows_frontier = float(n[0]) + float((nl + nr).sum())
    counters = {
        "rows_scanned": int(round(rows_scanned)),
        "rows_frontier": int(round(rows_frontier)),
        "expansions": int(len(exp_ids)),
    }

    per_pair = split_psum_bytes(
        n_slots=1 if subtraction else 2, n_features=n_features,
        n_bins=n_bins, n_channels=n_channels,
        itemsize=8 if gbdt_x64 else itemsize,
    )
    calls = len(exp_ids) + 1  # + the root bootstrap pair
    coll = {"split_hist_psum": {"calls": calls, "bytes": calls * per_pair}}
    if task == "regression":
        coll["y_range_pminmax"] = {"calls": calls, "bytes": calls * 2 * 2 * 4}
    if gbdt_leaf_slots is not None:
        # The fused-rounds engine refits leaf values and reduces the
        # training loss in-program once per round tree (G/H over the
        # padded M node slots + two loss scalars).
        coll["gbdt_leaf_psum"] = {
            "calls": 1,
            "bytes": gbdt_leaf_psum_bytes(
                n_slots=gbdt_leaf_slots, itemsize=8 if gbdt_x64 else 4
            ),
        }

    rows = []
    depths = tree.depth[tree.left[exp_ids]] if len(exp_ids) else np.zeros(0)
    for d in sorted(set(np.asarray(depths, np.int64).tolist())):
        sel = depths == d
        scanned = float(acc[sel].sum())
        frontier = float((nl + nr)[sel].sum())
        rows.append({
            "level": int(d),
            "frontier": int(2 * sel.sum()),
            "splits": int(interior[tree.left[exp_ids[sel]]].sum()
                          + interior[tree.right[exp_ids[sel]]].sum()),
            "hist_bytes": int(sel.sum()) * per_pair,
            "psum_bytes": int(sel.sum()) * per_pair,
            "rows_scanned": scanned,
            "small_child_fraction": (
                round(scanned / frontier, 6) if frontier else None
            ),
            "seconds": None,
            "new_lowerings": 0,
        })
    return rows, coll, counters

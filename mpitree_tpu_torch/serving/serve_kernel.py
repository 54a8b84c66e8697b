"""The serving traversal kernels for Hopper, their wrappers, planner and plain versions.

Replaces the Pallas kernel ``mpitree_tpu/serving/pallas_serve.py:49``
(``_traverse_kernel``, reached through ``traverse_batch_pallas`` at
``:150``) in both of its forms:

- K4, :func:`traverse` (``launches["traverse"]``): float32 thresholds,
  float64 leaf values, a float64 reduction in one of three modes —
  ``sum``, ``norm`` (per-tree row over ``max(rowsum, 1)``) and ``percls``
  (tree ``t`` into column ``t mod n_out``) — from zeros or, given
  ``baseline``, from a boosted model's baseline margins;
- K5, :func:`traverse_q` (``launches["traverse_q"]``): the quantized
  tables of ``serving/quantize.py`` — int16 feature ids, bfloat16
  thresholds, int8 leaf values summed as an exact int32 lattice sum in
  ``sum`` or ``percls`` mode; the caller applies the affine dequantization
  once afterwards (it is linear across the ensemble sum).

The TPU kernel descends by one-hot matmuls over a stacked per-tree table
(Mosaic has no vector gather) and accumulates in float32 (the TPU has no
float64). ``csrc/traverse.cu`` gathers directly from the flat
depth-packed :class:`~mpitree_tpu_torch.serving.tables.NodeTable`, read
as one 16-byte record per node (:func:`pack_nodes`), with one thread per
(row, tree) descent and one thread per (row, output column) reduction in
member order, all output columns in one launch; :func:`plan` tiles a call.
The reduction uses IEEE float64 operations nvcc cannot contract: K4 equals
its plain version, and so the estimator's host loop, bit for bit. What
bounds it on an H100 and the measured times: ``PERF.md``
(``chip_smoke.py``).

A ``percls`` launch (a boosted model's margins, kind ``margin``) given a
margin pack goes to a second body, ``csrc/margin.cu`` (``launches["margin"]``
for K4, ``launches["margin_q"]`` for K5): the ensemble re-packed once per
model, when it is compiled, by :func:`pack_margin` (8-byte records, trees
grouped by output column, breadth-first with adjacent siblings), one
output column a block, the column's trees staged in shared memory, the
leaf value gathered by the descending thread, and the same member-order
float64 chain; :func:`plan_margin` tiles it. The pack's ``serves`` says
whether the margin body takes the model: where its trees are small, at
most ``MARGIN_MEAN_NODES`` nodes a tree on average (boosted ensembles of
shallow or leaf-capped trees, the shape it was built for); ensembles of
larger trees, and a model the pack cannot hold (a feature id past 16
bits, a tree of more than 65,536 nodes), keep the general body, which is
faster there (``PERF.md`` §6, ``chip_smoke.py`` phases 6, 23 and 26). A
launch never packs: without a pack it takes the general body.

On a CPU tensor each wrapper uses its plain version (``traversal.descend``
+ ``traversal.accumulate``); on a CUDA tensor it launches a kernel or
raises. There is no fallback from a failed build or launch. ``launches``
counts kernel launches, and nothing else: one per call, under the body
that ran.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import numpy as np
import torch

from mpitree_tpu_torch._device import sm_count
from mpitree_tpu_torch.obs.memory import margin_smem_bytes, serve_smem_bytes
from mpitree_tpu_torch.serving import traversal

THREADS = 256  # threads per block the planner fills with (row, tree) pairs
# Blocks per SM the planner keeps before it packs more rows into a block
# (measured on an H100: PERF.md, chip_smoke.py's tiling sweep).
FILL_BLOCKS_PER_SM = 4
SMEM_STATIC = 48 * 1024  # dynamic shared memory without the opt-in
SMEM_BYTES = 232_448  # the most one block may opt in to on Hopper
N_SMS = 132  # an H100 SXM's streaming multiprocessors (plan's default)
_AGG_CODE = {"sum": 0, "norm": 1, "percls": 2}
# (kernel, feature dtype, threshold dtype, value dtype, accumulator dtype)
_FORMS = {
    "traverse": ("mpt_traverse", torch.int32, torch.float32, torch.float64,
                 torch.float64),
    "traverse_q": ("mpt_traverse_q", torch.int16, torch.bfloat16, torch.int8,
                   torch.int32),
}

# the margin body's kernel per form, and its launch counter
_MARGIN = {"traverse": ("mpt_margin", "margin"),
           "traverse_q": ("mpt_margin_q", "margin_q")}
MARGIN_TABLE_BYTES = 160 * 1024  # a staged chunk of the pack, at most
MARGIN_TERMS_BYTES = 32 * 1024   # K4's float64 terms of one pass, at most
MARGIN_ROWS = 256                # the most rows a margin block takes
# fewest rows a block must take before its table chunk is staged: a
# record read by fewer rows is cheaper to descend in place (chip_smoke.py,
# phase 23's tiling sweep)
MARGIN_STAGE_ROWS = 16
# the most nodes a tree, on average, of an ensemble the margin body
# serves: larger trees scatter its shared-memory gathers and fill a chunk
# with few trees, and the general body is faster on them at 4,096 rows
# (chip_smoke.py, phases 6 and 23: boosted trees of 424 nodes on average
# faster in the margin body, of 1,158 and more slower; PERF.md §6)
MARGIN_MEAN_NODES = 512
_MARGIN_FEATURES = 0xFFFF   # feature ids below it fit a record's 16 bits
_MARGIN_TREE_NODES = 1 << 16  # tree-local child ids fit 16 bits

launches = {"traverse": 0, "traverse_q": 0, "margin": 0, "margin_q": 0}

_lib = None
_margin_lib = None


def _library():
    global _lib
    if _lib is None:
        from mpitree_tpu_torch import _build

        lib = _build.load("traverse")
        for name in ("mpt_traverse", "mpt_traverse_q"):
            fn = getattr(lib, name)
            fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 12
                           + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
        lib.mpt_traverse_error_string.argtypes = [ctypes.c_int]
        lib.mpt_traverse_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _margin_library():
    global _margin_lib
    if _margin_lib is None:
        from mpitree_tpu_torch import _build

        lib = _build.load("margin")
        for name, _ in _MARGIN.values():
            fn = getattr(lib, name)
            fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 14
                           + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
        lib.mpt_margin_error_string.argtypes = [ctypes.c_int]
        lib.mpt_margin_error_string.restype = ctypes.c_char_p
        _margin_lib = lib
    return _margin_lib


# one block's dynamic shared memory: obs/memory.serve_smem_bytes, the
# formula the memory ledger prices the served model's tile with
_smem_bytes = serve_smem_bytes


def plan(form: str, n_rows: int, n_trees: int, n_out: int, *,
         n_features: int, agg: str = "sum", n_sms: int = N_SMS,
         rows_per_block: int | None = None) -> dict:
    """Tiling of one launch (host arithmetic, no device).

    A block takes ``rows_per_block`` rows (R) and walks the trees in
    chunks of ``trees_per_chunk`` (Tc = ``min(T, THREADS // R)``), one
    thread per (row, tree) pair of a chunk, then one thread per (row,
    output column) for the reduction. R grows with the batch, as far as
    ``FILL_BLOCKS_PER_SM`` blocks per SM remain, up to ``THREADS //
    n_out`` (the reduction then keeps most threads busy): small batches
    get one row per block and all their trees in one chunk, large ones
    many rows and short chunks. R is cut further while the block's shared
    memory is above 48 KB. The X rows are staged in shared memory unless
    one row alone would not fit.
    ``rows_per_block`` forces R (``chip_smoke.py`` times alternatives).
    Returns R, Tc, ``threads``, ``blocks``, ``smem`` (bytes), ``stage_x``
    and ``chunks``, the ``(t0, t1)`` tree ranges in the order the block
    reduces them; raises ``ValueError`` when one row's block cannot fit in
    ``SMEM_BYTES``.
    """
    acc_bytes = _FORMS[form][4].itemsize
    norm = agg == "norm"
    T = max(int(n_trees), 1)
    if rows_per_block is None:
        r = max(1, min(THREADS // n_out,
                       n_rows // (FILL_BLOCKS_PER_SM * n_sms)))
    else:
        r = int(rows_per_block)
        if not 1 <= r <= THREADS:
            raise ValueError(f"rows_per_block must be in [1, {THREADS}]")

    stage_x = _smem_bytes(1, min(T, THREADS), n_out, n_features, acc_bytes,
                          norm, True) <= SMEM_BYTES

    def tiling(r):
        tc = min(T, max(1, THREADS // r))
        return tc, _smem_bytes(r, tc, n_out, n_features, acc_bytes, norm,
                               stage_x)

    tc, smem = tiling(r)
    while rows_per_block is None and r > 1 and smem > SMEM_STATIC:
        r -= 1
        tc, smem = tiling(r)
    if smem > SMEM_BYTES:
        raise ValueError(
            f"{form}: a block of {r} rows x {tc} trees with n_out={n_out} "
            f"needs {smem} bytes of shared memory, over {SMEM_BYTES}"
        )
    return dict(
        rows_per_block=r, trees_per_chunk=tc,
        threads=-(-r * tc // 32) * 32, blocks=math.ceil(n_rows / r),
        smem=smem, stage_x=stage_x,
        chunks=tuple((t0, min(t0 + tc, n_trees))
                     for t0 in range(0, n_trees, tc)),
    )


def pack_nodes(feature, threshold, left, right) -> torch.Tensor:
    """(M, 4) int32 node records, one 16-byte load per descent step:
    (feature, threshold's float32 bits, left, right). int16 feature ids and
    bfloat16 thresholds widen exactly. Built on the columns' device; a
    model packs once when it is compiled (``NodeTable.dev_record``)."""
    return torch.stack([
        feature.to(torch.int32),
        threshold.to(torch.float32).view(torch.int32),
        left.to(torch.int32), right.to(torch.int32),
    ], dim=1).contiguous()


@dataclasses.dataclass
class MarginPack:
    """A boosted ensemble re-packed for the margin body (:func:`pack_margin`):
    device tensors the kernel reads, and the host counts its planner reads.

    Attributes
    ----------
    form : ``"traverse"`` (K4) or ``"traverse_q"`` (K5).
    n_out, n_trees : output columns and member trees.
    depth : the deepest leaf's depth (a launch's ``n_steps`` must reach it).
    rec : (even M, 2) int32 node records, trees in pack order (column
        ``c``'s trees ``c, c + K, ...`` in member order, column after
        column), each tree breadth-first from its root: ``(feature | left
        << 16, threshold bits)``, the right child ``left + 1`` (tree-local
        ids); a leaf ``(-1, payload)``, the payload its index into
        ``leaf_vals`` (K4) or its int8 value (K5).
    leaf_vals : (even L,) float64 leaf values in pack order (K4), else None.
    tree_rec : (T + 1,) int32, pack tree ``i``'s first record.
    tree_val : (T + 1,) int32, its first leaf value (K4), else None.
    chunk_tree : (n_chunks + 1,) int32 chunk bounds in pack trees; a chunk
        is whole trees of one column, at most ``MARGIN_TABLE_BYTES``
        staged unless it is one tree alone.
    col_chunk : (n_out + 1,) int32, column ``c``'s chunks (at least one,
        maybe empty).
    table_bytes : the largest chunk's staged bytes within the budget.
    chunk_trees : the most trees in one chunk.
    serves : the trees average at most ``MARGIN_MEAN_NODES`` nodes: the
        margin body serves the model (see :func:`body_for`).
    """

    form: str
    n_out: int
    n_trees: int
    depth: int
    rec: torch.Tensor
    leaf_vals: torch.Tensor | None
    tree_rec: torch.Tensor
    tree_val: torch.Tensor | None
    chunk_tree: torch.Tensor
    col_chunk: torch.Tensor
    table_bytes: int
    chunk_trees: int
    serves: bool

    @property
    def staged_bytes(self) -> int:
        """The records and leaf values: what the blocks of one row group
        stage in all."""
        return self.rec.numel() * 4 + (
            0 if self.leaf_vals is None else self.leaf_vals.numel() * 8)

    def tensors(self) -> dict:
        """name -> the device tensors of the pack (K5 has no value
        arrays); the memory ledger prices each."""
        named = {"margin_records": self.rec,
                 "margin_leaf_values": self.leaf_vals,
                 "margin_tree_records": self.tree_rec,
                 "margin_tree_values": self.tree_val,
                 "margin_chunks": self.chunk_tree,
                 "margin_columns": self.col_chunk}
        return {k: t for k, t in named.items() if t is not None}

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in self.tensors().values())


def _staged_bytes(tree_rec, tree_val, a: int, b: int) -> int:
    """Bytes a block stages for pack trees ``[a, b)``: records and values
    each from the even index at or below the first to the even index at or
    above the end (16-byte copies), as ``csrc/margin.cu`` stages them."""
    n = ((int(tree_rec[b]) + 1) & ~1) - (int(tree_rec[a]) & ~1)
    v = 0 if tree_val is None else (
        ((int(tree_val[b]) + 1) & ~1) - (int(tree_val[a]) & ~1))
    return 8 * n + 8 * v


def margin_chunks(tree_rec, tree_val, n_trees: int, n_out: int,
                  budget: int | None = None) -> tuple:
    """Greedy chunks of each column's pack trees within ``budget`` staged
    bytes (``MARGIN_TABLE_BYTES`` by default; a tree past it alone is a
    chunk of its own, descended in global memory): ``(chunk_tree,
    col_chunk, table_bytes, chunk_trees)``."""
    budget = MARGIN_TABLE_BYTES if budget is None else int(budget)
    bounds, col_chunk, table, most = [], [0], 0, 1
    start = 0
    for c in range(n_out):
        end = start + len(range(c, n_trees, n_out))
        a = start
        while True:
            b = min(a + 1, end)
            while b < end and _staged_bytes(tree_rec, tree_val, a,
                                            b + 1) <= budget:
                b += 1
            bounds.append(a)
            nb = _staged_bytes(tree_rec, tree_val, a, b)
            if nb <= budget:
                table = max(table, nb)
            most = max(most, b - a)
            a = b
            if a >= end:
                break
        col_chunk.append(len(bounds))
        start = end
    bounds.append(n_trees)
    return (np.asarray(bounds, np.int32), np.asarray(col_chunk, np.int32),
            table, most)


def pack_margin(feature, threshold, left, right, root, values, *,
                n_out: int, form: str) -> MarginPack | None:
    """Re-pack a depth-packed table and its first value channel for the
    margin body (:class:`MarginPack`), on the columns' device; a model
    packs once when it is compiled. Host arithmetic over the columns (one
    copy to the host). Returns None when a feature id does not fit 16
    bits (checked before any copy) or a tree has more than 65,536 nodes:
    the general body then serves the model."""
    if form not in _MARGIN:
        raise ValueError(f"unknown traversal form {form!r}")
    if feature.numel() and int(feature.max()) >= _MARGIN_FEATURES:
        return None
    dev = root.device
    feat = feature.cpu().numpy().astype(np.int64)
    thr = threshold.to(torch.float32).cpu().numpy().view(np.int32)
    lft = left.cpu().numpy().astype(np.int64)
    rgt = right.cpu().numpy().astype(np.int64)
    vals = values[:, 0].cpu().numpy()
    T, K = int(root.shape[0]), int(n_out)
    order = np.concatenate(
        [np.arange(c, T, K) for c in range(K)] + [np.zeros(0, np.int64)])
    # breadth-first, level by level over all trees: every level stays in
    # pack-tree order, children in (left, right) pairs
    lvl_tree = np.arange(T, dtype=np.int64)
    lvl_node = root.cpu().numpy().astype(np.int64)[order]
    trees, nodes, depth = [], [], -1
    while lvl_node.size:
        trees.append(lvl_tree)
        nodes.append(lvl_node)
        depth += 1
        inner = feat[lvl_node] >= 0
        lvl_tree = np.repeat(lvl_tree[inner], 2)
        lvl_node = np.stack([lft[lvl_node[inner]], rgt[lvl_node[inner]]],
                            axis=1).reshape(-1)
    pt = np.concatenate(trees + [np.zeros(0, np.int64)])
    pn = np.concatenate(nodes + [np.zeros(0, np.int64)])
    perm = np.argsort(pt, kind="stable")  # tree-major, breadth-first
    pt, pn = pt[perm], pn[perm]
    tree_rec = np.searchsorted(pt, np.arange(T + 1)).astype(np.int64)
    local = np.arange(pn.size, dtype=np.int64) - tree_rec[pt]
    if local.size and local.max() >= _MARGIN_TREE_NODES:
        return None
    loc = np.zeros(max(feat.size, 1), np.int64)
    loc[pn] = local
    inner = feat[pn] >= 0
    lo = loc[lft[pn[inner]]]
    if not np.array_equal(loc[rgt[pn[inner]]], lo + 1):
        raise AssertionError("margin pack: siblings not adjacent")
    n_rec = pn.size + (pn.size & 1)
    rec = np.zeros((n_rec, 2), np.int32)
    rec[:pn.size, 0] = -1
    rec[:pn.size][inner, 0] = ((lo << 16) | feat[pn[inner]]).astype(
        np.uint32).view(np.int32)
    rec[:pn.size][inner, 1] = thr[pn[inner]]
    leaf = ~inner
    leaf_vals = tree_val = None
    if form == "traverse":
        rec[:pn.size][leaf, 1] = np.arange(int(leaf.sum()), dtype=np.int32)
        lv = vals[pn[leaf]].astype(np.float64)
        leaf_vals = np.zeros(lv.size + (lv.size & 1), np.float64)
        leaf_vals[:lv.size] = lv
        tree_val = np.concatenate([[0], np.cumsum(
            np.bincount(pt[leaf], minlength=T))]).astype(np.int64)
    else:
        rec[:pn.size][leaf, 1] = vals[pn[leaf]].astype(np.int32)
    chunk_tree, col_chunk, table, most = margin_chunks(
        tree_rec, tree_val, T, K)

    def up(a, dtype=torch.int32):
        return None if a is None else torch.from_numpy(
            np.ascontiguousarray(a)).to(dtype).to(dev)

    return MarginPack(
        form=form, n_out=K, n_trees=T, depth=max(depth, 0), rec=up(rec),
        leaf_vals=up(leaf_vals, torch.float64), tree_rec=up(tree_rec),
        tree_val=up(tree_val), chunk_tree=up(chunk_tree),
        col_chunk=up(col_chunk), table_bytes=int(table),
        chunk_trees=int(most),
        serves=bool(pn.size <= MARGIN_MEAN_NODES * max(T, 1)))


def plan_margin(form: str, n_rows: int, n_out: int, *, n_features: int,
                table_bytes: int, chunk_trees: int, n_sms: int = N_SMS,
                rows_per_block: int | None = None,
                row_groups: int | None = None,
                threads_per_row: int | None = None,
                stage: bool | None = None) -> dict:
    """Tiling of one margin-body launch (host arithmetic, no device).

    Block ``(p, c)`` takes output column ``c`` and row tiles ``p, p + P,
    ...`` of ``rows_per_block`` rows (R); ``P = row_groups`` blocks a
    column, one per SM by default (``n_sms // n_out``), so the grid is one
    resident wave and each block stages a column chunk once for all its
    tiles. R is the batch spread evenly over the groups, at most
    ``MARGIN_ROWS``, and cut (to 32 at the least) while the block's X rows
    would not fit beside its table chunk. ``threads`` is R times G
    descending threads a row
    (as many of a chunk's trees as 1,024 threads hold: the descents are
    bound by shared-memory bank conflicts and want every thread the block
    can hold); K4's terms go through shared memory ``trees_per_pass``
    trees at a time (``MARGIN_TERMS_BYTES`` at most). The table chunk is
    staged when R reaches ``MARGIN_STAGE_ROWS``, and the X rows where they
    fit next to it. ``rows_per_block``, ``row_groups``,
    ``threads_per_row`` and ``stage`` force the tiling (``chip_smoke.py``
    times alternatives). Raises ``ValueError`` when a block cannot fit in
    ``SMEM_BYTES``.
    """
    ordered = form == "traverse"
    acc_bytes = _FORMS[form][4].itemsize
    N, K = max(int(n_rows), 1), max(int(n_out), 1)
    groups = max(1, n_sms // K) if row_groups is None else int(row_groups)
    if groups < 1:
        raise ValueError("row_groups must be at least 1")
    if rows_per_block is None:
        r = min(MARGIN_ROWS, -(-N // groups))
        r = -(-N // (groups * -(-N // (groups * r))))  # even tiles
    else:
        r = int(rows_per_block)
        if not 1 <= r <= 1024:
            raise ValueError("rows_per_block must be in [1, 1024]")
    most = max(int(chunk_trees), 1)
    x_stride = int(n_features) | 1

    def layout(r):
        """(staged, table bytes, G, threads, trees a pass, smem with and
        without the X rows) of an R-row block."""
        staged = (r >= MARGIN_STAGE_ROWS if stage is None else bool(stage)) \
            and table_bytes > 0
        tb = int(table_bytes) if staged else 0
        if threads_per_row is not None:
            g = int(threads_per_row)
            if not 1 <= g <= 1024 // r:
                raise ValueError(
                    f"threads_per_row must be in [1, {1024 // r}]")
        else:
            g = max(1, min(1024 // r, most))
        ts = most
        if ordered:  # whole rounds of the G threads' trees
            ts = min(most, max(g, MARGIN_TERMS_BYTES // (r * 8)))
            ts -= ts % g if ts < most else 0
        return (staged, tb, g, -(-r * g // 32) * 32, ts,
                margin_smem_bytes(r, ts, tb, x_stride, acc_bytes, True),
                margin_smem_bytes(r, ts, tb, x_stride, acc_bytes, False))

    staged, tb, g, threads, ts, smem_x, smem = layout(r)
    if rows_per_block is None:
        # fewer rows before the X rows leave shared memory: a descent
        # step reads X, and from global memory it is slower (PERF.md §6)
        fit = r
        while fit > 32 and smem_x > SMEM_BYTES:
            fit -= 1
            staged, tb, g, threads, ts, smem_x, smem = layout(fit)
        if smem_x <= SMEM_BYTES:
            r = fit
        else:
            staged, tb, g, threads, ts, smem_x, smem = layout(r)
    stage_x = smem_x <= SMEM_BYTES
    if stage_x:
        smem = smem_x
    if smem > SMEM_BYTES:
        raise ValueError(
            f"{form}: a margin block of {r} rows with a {tb}-byte table "
            f"chunk needs {smem} bytes of shared memory, over {SMEM_BYTES}"
        )
    tiles = -(-N // r)
    groups = min(groups, tiles)
    return dict(body="margin", rows_per_block=r, threads_per_row=g,
                row_groups=groups, tiles=tiles, threads=threads,
                blocks=K * groups,
                trees_per_pass=ts, stage=staged, table_bytes=tb,
                stage_x=stage_x, x_stride=x_stride, smem=smem)


def _check_inputs(form: str, X, table, values, *, agg: str, n_out: int,
                  n_features: int, n_steps: int, record=None, baseline=None,
                  pack=None) -> None:
    """Raise on anything the kernels do not take (both devices)."""
    _, feat_t, thr_t, val_t, acc_t = _FORMS[form]
    feature, threshold, left, right, root = table
    if agg not in _AGG_CODE or (form == "traverse_q" and agg == "norm"):
        raise ValueError(f"{form}: unknown or unsupported mode {agg!r}")
    tensors = (X, feature, threshold, left, right, root, values)
    if any(t.device != X.device for t in tensors):
        raise ValueError(f"{form}: X, table and values must share a device")
    want = ((X, torch.float32, 2, "X"), (feature, feat_t, 1, "feature"),
            (threshold, thr_t, 1, "threshold"),
            (left, torch.int32, 1, "left"), (right, torch.int32, 1, "right"),
            (root, torch.int32, 1, "root"), (values, val_t, 2, "values"))
    if record is not None:
        want += ((record, torch.int32, 2, "record"),)
    if baseline is not None:
        want += ((baseline, acc_t, 1, "baseline"),)
        if baseline.shape[0] != n_out or baseline.device != X.device:
            raise ValueError(
                f"{form}: baseline must hold n_out={n_out} values on X's "
                f"device, got {tuple(baseline.shape)} on {baseline.device}"
            )
    for t, dtype, dim, name in want:
        if t.dtype != dtype or t.dim() != dim:
            raise ValueError(
                f"{form}: {name} must be a {dim}-D {dtype} tensor, got "
                f"{t.dim()}-D {t.dtype}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{form}: {name} must be contiguous")
    if X.shape[1] != n_features:
        raise ValueError(
            f"{form}: X has {X.shape[1]} features, the table was built for "
            f"{n_features}"
        )
    M = feature.shape[0]
    if not (threshold.shape[0] == left.shape[0] == right.shape[0]
            == values.shape[0] == M):
        raise ValueError(f"{form}: table columns and values differ in length")
    if record is not None and (record.shape != (M, 4)
                               or record.device != X.device):
        raise ValueError(
            f"{form}: record must be the table's (M, 4) pack_nodes on X's "
            f"device, got {tuple(record.shape)} on {record.device}"
        )
    if n_out < 1 or values.shape[1] < 1 or (
            agg != "percls" and n_out != values.shape[1]):
        raise ValueError(
            f"{form}: n_out={n_out} does not fit {values.shape[1]} value "
            f"channels in mode {agg!r}"
        )
    if pack is not None and (
            pack.form != form or pack.n_out != n_out
            or pack.n_trees != root.shape[0] or pack.depth > n_steps
            or pack.rec.device != X.device):
        raise ValueError(
            f"{form}: the margin pack ({pack.form}, {pack.n_trees} trees "
            f"into {pack.n_out} columns, depth {pack.depth}, on "
            f"{pack.rec.device}) is not this table's: {root.shape[0]} trees "
            f"into {n_out} columns, {n_steps} steps, on {X.device}"
        )


def _takes_margin(form: str, agg: str, pack, body: str | None) -> bool:
    """Whether a launch takes the margin body: in ``percls`` with a pack
    that ``serves`` (small trees, where the margin body beats the general
    one: ``PERF.md`` §6), or with
    ``body="margin"`` forced over any pack (``"traverse"`` forces the
    general body). Host arithmetic, no device."""
    if body == "margin" and (agg != "percls" or pack is None):
        raise ValueError(f"{form}: the margin body needs agg='percls' and "
                         "a margin pack")
    return agg == "percls" and pack is not None and (
        body == "margin" or (body is None and pack.serves))


def body_for(form: str, agg: str | None, pack, device, *,
             _body: str | None = None) -> str:
    """The body a launch of ``form`` (``"traverse"``/``"traverse_q"``) in
    ``agg`` over ``pack`` on ``device`` takes, under its launch counter's
    name (:data:`launches`): ``"margin"``/``"margin_q"`` where
    :func:`_takes_margin`, else ``form``; ``"plain"`` off CUDA, where the
    plain version runs. The one routing rule: :func:`_launch` routes by
    it, and a compiled model records it (``serving_kernel``). ``_body``
    forces a body as :func:`_launch`'s does. Host arithmetic, no device."""
    if torch.device(device).type != "cuda":
        return "plain"
    return _MARGIN[form][1] if _takes_margin(form, agg, pack, _body) \
        else form


def _launch(form: str, X, table, values, record, *, n_steps: int, agg: str,
            n_out: int, baseline=None, pack=None,
            _rows_per_block: int | None = None, _body: str | None = None,
            _tiling: dict | None = None) -> torch.Tensor:
    """Allocate the (N, n_out) output and launch one kernel once on the
    current stream, without synchronising: the margin body for ``percls``
    where ``pack`` is given and ``pack.serves`` (:func:`body_for`),
    else the general one (packing ``record`` when None).
    Only ``chip_smoke.py`` and the card's tests pass the private
    arguments, to time and check alternatives against each other:
    ``_body`` forces a body (``"margin"`` over any pack, ``"traverse"``
    the general one in ``percls`` too), and ``_rows_per_block`` and
    ``_tiling`` (:func:`plan_margin`'s forcing arguments, which force the
    margin body) force a tiling."""
    name, *_, acc_t = _FORMS[form]
    N, F = X.shape
    feature, threshold, left, right, root = table
    T = root.shape[0]
    if N == 0 or T == 0:
        out = torch.zeros((N, n_out), dtype=acc_t, device=X.device)
        return out if baseline is None else out + baseline
    if body_for(form, agg, pack, X.device,
                _body="margin" if _tiling is not None and _body is None
                else _body) != form:
        return _launch_margin(form, X, pack, n_steps=n_steps, n_out=n_out,
                              baseline=baseline, tiling=_tiling)
    if record is None:
        record = pack_nodes(feature, threshold, left, right)
    p = plan(form, N, T, n_out, n_features=F, agg=agg,
             n_sms=sm_count(X.device), rows_per_block=_rows_per_block)
    out = torch.empty((N, n_out), dtype=acc_t, device=X.device)
    lib = _library()
    with torch.cuda.device(X.device):
        code = getattr(lib, name)(
            X.data_ptr(), record.data_ptr(), root.data_ptr(),
            values.data_ptr(),
            None if baseline is None else baseline.data_ptr(),
            out.data_ptr(), N, F, T, n_steps,
            values.shape[1], n_out, _AGG_CODE[agg], p["rows_per_block"],
            p["trees_per_chunk"], int(p["stage_x"]), p["threads"],
            p["smem"], torch.cuda.current_stream(X.device).cuda_stream,
        )
    if code != 0:
        msg = lib.mpt_traverse_error_string(code).decode()
        raise RuntimeError(f"{form} launch failed: CUDA error {code} ({msg})")
    launches[form] += 1
    return out


def _launch_margin(form: str, X, pack: MarginPack, *, n_steps: int,
                   n_out: int, baseline=None,
                   tiling: dict | None = None) -> torch.Tensor:
    """The margin body's launch (``csrc/margin.cu``), as :func:`_launch`."""
    if pack.depth > n_steps:  # the descent must reach every leaf
        raise ValueError(f"{form}: the margin pack is {pack.depth} deep, "
                         f"over n_steps={n_steps}")
    name, key = _MARGIN[form]
    acc_t = _FORMS[form][4]
    N, F = X.shape
    p = plan_margin(form, N, n_out, n_features=F,
                    table_bytes=pack.table_bytes,
                    chunk_trees=pack.chunk_trees, n_sms=sm_count(X.device),
                    **(tiling or {}))
    out = torch.empty((N, n_out), dtype=acc_t, device=X.device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    lib = _margin_library()
    with torch.cuda.device(X.device):
        code = getattr(lib, name)(
            X.data_ptr(), pack.rec.data_ptr(), ptr(pack.leaf_vals),
            pack.tree_rec.data_ptr(), ptr(pack.tree_val),
            pack.chunk_tree.data_ptr(), pack.col_chunk.data_ptr(),
            ptr(baseline), out.data_ptr(), N, F, n_out, n_steps,
            p["rows_per_block"], p["threads_per_row"], p["row_groups"],
            p["trees_per_pass"],
            int(p["stage"]), p["table_bytes"], int(p["stage_x"]),
            p["x_stride"], p["threads"], p["smem"],
            torch.cuda.current_stream(X.device).cuda_stream,
        )
    if code != 0:
        msg = lib.mpt_margin_error_string(code).decode()
        raise RuntimeError(f"{form} margin launch failed: CUDA error {code} "
                           f"({msg})")
    launches[key] += 1
    return out


def traverse_reference(X, feature, threshold, left, right, root, values, *,
                       n_steps: int, agg: str, n_out: int,
                       baseline=None) -> torch.Tensor:
    """K4's plain version: ``traversal.descend`` + ``traversal.accumulate``."""
    node = traversal.descend(X, feature, threshold, left, right, root,
                             n_steps)
    return traversal.accumulate(node, values, agg=agg, n_out=n_out,
                                baseline=baseline)


def traverse_q_reference(X, feature, threshold, left, right, root, qvals, *,
                         n_steps: int, agg: str, n_out: int) -> torch.Tensor:
    """K5's plain version: the descent over the int16/bfloat16 columns
    (both upcasts exact) and the int32 lattice sum."""
    node = traversal.descend(X, feature.to(torch.int32),
                             threshold.to(torch.float32), left, right, root,
                             n_steps)
    return traversal.accumulate(node, qvals.to(torch.int32), agg=agg,
                                n_out=n_out)


def traverse(X, feature, threshold, left, right, root, values, *,
             n_steps: int, agg: str, n_out: int, n_features: int,
             record: torch.Tensor | None = None,
             baseline: torch.Tensor | None = None,
             pack: MarginPack | None = None) -> torch.Tensor:
    """K4: (N, n_out) float64 ensemble reduction (no division by the tree
    count: the caller owns the per-kind tail). A kernel on CUDA tensors,
    :func:`traverse_reference` on CPU tensors. ``record`` is the columns'
    :func:`pack_nodes`, kept by the caller; without it the kernel's call
    packs them first. ``pack`` is the columns' :func:`pack_margin`, made
    once by the caller: a ``percls`` launch descends it where it
    ``serves``; without it the general body runs.
    ``baseline`` ((n_out,) float64 on X's device, a boosted model's
    baseline margins) is where every row's accumulator starts, so the
    trees add to it in the estimator's order."""
    table = (feature, threshold, left, right, root)
    _check_inputs("traverse", X, table, values, agg=agg, n_out=n_out,
                  n_features=n_features, n_steps=n_steps, record=record,
                  baseline=baseline, pack=pack)
    if X.is_cuda:
        return _launch("traverse", X, table, values, record,
                       n_steps=n_steps, agg=agg, n_out=n_out,
                       baseline=baseline, pack=pack)
    return traverse_reference(X, *table, values, n_steps=n_steps, agg=agg,
                              n_out=n_out, baseline=baseline)


def traverse_q(X, feature, threshold, left, right, root, qvals, *,
               n_steps: int, agg: str, n_out: int, n_features: int,
               record: torch.Tensor | None = None,
               pack: MarginPack | None = None) -> torch.Tensor:
    """K5: (N, n_out) int32 lattice sum over the quantized tables. A
    kernel on CUDA tensors, :func:`traverse_q_reference` on CPU tensors;
    ``record`` and ``pack`` as for :func:`traverse`."""
    table = (feature, threshold, left, right, root)
    _check_inputs("traverse_q", X, table, qvals, agg=agg, n_out=n_out,
                  n_features=n_features, n_steps=n_steps, record=record,
                  pack=pack)
    if X.is_cuda:
        return _launch("traverse_q", X, table, qvals, record,
                       n_steps=n_steps, agg=agg, n_out=n_out, pack=pack)
    return traverse_q_reference(X, *table, qvals, n_steps=n_steps, agg=agg,
                                n_out=n_out)

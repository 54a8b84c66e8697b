"""The boosted-margin body's host side on the CPU: pack, planner and a
replay of the kernel's order.

The margin body (``csrc/margin.cu``) runs only on the card
(``tests/test_torch_cuda.py``); what it is told to do is decided here, in
Python, and tested here:

- :func:`serve_kernel.pack_margin` keeps every tree (records breadth-first
  with adjacent siblings, leaves carrying their value or its index) and
  groups the trees by output column in member order;
- :func:`serve_kernel.plan_margin` gives every (row, tree) pair to exactly
  one block, row tile and pass, within the shared-memory budget, at the
  shapes of phase 23 in ``chip_smoke.py`` (700 trees into 7 columns, 100
  into 1, a column count that does not divide the tree count) from 1 to
  500,000 rows;
- a numpy replay of the kernel (its chunks, row tiles, passes, staged
  offsets and 8-byte record descents) equals the plain versions bit for
  bit: K4 in float64 from the baseline row, K5 as an int32 sum;
- on boosted models fitted by the JAX package and carried over through its
  model file, the replayed margins equal the JAX package's served answers
  bit for bit (the contract ``tests/test_torch_boosting_serve.py`` holds
  the port's served margins to).
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import mpitree_tpu_torch as P  # noqa: E402
from mpitree_tpu_torch.obs import memory  # noqa: E402
from mpitree_tpu_torch.serving import quantize, serve_kernel  # noqa: E402
from mpitree_tpu_torch.serving.tables import tables_for  # noqa: E402
from mpitree_tpu_torch.utils.datasets import (  # noqa: E402
    california_like,
    covtype_like,
)

CPU = torch.device("cpu")
F = 54
# (trees, output columns, depth): phase 23's classifier and regressor
# (their trees cut to depth 3), and a column count that does not divide
# the trees
SHAPES = ((700, 7, 3), (100, 1, 3), (50, 3, 6), (10, 4, 4))
ROWS = (1, 63, 64, 3_000, 4_096, 500_000)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread for this module (as ``tests/test_torch_boosting.py``
    keeps it): the replays and fits are many small operations, which
    pytest-xdist's parallel workers would oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(rng, X, depth: int, p_split: float = 0.9):
    """A random binary tree to ``depth``, split on ``X``'s own values."""
    feat, thr, left, right, dep = [], [], [], [], []

    def add(d):
        i = len(feat)
        feat.append(-1)
        thr.append(np.nan)
        left.append(-1)
        right.append(-1)
        dep.append(d)
        if d < depth and (d == 0 or rng.random() < p_split):
            f = int(rng.integers(X.shape[1]))
            feat[i], thr[i] = f, float(X[rng.integers(len(X)), f])
            lo = add(d + 1)
            hi = add(d + 1)
            left[i], right[i] = lo, hi
        return i

    add(0)
    return SimpleNamespace(
        n_nodes=len(feat), depth=np.array(dep),
        feature=np.array(feat, np.int32),
        threshold=np.array(thr, np.float32), left=np.array(left),
        right=np.array(right))


@pytest.fixture(scope="module")
def ensembles():
    """(T, K, depth) -> (flat table, X rows, K4 values, baseline, K5 int8
    values), seeded."""
    X = covtype_like(4_096, seed=5)[0]
    out = {}
    for T, K, depth in SHAPES:
        rng = np.random.default_rng(T * 10 + K)
        [table] = tables_for([_tree(rng, X, depth) for _ in range(T)],
                             group_bytes=None)
        vals = torch.from_numpy(rng.normal(size=(table.n_nodes, 1)) * 0.1)
        base = torch.from_numpy(rng.normal(size=K))
        qv = torch.from_numpy(rng.integers(
            -127, 128, size=(table.n_nodes, 1)).astype(np.int8))
        out[T, K, depth] = (table, X, vals, base, qv)
    return out


def _qcols(table):
    f, t, lo, hi, root, _ = table.dev_arrays(CPU)
    return (f.to(torch.int16), quantize.quantize_thresholds(table.threshold),
            lo, hi, root)


def replay(X, pack, plan, n_steps: int, init=None) -> np.ndarray:
    """``csrc/margin.cu`` written out in numpy: block ``(p, c)`` takes
    column ``c``'s chunks in order (staged, where the plan stages and the
    chunk fits, as a copy from the even record and value indices), each
    over row tiles ``p, p + P, ...``; each pass of trees descends the
    8-byte records from the tree's first record (child ``left`` or
    ``left + 1``) and adds its terms in member order (K4) or as int32
    (K5), carrying the sum over chunks in ``out``."""
    ordered = pack.form == "traverse"
    rec = pack.rec.numpy()
    lv = pack.leaf_vals.numpy() if ordered else None
    trec = pack.tree_rec.numpy()
    tval = pack.tree_val.numpy() if ordered else None
    ct, cc = pack.chunk_tree.numpy(), pack.col_chunk.numpy()
    N, K = X.shape[0], pack.n_out
    R, groups, ts = (plan["rows_per_block"], plan["row_groups"],
                     plan["trees_per_pass"])
    out = np.full((N, K), np.nan if ordered else -(1 << 30),
                  np.float64 if ordered else np.int32)
    tiles = -(-N // R)
    for blk in range(K * groups):
        c, p = blk % K, blk // K
        k0, k1 = int(cc[c]), int(cc[c + 1])
        for k in range(k0, k1):
            ta, tb = int(ct[k]), int(ct[k + 1])
            r0, r1 = trec[ta] & ~1, (trec[tb] + 1) & ~1
            v0 = v1 = 0
            if ordered:
                v0, v1 = tval[ta] & ~1, (tval[tb] + 1) & ~1
            staged = plan["stage"] and (
                8 * (r1 - r0) + 8 * (v1 - v0) <= plan["table_bytes"])
            rp, vp, roff, voff = rec, lv, 0, 0
            if staged:
                rp, roff = rec[r0:r1].copy(), r0
                if ordered:
                    vp, voff = lv[v0:v1].copy(), v0
            for i in range(p, tiles, groups):
                row0 = i * R
                rows = min(R, N - row0)
                x = X[row0:row0 + rows]
                if k != k0:
                    a = out[row0:row0 + rows, c].copy()
                else:
                    a = np.full(rows, 0 if init is None else init[c],
                                out.dtype)
                for s0 in range(ta, tb, ts):
                    terms = []
                    for t in range(s0, min(s0 + ts, tb)):
                        base = trec[t] - roff
                        cur = np.full(rows, base)
                        rc = rp[cur]
                        for _ in range(n_steps):
                            live = rc[:, 0] != -1
                            f = np.where(live, rc[:, 0] & 0xFFFF, 0)
                            go = ~(x[np.arange(rows), f]
                                   <= rc[:, 1].view(np.float32))
                            left = (rc[:, 0].view(np.uint32) >> 16).astype(
                                np.int64)
                            cur = np.where(live, base + left + go, cur)
                            rc = rp[cur]
                        assert (rc[:, 0] == -1).all()  # every row at a leaf
                        terms.append(vp[rc[:, 1] - voff] if ordered
                                     else rc[:, 1])
                    for v in terms:
                        a = a + v
                out[row0:row0 + rows, c] = a
    return out


def _plan(form, N, K, pack, **kw):
    return serve_kernel.plan_margin(
        form, N, K, n_features=F, table_bytes=pack.table_bytes,
        chunk_trees=pack.chunk_trees, **kw)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "T{}-K{}-d{}".format(
    *s))
def test_pack_keeps_every_tree_grouped_by_column(ensembles, shape):
    table, X, vals, _, qv = ensembles[shape]
    T, K, _ = shape
    cols = table.dev_arrays(CPU)[:5]
    pack = serve_kernel.pack_margin(*cols, vals, n_out=K, form="traverse")
    rec, trec = pack.rec.numpy(), pack.tree_rec.numpy()
    assert pack.depth == table.n_steps and pack.n_trees == T
    assert rec.shape[0] % 2 == 0 and pack.leaf_vals.numel() % 2 == 0
    assert trec[-1] == table.n_nodes and np.all(np.diff(trec) >= 1)
    leaves = rec[:table.n_nodes, 0] == -1
    assert leaves.sum() == (table.n_nodes + T) // 2  # binary trees
    # each leaf's index runs over the leaf values in pack order
    assert np.array_equal(rec[:table.n_nodes][leaves, 1],
                          np.arange(leaves.sum()))
    assert sorted(pack.leaf_vals.numpy()[:leaves.sum()]) == sorted(
        vals.numpy()[table.feature < 0, 0])
    # pack tree i is member c + K * j: column c's trees in member order
    order = np.concatenate([np.arange(c, T, K) for c in range(K)])
    sizes = np.diff(trec)
    tree_nodes = np.zeros(T, np.int64)
    stack = [(int(r), t) for t, r in enumerate(table.root)]
    while stack:
        n, t = stack.pop()
        tree_nodes[t] += 1
        if table.feature[n] >= 0:
            stack += [(int(table.left[n]), t), (int(table.right[n]), t)]
    assert np.array_equal(sizes, tree_nodes[order])
    # chunks: whole trees of one column, every column at least one
    ct, cc = pack.chunk_tree.numpy(), pack.col_chunk.numpy()
    assert cc[0] == 0 and cc[-1] == len(ct) - 1 and np.all(np.diff(cc) >= 1)
    starts = np.concatenate([[0], np.cumsum(
        [len(range(c, T, K)) for c in range(K)])])
    for c in range(K):
        bounds = ct[cc[c]:cc[c + 1] + 1]
        assert bounds[0] == starts[c] and bounds[-1] == starts[c + 1]
        assert np.all(np.diff(bounds) >= 0)
    # K5 keeps its int8 values in the records, and no value array
    qp = serve_kernel.pack_margin(*_qcols(table), qv, n_out=K,
                                  form="traverse_q")
    assert qp.leaf_vals is None and qp.tree_val is None
    qrec = qp.rec.numpy()
    assert np.array_equal(qrec[:, 0], rec[:, 0])
    assert sorted(qrec[:table.n_nodes][leaves, 1]) == sorted(
        qv.numpy()[table.feature < 0, 0].astype(np.int32))


@pytest.mark.parametrize("N", ROWS)
@pytest.mark.parametrize("shape", SHAPES[:3], ids=lambda s: "T{}-K{}".format(
    *s))
def test_plan_covers_every_pair_once_within_budget(ensembles, shape, N):
    table, _, vals, _, qv = ensembles[shape]
    T, K, _ = shape
    cols = table.dev_arrays(CPU)[:5]
    for form, pack in (
            ("traverse", serve_kernel.pack_margin(*cols, vals, n_out=K,
                                                  form="traverse")),
            ("traverse_q", serve_kernel.pack_margin(
                *_qcols(table), qv, n_out=K, form="traverse_q"))):
        p = _plan(form, N, K, pack)
        R, groups = p["rows_per_block"], p["row_groups"]
        assert 1 <= R <= serve_kernel.MARGIN_ROWS
        assert p["blocks"] == K * groups <= max(K, serve_kernel.N_SMS)
        # row tiles p, p + groups, ... of every column cover [0, N) once
        tiles = [i for g in range(groups) for i in range(g, p["tiles"],
                                                          groups)]
        assert sorted(tiles) == list(range(p["tiles"]))
        assert p["tiles"] * R >= N > (p["tiles"] - 1) * R
        # every descending thread maps to one (row, tree slot): R x G,
        # at least one tree a thread and pass
        G = p["threads_per_row"]
        assert G >= 1 and R * G <= p["threads"] <= 1024
        assert p["threads"] % 32 == 0 and p["threads"] - R * G < 32
        assert p["trees_per_pass"] >= min(G, pack.chunk_trees)
        # the chunks cover each column's trees once, in member order
        ct, cc = pack.chunk_tree.numpy(), pack.col_chunk.numpy()
        order = np.concatenate([np.arange(c, T, K) for c in range(K)])
        seen = [order[t] for k in range(len(ct) - 1)
                for t in range(ct[k], ct[k + 1])]
        assert seen == list(order)
        acc = 8 if form == "traverse" else 4
        assert p["smem"] == memory.margin_smem_bytes(
            R, p["trees_per_pass"], p["table_bytes"], p["x_stride"], acc,
            p["stage_x"]) <= serve_kernel.SMEM_BYTES
        assert p["stage"] == (R >= serve_kernel.MARGIN_STAGE_ROWS)
        assert p["table_bytes"] == (pack.table_bytes if p["stage"] else 0)
        assert pack.table_bytes <= serve_kernel.MARGIN_TABLE_BYTES
        if form == "traverse":  # one pass of terms within its budget
            assert R * p["trees_per_pass"] * 8 <= max(
                serve_kernel.MARGIN_TERMS_BYTES, R * G * 8)


def test_plan_forcing_and_refusals(ensembles):
    table, _, vals, _, _ = ensembles[700, 7, 3]
    pack = serve_kernel.pack_margin(*table.dev_arrays(CPU)[:5], vals,
                                    n_out=7, form="traverse")
    p = _plan("traverse", 4_096, 7, pack, rows_per_block=32, row_groups=4,
              stage=False)
    assert (p["rows_per_block"], p["row_groups"], p["stage"]) == (32, 4,
                                                                  False)
    assert p["table_bytes"] == 0 and p["blocks"] == 28
    with pytest.raises(ValueError, match="rows_per_block"):
        _plan("traverse", 64, 7, pack, rows_per_block=0)
    with pytest.raises(ValueError, match="row_groups"):
        _plan("traverse", 64, 7, pack, row_groups=0)
    # rows too wide to stage beside the table: X stays in global memory
    wide = serve_kernel.plan_margin("traverse", 4_096, 7, n_features=60_000,
                                    table_bytes=pack.table_bytes,
                                    chunk_trees=pack.chunk_trees)
    assert not wide["stage_x"] and wide["smem"] <= serve_kernel.SMEM_BYTES
    # a table past the budget cannot be planned
    with pytest.raises(ValueError, match="shared memory"):
        serve_kernel.plan_margin("traverse", 4_096, 7, n_features=F,
                                 table_bytes=serve_kernel.SMEM_BYTES,
                                 chunk_trees=100)
    # a chunk budget of a few trees: more chunks, the same cover
    ct, cc, tb, most = serve_kernel.margin_chunks(
        pack.tree_rec.numpy(), pack.tree_val.numpy(), 700, 7, budget=4_096)
    assert tb <= 4_096 and most < 100 and len(ct) - 1 > 7
    assert cc[-1] == len(ct) - 1 and ct[-1] == 700


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "T{}-K{}-d{}".format(
    *s))
def test_pack_serves_small_trees(ensembles, shape):
    """The margin body serves an ensemble whose trees average at most
    ``MARGIN_MEAN_NODES`` nodes, in both forms, however many chunks its
    columns take (the shapes here are all small); the rule reads the node
    count only."""
    table, _, vals, _, qv = ensembles[shape]
    T, K, _ = shape
    cols = table.dev_arrays(CPU)[:5]
    for pack in (serve_kernel.pack_margin(*cols, vals, n_out=K,
                                          form="traverse"),
                 serve_kernel.pack_margin(*_qcols(table), qv, n_out=K,
                                          form="traverse_q")):
        assert table.n_nodes <= serve_kernel.MARGIN_MEAN_NODES * T
        assert pack.serves
    with pytest.MonkeyPatch.context() as mp:  # a chunk of a few trees
        mp.setattr(serve_kernel, "MARGIN_TABLE_BYTES", 1_024)
        pack = serve_kernel.pack_margin(*cols, vals, n_out=K,
                                        form="traverse")
        assert pack.serves and (T <= K or pack.chunk_tree.numel() - 1 > K)
        mp.setattr(serve_kernel, "MARGIN_MEAN_NODES",
                   table.n_nodes // T - 1)
        assert not serve_kernel.pack_margin(*cols, vals, n_out=K,
                                            form="traverse").serves


def test_large_trees_keep_the_general_body():
    """Phase 6's shape cut down: 20 trees of depth 12 (thousands of nodes
    each) into 3 columns: the pack does not serve."""
    X = covtype_like(4_096, seed=5)[0]
    rng = np.random.default_rng(12)
    [table] = tables_for([_tree(rng, X, 12, p_split=0.97)
                          for _ in range(20)], group_bytes=None)
    vals = torch.from_numpy(rng.normal(size=(table.n_nodes, 1)))
    pack = serve_kernel.pack_margin(*table.dev_arrays(CPU)[:5], vals,
                                    n_out=3, form="traverse")
    assert pack is not None and pack.depth == 12
    assert table.n_nodes > serve_kernel.MARGIN_MEAN_NODES * 20
    assert not pack.serves


@pytest.mark.parametrize("case", [
    ("percls", "serves", None, True), ("percls", "serves", "traverse", False),
    ("percls", "not", None, False), ("percls", "not", "margin", True),
    ("percls", None, None, False), ("sum", "serves", None, False),
    ("percls", None, "margin", ValueError), ("sum", "serves", "margin",
                                             ValueError),
], ids=lambda c: "-".join(str(v) for v in c[:3]))
def test_launch_takes_the_margin_body_where_the_pack_serves(case):
    """The launch's routing: the margin body for ``percls`` over a pack
    that serves, the general body without a pack or over one that does
    not; a forced body overrides it, and the margin body cannot be forced
    without a pack or outside ``percls``."""
    agg, pack, body, want = case
    pack = None if pack is None else SimpleNamespace(serves=pack == "serves")
    if want is ValueError:
        with pytest.raises(ValueError, match="margin pack"):
            serve_kernel._takes_margin("traverse", agg, pack, body)
    else:
        assert serve_kernel._takes_margin("traverse", agg, pack, body) \
            is want


@pytest.mark.parametrize("tiling", [
    {}, dict(rows_per_block=7, row_groups=3), dict(rows_per_block=16),
    dict(rows_per_block=64, stage=True), dict(rows_per_block=5, stage=True),
    dict(row_groups=1),
], ids=lambda t: "-".join(f"{k}{v}" for k, v in t.items()) or "planned")
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "T{}-K{}-d{}".format(
    *s))
def test_replay_equals_plain_versions_bit_for_bit(ensembles, shape, tiling):
    table, X, vals, base, qv = ensembles[shape]
    T, K, _ = shape
    cols = table.dev_arrays(CPU)[:5]
    N = 300 if tiling else 1_000
    Xt = torch.from_numpy(X[:N])
    kw = dict(n_steps=table.n_steps, agg="percls", n_out=K)
    pack = serve_kernel.pack_margin(*cols, vals, n_out=K, form="traverse")
    want = serve_kernel.traverse_reference(Xt, *cols, vals, baseline=base,
                                           **kw).numpy()
    got = replay(X[:N], pack, _plan("traverse", N, K, pack, **tiling),
                 table.n_steps, base.numpy())
    np.testing.assert_array_equal(got, want)
    qcols = _qcols(table)
    qp = serve_kernel.pack_margin(*qcols, qv, n_out=K, form="traverse_q")
    wq = serve_kernel.traverse_q_reference(Xt, *qcols, qv, **kw).numpy()
    got = replay(X[:N], qp, _plan("traverse_q", N, K, qp, **tiling),
                 table.n_steps)
    np.testing.assert_array_equal(got, wq)


def test_replay_across_chunks_carries_the_sum(ensembles, monkeypatch):
    """A chunk budget of a few trees: every column takes several chunks
    (some staged, a tree past the budget descended in place), and the sum
    carried in ``out`` between them stays the member-order chain."""
    table, X, vals, base, _ = ensembles[50, 3, 6]
    monkeypatch.setattr(serve_kernel, "MARGIN_TABLE_BYTES", 1_024)
    cols = table.dev_arrays(CPU)[:5]
    pack = serve_kernel.pack_margin(*cols, vals, n_out=3, form="traverse")
    assert pack.chunk_tree.numel() - 1 > 3 and pack.table_bytes <= 1_024
    ct, trec, tval = (pack.chunk_tree.numpy(), pack.tree_rec.numpy(),
                      pack.tree_val.numpy())
    assert any(serve_kernel._staged_bytes(trec, tval, ct[k], ct[k + 1])
               > 1_024 for k in range(len(ct) - 1))  # one in place
    want = serve_kernel.traverse_reference(
        torch.from_numpy(X[:200]), *cols, vals, baseline=base,
        n_steps=table.n_steps, agg="percls", n_out=3).numpy()
    for R in (16, 200):
        got = replay(X[:200], pack, _plan("traverse", 200, 3, pack,
                                          rows_per_block=R),
                     table.n_steps, base.numpy())
        np.testing.assert_array_equal(got, want)


def test_pack_refuses_what_its_records_cannot_hold():
    """A feature id past 16 bits or a tree of more than 65,536 nodes has
    no margin pack (the general body then serves the model); the wrapper
    checks a pack against its table."""
    feature = torch.tensor([70_000, -1, -1], dtype=torch.int32)
    cols = (feature, torch.tensor([0.5, np.nan, np.nan]),
            torch.tensor([1, -1, -1], dtype=torch.int32),
            torch.tensor([2, -1, -1], dtype=torch.int32),
            torch.tensor([0], dtype=torch.int32))
    vals = torch.zeros((3, 1), dtype=torch.float64)
    assert serve_kernel.pack_margin(*cols, vals, n_out=1,
                                    form="traverse") is None
    # a heap-shaped tree of 65,537 nodes: its last id is past 16 bits
    n = 1 << 16
    inner = np.arange(n // 2, dtype=np.int32)
    f = np.full(n + 1, -1, np.int32)
    f[inner] = 0
    left = np.full(n + 1, -1, np.int32)
    right = np.full(n + 1, -1, np.int32)
    left[inner], right[inner] = 2 * inner + 1, 2 * inner + 2
    deep = (torch.from_numpy(f), torch.zeros(n + 1), torch.from_numpy(left),
            torch.from_numpy(right), torch.tensor([0], dtype=torch.int32))
    assert serve_kernel.pack_margin(
        *deep, torch.zeros((n + 1, 1), dtype=torch.float64), n_out=1,
        form="traverse") is None
    ok = serve_kernel.pack_margin(feature.clamp(max=5), *cols[1:], vals,
                                  n_out=1, form="traverse")
    assert ok is not None and ok.depth == 1
    X = torch.zeros((2, 6))
    kw = dict(n_steps=1, agg="percls", n_features=6)
    with pytest.raises(ValueError, match="margin pack"):
        serve_kernel.traverse(X, feature.clamp(max=5), *cols[1:], vals,
                              n_out=2, pack=ok, **kw)
    with pytest.raises(ValueError, match="margin pack"):
        serve_kernel.traverse(X, feature.clamp(max=5), *cols[1:], vals,
                              n_out=1, pack=ok, **dict(kw, n_steps=0))


# -- boosted models carried over from the JAX package ---------------------------

KW = dict(max_iter=4, max_depth=3, subsample=0.8, random_state=3)


@pytest.fixture(scope="module")
def carried(tmp_path_factory):
    """kind -> (port estimator loaded from the JAX package's model file,
    JAX estimator, rows)."""
    import mpitree_tpu as J

    X, y = covtype_like(1_500, seed=7)
    Xr, yr = california_like(1_500, seed=3)
    out = {}
    for kind, cls, Xd, yd in (
            ("multi", "GradientBoostingClassifier", X, y),
            ("binary", "GradientBoostingClassifier", X,
             (y == 1).astype(np.int64)),
            ("reg", "GradientBoostingRegressor", Xr, yr)):
        ref = getattr(J, cls)(**KW).fit(Xd, yd)
        path = tmp_path_factory.mktemp(kind) / "m"
        J.save_model(ref, path)
        out[kind] = (P.load_model(path.with_suffix(".npz"), device="cpu"),
                     ref, Xd)
    return out


@pytest.mark.parametrize("kind", ["multi", "binary", "reg"])
def test_replayed_margins_equal_the_jax_served_answers(carried, kind):
    from mpitree_tpu.serving import compile_model as jax_compile

    est, ref, X = carried[kind]
    cm = P.compile_model(est)
    assert cm.kind == "margin" and cm._margin is None  # CPU: no kernel
    pack = serve_kernel.pack_margin(*cm._dev_table, cm._values,
                                    n_out=cm.n_out, form="traverse")
    want = np.asarray(jax_compile(ref).raw(X))
    for N in (1, 64, len(X)):
        got = replay(X[:N], pack, serve_kernel.plan_margin(
            "traverse", N, cm.n_out, n_features=X.shape[1],
            table_bytes=pack.table_bytes, chunk_trees=pack.chunk_trees),
            cm.table.n_steps, cm._baseline.numpy())
        got = got[:, 0] if kind != "multi" and want.ndim == 1 else got
        np.testing.assert_array_equal(got.reshape(want[:N].shape), want[:N])
    # K5: the int8 tables' lattice sum, replayed, equals its plain version
    cm8 = P.compile_model(est, quantize="int8", quantize_tol=float("inf"))
    q = cm8._quant
    assert q.margin is None  # CPU
    qcols = (q.feature, q.threshold, q.left, q.right, q.root)
    qp = serve_kernel.pack_margin(*qcols, q.qvals, n_out=cm8.n_out,
                                  form="traverse_q")
    got = replay(X, qp, serve_kernel.plan_margin(
        "traverse_q", len(X), cm8.n_out, n_features=X.shape[1],
        table_bytes=qp.table_bytes, chunk_trees=qp.chunk_trees),
        cm8.table.n_steps)
    np.testing.assert_array_equal(got, serve_kernel.traverse_q_reference(
        torch.from_numpy(X), *qcols, q.qvals, n_steps=cm8.table.n_steps,
        agg="percls", n_out=cm8.n_out).numpy())

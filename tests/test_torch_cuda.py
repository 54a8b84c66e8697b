"""The Hopper kernels against their plain versions, on the card.

These tests need a CUDA card and ``nvcc``; elsewhere they skip. Run them
on the machine with the card with ``python -m pytest --noconftest -m cuda
tests/test_torch_cuda.py``. Integer-valued payloads sum exactly in float32
in any order, and every other payload takes the fixed-point route, whose
int64 sums are exact in any order, so the histogram kernels must equal the
plain version bit for bit; the traversal kernels reduce in member order
with correctly rounded float64 (K4) or integer (K5) adds, so they must too.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from mpitree_tpu_torch.ops import hist_kernel

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _hist_inputs(cuda, seed, S, *, N=20_000, skew=False):
    """covtype-shaped bins (10 wide columns, 44 two-bin ones), an integer
    class payload with zero weights, slots from -2 to S + 1; with ``skew``
    one slot holds 60% of the rows and every fourth slot is empty."""
    rng = np.random.default_rng(seed)
    F, C, B = 54, 7, 256
    xb = rng.integers(0, B, size=(N, F)).astype(np.int32)
    xb[:, 10:] %= 2
    y = torch.from_numpy(rng.integers(0, C, size=N)).to(cuda)
    w = torch.from_numpy(rng.integers(0, 4, size=N).astype(np.float32)).to(cuda)
    payload = (torch.nn.functional.one_hot(y, C).float() * w[:, None]).contiguous()
    slot = rng.integers(-2, S + 2, size=N).astype(np.int32)
    if skew:
        live = np.array([s for s in range(S) if s % 4 != 3])
        slot = live[rng.integers(0, len(live), N)].astype(np.int32)
        slot[rng.random(N) < 0.6] = live[len(live) // 2]
        slot[rng.random(N) < 0.05] = -1
    return (torch.from_numpy(xb).to(cuda), payload,
            torch.from_numpy(slot).to(cuda), [B] * 10 + [2] * 44)


def _every_route_equals_plain(xb, payload, slot, feat_bins, S):
    B = 256
    F, C = xb.shape[1], payload.shape[1]
    want = hist_kernel.histogram_reference(xb, payload, slot, n_slots=S,
                                           n_bins=B)
    packed = hist_kernel.pack_bins(xb, B)
    order, seg = hist_kernel.slot_segments(slot, S)
    ran = []
    for route in hist_kernel.ROUTES:
        for fb in (feat_bins, None):  # ragged tile, and B bins a feature
            try:
                hist_kernel.plan(S, F, C, B, route, feat_bins=fb)
            except ValueError:
                continue
            for pk in (None, packed):
                for pre in ({}, dict(order=order, seg_start=seg)):
                    before = hist_kernel.launches[route]
                    got = hist_kernel.histogram_cuda(
                        xb, payload, slot, n_slots=S, n_bins=B, packed=pk,
                        feat_bins=fb, _variant=route, **pre)
                    torch.cuda.synchronize()
                    assert hist_kernel.launches[route] == before + 1
                    assert torch.equal(got, want), (route, fb is None,
                                                    pk is None, bool(pre))
            ran.append(route)
    return ran


@pytest.mark.parametrize("S", [1, 8, 40, 64, 128, 512, 2048])
def test_kernel_variants_equal_plain_version(cuda, S):
    xb, payload, slot, feat_bins = _hist_inputs(cuda, S, S)
    ran = _every_route_equals_plain(xb, payload, slot, feat_bins, S)
    assert "sorted" in ran and ("stream" in ran) == (S <= 31)
    # the planned route, through the public wrapper
    route = hist_kernel.plan(S, 54, 7, 256)["route"]
    before = hist_kernel.launches[route]
    got = hist_kernel.histogram(xb, payload, slot, n_slots=S, n_bins=256)
    assert hist_kernel.launches[route] == before + 1
    assert torch.equal(got, hist_kernel.histogram_reference(
        xb, payload, slot, n_slots=S, n_bins=256))


@pytest.mark.parametrize("S", [12, 300])
def test_kernel_variants_with_a_skewed_frontier(cuda, S):
    """One slot holds 60% of the rows (split into pieces that combine with
    global atomics), a quarter of the slots are empty (zeros stored by the
    block that owns them); also through small pieces, and as a chunk whose
    segments start inside a wider level's order."""
    xb, payload, slot, feat_bins = _hist_inputs(cuda, S, S, N=60_000,
                                                skew=True)
    _every_route_equals_plain(xb, payload, slot, feat_bins, S)
    want = hist_kernel.histogram_reference(xb, payload, slot, n_slots=S,
                                           n_bins=256)
    for piece_rows in (32, 4_096):
        got = hist_kernel.histogram_cuda(
            xb, payload, slot, n_slots=S, n_bins=256, feat_bins=feat_bins,
            _variant="sorted", _tune=dict(piece_rows=piece_rows))
        assert torch.equal(got, want)
    order, seg = hist_kernel.slot_segments(slot + 5, S + 9)
    got = hist_kernel.histogram_cuda(
        xb, payload, slot, n_slots=S, n_bins=256,
        packed=hist_kernel.pack_bins(xb, 256), order=order,
        seg_start=seg[5:5 + S + 1].contiguous(), _variant="sorted")
    assert torch.equal(got, want)


def test_general_payload_and_odd_shapes(cuda):
    """Rows with several nonzero channels take the general loop; a bin
    count that is no multiple of 4 takes the scalar flush; more than 256
    bins keep int32 bins."""
    rng = np.random.default_rng(11)
    for N, F, C, B, S in ((5_000, 5, 3, 9, 6), (4_000, 20, 2, 300, 3),
                          (3_000, 33, 4, 64, 1)):
        xb = torch.from_numpy(
            rng.integers(0, B, size=(N, F)).astype(np.int32)).to(cuda)
        payload = torch.from_numpy(
            rng.integers(-3, 4, size=(N, C)).astype(np.float32)).to(cuda)
        slot = torch.from_numpy(
            rng.integers(-1, S + 1, size=N).astype(np.int32)).to(cuda)
        want = hist_kernel.histogram_reference(xb, payload, slot, n_slots=S,
                                               n_bins=B)
        packed = hist_kernel.pack_bins(xb, B) if B <= 256 else None
        for route in ("stream", "sorted"):
            for pk in {None, packed}:
                got = hist_kernel.histogram_cuda(
                    xb, payload, slot, n_slots=S, n_bins=B, packed=pk,
                    _variant=route)
                assert torch.equal(got, want), (route, B, pk is None)


def test_wrapper_refuses_what_the_kernels_do_not_take(cuda):
    xb = torch.zeros((8, 3), dtype=torch.int32, device=cuda)
    payload = torch.ones((8, 2), device=cuda)
    slot = torch.zeros(8, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="int32"):
        hist_kernel.histogram(xb.long(), payload, slot, n_slots=1, n_bins=2)
    with pytest.raises(ValueError, match="contiguous"):
        hist_kernel.histogram(xb.t().contiguous().t(), payload, slot,
                              n_slots=1, n_bins=2)
    with pytest.raises(ValueError, match="row counts"):
        hist_kernel.histogram(xb, payload[:4], slot, n_slots=1, n_bins=2)
    order, seg = hist_kernel.slot_segments(slot, 1)
    with pytest.raises(ValueError, match="order must be"):
        hist_kernel.histogram(xb, payload, slot, n_slots=1, n_bins=2,
                              order=order.long(), seg_start=seg)
    with pytest.raises(ValueError, match="come together"):
        hist_kernel.histogram(xb, payload, slot, n_slots=1, n_bins=2,
                              order=order)
    packed = hist_kernel.pack_bins(xb, 2)
    with pytest.raises(ValueError, match="multiple of 16"):
        hist_kernel.histogram(xb, payload, slot, n_slots=1, n_bins=2,
                              packed=packed[:, :8].contiguous())
    with pytest.raises(ValueError, match="n_bins <= 256"):
        hist_kernel.histogram(xb, payload, slot, n_slots=1, n_bins=300,
                              packed=packed)


def _fixed_payloads(cuda, N, rng):
    """A fractional class payload, regression moments and a GBDT payload
    with out-of-sample rows (h = 0)."""
    from mpitree_tpu_torch.ops import histogram as ph

    y = torch.from_numpy(rng.integers(0, 7, size=N)).to(cuda)
    w = torch.from_numpy(rng.uniform(0.5, 2, N).astype(np.float32)).to(cuda)
    t = torch.from_numpy(rng.normal(0, 1.3, N).astype(np.float32)).to(cuda)
    h = torch.from_numpy(np.where(rng.random(N) < 0.3, 0.0, rng.uniform(
        0.05, 0.25, N)).astype(np.float32)).to(cuda)
    return {"class": ph.class_payload(y, w, 7).contiguous(),
            "moments": ph.moment_payload(t, w).contiguous(),
            "gbdt": ph.gbdt_payload(t, h).contiguous()}


@pytest.mark.parametrize("S", [1, 8, 64, 512, 2048])
def test_fixed_point_route_equals_plain_version(cuda, S):
    """Every route whose tile fits, int32 and byte-wide bins, with and
    without the level's slot order: bit for bit the plain version's int64
    sums, and two launches bit for bit each other."""
    xb, _, slot, feat_bins = _hist_inputs(cuda, S, S)
    packed = hist_kernel.pack_bins(xb, 256)
    order, seg = hist_kernel.slot_segments(slot, S)
    rng = np.random.default_rng(S)
    for name, payload in _fixed_payloads(cuda, xb.shape[0], rng).items():
        se = hist_kernel.fixed_point_exponents(payload)
        want = hist_kernel.histogram_reference(xb, payload, slot, n_slots=S,
                                               n_bins=256, scale_exp=se)
        ran = []
        for route in hist_kernel.ROUTES:
            try:
                hist_kernel.plan(S, 54, payload.shape[1], 256, route,
                                 feat_bins=feat_bins, fixed=True)
            except ValueError:
                continue
            for pk in (None, packed):
                for pre in ({}, dict(order=order, seg_start=seg)):
                    key = f"{route}_fixed"
                    before = hist_kernel.launches[key]
                    runs = [hist_kernel.histogram_cuda(
                        xb, payload, slot, n_slots=S, n_bins=256, packed=pk,
                        feat_bins=feat_bins, scale_exp=se, _variant=route,
                        **pre) for _ in range(2)]
                    torch.cuda.synchronize()
                    assert hist_kernel.launches[key] == before + 2
                    assert runs[0].dtype == torch.int64
                    assert torch.equal(runs[0], want), (name, route)
                    assert torch.equal(runs[1], runs[0]), (name, route)
            ran.append(route)
        assert "sorted" in ran and (S > 1 or "stream" in ran), (name, ran)


def test_fixed_point_route_with_a_skewed_frontier_and_small_pieces(cuda):
    """Slots split into pieces combine with global 64-bit atomics into a
    zeroed int64 output; empty slots are stored as zeros."""
    S = 300
    xb, _, slot, feat_bins = _hist_inputs(cuda, S, S, N=60_000, skew=True)
    rng = np.random.default_rng(4)
    for name, payload in _fixed_payloads(cuda, xb.shape[0], rng).items():
        se = hist_kernel.fixed_point_exponents(payload)
        want = hist_kernel.histogram_reference(xb, payload, slot, n_slots=S,
                                               n_bins=256, scale_exp=se)
        for piece_rows in (32, 4_096):
            got = hist_kernel.histogram_cuda(
                xb, payload, slot, n_slots=S, n_bins=256,
                feat_bins=feat_bins, scale_exp=se, _variant="sorted",
                _tune=dict(piece_rows=piece_rows))
            assert torch.equal(got, want), (name, piece_rows)


def test_float32_route_refuses_an_inexact_payload(cuda):
    """Without scale_exp the kernel adds float32 in an unordered way, so a
    payload whose sums would depend on that order is refused before the
    launch: a fraction, or an integer sum at 2**24."""
    xb, payload, slot, _ = _hist_inputs(cuda, 0, 8)
    for bad in (payload * 0.5, payload + 2.0 ** 24):
        before = dict(hist_kernel.launches)
        with pytest.raises(ValueError, match="scale_exp"):
            hist_kernel.histogram_cuda(xb, bad.contiguous(), slot, n_slots=8,
                                       n_bins=256)
        assert hist_kernel.launches == before


def test_fractional_weight_and_regression_fits_on_the_card(cuda):
    """The card's trees equal the CPU's field for field: a fractionally
    weighted classifier (device engine and default) and a regressor, both
    through the fixed-point route."""
    from mpitree_tpu_torch.tree import (
        DecisionTreeClassifier,
        DecisionTreeRegressor,
    )
    from mpitree_tpu_torch.utils.datasets import california_like, covtype_like

    fields = ("feature", "threshold", "left", "right", "count", "value",
              "n_node_samples", "impurity")
    X, y = covtype_like(20_000, seed=6)
    w = np.random.default_rng(2).uniform(0.5, 2, len(y)).astype(np.float32)
    Xr, yr = california_like(20_000, seed=6)
    for est, data in (
            (lambda d: DecisionTreeClassifier(max_depth=10,
                                              refine_depth=None, device=d),
             (X, y, w)),
            (lambda d: DecisionTreeClassifier(max_depth=14, device=d),
             (X, y, w)),
            (lambda d: DecisionTreeRegressor(max_depth=12, device=d),
             (Xr, yr, None))):
        before = dict(hist_kernel.launches)
        gpu = est("cuda").fit(*data[:2], sample_weight=data[2])
        assert hist_kernel.launches["sorted_fixed"] > before["sorted_fixed"]
        assert hist_kernel.launches["stream_fixed"] > before["stream_fixed"]
        cpu = est("cpu").fit(*data[:2], sample_weight=data[2])
        assert gpu.fit_stats_["engine"] == "fused"
        for k in fields:
            np.testing.assert_array_equal(getattr(gpu.tree_, k),
                                          getattr(cpu.tree_, k), err_msg=k)


def test_crown_leaf_ids_and_default_fit_on_the_card(cuda):
    """The crown's leaf ids come from the card in one copy and equal the
    CPU's; the default fit (crown on the card, refine tail on the host)
    equals the CPU's tree, integer bootstrap-like weights with zeros
    included."""
    from mpitree_tpu_torch.core.builder import BuildConfig, build_tree
    from mpitree_tpu_torch.ops.binning import bin_for_engine
    from mpitree_tpu_torch.tree import DecisionTreeClassifier
    from mpitree_tpu_torch.utils.datasets import covtype_like

    X, y = covtype_like(30_000, seed=5)
    w = np.random.default_rng(1).integers(0, 3, len(y)).astype(np.float32)
    cfg = BuildConfig(max_depth=4)
    (tg, ig), (tc, ic) = [
        build_tree(bin_for_engine(X, max_bins=256, binning="auto",
                                  device=dev),
                   y, config=cfg, n_classes=7, sample_weight=w,
                   return_leaf_ids=True)
        for dev in (cuda, torch.device("cpu"))
    ]
    assert ig.dtype == np.int32 and ig.shape == (len(y),)
    np.testing.assert_array_equal(ig, ic)
    np.testing.assert_array_equal(tg.feature, tc.feature)
    assert (tg.feature[ig] < 0).all()

    fits = [DecisionTreeClassifier(max_depth=14, device=d).fit(
        X, y, sample_weight=w) for d in ("cuda", "cpu")]
    assert fits[0].fit_stats_["crown_depth"] == 4
    assert fits[0].fit_stats_["refine_nodes_added"] > 0
    for k in ("feature", "threshold", "left", "right", "count",
              "n_node_samples", "impurity"):
        np.testing.assert_array_equal(getattr(fits[0].tree_, k),
                                      getattr(fits[1].tree_, k), err_msg=k)


def _same_forests(gpu, cpu):
    for i, (a, b) in enumerate(zip(gpu.trees_, cpu.trees_, strict=True)):
        assert a.n_nodes == b.n_nodes, i
        for k in ("feature", "threshold", "left", "right", "count",
                  "value", "n_node_samples", "impurity"):
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k),
                                          err_msg=f"tree {i} {k}")


@pytest.mark.parametrize("mode", ["node", "tree"])
def test_sampled_forest_on_the_card_equals_cpu(cuda, mode):
    """Per-node (or per-tree) feature subsets, the node masks shipped to
    the card once per chunk: the card's trees equal the CPU's."""
    from mpitree_tpu_torch.tree import RandomForestClassifier
    from mpitree_tpu_torch.utils.datasets import covtype_like

    X, y = covtype_like(20_000, seed=4)
    kw = dict(n_estimators=3, max_depth=8, random_state=0,
              max_features="sqrt", max_features_mode=mode,
              refine_depth=None)
    before = dict(hist_kernel.launches)
    gpu = RandomForestClassifier(device="cuda", **kw).fit(X, y)
    assert hist_kernel.launches["sorted"] > before["sorted"]
    _same_forests(gpu, RandomForestClassifier(device="cpu", **kw).fit(X, y))


def test_extra_trees_regressor_on_the_card_equals_cpu(cuda):
    """Random splits (draws shipped as int64) on the fixed-point route."""
    from mpitree_tpu_torch.tree import ExtraTreesRegressor
    from mpitree_tpu_torch.utils.datasets import california_like

    X, y = california_like(20_000, seed=6)
    kw = dict(n_estimators=3, max_depth=8, random_state=0)
    for extra in (dict(refine_depth=None), {}):
        before = dict(hist_kernel.launches)
        gpu = ExtraTreesRegressor(device="cuda", **kw, **extra).fit(X, y)
        assert hist_kernel.launches["sorted_fixed"] > before["sorted_fixed"]
        _same_forests(gpu, ExtraTreesRegressor(device="cpu", **kw,
                                               **extra).fit(X, y))


# ---------------------------------------------------------------------------
# serving traversal kernels (K4 traverse, K5 traverse_q)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def forest_on_card():
    """A small forest fitted on the card, its flat table and query rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from mpitree_tpu_torch.serving.tables import tables_for
    from mpitree_tpu_torch.tree import RandomForestClassifier
    from mpitree_tpu_torch.utils.datasets import covtype_like

    X, y = covtype_like(20_000, seed=0)
    forest = RandomForestClassifier(n_estimators=6, max_depth=8,
                                    random_state=0, device="cuda").fit(X, y)
    [table] = tables_for(forest.trees_, group_bytes=None)
    Xq = covtype_like(3_000, seed=1)[0]
    return forest, table, Xq


def _members(forest_on_card, n_trees):
    """(trees, flat table) of the forest's first ``n_trees`` members."""
    from mpitree_tpu_torch.serving.tables import tables_for

    forest, table, _ = forest_on_card
    if n_trees == len(forest.trees_):
        return list(forest.trees_), table
    trees = list(forest.trees_)[:n_trees]
    [sub] = tables_for(trees, group_bytes=None)
    return trees, sub


ROWS = [1, 63, 64, 3_000]


@pytest.mark.parametrize("N", ROWS)
@pytest.mark.parametrize("n_trees", [1, 6])
@pytest.mark.parametrize("agg,n_chan,n_out", [
    ("norm", 7, 7), ("sum", 7, 7), ("sum", 12, 12), ("percls", 1, 3),
    ("percls", 1, 10),
], ids=["norm", "sum", "sum-12", "percls", "percls-10"])
def test_traverse_kernel_equals_plain_version(forest_on_card, agg, n_chan,
                                             n_out, n_trees, N):
    from mpitree_tpu_torch.serving import serve_kernel

    trees, table = _members(forest_on_card, n_trees)
    dev = torch.device("cuda")
    cols = table.dev_arrays(dev)[:5]
    rng = np.random.default_rng(n_chan + n_out)
    if agg == "norm":
        vals = np.concatenate([t.count for t in trees])
        vals = vals[table.scatter_order()].astype(np.float64)
    else:  # non-integer values: the reduction order is what is tested
        vals = rng.standard_normal((table.n_nodes, n_chan))
    values = torch.from_numpy(np.ascontiguousarray(vals)).to(dev)
    X = torch.from_numpy(forest_on_card[2][:N]).to(dev)
    kw = dict(n_steps=table.n_steps, agg=agg, n_out=n_out)
    before = serve_kernel.launches["traverse"]
    got = serve_kernel.traverse(X, *cols, values, n_features=X.shape[1],
                                record=table.dev_record(dev), **kw)
    torch.cuda.synchronize()
    assert serve_kernel.launches["traverse"] == before + 1
    want = serve_kernel.traverse_reference(X, *cols, values, **kw)
    assert got.dtype == torch.float64 and torch.equal(got, want)
    # without a record the call packs the columns itself: same bits
    assert torch.equal(serve_kernel.traverse(
        X, *cols, values, n_features=X.shape[1], **kw), want)


@pytest.mark.parametrize("N", ROWS)
@pytest.mark.parametrize("n_trees", [1, 6])
@pytest.mark.parametrize("agg,n_out", [("sum", 7), ("percls", 3)])
def test_quantized_kernel_equals_plain_version(forest_on_card, agg, n_out,
                                               n_trees, N):
    from mpitree_tpu_torch.serving import quantize, serve_kernel

    trees, table = _members(forest_on_card, n_trees)
    dev = torch.device("cuda")
    counts = np.concatenate([t.count for t in trees])
    prepared = quantize.prepare_channel(
        "forest_proba", counts[table.scatter_order()])
    state = quantize.build_state(
        table, prepared, kind="forest_proba", scale=len(trees),
        n_steps=table.n_steps, tol=1.0, device=dev, n_features=54)
    X = torch.from_numpy(forest_on_card[2][:N]).to(dev)
    cols = (state.feature, state.threshold, state.left, state.right,
            state.root)
    kw = dict(n_steps=table.n_steps, agg=agg, n_out=n_out)
    before = serve_kernel.launches["traverse_q"]
    got = serve_kernel.traverse_q(X, *cols, state.qvals, n_features=54,
                                  record=state.record, **kw)
    torch.cuda.synchronize()
    assert serve_kernel.launches["traverse_q"] == before + 1
    want = serve_kernel.traverse_q_reference(X, *cols, state.qvals, **kw)
    assert got.dtype == torch.int32 and torch.equal(got, want)


def test_traverse_kernel_reads_rows_too_wide_to_stage(forest_on_card):
    """Rows wider than a block's shared memory are read from global memory
    (the plan's ``stage_x`` off): the table only splits on the first 54
    columns, the other columns are padding."""
    from mpitree_tpu_torch.serving import serve_kernel

    _, table, Xq = forest_on_card
    dev = torch.device("cuda")
    F = 60_000
    X = torch.zeros((64, F), dtype=torch.float32, device=dev)
    X[:, :Xq.shape[1]] = torch.from_numpy(Xq[:64]).to(dev)
    assert not serve_kernel.plan("traverse", 64, table.n_trees, 7,
                                 n_features=F)["stage_x"]
    cols = table.dev_arrays(dev)[:5]
    values = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (table.n_nodes, 7))).to(dev)
    kw = dict(n_steps=table.n_steps, agg="sum", n_out=7)
    got = serve_kernel.traverse(X, *cols, values, n_features=F,
                                record=table.dev_record(dev), **kw)
    want = serve_kernel.traverse_reference(X, *cols, values, **kw)
    assert torch.equal(got, want)


def test_traverse_wrapper_refuses_what_the_kernels_do_not_take(
        forest_on_card):
    from mpitree_tpu_torch.serving import serve_kernel

    _, table, Xq = forest_on_card
    dev = torch.device("cuda")
    cols = table.dev_arrays(dev)[:5]
    values = torch.ones((table.n_nodes, 7), dtype=torch.float64, device=dev)
    X = torch.from_numpy(Xq).to(dev)
    kw = dict(n_steps=table.n_steps, agg="sum", n_out=7)
    with pytest.raises(ValueError, match="float64"):
        serve_kernel.traverse(X, *cols, values.float(), n_features=54, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        serve_kernel.traverse(X.t().contiguous().t(), *cols, values,
                              n_features=54, **kw)
    with pytest.raises(ValueError, match="features"):
        serve_kernel.traverse(X[:, :50].contiguous(), *cols, values,
                              n_features=54, **kw)


def test_compiled_forest_serves_through_the_kernels_only(forest_on_card,
                                                         monkeypatch):
    from mpitree_tpu_torch.serving import compile_model, serve_kernel

    forest, _, Xq = forest_on_card

    def plain(*a, **k):
        raise AssertionError("the plain tier ran on the card")

    monkeypatch.setattr(serve_kernel, "traverse_reference", plain)
    monkeypatch.setattr(serve_kernel, "traverse_q_reference", plain)
    for quantize, counter in ((None, "traverse"), ("int8", "traverse_q")):
        cm = compile_model(forest, quantize=quantize, quantize_tol=1.0)
        assert cm.serve_report_["dispatch"] == f"kernel {counter}"
        before = serve_kernel.launches[counter]
        got = cm.raw(Xq)
        assert serve_kernel.launches[counter] > before
        if quantize is None:
            assert cm.exact
            np.testing.assert_array_equal(got, forest.predict_proba(Xq))


def test_compiled_regression_forest_serves_predict_on_the_card(cuda):
    """``forest_mean`` through K4 in ``sum`` mode: the regression forest's
    ``predict`` bit for bit."""
    from mpitree_tpu_torch.serving import compile_model, serve_kernel
    from mpitree_tpu_torch.tree import RandomForestRegressor
    from mpitree_tpu_torch.utils.datasets import california_like

    X, y = california_like(20_000, seed=0)
    Xq, _ = california_like(5_000, seed=1)
    forest = RandomForestRegressor(n_estimators=6, max_depth=10,
                                   random_state=0, device="cuda").fit(X, y)
    cm = compile_model(forest)
    before = serve_kernel.launches["traverse"]
    for n in (1, 64, 5_000):
        got = cm.raw(Xq[:n])
        assert got.dtype == np.float64
        np.testing.assert_array_equal(got, forest.predict(Xq[:n]))
    assert serve_kernel.launches["traverse"] > before


@pytest.mark.parametrize("payload_kind", ["class", "weighted", "moments"])
@pytest.mark.parametrize("S", [1, 64])
def test_constrained_split_step_on_the_card_equals_cpu(cuda, payload_kind,
                                                       S):
    """``collective.split_step`` with the monotonic gate and bound windows:
    the card's decisions (the histogram kernel, then the sweep with its
    gate) equal the CPU's plain path on the integer route, the fixed route
    of fractional weights and the regression moments: winners, node
    statistics and the winners' child values bit for bit; the cost and
    the parent impurity to 1e-6 relative, as CUDA's ``log`` may differ
    from glibc's by an ulp (phase 4's exact-tie rule)."""
    from mpitree_tpu_torch.ops.histogram import (
        class_payload,
        moment_payload,
        payload_scale,
    )
    from mpitree_tpu_torch.parallel import collective

    rng = np.random.default_rng(S)
    N, F, B = 20_000, 6, 64
    xb = rng.integers(0, B, size=(N, F)).astype(np.int32)
    nid = rng.integers(-1, S, size=N).astype(np.int32)
    yc = rng.integers(0, 2, size=N)
    yr = (xb[:, 0] * 0.1 - xb[:, 2] * 0.05
          + rng.normal(size=N)).astype(np.float32)
    w = (rng.uniform(0.5, 2.0, N) if payload_kind == "weighted"
         else np.ones(N)).astype(np.float32)
    cst = np.array([1, 0, -1, 0, 1, 0], np.int32)
    lo = np.full(S, -np.inf, np.float32)
    hi = np.full(S, np.inf, np.float32)
    lo[1::2] = 0.3 if payload_kind != "moments" else -0.5
    hi[::3] = 0.7 if payload_kind != "moments" else 0.5
    cand = rng.random((F, B)) < 0.95

    def run(dev):
        t = {k: torch.from_numpy(v).to(dev) for k, v in dict(
            xb=xb, nid=nid, yc=yc, yr=yr, w=w, cst=cst, lo=lo, hi=hi,
            cand=cand).items()}
        if payload_kind == "moments":
            payload = moment_payload(t["yr"], t["w"]).contiguous()
            se = hist_kernel.fixed_point_exponents(payload)
        else:
            payload = class_payload(t["yc"], None if payload_kind == "class"
                                    else t["w"], 2).contiguous()
            se = payload_scale(payload)
        order = seg = None
        if S > hist_kernel.STREAM_MAX_SLOTS:
            order, seg = hist_kernel.slot_segments(t["nid"], S)
        return collective.split_step(
            t["xb"], payload, t["nid"], t["cand"], 0, n_slots=S, n_bins=B,
            criterion="entropy", min_child_weight=1.0,
            packed=(hist_kernel.pack_bins(t["xb"], B) if dev.type == "cuda"
                    else None),
            order=order, seg_start=seg, scale_exp=se,
            task="regression" if payload_kind == "moments"
            else "classification", y=t["yr"], mono_cst=t["cst"],
            mono_lo=t["lo"], mono_hi=t["hi"]).cpu()

    before = dict(hist_kernel.launches)
    kw = dict(n_counts=3 if payload_kind == "moments" else 2,
              y_range=payload_kind == "moments", mono=True)
    got = collective.unpack_decision(run(cuda).numpy(), **kw)
    assert hist_kernel.launches != before
    want = collective.unpack_decision(run(torch.device("cpu")).numpy(), **kw)
    assert got.keys() == want.keys()
    for k in want:
        if k in ("cost", "impurity"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=0,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert np.isfinite(want["v_left"][np.isfinite(want["cost"])]).all()


def test_constrained_fits_and_forest_serving_on_the_card(cuda):
    """Constrained trees on the card equal the CPU's field for field (a
    binary classifier, integer route; a regressor, fixed-point route); a
    constrained forest serves ``forest_values`` through K4 ``sum`` bit for
    bit as its ``predict_proba``."""
    from mpitree_tpu_torch.serving import compile_model, serve_kernel
    from mpitree_tpu_torch.tree import (
        DecisionTreeClassifier,
        DecisionTreeRegressor,
        RandomForestClassifier,
    )
    from mpitree_tpu_torch.utils.datasets import california_like, covtype_like

    X, y = covtype_like(20_000, seed=6)
    y = (y == np.bincount(y).argmax()).astype(np.int64)
    cst = np.zeros(X.shape[1], np.int64)
    cst[0], cst[5] = 1, -1
    Xr, yr = california_like(20_000, seed=6)
    fields = ("feature", "threshold", "left", "right", "count", "value",
              "n_node_samples", "impurity")
    for make, data in (
            (lambda d: DecisionTreeClassifier(max_depth=10,
                                              monotonic_cst=cst, device=d),
             (X, y)),
            (lambda d: DecisionTreeRegressor(
                max_depth=12, monotonic_cst=[1] + [0] * 7, device=d),
             (Xr, yr))):
        gpu, cpu = make("cuda").fit(*data), make("cpu").fit(*data)
        for k in fields:
            np.testing.assert_array_equal(getattr(gpu.tree_, k),
                                          getattr(cpu.tree_, k), err_msg=k)
    forest = RandomForestClassifier(n_estimators=6, max_depth=8,
                                    random_state=0, monotonic_cst=cst,
                                    device="cuda").fit(X, y)
    cm = compile_model(forest)
    assert cm.kind == "forest_values"
    before = serve_kernel.launches["traverse"]
    for n in (1, 64, 4_096):
        np.testing.assert_array_equal(cm.raw(X[:n]),
                                      forest.predict_proba(X[:n]))
    assert serve_kernel.launches["traverse"] > before


@pytest.mark.parametrize("S", [1, 64])
def test_newton_split_step_on_the_card_equals_cpu(cuda, S):
    """``collective.split_step(task="gbdt")``: the fixed-point histogram of
    a ``(count, g, h)`` payload with subsampled-out rows (``h == 0``) and
    the Newton sweep on the card equal the CPU's plain path bit for bit,
    every field: the sums are exact int64 and the sweep's float32 formula
    has no transcendental."""
    from mpitree_tpu_torch.ops.histogram import gbdt_payload
    from mpitree_tpu_torch.parallel import collective

    rng = np.random.default_rng(S + 3)
    N, F, B = 20_000, 6, 64
    xb = rng.integers(0, B, size=(N, F)).astype(np.int32)
    nid = rng.integers(-1, S, size=N).astype(np.int32)
    g = rng.normal(size=N).astype(np.float32)
    h = rng.uniform(0.01, 0.25, size=N).astype(np.float32)
    h[rng.random(N) < 0.2] = 0.0
    cand = rng.random((F, B)) < 0.95

    def run(dev):
        t = {k: torch.from_numpy(v).to(dev) for k, v in dict(
            xb=xb, nid=nid, g=g, h=h, cand=cand).items()}
        payload = gbdt_payload(t["g"], t["h"]).contiguous()
        se = hist_kernel.fixed_point_exponents(payload)
        order = seg = None
        if S > hist_kernel.STREAM_MAX_SLOTS:
            order, seg = hist_kernel.slot_segments(t["nid"], S)
        return collective.split_step(
            t["xb"], payload, t["nid"], t["cand"], 0, n_slots=S, n_bins=B,
            criterion="entropy", min_child_weight=0.5,
            packed=(hist_kernel.pack_bins(t["xb"], B) if dev.type == "cuda"
                    else None),
            order=order, seg_start=seg, scale_exp=se, task="gbdt",
            reg_lambda=0.7, min_leaf_rows=20.0).cpu()

    before = dict(hist_kernel.launches)
    got = run(cuda)
    assert hist_kernel.launches != before
    want = run(torch.device("cpu"))
    assert got.dtype == want.dtype == torch.float64
    assert torch.equal(got, want)


def test_boosted_fits_and_margins_on_the_card(cuda):
    """Boosted ensembles on the card (multiclass with row and column
    subsampling, and a regressor) equal the CPU's tree for tree and margin
    for margin, through the fixed-point routes only; compiled, their
    margins through K4 ``percls`` equal ``decision_function`` /
    ``predict`` bit for bit, and K5's equal its plain version."""
    from mpitree_tpu_torch.serving import compile_model, serve_kernel
    from mpitree_tpu_torch.tree import (
        GradientBoostingClassifier,
        GradientBoostingRegressor,
    )
    from mpitree_tpu_torch.utils.datasets import california_like, covtype_like

    X, y = covtype_like(20_000, seed=4)
    Xr, yr = california_like(20_000, seed=4)
    kw = dict(max_iter=4, max_depth=5, subsample=0.8, colsample_bytree=0.5,
              random_state=0)
    fields = ("feature", "threshold", "left", "right", "count", "value",
              "n_node_samples", "impurity")
    for cls, (Xd, yd) in ((GradientBoostingClassifier, (X, y)),
                          (GradientBoostingRegressor, (Xr, yr))):
        before = dict(hist_kernel.launches)
        gpu = cls(**kw, device="cuda").fit(Xd, yd)
        ran = {k: v - before[k] for k, v in hist_kernel.launches.items()}
        assert ran["stream_fixed"] and ran["sorted_fixed"], ran
        assert not (ran["stream"] or ran["sorted"]), ran
        cpu = cls(**kw, device="cpu").fit(Xd, yd)
        assert len(gpu.trees_) == len(cpu.trees_)
        for a, b in zip(gpu.trees_, cpu.trees_):
            for k in fields:
                np.testing.assert_array_equal(getattr(a, k), getattr(b, k),
                                              err_msg=k)
        margins = (gpu.decision_function if hasattr(gpu, "decision_function")
                   else gpu.predict)
        np.testing.assert_array_equal(margins(Xd), (
            cpu.decision_function if hasattr(cpu, "decision_function")
            else cpu.predict)(Xd))
        cm = compile_model(gpu)
        assert cm.kind == "margin" and cm.dispatch == "kernel traverse"
        served = cm.decision_function if hasattr(gpu, "decision_function") \
            else cm.predict
        before = dict(serve_kernel.launches)
        for n in (1, 64, 4_096):
            np.testing.assert_array_equal(served(Xd[:n]), margins(Xd[:n]))
        assert serve_kernel.launches["traverse"] > before["traverse"]
        cm8 = compile_model(gpu, quantize="int8", quantize_tol=1.0)
        q = cm8._quant
        Xq = torch.from_numpy(Xd[:4_096]).to(cuda)
        cols = (q.feature, q.threshold, q.left, q.right, q.root)
        args = dict(n_steps=cm8.table.n_steps, agg="percls",
                    n_out=cm8.n_out)
        assert torch.equal(
            serve_kernel.traverse_q(Xq, *cols, q.qvals, record=q.record,
                                    n_features=Xd.shape[1], **args),
            serve_kernel.traverse_q_reference(Xq, *cols, q.qvals, **args))


_TREE_FIELDS = ("feature", "threshold", "left", "right", "parent", "depth",
                "count", "value", "n_node_samples", "impurity")


def _same_trees(a, b, msg=""):
    assert a.n_nodes == b.n_nodes, msg
    for k in _TREE_FIELDS:
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k),
                                      err_msg=f"{msg} {k}")


@pytest.mark.parametrize("task", ["classification", "weighted",
                                  "regression"])
def test_fused_and_levelwise_with_subtraction_on_the_card(cuda, task):
    """Both engines, subtraction on and off, on the card and with
    device="cpu": one tree, field for field (multi-chunk frontiers and the
    per-chunk carry included), and the fused engine reads the frontier
    size at most once a level."""
    import dataclasses

    from mpitree_tpu_torch.core import fused_builder
    from mpitree_tpu_torch.core.builder import BuildConfig, build_tree
    from mpitree_tpu_torch.ops.binning import bin_for_engine
    from mpitree_tpu_torch.utils.datasets import california_like, covtype_like

    if task == "regression":
        X, y64 = california_like(20_000, seed=3)
        y, kw = (y64 - y64.mean()).astype(np.float32), dict(
            refit_targets=y64)
        base = BuildConfig(task="regression", criterion="mse", max_depth=12,
                           max_frontier_chunk=64)
    else:
        X, y = covtype_like(20_000, seed=3)
        w = None if task == "classification" else np.random.default_rng(
            3).uniform(0.5, 2, len(y)).astype(np.float32)
        kw = dict(n_classes=7, sample_weight=w)
        base = BuildConfig(max_depth=12, max_frontier_chunk=64)
    trees = {}
    for dev in ("cuda", "cpu"):
        binned = bin_for_engine(X, max_bins=256, binning="auto",
                                device=torch.device(dev))
        for engine in ("fused", "levelwise"):
            for sub in ("off", "on"):
                cfg = dataclasses.replace(base, engine=engine,
                                          hist_subtraction=sub)
                before = fused_builder.frontier_reads
                tree = build_tree(binned, y, config=cfg, **kw)
                reads = fused_builder.frontier_reads - before
                assert reads <= (tree.depth.max() + 1 if engine == "fused"
                                 else 0)
                trees[(dev, engine, sub)] = tree
    ref = trees[("cpu", "levelwise", "off")]
    assert ref.n_nodes > 4 * 64  # frontiers wider than the 64-slot chunk
    for key, tree in trees.items():
        _same_trees(tree, ref, str(key))


def test_fused_forest_on_the_card_equals_cpu(cuda):
    """The batched forest (sampling, random splits and a subspace) on the
    card equals the CPU's and the card's per-tree levelwise forest."""
    import os

    from mpitree_tpu_torch.tree import ExtraTreesClassifier
    from mpitree_tpu_torch.utils.datasets import covtype_like

    X, y = covtype_like(20_000, seed=4)
    kw = dict(n_estimators=4, max_depth=10, max_features=0.3,
              random_state=1, refine_depth=None)
    gpu = ExtraTreesClassifier(device="cuda", **kw).fit(X, y)
    cpu = ExtraTreesClassifier(device="cpu", **kw).fit(X, y)
    os.environ["MPITREE_TPU_ENGINE"] = "levelwise"
    try:
        lw = ExtraTreesClassifier(device="cuda", **kw).fit(X, y)
    finally:
        del os.environ["MPITREE_TPU_ENGINE"]
    assert gpu.fit_stats_["ensemble_path"] == "batched-fused"
    assert lw.fit_stats_["ensemble_path"] == "per-tree"
    for i, (a, b, c) in enumerate(zip(gpu.trees_, cpu.trees_, lw.trees_)):
        _same_trees(a, b, f"tree {i} cpu")
        _same_trees(a, c, f"tree {i} levelwise")


def test_sampling_twins_on_the_card_equal_the_host_hash(cuda):
    from mpitree_tpu_torch.ops import sampling

    keys = np.random.default_rng(0).integers(
        0, 2**32, size=4_099, dtype=np.uint64).astype(np.uint32)
    kd = torch.from_numpy(keys.astype(np.int64)).to(cuda)
    np.testing.assert_array_equal(sampling.pcg_hash_dev(kd).cpu().numpy(),
                                  sampling.pcg_hash(keys).astype(np.int64))
    s = sampling.NodeFeatureSampler(k=7, n_features=54, seed=3)
    np.testing.assert_array_equal(
        sampling.node_masks_dev(kd, 7, 54).cpu().numpy(), s.node_masks(keys))
    np.testing.assert_array_equal(
        sampling.node_draws_dev(kd, 54).cpu().numpy(),
        s.node_draws(keys).astype(np.int64))
    for a, b in zip(sampling.child_keys_dev(kd), s.child_keys(keys)):
        np.testing.assert_array_equal(a.cpu().numpy(), b.astype(np.int64))


@pytest.mark.parametrize("task", ["classification", "weighted",
                                  "regression"])
def test_leafwise_engines_on_the_card_equal_cpu(cuda, task):
    """Both leaf-wise engines, subtraction on and off, on the card (the
    fused engine replaying its captured expansion) and with
    device="cpu": one tree, field for field, budget binding."""
    import dataclasses

    from mpitree_tpu_torch.core import leafwise_builder
    from mpitree_tpu_torch.core.builder import BuildConfig, build_tree
    from mpitree_tpu_torch.ops.binning import bin_for_engine
    from mpitree_tpu_torch.utils.datasets import california_like, covtype_like

    if task == "regression":
        X, y64 = california_like(20_000, seed=5)
        y, kw = (y64 - y64.mean()).astype(np.float32), dict(
            refit_targets=y64)
        base = BuildConfig(task="regression", criterion="mse",
                           max_leaf_nodes=63)
    else:
        X, y = covtype_like(20_000, seed=5)
        w = None if task == "classification" else np.random.default_rng(
            5).uniform(0.5, 2, len(y)).astype(np.float32)
        kw = dict(n_classes=7, sample_weight=w)
        base = BuildConfig(max_leaf_nodes=63)
    trees = {}
    for dev in ("cuda", "cpu"):
        binned = bin_for_engine(X, max_bins=256, binning="auto",
                                device=torch.device(dev))
        for engine in ("fused", "levelwise"):
            for sub in ("off", "on"):
                cfg = dataclasses.replace(base, engine=engine,
                                          hist_subtraction=sub)
                before = leafwise_builder.done_reads
                tree = build_tree(binned, y, config=cfg, **kw)
                reads = leafwise_builder.done_reads - before
                assert reads <= (62 // leafwise_builder.CHECK_EVERY
                                 if engine == "fused" else 0)
                trees[(dev, engine, sub)] = tree
    ref = trees[("cpu", "levelwise", "off")]
    assert int((ref.left < 0).sum()) == 63
    for key, tree in trees.items():
        _same_trees(tree, ref, str(key))


def test_row_subsample_mask_on_the_card_equals_the_host(cuda):
    from mpitree_tpu_torch.ops import sampling

    for seed, r, fraction in ((0, 0, 0.5), (7, 13, 0.8), (2**32 - 1, 99,
                                                         0.999)):
        want = sampling.row_subsample_mask(seed, r, 100_003, fraction)
        got = sampling.row_subsample_mask_dev(seed, r, 100_003, fraction,
                                              cuda)
        np.testing.assert_array_equal(got.cpu().numpy(), want)


@pytest.mark.parametrize("what", ["regressor", "classifier"])
def test_fused_rounds_on_the_card_equal_cpu(cuda, what):
    """K = 4 fused rounds on the card against the same fit with
    device="cpu" (margins within 2e-4: the card's float32 tanh may differ
    from the CPU's in its last bit) and against the card's host loop."""
    from mpitree_tpu_torch.tree import (
        GradientBoostingClassifier,
        GradientBoostingRegressor,
    )
    from mpitree_tpu_torch.utils.datasets import california_like, covtype_like

    if what == "regressor":
        X, y = california_like(10_000, seed=6)
        cls, kw = GradientBoostingRegressor, dict(subsample=0.8)
    else:
        X, y = covtype_like(10_000, seed=6)
        y = (y == np.bincount(y).argmax()).astype(np.int64)
        cls, kw = GradientBoostingClassifier, dict(max_leaf_nodes=15)
    kw.update(max_iter=9, learning_rate=0.3, random_state=0)
    fits = {(dev, K): cls(rounds_per_dispatch=K, device=dev, **kw).fit(X, y)
            for dev in ("cuda", "cpu") for K in (4, 1)}

    def margins(m):
        return m.predict(X) if what == "regressor" else m.decision_function(X)

    ref = margins(fits[("cpu", 4)])
    for key, m in fits.items():
        np.testing.assert_allclose(margins(m), ref, rtol=2e-4, atol=2e-4,
                                   err_msg=str(key))
    assert fits[("cuda", 4)].fit_stats_["dispatches"] == 3


# ---------------------------------------------------------------------------
# the serving tier on the card: pinned, overlapped staging, the stream
# stage, the scheduler, the quantized regression tree
# ---------------------------------------------------------------------------

def _on(est, device: str):
    """A shallow copy of a fitted estimator that serves on ``device``."""
    import copy

    out = copy.copy(est)
    out.device = device
    return out


@pytest.mark.parametrize("quant", [None, "int8"])
def test_pinned_staging_on_the_card_equals_the_cpu_path(forest_on_card,
                                                        quant):
    """Every bucket and an oversize batch (six chunks) through the card's
    pinned slots and copy stream: K4 equal to the CPU path bit for bit,
    K5 too (its lattice sum is exact, its float32 affine the same two
    roundings) and within its report of ``predict_proba``."""
    from mpitree_tpu_torch.serving import compile_model, serve_kernel

    forest, _, Xq = forest_on_card
    kw = dict(buckets=(1, 64, 512), quantize=quant, quantize_tol=1.0)
    card = compile_model(forest, **kw)
    cpu = compile_model(_on(forest, "cpu"), **kw)
    counter = "traverse_q" if quant else "traverse"
    before = serve_kernel.launches[counter]
    for n in (1, 37, 64, 512, 3_000):
        got = card.raw(Xq[:n])
        np.testing.assert_array_equal(got, cpu.raw(Xq[:n]))
        if quant is None:
            np.testing.assert_array_equal(got, forest.predict_proba(Xq[:n]))
    assert serve_kernel.launches[counter] - before == 4 + 6
    assert 0 < card._slots.allocated <= 2 * (6 + 3)
    rep = card.serve_report_["quantization"]
    if quant:
        from mpitree_tpu_torch.serving import quantize

        cal = quantize.synthesize_calibration(card.table, Xq.shape[1])
        delta = np.abs(card.raw(cal) - forest.predict_proba(cal)).max()
        assert delta <= rep["max_abs_delta"] + 1e-6


@pytest.mark.parametrize("quant", [None, "int8"])
def test_eight_threads_through_one_model_equal_serial_answers(
        forest_on_card, quant):
    """The slot-reuse race probe: 8 threads, each its own rows and batch
    sizes (one chunked), through one model on the card, many times over;
    every answer equals the serial one."""
    import sys
    import threading

    from mpitree_tpu_torch.serving import compile_model

    forest, _, Xq = forest_on_card
    cm = compile_model(forest, buckets=(1, 64, 512), quantize=quant,
                       quantize_tol=1.0)
    jobs = [Xq[i * 300:i * 300 + n] for i, n in
            enumerate((1, 5, 64, 100, 300, 2, 63, 1))]
    jobs[4] = Xq[1_200:2_900]  # 1,700 rows: four chunks
    want = [cm.raw(X) for X in jobs]
    errors = []

    def worker(i):
        try:
            for _ in range(25):
                if not np.array_equal(cm.raw(jobs[i]), want[i]):
                    errors.append(f"thread {i}: wrong answer")
        except Exception as e:  # noqa: BLE001 — reported by the assert
            errors.append(repr(e))

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert errors == []


def test_stream_stage_on_the_card_equals_raw(forest_on_card):
    from mpitree_tpu_torch.serving import StreamStage, compile_model

    forest, _, Xq = forest_on_card
    cm = compile_model(forest, buckets=(1, 64, 512))
    for depth in (1, 2, 4):
        stage = StreamStage(cm, depth=depth)
        done = []
        for lo in range(0, 3_000, 250):
            done += stage.submit(Xq[lo:lo + 250])
        done += stage.drain()
        assert [t for t, _ in done] == list(range(12))
        got = np.concatenate([o for _, o in done])
        np.testing.assert_array_equal(got, forest.predict_proba(Xq))


@pytest.mark.parametrize("quant", [None, "int8"])
def test_scheduler_on_the_card_equals_direct_raw(forest_on_card, quant):
    from mpitree_tpu_torch.serving import ModelRegistry, Scheduler

    forest, _, Xq = forest_on_card
    reg = ModelRegistry(buckets=(1, 64, 512))
    cm = reg.publish("rf", forest, quantize=quant, quantize_tol=1.0)
    with Scheduler(reg, qos="interactive:10000:512;batch:60000:512",
                   shed_depth=1024, margin_ms=5, wait_ms=2) as s:
        futs = [s.submit("rf", Xq[i], qos="batch" if i % 5 else
                         "interactive") for i in range(200)]
        got = np.stack([f.result(timeout=60) for f in futs])
    np.testing.assert_array_equal(got, cm.raw(Xq[:200]))


def test_quantized_regression_tree_on_the_card_equals_cpu(cuda):
    from mpitree_tpu_torch.serving import compile_model
    from mpitree_tpu_torch.tree import DecisionTreeRegressor
    from mpitree_tpu_torch.utils.datasets import california_like

    X, y = california_like(20_000, seed=0)
    Xq, _ = california_like(5_000, seed=1)
    est = DecisionTreeRegressor(max_depth=10, device="cuda").fit(X, y)
    card = compile_model(est, quantize="int8")
    cpu = compile_model(_on(est, "cpu"), quantize="int8")
    assert card.serve_report_["quantization"] == \
        cpu.serve_report_["quantization"]
    for n in (1, 64, 5_000):
        got = card.raw(Xq[:n])
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, cpu.raw(Xq[:n]))


@pytest.mark.parametrize("task", ["classification", "weighted",
                                  "regression"])
def test_in_process_mesh_on_the_card_equals_one_device(cuda, task):
    """Every visible card as the local shards of one process (one card:
    one shard through the mesh code): the tree equals the one-device fit
    on the card and the 4-shard fit with device="cpu", field for field,
    and sharded predict equals one-device predict."""
    from mpitree_tpu_torch.parallel import mesh as M
    from mpitree_tpu_torch.tree import (DecisionTreeRegressor,
                                        ParallelDecisionTreeClassifier)
    from mpitree_tpu_torch.utils.datasets import california_like, covtype_like

    if task == "regression":
        X, y = california_like(20_000, seed=3)
        make = DecisionTreeRegressor
        kw, fit_kw = dict(max_depth=12, refine_depth=None), {}
    else:
        X, y = covtype_like(20_000, seed=3)
        make = ParallelDecisionTreeClassifier
        kw = dict(max_depth=12, refine_depth=None)
        fit_kw = {} if task == "classification" else dict(
            sample_weight=np.random.default_rng(3).uniform(
                0.5, 2, len(y)).astype(np.float32))
    one = make(n_devices=None, device="cuda", **kw).fit(X, y, **fit_kw)
    par = make(n_devices="all", device="cuda", **kw).fit(X, y, **fit_kw)
    assert par.fit_stats_["n_shards"] == torch.cuda.device_count()
    prev = M.set_cpu_shards(4)
    try:
        cpu = make(n_devices="all", device="cpu", **kw).fit(X, y, **fit_kw)
    finally:
        M.set_cpu_shards(prev)
    _same_trees(par.tree_, one.tree_, "mesh vs one card")
    _same_trees(par.tree_, cpu.tree_, "card mesh vs 4 CPU shards")
    np.testing.assert_array_equal(par.predict(X[:5_000]),
                                  one.predict(X[:5_000]))


def test_global_exponents_on_the_card_equal_the_cpu(cuda):
    """The route statistics reduce on the card to the CPU's route and
    exponents, at one shard and at 4 CPU shards."""
    from mpitree_tpu_torch.core.builder import BuildConfig, FitInputs
    from mpitree_tpu_torch.ops.binning import bin_for_engine
    from mpitree_tpu_torch.parallel import mesh as M
    from mpitree_tpu_torch.utils.datasets import california_like

    X, y = california_like(20_000, seed=3)
    y = (y - y.mean()).astype(np.float32)
    y[17] = 500.0  # the maximum in one shard only
    cfg = BuildConfig(task="regression", criterion="mse", max_depth=4)
    exps = []
    prev = M.set_cpu_shards(4)
    try:
        for dev in ("cuda", "cpu"):
            binned = bin_for_engine(X, max_bins=256, binning="auto",
                                    device=torch.device(dev))
            mesh = M.resolve_mesh(device=dev, n_devices="all")
            exps.append(FitInputs(binned, y, cfg, mesh=mesh).scale_exp)
            exps.append(FitInputs(binned, y, cfg).scale_exp)
    finally:
        M.set_cpu_shards(prev)
    assert all(e == exps[0] for e in exps), exps


@pytest.mark.parametrize("S", [1, 8, 64, 512, 2048])
@pytest.mark.parametrize("df", [2, 4])
def test_feature_slab_equals_full_histogram_columns(cuda, S, df):
    """A (data, feature) mesh hands each shard an ``F/df``-column slab of
    the bins (padded to a multiple of ``df`` with bin-0 columns): every
    route, on the slab's own byte-wide copy and bin counts, gives the same
    columns of the full-F histogram, bit for bit, on both payload
    routes."""
    xb, payload, slot, feat_bins = _hist_inputs(cuda, 20 + S, S)
    B, F = 256, xb.shape[1]
    fl = -(-F // df)
    full = hist_kernel.histogram_reference(xb, payload, slot, n_slots=S,
                                           n_bins=B)
    pad = torch.zeros((xb.shape[0], fl * df - F), dtype=torch.int32,
                      device=cuda)
    xp = torch.cat([xb, pad], dim=1)
    fb_pad = list(feat_bins) + [1] * (fl * df - F)
    ran = set()
    for fi in range(df):
        x_s = xp[:, fi * fl:(fi + 1) * fl].contiguous()
        fb = fb_pad[fi * fl:(fi + 1) * fl]
        packed = hist_kernel.pack_bins(x_s, B)
        lo, hi = fi * fl, min((fi + 1) * fl, F)
        for route in hist_kernel.ROUTES:
            try:
                hist_kernel.plan(S, fl, payload.shape[1], B, route,
                                 feat_bins=fb)
            except ValueError:
                continue
            got = hist_kernel.histogram_cuda(
                x_s, payload, slot, n_slots=S, n_bins=B, packed=packed,
                feat_bins=fb, _variant=route)
            assert torch.equal(got[:, :hi - lo], full[:, lo:hi]), (route, fi)
            # padding columns hold every row in bin 0
            assert torch.equal(got[:, hi - lo:, :, 1:],
                               torch.zeros_like(got[:, hi - lo:, :, 1:]))
            ran.add(route)
        exp = hist_kernel.fixed_point_exponents(payload)
        got = hist_kernel.histogram_cuda(
            x_s, payload, slot, n_slots=S, n_bins=B, packed=packed,
            feat_bins=fb, scale_exp=exp)
        want = hist_kernel.histogram_reference(
            xb, payload, slot, n_slots=S, n_bins=B, scale_exp=exp)
        assert torch.equal(got[:, :hi - lo], want[:, lo:hi]), ("fixed", fi)
    assert ran


@pytest.mark.parametrize("chunk", [1_000, 4_096, 7_777, 20_000])
def test_assemble_binned_on_the_card_equals_the_cpu(cuda, chunk):
    """The streaming placement on the card (one pinned staging buffer,
    ``non_blocking`` copies, an event before each reuse) fills its shard
    exactly as the CPU assembly does, at every chunk size."""
    from mpitree_tpu_torch.ingest import StreamedDataset, ingest_dataset
    from mpitree_tpu_torch.parallel import mesh as M
    from mpitree_tpu_torch.utils.datasets import covtype_like

    X, y = covtype_like(20_000, seed=6)
    ds = StreamedDataset.from_arrays(X, y, chunk_rows=chunk)
    got = ingest_dataset(ds, mesh=M.resolve_mesh(), max_bins=256).binned
    want = ingest_dataset(ds, mesh=M.resolve_mesh(device="cpu"),
                          max_bins=256).binned
    assert len(got.x_binned) == 1 and got.x_binned[0].is_cuda
    assert torch.equal(got.x_binned[0].cpu(), want.x_binned[0])
    np.testing.assert_array_equal(got.thresholds, want.thresholds)


@pytest.mark.parametrize("kind", ["tree", "forest", "boosted"])
def test_streamed_fits_on_the_card_equal_in_memory(cuda, kind):
    """A streamed fit on the card equals the card's in-memory fit (the
    forest's keyed twin) and the CPU's streamed fit field for field."""
    import os

    from mpitree_tpu_torch import (
        DecisionTreeClassifier,
        GradientBoostingRegressor,
        RandomForestClassifier,
        StreamedDataset,
    )
    from mpitree_tpu_torch.utils.datasets import covtype_like

    X, y = covtype_like(20_000, seed=7)
    if kind == "tree":
        make = lambda d: DecisionTreeClassifier(  # noqa: E731
            max_depth=10, refine_depth=None, device=d)
    elif kind == "forest":
        make = lambda d: RandomForestClassifier(  # noqa: E731
            n_estimators=3, max_depth=8, random_state=1, refine_depth=None,
            device=d)
    else:
        y = (y == 1).astype(np.float64)
        make = lambda d: GradientBoostingRegressor(  # noqa: E731
            max_iter=5, rounds_per_dispatch=1, device=d)
    ds = StreamedDataset.from_arrays(X, y, chunk_rows=3_000)
    card, cpu = make(None).fit(ds), make("cpu").fit(ds)
    os.environ["MPITREE_TPU_KEYED_BOOTSTRAP"] = "1"
    try:
        mem = make(None).fit(X, y)
    finally:
        del os.environ["MPITREE_TPU_KEYED_BOOTSTRAP"]
    trees = (lambda e: e.trees_ if hasattr(e, "trees_") else [e.tree_])
    for a, b, c in zip(trees(card), trees(mem), trees(cpu)):
        for k in ("feature", "threshold", "left", "right", "count"):
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
            np.testing.assert_array_equal(getattr(a, k), getattr(c, k))


def test_real_oom_on_the_card_fails_over_to_the_cpu_tree(cuda, monkeypatch):
    """A real ``torch.OutOfMemoryError`` inside the card's build (the
    caching allocator capped below the build's need after binning) is
    classed OOM, terminal. With ``MPITREE_TPU_ELASTIC`` unset (the
    port's default) it raises to the caller; with ``1`` the host rung
    grows the host tier's tree (the card's up to an exact cost tie,
    ``ROADMAP.md`` R3: this data has one, at depth 8); the cap lifted,
    the card fits again."""
    from mpitree_tpu_torch import DecisionTreeClassifier
    from mpitree_tpu_torch.models import classifier as clf_mod
    from mpitree_tpu_torch.resilience import is_oom_failure
    from mpitree_tpu_torch.utils.datasets import covtype_like

    monkeypatch.setenv("MPITREE_TPU_BACKOFF_S", "0")
    X, y = covtype_like(20_000, seed=3)
    kw = dict(max_depth=8, refine_depth=None)
    want = DecisionTreeClassifier(**kw).fit(X, y)
    seen = []
    real_build = clf_mod.build_tree

    def starved(*a, **k):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        used = torch.cuda.memory_reserved()
        total = torch.cuda.get_device_properties(0).total_memory
        torch.cuda.set_per_process_memory_fraction(
            (used + (2 << 20)) / total)
        try:
            return real_build(*a, **k)
        except Exception as e:
            seen.append(e)
            raise
        finally:
            torch.cuda.set_per_process_memory_fraction(1.0)

    monkeypatch.setattr(clf_mod, "build_tree", starved)
    monkeypatch.delenv("MPITREE_TPU_ELASTIC", raising=False)
    with pytest.raises(torch.OutOfMemoryError):
        DecisionTreeClassifier(**kw).fit(X, y)
    assert len(seen) == 1 and is_oom_failure(seen[0])
    monkeypatch.setenv("MPITREE_TPU_ELASTIC", "1")
    with pytest.warns(UserWarning, match="rebuilding on the host tier"):
        got = DecisionTreeClassifier(**kw).fit(X, y)
    monkeypatch.setattr(clf_mod, "build_tree", real_build)
    assert len(seen) == 2 and isinstance(seen[1], torch.OutOfMemoryError)
    assert is_oom_failure(seen[1])
    assert got.fit_stats_["device_failovers"] == 1
    assert got.fit_stats_["engine"] == "host"
    host = DecisionTreeClassifier(backend="host", device="cpu",
                                  **kw).fit(X, y)
    for k in ("feature", "threshold", "left", "right", "count"):
        np.testing.assert_array_equal(getattr(got.tree_, k),
                                      getattr(host.tree_, k))
    again = DecisionTreeClassifier(**kw).fit(X, y)
    np.testing.assert_array_equal(again.tree_.feature, want.tree_.feature)


@pytest.mark.parametrize("spec,rung", [
    ("dispatch:1:unavailable", "device_retries"),
    ("level:1:deadline:at_level=3", "level_retries")])
def test_retry_on_the_card_grows_the_same_tree(cuda, monkeypatch, spec,
                                               rung):
    """A transient fault retries on the card (the levelwise engine from
    its level): the tree of an uninterrupted card fit."""
    from mpitree_tpu_torch import DecisionTreeClassifier
    from mpitree_tpu_torch.resilience import chaos
    from mpitree_tpu_torch.utils.datasets import covtype_like

    monkeypatch.setenv("MPITREE_TPU_BACKOFF_S", "0")
    monkeypatch.setenv("MPITREE_TPU_ENGINE", "levelwise")
    monkeypatch.delenv("MPITREE_TPU_ELASTIC", raising=False)
    X, y = covtype_like(20_000, seed=4)
    kw = dict(max_depth=8, refine_depth=None)
    want = DecisionTreeClassifier(**kw).fit(X, y)
    chaos.install(spec)
    try:
        with pytest.warns(UserWarning):
            got = DecisionTreeClassifier(**kw).fit(X, y)
    finally:
        chaos.clear()
    assert got.fit_stats_[rung] == 1 and got.fit_stats_["engine"] != "host"
    for k in ("feature", "threshold", "left", "right", "count"):
        np.testing.assert_array_equal(getattr(got.tree_, k),
                                      getattr(want.tree_, k))

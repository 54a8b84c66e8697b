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
        assert gpu.fit_stats_["engine"] == "device"
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

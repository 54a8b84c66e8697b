"""The port's memory ledger (``mpitree_tpu_torch/obs/memory.py``) against
the JAX package's (``mpitree_tpu/obs/memory.py``) and against what the
port allocates.

- **Pinned decisions.** Every sizing decision whose formula moved into
  ``obs/memory.py`` (the chunk and table widths, the mesh shape
  policies, the fused rounds' pool blocker, the serving tile) equals its
  formula from before the move, copied here, over a grid of shapes.
- **The same ledger as JAX.** For the same statics and engine the port's
  plan has the JAX package's array names and phases; the arrays only the
  port holds are listed (:data:`PORT_ONLY`).
- **Schema.** ``fit_report_["memory"]`` on every estimator, streamed fits
  too, with the JAX package's field names; the digest carries the peaks.
- **Refusal.** Under a small ``MPITREE_TPU_HBM_BYTES`` a fit refuses
  before any call of the histogram's plain version, with the
  ``oom_predicted`` fields of the JAX package's refusal of the same fit.
- **drift_check.** The JAX package's cases, one for one.
- **Bracket on the CPU.** Under ``MPITREE_TPU_MEM_SAMPLE=1`` the live
  tensor bytes of a small fit stay under the ledger's peak / 0.8.
"""

from __future__ import annotations

import json
import math

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from mpitree_tpu import DecisionTreeClassifier as JDecisionTreeClassifier  # noqa: E402,E501
from mpitree_tpu.core.leafwise_builder import (  # noqa: E402
    _pool_capacity as jax_pool_capacity,
)
from mpitree_tpu.obs import memory as jax_memory  # noqa: E402

from mpitree_tpu_torch import (  # noqa: E402
    DecisionTreeClassifier,
    DecisionTreeRegressor,
    ExtraTreesClassifier,
    GradientBoostingClassifier,
    GradientBoostingRegressor,
    RandomForestClassifier,
    RandomForestRegressor,
    StreamedDataset,
)
from mpitree_tpu_torch import obs  # noqa: E402
from mpitree_tpu_torch.boosting import fused_rounds  # noqa: E402
from mpitree_tpu_torch.core import builder  # noqa: E402
from mpitree_tpu_torch.core import leafwise_builder  # noqa: E402
from mpitree_tpu_torch.obs import memory  # noqa: E402
from mpitree_tpu_torch.ops import hist_kernel  # noqa: E402
from mpitree_tpu_torch.parallel import mesh as mesh_lib  # noqa: E402
from mpitree_tpu_torch.serving import serve_kernel  # noqa: E402
from mpitree_tpu_torch.utils.datasets import covtype_like  # noqa: E402

HBM = "MPITREE_TPU_HBM_BYTES"
SAMPLE = "MPITREE_TPU_MEM_SAMPLE"

# arrays the port's ledger prices that the JAX package's does not hold
PORT_ONLY = {
    "x_packed": "the byte-wide bins the histogram kernels read",
    "payload": "the (N, C) float32 histogram payload",
    "row_order": "a level's sorted-route row order and new node ids",
    "payload_q": "the terminal sums' int64 payload",
    "node_state": "the fused engine's tree on the card",
    "bin_workspace": "the device binning's transient",
    "weight": "a forest's row weights (JAX keeps only tree_weights)",
    "cand_mask": "a forest's shared candidate mask",
}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data():
    return covtype_like(3_000, seed=0)


# -- pinned decisions ---------------------------------------------------------

def _old_chunk_size(n, f, b, c, cfg, cell):
    """``core/builder._chunk_size`` before its formula moved."""
    per_node = f * b * (c * cell + 8 * 8)
    cap = max(1, cfg.hist_budget_bytes // max(per_node, 1))
    cap = min(cap, cfg.max_frontier_chunk)
    widest = n
    if cfg.max_depth is not None and cfg.max_depth < 31:
        widest = min(widest, 2 ** cfg.max_depth)
    widest = max(widest, 1)
    want = 1 << max(0, math.ceil(math.log2(max(widest, 1))))
    return min(want, 1 << int(math.log2(cap)))


def _old_table_slots(n, cfg):
    widest = n
    if cfg.max_depth is not None and cfg.max_depth < 31:
        widest = min(widest, 2 ** cfg.max_depth)
    widest = min(max(widest, 1), cfg.max_table_slots)
    return 1 << max(0, math.ceil(math.log2(widest)))


SHAPES = [
    (581_012, 54, 256, 7, 4 << 30, 4096, 20),
    (581_012, 8, 256, 3, 4 << 30, 4096, None),
    (50_000, 54, 256, 7, 4 << 30, 4096, 10),
    (48_000, 54, 256, 7, 1 << 28, 4096, 20),
    (2_000, 8, 64, 3, 4 << 30, 4096, 6),
    (100, 4, 16, 2, 1 << 20, 64, None),
    (200_000, 54, 256, 7, 4 << 30, 512, 12),
]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("cell", [4, 8])
def test_chunk_size_pinned(shape, cell):
    n, f, b, c, budget, cap, depth = shape
    cfg = builder.BuildConfig(hist_budget_bytes=budget,
                              max_frontier_chunk=cap, max_depth=depth)
    assert builder._chunk_size(n, f, b, c, cfg, cell_bytes=cell) == \
        _old_chunk_size(n, f, b, c, cfg, cell)
    assert builder.chunk_bytes_per_slot(f, b, c, cell) == \
        f * b * (c * cell + 64)


@pytest.mark.parametrize("shape", SHAPES)
def test_table_slots_pinned(shape):
    n, *_, depth = shape
    for max_slots in (1 << 17, 64):
        cfg = builder.BuildConfig(max_depth=depth,
                                  max_table_slots=max_slots)
        assert builder._table_slots(n, cfg) == _old_table_slots(n, cfg)


def _old_data_feature(d, n_features, hist_bytes, hist_budget):
    divisors = [k for k in range(1, d + 1) if d % k == 0]
    usable = [k for k in divisors if k <= max(int(n_features), 1)]
    f = 1
    if hist_budget:
        while f < max(usable) and hist_bytes > hist_budget * f:
            f = min(k for k in usable if k > f)
    return d // f, f


@pytest.mark.parametrize("case", [
    (8, 54, 0, None), (8, 54, 1 << 20, None), (8, 54, 4 << 20, 1 << 20),
    (8, 54, 2 << 20, 1 << 20), (8, 3, 64 << 20, 1 << 20), (1, 54, 0, 1),
    (4, 2, 10 << 20, 1 << 20), (16, 54, 32 << 20, 1 << 20)])
def test_data_feature_shape_pinned(case):
    d, nf, hb, budget = case
    assert mesh_lib.data_feature_shape(
        d, nf, hist_bytes=hb, hist_budget=budget) == \
        _old_data_feature(d, nf, hb, budget)


def _old_tree_data(d, n_trees, dataset_bytes, hbm_budget):
    divisors = [k for k in range(1, d + 1) if d % k == 0]
    t = max(k for k in divisors if k <= max(int(n_trees), 1))
    if hbm_budget:
        while t > 1 and dataset_bytes > hbm_budget * (d // t):
            t = max(k for k in divisors if k < t)
    return t, d // t


@pytest.mark.parametrize("case", [
    (8, 8, 0, None), (8, 2, 0, None), (8, 8, 100, 30), (8, 8, 10**9, 1),
    (8, 5, 10**6, 10**5), (1, 4, 0, None), (4, 50, 4 * 581_012 * 54, 1)])
def test_tree_data_shape_pinned(case):
    d, nt, db, budget = case
    assert mesh_lib.tree_data_shape(
        d, nt, dataset_bytes=db, hbm_budget=budget) == \
        _old_tree_data(d, nt, db, budget)


def test_mesh_slab_is_the_ledger_formula():
    assert mesh_lib.slab_bytes is memory.slab_bytes
    assert memory.slab_bytes(64, 54, 7, 256) == 64 * 54 * 7 * 256 * 4


@pytest.mark.parametrize("case", [
    (255, None, 581_012, 54, 256, None), (31, 6, 581_012, 8, 256, None),
    (4096, 12, 581_012, 54, 256, None), (8192, None, 10**6, 54, 256, None),
    (255, None, 100, 54, 256, 1 << 20), (None, 6, 50_000, 8, 256, None)])
def test_fused_rounds_pool_blocker_pinned(case):
    mln, depth, n, f, b, budget = case
    _, reason = fused_rounds.resolve_rounds_per_dispatch(
        "auto", device_type="cuda", loss_kind="squared_error", loss_K=1,
        early_stopping=False, colsample=1.0, max_depth=depth,
        max_leaf_nodes=mln, n_samples=n, n_features=f, n_bins=b,
        hist_budget_bytes=budget)
    pn = leafwise_builder._pool_capacity(
        mln if mln is not None else 1 << 30, depth, n)
    pool_bytes = pn * f * 3 * b * 4
    blocked = (pn > fused_rounds.FUSED_POOL_CEILING
               or pool_bytes > (budget or 4 << 30))
    assert ("leaf pool of" in reason) is blocked
    assert memory.pool_hist_bytes(pn, f, b) == pool_bytes


@pytest.mark.parametrize("args", [
    (255, None, 10**6), (255, 6, 10**6), (4096, 20, 100), (2, 1, 50),
    (1 << 30, 6, 581_012)])
def test_pool_capacity_equals_jax(args):
    assert leafwise_builder._pool_capacity(*args) == \
        memory.pool_capacity(*args) == jax_pool_capacity(*args)


def _old_smem(rows, chunk, n_out, n_features, acc_bytes, norm, stage_x):
    def a16(b):
        return -(-b // 16) * 16
    return (a16(rows * n_out * acc_bytes) + (a16(rows * chunk * 8) if norm
                                             else 0)
            + a16(rows * chunk * 4)
            + (a16(rows * n_features * 4) if stage_x else 0))


@pytest.mark.parametrize("case", [
    ("traverse", 1, 50, 7, "sum"), ("traverse", 4096, 50, 7, "sum"),
    ("traverse", 500_000, 50, 7, "norm"), ("traverse", 4096, 700, 7,
                                           "percls"),
    ("traverse_q", 4096, 50, 7, "sum"), ("traverse", 64, 1, 1, "sum")])
def test_serving_tile_pinned(case):
    form, rows, trees, n_out, agg = case
    p = serve_kernel.plan(form, rows, trees, n_out, n_features=54, agg=agg)
    acc = 8 if form == "traverse" else 4
    assert p["smem"] == _old_smem(p["rows_per_block"],
                                  p["trees_per_chunk"], n_out, 54, acc,
                                  agg == "norm", p["stage_x"])
    assert serve_kernel._smem_bytes is memory.serve_smem_bytes


@pytest.mark.parametrize("quantized", [False, True], ids=["k4", "k5"])
def test_margin_pack_priced_as_allocated(quantized):
    """A boosted model's margin pack (``serve_kernel.pack_margin``), passed
    as ``plan_serve(margin=...)``: each of its tensors is priced at its
    own shape and item size in place of the general body's 16-byte
    records, and the tile is the margin body's plan from the pack's own
    chunks; without it the plan prices the records and no margin array
    (the JAX ledger's names)."""
    from mpitree_tpu_torch.serving import compile_model, quantize

    X, y = covtype_like(1_500, seed=7)
    est = GradientBoostingClassifier(max_iter=4, max_depth=3, device="cpu",
                                     random_state=3).fit(X, y)
    cm = compile_model(est)
    T, M, K = cm.table.n_trees, cm.table.n_nodes, cm.n_out
    if quantized:
        q = quantize.build_state(
            cm.table, quantize.prepare_channel(
                "margin", cm._values.numpy()), kind="margin", scale=1.0,
            n_steps=cm.table.n_steps, tol=math.inf,
            device=torch.device("cpu"), n_features=54, n_out=K)
        pack = serve_kernel.pack_margin(q.feature, q.threshold, q.left,
                                        q.right, q.root, q.qvals, n_out=K,
                                        form="traverse_q")
    else:
        pack = serve_kernel.pack_margin(*cm._dev_table, cm._values,
                                        n_out=K, form="traverse")
    assert pack.serves
    kw = dict(n_trees=T, n_nodes_total=M, n_nodes_max=M, n_features=54,
              value_channels=1, n_out=K, kernel=True, quantized=quantized)
    plan = memory.plan_serve(**kw, margin=pack)
    arrays = {a["name"]: a for a in plan.arrays}
    held = pack.tensors()
    assert ("margin_leaf_values" in held) != quantized
    for name, t in held.items():
        a = arrays[name]
        assert (a["shape"], a["itemsize"]) == (list(t.shape),
                                               t.element_size()), name
        assert a["bytes_per_device"] == memory._block(
            t.numel() * t.element_size())
    assert "kernel_tables" not in arrays and plan.inputs["margin_body"]
    p = serve_kernel.plan_margin(
        "traverse_q" if quantized else "traverse", 4_096, K, n_features=54,
        table_bytes=pack.table_bytes, chunk_trees=pack.chunk_trees)
    assert plan.inputs["kernel_tile"] == {
        "rows_per_block": p["rows_per_block"], "smem": p["smem"],
        "stage_x": p["stage_x"], "body": "margin"}
    plain = memory.plan_serve(**kw)
    names = {a["name"] for a in plain.arrays}
    assert "kernel_tables" in names and not names & set(held)
    assert not plain.inputs["margin_body"]


# -- the same ledger as JAX -----------------------------------------------------

def _names(plan) -> dict:
    return {a["name"]: a["phase"] for a in plan.arrays}


@pytest.mark.parametrize("engine,kw", [
    ("fused", dict(max_depth=10)),
    ("levelwise", dict(max_depth=10, subtraction=True)),
    ("leafwise", dict(max_leaf_nodes=255)),
    ("leafwise", dict(max_leaf_nodes=255, subtraction=True)),
    ("fused_rounds", dict(task="gbdt", max_depth=6, max_leaf_nodes=64,
                          rounds_per_dispatch=8)),
])
def test_fit_ledger_names_and_phases_equal_jax(engine, kw):
    st = dict(rows=50_000, features=54, classes=7, bins=256, **kw)
    mine = memory.plan_fit(engine=engine, device_bin=True, **st)
    jax = jax_memory.plan_fit(engine=engine, **st)
    m, j = _names(mine), _names(jax)
    assert {k: m[k] for k in j} == j  # every JAX array, in its phase
    assert set(m) - set(j) <= set(PORT_ONLY)
    assert mine.inputs["engine"] == jax.inputs["engine"] == engine
    assert set(mine.to_dict()) == set(jax.to_dict())
    assert set(mine.inputs) == set(jax.inputs)


def test_forest_ledger_names_equal_jax():
    st = dict(n_trees=50, rows=200_000, features=54, classes=7, bins=256,
              max_depth=12)
    mine, jax = memory.plan_forest(**st), jax_memory.plan_forest(**st)
    m, j = _names(mine), _names(jax)
    assert set(j) <= set(m) and set(m) - set(j) <= set(PORT_ONLY)
    assert mine.kind == jax.kind == "forest"
    assert set(mine.inputs) == set(jax.inputs)


def test_ingest_and_serve_ledgers_equal_jax():
    st = dict(rows=100_000, features=54, chunk_rows=4096,
              sketch_capacity=1 << 20, mesh_axes={"data": 2, "feature": 1})
    mine, jax = memory.plan_ingest(**st), jax_memory.plan_ingest(**st)
    assert mine.to_dict() == jax.to_dict()  # host arithmetic, one formula
    sv = dict(n_trees=50, n_nodes_total=400_000, n_nodes_max=8191,
              n_features=54, value_channels=7, n_out=7)
    mine, jax = memory.plan_serve(**sv), jax_memory.plan_serve(**sv)
    assert _names(mine) == _names(jax)
    assert mine.peak_phase == jax.peak_phase == "dispatch"


@pytest.mark.parametrize("name,engine,knob", [
    ("split_hist_chunk", None, "max_frontier_chunk"),
    ("parent_hist", None, "hist_subtraction"),
    ("margin_carry", "fused_rounds", "rounds_per_dispatch"),
    ("margin_carry", None, None),
    ("pool_hist", "leafwise", "hist_subtraction"),
    ("pool_hist", "fused_rounds", "rounds_per_dispatch"),
    ("x_binned", None, None), ("node_state", "fused", None)])
def test_shrink_knob_equals_jax(name, engine, knob):
    assert memory.shrink_knob(name, engine=engine) == knob
    assert jax_memory.shrink_knob(name, engine=engine) == knob


# -- schema on every estimator --------------------------------------------------

JAX_FIELDS = set(jax_memory.plan_fit(rows=10, features=2).to_dict())


def _estimators(X, y, yr):
    yb = (y == y[0]).astype(np.int64)
    return {
        "tree": lambda: DecisionTreeClassifier(max_depth=5, device="cpu"
                                               ).fit(X, y),
        "regressor": lambda: DecisionTreeRegressor(max_depth=5, device="cpu"
                                                   ).fit(X, yr),
        "forest": lambda: RandomForestClassifier(
            n_estimators=3, max_depth=4, device="cpu", random_state=0
        ).fit(X, y),
        "forest_regressor": lambda: RandomForestRegressor(
            n_estimators=2, max_depth=4, device="cpu", random_state=0
        ).fit(X, yr),
        "extra_trees": lambda: ExtraTreesClassifier(
            n_estimators=2, max_depth=4, device="cpu", random_state=0
        ).fit(X, y),
        "boosting": lambda: GradientBoostingClassifier(
            max_iter=2, max_depth=3, device="cpu").fit(X, yb),
        "fused_rounds": lambda: GradientBoostingRegressor(
            max_iter=2, max_depth=3, rounds_per_dispatch=2, device="cpu"
        ).fit(X, yr),
        "leafwise": lambda: DecisionTreeClassifier(
            max_leaf_nodes=15, device="cpu").fit(X, y),
        "host": lambda: DecisionTreeClassifier(
            max_depth=4, backend="host", device="cpu").fit(X, y),
        "streamed": lambda: DecisionTreeClassifier(
            max_depth=5, device="cpu").fit(
                dataset=StreamedDataset.from_arrays(X, y, chunk_rows=1000)),
    }


@pytest.fixture(scope="module")
def fitted(data):
    X, y = data
    yr = X[:, 0] * 2.0 + np.sin(X[:, 1] / 500.0)
    return {k: f() for k, f in _estimators(X, y, yr).items()}


@pytest.mark.parametrize("name", list(_estimators(
    np.zeros((2, 2)), np.zeros(2), np.zeros(2))))
def test_every_estimator_records_the_memory_section(fitted, name):
    rep = fitted[name].fit_report_
    mem = rep["memory"]
    assert JAX_FIELDS <= set(mem), name
    assert mem["schema"] == memory.MEMORY_SCHEMA == jax_memory.MEMORY_SCHEMA
    d = obs.digest(rep)
    assert d["hbm_peak_bytes"] == mem["hbm_peak_bytes"]
    assert d["host_peak_bytes"] == mem["host_peak_bytes"]
    if name == "host":
        assert mem["inputs"]["engine"] == "host"
        assert mem["host_peak_bytes"] > 0 and mem["hbm_peak_bytes"] == 0
    else:
        assert mem["hbm_peak_bytes"] > 0
    if name == "streamed":
        assert mem["inputs"].get("streamed") is True
        assert mem["aggregate"]["rounds"] == 2  # the ingest's and the fit's
    if name == "boosting":
        assert mem["aggregate"]["rounds"] >= 2  # one plan a round
    assert json.loads(json.dumps(rep)) == rep


# -- refusal --------------------------------------------------------------------

def test_refusal_before_any_plain_histogram_call(data, monkeypatch):
    X, y = data
    calls = []
    real = hist_kernel.histogram_reference

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(hist_kernel, "histogram_reference", counted)
    monkeypatch.setenv(HBM, str(1 << 20))
    made = []
    from mpitree_tpu_torch.models import classifier as clf_mod

    real_obs = clf_mod.fit_observer
    monkeypatch.setattr(clf_mod, "fit_observer",
                        lambda *a, **k: made.append(real_obs(*a, **k))
                        or made[-1])
    kw = dict(max_depth=6, refine_depth=None)
    with pytest.raises(memory.MemoryPlanError) as err:
        DecisionTreeClassifier(device="cpu", **kw).fit(X, y)
    assert not calls
    ev = [e for e in made[-1].record.events if e["kind"] == "oom_predicted"]
    assert len(ev) == 1 and ev[0]["binding_array"] == \
        err.value.binding_array == "split_hist_chunk"
    with pytest.raises(jax_memory.MemoryPlanError) as jerr:
        JDecisionTreeClassifier(backend="cpu", **kw).fit(X, y)
    assert jerr.value.binding_array == err.value.binding_array
    jax_fields = {"kind", "message", "binding_array", "binding_bytes",
                  "hbm_peak_bytes", "budget_bytes", "top"}
    assert set(ev[0]) == jax_fields
    assert ev[0]["budget_bytes"] == 1 << 20
    assert "MPITREE_TPU_HBM_BYTES" in str(err.value)


def test_budget_source(monkeypatch):
    monkeypatch.setenv(HBM, "12345")
    assert memory.device_hbm_budget("cpu") == 12345
    monkeypatch.setenv(HBM, "not-a-number")
    assert memory.device_hbm_budget("cpu") is None
    monkeypatch.delenv(HBM)
    assert memory.device_hbm_budget("cpu") is None  # the CPU refuses nothing


# -- drift_check: the JAX package's cases, with the port's sources ------------

EXACT, FALLBACK = memory.ALLOCATOR_SOURCE, memory.LIVE_TENSORS_SOURCE


@pytest.mark.parametrize("case", ["within", "under_fallback", "under_exact",
                                  "over_fallback", "over_exact", "none",
                                  "zero"])
def test_drift_check_semantics(case):
    big = int(100 * (memory.drift_tolerance() + 1))
    if case == "within":
        assert memory.drift_check(100, 90, EXACT) is None
    elif case == "under_fallback":
        d = memory.drift_check(100, 200, FALLBACK)
        assert d is not None and d["direction"] == "underestimate"
    elif case == "under_exact":
        d = memory.drift_check(100, 200, EXACT)
        assert d is not None and d["direction"] == "underestimate"
    elif case == "over_fallback":
        assert memory.drift_check(big, 100, FALLBACK) is None
    elif case == "over_exact":
        d = memory.drift_check(big, 100, EXACT)
        assert d is not None and d["direction"] == "overestimate"
    elif case == "none":
        assert memory.drift_check(None, 100) is None
    else:
        assert memory.drift_check(100, 0) is None


def test_drift_tolerance_knob(monkeypatch):
    monkeypatch.setenv("MPITREE_TPU_MEM_DRIFT_TOL", "2.5")
    assert memory.drift_tolerance() == 2.5
    assert memory.drift_check(300, 100, EXACT)["direction"] == "overestimate"


# -- the bracket on the CPU -------------------------------------------------------

def test_live_tensors_bracket_a_small_fit(data, monkeypatch, tmp_path):
    X, y = data
    monkeypatch.setenv(SAMPLE, "1")
    trace = tmp_path / "t.json"
    clf = DecisionTreeClassifier(max_depth=6, refine_depth=None,
                                 device="cpu").fit(X, y, trace_to=trace)
    rep = clf.fit_report_
    live = rep["memory"]["live"]
    assert live["source"] == FALLBACK
    assert live["samples"] >= 4
    assert 0 < live["hbm_peak_delta_bytes"] <= \
        rep["memory"]["hbm_peak_bytes"] / 0.8
    assert {"bin", "shard", "fused_build"} <= set(live["span_peaks"])
    assert not [e for e in rep["events"]
                if e["kind"] == "mem_estimate_drift"]
    assert clf.fit_stats_ is not None  # sampling implies timing
    events = json.load(open(trace))["traceEvents"]
    assert any(e.get("name") == "mem_hbm_bytes" and e.get("ph") == "C"
               for e in events)


def test_an_underestimate_is_a_typed_event(data, monkeypatch):
    X, y = data
    monkeypatch.setenv(SAMPLE, "1")
    real = memory.plan_fit
    monkeypatch.setattr(memory, "plan_fit", lambda **k: _tiny(real(**k)))
    clf = DecisionTreeClassifier(max_depth=4, refine_depth=None,
                                 device="cpu").fit(X, y)
    ev = [e for e in clf.fit_report_["events"]
          if e["kind"] == "mem_estimate_drift"]
    assert len(ev) == 1 and ev[0]["direction"] == "underestimate"
    assert ev[0]["source"] == FALLBACK


def _tiny(plan):
    plan.hbm_peak_bytes = 1
    return plan


def test_memwatch_counts_only_what_follows_its_baseline(monkeypatch):
    """On the card each sample reads the allocator's peak since the last
    reset; the baseline's reading is the process's history, not the
    fit's."""
    readings = iter([(100, 900), (150, 300), (120, 130)])
    monkeypatch.setattr(memory, "live_hbm_bytes",
                        lambda dev=None: (*next(readings), EXACT))
    w = memory.MemWatch("cuda:0")
    w.sample()
    w.sample("split")
    w.sample()
    got = w.summary()
    assert got["hbm_baseline_bytes"] == 100
    assert got["hbm_peak_delta_bytes"] == 200
    assert got["span_peaks"] == {"split": 200}
    assert got["source"] == EXACT


def test_watch_memory_without_the_knob(data):
    o = obs.BuildObserver(timing=False)
    assert not o.watching_memory
    o.device = torch.device("cpu")
    o.watch_memory()
    assert o.watching_memory and o.enabled
    with o.span("x"):
        keep = torch.ones(1 << 16)
    rep = o.report()
    assert rep["memory"]["live"]["hbm_peak_delta_bytes"] >= keep.numel() * 4


def test_sampling_is_off_by_default(data, monkeypatch):
    for name in (SAMPLE, "MPITREE_TPU_PROFILE", "MPITREE_TPU_TRACE_DIR"):
        monkeypatch.delenv(name, raising=False)
    X, y = data
    clf = DecisionTreeClassifier(max_depth=3, refine_depth=None,
                                 device="cpu").fit(X, y)
    assert "live" not in clf.fit_report_["memory"]
    assert clf.fit_stats_ is None

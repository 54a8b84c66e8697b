"""The port's compute ledger (``mpitree_tpu_torch/obs/cost.py``) against
the JAX package's (``mpitree_tpu/obs/cost.py``).

- the join (``compute_section``) is the JAX package's arithmetic: the
  same report and captures give the same section;
- on the CPU both packages price to None (no peak row); an unknown card
  prices to None with one typed ``cost_unavailable`` event per entry, and
  so does a count that fails;
- with ``MPITREE_TPU_PEAK_FLOPS``/``_PEAK_HBM_GBPS`` set, every engine's
  entry is priced: floor, dispatches, measured wall, utilisation, bound;
- a tiny fit's bytes and flops equal a count by hand, and so does a
  batch through the boosted-margin body;
- the H100 rows match the names ``torch.cuda.get_device_name()`` returns
  for SXM and PCIe parts.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from mpitree_tpu import DecisionTreeClassifier as JDecisionTreeClassifier  # noqa: E402,E501
from mpitree_tpu.obs import cost as jax_cost  # noqa: E402

from mpitree_tpu_torch import (  # noqa: E402
    DecisionTreeClassifier,
    GradientBoostingRegressor,
    RandomForestClassifier,
)
from mpitree_tpu_torch import obs  # noqa: E402
from mpitree_tpu_torch.obs import cost  # noqa: E402
from mpitree_tpu_torch.ops import hist_kernel  # noqa: E402
from mpitree_tpu_torch.serving import ModelRegistry  # noqa: E402
from mpitree_tpu_torch.utils.datasets import covtype_like  # noqa: E402

FLOPS, HBM = cost.PEAK_FLOPS_ENV, cost.PEAK_HBM_ENV


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data():
    return covtype_like(3_000, seed=0)


@pytest.fixture(autouse=True)
def _fresh_costs():
    """Each test prices its entries anew (captures are process-wide)."""
    obs.REGISTRY._costs.clear()
    yield


def _report(n_shards=1):
    return {
        "phases": {"split": {"seconds": 0.2, "calls": 6},
                   "fused_build": {"seconds": 0.1, "calls": 1}},
        "collectives": {"split_hist_psum": {"calls": 6, "bytes": 4096}},
        "counters": {"expansions": 30},
        "levels": [
            {"level": 0, "hist_bytes": 1e6, "psum_bytes": 1e5,
             "seconds": 0.05},
            {"level": 1, "hist_bytes": 2e6, "psum_bytes": 2e5,
             "seconds": None},
        ],
        "wire": {"n_shards": n_shards, "wire_bytes_per_shard": 0},
        "mesh": {"axes": {"data": n_shards}},
    }


PEAKS = {"flops": 1e12, "hbm_gbps": 100.0, "ici_gbps": 50.0,
         "device_kind": "test", "source": "env"}


@pytest.mark.parametrize("entry", ["split_fn", "fused_fn"])
@pytest.mark.parametrize("n_shards", [1, 4])
def test_join_equals_jax(entry, n_shards):
    caps = {entry: {"flops": 2e9, "bytes": 1e9, "variants": 2}}
    mine = cost.compute_section(_report(n_shards), caps, PEAKS)
    jax = jax_cost.compute_section(_report(n_shards), caps, PEAKS)
    assert mine == jax


def test_entry_join_and_host_entries_names_equal_jax():
    assert set(cost.ENTRY_JOIN) == set(jax_cost.ENTRY_JOIN)
    assert set(cost.HOST_ENTRIES) == set(jax_cost.HOST_ENTRIES)
    assert cost.host_only_section({}) == jax_cost.host_only_section({})


@pytest.mark.parametrize("name,row", [
    ("NVIDIA H100 80GB HBM3", (67e12, 3350.0, 900.0)),
    ("NVIDIA H100 SXM5 80GB", (67e12, 3350.0, 900.0)),
    ("NVIDIA H100 PCIe", (51e12, 2000.0, None)),
    ("NVIDIA A100-SXM4-80GB", (None, None, None)),
    (None, (None, None, None))])
def test_h100_rows_match_device_names(name, row, monkeypatch):
    monkeypatch.delenv(FLOPS, raising=False)
    monkeypatch.delenv(HBM, raising=False)
    p = cost.platform_peaks(name)
    assert (p["flops"], p["hbm_gbps"], p["ici_gbps"]) == row
    assert p["source"] == ("table" if row[0] else "unknown")
    assert p["device_kind"] == name


def test_env_overrides_field_by_field(monkeypatch):
    monkeypatch.setenv(FLOPS, "5e12")
    p = cost.platform_peaks("Strange Accelerator 9000")
    assert p["source"] == "env" and p["flops"] == 5e12
    assert p["hbm_gbps"] is None
    monkeypatch.setenv(HBM, "1000")
    assert cost.platform_peaks(None)["hbm_gbps"] == 1000.0


def test_cpu_prices_to_none_in_both_packages(data, monkeypatch):
    monkeypatch.delenv(FLOPS, raising=False)
    monkeypatch.delenv(HBM, raising=False)
    X, y = data
    kw = dict(max_depth=5, refine_depth=None)
    port = DecisionTreeClassifier(device="cpu", **kw).fit(X, y)
    jax = JDecisionTreeClassifier(backend="cpu", **kw).fit(X, y)
    for rep in (port.fit_report_, jax.fit_report_):
        comp = rep["compute"]
        assert comp["entries"]
        for e in comp["entries"].values():
            assert e["optimal_s"] is None and e["util_pct"] is None
            assert e["bound"] is None
        assert comp["roofline"] is None and comp["util_pct"] is None
        assert comp["peak"]["source"] == "unknown"
    assert set(port.fit_report_["compute"]["entries"]) == \
        set(jax.fit_report_["compute"]["entries"]) == {"fused_fn"}
    # the CPU is not a card without a row: silent, as the JAX package
    kinds = [e["kind"] for e in port.fit_report_["events"]]
    assert kinds == [e["kind"] for e in jax.fit_report_["events"]] == []


def test_unknown_card_is_a_typed_event(data, monkeypatch):
    monkeypatch.delenv(FLOPS, raising=False)
    monkeypatch.delenv(HBM, raising=False)
    monkeypatch.setattr(cost, "device_kind", lambda dev=None: "Strange GPU")
    X, y = data
    clf = DecisionTreeClassifier(max_depth=4, refine_depth=None,
                                 device="cpu").fit(X, y)
    ev = [e for e in clf.fit_report_["events"]
          if e["kind"] == "cost_unavailable"]
    assert len(ev) == 1 and ev[0]["entry"] == "fused_fn"
    assert "Strange GPU" in ev[0]["message"]
    assert clf.fit_report_["compute"]["entries"]["fused_fn"][
        "optimal_s"] is None


def test_a_failing_count_degrades_to_one_event():
    o = obs.BuildObserver(timing=False)

    def boom():
        raise RuntimeError("no count")

    o.price_dispatch("split_fn", "k1", boom)
    o.price_compile("split_fn", boom)  # deduplicated
    o.price_compile("counts_fn", lambda: {})
    kinds = [e["kind"] for e in o.record.events]
    assert kinds == ["cost_unavailable", "cost_unavailable"]
    assert "compute" in o.report()


def _fits(X, y):
    yr = X[:, 0] * 2.0 + np.sin(X[:, 1] / 500.0)
    return {
        "fused_fn": lambda: DecisionTreeClassifier(
            max_depth=5, refine_depth=None, device="cpu").fit(X, y),
        "split_fn": lambda: GradientBoostingRegressor(
            max_iter=2, max_depth=3, rounds_per_dispatch=1,
            device="cpu").fit(X, yr),
        "forest_fn": lambda: RandomForestClassifier(
            n_estimators=2, max_depth=4, refine_depth=None, device="cpu",
            random_state=0).fit(X, y),
        "leafwise_fn": lambda: DecisionTreeClassifier(
            max_leaf_nodes=15, device="cpu").fit(X, y),
        "fused_rounds_fn": lambda: GradientBoostingRegressor(
            max_iter=4, max_depth=3, rounds_per_dispatch=2,
            device="cpu").fit(X, yr),
    }


@pytest.mark.parametrize("entry", list(_fits(np.zeros((2, 2)),
                                             np.zeros(2))))
def test_env_peaks_price_every_engine(data, monkeypatch, entry):
    monkeypatch.setenv(FLOPS, "1e12")
    monkeypatch.setenv(HBM, "100")
    monkeypatch.setenv("MPITREE_TPU_PROFILE", "1")
    X, y = data
    est = _fits(X, y)[entry]()
    comp = est.fit_report_["compute"]
    e = comp["entries"][entry]
    assert e["flops"] > 0 and e["bytes"] > 0
    assert e["optimal_s"] == pytest.approx(
        max(e["flops"] / 1e12, e["bytes"] / 100e9))
    assert e["bound"] in ("compute", "hbm")
    assert e["dispatches"] and e["measured_s"]
    assert e["util_pct"] == pytest.approx(
        100 * e["optimal_s"] * e["dispatches"] / e["measured_s"], abs=0.01)
    assert comp["roofline"] in ("compute", "hbm")
    assert comp["peak"]["source"] == "env"
    assert cost.SWEEP_NOTE in e["note"]


def test_served_model_prices_each_bucket_once(data, monkeypatch):
    monkeypatch.setenv(FLOPS, "1e12")
    monkeypatch.setenv(HBM, "100")
    X, y = data
    rf = RandomForestClassifier(n_estimators=2, max_depth=4, device="cpu",
                                random_state=0).fit(X, y)
    reg = ModelRegistry()
    reg.publish("rf", rf)
    m = reg.get("rf")
    for _ in range(3):
        reg.predict_proba("rf", X[:10])
    e = m.serve_report_["compute"]["entries"]["serving_traverse"]
    assert e["variants"] == len(m.buckets)  # one count a bucket
    assert e["optimal_s"] is not None and e["dispatches"] is None


@pytest.mark.parametrize("staged", [True, False])
def test_margin_cost_equals_a_hand_count(staged):
    """The margin body's count at phase 23's classifier shape: every
    column's blocks read the batch, a staging row group reads the pack
    once (else each descent reads its records and leaf value), the
    output is written once; staged, it moves a small part of what the
    general body's count (:func:`cost.traverse_cost`) charges."""
    kw = dict(n_rows=4_096, n_trees=700, n_steps=6, n_features=54, n_out=7,
              value_bytes=8)
    c = cost.margin_cost(**kw, acc_bytes=8, pack_bytes=952_872,
                         row_groups=18, staged=staged)
    table = 18 * 952_872 if staged else 4_096 * 700 * (7 * 8 + 8)
    assert c == {"flops": float(4_096 * 700 * 6),
                 "bytes": float(4_096 * 54 * 4 * 7 + table
                                + 4_096 * 7 * 8)}
    if staged:
        assert c["bytes"] < cost.traverse_cost(**kw)["bytes"] / 4


def test_tiny_fit_bytes_equal_a_hand_count(monkeypatch):
    """Depth 2 on 200 rows, 3 features, 2 classes: the root's one-slot
    stream launch, then one sorted launch over the 4-slot chunk; each
    swept once; the terminal level launches nothing."""
    monkeypatch.setenv(FLOPS, "1e12")
    monkeypatch.setenv(HBM, "100")
    rng = np.random.default_rng(0)
    X = rng.normal(size=(200, 3)).astype(np.float32)
    y = (X[:, 0] + 0.3 * X[:, 1] > 0).astype(np.int64)
    clf = DecisionTreeClassifier(max_depth=2, refine_depth=None,
                                 max_bins=8, device="cpu").fit(X, y)
    e = clf.fit_report_["compute"]["entries"]["fused_fn"]
    t = clf.tree_
    N, F, C, pw = 200, 3, 2, 16
    B = int(clf.fit_report_["memory"]["inputs"]["bins"])
    slab = F * C * B * 4
    n1 = float(t.n_node_samples[t.depth == 1].sum())
    assert hist_kernel.STREAM_MAX_SLOTS == 2
    root = N * 4 + N * (pw + C * 4) + 1 * slab + 1 * slab
    level1 = (N * 4 + n1 * (pw + C * 4) + 4 * slab + n1 * 4 + 5 * 4
              + 4 * slab)
    assert e["bytes"] == pytest.approx(root + level1)
    assert e["flops"] == pytest.approx((N + n1) * F)


def test_each_fit_joins_its_own_keys_count(data, monkeypatch):
    """Counts are kept per static key: a fit joins its own key's, not
    the latest fit's of the same entry."""
    monkeypatch.setenv(FLOPS, "1e12")
    monkeypatch.setenv(HBM, "100")
    X, y = data

    def fused_bytes(n):
        clf = DecisionTreeClassifier(max_depth=5, refine_depth=None,
                                     device="cpu").fit(X[:n], y[:n])
        return clf.fit_report_["compute"]["entries"]["fused_fn"]

    a, b, again = fused_bytes(3_000), fused_bytes(1_000), fused_bytes(3_000)
    assert a["bytes"] != b["bytes"]
    assert again["bytes"] == a["bytes"] and again["variants"] == 2

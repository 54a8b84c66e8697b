"""The port's evidence-driven ``auto`` policies
(``mpitree_tpu_torch/obs/advisor.py``) against the JAX package's
(``mpitree_tpu/obs/advisor.py``), and the routes that consult them.

- on one synthetic flight store, every ``advise_*`` of both packages
  returns equal dicts: the measured winner and loser, thin history, the
  wrong platform, the noise gate, ``off`` (config and knob), K carried
  over, the nearest shape outvoting foreign workloads, the serving
  kernel's groups (the JAX test grid, ``tests/test_obs_cost.py:187-400``);
- evidence routes the fits, each equal to its static twin field for
  field: a depth-bounded ``"auto"`` tree through the leaf-wise engine at
  ``2**max_depth`` (and to the JAX package's routed tree), the default
  (hybrid) tree's crown, sibling subtraction, ``rounds_per_dispatch``
  (the measured K; a ``"host"`` verdict on the card's platform gives 1),
  and ``resolve_mesh_2d``'s shape on a 2-shard CPU mesh (as JAX's);
- the hard constraints hold: an explicit engine, a feature axis,
  monotonic constraints, per-node sampling and ``task="gbdt"`` are never
  rerouted; ``MPITREE_TPU_POLICY_EVIDENCE=off`` and an unset store record
  no ``advisor_*`` decision.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import mpitree_tpu as J  # noqa: E402
from mpitree_tpu.obs import advisor as jax_advisor  # noqa: E402
from mpitree_tpu.obs import flight as jax_flight  # noqa: E402
from mpitree_tpu.parallel import mesh as jax_mesh  # noqa: E402

import mpitree_tpu_torch as P  # noqa: E402
from mpitree_tpu_torch.boosting import fused_rounds  # noqa: E402
from mpitree_tpu_torch.core import builder  # noqa: E402
from mpitree_tpu_torch.obs import advisor, flight  # noqa: E402
from mpitree_tpu_torch.obs.observer import BuildObserver  # noqa: E402
from mpitree_tpu_torch.parallel import mesh as M  # noqa: E402

SHAPE = {"n_samples": 4000, "n_features": 16, "n_bins": 64}
FIELDS = ("feature", "threshold", "left", "right", "value", "count",
          "n_node_samples", "impurity")
POLICIES = ("hist_subtraction", "engine", "rounds_per_dispatch", "mesh_2d",
            "serving_kernel")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread for this module's fits."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def evidence(tmp_path, monkeypatch):
    """An ambient store (the advisor consults only under RUN_DIR)."""
    monkeypatch.setenv(flight.RUN_DIR_ENV, str(tmp_path))
    monkeypatch.delenv(advisor.POLICY_ENV, raising=False)
    return flight.FlightStore(str(tmp_path))


def _seed(store, section, metric, values, *, platform="cpu", extra=None,
          shape=None):
    for v in values:
        store.append(kind="bench", section=section, platform=platform,
                     metrics={metric: v, **(shape or SHAPE),
                              **(extra or {})})


def _both(policy, store, **kw):
    """The port's and the JAX package's consultation on one store."""
    jstore = jax_flight.FlightStore(store.root)
    got = getattr(advisor, f"advise_{policy}")(store=store, **kw)
    want = getattr(jax_advisor, f"advise_{policy}")(store=jstore, **kw)
    assert got == want, (policy, got, want)
    return got


def test_constants_equal_jax():
    assert (advisor.NEAREST_K, advisor.MARGIN_FLOOR, advisor.SHAPE_KEYS,
            advisor.MIN_HISTORY, advisor.NOISE_Z, advisor.POLICY_ENV) == (
        jax_advisor.NEAREST_K, jax_advisor.MARGIN_FLOOR,
        jax_advisor.SHAPE_KEYS, jax_advisor.MIN_HISTORY,
        jax_advisor.NOISE_Z, jax_advisor.POLICY_ENV)
    for shape in (SHAPE, {"n_samples": 10}, None, {"n_bins": True}):
        for m in (SHAPE, {"n_samples": 4e6, "n_features": 16}, {}):
            assert advisor._shape_distance(m, shape) == \
                jax_advisor._shape_distance(m, shape)
    for vals in ([1.4, 1.4, 1.4], [0.7, 1.5, 0.8, 1.4], [0.0, 0.0, 1.0]):
        assert advisor._noise_gate(vals) == jax_advisor._noise_gate(vals)


def test_winner_and_loser(evidence):
    _seed(evidence, "subtraction_ab", "warm_speedup_on_vs_off",
          [1.38, 1.42, 1.40, 1.45])
    adv = _both("hist_subtraction", evidence, platform="cpu", shape=SHAPE)
    assert adv["value"] == "on" and adv["fallback"] is None
    assert adv["evidence_n"] == 4 and adv["margin"] > adv["gate"]
    _seed(evidence, "mesh2d_ab", "warm_speedup_2d_vs_1d",
          [0.71, 0.69, 0.70, 0.72])
    assert _both("mesh_2d", evidence, platform="cpu",
                 shape=SHAPE)["value"] == "1d"
    _seed(evidence, "leafwise_ab", "warm_speedup_x", [1.5, 1.6, 1.55, 1.5])
    assert _both("engine", evidence, platform="cpu",
                 shape=SHAPE)["value"] == "leafwise"
    _seed(evidence, "leafwise_ab", "warm_speedup_x", [0.6] * 8)
    assert _both("engine", evidence, platform="cpu",
                 shape=SHAPE)["value"] == "levelwise"


def test_thin_history_and_wrong_platform(evidence):
    _seed(evidence, "subtraction_ab", "warm_speedup_on_vs_off", [1.4, 1.4])
    adv = _both("hist_subtraction", evidence, platform="cpu", shape=SHAPE)
    assert adv["value"] is None and adv["fallback"] == "thin_history"
    adv = _both("hist_subtraction", evidence, platform="cuda", shape=SHAPE)
    assert adv["value"] is None and adv["evidence_n"] == 0


def test_noise_gate(evidence):
    _seed(evidence, "subtraction_ab", "warm_speedup_on_vs_off",
          [0.7, 1.5, 0.8, 1.4])
    adv = _both("hist_subtraction", evidence, platform="cpu", shape=SHAPE)
    assert adv["value"] is None and adv["fallback"] == "noise_gate"
    assert adv["gate"] > adv["margin"]


@pytest.mark.parametrize("policy", POLICIES)
def test_off_and_no_store_consult_nothing(evidence, monkeypatch, policy):
    _seed(evidence, "subtraction_ab", "warm_speedup_on_vs_off", [1.4] * 4)
    assert _both(policy, evidence, platform="cpu", shape=SHAPE,
                 policy_evidence="off") is None
    monkeypatch.setenv(advisor.POLICY_ENV, "off")
    assert _both(policy, evidence, platform="cpu", shape=SHAPE) is None
    monkeypatch.delenv(advisor.POLICY_ENV)
    monkeypatch.delenv(flight.RUN_DIR_ENV)
    fn = getattr(advisor, f"advise_{policy}")
    assert fn(platform="cpu", shape=SHAPE) is None


def test_rounds_carry_the_measured_k(evidence):
    _seed(evidence, "gbdt_fusedK", "fit_speedup_x", [2.1, 2.0, 2.2],
          extra={"K": 6})
    adv = _both("rounds_per_dispatch", evidence, platform="cpu", shape=SHAPE)
    assert adv["value"] == "fused" and adv["K"] == 6


def test_serving_kernel_groups(evidence):
    _seed(evidence, "serving", "sustained_rows_per_s",
          [1.0e5, 1.1e5, 1.05e5], extra={"kernel_pallas": 0})
    _seed(evidence, "serving", "sustained_rows_per_s",
          [2.0e5, 2.1e5, 2.05e5], extra={"kernel_pallas": 1})
    adv = _both("serving_kernel", evidence, platform="cpu",
                shape={"n_features": 16})
    assert adv["value"] == "pallas" and adv["median"] == pytest.approx(
        2.0, abs=0.1)


def test_nearest_shape_outvotes_foreign_workloads(evidence):
    far = {"n_samples": 4_000_000, "n_features": 16, "n_bins": 64}
    _seed(evidence, "subtraction_ab", "warm_speedup_on_vs_off", [0.7] * 8,
          shape=far)
    _seed(evidence, "subtraction_ab", "warm_speedup_on_vs_off", [1.4] * 8)
    assert _both("hist_subtraction", evidence, platform="cpu",
                 shape=SHAPE)["value"] == "on"
    assert _both("hist_subtraction", evidence, platform="cpu",
                 shape=far)["value"] == "off"


def test_record_advice_is_a_typed_decision(evidence):
    _seed(evidence, "subtraction_ab", "warm_speedup_on_vs_off", [1.4] * 4)
    adv = advisor.advise_hist_subtraction(platform="cpu", shape=SHAPE)
    obs = BuildObserver(timing=False)
    advisor.record_advice(obs, adv)
    advisor.record_advice(obs, None)
    advisor.record_advice(None, adv)
    d = obs.record.decisions["advisor_hist_subtraction"]
    assert d["value"] == "on" and d["inputs"]["evidence_n"] == 4
    assert d["inputs"]["fallback"] is None
    assert "measured winner" in d["reason"]


# -- routed fits ----------------------------------------------------------------

@pytest.fixture(scope="module")
def small():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(500, 6)).astype(np.float32)
    y = (X[:, 0] + X[:, 1] > 0).astype(np.int64) + (X[:, 2] > 0.5)
    return X, y.astype(np.int64)


FIT_SHAPE = {"n_samples": 500, "n_features": 6}


def _tree(X, y, **kw):
    kw = {"max_depth": 4, "max_bins": 16, "refine_depth": None, **kw}
    return P.DecisionTreeClassifier(device="cpu", **kw).fit(X, y)


def _advice(est) -> dict:
    return {k: v["value"] for k, v in est.fit_report_["decisions"].items()
            if k.startswith("advisor_")}


def _equal(a, b):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(a.tree_, f),
                                      getattr(b.tree_, f), err_msg=f)


@pytest.mark.parametrize("kw", [
    {}, {"max_depth": 8, "refine_depth": 3}, {"criterion": "gini"}],
    ids=["fused", "hybrid", "gini"])
def test_leafwise_evidence_routes_an_equal_tree(evidence, monkeypatch,
                                                small, kw):
    X, y = small
    _seed(evidence, "leafwise_ab", "warm_speedup_x", [1.5, 1.6, 1.55, 1.5],
          shape={**FIT_SHAPE, "max_depth": kw.get("max_depth", 4)})
    routed = _tree(X, y, **kw)
    dec = routed.fit_report_["decisions"]
    assert dec["advisor_engine"]["value"] == "leafwise"
    assert dec["advisor_engine"]["inputs"]["evidence_n"] == 4
    assert dec["frontier"]["value"] == "leafwise"
    crown = (dec.get("refine") or {}).get("value") or 4
    assert dec["frontier"]["inputs"]["max_leaf_nodes"] == 2 ** crown
    monkeypatch.setenv(advisor.POLICY_ENV, "off")
    static = _tree(X, y, **kw)
    assert not _advice(static)
    assert "frontier" not in static.fit_report_["decisions"] or \
        static.fit_report_["decisions"]["frontier"]["value"] != "leafwise"
    _equal(routed, static)
    assert routed.fit_report_["fingerprints"]["fit"] == \
        static.fit_report_["fingerprints"]["fit"]


def test_leafwise_route_equals_the_jax_routed_tree(evidence, small):
    X, y = small
    _seed(evidence, "leafwise_ab", "warm_speedup_x", [1.5, 1.6, 1.55, 1.5],
          shape={**FIT_SHAPE, "max_depth": 4})
    port = _tree(X, y)
    ref = J.DecisionTreeClassifier(max_depth=4, max_bins=16, backend="cpu",
                                   refine_depth=None).fit(X, y)
    assert ref.fit_report_["decisions"]["advisor_engine"]["value"] == \
        port.fit_report_["decisions"]["advisor_engine"]["value"] == \
        "leafwise"
    for f in ("feature", "threshold", "left", "right", "n_node_samples"):
        np.testing.assert_array_equal(getattr(port.tree_, f),
                                      getattr(ref.tree_, f), err_msg=f)


@pytest.mark.parametrize("case", ["engine", "env_engine", "deep",
                                  "monotonic", "sampling", "gbdt",
                                  "feature_axis"])
def test_hard_constraints_are_never_rerouted(evidence, monkeypatch, request,
                                            case):
    from mpitree_tpu_torch.core.builder import BuildConfig

    cfg = BuildConfig(max_depth=4)
    kw = {}
    if case == "engine":
        cfg = BuildConfig(max_depth=4, engine="levelwise")
    elif case == "env_engine":
        monkeypatch.setenv(builder.ENGINE_ENV, "fused")
    elif case == "deep":
        cfg = BuildConfig(max_depth=13)
    elif case == "monotonic":
        kw["mono_cst"] = np.array([1, 0, 0])
    elif case == "sampling":
        kw["feature_sampler"] = type("S", (), {"active": True})()
    elif case == "gbdt":
        cfg = BuildConfig(max_depth=4, task="gbdt")
    else:
        request.getfixturevalue("two_shards")
        kw["mesh"] = M.resolve_mesh(device="cpu", n_devices=(1, 2))
    assert builder.leafwise_reroute_budget(cfg, **kw) is None


def test_reroute_budget_is_the_level_bound():
    from mpitree_tpu_torch.core.builder import BuildConfig

    for d in (1, 4, 12):
        assert builder.leafwise_reroute_budget(
            BuildConfig(max_depth=d)) == 2 ** d
    assert builder.leafwise_reroute_budget(
        BuildConfig(max_depth=4), mono_cst=np.zeros(3)) == 16
    assert builder.leafwise_reroute_budget(BuildConfig()) is None
    assert builder.leafwise_reroute_budget(
        BuildConfig(max_depth=4, max_leaf_nodes=7)) is None
    assert builder.leafwise_reroute_budget(
        BuildConfig(max_depth=4, debug=True)) is None


def test_monotonic_fit_is_not_rerouted(evidence, small):
    X, y = small
    _seed(evidence, "leafwise_ab", "warm_speedup_x", [1.5] * 4,
          shape={**FIT_SHAPE, "max_depth": 4})
    yb = (y > 0).astype(np.int64)
    est = _tree(X, yb, monotonic_cst=[1, 0, 0, 0, 0, 0])
    assert "advisor_engine" not in est.fit_report_["decisions"]
    assert est.fit_report_["decisions"].get(
        "frontier", {}).get("value") != "leafwise"


@pytest.mark.parametrize("values, want", [([1.4] * 4, "on"),
                                          ([0.7] * 4, "off")])
def test_subtraction_evidence_routes_an_equal_tree(evidence, monkeypatch,
                                                   small, values, want):
    X, y = small
    _seed(evidence, "subtraction_ab", "warm_speedup_on_vs_off", values,
          shape={**FIT_SHAPE, "n_bins": 16})
    routed = _tree(X, y)
    dec = routed.fit_report_["decisions"]
    assert dec["advisor_hist_subtraction"]["value"] == want
    assert dec["hist_subtraction"]["value"] == want
    monkeypatch.setenv(advisor.POLICY_ENV, "off")
    static = _tree(X, y)
    assert static.fit_report_["decisions"]["hist_subtraction"]["value"] == \
        ("on" if builder.SUBTRACTION_AUTO["cpu"] else "off")
    _equal(routed, static)
    # an explicit setting is never consulted
    monkeypatch.delenv(advisor.POLICY_ENV)
    obs = BuildObserver(timing=False)
    for flag in ("on", "off"):
        assert builder.resolve_hist_subtraction(
            builder.BuildConfig(hist_subtraction=flag), "cpu",
            obs=obs) is (flag == "on")
    assert not obs.record.decisions
    assert builder.resolve_hist_subtraction(
        builder.BuildConfig(), "cpu", obs=obs,
        shape={**FIT_SHAPE, "n_bins": 16}) is (want == "on")
    assert obs.record.decisions["advisor_hist_subtraction"]["value"] == want


def test_rounds_evidence_routes_the_measured_k(evidence, monkeypatch, small):
    X, y = small
    yr = (X[:, 0] * 2 - X[:, 1]).astype(np.float64)
    _seed(evidence, "gbdt_fusedK", "fit_speedup_x", [2.1, 2.0, 2.2],
          extra={"K": 2}, shape={**FIT_SHAPE, "n_bins": 16})
    kw = dict(max_iter=4, max_depth=3, max_bins=16, device="cpu")
    routed = P.GradientBoostingRegressor(**kw).fit(X, yr)
    dec = routed.fit_report_["decisions"]
    assert dec["advisor_rounds_per_dispatch"]["value"] == "fused"
    assert dec["rounds_per_dispatch"]["value"] == 2
    assert "evidence" in dec["rounds_per_dispatch"]["reason"]
    twin = P.GradientBoostingRegressor(rounds_per_dispatch=2, **kw).fit(
        X, yr)
    assert "advisor_rounds_per_dispatch" not in \
        twin.fit_report_["decisions"]
    for a, b in zip(routed.trees_, twin.trees_):
        for f in ("feature", "threshold", "left", "right", "value"):
            np.testing.assert_array_equal(
                np.asarray(getattr(a, f)), np.asarray(getattr(b, f)))
    np.testing.assert_array_equal(routed.predict(X), twin.predict(X))
    monkeypatch.setenv(advisor.POLICY_ENV, "off")
    static = P.GradientBoostingRegressor(**kw).fit(X, yr)
    assert static.fit_report_["decisions"]["rounds_per_dispatch"][
        "value"] == fused_rounds.ROUNDS_AUTO["cpu"]
    assert not _advice(static)


def test_rounds_host_verdict_and_blockers(evidence):
    kw = dict(device_type="cuda", loss_kind="squared_error", loss_K=1,
              early_stopping=False, colsample=1.0, max_depth=6,
              max_leaf_nodes=None, n_samples=4000, n_features=16, n_bins=64)
    assert fused_rounds.resolve_rounds_per_dispatch("auto", **kw)[0] == \
        fused_rounds.ROUNDS_AUTO["cuda"]
    _seed(evidence, "gbdt_fusedK", "fit_speedup_x", [0.5, 0.52, 0.51],
          platform="cuda", extra={"K": 8})
    obs = BuildObserver(timing=False)
    k, reason = fused_rounds.resolve_rounds_per_dispatch("auto", obs=obs,
                                                         **kw)
    assert k == 1 and "host per-round loop measured faster" in reason
    assert obs.record.decisions["advisor_rounds_per_dispatch"]["value"] \
        == "host"
    # a blocker is checked first: no consultation at all
    obs2 = BuildObserver(timing=False)
    k2, _ = fused_rounds.resolve_rounds_per_dispatch(
        "auto", obs=obs2, **{**kw, "early_stopping": True})
    assert k2 == 1 and not obs2.record.decisions
    # an explicit K is never consulted
    assert fused_rounds.resolve_rounds_per_dispatch(4, obs=obs2, **kw)[0] \
        == 4 and not obs2.record.decisions


@pytest.fixture
def two_shards():
    prev = M.set_cpu_shards(2)
    yield
    M.set_cpu_shards(prev)


def _feature_width(m) -> int:
    return dict(zip(m.axis_names, m.shape)).get(M.FEATURE_AXIS, 1)


@pytest.mark.parametrize("values, want", [([0.7] * 4, 1), ([1.4] * 4, 2)])
def test_mesh_2d_follows_evidence(evidence, two_shards, values, want):
    _seed(evidence, "mesh2d_ab", "warm_speedup_2d_vs_1d", values,
          shape={"n_features": 54, "n_devices": 2})
    obs = BuildObserver(timing=False)
    # the budget alone would split the features (2 shards, a slab over it)
    kw = dict(n_features=54, hist_bytes=4 << 20, hist_budget=3 << 20,
              n_devices=2)
    m = M.resolve_mesh_2d(device="cpu", obs=obs, **kw)
    assert _feature_width(m) == want and m.size == 2
    assert obs.record.decisions["advisor_mesh_2d"]["value"] == \
        {1: "1d", 2: "2d"}[want]
    ref = jax_mesh.resolve_mesh_2d(backend="cpu", **kw)
    shape = tuple(ref.devices.shape)
    assert (shape[1] if len(shape) == 2 else 1) == want
    static = M.resolve_mesh_2d(device="cpu", policy_evidence="off", **kw)
    assert _feature_width(static) == 2
    # an explicit shape bypasses the evidence, as JAX's does
    assert _feature_width(M.resolve_mesh_2d(
        device="cpu", n_features=54, n_devices=(2, 1))) == 1


def test_mesh_2d_one_device_is_not_consulted(evidence):
    _seed(evidence, "mesh2d_ab", "warm_speedup_2d_vs_1d", [1.4] * 4)
    obs = BuildObserver(timing=False)
    M.resolve_mesh_2d(device="cpu", n_features=54, obs=obs)
    assert not obs.record.decisions


def test_off_records_no_advisor_decision(evidence, monkeypatch, small):
    X, y = small
    for section, metric in (("leafwise_ab", "warm_speedup_x"),
                            ("subtraction_ab", "warm_speedup_on_vs_off")):
        _seed(evidence, section, metric, [1.5] * 4,
              shape={**FIT_SHAPE, "max_depth": 4, "n_bins": 16})
    assert set(_advice(_tree(X, y))) >= {"advisor_engine"}
    monkeypatch.setenv(advisor.POLICY_ENV, "off")
    assert not _advice(_tree(X, y))
    assert not _advice(P.GradientBoostingClassifier(
        max_iter=2, max_depth=3, device="cpu").fit(X, (y > 0).astype(int)))
    monkeypatch.delenv(advisor.POLICY_ENV)
    monkeypatch.delenv(flight.RUN_DIR_ENV)
    assert not _advice(_tree(X, y))

"""The port's flight store (``mpitree_tpu_torch/obs/flight.py``) against
the JAX package's (``mpitree_tpu/obs/flight.py``).

- the envelope has the JAX package's keys (the golden of
  ``tests/test_obs_flight.py:85``), platform ``"cpu"`` here, and its
  digest and record the JAX package's keys;
- ``config_digest`` and ``config_digest_from_record`` give the same
  digest in both packages on the same dict (fit and serve records of
  both packages);
- under ``MPITREE_TPU_RUN_DIR`` every estimator's fit appends exactly one
  ``fit`` envelope (a re-report appends nothing), a served model's first
  ``serve_report_`` one ``serve`` envelope; with it unset nothing is
  written and the tree is the same;
- lineage and baseline, the torn line, an unwritable store, and the
  per-lineage rotation with its stand-down, as the JAX package's tests
  hold them (``tests/test_resilience_v2.py:399-475``); the JAX package
  reads the port's store line for line.
"""

from __future__ import annotations

import os
import warnings

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import mpitree_tpu as J  # noqa: E402
from mpitree_tpu.obs import flight as jax_flight  # noqa: E402
from mpitree_tpu.serving import compile_model as jax_compile  # noqa: E402

import mpitree_tpu_torch as P  # noqa: E402
from mpitree_tpu_torch.obs import flight  # noqa: E402
from mpitree_tpu_torch.obs.record import digest  # noqa: E402

RUN_DIR = flight.RUN_DIR_ENV
TREE_FIELDS = ("feature", "threshold", "left", "right", "value", "count",
               "n_node_samples", "impurity")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread for this module's fits (under xdist's parallel
    workers torch's intra-op threads would oversubscribe the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def small():
    rng = np.random.default_rng(7)
    X = rng.standard_normal((1200, 6)).astype(np.float32)
    y = rng.integers(0, 3, 1200).astype(np.int64)
    return X, y


def _port_tree(X, y, **kw):
    kw = {"max_depth": 5, "max_bins": 16, "refine_depth": None, **kw}
    return P.DecisionTreeClassifier(device="cpu", **kw).fit(X, y)


def _jax_tree(X, y, **kw):
    kw = {"max_depth": 5, "max_bins": 16, "refine_depth": None, **kw}
    return J.DecisionTreeClassifier(backend="cpu", **kw).fit(X, y)


@pytest.fixture(scope="module")
def stores(small, tmp_path_factory):
    """One port fit and one JAX fit, each into its own store."""
    X, y = small
    out = {}
    old = os.environ.get(RUN_DIR)
    try:
        for name, fit in (("port", _port_tree), ("jax", _jax_tree)):
            d = tmp_path_factory.mktemp(f"flight_{name}")
            os.environ[RUN_DIR] = str(d)
            fit(X, y)
            out[name] = flight.FlightStore(str(d)).entries()
    finally:
        if old is None:
            os.environ.pop(RUN_DIR, None)
        else:
            os.environ[RUN_DIR] = old
    return out


def test_envelope_keys_equal_jax(stores):
    [p], [j] = stores["port"], stores["jax"]
    golden = ("schema", "ts", "iso", "kind", "section", "git", "platform",
              "mesh_axes", "config_digest", "digest", "metrics", "record")
    assert sorted(p) == sorted(j) == sorted(golden)
    assert p["schema"] == j["schema"] == flight.FLIGHT_SCHEMA == 1
    assert p["kind"] == j["kind"] == "fit"
    assert p["platform"] == j["platform"] == "cpu"
    assert p["record"]["schema"] == j["record"]["schema"] == 9
    assert sorted(p["digest"]) == sorted(j["digest"])
    assert sorted(p["record"]) == sorted(j["record"])
    # both packages built the same tree: the same whole-fit fingerprint
    assert p["digest"]["fingerprint"] == j["digest"]["fingerprint"]
    assert p["digest"] == digest(p["record"])
    # the store is on: span timing ran, so the headline wall is real
    assert p["digest"]["wall_s"] > 0


@pytest.mark.parametrize("side", ["port", "jax"])
@pytest.mark.parametrize("kind", ["fit", "serve"])
def test_config_digest_from_record_equals_jax(stores, side, kind):
    rec = stores[side][0]["record"]
    got = flight.config_digest_from_record(rec, kind=kind)
    assert got == jax_flight.config_digest_from_record(rec, kind=kind)
    assert len(got) == 12


def test_config_digest_of_a_mapping_equals_jax():
    for cfg in ({"section": "north_star"}, {"b": [1, 2], "a": {"z": 1.5}},
                {"workload": None}):
        assert flight.config_digest(cfg) == jax_flight.config_digest(cfg)
    assert flight.LINEAGE_KEYS == jax_flight.LINEAGE_KEYS
    assert flight.KEEP_PER_LINEAGE == jax_flight.KEEP_PER_LINEAGE


def test_serve_envelope_and_its_digest_equal_jax(small, tmp_path,
                                                 monkeypatch):
    """A served model's first ``serve_report_`` appends one ``serve``
    envelope, whose lineage key is the JAX package's on the same record
    (a second read appends nothing)."""
    X, y = small
    clf = _port_tree(X, y)
    monkeypatch.setenv(RUN_DIR, str(tmp_path))
    model = P.compile_model(clf, buckets=(64,))
    model.predict_proba(X[:10])
    rep = model.serve_report_
    model.serve_report_  # noqa: B018 — a re-read appends nothing
    [env] = flight.FlightStore(str(tmp_path)).entries()
    assert env["kind"] == "serve"
    assert env["config_digest"] == jax_flight.config_digest_from_record(
        env["record"], kind="serve")
    assert env["digest"]["fingerprint"] == rep["fingerprints"]["fit"]
    ref = jax_compile(_jax_tree(X, y), buckets=(64,)).serve_report_
    assert sorted(ref["fingerprints"]) == sorted(rep["fingerprints"])


def test_serve_records_of_one_model_and_its_int8_twin_equal_jax(
        small, tmp_path, monkeypatch):
    """The same forest (the JAX package's fit, carried into the port by its
    model file), compiled float and ``quantize="int8"`` in both packages:
    each of the port's serve envelopes has the decision keys of the JAX
    package's envelope for the same model, and the float and int8
    envelopes lie in two lineages in each store, as in the JAX package
    (the serve lineage key reads ``serving_compile``, ``serving_kernel``
    and ``memory.inputs.x64``). With a store, the JAX package also asks
    its advisor which serving tier to take (``advisor_serving_kernel``);
    the port's body follows from the model alone and consults no evidence
    (``obs/advisor.py``), so that record is the one key it lacks."""
    X, y = small
    ref = J.RandomForestClassifier(n_estimators=3, max_depth=4,
                                   random_state=0).fit(X, y)
    J.save_model(ref, tmp_path / "rf")
    est = P.load_model(tmp_path / "rf.npz", device="cpu")
    envs = {}
    for side, compile_, model in (("port", P.compile_model, est),
                                  ("jax", jax_compile, ref)):
        monkeypatch.setenv(RUN_DIR, str(tmp_path / side))
        for q in (None, "int8"):
            compile_(model, quantize=q, quantize_tol=1.0).serve_report_  # noqa: B018
        envs[side] = flight.FlightStore(str(tmp_path / side)).entries()
    for p, j in zip(envs["port"], envs["jax"]):
        assert p["kind"] == j["kind"] == "serve"
        jkeys = set(j["record"]["decisions"])
        assert set(p["record"]["decisions"]) == jkeys - {
            "advisor_serving_kernel"}
        assert "advisor_serving_kernel" in jkeys
        assert p["config_digest"] == flight.config_digest_from_record(
            p["record"], kind="serve")
    for side in ("port", "jax"):
        assert len({e["config_digest"] for e in envs[side]}) == 2, side


ESTIMATORS = {
    "tree": lambda X, y: P.DecisionTreeClassifier(
        max_depth=4, device="cpu").fit(X, y),
    "tree_hybrid": lambda X, y: P.DecisionTreeClassifier(
        max_depth=8, refine_depth=3, device="cpu").fit(X, y),
    "leafwise": lambda X, y: P.DecisionTreeClassifier(
        max_leaf_nodes=9, device="cpu").fit(X, y),
    "regressor": lambda X, y: P.DecisionTreeRegressor(
        max_depth=4, device="cpu").fit(X, y.astype(np.float64)),
    "parallel": lambda X, y: P.ParallelDecisionTreeClassifier(
        max_depth=4, device="cpu").fit(X, y),
    "forest": lambda X, y: P.RandomForestClassifier(
        n_estimators=3, max_depth=4, random_state=0, device="cpu").fit(X, y),
    "extra_trees": lambda X, y: P.ExtraTreesRegressor(
        n_estimators=2, max_depth=4, random_state=0,
        device="cpu").fit(X, y.astype(np.float64)),
    "boosting": lambda X, y: P.GradientBoostingClassifier(
        max_iter=2, max_depth=3, device="cpu").fit(X, y),
    "boosting_fused": lambda X, y: P.GradientBoostingRegressor(
        max_iter=3, max_depth=3, rounds_per_dispatch=2,
        device="cpu").fit(X, y.astype(np.float64)),
    "streamed": lambda X, y: P.DecisionTreeClassifier(
        max_depth=4, device="cpu").fit(
            P.StreamedDataset.from_arrays(X, y, chunk_rows=500)),
}


@pytest.mark.parametrize("name", list(ESTIMATORS))
def test_every_estimator_appends_one_fit_envelope(small, tmp_path,
                                                  monkeypatch, name):
    X, y = small
    monkeypatch.setenv(RUN_DIR, str(tmp_path))
    est = ESTIMATORS[name](X, y)
    est.dump_report(str(tmp_path / "rep.json"))  # a re-report
    [env] = flight.FlightStore(str(tmp_path)).entries()
    assert env["kind"] == "fit" and env["platform"] == "cpu"
    assert env["record"]["result"] == est.fit_report_["result"]
    assert env["config_digest"] == flight.config_digest_from_record(
        est.fit_report_)


def test_unset_store_writes_nothing_and_changes_no_tree(small, tmp_path,
                                                        monkeypatch):
    X, y = small
    for name in (RUN_DIR, "MPITREE_TPU_PROFILE", "MPITREE_TPU_TRACE_DIR"):
        monkeypatch.delenv(name, raising=False)
    plain = _port_tree(X, y)
    assert plain.fit_stats_ is None  # no store, no profile: untimed
    monkeypatch.setenv(RUN_DIR, str(tmp_path / "on"))
    stored = _port_tree(X, y)
    assert stored.fit_stats_ is not None  # the store turns timing on
    for f in TREE_FIELDS:
        np.testing.assert_array_equal(getattr(plain.tree_, f),
                                      getattr(stored.tree_, f), err_msg=f)
    assert plain.fit_report_["fingerprints"] == \
        stored.fit_report_["fingerprints"]
    monkeypatch.delenv(RUN_DIR)
    _port_tree(X, y)
    assert not (tmp_path / "off").exists()
    assert len(flight.FlightStore(str(tmp_path / "on")).entries()) == 1


def test_lineage_and_baseline(small, tmp_path, monkeypatch):
    X, y = small
    monkeypatch.setenv(RUN_DIR, str(tmp_path))
    _port_tree(X, y)
    _port_tree(X, y)
    _port_tree(X, y, max_depth=3)  # another config, another lineage
    store = flight.FlightStore(str(tmp_path))
    a, b, c = store.entries(kind="fit")
    assert a["config_digest"] == b["config_digest"] != c["config_digest"]
    assert store.lineage(b) == [a, b]
    assert store.baseline_for(b) == a
    assert store.baseline_for(a) is None and store.baseline_for(c) is None
    assert store.latest(kind="fit") == c
    assert store.sibling_lineage(b, platform="cuda") == []
    # the JAX package reads the port's store line for line
    assert jax_flight.FlightStore(str(tmp_path)).entries() == [a, b, c]


def test_torn_line_and_unwritable_store(tmp_path):
    store = flight.FlightStore(str(tmp_path))
    store.append(kind="bench", section="s", metrics={"warm_s": 1.0})
    with open(store.path, "a") as f:
        f.write('{"torn": ')  # a kill mid-append
    store.append(kind="bench", section="s", metrics={"warm_s": 2.0})
    assert [r["metrics"]["warm_s"] for r in store.entries(section="s")] \
        == [1.0, 2.0]
    blocked = flight.FlightStore(str(tmp_path / "f"))
    (tmp_path / "f").write_text("a file where the directory should be")
    with pytest.warns(UserWarning, match="flight store unwritable"):
        assert blocked.append(kind="fit", record={}) is None
    with pytest.raises(ValueError, match="no flight run dir"):
        flight.FlightStore(None)


def test_unwritable_ambient_store_never_aborts_a_fit(small, tmp_path,
                                                     monkeypatch):
    X, y = small
    (tmp_path / "f").write_text("not a directory")
    monkeypatch.setenv(RUN_DIR, str(tmp_path / "f"))
    with pytest.warns(UserWarning, match="flight store unwritable"):
        clf = _port_tree(X, y)
    assert clf.fit_report_["result"]["n_nodes"] > 1


def _mini_env(section, i):
    return dict(kind="bench", section=section,
                digest={"wall_s": 1.0 + i / 100}, metrics={}, record=None,
                config={"workload": section}, platform="cpu",
                git="deadbeef")


def test_rotation_keeps_each_lineage_tail(tmp_path, monkeypatch):
    store = flight.FlightStore(str(tmp_path))
    for i in range(30):
        store.append(**_mini_env("alpha", i))
        store.append(**_mini_env("beta", i))
    big = os.path.getsize(store.path)
    monkeypatch.setenv(flight.RUN_MAX_BYTES_ENV, str(big // 4))
    monkeypatch.setenv(flight.RUN_KEEP_ENV, "4")
    store.append(**_mini_env("alpha", 30))
    assert os.path.getsize(store.path) < big // 2
    alpha, beta = store.entries(section="alpha"), store.entries(
        section="beta")
    assert len(alpha) == len(beta) == 4
    assert alpha[-1]["digest"]["wall_s"] == pytest.approx(1.30)
    assert beta[-1]["digest"]["wall_s"] == pytest.approx(1.29)
    assert store.baseline_for(alpha[-1])["digest"] == alpha[-2]["digest"]
    # the JAX package's trim of the same entries keeps the same tail
    assert jax_flight.FlightStore(str(tmp_path)).trim(keep=2) == 4
    assert [e["digest"] for e in store.entries(section="alpha")] == \
        [e["digest"] for e in alpha[-2:]]


def test_rotation_stands_down_when_the_cap_cannot_be_met(tmp_path,
                                                         monkeypatch):
    store = flight.FlightStore(str(tmp_path))
    for i in range(6):
        store.append(**_mini_env(f"sec{i}", 0))
    monkeypatch.setenv(flight.RUN_MAX_BYTES_ENV, "64")
    monkeypatch.setenv(flight.RUN_KEEP_ENV, "4")
    try:
        with pytest.warns(UserWarning, match="rotation stands down"):
            store.append(**_mini_env("sec0", 1))
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            flight.FlightStore(str(tmp_path)).append(**_mini_env("sec1", 1))
        assert len(store.entries()) == 8
        store.trim(keep=1)  # an explicit trim re-arms the rotation
        assert not flight._ROTATION_STUCK
    finally:
        flight._ROTATION_STUCK.clear()


def test_malformed_cap_warns_and_appends(tmp_path, monkeypatch):
    store = flight.FlightStore(str(tmp_path))
    monkeypatch.setenv(flight.RUN_MAX_BYTES_ENV, "not-a-number")
    with pytest.warns(UserWarning, match="malformed"):
        store.append(**_mini_env("a", 0))
    assert len(store.entries(section="a")) == 1

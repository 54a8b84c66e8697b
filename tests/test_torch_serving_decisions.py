"""The port's served models, registry and serving imports against the JAX
package's, on the same fitted models (fitted by the JAX package and carried
into the port through its model file).

- F11: every compile kind (``gather_counts``, ``gather_value``,
  ``forest_proba``, ``forest_mean``, ``margin``, ``forest_values``),
  float and ``quantize="int8"``, records the JAX package's serving
  decision keys, with equal ``serving_compile`` (value and inputs) and
  ``serving_quantize`` values, and ``serving_kernel`` the body its
  launches take (``plain`` on the CPU); ``memory.inputs.x64`` is the JAX
  package's; a float model and its int8 twin land in different serve
  lineages of a flight store, as in the JAX package;
- F12: ``ModelRegistry.publish`` takes a ``CompiledModel`` as it is and
  ``warm=``; ``models()`` equals the JAX package's but for ``warm_s``'s
  value; a quantization refusal leaves the old model serving;
- F13 and F14: ``mpitree_tpu_torch.tree``'s ``BranchType``, ``Node``,
  ``TreeArrays``, the serving re-exports, ``NodeTable.values`` and
  ``QuantizedState.rows_per_tree``/``q_rows_per_tree`` as the JAX
  package's.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import mpitree_tpu as J  # noqa: E402
import mpitree_tpu.serving as jax_serving  # noqa: E402
import mpitree_tpu.tree as jax_tree  # noqa: E402
from mpitree_tpu.serving import ModelRegistry as JaxRegistry  # noqa: E402
from mpitree_tpu.serving import compile_model as jax_compile  # noqa: E402

import mpitree_tpu_torch as P  # noqa: E402
import mpitree_tpu_torch.serving as serving  # noqa: E402
import mpitree_tpu_torch.tree as port_tree  # noqa: E402
from mpitree_tpu_torch.obs import flight  # noqa: E402
from mpitree_tpu_torch.serving import (  # noqa: E402
    ModelRegistry,
    QuantizationError,
    compile_model,
)

TOL = 1.0  # a tolerance no model here exceeds, the same in both packages
# kind -> (estimator, parameters, target)
MODELS = {
    "gather_counts": ("DecisionTreeClassifier", dict(max_depth=4), "cls"),
    "gather_value": ("DecisionTreeRegressor", dict(max_depth=4), "reg"),
    "gather_value_mono": ("DecisionTreeClassifier", dict(
        max_depth=4, monotonic_cst=[1, 0, 0, 0, 0]), "bin"),
    "forest_proba": ("ExtraTreesClassifier", dict(
        n_estimators=3, max_depth=4), "cls"),
    "forest_mean": ("RandomForestRegressor", dict(
        n_estimators=3, max_depth=4), "reg"),
    "forest_values": ("RandomForestClassifier", dict(
        n_estimators=3, max_depth=4, monotonic_cst=[1, 0, 0, 0, 0]), "bin"),
    "margin": ("GradientBoostingClassifier", dict(
        max_iter=3, max_depth=3), "cls"),
    "margin_reg": ("GradientBoostingRegressor", dict(
        max_iter=3, max_depth=3), "reg"),
}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread for this module (under xdist's parallel workers
    torch's intra-op threads would oversubscribe the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(11)
    X = rng.standard_normal((400, 5)).astype(np.float32)
    y = {"cls": rng.integers(0, 3, 400).astype(np.int64),
         "bin": (X[:, 0] + 0.5 * rng.standard_normal(400) > 0).astype(
             np.int64),
         "reg": (2 * X[:, 0] + X[:, 2]
                 + 0.1 * rng.standard_normal(400)).astype(np.float64)}
    return X, y


@pytest.fixture(scope="module")
def models(data, tmp_path_factory):
    """kind -> (the JAX package's fitted estimator, the port's from its
    model file)."""
    X, y = data
    out = {}
    d = tmp_path_factory.mktemp("models")
    for kind, (name, kw, target) in MODELS.items():
        ref = getattr(J, name)(**kw).fit(X, y[target])
        J.save_model(ref, d / kind)
        out[kind] = (ref, P.load_model(d / f"{kind}.npz", device="cpu"))
    return out


def _kind(kind: str) -> str:
    return kind.split("_mono")[0].replace("_reg", "")


@pytest.mark.parametrize("quantize", [None, "int8"])
@pytest.mark.parametrize("kind", list(MODELS))
def test_serving_decisions_equal_jax(models, kind, quantize):
    ref, est = models[kind]
    jm = jax_compile(ref, quantize=quantize, quantize_tol=TOL)
    pm = compile_model(est, quantize=quantize, quantize_tol=TOL)
    assert pm.kind == jm.kind == _kind(kind)
    jrep, prep = jm.serve_report_, pm.serve_report_
    jd, pd = jrep["decisions"], prep["decisions"]
    assert set(pd) == set(jd)
    assert pd["serving_compile"]["value"] == jd["serving_compile"]["value"]
    assert pd["serving_compile"]["inputs"] == jd["serving_compile"]["inputs"]
    if "serving_quantize" in jd:
        jq, pq = jd["serving_quantize"], pd["serving_quantize"]
        assert pq["value"] == jq["value"]
        assert set(pq.get("inputs", {})) == set(jq.get("inputs", {}))
        for k in ("mode", "rows", "tolerance", "ok"):
            assert pq.get("inputs", {}).get(k) == jq.get("inputs", {}).get(k)
    assert pd["serving_kernel"]["value"] == "plain"  # no kernel on the CPU
    assert (prep["memory"]["inputs"]["x64"]
            == jrep["memory"]["inputs"]["x64"])


@pytest.mark.parametrize("form", ["traverse", "traverse_q"])
def test_serving_kernel_names_the_launch_routing_rule(form):
    """``serve_kernel.body_for`` is the rule ``_launch`` routes by and
    the value a compiled model records: the margin body for ``percls``
    over a pack that serves, the general body otherwise, ``plain`` off
    CUDA (host arithmetic, no card needed)."""
    from types import SimpleNamespace

    from mpitree_tpu_torch.serving import serve_kernel

    serves, loses = SimpleNamespace(serves=True), SimpleNamespace(
        serves=False)
    margin = {"traverse": "margin", "traverse_q": "margin_q"}[form]
    cuda = torch.device("cuda")
    assert serve_kernel.body_for(form, "percls", serves, cuda) == margin
    assert serve_kernel.body_for(form, "percls", loses, cuda) == form
    assert serve_kernel.body_for(form, "percls", None, cuda) == form
    assert serve_kernel.body_for(form, "sum", serves, cuda) == form
    assert serve_kernel.body_for(form, "percls", loses, cuda,
                                 _body="margin") == margin
    assert serve_kernel.body_for(form, "percls", serves, "cpu") == "plain"


@pytest.mark.parametrize("kind", ["forest_proba", "margin"])
def test_a_model_and_its_int8_twin_have_their_own_lineage(
        models, kind, tmp_path, monkeypatch):
    ref, est = models[kind]
    monkeypatch.setenv(flight.RUN_DIR_ENV, str(tmp_path / "port"))
    for q in (None, "int8"):
        compile_model(est, quantize=q, quantize_tol=TOL).serve_report_  # noqa: B018
    monkeypatch.setenv(flight.RUN_DIR_ENV, str(tmp_path / "jax"))
    for q in (None, "int8"):
        jax_compile(ref, quantize=q, quantize_tol=TOL).serve_report_  # noqa: B018
    for side in ("port", "jax"):
        envs = flight.FlightStore(str(tmp_path / side)).entries()
        assert [e["kind"] for e in envs] == ["serve", "serve"]
        assert envs[0]["config_digest"] != envs[1]["config_digest"], side


def test_publish_takes_a_compiled_model_without_compiling_or_warming(
        models):
    ref, est = models["forest_proba"]
    reg, jreg = ModelRegistry(), JaxRegistry()
    cm, jcm = compile_model(est), jax_compile(ref)
    assert reg.publish("rf", cm, warm=False) is cm
    jreg.publish("rf", jcm, warm=False)
    assert reg.get("rf") is cm
    rep = cm.serve_report_
    assert rep["counters"].get("serving_dispatches", 0) == 0
    assert rep["requests"] == 0
    mine, theirs = reg.models(), jreg.models()
    assert {k: {f: v for f, v in m.items() if f != "warm_s"}
            for k, m in mine.items()} == {
        k: {f: v for f, v in m.items() if f != "warm_s"}
        for k, m in theirs.items()}
    warm_s = mine["rf"]["warm_s"]
    assert isinstance(warm_s, float) and warm_s == round(warm_s, 3)
    jpub = jcm.serve_report_["decisions"]["registry_publish"]
    pub = rep["decisions"]["registry_publish"]
    assert pub["value"] == jpub["value"] == "rf"
    assert pub["inputs"] == jpub["inputs"] == {"warm": False}
    # an estimator is compiled, and warm=True runs every bucket once
    again = reg.publish("rf", est)
    assert again is not cm and again.kind == "forest_proba"
    assert again.serve_report_["counters"]["serving_dispatches"] == len(
        again.buckets)
    jreg.publish("rf", ref)
    assert reg.models()["rf"]["generation"] == jreg.models()["rf"][
        "generation"] == 2
    np.testing.assert_array_equal(
        reg.predict_proba("rf", np.zeros((3, 5), np.float32)),
        est.predict_proba(np.zeros((3, 5), np.float32)))


def test_a_refused_publish_leaves_the_old_model_serving(models):
    ref, est = models["forest_proba"]
    for registry, model, compiler, refusal in (
            (ModelRegistry(), est, compile_model, QuantizationError),
            (JaxRegistry(), ref, jax_compile,
             jax_serving.QuantizationError)):
        old = registry.publish("rf", compiler(model), warm=False)
        with pytest.raises(refusal):
            registry.publish("rf", model, quantize="int8",
                             quantize_tol=1e-12)
        assert registry.get("rf") is old
        assert registry.models()["rf"]["generation"] == 1


def test_registry_snapshot_counts_publishes_as_jax(models):
    ref, est = models["margin"]
    reg, jreg = ModelRegistry(), JaxRegistry()
    for name in ("a", "b", "a"):
        reg.publish(name, compile_model(est), warm=False)
        jreg.publish(name, jax_compile(ref), warm=False)
    snap, jsnap = reg.metrics.snapshot(), jreg.metrics.snapshot()
    assert set(snap) == set(jsnap)
    key = "mpitree_registry_publish_total"
    assert snap[key] == jsnap[key] == {'{model="a"}': 2.0,
                                       '{model="b"}': 1.0}
    hist = snap["mpitree_registry_warm_seconds"]
    assert set(hist) == set(jsnap["mpitree_registry_warm_seconds"])
    assert [h["count"] for h in hist.values()] == [2, 1]


def test_tree_and_serving_import_surfaces():
    from mpitree_tpu_torch.core import tree_struct
    from mpitree_tpu_torch.serving import tables

    from mpitree_tpu_torch.tree import BranchType, Node, TreeArrays

    assert (BranchType, Node, TreeArrays) == (
        tree_struct.BranchType, tree_struct.Node, tree_struct.TreeArrays)
    assert set(jax_tree.__all__) <= set(port_tree.__all__)
    assert (serving.NodeTable, serving.tables_for, serving.note_serving) == (
        tables.NodeTable, tables.tables_for, tables.note_serving)
    assert set(jax_serving.__all__) - {"resolve_serving_kernel"} <= set(
        serving.__all__)


def test_node_table_values_are_kept_as_jax_keeps_them(models):
    ref, est = models["margin"]
    jm, pm = jax_compile(ref), compile_model(est)
    channel = f"serve:margin:lr={float(est.learning_rate)!r}"

    def unbuilt(_table):
        raise AssertionError("the channel was not kept")

    got, want = pm.table.values(channel, unbuilt), jm.table.values(
        channel, unbuilt)
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    calls = []
    table = pm.table
    for _ in range(2):
        table.values("probe", lambda t: calls.append(t) or np.ones(3))
    assert calls == [table]


@pytest.mark.parametrize("kind", ["forest_proba", "forest_mean", "margin"])
def test_rows_per_tree_equal_jax(models, kind):
    ref, est = models[kind]
    jm = jax_compile(ref, quantize="int8", quantize_tol=TOL)
    pm = compile_model(est, quantize="int8", quantize_tol=TOL)
    jq, pq = jm._quant, pm._quant
    np.testing.assert_array_equal(pq.q_host, jq.q_host)
    np.testing.assert_array_equal(pq.rows_host, jq.rows_host)
    for method in ("rows_per_tree", "q_rows_per_tree"):
        want = getattr(jq, method)(jm.trees, jm.table)
        got = getattr(pq, method)(pm.trees, pm.table)
        assert len(got) == len(want) == len(pm.trees)
        for pt, jt in zip(pm.trees, jm.trees):
            g, w = got[id(pt)], want[id(jt)]
            assert g.dtype == w.dtype and g.shape == (pt.n_nodes, w.shape[1])
            np.testing.assert_array_equal(g, w)

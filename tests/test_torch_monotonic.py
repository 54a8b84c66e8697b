"""``monotonic_cst`` in the port against the JAX package, on the CPU.

The constraint gate is a hard binary on float32 child values, so the port
keeps the JAX package's arithmetic operation for operation
(``utils/monotonic.py``, ``ops/impurity._monotonic_ok``). Where the JAX
package's sums are exact (integer counts; integer-valued regression
targets) the constrained trees are equal field for field, clipped
``value``/``count[:, 0]`` included; with real regression targets the port's
device engine holds the regressor's cross-engine contract against the JAX
device engine (R4 in ``ROADMAP.md``), and the port's two tiers are equal
to each other. The data are the 4-feature sets of ``tests/test_monotonic.py``
and ``covtype_like(8_000)`` made binary (the most frequent class against
the rest, as LIBSVM's ``covtype.binary``).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mpitree_tpu_torch.core.builder import BuildConfig, build_tree  # noqa: E402
from mpitree_tpu_torch.obs import stats_view  # noqa: E402
from mpitree_tpu_torch.core.host_builder import build_tree_host  # noqa: E402
from mpitree_tpu_torch.ops import impurity as pimp  # noqa: E402
from mpitree_tpu_torch.ops.binning import bin_dataset  # noqa: E402
from mpitree_tpu_torch.tree import (  # noqa: E402
    DecisionTreeClassifier,
    DecisionTreeRegressor,
    ExtraTreesRegressor,
    RandomForestClassifier,
    RandomForestRegressor,
)
from mpitree_tpu_torch.utils import monotonic as pmono  # noqa: E402
from mpitree_tpu_torch.utils.carry import tree_from_reference  # noqa: E402
from mpitree_tpu_torch.utils.datasets import covtype_like  # noqa: E402

@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread for this module's fits: under pytest-xdist's
    parallel workers, torch's intra-op threads oversubscribe the cores;
    the trees do not depend on the thread count (exact sums)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


FIELDS = ("feature", "threshold", "left", "right", "parent", "depth",
          "value", "count", "n_node_samples", "impurity")
CST4 = [1, 0, -1, 0]


def _clf_data(n=400, seed=0):
    """``tests/test_monotonic.py:30-37``."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(-2, 2, size=(n, 4)).astype(np.float32)
    y = (X[:, 0] - 0.3 * X[:, 2] + rng.normal(scale=0.8, size=n) > 0
         ).astype(np.int64)
    return X, y


def _reg_data(n=400, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-2, 2, size=(n, 4)).astype(np.float32)
    y = X[:, 0] * 2 + np.sin(X[:, 1]) - 0.5 * X[:, 2] + rng.normal(
        scale=0.4, size=n)
    return X, y


def _int_reg_data(n=400, seed=0):
    """Integer-valued targets whose mean is an integer: the centred float32
    targets are small integers, so every float32 moment sum is exact."""
    X, y = _reg_data(n, seed)
    y = np.round(2 * y)
    y[-1] -= y.sum() % n  # sum divisible by n
    return X, y


def _sweep(X, f, anchor, n=80):
    """``tests/test_monotonic.py:39-44``: one row with feature ``f`` run
    over [-2, 2]."""
    base = np.tile(X[anchor], (n, 1))
    base[:, f] = np.linspace(-2, 2, n).astype(np.float32)
    return base


def _assert_monotone(pred, sign, msg=""):
    d = np.diff(np.asarray(pred, np.float64))
    assert (sign * d >= -1e-6).all(), msg


def _same_tree(got, want, fields=FIELDS, msg=""):
    assert got.n_nodes == want.n_nodes, msg
    for k in fields:
        a, b = getattr(got, k), getattr(want, k)
        assert a.dtype == b.dtype, (msg, k)
        np.testing.assert_array_equal(a, b, err_msg=f"{msg} {k}")


def _jax(name):
    import mpitree_tpu

    return getattr(mpitree_tpu, name)


@pytest.fixture(scope="module")
def cov_binary():
    X, y = covtype_like(8_000, seed=0)
    top = np.bincount(y).argmax()
    return X, (y == top).astype(np.int64)


def _cov_cst(F=54):
    c = np.zeros(F, np.int64)
    c[0], c[5] = 1, -1
    return c


# -- utils/monotonic.py -----------------------------------------------------

@pytest.mark.parametrize("cst,task,n_classes", [
    ([1, 0, -1, 0], "classification", 2),
    ([1, 0, -1, 0], "regression", None),
    ([0, 0, 0, 0], "classification", 2),
    (None, "regression", None),
    ([1, 0], "regression", None),
    ([2, 0, 0, 0], "regression", None),
    ([1, 0, 0, 0], "classification", 3),
], ids=["clf", "reg", "zeros", "none", "shape", "values", "multiclass"])
def test_validate_monotonic_cst_equals_jax(cst, task, n_classes):
    from mpitree_tpu.utils import monotonic as jmono

    kw = dict(task=task, n_classes=n_classes)
    try:
        want = jmono.validate_monotonic_cst(cst, 4, **kw)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            pmono.validate_monotonic_cst(cst, 4, **kw)
        assert str(got.value) == str(e)
        return
    got = pmono.validate_monotonic_cst(cst, 4, **kw)
    if want is None:
        assert got is None
    else:
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_estimators_validate_with_sklearn_messages():
    X, y = _clf_data()
    with pytest.raises(ValueError, match="shape"):
        DecisionTreeClassifier(monotonic_cst=[1, 0], device="cpu").fit(X, y)
    with pytest.raises(ValueError, match="-1, 0 or 1"):
        DecisionTreeRegressor(monotonic_cst=[2, 0, 0, 0],
                              device="cpu").fit(X, y)
    with pytest.raises(ValueError, match="multiclass"):
        RandomForestClassifier(n_estimators=2, monotonic_cst=CST4,
                               device="cpu").fit(X, np.arange(len(X)) % 3)
    a = DecisionTreeClassifier(max_depth=5, device="cpu").fit(X, y)
    b = DecisionTreeClassifier(max_depth=5, monotonic_cst=[0] * 4,
                               device="cpu").fit(X, y)
    _same_tree(b.tree_, a.tree_)


def test_bounds_store_and_clipping_equal_jax():
    """``BoundsStore`` on random splits, and ``tree_bounds``,
    ``clipped_class0`` and ``clip_tree_values`` on JAX-fitted trees."""
    from mpitree_tpu.utils import monotonic as jmono

    rng = np.random.default_rng(3)
    stores = (pmono.BoundsStore(), jmono.BoundsStore())
    n = 1
    for _ in range(40):
        parent = int(rng.integers(0, n))
        vl, vr = rng.normal(size=2).astype(np.float32)
        sign = np.int32(rng.integers(-1, 2))
        for s in stores:
            s.assign_children(np.array([parent]), np.array([n]),
                              np.array([n + 1]), np.array([vl]),
                              np.array([vr]), np.array([sign]), n + 2)
        n += 2
    for a, b in zip(stores[0].window(3, 30, 40), stores[1].window(3, 30, 40)):
        np.testing.assert_array_equal(a, b)

    X, y = _clf_data(seed=2)
    cst = jmono.validate_monotonic_cst(CST4, 4, task="classification",
                                       n_classes=2)
    jt = _jax("DecisionTreeClassifier")(max_depth=7, backend="host").fit(
        X, y).tree_
    pt = tree_from_reference(dataclasses.asdict(jt))
    for a, b in zip(pmono.tree_bounds(pt, cst, "classification"),
                    jmono.tree_bounds(jt, cst, "classification")):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(pmono.clipped_class0(pt, cst),
                                  jmono.clipped_class0(jt, cst))
    pmono.clip_tree_values(pt, cst, "classification")
    jmono.clip_tree_values(jt, cst, "classification")
    np.testing.assert_array_equal(pt.value, jt.value)

    X, y = _reg_data(seed=2)
    cst = np.array([1, 0, -1, 0], np.int8)
    jt = _jax("DecisionTreeRegressor")(max_depth=6, backend="host").fit(
        X, y).tree_
    pt = tree_from_reference(dataclasses.asdict(jt), task="regression")
    pmono.clip_tree_values(pt, cst, "regression")
    jmono.clip_tree_values(jt, cst, "regression")
    np.testing.assert_array_equal(pt.count, jt.count)
    np.testing.assert_array_equal(pt.value, jt.value)


# -- ops/impurity.py --------------------------------------------------------

def _bounds(rng, K):
    lo = np.full(K, -np.inf, np.float32)
    hi = np.full(K, np.inf, np.float32)
    lo[1::3] = rng.uniform(0.0, 0.4, size=len(lo[1::3]))
    hi[2::3] = rng.uniform(0.6, 1.0, size=len(hi[2::3]))
    return lo, hi


@functools.cache
def _jax_sweep(task):
    """The JAX package's sweep, compiled once for the module's shapes."""
    from mpitree_tpu.ops import impurity as jimp

    if task == "classification":
        return jax.jit(functools.partial(jimp.best_split_classification,
                                         exact_ties=True))
    return jax.jit(jimp.best_split_regression)


def _mono_decision(dec):
    return {k: np.asarray(getattr(dec, k)) for k in
            ("feature", "bin", "v_left", "v_right")}


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("route", ["integer", "fixed"])
def test_classification_sweep_gate_equals_jax(seed, route):
    """Integer class counts: the port's sweep (the float32 route, or the
    fixed-point route's int64 form of the same counts) picks JAX's feature
    and bin, and its winners' child values are JAX's bit for bit."""
    rng = np.random.default_rng(seed)
    K, F, B = 9, 4, 16
    h = rng.integers(0, 6, size=(K, F, 2, B)).astype(np.float32)
    h[:, :, :, rng.random(B) < 0.3] = 0
    cand = rng.random((F, B)) < 0.9
    cst = np.array([1, -1, 0, 1], np.int32)
    lo, hi = _bounds(rng, K)
    want = _mono_decision(_jax_sweep("classification")(
        jnp.asarray(h), jnp.asarray(cand), mono_cst=jnp.asarray(cst),
        mono_lo=jnp.asarray(lo), mono_hi=jnp.asarray(hi)))
    kw = dict(mono_cst=torch.from_numpy(cst), mono_lo=torch.from_numpy(lo),
              mono_hi=torch.from_numpy(hi))
    if route == "fixed":
        q = torch.from_numpy(h.astype(np.int64))
        dec = pimp.best_split_classification(
            q, torch.from_numpy(cand), scale_exp=(0, 0), **kw)
    else:
        dec = pimp.best_split_classification(
            torch.from_numpy(h), torch.from_numpy(cand), **kw)
    got = _mono_decision(dec)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["v_left"].dtype == np.float32


@pytest.mark.parametrize("seed", range(3))
def test_regression_sweep_gate_equals_jax(seed):
    """Integer-valued moments: the port's int64 sweep and JAX's float32
    one agree on the winners and their child means, bit for bit."""
    rng = np.random.default_rng(10 + seed)
    K, F, B = 9, 4, 16
    w = rng.integers(0, 4, size=(K, F, B))
    yv = rng.integers(-5, 6, size=(K, F, B))
    h = np.stack([w, w * yv, w * yv * yv], axis=2).astype(np.int64)
    cand = rng.random((F, B)) < 0.9
    cst = np.array([1, 0, -1, 1], np.int32)
    lo = np.full(K, -np.inf, np.float32)
    hi = np.full(K, np.inf, np.float32)
    lo[1::3] = -1.0
    hi[2::3] = 1.5
    want = _mono_decision(_jax_sweep("regression")(
        jnp.asarray(h.astype(np.float32)), jnp.asarray(cand),
        mono_cst=jnp.asarray(cst), mono_lo=jnp.asarray(lo),
        mono_hi=jnp.asarray(hi)))
    got = _mono_decision(pimp.best_split_regression(
        torch.from_numpy(h), torch.from_numpy(cand), scale_exp=(0, 0, 0),
        mono_cst=torch.from_numpy(cst), mono_lo=torch.from_numpy(lo),
        mono_hi=torch.from_numpy(hi)))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_unconstrained_sweep_has_no_child_values():
    h = torch.ones((2, 3, 2, 4))
    dec = pimp.best_split_classification(h, torch.ones((3, 4), dtype=bool))
    assert dec.v_left is None and dec.v_right is None


# -- classification trees ---------------------------------------------------

@pytest.fixture(scope="module")
def jax_clf_trees(cov_binary):
    """JAX ``backend="cpu"`` constrained trees: the 4-feature data at depth
    8, covtype made binary at depth 10."""
    J = _jax("DecisionTreeClassifier")
    X4, y4 = _clf_data()
    Xc, yc = cov_binary
    return {
        "four": (X4, y4, dict(max_depth=8, monotonic_cst=CST4),
                 J(max_depth=8, monotonic_cst=CST4, backend="cpu").fit(
                     X4, y4)),
        "covtype": (Xc, yc, dict(max_depth=10, monotonic_cst=_cov_cst()),
                    J(max_depth=10, monotonic_cst=_cov_cst(),
                      backend="cpu").fit(Xc, yc)),
    }


@pytest.mark.parametrize("data", ["four", "covtype"])
@pytest.mark.parametrize("backend", [None, "host"], ids=["device", "host"])
def test_classifier_equals_jax_field_for_field(jax_clf_trees, data,
                                               backend):
    """Device engine (integer route) and host tier (the C++ gate) against
    JAX ``backend="cpu"``: every field, the clipped labels in ``value``
    included; ``predict`` reads them, ``predict_proba`` the raw counts."""
    X, y, kw, ref = jax_clf_trees[data]
    est = DecisionTreeClassifier(device="cpu", backend=backend, **kw).fit(X, y)
    assert stats_view(est.fit_report_)["engine"] == ("host" if backend else "fused")
    assert "crown_depth" not in stats_view(est.fit_report_)  # no refine tail
    _same_tree(est.tree_, ref.tree_, msg=f"{data}/{backend}")
    np.testing.assert_array_equal(est.predict(X), ref.predict(X))
    np.testing.assert_array_equal(est.predict_proba(X), ref.predict_proba(X))


def test_fractionally_weighted_classifier_equals_jax_host(cov_binary):
    """Fractional weights: the device engine's fixed-point route builds the
    child values from its exact sums cast to float32, the JAX host tier's
    form (F1's contract: field for field)."""
    X, y = cov_binary
    X, y = X[:3_000], y[:3_000]
    w = np.random.default_rng(2).uniform(0.5, 2.0, len(y)).astype(np.float32)
    kw = dict(max_depth=8, monotonic_cst=_cov_cst())
    ref = _jax("DecisionTreeClassifier")(backend="host", **kw).fit(
        X, y, sample_weight=w)
    for backend in (None, "host"):
        est = DecisionTreeClassifier(device="cpu", backend=backend, **kw).fit(
            X, y, sample_weight=w)
        _same_tree(est.tree_, ref.tree_, msg=str(backend))


@pytest.mark.parametrize("backend", [None, "host"], ids=["device", "host"])
def test_classifier_monotone_property(backend):
    """sklearn's property check (``tests/test_monotonic.py:39-49``): along
    each constrained feature, ``predict`` is monotone in its sign."""
    X, y = _clf_data()
    clf = DecisionTreeClassifier(max_depth=8, monotonic_cst=CST4,
                                 backend=backend, device="cpu").fit(X, y)
    for anchor in (3, 11, 40):
        _assert_monotone(clf.predict(_sweep(X, 0, anchor)), 1)
        _assert_monotone(clf.predict(_sweep(X, 2, anchor)), -1)


# -- regression trees -------------------------------------------------------

@pytest.mark.parametrize("engine", ["fused", "levelwise", "host"])
def test_regression_build_tree_equals_jax_engines(engine):
    """``tests/test_monotonic.py:96-128`` with integer-valued float32
    targets: the port's device engine and host tier grow the JAX engines'
    constrained tree, field for field."""
    from mpitree_tpu.core.builder import BuildConfig as JConfig
    from mpitree_tpu.core.builder import build_tree as jbuild
    from mpitree_tpu.core.host_builder import build_tree_host as jhost
    from mpitree_tpu.ops.binning import bin_dataset as jbin
    from mpitree_tpu.parallel import mesh as mesh_lib

    rng = np.random.default_rng(5)
    X = rng.integers(0, 6, size=(200, 4)).astype(np.float32)
    X[:6] = np.arange(6, dtype=np.float32)[:, None]
    y = np.round(X[:, 0] - X[:, 2] + rng.normal(scale=1.0, size=200))
    y32 = y.astype(np.float32)
    cst = np.array([1, 0, -1, 0], np.int8)
    cfg = dict(task="regression", criterion="mse", max_depth=6)
    jb = jbin(X, binning="exact")
    if engine == "host":
        ref = jhost(jb, y32, config=JConfig(**cfg), refit_targets=y,
                    mono_cst=cst)
    else:
        ref = jbuild(jb, y32, config=JConfig(**cfg, engine=engine),
                     mesh=mesh_lib.resolve_mesh(n_devices=1),
                     refit_targets=y, mono_cst=cst)
    pb = bin_dataset(X, binning="exact")
    dev = build_tree(dataclasses.replace(pb, x_binned=torch.from_numpy(
        pb.x_binned)), y32, config=BuildConfig(**cfg), refit_targets=y,
        mono_cst=cst)
    host = build_tree_host(pb, y32, config=BuildConfig(**cfg),
                           refit_targets=y, mono_cst=cst)
    for got in (dev, host):
        _same_tree(got, ref, msg=engine)


@pytest.fixture(scope="module")
def reg_pair():
    X, y = _reg_data(seed=1)
    kw = dict(max_depth=8, monotonic_cst=CST4)
    return X, y, kw, _jax("DecisionTreeRegressor")(backend="cpu", **kw).fit(
        X, y)


def test_regressor_cross_engine_contract_and_tier_identity(reg_pair):
    """Real targets: the port's device engine against the JAX device
    engine by R4's contract (same node count, >= 90% same features, R^2
    within 1e-3); the port's host tier equals its device engine."""
    X, y, kw, ref = reg_pair
    dev = DecisionTreeRegressor(device="cpu", **kw).fit(X, y)
    host = DecisionTreeRegressor(device="cpu", backend="host", **kw).fit(X, y)
    _same_tree(host.tree_, dev.tree_, msg="host vs device")
    assert dev.tree_.n_nodes == ref.tree_.n_nodes
    assert np.mean(dev.tree_.feature == ref.tree_.feature) >= 0.9
    assert abs(dev.score(X, y) - ref.score(X, y)) <= 1e-3
    # count[:, 0] holds the clipped exact means predict returns
    np.testing.assert_array_equal(dev.predict(X),
                                  dev.tree_.count[dev.apply(X), 0])


@pytest.mark.parametrize("backend", [None, "host"], ids=["device", "host"])
@pytest.mark.parametrize("sign", [1, -1])
def test_regressor_monotone_property(backend, sign):
    X, y = _reg_data()
    reg = DecisionTreeRegressor(max_depth=8, monotonic_cst=[sign, 0, 0, 0],
                                backend=backend, device="cpu").fit(X, y)
    for anchor in (3, 7, 20):
        _assert_monotone(reg.predict(_sweep(X, 0, anchor)), sign,
                         f"{backend} sign={sign} anchor={anchor}")


# -- forests ---------------------------------------------------------------

@pytest.mark.parametrize("name,data", [
    ("RandomForestClassifier", "clf"),
    ("RandomForestRegressor", "reg"),
    ("ExtraTreesRegressor", "reg"),
])
def test_constrained_forests_equal_jax_per_tree(name, data):
    """Each tree equal to the JAX forest's (defaults: JAX's host tier, the
    port's device engine; integer-valued regression targets, so JAX's
    float32 moments are exact); a classification forest's
    ``predict_proba`` (the averaged clipped ``[p0, 1 - p0]``) bit for
    bit, and monotone in each constrained feature."""
    X, y = _clf_data(seed=4) if data == "clf" else _int_reg_data(seed=4)
    kw = dict(n_estimators=3, max_depth=6, random_state=0,
              monotonic_cst=CST4)
    ref = _jax(name)(**kw).fit(X, y)
    est = {"RandomForestClassifier": RandomForestClassifier,
           "RandomForestRegressor": RandomForestRegressor,
           "ExtraTreesRegressor": ExtraTreesRegressor}[name](
        device="cpu", **kw).fit(X, y)
    for i, (got, want) in enumerate(zip(est.trees_, ref.trees_, strict=True)):
        _same_tree(got, want, msg=f"{name} tree {i}")
    if data == "clf":
        np.testing.assert_array_equal(est.predict_proba(X),
                                      ref.predict_proba(X))
        for anchor in (3, 11):
            p1 = est.predict_proba(_sweep(X, 0, anchor))[:, 1]
            _assert_monotone(p1, 1)
            _assert_monotone(est.predict_proba(_sweep(X, 2, anchor))[:, 1],
                             -1)
    else:
        np.testing.assert_array_equal(est.predict(X), ref.predict(X))


# -- serving ---------------------------------------------------------------

def test_compiled_constrained_models_serve_as_predict():
    """A constrained tree serves its clipped labels (``gather_value``), a
    constrained forest its averaged clipped fractions (``forest_values``,
    the traversal's ``sum`` mode), both bit for bit as the estimator; the
    int8 forest stays within its exactness report."""
    from mpitree_tpu_torch.serving import compile_model, quantize

    X, y = _clf_data(seed=5)
    clf = DecisionTreeClassifier(max_depth=6, monotonic_cst=CST4,
                                 device="cpu").fit(X, y)
    cm = compile_model(clf)
    assert cm.kind == "gather_value"
    np.testing.assert_array_equal(cm.predict(X), clf.predict(X))
    rf = RandomForestClassifier(n_estimators=4, max_depth=6, random_state=0,
                                monotonic_cst=CST4, device="cpu").fit(X, y)
    cm = compile_model(rf)
    assert cm.kind == "forest_values"
    np.testing.assert_array_equal(cm.predict_proba(X), rf.predict_proba(X))
    np.testing.assert_array_equal(cm.predict(X), rf.predict(X))
    cm8 = compile_model(rf, quantize="int8", quantize_tol=1.0)
    rep = cm8.serve_report_["quantization"]
    cal = quantize.synthesize_calibration(cm8.table, X.shape[1])
    assert rep["ok"]
    assert np.abs(cm8.raw(cal) - cm.raw(cal)).max() <= \
        rep["max_abs_delta"] + 1e-6

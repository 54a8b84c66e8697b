"""The port's leaf-wise (best-first) growth, ``max_leaf_nodes``, on the CPU
against the JAX package (``mpitree_tpu/core/leafwise_builder.py``).

- the priority (``leaf_gain``), the pool pick (``best_leaf_slot`` and its
  numpy twin), ``bfs_new_ids`` and ``_pool_capacity`` equal JAX's;
- identity at the node budget (``tests/test_leafwise.py:187-227``): with
  ``max_leaf_nodes = 2**max_depth`` the port's leaf-wise tree equals its
  level-wise tree field for field, for the classifier in both engines
  (fused, stepped) with subtraction on and off, the regressor and the
  trees of a boosted fit; and each equals JAX's leaf-wise tree field for
  field (classification and boosting: integer or exact sums), the
  regressor by ``ROADMAP.md`` R4's contract (JAX's float32 moments);
- budgets that bind equal JAX's leaf-wise trees field for field: the
  greedy-order oracle (budget 9, ``:129-185``) and ``covtype_like(4_000)``
  at budgets 7 and 31, entropy and gini; the engines equal each other
  (fractional weights, regression, gbdt builds too);
- the gain gates, the validation errors, the expansion count, the leaf
  ids, model files, serving, ``fit_stats_`` and ``MPITREE_TPU_ENGINE``.

JAX runs on one CPU device (``n_devices=1``) on the same seeded inputs.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import mpitree_tpu_torch as P  # noqa: E402
from mpitree_tpu_torch.core import leafwise_builder as plw  # noqa: E402
from mpitree_tpu_torch.obs import stats_view  # noqa: E402
from mpitree_tpu_torch.core.builder import BuildConfig, build_tree  # noqa: E402
from mpitree_tpu_torch.ops import impurity as pimp  # noqa: E402
from mpitree_tpu_torch.ops.binning import bin_dataset  # noqa: E402
from mpitree_tpu_torch.utils.datasets import (  # noqa: E402
    california_like,
    covtype_like,
)

FIELDS = ("feature", "threshold", "left", "right", "parent", "depth",
          "value", "count", "n_node_samples", "impurity")
JAX_FIELDS = ("feature", "threshold", "left", "right", "value",
              "n_node_samples")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread for this module: under pytest-xdist's parallel
    workers torch's intra-op threads oversubscribe the cores; the trees do
    not depend on the thread count (exact sums)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cls_data(n=500, f=8, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f)).astype(np.float32)
    y = ((X[:, 0] + 0.5 * X[:, 1] > 0) ^ (X[:, 2] > 0.7)).astype(np.int64)
    return X, y


def _reg_data(n=500, f=8, seed=1):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f)).astype(np.float32)
    y = (X[:, 0] * 2 + np.sin(X[:, 1])
         + 0.1 * rng.normal(size=n)).astype(np.float64)
    return X, y


def _same_tree(got, want, msg="", fields=FIELDS):
    assert got.n_nodes == want.n_nodes, msg
    for k in fields:
        a, b = getattr(got, k), getattr(want, k)
        np.testing.assert_array_equal(a, b, err_msg=f"{msg} {k}")


def _env(monkeypatch, engine="auto", sub="auto"):
    monkeypatch.setenv("MPITREE_TPU_ENGINE", engine)
    monkeypatch.setenv("MPITREE_TPU_HIST_SUBTRACTION", sub)


# -- the priority, the pick, the renumbering ------------------------------------

def test_best_leaf_slot_equals_jax_and_numpy():
    """The device pick, its numpy twin and JAX's agree on the grids of
    ``tests/test_leafwise.py:89``: the highest gain, ties to the lowest
    node id, ``-inf`` slots closed."""
    import jax.numpy as jnp
    from mpitree_tpu.ops import impurity as jimp

    rng = np.random.default_rng(3)
    for _ in range(50):
        gain = rng.choice([1.0, 2.0, 2.0, 5.5, -np.inf],
                          size=16).astype(np.float32)
        gain[rng.integers(0, 16)] = 5.5
        node = rng.permutation(16).astype(np.int32)
        want = int(jimp.best_leaf_slot(jnp.asarray(gain), jnp.asarray(node)))
        assert int(pimp.best_leaf_slot(torch.from_numpy(gain),
                                       torch.from_numpy(node))) == want
        assert pimp.best_leaf_slot_np(gain, node) == want
        assert jimp.best_leaf_slot_np(gain, node) == want


@pytest.mark.parametrize("task", ["classification", "regression", "gbdt"])
def test_leaf_gain_equals_jax(task):
    from mpitree_tpu.ops import impurity as jimp

    rng = np.random.default_rng(5)
    n = rng.integers(1, 1000, 64).astype(np.float32)
    imp = rng.random(64).astype(np.float32)
    cost = (imp * rng.random(64)).astype(np.float32)
    want = jimp.leaf_gain(n, imp, cost, task=task)
    np.testing.assert_array_equal(pimp.leaf_gain(n, imp, cost, task=task),
                                  want)
    got = pimp.leaf_gain(torch.from_numpy(n), torch.from_numpy(imp),
                         torch.from_numpy(cost), task=task)
    np.testing.assert_array_equal(got.numpy(), want)


def test_bfs_new_ids_and_pool_capacity_equal_jax():
    from mpitree_tpu.core import leafwise_builder as jlw

    left = np.array([1, 5, 3, -1, -1, -1, -1])
    np.testing.assert_array_equal(plw.bfs_new_ids(left),
                                  [0, 1, 2, 5, 6, 3, 4])
    rng = np.random.default_rng(7)
    for _ in range(20):  # random expansion orders
        n_exp = int(rng.integers(1, 40))
        left = np.full(2 * n_exp + 1, -1)
        open_ = [0]
        for e in range(n_exp):
            node = open_.pop(int(rng.integers(0, len(open_))))
            left[node] = 2 * e + 1
            open_ += [2 * e + 1, 2 * e + 2]
        np.testing.assert_array_equal(plw.bfs_new_ids(left),
                                      jlw.bfs_new_ids(left))
    for args in [(255, None, 581_012), (4096, 12, 581_012), (31, 6, 10),
                 (8, 0, 100), (1 << 30, 6, 10**6), (2, 40, 1)]:
        assert plw._pool_capacity(*args) == jlw._pool_capacity(*args), args


# -- identity at the node budget ------------------------------------------------

@pytest.fixture(scope="module")
def cls_identity():
    import mpitree_tpu as J

    X, y = _cls_data()
    base = P.DecisionTreeClassifier(max_depth=4, refine_depth=None,
                                    device="cpu").fit(X, y)
    ref = J.DecisionTreeClassifier(max_depth=4, max_leaf_nodes=16,
                                   backend="cpu", n_devices=1).fit(X, y)
    return X, y, base.tree_, ref.tree_


@pytest.mark.parametrize("engine", ["fused", "levelwise"])
@pytest.mark.parametrize("sub", ["on", "off"])
def test_classifier_identity_at_node_budget(cls_identity, engine, sub,
                                            monkeypatch):
    X, y, base, ref = cls_identity
    _env(monkeypatch, engine, sub)
    lw = P.DecisionTreeClassifier(max_depth=4, max_leaf_nodes=16,
                                  device="cpu").fit(X, y)
    assert stats_view(lw.fit_report_)["engine"] == engine
    assert stats_view(lw.fit_report_)["frontier"] == "leafwise"
    _same_tree(lw.tree_, base, f"{engine}/{sub} vs level-wise")
    _same_tree(lw.tree_, ref, f"{engine}/{sub} vs JAX", JAX_FIELDS)


@pytest.mark.parametrize("engine", ["fused", "levelwise"])
def test_regressor_identity_at_node_budget(engine, monkeypatch):
    import mpitree_tpu as J

    X, y = _reg_data()
    base = P.DecisionTreeRegressor(max_depth=4, refine_depth=None,
                                   device="cpu").fit(X, y).tree_
    _env(monkeypatch, engine, "on" if engine == "fused" else "off")
    lw = P.DecisionTreeRegressor(max_depth=4, max_leaf_nodes=16,
                                 device="cpu").fit(X, y)
    _same_tree(lw.tree_, base, engine)
    # JAX's leaf-wise regressor sums float32 moments: R4's contract
    ref = J.DecisionTreeRegressor(max_depth=4, max_leaf_nodes=16,
                                  backend="cpu", n_devices=1).fit(X, y)
    assert lw.tree_.n_nodes == ref.tree_.n_nodes
    assert np.mean(lw.tree_.feature == ref.tree_.feature) >= 0.9
    assert abs(lw.score(X, y) - ref.score(X, y)) <= 1e-3


@pytest.mark.parametrize("engine", ["fused", "levelwise"])
def test_gbdt_trees_identity_at_node_budget(engine, monkeypatch):
    """The trees of a boosted fit: budget ``2**max_depth`` equals the
    level-wise rounds tree for tree, and JAX's leaf-wise rounds field for
    field (both sum (g, h) exactly on the CPU)."""
    import mpitree_tpu as J

    X, y = _cls_data()
    kw = dict(max_iter=4, max_depth=3, rounds_per_dispatch=1)
    base = P.GradientBoostingClassifier(device="cpu", **kw).fit(X, y)
    _env(monkeypatch, engine)
    lw = P.GradientBoostingClassifier(max_leaf_nodes=8, device="cpu",
                                      **kw).fit(X, y)
    ref = J.GradientBoostingClassifier(max_leaf_nodes=8, n_devices=1,
                                       **kw).fit(X, y)
    assert stats_view(lw.fit_report_)["frontier"] == "leafwise"
    for i, (a, b, c) in enumerate(zip(lw.trees_, base.trees_, ref.trees_)):
        _same_tree(a, b, f"tree {i} vs level-wise")
        _same_tree(a, c, f"tree {i} vs JAX", JAX_FIELDS + ("count",))
    np.testing.assert_array_equal(lw.predict_proba(X), base.predict_proba(X))
    np.testing.assert_array_equal(lw.predict_proba(X), ref.predict_proba(X))


# -- budgets that bind ----------------------------------------------------------

def test_expansion_order_is_greedy_gain_prefix():
    """The budget-9 tree realizes the greedy highest-gain prefix replayed
    over the full best-first tree (``tests/test_leafwise.py:129``), and
    equals JAX's budget-9 tree field for field."""
    import mpitree_tpu as J

    X, y = _cls_data(600, seed=9)
    budget = 9
    full = P.DecisionTreeClassifier(max_depth=6, max_leaf_nodes=64,
                                    device="cpu").fit(X, y).tree_
    small = P.DecisionTreeClassifier(max_depth=6, max_leaf_nodes=budget,
                                     device="cpu").fit(X, y).tree_
    ref = J.DecisionTreeClassifier(max_depth=6, max_leaf_nodes=budget,
                                   backend="cpu", n_devices=1).fit(X, y)
    _same_tree(small, ref.tree_, "budget 9 vs JAX", JAX_FIELDS)
    nns = full.n_node_samples.astype(np.float64)
    imp = full.impurity.astype(np.float64)
    left, right = full.left, full.right
    gain = {i: nns[i] * imp[i] - nns[left[i]] * imp[left[i]]
            - nns[right[i]] * imp[right[i]]
            for i in range(full.n_nodes) if left[i] >= 0}
    open_set, expanded, leaves = {0}, [], 1
    while leaves < budget:
        cand = [i for i in open_set if i in gain]
        if not cand:
            break
        best = max(cand, key=lambda i: (gain[i], -i))
        open_set.remove(best)
        open_set.update((left[best], right[best]))
        expanded.append(best)
        leaves += 1
    assert int((small.left >= 0).sum()) == len(expanded)
    sig = sorted((int(full.feature[i]), int(nns[i])) for i in expanded)
    small_sig = sorted((int(f), int(n)) for f, n in zip(
        small.feature[small.left >= 0],
        small.n_node_samples[small.left >= 0]))
    assert sig == small_sig


@pytest.fixture(scope="module")
def covtype4k():
    return covtype_like(4_000, seed=0)


@pytest.mark.parametrize("budget", [7, 31])
@pytest.mark.parametrize("criterion", ["entropy", "gini"])
def test_binding_budget_equals_jax(covtype4k, budget, criterion):
    import mpitree_tpu as J

    X, y = covtype4k
    kw = dict(max_leaf_nodes=budget, criterion=criterion)
    ref = J.DecisionTreeClassifier(n_devices=1, **kw).fit(X, y)
    got = P.DecisionTreeClassifier(device="cpu", **kw).fit(X, y)
    _same_tree(got.tree_, ref.tree_, "", JAX_FIELDS + (
        "count", "parent", "depth", "impurity"))
    assert got.get_n_leaves() == budget
    assert stats_view(got.fit_report_)["expansions"] == budget - 1


def _engines(X, y, cfg, **kw):
    pb = bin_dataset(X, max_bins=64, binning="quantile")
    pb = dataclasses.replace(pb, x_binned=torch.from_numpy(pb.x_binned))
    return {(eng, sub): build_tree(pb, y, config=dataclasses.replace(
        cfg, engine=eng, hist_subtraction=sub), **kw)
        for eng in ("fused", "levelwise") for sub in ("off", "on")}


@pytest.mark.parametrize("case", ["weights", "regression", "gbdt"])
def test_engines_equal_each_other(case):
    """Both engines, subtraction on and off, the same tree on the
    fixed-point route (fractional weights, regression moments, a boosting
    round's (count, g, h))."""
    rng = np.random.default_rng(11)
    if case == "weights":
        X, y = covtype_like(2_000, seed=1)
        cfg = BuildConfig(max_leaf_nodes=23, min_decrease_scaled=1e-3)
        kw = dict(n_classes=7, sample_weight=rng.uniform(
            0.5, 2, len(y)).astype(np.float32))
    elif case == "regression":
        X, y = california_like(2_000, seed=2)
        y = (y - y.mean()).astype(np.float32)
        cfg = BuildConfig(task="regression", criterion="mse",
                          max_leaf_nodes=23, max_depth=7)
        kw = {}
    else:
        X, y = california_like(2_000, seed=3)
        g = (rng.standard_normal(len(y))).astype(np.float32)
        h = np.where(rng.random(len(y)) < 0.2, 0.0,
                     rng.uniform(0.1, 0.3, len(y))).astype(np.float32)
        y = g
        cfg = BuildConfig(task="gbdt", max_leaf_nodes=23,
                          min_leaf_rows=5.0, min_child_weight=1e-3)
        kw = dict(sample_weight=h)
    trees = _engines(X, y, cfg, **kw)
    base = trees[("levelwise", "off")]
    assert base.n_nodes > 20
    for key, tree in trees.items():
        _same_tree(tree, base, str(key))


def test_subtraction_pool_respects_the_histogram_budget():
    """A pool whose resident histograms exceed ``hist_budget_bytes`` grows
    by direct accumulation: the same tree."""
    X, y = covtype_like(1_500, seed=2)
    pb = bin_dataset(X, max_bins=32, binning="quantile")
    pb = dataclasses.replace(pb, x_binned=torch.from_numpy(pb.x_binned))
    cfg = BuildConfig(max_leaf_nodes=40, hist_subtraction="on")
    fit = plw.FitInputs(pb, y, cfg, n_classes=7)
    assert plw.leafwise_subtraction(fit, cfg, 40)
    tight = dataclasses.replace(cfg, hist_budget_bytes=1024)
    assert not plw.leafwise_subtraction(fit, tight, 40)
    _same_tree(build_tree(pb, y, config=tight, n_classes=7),
               build_tree(pb, y, config=cfg, n_classes=7))


# -- semantics and surface ------------------------------------------------------

def test_gain_gates_stop_before_budget():
    X, y = _cls_data(200)
    m = P.DecisionTreeClassifier(max_leaf_nodes=200,
                                 min_impurity_decrease=0.2,
                                 device="cpu").fit(X, y)
    assert m.get_n_leaves() < 16


def test_budget_restricts_leaves_and_keeps_accuracy():
    X, y = _cls_data(800)
    m = P.DecisionTreeClassifier(max_leaf_nodes=7, max_depth=10,
                                 device="cpu").fit(X, y)
    assert 2 <= m.get_n_leaves() <= 7
    assert m.score(X, y) > 0.8


@pytest.mark.parametrize("kw,match", [
    (dict(max_leaf_nodes=1), "larger than 1"),
    (dict(max_leaf_nodes=4, backend="host"), "device engine"),
    (dict(max_leaf_nodes=4, max_features=2), "feature sampling"),
    (dict(max_leaf_nodes=4, splitter="random"), "feature sampling"),
    (dict(max_leaf_nodes=4, monotonic_cst=[1, 0, 0, 0, 0, 0, 0, 0]),
     "monotonic"),
])
def test_validation_errors(kw, match):
    X, y = _cls_data(100)
    with pytest.raises(ValueError, match=match):
        P.DecisionTreeClassifier(device="cpu", **kw).fit(X, y)


def test_build_tree_refuses_a_budget_below_two():
    X, y = _cls_data(100)
    pb = bin_dataset(X, max_bins=16, binning="quantile")
    pb = dataclasses.replace(pb, x_binned=torch.from_numpy(pb.x_binned))
    with pytest.raises(ValueError, match=">= 2"):
        build_tree(pb, y, config=BuildConfig(max_leaf_nodes=1), n_classes=2)


@pytest.mark.parametrize("engine", ["fused", "levelwise"])
def test_expansions_count(engine, monkeypatch):
    """``tests/test_leafwise.py:305``: 14 expansions grow 15 leaves."""
    X, y = _cls_data(2000, seed=4)
    _env(monkeypatch, engine)
    lw = P.DecisionTreeClassifier(max_depth=8, max_leaf_nodes=15,
                                  device="cpu").fit(X, y)
    assert stats_view(lw.fit_report_)["expansions"] == 14
    assert lw.get_n_leaves() == 15


def test_fused_engine_reads_the_flag_once_per_check():
    X, y = covtype_like(3_000, seed=5)
    before = plw.done_reads
    m = P.DecisionTreeClassifier(max_leaf_nodes=40, device="cpu").fit(X, y)
    assert stats_view(m.fit_report_)["expansions"] == 39
    assert plw.done_reads - before == (39 - 1) // plw.CHECK_EVERY


def test_return_leaf_ids_in_the_finished_tree():
    X, y = covtype_like(2_000, seed=6)
    pb = bin_dataset(X, max_bins=64, binning="quantile")
    pb = dataclasses.replace(pb, x_binned=torch.from_numpy(pb.x_binned))
    for engine in ("fused", "levelwise"):
        tree, ids = build_tree(pb, y, config=BuildConfig(
            max_leaf_nodes=17, engine=engine), n_classes=7,
            return_leaf_ids=True)
        assert ids.shape == (len(y),)
        assert (tree.left[ids] < 0).all()
        np.testing.assert_array_equal(
            np.bincount(ids, minlength=tree.n_nodes)[tree.left < 0],
            tree.n_node_samples[tree.left < 0])
        # the rows' descent of the finished tree lands where they grew
        from mpitree_tpu_torch.ops.predict import predict_leaf_ids

        np.testing.assert_array_equal(
            ids, predict_leaf_ids(X, tree, torch.device("cpu")))


def test_regressor_leaf_values_are_exact_means():
    X, y = california_like(1_500, seed=4)
    m = P.DecisionTreeRegressor(max_leaf_nodes=12, device="cpu").fit(X, y)
    ids = m.apply(X)
    for leaf in np.unique(ids):
        assert m.tree_.count[leaf, 0] == pytest.approx(
            y[ids == leaf].mean(), rel=1e-12, abs=1e-12)


def test_model_file_round_trip(tmp_path):
    """``max_leaf_nodes`` rides in the file; a loaded estimator predicts
    the same and refits with the budget."""
    X, y = covtype_like(1_500, seed=7)
    m = P.DecisionTreeClassifier(max_leaf_nodes=11, device="cpu").fit(X, y)
    path = tmp_path / "lw.npz"
    P.save_model(m, path)
    back = P.load_model(path, device="cpu")
    assert back.max_leaf_nodes == 11
    np.testing.assert_array_equal(back.predict_proba(X), m.predict_proba(X))
    back.fit(X, y)
    _same_tree(back.tree_, m.tree_)


def test_served_tree_equals_predict_proba():
    from mpitree_tpu_torch.serving import compile_model, serve_kernel

    X, y = covtype_like(1_500, seed=8)
    m = P.DecisionTreeClassifier(max_leaf_nodes=25, device="cpu").fit(X, y)
    cm = compile_model(m)
    np.testing.assert_array_equal(cm.predict_proba(X), m.predict_proba(X))
    # the count channel through K4's plain version (``sum``)
    cols = cm.table.dev_arrays(torch.device("cpu"))[:5]
    got = serve_kernel.traverse(
        torch.from_numpy(X), *cols, cm._values.to(torch.float64),
        n_steps=cm.table.n_steps, agg="sum", n_out=7,
        n_features=X.shape[1])
    np.testing.assert_array_equal(got.numpy(),
                                  m.predict_proba(X).astype(np.float64))


def test_engine_env_and_explicit_config(monkeypatch):
    from mpitree_tpu_torch.core.builder import resolve_engine

    X, y = _cls_data(300)
    cfg = BuildConfig(max_leaf_nodes=5)
    assert resolve_engine(cfg) == "fused"
    monkeypatch.setenv("MPITREE_TPU_ENGINE", "levelwise")
    assert resolve_engine(cfg) == "levelwise"
    assert resolve_engine(dataclasses.replace(cfg, engine="fused")) == "fused"
    # the level-by-level gbdt rule does not apply to a leaf budget
    monkeypatch.delenv("MPITREE_TPU_ENGINE")
    gbdt = dataclasses.replace(cfg, task="gbdt")
    assert resolve_engine(gbdt) == "fused"
    assert resolve_engine(dataclasses.replace(gbdt, engine="fused")) == \
        "fused"
    assert resolve_engine(dataclasses.replace(
        gbdt, max_leaf_nodes=None)) == "levelwise"
    with pytest.raises(ValueError, match="engine"):
        resolve_engine(dataclasses.replace(cfg, engine="x"))
    m = P.DecisionTreeClassifier(max_leaf_nodes=5, ccp_alpha=0.01,
                                 device="cpu").fit(X, y)
    assert "crown_depth" not in stats_view(m.fit_report_)  # one engine, no refine tail

"""The port's batched forest (``core/fused_builder.build_forest_fused``)
against per-tree builds and the JAX package's batched forest.

- ``build_forest_fused`` on stacked (T, N) weights and (T, F, B)
  candidate masks equals one ``build_tree`` per tree, field for field;
- the forests at their default engine (``ensemble_path``
  ``"batched-fused"``) equal the per-tree levelwise forests
  (``MPITREE_TPU_ENGINE=levelwise``) and the JAX package's batched forest
  on its CPU device engine (``backend="cpu"``): bagged, ``max_features``
  sqrt, ``ExtraTreesClassifier`` and ``monotonic_cst``, with
  ``predict_proba`` bit for bit; a regression forest and a default forest
  (refine tail below a batched crown) equal their per-tree twins.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from mpitree_tpu_torch.core import builder as pbuilder  # noqa: E402
from mpitree_tpu_torch.obs import stats_view  # noqa: E402
from mpitree_tpu_torch.core.builder import BuildConfig, build_tree  # noqa: E402
from mpitree_tpu_torch.core.fused_builder import build_forest_fused  # noqa: E402
from mpitree_tpu_torch.ops.binning import bin_for_engine  # noqa: E402
from mpitree_tpu_torch.ops.sampling import NodeFeatureSampler  # noqa: E402
from mpitree_tpu_torch.tree import (  # noqa: E402
    ExtraTreesClassifier,
    RandomForestClassifier,
    RandomForestRegressor,
)
from mpitree_tpu_torch.utils.datasets import (  # noqa: E402
    california_like,
    covtype_like,
)

FIELDS = ("feature", "threshold", "left", "right", "parent", "depth",
          "value", "count", "n_node_samples", "impurity")
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread for this module: under pytest-xdist's parallel
    workers torch's intra-op threads oversubscribe the cores; the trees do
    not depend on the thread count (exact sums)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same_tree(got, want, msg=""):
    assert got.n_nodes == want.n_nodes, msg
    for k in FIELDS:
        a, b = getattr(got, k), getattr(want, k)
        assert a.dtype == b.dtype, (msg, k)
        np.testing.assert_array_equal(a, b, err_msg=f"{msg} {k}")


@pytest.fixture(scope="module")
def data():
    return covtype_like(3_000, seed=9)


@pytest.mark.parametrize("task", ["classification", "regression"])
def test_build_forest_fused_equals_per_tree_builds(data, task):
    X, y = data
    rng = np.random.default_rng(3)
    n, F = X.shape
    T = 3
    binned = bin_for_engine(X, max_bins=32, binning="quantile", device=CPU)
    w = rng.multinomial(n, np.full(n, 1.0 / n), size=T).astype(np.float32)
    w[1] *= rng.uniform(0.5, 2.0, n).astype(np.float32)  # fixed-point route
    sub = np.ones((T, F), bool)
    sub[2, ::3] = False
    cand = binned.candidate_mask()[None] & sub[:, :, None]
    samplers = [None, NodeFeatureSampler(k=5, n_features=F, seed=11),
                NodeFeatureSampler(k=F, n_features=F, seed=12,
                                   random_split=True)]
    if task == "classification":
        kw, yy, refit = dict(n_classes=7), y, None
        cfg = BuildConfig(max_depth=8, hist_subtraction="on")
    else:
        yy = X[:, 0].astype(np.float32)
        kw, refit = {}, yy.astype(np.float64)
        cfg = BuildConfig(task="regression", criterion="mse", max_depth=8)
    mcw = [0.0, 3.0, 0.0]
    mid = [0.0, 0.0, 2.0]
    trees, leaf_ids = build_forest_fused(
        binned, yy, config=cfg, weights=w, cand_masks=cand,
        refit_targets=refit, return_leaf_ids=True, min_child_weights=mcw,
        min_decrease_scaleds=mid, samplers=samplers, **kw)
    assert leaf_ids.shape == (T, n)
    for t in range(T):
        tcfg = BuildConfig(**{**cfg.__dict__, "engine": "levelwise",
                              "min_child_weight": mcw[t],
                              "min_decrease_scaled": mid[t]})
        want, ids = build_tree(binned, yy, config=tcfg, sample_weight=w[t],
                               feature_mask=sub[t], feature_sampler=samplers[t],
                               refit_targets=refit, return_leaf_ids=True,
                               **kw)
        _same_tree(trees[t], want, f"tree {t}")
        np.testing.assert_array_equal(leaf_ids[t], ids)


FORESTS = {
    "bagged": (RandomForestClassifier, {}),
    "sqrt": (RandomForestClassifier, dict(max_features="sqrt")),
    "extra": (ExtraTreesClassifier, {}),
    "constrained": (RandomForestClassifier, dict(monotonic_cst="binary")),
}


@pytest.mark.parametrize("name", list(FORESTS))
def test_batched_forest_equals_per_tree_and_jax(data, name, monkeypatch):
    import mpitree_tpu.models.forest as jforest

    X, y = data
    cls, extra = FORESTS[name]
    extra = dict(extra)
    if extra.get("monotonic_cst") == "binary":
        y = (y == 1).astype(np.int64)
        cst = np.zeros(X.shape[1], np.int8)
        cst[0], cst[5] = 1, -1
        extra["monotonic_cst"] = cst
    kw = dict(n_estimators=4, max_depth=8, max_bins=32, random_state=0,
              refine_depth=None, **extra)
    ref = getattr(jforest, cls.__name__)(backend="cpu", **kw).fit(X, y)
    monkeypatch.delenv(pbuilder.ENGINE_ENV, raising=False)
    batched = cls(device="cpu", **kw).fit(X, y)
    monkeypatch.setenv(pbuilder.ENGINE_ENV, "levelwise")
    per_tree = cls(device="cpu", **kw).fit(X, y)
    assert stats_view(batched.fit_report_)["ensemble_path"] == "batched-fused"
    assert stats_view(per_tree.fit_report_)["ensemble_path"] == "per-tree"
    assert (stats_view(batched.fit_report_)["engine"], stats_view(per_tree.fit_report_)["engine"]) \
        == ("fused", "levelwise")
    for i, (a, b, c) in enumerate(zip(batched.trees_, per_tree.trees_,
                                      ref.trees_)):
        _same_tree(a, b, f"{name} tree {i} vs per-tree")
        _same_tree(a, c, f"{name} tree {i} vs JAX")
    Xq = X[:500]
    p = batched.predict_proba(Xq)
    np.testing.assert_array_equal(p, per_tree.predict_proba(Xq))
    np.testing.assert_array_equal(p, ref.predict_proba(Xq))


def test_batched_regression_and_default_forests_equal_per_tree(
        data, monkeypatch):
    Xc, yc = california_like(3_000, seed=4)
    X, y = data
    cases = [
        (RandomForestRegressor, Xc, yc,
         dict(n_estimators=3, max_depth=8, random_state=1,
              refine_depth=None)),
        # default refine: the tail grows below a batched depth-1 crown
        (RandomForestClassifier, X, y,
         dict(n_estimators=3, max_depth=9, max_bins=32, random_state=2)),
    ]
    for cls, Xa, ya, kw in cases:
        monkeypatch.delenv(pbuilder.ENGINE_ENV, raising=False)
        batched = cls(device="cpu", **kw).fit(Xa, ya)
        monkeypatch.setenv(pbuilder.ENGINE_ENV, "levelwise")
        per_tree = cls(device="cpu", **kw).fit(Xa, ya)
        for i, (a, b) in enumerate(zip(batched.trees_, per_tree.trees_)):
            _same_tree(a, b, f"{cls.__name__} tree {i}")
        np.testing.assert_array_equal(batched.predict(Xa[:300]),
                                      per_tree.predict(Xa[:300]))
    assert stats_view(batched.fit_report_)["refine_nodes_added"] > 0

"""The port's cost-complexity pruning (``ccp_alpha``) against the JAX
package's.

``utils/pruning.py`` works on the finished ``TreeArrays``, after the
refine tail, so pruned trees and pruning paths must equal the JAX
package's exactly: on the same tree (the functions alone), and through the
estimators at default settings, refine tail engaged, on the same seeded
inputs.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")

from mpitree_tpu_torch.core.tree_struct import TreeArrays  # noqa: E402
from mpitree_tpu_torch.tree import (  # noqa: E402
    DecisionTreeClassifier,
    RandomForestClassifier,
)
from mpitree_tpu_torch.utils.datasets import covtype_like  # noqa: E402
from mpitree_tpu_torch.utils.pruning import (  # noqa: E402
    Bunch,
    ccp_prune,
    pruning_path,
)

FIELDS = ("feature", "threshold", "left", "right", "parent", "depth",
          "value", "count", "n_node_samples", "impurity")


def assert_same_tree(got, want):
    assert got.n_nodes == want.n_nodes
    for k in FIELDS:
        a, b = getattr(got, k), getattr(want, k)
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)


@pytest.fixture(scope="module")
def trees():
    """JAX-fitted trees to prune: unweighted and fractionally weighted."""
    from mpitree_tpu.tree import DecisionTreeClassifier as JaxTree

    X, y = covtype_like(6_000, seed=31)
    w = (np.random.default_rng(2).random(len(y)) + 0.5).astype(np.float32)
    return {
        "unweighted": JaxTree(max_depth=10, backend="cpu").fit(X, y).tree_,
        "fractional": JaxTree(max_depth=8, backend="cpu").fit(
            X, y, sample_weight=w).tree_,
    }


def _port(tree) -> TreeArrays:
    return TreeArrays(**dataclasses.asdict(tree))


@pytest.mark.parametrize("kind", ["unweighted", "fractional"])
@pytest.mark.parametrize("step", [0.05, 0.3, 0.7, 0.95, 1.0])
def test_ccp_prune_identical_to_jax(trees, kind, step):
    """At alphas taken from the tree's own path (exactly at a step, where
    the weakest links tie with ``ccp_alpha``)."""
    from mpitree_tpu.utils.pruning import ccp_prune as jax_prune
    from mpitree_tpu.utils.pruning import pruning_path as jax_path

    tree = trees[kind]
    alphas = jax_path(tree, task="classification")[0]
    alpha = float(alphas[1 + int(step * (len(alphas) - 2))])
    ours = ccp_prune(_port(tree), alpha)
    assert_same_tree(ours, jax_prune(tree, alpha, task="classification"))
    assert ours.n_nodes < tree.n_nodes


@pytest.mark.parametrize("kind", ["unweighted", "fractional"])
def test_pruning_path_identical_to_jax(trees, kind):
    from mpitree_tpu.utils.pruning import pruning_path as jax_path

    alphas, imps = pruning_path(_port(trees[kind]))
    ja, ji = jax_path(trees[kind], task="classification")
    np.testing.assert_array_equal(alphas, ja)
    np.testing.assert_array_equal(imps, ji)
    assert (np.diff(alphas) > 0).all() and len(alphas) > 10


def test_zero_negative_and_single_leaf(trees):
    tree = _port(trees["unweighted"])
    assert ccp_prune(tree, 0.0) is tree
    with pytest.raises(ValueError, match="ccp_alpha"):
        ccp_prune(tree, -0.1)
    leaf = ccp_prune(tree, np.inf)
    assert leaf.n_nodes == 1 and leaf.feature[0] == -1
    assert np.isnan(leaf.threshold[0])
    assert ccp_prune(leaf, 1.0) is leaf


@pytest.mark.parametrize("alpha", [2e-4, 1e-3, 5e-3])
def test_classifier_ccp_alpha_identical_to_jax(alpha):
    """Defaults (refine tail engaged, then pruning) in both packages."""
    from mpitree_tpu.tree import DecisionTreeClassifier as JaxTree

    X, y = covtype_like(12_000, seed=32)
    ref = JaxTree(max_depth=14, ccp_alpha=alpha, backend="cpu").fit(X, y)
    ours = DecisionTreeClassifier(max_depth=14, ccp_alpha=alpha,
                                  device="cpu").fit(X, y)
    assert_same_tree(ours.tree_, ref.tree_)
    assert ours.get_n_leaves() == ref.get_n_leaves()


def test_host_backend_ccp_alpha_identical_to_jax():
    from mpitree_tpu.tree import DecisionTreeClassifier as JaxTree

    X, y = covtype_like(6_000, seed=33)
    kw = dict(max_depth=10, ccp_alpha=1e-3, backend="host")
    ref = JaxTree(**kw).fit(X, y)
    ours = DecisionTreeClassifier(device="cpu", **kw).fit(X, y)
    assert_same_tree(ours.tree_, ref.tree_)


def test_cost_complexity_pruning_path_identical_to_jax():
    from mpitree_tpu.tree import DecisionTreeClassifier as JaxTree

    X, y = covtype_like(8_000, seed=34)
    w = np.random.default_rng(4).integers(1, 4, size=len(y)).astype(
        np.float32)
    ref = JaxTree(max_depth=12, ccp_alpha=0.01, backend="cpu")
    est = DecisionTreeClassifier(max_depth=12, ccp_alpha=0.01, device="cpu")
    jp = ref.cost_complexity_pruning_path(X, y, sample_weight=w)
    path = est.cost_complexity_pruning_path(X, y, sample_weight=w)
    assert isinstance(path, Bunch) and set(path) == {"ccp_alphas",
                                                     "impurities"}
    assert path.ccp_alphas is path["ccp_alphas"]
    np.testing.assert_array_equal(path.ccp_alphas, jp.ccp_alphas)
    np.testing.assert_array_equal(path.impurities, jp.impurities)
    assert est.ccp_alpha == 0.01 and not hasattr(est, "tree_")
    with pytest.raises(AttributeError):
        path.nope  # noqa: B018


def test_path_alphas_step_the_pruned_tree():
    """Refit just above each path alpha: the leaf count falls step by step
    to one leaf at the last alpha (sklearn's path semantics)."""
    X, y = covtype_like(3_000, seed=35)
    kw = dict(max_depth=6, backend="host", device="cpu")
    path = DecisionTreeClassifier(**kw).cost_complexity_pruning_path(X, y)
    alphas = path.ccp_alphas[1:]
    picks = alphas[np.linspace(0, len(alphas) - 1, 6).astype(int)]
    leaves = [
        DecisionTreeClassifier(ccp_alpha=float(a) * (1 + 1e-9),
                               **kw).fit(X, y).get_n_leaves()
        for a in picks
    ]
    assert leaves == sorted(leaves, reverse=True) and leaves[-1] == 1
    full = DecisionTreeClassifier(**kw).fit(X, y)
    assert full.get_n_leaves() > leaves[0]


def test_forest_ccp_alpha_identical_to_jax():
    from mpitree_tpu.tree import RandomForestClassifier as JaxForest

    X, y = covtype_like(8_000, seed=36)
    kw = dict(n_estimators=3, max_depth=12, random_state=2, ccp_alpha=1e-3)
    ref = JaxForest(backend="cpu", **kw).fit(X, y)
    ours = RandomForestClassifier(device="cpu", **kw).fit(X, y)
    for a, b in zip(ours.trees_, ref.trees_, strict=True):
        assert_same_tree(a, b)
    Xh, _ = covtype_like(2_000, seed=37)
    np.testing.assert_array_equal(ours.predict_proba(Xh),
                                  ref.predict_proba(Xh))

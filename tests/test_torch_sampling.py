"""The port's feature sampling and random splits against the JAX package.

- ``ops/sampling.py``: ``pcg_hash``, ``NodeFeatureSampler`` (root and child
  keys, node masks and draws, ``keys_for_tree``) and ``KeyStore`` are
  uint32 arithmetic and must equal the JAX package's bit for bit, over
  seeded keys; ``sampler_for``/``n_subspace_features`` read sklearn's
  ``max_features`` grammar as it does.
- ``ops/impurity.py``: ``_drawn_bins`` and the masked (``node_mask``) and
  drawn (``forced_draw``) sweeps against ``mpitree_tpu.ops.impurity`` on
  seeded histograms, on the integer route (float32 counts) and on the
  fixed-point route (int64 sums of weights in {1, 1.5, 2}, so every
  non-empty side weighs at least 1 and the JAX package's float32 sums are
  exact too): the same winning feature, bin and left weight.
- trees: ``DecisionTreeClassifier`` and ``DecisionTreeRegressor`` with
  ``max_features="sqrt"`` and ``splitter="random"`` on the CPU equal the
  JAX package's field for field, at ``backend="host"`` and at the
  defaults (crown on the device engine, tail on the host; the JAX default
  at these sizes is its host tier), with ``feature_importances_``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from mpitree_tpu_torch.ops import hist_kernel  # noqa: E402
from mpitree_tpu_torch.obs import stats_view  # noqa: E402
from mpitree_tpu_torch.ops import histogram as ph  # noqa: E402
from mpitree_tpu_torch.ops import impurity as pimp  # noqa: E402
from mpitree_tpu_torch.ops import sampling as psamp  # noqa: E402
from mpitree_tpu_torch.tree import (  # noqa: E402
    DecisionTreeClassifier,
    DecisionTreeRegressor,
)
from mpitree_tpu_torch.utils.datasets import (  # noqa: E402
    california_like,
    covtype_like,
)

FIELDS = ("feature", "threshold", "left", "right", "parent", "depth",
          "value", "count", "n_node_samples", "impurity")


def _same_tree(got, want):
    assert got.n_nodes == want.n_nodes
    for k in FIELDS:
        a, b = getattr(got, k), getattr(want, k)
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)


def _keys(seed, n=257):
    return np.random.default_rng(seed).integers(
        0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)


# -- ops/sampling.py ------------------------------------------------------

@pytest.mark.parametrize("seed", range(3))
def test_pcg_hash_bit_identical(seed):
    from mpitree_tpu.ops import sampling as jsamp

    k = _keys(seed, 4096)
    got, want = psamp.pcg_hash(k), jsamp.pcg_hash(k)
    assert got.dtype == want.dtype == np.uint32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k,F,random_split", [
    (7, 54, False), (1, 8, True), (8, 8, True), (3, 10, False),
])
def test_sampler_masks_draws_and_keys_bit_identical(k, F, random_split):
    from mpitree_tpu.ops import sampling as jsamp

    kw = dict(k=k, n_features=F, seed=123456789, random_split=random_split)
    p, j = psamp.NodeFeatureSampler(**kw), jsamp.NodeFeatureSampler(**kw)
    assert p.active == j.active
    assert p.root_key() == j.root_key()
    keys = _keys(F)
    pm, jm = p.node_masks(keys), j.node_masks(keys)
    np.testing.assert_array_equal(pm, jm)
    assert (pm.sum(axis=1) == min(k, F)).all()
    np.testing.assert_array_equal(p.node_draws(keys), j.node_draws(keys))
    for a, b in zip(p.child_keys(keys), j.child_keys(keys)):
        np.testing.assert_array_equal(a, b)
    sub = dict(kw, root_key_value=int(keys[5]))
    assert psamp.NodeFeatureSampler(**sub).root_key() == \
        jsamp.NodeFeatureSampler(**sub).root_key() == keys[5]


def test_key_store_and_keys_for_tree_bit_identical():
    from mpitree_tpu.ops import sampling as jsamp
    from mpitree_tpu.tree import DecisionTreeClassifier as JaxTree

    X, y = covtype_like(2_000, seed=3)
    tree = JaxTree(max_depth=6, max_features="sqrt", random_state=4,
                   backend="host").fit(X, y).tree_
    kw = dict(k=7, n_features=54, seed=99)
    p, j = psamp.NodeFeatureSampler(**kw), jsamp.NodeFeatureSampler(**kw)
    np.testing.assert_array_equal(p.keys_for_tree(tree),
                                  j.keys_for_tree(tree))
    roots = _keys(11, 5)
    for stores in ((p.key_store(), j.key_store()),
                   (p.key_store(roots), j.key_store(roots))):
        ps, js = stores
        # children past the store's capacity, as a wide level has
        parents = np.arange(5)
        lefts = 300 + 2 * parents
        ps.assign_children(parents, lefts, lefts + 1, 310)
        js.assign_children(parents, lefts, lefts + 1, 310)
        np.testing.assert_array_equal(ps.keys, js.keys)
        np.testing.assert_array_equal(ps.slice(0, 310), js.slice(0, 310))
        np.testing.assert_array_equal(ps.masks(300, 310), js.masks(300, 310))
        np.testing.assert_array_equal(ps.draws(300, 310), js.draws(300, 310))


@pytest.mark.parametrize("mf", [None, "sqrt", "log2", 0.3, 1.0, 5, 54])
def test_max_features_grammar_as_jax(mf):
    from mpitree_tpu.ops import sampling as jsamp

    assert psamp.n_subspace_features(mf, 54) == \
        jsamp.n_subspace_features(mf, 54)
    for splitter in ("best", "random"):
        p = psamp.sampler_for(mf, 7, 54, splitter=splitter)
        j = jsamp.sampler_for(mf, 7, 54, splitter=splitter)
        assert (p is None) == (j is None)
        if p is not None:
            assert (p.k, p.seed, p.random_split) == (j.k, j.seed,
                                                     j.random_split)


@pytest.mark.parametrize("bad", ["cbrt", 0.0, 1.5, 0, 55])
def test_max_features_and_splitter_refusals(bad):
    with pytest.raises(ValueError, match="max_features"):
        psamp.n_subspace_features(bad, 54)
    with pytest.raises(ValueError, match="splitter"):
        psamp.sampler_for(None, 0, 54, splitter="best-first")
    with pytest.raises(ValueError, match="random_state"):
        psamp.seed_from("seed")
    assert psamp.seed_from(None) == 0
    assert psamp.seed_from(np.random.default_rng(1)) == \
        int(np.random.default_rng(1).integers(2**32))


# -- ops/impurity.py ------------------------------------------------------

def _hist(seed, K=6, F=5, C=3, B=12, rows=400, weights=None):
    rng = np.random.default_rng(seed)
    used = np.flatnonzero(rng.random(B) < 0.75)
    xb = rng.choice(used, size=(rows, F))
    y = rng.integers(0, C, size=rows)
    node = rng.integers(0, K, size=rows)
    xb[node == K - 1] = used[0]  # a constant node
    w = np.ones(rows) if weights is None else rng.choice(weights, rows)
    h = np.zeros((K, F, C, B), np.float32)
    for f in range(F):
        np.add.at(h, (node, f, y, xb[:, f]), w)
    cand = rng.random((F, B)) < 0.9
    cand[:, -1] = False
    return h, cand, (xb, y, node, w)


def _mask_draw(seed, K, F):
    rng = np.random.default_rng(100 + seed)
    nmask = rng.random((K, F)) < 0.5
    nmask[0] = False  # a node whose sample admits no split
    draws = rng.integers(0, 2**32, size=(K, F), dtype=np.uint64).astype(
        np.uint32)
    return nmask, draws


@pytest.mark.parametrize("seed", range(4))
def test_drawn_bins_bit_identical(seed):
    from mpitree_tpu.ops import impurity as jimp

    rng = np.random.default_rng(seed)
    valid = rng.random((9, 6, 33)) < [0.0, 0.02, 0.3, 0.6, 0.9, 1.0][seed]
    draw = rng.integers(0, 2**32, size=(9, 6), dtype=np.uint64).astype(
        np.uint32)
    got = pimp._drawn_bins(torch.from_numpy(valid),
                           torch.from_numpy(draw.astype(np.int64)))
    want = np.asarray(jimp._drawn_bins(jnp.asarray(valid),
                                       jnp.asarray(draw)))
    np.testing.assert_array_equal(got.numpy(), want)
    picked = np.take_along_axis(valid, got.numpy()[:, :, None], 2)[:, :, 0]
    assert (picked | ~valid.any(axis=2)).all()


def _decision(dec):
    return {k: np.asarray(getattr(dec, k)) for k in
            ("feature", "bin", "n_left", "constant")}


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("criterion", ["entropy", "gini"])
@pytest.mark.parametrize("draw", [False, True], ids=["masked", "drawn"])
def test_class_sweep_masked_and_drawn_matches_jax(seed, criterion, draw):
    from mpitree_tpu.ops import impurity as jimp

    h, cand, _ = _hist(seed)
    nmask, draws = _mask_draw(seed, h.shape[0], h.shape[1])
    kw = dict(criterion=criterion, min_child_weight=3.0, exact_ties=True)
    want = _decision(jimp.best_split_classification(
        jnp.asarray(h), jnp.asarray(cand), node_mask=jnp.asarray(nmask),
        forced_draw=jnp.asarray(draws) if draw else None, **kw))
    got = _decision(pimp.best_split_classification(
        torch.from_numpy(h), torch.from_numpy(cand),
        node_mask=torch.from_numpy(nmask),
        forced_draw=torch.from_numpy(draws.astype(np.int64)) if draw
        else None, **kw))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("task", ["classification", "regression"])
@pytest.mark.parametrize("draw", [False, True], ids=["masked", "drawn"])
def test_fixed_route_sweeps_masked_and_drawn_match_jax(task, draw):
    """The int64 fixed-point histogram of weights in {1, 1.5, 2}: the
    port's sweep on it equals the JAX package's on the float32 histogram
    of the same (exactly summed) values."""
    from mpitree_tpu.ops import impurity as jimp

    K, F, B, C = 6, 5, 12, 3
    _, cand, (xb, y, node, w) = _hist(7, K=K, F=F, C=C, B=B,
                                       weights=[1.0, 1.5, 2.0])
    nmask, draws = _mask_draw(7, K, F)
    xb_t = torch.from_numpy(xb.astype(np.int32))
    w_t = torch.from_numpy(w.astype(np.float32))
    if task == "regression":
        yv = torch.from_numpy((y - 1).astype(np.float32))
        payload = ph.moment_payload(yv, w_t).contiguous()
    else:
        payload = ph.class_payload(torch.from_numpy(y), w_t, C).contiguous()
    se = hist_kernel.fixed_point_exponents(payload)
    q = hist_kernel.histogram_reference(
        xb_t, payload, torch.from_numpy(node.astype(np.int32)), n_slots=K,
        n_bins=B, scale_exp=se)
    h32 = jnp.asarray(hist_kernel.dequantize(q, se, dim=2).float().numpy())
    dkw = dict(node_mask=torch.from_numpy(nmask),
               forced_draw=torch.from_numpy(draws.astype(np.int64))
               if draw else None, min_child_weight=2.0)
    jkw = dict(node_mask=jnp.asarray(nmask),
               forced_draw=jnp.asarray(draws) if draw else None,
               min_child_weight=2.0)
    if task == "regression":
        got = pimp.best_split_regression(q, torch.from_numpy(cand),
                                         scale_exp=se, **dkw)
        want = jimp.best_split_regression(h32, jnp.asarray(cand), **jkw)
    else:
        got = pimp.best_split_classification(
            q, torch.from_numpy(cand), scale_exp=se, **dkw)
        want = jimp.best_split_classification(
            h32, jnp.asarray(cand), exact_ties=True, **jkw)
    got, want = _decision(got), _decision(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# -- trees ----------------------------------------------------------------

CASES = [
    dict(max_features="sqrt"),
    dict(splitter="random"),
    dict(max_features=0.5, splitter="random"),
]
IDS = ["sqrt", "random", "half-random"]


@pytest.fixture(scope="module")
def cls_data():
    return covtype_like(2_000, seed=6)


@pytest.fixture(scope="module")
def reg_data():
    return california_like(3_000, seed=6)


@pytest.mark.parametrize("kw", CASES, ids=IDS)
@pytest.mark.parametrize("backend", ["host", None], ids=["host", "default"])
def test_classifier_sampled_tree_equals_jax(cls_data, kw, backend):
    from mpitree_tpu.tree import DecisionTreeClassifier as JaxTree

    X, y = cls_data
    params = dict(max_depth=6, max_bins=64, random_state=3, **kw)
    ref = JaxTree(backend=backend, **params).fit(X, y)
    est = DecisionTreeClassifier(backend=backend, device="cpu",
                                 **params).fit(X, y)
    if backend is None:  # the tail engaged below a one-level crown
        assert stats_view(est.fit_report_)["crown_depth"] == 1
        assert stats_view(est.fit_report_)["refine_nodes_added"] > 0
    _same_tree(est.tree_, ref.tree_)
    np.testing.assert_allclose(est.feature_importances_,
                               ref.feature_importances_, rtol=1e-12)


@pytest.mark.parametrize("kw", CASES, ids=IDS)
@pytest.mark.parametrize("backend", ["host", None], ids=["host", "default"])
def test_regressor_sampled_tree_equals_jax(reg_data, kw, backend):
    from mpitree_tpu.tree import DecisionTreeRegressor as JaxReg

    X, y = reg_data
    params = dict(max_depth=7, max_bins=64, random_state=3, **kw)
    ref = JaxReg(backend=backend, **params).fit(X, y)
    est = DecisionTreeRegressor(backend=backend, device="cpu",
                                **params).fit(X, y)
    if backend is None:
        assert stats_view(est.fit_report_)["refine_nodes_added"] > 0
    _same_tree(est.tree_, ref.tree_)
    np.testing.assert_allclose(est.feature_importances_,
                               ref.feature_importances_, rtol=1e-12)


def test_device_engine_sampled_tree_equals_jax_host_tier(cls_data):
    """The device engine alone (every level on the card's code path) draws
    the same masks and bins as the JAX host tier."""
    from mpitree_tpu.tree import DecisionTreeClassifier as JaxTree

    X, y = cls_data
    params = dict(max_depth=8, max_features=0.3, splitter="random",
                  random_state=5, refine_depth=None)
    ref = JaxTree(backend="host", **params).fit(X, y)
    est = DecisionTreeClassifier(device="cpu", **params).fit(X, y)
    assert stats_view(est.fit_report_)["engine"] == "fused"
    _same_tree(est.tree_, ref.tree_)


def test_sampled_leaf_without_valid_split_is_a_leaf():
    """No redraw: with one sampled feature per node, a node whose feature
    is constant among its rows stops, though another feature could
    split it."""
    X = np.zeros((64, 3), np.float32)
    X[:, 0] = np.arange(64) % 2
    y = (X[:, 0] > 0).astype(np.int64)
    fits = [DecisionTreeClassifier(max_features=1, random_state=s,
                                   device="cpu").fit(X, y)
            for s in range(8)]
    roots = {f.tree_.feature[0] for f in fits}
    assert -1 in roots and 0 in roots

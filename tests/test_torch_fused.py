"""The port's fused engine (``core/fused_builder.py``) against the JAX
package's fused engine and against the port's levelwise engine.

- classification: the port's fused tree equals JAX's fused tree
  (``BuildConfig(engine="fused")`` on a one-device CPU mesh) field for
  field: entropy and gini, unbounded depth, ``min_samples_split``, a
  single row and a constant column, multi-chunk frontiers with and without
  per-node sampling (``max_frontier_chunk`` 32/64, ``frontier_tiers=(8,)``,
  as ``tests/test_fused_builder.py:105-177``), ``splitter="random"``,
  ``monotonic_cst`` and integer weights; with subtraction on as well;
- regression: the port's fused tree equals its levelwise tree bit for bit
  (both sum the moments exactly), and meets ``ROADMAP.md`` R4's contract
  against JAX's fused tree (float32 moments there);
- the sampling twins equal the host hash bit for bit; ``_node_capacity``
  equals JAX's; one frontier read a level; the default fit's fused crown
  against the JAX default; ``fit_stats_["engine"]`` and
  ``MPITREE_TPU_ENGINE``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from mpitree_tpu_torch.core import builder as pbuilder  # noqa: E402
from mpitree_tpu_torch.obs import stats_view  # noqa: E402
from mpitree_tpu_torch.core import fused_builder as pfused  # noqa: E402
from mpitree_tpu_torch.core.builder import BuildConfig, build_tree  # noqa: E402
from mpitree_tpu_torch.ops import sampling as psamp  # noqa: E402
from mpitree_tpu_torch.ops.binning import bin_dataset  # noqa: E402
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
def cls_data():
    X, y = covtype_like(3_000, seed=4)
    return X, y


def _both(X, y, kw, *, n_classes, max_bins=32, jax_sampler=None,
          port_sampler=None, subtraction=("off",), **build):
    """(port fused trees per subtraction setting, JAX fused tree)."""
    from mpitree_tpu.core.builder import BuildConfig as JConfig
    from mpitree_tpu.core.builder import build_tree as jbuild
    from mpitree_tpu.ops.binning import bin_dataset as jbin
    from mpitree_tpu.parallel import mesh as mesh_lib

    jb = jbin(X, max_bins=max_bins, binning="quantile")
    ref = jbuild(jb, y, config=JConfig(engine="fused", **kw),
                 mesh=mesh_lib.resolve_mesh(n_devices=1),
                 n_classes=n_classes, feature_sampler=jax_sampler, **build)
    pb = bin_dataset(X, max_bins=max_bins, binning="quantile")
    pb = dataclasses.replace(pb, x_binned=torch.from_numpy(pb.x_binned))
    got = {sub: build_tree(pb, y, config=BuildConfig(
        engine="fused", hist_subtraction=sub, **kw), n_classes=n_classes,
        feature_sampler=port_sampler, **build) for sub in subtraction}
    return got, ref


@pytest.mark.parametrize("criterion", ["entropy", "gini"])
def test_fused_equals_jax_fused(cls_data, criterion):
    X, y = cls_data
    got, ref = _both(X, y, dict(max_depth=9, criterion=criterion),
                     n_classes=7, subtraction=("off", "on"))
    for sub, tree in got.items():
        _same_tree(tree, ref, sub)


@pytest.mark.parametrize("kw", [
    dict(max_depth=None),
    dict(max_depth=12, min_samples_split=40),
    dict(max_depth=10, max_frontier_chunk=32, frontier_tiers=(8,)),
], ids=["unbounded", "min-samples-split", "multi-chunk"])
def test_fused_depth_rules_and_chunks(cls_data, kw):
    X, y = cls_data
    got, ref = _both(X[:1_500], y[:1_500], kw, n_classes=7,
                     subtraction=("off", "on"))
    for sub, tree in got.items():
        _same_tree(tree, ref, sub)


def test_fused_single_row_and_constant_column():
    from mpitree_tpu.core.builder import BuildConfig as JConfig
    from mpitree_tpu.core.builder import build_tree as jbuild
    from mpitree_tpu.ops.binning import bin_dataset as jbin
    from mpitree_tpu.parallel import mesh as mesh_lib

    mesh = mesh_lib.resolve_mesh(n_devices=1)
    rng = np.random.default_rng(0)
    X = rng.normal(size=(200, 3)).astype(np.float32)
    X[:, 1] = 4.0  # a constant column
    y = (X[:, 0] > 0).astype(np.int64)
    for Xc, yc in ((X, y), (X[:1], y[:1]), (np.ones((5, 3), np.float32),
                                            np.ones(5, np.int64))):
        ref = jbuild(jbin(Xc, max_bins=16), yc, config=JConfig(
            engine="fused"), mesh=mesh, n_classes=2)
        pb = bin_dataset(Xc, max_bins=16)
        got = build_tree(dataclasses.replace(
            pb, x_binned=torch.from_numpy(pb.x_binned)), yc,
            config=BuildConfig(engine="fused"), n_classes=2)
        _same_tree(got, ref, str(len(yc)))
    assert got.n_nodes == 1 and got.feature[0] == -1


@pytest.mark.parametrize("k,chunk,random_split", [
    (3, 32, False), (4, 64, False), (10, 64, True), (5, 32, True),
], ids=["k3-chunk32", "k4-chunk64", "random", "k5-random-chunk32"])
def test_fused_sampling_equals_jax(cls_data, k, chunk, random_split):
    from mpitree_tpu.ops import sampling as jsamp

    X, y = cls_data
    X = X[:, :10]  # the continuous columns: deep trees under sampling
    kw = dict(k=k, n_features=X.shape[1], seed=5, random_split=random_split)
    got, ref = _both(
        X, y, dict(max_depth=10, max_frontier_chunk=chunk,
                   frontier_tiers=(8,)), n_classes=7,
        jax_sampler=jsamp.NodeFeatureSampler(**kw),
        port_sampler=psamp.NodeFeatureSampler(**kw),
        subtraction=("off", "on"))
    assert ref.n_nodes > 2 * chunk  # frontiers crossed the chunk
    for sub, tree in got.items():
        _same_tree(tree, ref, sub)


def test_fused_monotonic_and_integer_weights_equal_jax(cls_data):
    X, y = cls_data
    yb = (y == 1).astype(np.int64)
    cst = np.zeros(X.shape[1], np.int8)
    cst[0], cst[5] = -1, 1  # internal signs (class-0 fraction)
    got, ref = _both(X, yb, dict(max_depth=9), n_classes=2, mono_cst=cst,
                     subtraction=("off", "on"))
    for sub, tree in got.items():
        _same_tree(tree, ref, f"mono {sub}")
    w = np.random.default_rng(1).integers(0, 4, len(y)).astype(np.float32)
    got, ref = _both(X, y, dict(max_depth=9), n_classes=7, sample_weight=w,
                     subtraction=("off", "on"))
    for sub, tree in got.items():
        _same_tree(tree, ref, f"weights {sub}")


def test_fused_regression_equals_levelwise_and_r4_against_jax():
    from mpitree_tpu.core.builder import BuildConfig as JConfig
    from mpitree_tpu.core.builder import build_tree as jbuild
    from mpitree_tpu.ops.binning import bin_dataset as jbin
    from mpitree_tpu.parallel import mesh as mesh_lib

    X, y = california_like(3_000, seed=3)
    y32 = (y - y.mean()).astype(np.float32)
    pb = bin_dataset(X, max_bins=64, binning="quantile")
    pb = dataclasses.replace(pb, x_binned=torch.from_numpy(pb.x_binned))
    kw = dict(task="regression", criterion="mse", max_depth=9)
    trees = {(eng, sub): build_tree(pb, y32, config=BuildConfig(
        engine=eng, hist_subtraction=sub, **kw), refit_targets=y)
        for eng in ("levelwise", "fused") for sub in ("off", "on")}
    base = trees[("levelwise", "off")]
    for key, tree in trees.items():
        _same_tree(tree, base, str(key))
    ref = jbuild(jbin(X, max_bins=64, binning="quantile"), y32,
                 config=JConfig(engine="fused", **kw),
                 mesh=mesh_lib.resolve_mesh(n_devices=1), refit_targets=y)
    got = trees[("fused", "off")]
    assert got.n_nodes == ref.n_nodes
    assert np.mean(got.feature == ref.feature) >= 0.9
    # R^2 of the training fit within 1e-3
    def r2(tree):
        from mpitree_tpu_torch.ops.predict import predict_leaf_ids

        leaves = predict_leaf_ids(X, tree, torch.device("cpu"))
        pred = tree.count[leaves, 0]
        return 1 - ((y - pred) ** 2).sum() / ((y - y.mean()) ** 2).sum()

    assert abs(r2(got) - r2(ref)) <= 1e-3


def test_node_capacity_equals_jax():
    from mpitree_tpu.core.fused_builder import _node_capacity as jcap

    for n, d in [(100, None), (10**6, 3), (1, None), (581_012, 20),
                 (200_000, 12), (5, 0), (7, 40)]:
        assert pfused._node_capacity(n, d) == jcap(n, d), (n, d)


def test_sampler_statics_equal_jax():
    from mpitree_tpu.core.fused_builder import _sampler_statics as jstat
    from mpitree_tpu.ops import sampling as jsamp

    for kw in (dict(k=3, n_features=8, seed=2),
               dict(k=8, n_features=8, seed=2, random_split=True),
               dict(k=8, n_features=8, seed=2)):
        got = pfused._sampler_statics(psamp.NodeFeatureSampler(**kw), 8)
        want = jstat(jsamp.NodeFeatureSampler(**kw), 8)
        assert got == (want[0], want[1], int(want[2]))
    assert pfused._sampler_statics(None, 8) == (None, False, 0)


@pytest.mark.parametrize("seed", range(3))
def test_sampling_twins_bit_identical(seed):
    keys = np.random.default_rng(seed).integers(
        0, 2**32, size=513, dtype=np.uint64).astype(np.uint32)
    kd = torch.from_numpy(keys.astype(np.int64))
    np.testing.assert_array_equal(psamp.pcg_hash_dev(kd).numpy(),
                                  psamp.pcg_hash(keys).astype(np.int64))
    for k in (1, 7, 54):
        s = psamp.NodeFeatureSampler(k=k, n_features=54, seed=seed)
        np.testing.assert_array_equal(
            psamp.node_masks_dev(kd, k, 54).numpy(), s.node_masks(keys))
        np.testing.assert_array_equal(psamp.node_draws_dev(kd, 54).numpy(),
                                      s.node_draws(keys).astype(np.int64))
        for a, b in zip(psamp.child_keys_dev(kd), s.child_keys(keys)):
            np.testing.assert_array_equal(a.numpy(), b.astype(np.int64))


@pytest.mark.parametrize("C", [2, 5, 7, 8, 9, 16, 23, 40, 130])
def test_row_sum_follows_numpy(C):
    x = np.random.default_rng(C).uniform(0, 1e3, size=(300, C))
    np.testing.assert_array_equal(
        pfused._row_sum(torch.from_numpy(x)).numpy(), x.sum(axis=1))


def test_one_frontier_read_a_level(cls_data):
    X, y = cls_data
    pb = bin_dataset(X, max_bins=32)
    pb = dataclasses.replace(pb, x_binned=torch.from_numpy(pb.x_binned))
    for depth in (6, None):
        before = pfused.frontier_reads
        tree = build_tree(pb, y, config=BuildConfig(engine="fused",
                                                    max_depth=depth),
                          n_classes=7)
        levels = int(tree.depth.max()) + 1
        # a terminal level (depth == max_depth) reads nothing
        assert pfused.frontier_reads - before == levels - (
            depth is not None and levels == depth + 1)


def test_default_fit_fused_crown_equals_jax_default(cls_data):
    from mpitree_tpu.tree import DecisionTreeClassifier as JaxTree

    X, y = cls_data
    kw = dict(max_depth=10, max_bins=32, refine_depth=2)
    ref = JaxTree(**kw).fit(X, y)
    est = DecisionTreeClassifier(device="cpu", **kw).fit(X, y)
    assert stats_view(est.fit_report_)["engine"] == "fused"
    assert stats_view(est.fit_report_)["refine_nodes_added"] > 0
    _same_tree(est.tree_, ref.tree_)


def test_engine_resolution_and_steering(cls_data, monkeypatch):
    X, y = cls_data
    monkeypatch.delenv(pbuilder.ENGINE_ENV, raising=False)
    assert pbuilder.resolve_engine(BuildConfig()) == "fused"
    assert pbuilder.resolve_engine(BuildConfig(task="gbdt")) == "levelwise"
    with pytest.raises(ValueError, match="does not implement task='gbdt'"):
        pbuilder.resolve_engine(BuildConfig(task="gbdt", engine="fused"))
    with pytest.raises(ValueError, match="unknown build engine"):
        pbuilder.resolve_engine(BuildConfig(engine="fast"))
    kw = dict(max_depth=6, refine_depth=None, device="cpu")
    fused = DecisionTreeClassifier(**kw).fit(X, y)
    monkeypatch.setenv(pbuilder.ENGINE_ENV, "levelwise")
    assert pbuilder.resolve_engine(BuildConfig()) == "levelwise"
    # the knob steers "auto" only
    assert pbuilder.resolve_engine(BuildConfig(engine="fused")) == "fused"
    lw = DecisionTreeClassifier(**kw).fit(X, y)
    assert (stats_view(fused.fit_report_)["engine"], stats_view(lw.fit_report_)["engine"]) == (
        "fused", "levelwise")
    _same_tree(fused.tree_, lw.tree_)
    reg = DecisionTreeRegressor(**kw).fit(*california_like(500, seed=1))
    assert stats_view(reg.fit_report_)["engine"] == "levelwise"
    monkeypatch.setenv(pbuilder.ENGINE_ENV, "bogus")
    with pytest.raises(ValueError, match="MPITREE_TPU_ENGINE"):
        pbuilder.resolve_engine(BuildConfig())

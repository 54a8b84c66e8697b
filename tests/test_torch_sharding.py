"""Distributed invariants on 8 CPU shards: a port of ``tests/test_sharding.py``.

The reference's parallel correctness is that every rank computes the same
split (SURVEY.md §2.4). The port's data mesh restates it as the JAX
package does: the fitted tree is the same field for field at every shard
count, because the reduced histograms are integer-valued float32 sums
below 2**24 or int64 fixed-point sums, which no summation order changes,
and the split search runs once on the reduced histogram. The shard count
comes from ``mesh.set_cpu_shards(8)``, where the JAX tests force 8 virtual
CPU devices (``tests/conftest.py``), and the JAX fits run there on those 8
devices.

Against the JAX package: exact wherever JAX's sums are (integer weights),
so field for field with ``max_features``, ``splitter="random"``,
``monotonic_cst``, the default refine tail and covtype at depth 10.
Non-integer payloads are JAX's own identity opt-out
(``mpitree_tpu/core/builder.py:244-260``): its device engine sums float32
counts and moments, so there the port is held to the existing contracts,
named in the test: fractional weights to F2 (``tests/test_torch_weights.py``),
the regressor's moments to R4 (``ROADMAP.md``).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
pytest.importorskip("sklearn")

from mpitree_tpu_torch import (  # noqa: E402
    DecisionTreeClassifier,
    DecisionTreeRegressor,
    ParallelDecisionTreeClassifier,
)
from mpitree_tpu_torch.obs import stats_view  # noqa: E402
from mpitree_tpu_torch.models.classifier import predict_mesh  # noqa: E402
from mpitree_tpu_torch.parallel import mesh as M  # noqa: E402
from mpitree_tpu_torch.utils.datasets import (  # noqa: E402
    california_like,
    covtype_like,
)

FIELDS = ("feature", "threshold", "left", "right", "parent", "depth",
          "value", "count", "n_node_samples", "impurity")
STRUCTURE = ("feature", "threshold", "left", "right", "parent", "depth")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread_eight_shards():
    """One torch thread (six pytest-xdist workers share the cores) and 8
    CPU shards, the JAX tests' 8 virtual devices; both restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    prev = M.set_cpu_shards(8)
    yield
    M.set_cpu_shards(prev)
    torch.set_num_threads(n)


def _same_tree(got, want, what=""):
    assert got.n_nodes == want.n_nodes, what
    for k in FIELDS:
        a, b = getattr(got, k), getattr(want, k)
        assert a.dtype == b.dtype, (what, k)
        np.testing.assert_array_equal(a, b, err_msg=f"{what} {k}")


def _jax(name, **kw):
    import mpitree_tpu.tree as jt

    return getattr(jt, name)(**kw)


@pytest.fixture(scope="module")
def cov():
    X, y = covtype_like(3_000, seed=4)
    return X, y


@pytest.fixture(scope="module")
def jax_cov_default(cov):
    """JAX's ParallelDecisionTreeClassifier on 8 devices, depth 8, the
    device engine alone."""
    X, y = cov
    return _jax("ParallelDecisionTreeClassifier", max_depth=8,
                refine_depth=None).fit(X, y).tree_


@pytest.mark.parametrize("n_devices", [1, 2, 8])
def test_tree_identical_across_shard_counts(iris2, n_devices):
    X, y, _ = iris2
    kw = dict(max_depth=5, binning="exact", device="cpu")
    seq = DecisionTreeClassifier(**kw).fit(X, y)
    par = DecisionTreeClassifier(n_devices=n_devices, **kw).fit(X, y)
    _same_tree(par.tree_, seq.tree_)
    if n_devices > 1:
        assert stats_view(par.fit_report_)["n_shards"] == n_devices
        assert stats_view(par.fit_report_)["allreduce_calls"] > 0
    ref = _jax("DecisionTreeClassifier", max_depth=5, binning="exact",
               n_devices=8).fit(X, y)
    _same_tree(par.tree_, ref.tree_, "vs JAX on 8 devices")


def test_parallel_class_equals_jax_on_8_devices(iris2):
    X, y, _ = iris2
    par = ParallelDecisionTreeClassifier(max_depth=3, binning="exact",
                                         device="cpu").fit(X, y)
    assert par.n_devices == "all" and stats_view(par.fit_report_)["n_shards"] == 8
    ref = _jax("ParallelDecisionTreeClassifier", max_depth=3,
               binning="exact").fit(X, y)
    _same_tree(par.tree_, ref.tree_)
    np.testing.assert_array_equal(par.predict(X), ref.predict(X))
    np.testing.assert_array_equal(par.predict_proba(X), ref.predict_proba(X))
    assert par.get_params() == dict(ref.get_params(), device="cpu")


def test_parallel_world_attrs():
    from mpitree_tpu.tree import ParallelDecisionTreeClassifier as JaxPar

    assert ParallelDecisionTreeClassifier.WORLD_SIZE == JaxPar.WORLD_SIZE == 8
    assert ParallelDecisionTreeClassifier.WORLD_RANK == JaxPar.WORLD_RANK == 0


def test_uneven_rows_pad_correctly():
    # 103 rows over 8 shards exercises the padding path.
    rng = np.random.default_rng(1)
    X = rng.normal(size=(103, 5))
    y = rng.integers(0, 2, size=103)
    seq = DecisionTreeClassifier(max_depth=4, device="cpu").fit(X, y)
    par = DecisionTreeClassifier(max_depth=4, n_devices=8,
                                 device="cpu").fit(X, y)
    _same_tree(par.tree_, seq.tree_)
    ref = _jax("DecisionTreeClassifier", max_depth=4, n_devices=8).fit(X, y)
    _same_tree(par.tree_, ref.tree_, "vs JAX")


def test_regressor_sharded_matches_single():
    rng = np.random.default_rng(2)
    X = rng.normal(size=(200, 4))
    y = (X[:, 0] * 2 + rng.normal(scale=0.1, size=200)).astype(np.float64)
    seq = DecisionTreeRegressor(max_depth=5, device="cpu").fit(X, y)
    for n in (2, 8):
        par = DecisionTreeRegressor(max_depth=5, n_devices=n,
                                    device="cpu").fit(X, y)
        _same_tree(par.tree_, seq.tree_, f"{n} shards")
    ref = _jax("DecisionTreeRegressor", max_depth=5, n_devices=8).fit(X, y)
    _same_tree(par.tree_, ref.tree_, "vs JAX")


def test_regressor_deeper_sharded_exact_and_r4_against_jax():
    """At 3,000 rows and depth 8 the port's fixed-point moments give the
    same tree at 1 and 8 shards; JAX's 8-device tree sums float32 moments,
    so it is held to R4's contract: the same node count, at least 90% of
    nodes on the same feature, R^2 within 1e-3."""
    X, y = california_like(3_000, seed=0)
    kw = dict(max_depth=8, refine_depth=None)
    seq = DecisionTreeRegressor(device="cpu", **kw).fit(X, y)
    par = DecisionTreeRegressor(device="cpu", n_devices=8, **kw).fit(X, y)
    _same_tree(par.tree_, seq.tree_)
    ref = _jax("DecisionTreeRegressor", n_devices=8, **kw).fit(X, y)
    assert par.tree_.n_nodes == ref.tree_.n_nodes
    agree = np.mean(par.tree_.feature == ref.tree_.feature)
    assert agree >= 0.9, f"only {agree:.0%} of nodes agree (R4)"
    assert abs(par.score(X, y) - ref.score(X, y)) < 1e-3


def test_predict_is_data_sharded_and_identical():
    """Rows split over the 8 shards at predict; the answers equal the
    single-device ones exactly, uneven row counts included."""
    rng = np.random.default_rng(5)
    X = rng.normal(size=(203, 5))
    y = rng.integers(0, 3, size=203)
    par = DecisionTreeClassifier(max_depth=6, n_devices=8,
                                 device="cpu").fit(X, y)
    assert predict_mesh(par).size == 8
    single = DecisionTreeClassifier(max_depth=6, device="cpu").fit(X, y)
    assert predict_mesh(single) is None
    Xq = rng.normal(size=(157, 5))
    np.testing.assert_array_equal(par.predict(Xq), single.predict(Xq))
    np.testing.assert_array_equal(par.predict_proba(Xq),
                                  single.predict_proba(Xq))
    np.testing.assert_array_equal(par.apply(Xq), single.apply(Xq))
    reg = DecisionTreeRegressor(max_depth=5, n_devices=8, device="cpu").fit(
        X, X[:, 0] - X[:, 1])
    one = DecisionTreeRegressor(max_depth=5, device="cpu").fit(
        X, X[:, 0] - X[:, 1])
    np.testing.assert_array_equal(reg.predict(Xq), one.predict(Xq))
    par.set_params(n_devices=9)  # a mesh that cannot be had raises
    with pytest.raises(ValueError, match="n_devices=9"):
        par.predict(Xq)


@pytest.mark.parametrize("kw", [
    dict(max_features="sqrt", random_state=0),
    dict(splitter="random", random_state=0),
    dict(monotonic_cst="binary"),
], ids=["sqrt", "random", "monotonic"])
def test_options_identical_across_shards_and_to_jax(cov, kw):
    X, y = cov
    kw = dict(kw)
    if kw.get("monotonic_cst") == "binary":
        y = (y == 1).astype(np.int64)
        kw["monotonic_cst"] = [1] + [0] * (X.shape[1] - 1)
    base = dict(max_depth=8, refine_depth=None, **kw)
    seq = DecisionTreeClassifier(device="cpu", **base).fit(X, y)
    par = ParallelDecisionTreeClassifier(device="cpu", **base).fit(X, y)
    _same_tree(par.tree_, seq.tree_)
    ref = _jax("ParallelDecisionTreeClassifier", **base).fit(X, y)
    _same_tree(par.tree_, ref.tree_, "vs JAX on 8 devices")


def _assert_f2(port, ref):
    """F2 (``tests/test_torch_weights.py``): the same structure and
    ``n_node_samples`` (one apart where the exact weight lies within the
    bound of an integer), counts within float32 recursive summation's
    bound ``rows * 2**-24 * sum(counts)`` per node."""
    assert port.n_nodes == ref.n_nodes
    for k in STRUCTURE:
        np.testing.assert_array_equal(getattr(port, k), getattr(ref, k),
                                      err_msg=k)
    total = port.count.sum(axis=1)
    bound = 2.0 * (port.n_node_samples + 1) * 2.0 ** -24 * total
    assert (np.abs(port.count - ref.count) <= bound[:, None]).all()
    gap = port.n_node_samples - ref.n_node_samples
    edge = np.abs(total - np.round(total)) <= bound
    assert ((gap == 0) | ((np.abs(gap) == 1) & edge)).all()


@pytest.mark.parametrize("how", ["sample_weight", "class_weight"])
def test_fractional_weights_sharded_exact_and_f2_against_jax(how):
    """Fractional weights take the fixed-point route with global
    exponents: 8 shards equal 1 field for field. JAX's 8 devices sum
    float32 counts, so against them F2's contract holds, in F2's own
    settings (``tests/test_torch_weights.py``: its weights at depth 6 on
    the device engine; ``class_weight="balanced"`` at depth 14 with the
    tail): the same structure and ``n_node_samples``, counts within
    float32 rounding."""
    X, y = covtype_like(12_000, seed=0)
    fit_kw = {}
    if how == "sample_weight":
        kw = dict(max_depth=6, refine_depth=None)
        fit_kw["sample_weight"] = np.random.default_rng(2).uniform(
            0.5, 2, len(y)).astype(np.float32)
    else:
        kw = dict(max_depth=14, class_weight="balanced")
    seq = DecisionTreeClassifier(device="cpu", **kw).fit(X, y, **fit_kw)
    par = ParallelDecisionTreeClassifier(device="cpu", **kw).fit(
        X, y, **fit_kw)
    _same_tree(par.tree_, seq.tree_)
    ref = _jax("ParallelDecisionTreeClassifier", **kw).fit(X, y, **fit_kw)
    _assert_f2(par.tree_, ref.tree_)


@pytest.mark.parametrize("engine,sub", [
    ("fused", "off"), ("fused", "on"), ("levelwise", "off"),
    ("levelwise", "on"),
])
def test_both_engines_with_and_without_subtraction(
        monkeypatch, cov, jax_cov_default, engine, sub):
    monkeypatch.setenv("MPITREE_TPU_ENGINE", engine)
    monkeypatch.setenv("MPITREE_TPU_HIST_SUBTRACTION", sub)
    X, y = cov
    for n in (2, 8):
        par = DecisionTreeClassifier(max_depth=8, refine_depth=None,
                                     n_devices=n, device="cpu").fit(X, y)
        assert stats_view(par.fit_report_)["engine"] == engine
        _same_tree(par.tree_, jax_cov_default, f"{engine} {sub} {n}")


def test_debug_fit_runs_the_replication_path(monkeypatch, cov,
                                             jax_cov_default):
    """``MPITREE_TPU_DEBUG`` builds with ``BuildConfig(debug=True)``; in
    one process the local shards share one sweep, so nothing is checked
    and the tree is the same."""
    monkeypatch.setenv("MPITREE_TPU_DEBUG", "1")
    X, y = cov
    par = ParallelDecisionTreeClassifier(max_depth=8, refine_depth=None,
                                         device="cpu").fit(X, y)
    _same_tree(par.tree_, jax_cov_default)
    assert stats_view(par.fit_report_)["replication_checks"] == 0


@pytest.fixture(scope="module")
def cov20k():
    return covtype_like(20_000, seed=0)


def test_default_refine_tail_on_a_sharded_crown(cov20k):
    """At defaults the crown (depth round(log2(20000 / 2048)) = 3) grows on
    8 shards and the tail on the host from the gathered leaf ids: the
    single-shard fit and JAX's 8-device fit, field for field."""
    X, y = cov20k
    par = ParallelDecisionTreeClassifier(device="cpu").fit(X, y)
    assert stats_view(par.fit_report_)["crown_depth"] == 3
    assert stats_view(par.fit_report_)["refine_nodes_added"] > 0
    seq = DecisionTreeClassifier(device="cpu").fit(X, y)
    _same_tree(par.tree_, seq.tree_)
    ref = _jax("ParallelDecisionTreeClassifier").fit(X, y)
    _same_tree(par.tree_, ref.tree_, "vs JAX")
    Xc, yc = california_like(20_000, seed=3)
    r8 = DecisionTreeRegressor(device="cpu", n_devices=8).fit(Xc, yc)
    r1 = DecisionTreeRegressor(device="cpu").fit(Xc, yc)
    assert stats_view(r8.fit_report_)["refine_nodes_added"] > 0
    _same_tree(r8.tree_, r1.tree_, "regressor at defaults")


def test_covtype_depth10_at_8_shards_equals_jax(cov20k):
    X, y = cov20k
    par = ParallelDecisionTreeClassifier(max_depth=10, refine_depth=None,
                                         device="cpu").fit(X, y)
    ref = _jax("ParallelDecisionTreeClassifier", max_depth=10,
               refine_depth=None).fit(X, y)
    _same_tree(par.tree_, ref.tree_)
    assert par.tree_.n_nodes > 1_000

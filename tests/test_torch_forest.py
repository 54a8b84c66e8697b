"""The port's ``RandomForestClassifier`` on the CPU against the JAX package.

``covtype_like(20_000, seed=0)``, ``n_estimators=4, max_depth=6,
random_state=0``, the port's device engine alone (``refine_depth=None``;
``tests/test_torch_hybrid.py`` holds the refine tail). The reference is the
JAX forest on its CPU device engine (``backend="cpu", refine_depth=None``),
whose batched and per-tree builds grow identical trees
(``tests/test_forest.py``). Both packages draw the
same multinomial bootstrap weights from one numpy generator, the
histograms of integer weights are exact in any order and both sweeps rank
float64 costs, so every tree must be equal field for field and
``predict_proba`` (the same float64 host loop) equal bit for bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from mpitree_tpu_torch.models.classifier import NotFittedError  # noqa: E402
from mpitree_tpu_torch.tree import RandomForestClassifier  # noqa: E402
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
PARAMS = dict(n_estimators=4, max_depth=6, random_state=0)


@pytest.fixture(scope="module")
def forests():
    from mpitree_tpu.tree import RandomForestClassifier as JaxForest

    X, y = covtype_like(20_000, seed=0)
    jax_f = JaxForest(backend="cpu", refine_depth=None, **PARAMS).fit(X, y)
    port = RandomForestClassifier(device="cpu", refine_depth=None,
                                  **PARAMS).fit(X, y)
    Xh, _ = covtype_like(3_000, seed=1)
    return X, y, Xh, jax_f, port


@pytest.mark.parametrize("i", range(PARAMS["n_estimators"]))
def test_each_tree_identical_to_jax(forests, i):
    *_, jax_f, port = forests
    got, want = port.trees_[i], jax_f.trees_[i]
    assert got.n_nodes == want.n_nodes
    for k in FIELDS:
        a, b = getattr(got, k), getattr(want, k)
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)


def test_predict_proba_bit_identical_to_jax(forests):
    X, y, Xh, jax_f, port = forests
    pp, jp = port.predict_proba(Xh), jax_f.predict_proba(Xh)
    assert pp.dtype == jp.dtype == np.float64
    np.testing.assert_array_equal(pp, jp)
    np.testing.assert_array_equal(port.predict(Xh), jax_f.predict(Xh))
    np.testing.assert_array_equal(port.classes_, jax_f.classes_)
    assert port.score(X, y) == jax_f.score(X, y)


def test_stacked_leaf_ids_equal_jax(forests):
    from mpitree_tpu.ops.predict import stacked_leaf_ids as jax_ids

    from mpitree_tpu_torch.ops.predict import stacked_leaf_ids
    from mpitree_tpu_torch.serving.tables import tables_for
    from mpitree_tpu_torch.serving.traversal import flat_leaf_ids

    *_, Xh, jax_f, port = forests
    cpu = torch.device("cpu")
    got = stacked_leaf_ids(port.trees_, Xh, cpu)
    np.testing.assert_array_equal(got, jax_ids(jax_f.trees_, Xh))
    # a group budget smaller than one tree: one table per tree
    split = tables_for(port.trees_, group_bytes=1)
    assert [tb.n_trees for tb in split] == [1] * len(port.trees_)
    for i, tb in enumerate(split):
        ids = flat_leaf_ids(torch.from_numpy(Xh), *tb.dev_arrays(cpu),
                            n_steps=tb.n_steps)
        np.testing.assert_array_equal(ids[:, 0].numpy(), got[i])


def test_reference_forest_carries_over(forests):
    *_, Xh, jax_f, _ = forests
    port = RandomForestClassifier.from_reference(
        [dataclasses.asdict(t) for t in jax_f.trees_], jax_f.classes_,
        jax_f.n_features_, device="cpu",
    )
    assert port.n_estimators == len(port.trees_) == 4
    np.testing.assert_array_equal(port.predict_proba(Xh),
                                  jax_f.predict_proba(Xh))


@pytest.mark.parametrize("params", [
    dict(n_estimators=3, max_depth=5, random_state=7, criterion="gini",
         min_samples_leaf=4, min_weight_fraction_leaf=0.02),
    dict(n_estimators=2, max_depth=4, random_state=1, bootstrap=False),
], ids=["gini-leaf-floors", "no-bootstrap"])
def test_options_identical_to_jax(params):
    """Per-tree leaf floors from the composed weights, gini, integer user
    weights riding the bootstrap, and bootstrap=False."""
    from mpitree_tpu.tree import RandomForestClassifier as JaxForest

    X, y = covtype_like(3_000, seed=5)
    w = np.random.default_rng(2).integers(1, 3, size=len(y)).astype(
        np.float32)
    jax_f = JaxForest(backend="cpu", refine_depth=None, **params).fit(
        X, y, sample_weight=w)
    port = RandomForestClassifier(device="cpu", refine_depth=None,
                                  **params).fit(X, y, sample_weight=w)
    for got, want in zip(port.trees_, jax_f.trees_, strict=True):
        for k in FIELDS:
            np.testing.assert_array_equal(getattr(got, k), getattr(want, k),
                                          err_msg=k)


def test_default_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X, y = covtype_like(200, seed=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        RandomForestClassifier(n_estimators=2, max_depth=2).fit(X, y)
    f = RandomForestClassifier(n_estimators=2, max_depth=2,
                               device="cpu").fit(X, y)
    f.set_params(device=None)
    with pytest.raises(RuntimeError, match="CUDA"):
        f.predict_proba(X)


def test_estimator_surface():
    X, y = covtype_like(600, seed=2)
    f = RandomForestClassifier(n_estimators=3, max_depth=3, device="cpu")
    with pytest.raises(NotFittedError):
        f.predict(X)
    assert f.get_params()["n_estimators"] == 3
    with pytest.raises(ValueError, match="Invalid parameter"):
        f.set_params(nope=1)
    f.fit(X, y)
    proba = f.predict_proba(X)
    np.testing.assert_allclose(proba.sum(axis=1), 1.0, rtol=0, atol=1e-12)
    assert f.score(X, y) == float(np.mean(f.predict(X) == y))
    with pytest.raises(ValueError, match="features"):
        f.predict(X[:, :5])


@pytest.mark.parametrize("param,value", [
    ("max_features", "sqrt"), ("splitter", "random"), ("oob_score", True),
    ("class_weight", "balanced"), ("warm_start", True),
])
def test_options_now_ported_equal_jax(param, value):
    """Once refused, now fitted: every tree equals the JAX default's (its
    host tier at this size), and so do the OOB scores; a warm start grows
    one tree onto one."""
    from mpitree_tpu.tree import RandomForestClassifier as JaxForest

    X, y = covtype_like(1_500, seed=0)
    kw = dict(n_estimators=2, max_depth=4, random_state=3, **{param: value})
    ests = [JaxForest(**kw), RandomForestClassifier(device="cpu", **kw)]
    for est in ests:
        if param == "warm_start":
            est.set_params(n_estimators=1).fit(X, y)
            est.set_params(n_estimators=2)
        est.fit(X, y)
    ref, port = ests
    for got, want in zip(port.trees_, ref.trees_, strict=True):
        for k in FIELDS:
            np.testing.assert_array_equal(getattr(got, k), getattr(want, k),
                                          err_msg=k)
    if param == "oob_score":
        assert port.oob_score_ == ref.oob_score_
        np.testing.assert_array_equal(port.oob_decision_function_,
                                      ref.oob_decision_function_)


@pytest.mark.parametrize("param,value", [
    ("checkpoint", "ck"), ("checkpoint_compact_every", 4),
    ("n_devices", 2),
])
def test_options_off_this_slice_raise(param, value):
    """Options not ported raise naming their ROADMAP item; ``n_devices``,
    refused until item 14b, now fits the one-device forest."""
    X, y = covtype_like(100, seed=0)
    if param == "n_devices":
        from mpitree_tpu_torch.parallel import mesh

        prev = mesh.set_cpu_shards(value)
        try:
            par = RandomForestClassifier(n_estimators=2, device="cpu",
                                         random_state=0,
                                         **{param: value}).fit(X, y)
        finally:
            mesh.set_cpu_shards(prev)
        one = RandomForestClassifier(n_estimators=2, device="cpu",
                                     random_state=0).fit(X, y)
        for got, want in zip(par.trees_, one.trees_, strict=True):
            for k in FIELDS:
                np.testing.assert_array_equal(getattr(got, k),
                                              getattr(want, k), err_msg=k)
        return
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        RandomForestClassifier(n_estimators=2, device="cpu",
                               **{param: value}).fit(X, y)


def test_streamed_dataset_refused():
    """Streaming is ported (item 16): what ``dataset=`` refuses now is
    anything but a StreamedDataset, and X beside one."""
    from mpitree_tpu_torch import StreamedDataset

    X, y = covtype_like(100, seed=0)
    with pytest.raises(TypeError, match="must be a .*StreamedDataset"):
        RandomForestClassifier(n_estimators=2, device="cpu").fit(
            X, y, dataset=object())
    with pytest.raises(ValueError, match="not both"):
        RandomForestClassifier(n_estimators=2, device="cpu").fit(
            X, dataset=StreamedDataset.from_arrays(X, y))

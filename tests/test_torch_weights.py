"""Fractional weights and ``class_weight`` on the CPU, against the JAX package.

A fractionally weighted fit takes the histogram's fixed-point route
(``ops/hist_kernel.py``): its class counts are exact float64 sums, and the
device engine ranks splits with the host tier's formula.

- **F1** (``ROADMAP.md`` Queue 3): at ``backend=None`` the JAX package sends
  a fit of at most 2**19 cells to its host tier (exact float64 counts, the
  C++ sweep); the port keeps it on its device engine. On
  ``covtype_like(6_000, seed=3)`` with weights uniform on [0.5, 2) the two
  defaults must be the same tree field for field, at ``refine_depth=None``
  and at the default ``refine_depth``. The one residual allowed is an exact
  tie: a first divergent node whose two candidates' float64 costs are
  within 1e-12 relative (the C++ sweep keeps the first of two such costs).
- **F2**: against the JAX device engine (``backend="cpu"``, float32
  counts) on ``covtype_like(12_000, seed=0)``: identical structure and
  ``n_node_samples``, and counts within float32 rounding, i.e. float32
  recursive summation's bound ``rows * 2**-24 * sum(counts)`` per node
  (rows <= 2 * (weight + 1) with weights >= 0.5). ``n_node_samples`` is
  the weighted count truncated to an integer, so where the exact weight
  lies within that bound of an integer the two may differ by one (a
  balanced ``class_weight`` makes the root's weight exactly ``N``). At
  ``max_depth=10`` without the tail the trees first differ at an exact tie
  (two candidates whose exact costs are equal): the port takes the first,
  JAX's float32 counts break the tie the other way. That node is held to
  the tie rule, and the nodes before it to F2.
- ``class_weight``: the sample weights equal sklearn's
  ``compute_sample_weight`` (the port reimplements it: the machine with
  the card has no sklearn), and a balanced fit equals JAX's under F2.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
pytest.importorskip("sklearn")

from mpitree_tpu_torch.ops import hist_kernel  # noqa: E402
from mpitree_tpu_torch.ops import histogram as ph  # noqa: E402
from mpitree_tpu_torch.ops import impurity as pimp  # noqa: E402
from mpitree_tpu_torch.ops.binning import bin_dataset  # noqa: E402
from mpitree_tpu_torch.ops.predict import descend  # noqa: E402
from mpitree_tpu_torch.tree import DecisionTreeClassifier  # noqa: E402
from mpitree_tpu_torch.utils.datasets import covtype_like  # noqa: E402
from mpitree_tpu_torch.utils.validation import (  # noqa: E402
    apply_class_weight,
    compute_sample_weight,
)

FIELDS = ("feature", "threshold", "left", "right", "parent", "depth",
          "value", "count", "n_node_samples", "impurity")
STRUCTURE = ("feature", "threshold", "left", "right", "parent", "depth")


def _weights(n):
    return np.random.default_rng(2).uniform(0.5, 2, n).astype(np.float32)


def _first_difference(a, b, fields):
    n = min(a.n_nodes, b.n_nodes)
    for i in range(n):
        if not all(np.array_equal(getattr(a, k)[i], getattr(b, k)[i],
                                  equal_nan=True) for k in fields):
            return i
    return None if a.n_nodes == b.n_nodes else n


def _exact_costs(X, y, w, tree, node):
    """Exact float64 entropy cost of every (feature, bin) at ``node``, from
    the node's rows (its ancestors are the same in both trees)."""
    t = [torch.from_numpy(np.asarray(v)) for v in
         (tree.feature, tree.threshold, tree.left, tree.right)]
    ids = descend(torch.from_numpy(X), t[0].long(), t[1], t[2].long(),
                  t[3].long(), n_steps=int(tree.depth[node]))
    rows = (ids == node).numpy()
    b = bin_dataset(X, max_bins=256)
    payload = ph.class_payload(torch.from_numpy(y[rows].astype(np.int64)),
                               torch.from_numpy(w[rows]), 7).contiguous()
    se = hist_kernel.fixed_point_exponents(payload)
    hist = hist_kernel.histogram_reference(
        torch.from_numpy(b.x_binned[rows]), payload,
        torch.zeros(int(rows.sum()), dtype=torch.int32), n_slots=1,
        n_bins=b.n_bins, scale_exp=se)
    cost = pimp.cost_sweep_f64(hist, "entropy", se, f64_out=True)[0][0]
    return b, cost


def _assert_tie_at(X, y, w, port, ref, node):
    """Both trees split ``node`` on candidates of equal exact cost (within
    1e-12 relative), and the port's is the first of them."""
    b, cost = _exact_costs(X, y, w, ref, node)

    def cand(tree):
        f = int(tree.feature[node])
        assert f >= 0, "the trees differ in whether the node splits"
        (bin_,) = np.flatnonzero(b.thresholds[f] == tree.threshold[node])
        return f, int(bin_)

    (fp, bp), (fr, br) = cand(port), cand(ref)
    cp, cr = float(cost[fp, bp]), float(cost[fr, br])
    assert abs(cp - cr) <= 1e-12 * max(abs(cp), abs(cr))
    assert (fp, bp) < (fr, br)


def _assert_same_or_tie(X, y, w, port, ref):
    node = _first_difference(port, ref, FIELDS)
    if node is not None:
        _assert_tie_at(X, y, w, port, ref, node)


@pytest.fixture(scope="module")
def f1_data():
    X, y = covtype_like(6_000, seed=3)
    return X, y, _weights(len(y))


@pytest.mark.parametrize("refine_depth", [None, "auto"])
def test_f1_port_default_equals_jax_default(f1_data, refine_depth):
    from mpitree_tpu.tree import DecisionTreeClassifier as JaxTree

    X, y, w = f1_data
    kw = dict(max_depth=12, refine_depth=refine_depth)
    ref = JaxTree(**kw).fit(X, y, sample_weight=w).tree_
    est = DecisionTreeClassifier(device="cpu", **kw).fit(X, y,
                                                         sample_weight=w)
    assert est.fit_stats_["engine"] == "device"
    port = est.tree_
    assert port.count.dtype == ref.count.dtype == np.float64
    _assert_same_or_tie(X, y, w, port, ref)
    # the host tier is the same tree
    host = DecisionTreeClassifier(device="cpu", backend="host", **kw).fit(
        X, y, sample_weight=w)
    assert host.fit_stats_["engine"] == "host"
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(host.tree_, k),
                                      getattr(ref, k), err_msg=k)


@pytest.fixture(scope="module")
def f2_data():
    X, y = covtype_like(12_000, seed=0)
    return X, y, _weights(len(y))


def _assert_f2(port, ref):
    assert port.n_nodes == ref.n_nodes
    for k in STRUCTURE:
        np.testing.assert_array_equal(getattr(port, k), getattr(ref, k),
                                      err_msg=k)
    total = port.count.sum(axis=1)
    bound = 2.0 * (port.n_node_samples + 1) * 2.0 ** -24 * total
    assert (np.abs(port.count - ref.count) <= bound[:, None]).all()
    # the truncated weight: equal, or one apart at an integer's edge
    gap = port.n_node_samples - ref.n_node_samples
    edge = np.abs(total - np.round(total)) <= bound
    assert ((gap == 0) | ((np.abs(gap) == 1) & edge)).all()


@pytest.mark.parametrize("kw", [
    dict(max_depth=14), dict(max_depth=6, refine_depth=None),
], ids=["default-depth14", "device-depth6"])
def test_f2_fractional_weights_against_the_jax_device_engine(f2_data, kw):
    from mpitree_tpu.tree import DecisionTreeClassifier as JaxTree

    X, y, w = f2_data
    ref = JaxTree(backend="cpu", **kw).fit(X, y, sample_weight=w).tree_
    port = DecisionTreeClassifier(device="cpu", **kw).fit(
        X, y, sample_weight=w).tree_
    _assert_f2(port, ref)


def test_f2_deep_device_fit_differs_only_at_an_exact_tie(f2_data):
    from mpitree_tpu.tree import DecisionTreeClassifier as JaxTree

    X, y, w = f2_data
    kw = dict(max_depth=10, refine_depth=None)
    ref = JaxTree(backend="cpu", **kw).fit(X, y, sample_weight=w).tree_
    port = DecisionTreeClassifier(device="cpu", **kw).fit(
        X, y, sample_weight=w).tree_
    node = _first_difference(port, ref, STRUCTURE)
    assert node is not None  # JAX's float32 counts break the tie
    _assert_f2(_head(port, node), _head(ref, node))
    _assert_tie_at(X, y, w, port, ref, node)


def _head(tree, n):
    """The first ``n`` nodes of ``tree``."""
    import dataclasses

    return type(tree)(**{k: v[:n] for k, v in
                         dataclasses.asdict(tree).items()})


@pytest.mark.parametrize("labels", ["int", "str", "digits", "float"])
@pytest.mark.parametrize("class_weight", [
    None, "balanced", {0: 2.0, 3: 0.25}, {}, {1: 3.0, 99: 2.0},
    "uniform",
])
def test_compute_sample_weight_equals_sklearn(class_weight, labels):
    from sklearn.utils.class_weight import compute_sample_weight as sk

    y = np.random.default_rng(0).choice(4, size=500, p=[.6, .25, .1, .05])
    cw = class_weight
    # sklearn looks a dict up by int(label) wherever int() takes the label
    # (strings of digits and non-integral floats too), else by str(label)
    relabel = {"str": lambda k: "abcd"[k] if k < 4 else "z",
               "digits": lambda k: str(k + 1),
               "float": lambda k: k + 0.5}.get(labels)
    if relabel is not None:
        y = np.array([relabel(k) for k in range(4)])[y]
        if isinstance(cw, dict):
            cw = {relabel(k): v for k, v in cw.items()}
    try:
        want = sk(cw, y)
    except (ValueError, TypeError) as e:
        with pytest.raises(ValueError):
            compute_sample_weight(cw, y)
        with pytest.raises(ValueError, match="invalid class_weight"):
            apply_class_weight(cw, np.searchsorted(np.unique(y), y),
                               np.unique(y), None)
        assert str(e)
        return
    got = compute_sample_weight(cw, y)
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, want)


def test_apply_class_weight_equals_jax():
    from mpitree_tpu.utils.validation import apply_class_weight as jax_apply

    y = np.random.default_rng(1).choice(3, size=400, p=[.7, .2, .1])
    classes, y_enc = np.unique(y, return_inverse=True)
    sw = _weights(len(y))
    for cw in ("balanced", {0: 0.5, 2: 4.0}, None):
        for w in (None, sw):
            got = apply_class_weight(cw, y_enc, classes, w)
            want = jax_apply(cw, y_enc, classes, w)
            if want is None:
                assert got is None
                continue
            assert got.dtype == want.dtype == np.float32
            np.testing.assert_array_equal(got, want)


def test_balanced_class_weight_fit_against_jax(f2_data):
    from mpitree_tpu.tree import DecisionTreeClassifier as JaxTree

    X, y, _ = f2_data
    kw = dict(max_depth=14, class_weight="balanced")
    ref = JaxTree(backend="cpu", **kw).fit(X, y).tree_
    est = DecisionTreeClassifier(device="cpu", **kw).fit(X, y)
    assert est.fit_stats_["engine"] == "device"
    _assert_f2(est.tree_, ref)

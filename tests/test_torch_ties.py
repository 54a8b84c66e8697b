"""Exact rational ties between the port's device engine and the JAX
package's default (``ROADMAP.md`` R3, where F3 is closed).

At ``backend=None`` the JAX package sends a fit of at most 2**19 cells to
its host tier; the port keeps every ``backend=None`` fit on its device
engine, which must run on the card unless the caller asks for the CPU.
The two tiers break exact cost ties differently, so on rows where random
splits or bootstrap draws make such ties common the trees may part at one
node. Pinned on the two probes that found it:

- ``covtype_like(8_000, seed=1)``, ``DecisionTreeClassifier(max_depth=12,
  splitter="random", random_state=0, refine_depth=None)``;
- ``covtype_like(6_000, seed=11)``, ``RandomForestClassifier(
  n_estimators=3, max_depth=12, random_state=2, refine_depth=None)``.

For each: the port's ``backend="host"`` equals JAX's ``backend="host"``
field for field; the port's ``backend=None`` equals the JAX default field
for field up to the first node where they differ, and there the two
chosen candidates' exact float64 costs, from the node's rows (weighted by
the tree's bootstrap counts for the forest), differ by at most 1e-12
relative. R3 fixes no order between the two, so none is asserted. A
divergence anywhere without such a tie fails.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from mpitree_tpu_torch.tree import (  # noqa: E402
    DecisionTreeClassifier,
    RandomForestClassifier,
)
from mpitree_tpu_torch.obs import stats_view  # noqa: E402
from mpitree_tpu_torch.utils.datasets import covtype_like  # noqa: E402

from test_torch_weights import (  # noqa: E402
    FIELDS,
    _exact_costs,
    _first_difference,
)

RANDOM_TREE = dict(max_depth=12, splitter="random", random_state=0,
                   refine_depth=None)
FOREST = dict(n_estimators=3, max_depth=12, random_state=2,
              refine_depth=None)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread for this module: under pytest-xdist's parallel
    workers torch's intra-op threads oversubscribe the cores; the trees do
    not depend on the thread count (exact sums)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _assert_tied_at(X, y, w, port, ref, node):
    """Both trees split ``node``, on candidates whose exact float64 costs
    from the node's rows lie within 1e-12 relative of each other."""
    b, cost = _exact_costs(X, y, w, ref, node)

    def cand(tree):
        f = int(tree.feature[node])
        assert f >= 0, f"node {node}: the trees differ in whether it splits"
        (bin_,) = np.flatnonzero(b.thresholds[f] == tree.threshold[node])
        return float(cost[f, int(bin_)])

    cp, cr = cand(port), cand(ref)
    assert abs(cp - cr) <= 1e-12 * max(abs(cp), abs(cr)), (node, cp, cr)


def _same_up_to_a_tie(X, y, w, port, ref) -> int | None:
    node = _first_difference(port, ref, FIELDS)
    if node is not None:
        _assert_tied_at(X, y, w, port, ref, node)
    return node


@pytest.fixture(scope="module")
def random_tree():
    import mpitree_tpu as J

    X, y = covtype_like(8_000, seed=1)
    return X, y, {
        "jax_default": J.DecisionTreeClassifier(**RANDOM_TREE).fit(X, y),
        "jax_host": J.DecisionTreeClassifier(
            backend="host", **RANDOM_TREE).fit(X, y),
        "port_default": DecisionTreeClassifier(
            device="cpu", **RANDOM_TREE).fit(X, y),
        "port_host": DecisionTreeClassifier(
            device="cpu", backend="host", **RANDOM_TREE).fit(X, y),
    }


@pytest.fixture(scope="module")
def forest():
    import mpitree_tpu as J

    X, y = covtype_like(6_000, seed=11)
    # the port's phase A draws, as the forest makes them: one multinomial
    # bootstrap a tree (no feature sampling at max_features=None)
    rng = np.random.default_rng(FOREST["random_state"])
    boots = [rng.multinomial(len(y), np.full(len(y), 1.0 / len(y)))
             .astype(np.float32) for _ in range(FOREST["n_estimators"])]
    return X, y, boots, {
        "jax_default": J.RandomForestClassifier(**FOREST).fit(X, y),
        "jax_host": J.RandomForestClassifier(
            backend="host", **FOREST).fit(X, y),
        "port_default": RandomForestClassifier(
            device="cpu", **FOREST).fit(X, y),
        "port_host": RandomForestClassifier(
            device="cpu", backend="host", **FOREST).fit(X, y),
    }


def test_random_tree_host_tiers_equal(random_tree):
    _, _, fits = random_tree
    assert _first_difference(fits["port_host"].tree_,
                             fits["jax_host"].tree_, FIELDS) is None


def test_random_tree_default_equal_up_to_an_exact_tie(random_tree):
    X, y, fits = random_tree
    port, ref = fits["port_default"], fits["jax_default"]
    assert stats_view(port.fit_report_)["engine"] == "fused"
    node = _same_up_to_a_tie(X, y, np.ones(len(y), np.float32), port.tree_,
                             ref.tree_)
    # the probe's node (depth 8): the pin holds it, not a later one
    assert node == 313 and int(ref.tree_.depth[node]) == 8


@pytest.mark.parametrize("t", range(FOREST["n_estimators"]))
def test_forest_host_tiers_equal(forest, t):
    _, _, _, fits = forest
    assert _first_difference(fits["port_host"].trees_[t],
                             fits["jax_host"].trees_[t], FIELDS) is None


@pytest.mark.parametrize("t", range(FOREST["n_estimators"]))
def test_forest_default_equal_up_to_an_exact_tie(forest, t):
    X, y, boots, fits = forest
    node = _same_up_to_a_tie(X, y, boots[t], fits["port_default"].trees_[t],
                             fits["jax_default"].trees_[t])
    # tree 0 parts at node 91 (depth 6), the others not at all
    assert node == (91 if t == 0 else None)

"""sklearn's ``check_estimator`` battery on the port's forests and boosted
ensembles against the JAX package's (``tests/_torch_sklearn.py``): the
same checks run, the port fails none that the JAX package passes, and the
input contract passes. The single trees are in
``test_torch_sklearn_conformance_trees.py``."""

from __future__ import annotations

import pytest
import torch

pytest.importorskip("jax")
pytest.importorskip("sklearn")

from _torch_sklearn import assert_conformant  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread for this module's fits: under pytest-xdist's
    parallel workers, torch's intra-op threads oversubscribe the cores;
    the trees do not depend on the thread count (exact sums)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", [
    "RandomForestClassifier",
    "RandomForestRegressor",
    "ExtraTreesClassifier",
    "ExtraTreesRegressor",
    "GradientBoostingClassifier",
    "GradientBoostingRegressor",
])
def test_check_estimator_matches_jax(name):
    assert_conformant(name)

"""sklearn's ``check_estimator`` battery on a port estimator and on its JAX
counterpart with the same parameters.

One helper for ``tests/test_torch_sklearn_conformance_*.py``:
:func:`assert_conformant` runs the battery on both (the port at
``device="cpu"``) and holds the port to the JAX package's record: the
same checks in the same order, the port's failures a subset of the JAX
package's (its allowlisted deviations: raw-count ``predict_proba``,
bootstrap forests, ``GradientBoostingClassifier``'s unfitted ``predict``
and one-sample fit), and every check of :data:`CONTRACT` passed.
"""

from __future__ import annotations

import warnings

# The battery's parameters: small models, so a check's many fits stay
# quick on the CPU.
PARAMS = {
    "DecisionTreeClassifier": dict(max_depth=4),
    "ParallelDecisionTreeClassifier": dict(max_depth=4),
    "DecisionTreeRegressor": dict(max_depth=4),
    "RandomForestClassifier": dict(n_estimators=3, max_depth=3),
    "RandomForestRegressor": dict(n_estimators=3, max_depth=3),
    "ExtraTreesClassifier": dict(n_estimators=3, max_depth=3),
    "ExtraTreesRegressor": dict(n_estimators=3, max_depth=3),
    "GradientBoostingClassifier": dict(max_iter=5, max_depth=3),
    "GradientBoostingRegressor": dict(max_iter=5, max_depth=3),
}

# The input contract the port's validation carries without sklearn: each
# of these must pass on every port estimator.
CONTRACT = (
    "check_estimators_unfitted",
    "check_complex_data",
    "check_dtype_object",
    "check_estimator_sparse_tag",
    "check_estimator_sparse_array",
    "check_estimator_sparse_matrix",
    "check_supervised_y_2d",
    "check_fit2d_predict1d",
    "check_requires_y_none",
)


def battery(estimator) -> list:
    """``check_estimator(..., on_fail=None)``'s records, warnings off."""
    from sklearn.utils.estimator_checks import check_estimator

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return check_estimator(estimator, on_fail=None)


def _failed(results) -> set:
    return {r["check_name"] for r in results
            if r["status"] not in ("passed", "skipped")}


def assert_conformant(name: str) -> None:
    import mpitree_tpu
    import mpitree_tpu_torch.tree as port

    params = PARAMS[name]
    got = battery(getattr(port, name)(**params, device="cpu"))
    want = battery(getattr(mpitree_tpu, name)(**params))
    assert [r["check_name"] for r in got] == [r["check_name"] for r in want]
    extra = _failed(got) - _failed(want)
    assert not extra, [
        (r["check_name"], str(r.get("exception"))[:300]) for r in got
        if r["check_name"] in extra]
    status = {}
    for r in got:
        status.setdefault(r["check_name"], set()).add(r["status"])
    assert {c: status.get(c) for c in CONTRACT} == {
        c: {"passed"} for c in CONTRACT}
    assert sum(r["status"] == "passed" for r in got) >= 55

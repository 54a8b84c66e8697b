"""The port's sklearn estimator surface against the JAX package's.

- sklearn's tags (``get_tags``) equal the JAX counterpart's for all nine
  estimators; ``is_classifier``/``is_regressor``, ``check_is_fitted``
  before and after ``fit``, and ``repr`` equal to the JAX package's;
- ``make_pipeline``, ``GridSearchCV`` and ``cross_val_score`` run every
  estimator; on ``DecisionTreeClassifier`` with integer weights the scores
  equal the JAX package's exactly (the trees are equal field for field);
- the fitted attributes ``feature_names_in_``, ``n_features_in_``,
  ``n_outputs_``, ``n_classes_``, ``max_features_`` and ``classes_`` equal
  the JAX package's after a DataFrame fit, an array refit and a streamed
  fit, and model files written by either package keep the names and
  ``max_features_`` in the other;
- the JAX package's ``tests/test_sklearn_compat.py`` fitted-surface and
  predict-time name checks, on every estimator;
- the port's refusals, its ``NotFittedError`` and ``DataConversionWarning``
  are sklearn's where sklearn is loaded, and fit, predict, ``repr`` and a
  refusal leave sklearn unimported where the caller never imported it.
"""

from __future__ import annotations

import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
pd = pytest.importorskip("pandas")
sklearn = pytest.importorskip("sklearn")

import mpitree_tpu  # noqa: E402
import mpitree_tpu_torch.tree as port  # noqa: E402
from sklearn.base import clone, is_classifier, is_regressor  # noqa: E402
from sklearn.exceptions import (  # noqa: E402
    DataConversionWarning,
    NotFittedError,
)
from sklearn.model_selection import (  # noqa: E402
    GridSearchCV,
    cross_val_score,
)
from sklearn.pipeline import make_pipeline  # noqa: E402
from sklearn.preprocessing import StandardScaler  # noqa: E402
from sklearn.utils import get_tags  # noqa: E402
from sklearn.utils.validation import check_is_fitted  # noqa: E402

from mpitree_tpu_torch.utils import serialize as port_files  # noqa: E402
from mpitree_tpu_torch.utils import validation  # noqa: E402

REPO = Path(__file__).resolve().parents[1]

# Every estimator with small parameters; max_features="sqrt" where the
# estimator has it, so that max_features_ differs from the width.
PARAMS = {
    "DecisionTreeClassifier": dict(max_depth=3, max_features="sqrt",
                                   random_state=0),
    "ParallelDecisionTreeClassifier": dict(max_depth=3),
    "DecisionTreeRegressor": dict(max_depth=3, max_features="sqrt",
                                  random_state=0),
    "RandomForestClassifier": dict(n_estimators=3, max_depth=3,
                                   max_features="sqrt", random_state=0),
    "RandomForestRegressor": dict(n_estimators=3, max_depth=3,
                                  random_state=0),
    "ExtraTreesClassifier": dict(n_estimators=3, max_depth=3,
                                 random_state=0),
    "ExtraTreesRegressor": dict(n_estimators=3, max_depth=3,
                                max_features=2, random_state=0),
    "GradientBoostingClassifier": dict(max_iter=3, max_depth=3,
                                       random_state=0),
    "GradientBoostingRegressor": dict(max_iter=3, max_depth=3,
                                      random_state=0),
}
NAMES = sorted(PARAMS)
ATTRS = ("feature_names_in_", "n_features_in_", "n_outputs_", "n_classes_",
         "max_features_", "classes_")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread for this module's fits: under pytest-xdist's
    parallel workers, torch's intra-op threads oversubscribe the cores;
    the trees do not depend on the thread count (exact sums)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port(name, **kw):
    return getattr(port, name)(**{**PARAMS[name], **kw}, device="cpu")


def _jax(name, **kw):
    return getattr(mpitree_tpu, name)(**{**PARAMS[name], **kw})


def _frame(seed=0, n=120, columns=("alpha", "beta", "gamma")):
    rng = np.random.default_rng(seed)
    X = pd.DataFrame(rng.normal(size=(n, len(columns))),
                     columns=list(columns))
    return X


def _target(name, X):
    """Two classes for the classifiers, a smooth target for the
    regressors."""
    a = np.asarray(X)[:, 0]
    if "Classifier" in name:
        return (a > 0).astype(np.int64)
    return a * 2.0 + np.asarray(X)[:, 1]


def _attrs(est) -> dict:
    return {a: getattr(est, a) for a in ATTRS if hasattr(est, a)}


def _assert_same_attrs(got, want):
    g, w = _attrs(got), _attrs(want)
    assert sorted(g) == sorted(w)
    for a in w:
        np.testing.assert_array_equal(g[a], w[a], err_msg=a)
    if "feature_names_in_" in w:
        assert g["feature_names_in_"].dtype == object


# -- protocol ---------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_tags_equal_jax(name):
    assert get_tags(_port(name)) == get_tags(_jax(name))
    assert is_classifier(_port(name)) == ("Classifier" in name)
    assert is_regressor(_port(name)) == ("Regressor" in name)
    # what sklearn before 1.6 reads in place of the tags
    assert _port(name)._estimator_type == get_tags(_jax(name)).estimator_type


@pytest.mark.parametrize("name", NAMES)
def test_check_is_fitted_before_and_after_fit(name):
    est = _port(name)
    assert est.__sklearn_is_fitted__() is False
    with pytest.raises(NotFittedError):
        check_is_fitted(est)
    with pytest.raises(NotFittedError):
        est.predict(np.zeros((2, 3)))
    X = _frame()
    est.fit(X, _target(name, X))
    assert est.__sklearn_is_fitted__() is True
    check_is_fitted(est)


@pytest.mark.parametrize("name,params", [
    ("DecisionTreeClassifier", {}),
    ("DecisionTreeClassifier", dict(max_depth=4)),
    ("DecisionTreeClassifier", dict(criterion="gini", class_weight={
        1: 2.0, 0: 1.0}, max_features="sqrt", ccp_alpha=0.01,
        min_samples_leaf=5, max_bins=64, random_state=0)),
    ("DecisionTreeRegressor", dict(max_depth=None, refine_depth=None)),
    ("RandomForestClassifier", dict(n_estimators=3, max_depth=3)),
    ("ExtraTreesRegressor", dict(bootstrap=True, oob_score=True)),
    ("GradientBoostingClassifier", dict(max_iter=5, learning_rate=0.3,
                                        subsample=0.8)),
    ("ParallelDecisionTreeClassifier", dict(n_devices=None)),
])
def test_repr_equals_jax(name, params):
    assert repr(getattr(port, name)(**params)) == repr(
        getattr(mpitree_tpu, name)(**params))


# -- meta-estimators ----------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_pipeline_grid_search_and_cross_val_run(name):
    X = _frame(n=90).to_numpy()
    y = _target(name, X)
    pipe = make_pipeline(StandardScaler(), _port(name)).fit(X, y)
    assert pipe.predict(X).shape == (90,)
    grid = GridSearchCV(_port(name), {"max_depth": [2, 3]}, cv=3).fit(X, y)
    assert grid.best_params_["max_depth"] in (2, 3)
    check_is_fitted(grid.best_estimator_)
    scores = cross_val_score(_port(name), X, y, cv=3)
    assert scores.shape == (3,) and np.isfinite(scores).all()
    assert type(clone(_port(name))) is type(_port(name))


def test_meta_estimator_scores_equal_jax_with_integer_weights():
    rng = np.random.default_rng(3)
    X = rng.normal(size=(150, 4))
    y = (X[:, 0] + 0.5 * X[:, 1] > 0).astype(int) + (X[:, 2] > 1)
    w = rng.integers(1, 4, size=150).astype(np.float64)
    ours = port.DecisionTreeClassifier(device="cpu")
    theirs = mpitree_tpu.DecisionTreeClassifier()
    grid = {"max_depth": [2, 3, 5]}
    got = GridSearchCV(ours, grid, cv=3).fit(X, y, sample_weight=w)
    want = GridSearchCV(theirs, grid, cv=3).fit(X, y, sample_weight=w)
    np.testing.assert_array_equal(got.cv_results_["mean_test_score"],
                                  want.cv_results_["mean_test_score"])
    assert got.best_params_ == want.best_params_
    np.testing.assert_array_equal(
        cross_val_score(make_pipeline(StandardScaler(), ours), X, y, cv=4,
                        params={"decisiontreeclassifier__sample_weight": w}),
        cross_val_score(make_pipeline(StandardScaler(), theirs), X, y,
                        cv=4,
                        params={"decisiontreeclassifier__sample_weight": w}))


# -- fitted attributes (F9) ---------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_fitted_attributes_equal_jax(name):
    X = _frame()
    y = _target(name, X)
    ours, theirs = _port(name), _jax(name)
    _assert_same_attrs(ours.fit(X, y), theirs.fit(X, y))
    assert list(ours.feature_names_in_) == ["alpha", "beta", "gamma"]
    # an array refit deletes the names, as sklearn does
    _assert_same_attrs(ours.fit(X.to_numpy(), y),
                       theirs.fit(X.to_numpy(), y))
    assert not hasattr(ours, "feature_names_in_")
    ours.fit(X, y)
    theirs.fit(X, y)
    ds_ours = port.StreamedDataset.from_arrays(
        X.to_numpy(), y, chunk_rows=50)
    ds_theirs = mpitree_tpu.StreamedDataset.from_arrays(
        X.to_numpy(), y, chunk_rows=50)
    _assert_same_attrs(ours.fit(ds_ours), theirs.fit(ds_theirs))
    assert not hasattr(ours, "feature_names_in_")


@pytest.mark.parametrize("name", NAMES)
def test_model_files_keep_names_both_ways(name, tmp_path):
    X = _frame(seed=1)
    y = _target(name, X)
    ours = _port(name).fit(X, y)
    port_files.save_model(ours, tmp_path / "ours")
    back = mpitree_tpu.load_model(tmp_path / "ours")
    _assert_same_attrs(back, ours)
    again = port_files.load_model(tmp_path / "ours", device="cpu")
    _assert_same_attrs(again, ours)
    np.testing.assert_array_equal(again.predict(X), ours.predict(X))

    theirs = _jax(name).fit(X, y)
    mpitree_tpu.save_model(theirs, tmp_path / "theirs")
    loaded = port_files.load_model(tmp_path / "theirs", device="cpu")
    _assert_same_attrs(loaded, theirs)
    assert list(loaded.feature_names_in_) == ["alpha", "beta", "gamma"]


# -- the JAX package's tests/test_sklearn_compat.py:75-127 -------------------

@pytest.mark.parametrize("name", NAMES)
def test_fitted_attribute_surface(name):
    X = _frame(seed=0, n=80)
    y = _target(name, X)
    est = _port(name).fit(X, y)
    assert est.feature_names_in_.tolist() == ["alpha", "beta", "gamma"]
    assert est.n_outputs_ == 1 and est.n_features_in_ == 3
    if "Classifier" in name:
        assert est.n_classes_ == 2
    if hasattr(est, "max_features"):
        assert est.max_features_ == (
            {None: 3, "sqrt": 1, 2: 2}[est.max_features])
    else:
        assert not hasattr(est, "max_features_")
    est.fit(X.to_numpy(), y)
    assert not hasattr(est, "feature_names_in_")


@pytest.mark.parametrize("name", NAMES)
def test_predict_feature_name_checks(name):
    X = _frame(seed=1, n=60, columns=("a", "b", "c"))
    y = _target(name, X)
    est = _port(name).fit(X, y)
    with pytest.raises(ValueError, match="should match"):
        est.predict(X[["b", "a", "c"]])
    with pytest.warns(UserWarning, match="does not have valid feature"):
        est.predict(X.to_numpy())
    unnamed = _port(name).fit(X.to_numpy(), y)
    with pytest.warns(UserWarning, match="fitted without feature names"):
        unnamed.predict(X)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        est.predict(X)  # matching names: silent
    mixed = pd.DataFrame(X.to_numpy(), columns=["a", "b", 3])
    with pytest.raises(TypeError, match="mixed types"):
        est.predict(mixed)
    with pytest.raises(TypeError, match="mixed types"):
        _port(name).fit(mixed, y)


# -- refusals and sklearn's exception types ---------------------------------

def _refusals(est, X, y):
    from scipy import sparse

    yield (TypeError, "Sparse data was passed", lambda: est.fit(
        sparse.csr_matrix(X), y))
    yield (ValueError, "Complex data not supported", lambda: est.fit(
        X + 1j, y))
    yield (ValueError, "Reshape your data", lambda: est.fit(X[:, 0], y))
    yield (ValueError, "requires y to be passed", lambda: est.fit(X, None))
    obj = X.astype(object)
    obj[0, 0] = {"foo": "bar"}
    yield (TypeError, "argument must be a string or a real number",
           lambda: est.fit(obj, y))
    yield (ValueError, "y should be a 1d array", lambda: est.fit(
        X, np.stack([y, y], axis=1)))


@pytest.mark.parametrize("name", NAMES)
def test_refusals_match_jax(name):
    X = _frame(n=40).to_numpy()
    y = _target(name, X)
    for (typ, msg, call), (_, _, jcall) in zip(
            _refusals(_port(name), X, y), _refusals(_jax(name), X, y)):
        with pytest.raises(typ, match=msg):
            call()
        with pytest.raises(typ):
            jcall()
    est = _port(name).fit(X, y)
    with pytest.raises(ValueError, match="Reshape your data"):
        est.predict(X[0])
    with pytest.warns(DataConversionWarning, match="column-vector y"):
        twice = _port(name).fit(X, y[:, None])
    np.testing.assert_array_equal(twice.predict(X), est.predict(X))


def test_exception_classes_are_sklearns_and_the_ports():
    err = port.DecisionTreeClassifier(device="cpu")._not_fitted()
    assert isinstance(err, NotFittedError)
    assert isinstance(err, validation.NotFittedError)
    assert isinstance(err, ValueError) and isinstance(err, AttributeError)
    assert validation.sklearn_flavoured(validation.NotFittedError) is type(err)
    cls = validation.sklearn_flavoured(validation.DataConversionWarning)
    assert issubclass(cls, DataConversionWarning)
    assert issubclass(cls, validation.DataConversionWarning)


_PROBE = """
import sys, warnings
import numpy as np
from mpitree_tpu_torch.tree import (
    DecisionTreeClassifier, GradientBoostingRegressor)
from mpitree_tpu_torch.utils.validation import (
    DataConversionWarning, NotFittedError)
rng = np.random.default_rng(0)
X = rng.normal(size=(60, 3)); y = (X[:, 0] > 0).astype(int)
class Frame:
    columns = ["a", "b", "c"]
    def __init__(self, a): self.a = a
    def __array__(self, dtype=None, copy=None): return self.a
try:
    DecisionTreeClassifier(device="cpu").predict(X)
except NotFittedError as e:
    assert type(e) is NotFittedError
clf = DecisionTreeClassifier(max_depth=3, device="cpu").fit(Frame(X), y)
with warnings.catch_warnings(record=True) as w:
    warnings.simplefilter("always")
    clf.predict(X)
    DecisionTreeClassifier(device="cpu").fit(X, y[:, None])
assert [type(x.message) for x in w] == [UserWarning, DataConversionWarning]
assert repr(clf) == "DecisionTreeClassifier(device='cpu', max_depth=3)", repr(clf)
assert list(clf.feature_names_in_) == ["a", "b", "c"]
GradientBoostingRegressor(max_iter=2, device="cpu").fit(X, X[:, 1])
for bad in (X + 1j, X[:, 0]):
    try:
        clf.fit(bad, y)
    except ValueError:
        pass
print(",".join(sorted(m for m in sys.modules
                      if m == "sklearn" or m.startswith("sklearn."))))
"""


def test_surface_leaves_sklearn_unimported():
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=REPO, capture_output=True,
        text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""

"""Model files shared with the JAX package, and the rest of the tree
surface (``decision_path``, ``export_dot``, ``nodes_``), on the CPU.

A file that ``mpitree_tpu.save_model`` writes loads with
``mpitree_tpu_torch.load_model`` and predicts bit for bit as the JAX
estimator, and a file the port writes loads in the JAX package and
predicts bit for bit as the port's estimator, for the six tree and forest
classes; a loaded forest compiles and serves. ``ParallelDecisionTreeClassifier``
files are refused, naming their item (gradient-boosted files cross both
ways: ``tests/test_torch_boosting_serve.py``).
The JAX fits run its host tier (``backend="host"``) on 300 rows, so no
XLA program is compiled for them.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest

pytest.importorskip("jax")

import mpitree_tpu_torch as P  # noqa: E402
from mpitree_tpu_torch.core.tree_struct import BranchType, Node  # noqa: E402
from mpitree_tpu_torch.utils.carry import tree_from_reference  # noqa: E402

NAMES = ("DecisionTreeClassifier", "DecisionTreeRegressor",
         "RandomForestClassifier", "RandomForestRegressor",
         "ExtraTreesClassifier", "ExtraTreesRegressor")
PARAMS = {
    "DecisionTreeClassifier": dict(max_depth=5, monotonic_cst=[1, 0, 0, -1]),
    "DecisionTreeRegressor": dict(max_depth=5, criterion="squared_error"),
    "RandomForestClassifier": dict(n_estimators=3, max_depth=4,
                                   random_state=0),
    "RandomForestRegressor": dict(n_estimators=3, max_depth=4,
                                  random_state=1),
    "ExtraTreesClassifier": dict(n_estimators=3, max_depth=4,
                                 random_state=2,
                                 monotonic_cst=[0, 1, 0, 0]),
    "ExtraTreesRegressor": dict(n_estimators=3, max_depth=4, random_state=3),
}
TREE_FIELDS = ("feature", "threshold", "left", "right", "parent", "depth",
               "value", "count", "n_node_samples", "impurity")


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    X = rng.uniform(-2, 2, size=(300, 4)).astype(np.float32)
    y = (X[:, 0] - 0.5 * X[:, 3] + rng.normal(scale=0.6, size=300) > 0
         ).astype(np.int64)
    yr = X[:, 0] * 2 + np.sin(X[:, 1]) + rng.normal(scale=0.3, size=300)
    return X, y, yr


def _target(name, data):
    X, y, yr = data
    return X, (yr if name.endswith("Regressor") else y)


def _answers(est, X):
    """Every prediction surface of an estimator, as host arrays."""
    out = {"predict": np.asarray(est.predict(X))}
    if hasattr(est, "predict_proba"):
        out["predict_proba"] = np.asarray(est.predict_proba(X))
    return out


def _same_answers(got, want, what):
    assert got.keys() == want.keys(), what
    for k in want:
        assert got[k].dtype == want[k].dtype, (what, k)
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{what} {k}")


def _trees(est):
    return list(est.trees_) if hasattr(est, "trees_") else [est.tree_]


def _same_trees(got, want, what):
    assert len(got) == len(want), what
    for i, (a, b) in enumerate(zip(got, want)):
        for k in TREE_FIELDS:
            x, z = getattr(a, k), getattr(b, k)
            assert x.dtype == z.dtype, (what, i, k)
            np.testing.assert_array_equal(x, z, err_msg=f"{what} {i} {k}")


@pytest.mark.parametrize("name", NAMES)
def test_jax_file_loads_in_the_port(tmp_path, data, name):
    import mpitree_tpu as J

    X, y = _target(name, data)
    ref = getattr(J, name)(backend="host", **PARAMS[name]).fit(X, y)
    J.save_model(ref, tmp_path / "m")
    est = P.load_model(tmp_path / "m.npz", device="cpu")
    assert type(est) is getattr(P, name)
    assert est.device == "cpu"
    _same_trees(_trees(est), _trees(ref), name)
    _same_answers(_answers(est, X), _answers(ref, X), name)
    want = {k: v for k, v in ref.get_params().items()}
    got = est.get_params()
    assert got.pop("device") == "cpu"
    assert got == want


@pytest.mark.parametrize("name", NAMES)
def test_port_file_loads_in_jax(tmp_path, data, name):
    import mpitree_tpu as J

    X, y = _target(name, data)
    est = getattr(P, name)(device="cpu", **PARAMS[name]).fit(X, y)
    P.save_model(est, tmp_path / "m.npz")
    with np.load(tmp_path / "m.npz") as z:
        header = json.loads(bytes(z["__header__"]).decode())
    assert header["format"] == "mpitree_tpu-model" and header["version"] == 1
    assert "device" not in header["params"]
    ref = J.load_model(tmp_path / "m.npz")
    assert type(ref).__name__ == name
    _same_trees(_trees(ref), _trees(est), name)
    _same_answers(_answers(ref, X), _answers(est, X), name)
    again = P.load_model(tmp_path / "m.npz", device="cpu")
    _same_answers(_answers(again, X), _answers(est, X), f"{name} port")


def test_loaded_forest_compiles_and_serves(tmp_path, data):
    """A loaded forest serves as the fitted one; a ``monotonic_cst`` array
    travels in the header as a list, so the loaded forest is constrained
    too (``forest_values``)."""
    X, y, _ = data
    for params in (dict(n_estimators=3, max_depth=4, random_state=0),
                   dict(n_estimators=3, max_depth=4, random_state=0,
                        monotonic_cst=np.array([1, 0, 0, -1]))):
        rf = P.RandomForestClassifier(device="cpu", **params).fit(X, y)
        P.save_model(rf, tmp_path / "rf.npz")
        back = P.load_model(tmp_path / "rf.npz", device="cpu")
        want = P.compile_model(rf).raw(X)
        got = P.compile_model(back)
        assert got.kind == ("forest_values" if "monotonic_cst" in params
                            else "forest_proba")
        np.testing.assert_array_equal(got.raw(X), want)
        np.testing.assert_array_equal(got.predict_proba(X),
                                      rf.predict_proba(X))


def _retagged(tmp_path, data, cls_name, params=None):
    """A JAX classifier file whose header names another class."""
    import mpitree_tpu as J

    X, y, _ = data
    J.save_model(J.DecisionTreeClassifier(max_depth=2, backend="host").fit(
        X, y), tmp_path / "t.npz")
    with np.load(tmp_path / "t.npz") as z:
        arrays = {k: z[k] for k in z.files}
    header = json.loads(bytes(arrays["__header__"]).decode())
    header["class"] = cls_name
    if params is not None:
        header["params"] = params
    arrays["__header__"] = np.frombuffer(json.dumps(header).encode(),
                                         np.uint8)
    np.savez(tmp_path / "t.npz", **arrays)
    return tmp_path / "t.npz"


@pytest.mark.parametrize("cls_name,item", [
    ("ParallelDecisionTreeClassifier", "A5"),
])
def test_later_estimator_files_are_refused(tmp_path, data, cls_name, item):
    path = _retagged(tmp_path, data, cls_name, params={})
    with pytest.raises(NotImplementedError, match=item):
        P.load_model(path, device="cpu")


def test_bad_files_are_refused(tmp_path, data):
    with pytest.raises(ValueError, match="unknown estimator class"):
        P.load_model(_retagged(tmp_path, data, "os.system"), device="cpu")
    with pytest.raises(ValueError, match="not parameters"):
        P.load_model(_retagged(tmp_path, data, "DecisionTreeClassifier",
                               params={"max_depth": 2, "n_jobs": 4}),
                     device="cpu")
    np.savez(tmp_path / "x.npz", a=np.zeros(3))
    with pytest.raises(ValueError, match="not an mpitree_tpu model"):
        P.load_model(tmp_path / "x.npz", device="cpu")
    with pytest.raises(ValueError, match="not fitted"):
        P.save_model(P.DecisionTreeClassifier(device="cpu"),
                     tmp_path / "u.npz")


# -- the tree surface -------------------------------------------------------

@pytest.fixture(scope="module")
def fitted_pairs(data):
    """(JAX estimator, the port's estimator carrying its tree) pairs."""
    import mpitree_tpu as J

    X, y, yr = data
    jc = J.DecisionTreeClassifier(max_depth=5, backend="host").fit(X, y)
    jr = J.DecisionTreeRegressor(max_depth=5, backend="host").fit(X, yr)
    pc = P.DecisionTreeClassifier.from_reference(
        dataclasses.asdict(jc.tree_), jc.classes_, jc.n_features_,
        device="cpu")
    pr = P.DecisionTreeRegressor.from_reference(
        dataclasses.asdict(jr.tree_), jr.n_features_, device="cpu")
    return {"classification": (jc, pc), "regression": (jr, pr)}


@pytest.mark.parametrize("task", ["classification", "regression"])
def test_decision_path_equals_jax(data, fitted_pairs, task):
    from mpitree_tpu.utils.export import tree_decision_path

    X = data[0]
    ref, est = fitted_pairs[task]
    got = est.decision_path(X)
    want = tree_decision_path(ref.tree_, est.apply(X))
    assert got.shape == want.shape == (len(X), est.tree_.n_nodes)
    for k in ("indptr", "indices", "data"):
        a, b = getattr(got, k), getattr(want, k)
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    leaf = est.apply(X)
    assert (got.indices[got.indptr[1:] - 1] == leaf).all()


@pytest.mark.parametrize("task", ["classification", "regression"])
@pytest.mark.parametrize("names", [False, True])
def test_export_dot_equals_jax(fitted_pairs, task, names):
    ref, est = fitted_pairs[task]
    kw = dict(feature_names=['a"1', "b\\2", "c", "d"] if names else None,
              precision=3)
    if task == "classification" and names:
        kw["class_names"] = ["no", "yes"]
    assert est.export_dot(**kw) == ref.export_dot(**kw)
    with pytest.raises(ValueError, match="feature_names"):
        est.export_dot(feature_names=["a"])


def _walk(node, out):
    out.append((node.value, node.threshold, node.depth,
                np.asarray(node.count).tolist(), node.is_leaf,
                None if node.parent is None else node.parent.depth))
    for c in node.children:
        _walk(c, out)
    return out


@pytest.mark.parametrize("task", ["classification", "regression"])
def test_nodes_has_jax_structure(fitted_pairs, task):
    ref, est = fitted_pairs[task]
    root = est.nodes_
    assert isinstance(root, Node)
    assert _walk(root, []) == _walk(ref.tree_.to_nodes(), [])
    inner = next(c for c in root.children if not c.is_leaf)
    leaf = Node(value=1)
    assert sorted([leaf, inner])[0] is inner  # the reference's __lt__
    assert inner._btype is BranchType.INTERIOR_LIKE
    assert leaf._btype is BranchType.LEAF_LIKE


def test_carried_tree_from_reference_matches_file(tmp_path, fitted_pairs):
    ref, est = fitted_pairs["classification"]
    P.save_model(est, tmp_path / "c.npz")
    back = P.load_model(tmp_path / "c.npz", device="cpu")
    _same_trees([back.tree_],
                [tree_from_reference(dataclasses.asdict(ref.tree_))], "c")

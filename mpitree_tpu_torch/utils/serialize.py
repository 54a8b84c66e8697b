"""Model files: a fitted tree, forest or boosted ensemble in one ``.npz``,
in the JAX package's format.

Counterpart of ``mpitree_tpu/utils/serialize.py``, writing and reading the
same file: a JSON ``__header__`` (``"format": "mpitree_tpu-model"``,
``"version": 1``, the class name, the constructor parameters, the scalar
fitted attributes of ``_SCALAR_ATTRS`` and ``n_trees``), the arrays
``tree{i}/<field>`` of every ``TreeArrays`` field, ``classes_`` and, for a
gradient-boosted ensemble, its baseline margins ``_baseline_raw``
(``:121-122``). A file
that either package writes loads in the other and predicts the same. No
pickle: arrays come from ``np.load(..., allow_pickle=False)`` and the
header is JSON.

Two differences, both about parameters:

- the port's estimators take ``device``, which the JAX constructors do
  not: :func:`save_model` leaves it out of the file, and
  :func:`load_model` takes it as an argument;
- a file's parameter the port's constructor does not know raises
  ``ValueError`` naming it; none is dropped. Parameters the port knows
  are kept as they are (``max_leaf_nodes`` and ``checkpoint`` included:
  a loaded estimator refits with its budget and its checkpoint path).

``ParallelDecisionTreeClassifier`` files go both ways too (the JAX
package writes them, ``:31``). A loaded estimator keeps its
``n_devices`` (a ``(dr, df)`` mesh as the JSON list ``[dr, df]``, which
the port's mesh resolver reads as the tuple), so it predicts on the mesh
that names; the trees of an estimator fitted on any mesh save as the
one-device fit's do.
"""

from __future__ import annotations

import dataclasses
import json
import os
import warnings

import numpy as np

from mpitree_tpu_torch.core.tree_struct import TreeArrays

FORMAT = "mpitree_tpu-model"
VERSION = 1
_TREE_FIELDS = [f.name for f in dataclasses.fields(TreeArrays)]
# The estimators of the JAX format (``:29-39``), all of which the port fits.
_PORTED = (
    "DecisionTreeClassifier",
    "ParallelDecisionTreeClassifier",
    "DecisionTreeRegressor",
    "RandomForestClassifier",
    "RandomForestRegressor",
    "ExtraTreesClassifier",
    "ExtraTreesRegressor",
    "GradientBoostingClassifier",
    "GradientBoostingRegressor",
)
# Classes whose fitted trees live in ``trees_`` (``:41``).
_ENSEMBLE_PREFIXES = ("RandomForest", "ExtraTrees", "GradientBoosting")
# Scalar fitted attributes carried in the header (``:46-49``), written
# and read when the estimator has them.
_SCALAR_ATTRS = (
    "n_features_", "n_features_in_", "_y_mean", "n_classes_",
    "n_outputs_", "max_features_", "n_iter_", "n_trees_per_iteration_",
)


def _npz_path(path) -> str:
    """``np.savez`` appends ``.npz``; save and load agree on the name."""
    path = os.fspath(path)
    return path if path.endswith(".npz") else path + ".npz"


def _json_params(params: dict) -> dict:
    """Constructor parameters as JSON values (numpy scalars unwrapped,
    arrays such as a ``monotonic_cst`` as lists, which either package's
    constructor takes); a parameter JSON cannot hold (a
    ``np.random.Generator`` random_state) is left out with a warning, and
    the loaded estimator takes the class default, as the JAX package
    does."""
    out = {}
    for k, v in params.items():
        if isinstance(v, (np.generic, np.ndarray)):
            v = v.tolist()
        try:
            json.dumps(v)
        except TypeError:
            warnings.warn(
                f"save_model: dropping non-serializable param {k}={v!r}; "
                "the loaded estimator will use the class default",
                stacklevel=3,
            )
            continue
        out[k] = v
    return out


def _classes() -> dict:
    from mpitree_tpu_torch import tree

    return {name: getattr(tree, name) for name in _PORTED}


def save_model(estimator, path) -> None:
    """Write a fitted tree, forest or boosted ensemble to ``path``
    (``.npz`` appended when missing) in the JAX package's format, without
    its ``device``."""
    name = type(estimator).__name__
    if name not in _PORTED:
        raise ValueError(f"cannot serialize {name!r}")
    params = estimator.get_params()
    params.pop("device", None)
    header = {
        "format": FORMAT,
        "version": VERSION,
        "class": name,
        "params": _json_params(params),
        "attrs": {a: getattr(estimator, a) for a in _SCALAR_ATTRS
                  if hasattr(estimator, a)},
    }
    arrays: dict = {}
    if hasattr(estimator, "classes_"):
        arrays["classes_"] = np.asarray(estimator.classes_)
    if hasattr(estimator, "_baseline_raw"):  # boosting: (K,) float64
        arrays["_baseline_raw"] = np.asarray(estimator._baseline_raw)
    if hasattr(estimator, "trees_"):
        trees = list(estimator.trees_)
    elif hasattr(estimator, "tree_"):
        trees = [estimator.tree_]
    else:
        raise ValueError("estimator is not fitted (no tree_/trees_)")
    header["n_trees"] = len(trees)
    for i, t in enumerate(trees):
        arrays.update({f"tree{i}/{k}": getattr(t, k) for k in _TREE_FIELDS})
    arrays["__header__"] = np.frombuffer(json.dumps(header).encode(),
                                         dtype=np.uint8)
    np.savez(_npz_path(path), **arrays)


def load_model(path, *, device=None):
    """The fitted estimator a model file holds, from either package, with
    ``device`` (``None`` = ``"cuda"``, as the estimators take it) for its
    predict and serving. Trees keep the file's arrays and dtypes; an
    ensemble's trees come as the ``TreeList`` a fit leaves in
    ``trees_``."""
    from mpitree_tpu_torch.serving.tables import TreeList

    with np.load(_npz_path(path), allow_pickle=False) as z:
        if "__header__" not in z.files:
            raise ValueError(f"{path!r} is not an mpitree_tpu model file")
        header = json.loads(bytes(z["__header__"]).decode())
        if header.get("format") != FORMAT:
            raise ValueError(f"{path!r} is not an mpitree_tpu model file")
        if header.get("version") != VERSION:
            raise ValueError(
                f"{path!r}: model file version {header.get('version')!r}, "
                f"this package reads version {VERSION}")
        name = header["class"]
        classes = _classes()
        if name not in classes:
            raise ValueError(f"unknown estimator class {name!r}")
        cls = classes[name]
        params = dict(header["params"])
        unknown = sorted(set(params) - set(cls._param_names()))
        if unknown:
            raise ValueError(
                f"{path!r}: {name} parameters {unknown} are not "
                "parameters of the port's estimator")
        est = cls(**params, device=device)
        attrs = header.get("attrs", {})
        for a in _SCALAR_ATTRS:
            if a in attrs:
                setattr(est, a, attrs[a])
        if "feature_names_in_" in attrs:
            est.feature_names_in_ = np.asarray(attrs["feature_names_in_"],
                                               dtype=object)
        if "classes_" in z.files:
            est.classes_ = z["classes_"]
        if "_baseline_raw" in z.files:
            est._baseline_raw = z["_baseline_raw"]
        trees = [
            TreeArrays(**{k: z[f"tree{i}/{k}"] for k in _TREE_FIELDS
                          if f"tree{i}/{k}" in z.files})
            for i in range(header["n_trees"])
        ]
    if name.startswith(_ENSEMBLE_PREFIXES):
        est.trees_ = TreeList(trees)
    else:
        est.tree_ = trees[0]
    return est

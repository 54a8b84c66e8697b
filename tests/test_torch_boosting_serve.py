"""Boosted models served and carried, on the CPU.

- ``compile_model`` of a boosted classifier (two classes and seven) and
  regressor: kind ``margin``, served by K4's plain version in ``percls``
  mode from the baseline margins, equal to ``decision_function`` /
  ``predict`` bit for bit at every bucket and past the largest; its
  ``predict`` and ``predict_proba`` equal the estimator's; under
  ``quantize="int8"`` (K5's plain version) the served margins stay within
  the exactness report on its calibration batch;
- the traversal's ``baseline`` against the estimator's own accumulation;
- ``save_model``/``load_model`` both ways with the JAX package: trees
  field for field, answers bit for bit, the loaded model served;
- ``boosting_from_reference``: a JAX ensemble's arrays make a port
  estimator that predicts and serves JAX's numbers bit for bit.

The JAX fits are small (1,500 rows, 4 rounds, depth 3), once per module.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import mpitree_tpu_torch as P  # noqa: E402
from mpitree_tpu_torch.serving import quantize, serve_kernel  # noqa: E402
from mpitree_tpu_torch.serving import traversal  # noqa: E402
from mpitree_tpu_torch.utils.carry import boosting_from_reference  # noqa: E402
from mpitree_tpu_torch.utils.datasets import (  # noqa: E402
    california_like,
    covtype_like,
)

FIELDS = ("feature", "threshold", "left", "right", "parent", "depth",
          "value", "count", "n_node_samples", "impurity")
KW = dict(max_iter=4, max_depth=3, subsample=0.8, random_state=3)
KINDS = ("multi", "binary", "reg")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread for this module's fits: under pytest-xdist's
    parallel workers, torch's intra-op threads oversubscribe the cores and
    the many small operations of a boosted fit on the CPU slow down tens
    of times; the results do not depend on the thread count (the sums are
    int64 and the float operations elementwise)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data():
    X, y = covtype_like(1_500, seed=7)
    Xr, yr = california_like(1_500, seed=3)
    return {"multi": (X, y), "binary": (X, (y == 1).astype(np.int64)),
            "reg": (Xr, yr)}


def _name(kind):
    return ("GradientBoostingRegressor" if kind == "reg"
            else "GradientBoostingClassifier")


@pytest.fixture(scope="module")
def models(data):
    """kind -> (port estimator, JAX estimator)."""
    import mpitree_tpu as J

    out = {}
    for kind in KINDS:
        X, y = data[kind]
        out[kind] = (getattr(P, _name(kind))(**KW, device="cpu").fit(X, y),
                     getattr(J, _name(kind))(**KW).fit(X, y))
    return out


def _margins(est, X):
    return (est.decision_function(X) if hasattr(est, "decision_function")
            else est.predict(X))


def _answers(est, X) -> dict:
    out = {"predict": est.predict(X)}
    if hasattr(est, "decision_function"):
        out["decision_function"] = est.decision_function(X)
        out["predict_proba"] = est.predict_proba(X)
    return out


def _same(got: dict, want: dict, what: str) -> None:
    assert got.keys() == want.keys(), what
    for k in want:
        assert got[k].dtype == want[k].dtype, (what, k)
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{what} {k}")


@pytest.mark.parametrize("kind", KINDS)
def test_compiled_margins_equal_the_estimator(models, data, kind):
    est, _ = models[kind]
    X = data[kind][0]
    cm = P.compile_model(est, buckets=(1, 64, 512))
    assert cm.kind == "margin" and cm.n_out == est.n_trees_per_iteration_
    assert cm.dispatch == "plain version of traverse"
    for n in (1, 7, 64, 512, len(X)):  # every bucket, and chunks past it
        if kind == "reg":
            np.testing.assert_array_equal(cm.predict(X[:n]),
                                          est.predict(X[:n]))
        else:
            np.testing.assert_array_equal(cm.decision_function(X[:n]),
                                          est.decision_function(X[:n]))
    np.testing.assert_array_equal(cm.predict(X), est.predict(X))
    if kind == "reg":
        with pytest.raises(AttributeError):
            cm.predict_proba(X[:3])
        with pytest.raises(AttributeError):
            cm.decision_function(X[:3])
    else:
        np.testing.assert_array_equal(cm.predict_proba(X),
                                      est.predict_proba(X))
    assert cm.serve_report_["rows"] >= len(X)


@pytest.mark.parametrize("kind", KINDS)
def test_int8_margins_stay_within_their_report(models, data, kind):
    est, _ = models[kind]
    cm = P.compile_model(est)
    cm8 = P.compile_model(est, quantize="int8", quantize_tol=1.0)
    rep = cm8.serve_report_["quantization"]
    assert rep["ok"] and cm8.dispatch == "plain version of traverse_q"
    cal = quantize.synthesize_calibration(cm8.table, est.n_features_in_)
    delta = float(np.abs(cm8.raw(cal) - cm.raw(cal)).max())
    assert delta <= rep["max_abs_delta"] + 1e-6, (delta, rep)
    assert cm8.raw(data[kind][0][:5]).shape == (5, cm.n_out)


def test_baseline_starts_the_percls_reduction():
    """``accumulate(..., baseline=b)`` adds tree ``t`` into column ``t mod
    K`` of a row that starts at ``b``: the estimator's host loop, in its
    order, so the float64 sums are the same bits."""
    rng = np.random.default_rng(0)
    N, T, K, M = 50, 12, 3, 40
    node = torch.from_numpy(rng.integers(0, M, size=(N, T)))
    vals = torch.from_numpy(rng.normal(size=(M, 1)) * 0.1)
    base = torch.from_numpy(rng.normal(size=K) * 3)
    got = traversal.accumulate(node, vals, agg="percls", n_out=K,
                               baseline=base)
    want = np.tile(base.numpy(), (N, 1))
    for t in range(T):
        want[:, t % K] += vals.numpy()[node.numpy()[:, t], 0]
    np.testing.assert_array_equal(got.numpy(), want)


def test_traverse_refuses_a_misshapen_baseline(models, data):
    est, _ = models["multi"]
    cm = P.compile_model(est)
    X = torch.from_numpy(data["multi"][0][:4])
    kw = dict(n_steps=cm.table.n_steps, agg="percls", n_out=cm.n_out,
              n_features=X.shape[1])
    with pytest.raises(ValueError, match="baseline"):
        serve_kernel.traverse(X, *cm._dev_table, cm._values,
                              baseline=torch.zeros(cm.n_out + 1,
                                                   dtype=torch.float64), **kw)
    with pytest.raises(ValueError, match="baseline"):
        serve_kernel.traverse(X, *cm._dev_table, cm._values,
                              baseline=torch.zeros(cm.n_out), **kw)


@pytest.mark.parametrize("kind", KINDS)
def test_jax_file_loads_in_the_port(tmp_path, models, data, kind):
    import mpitree_tpu as J

    _, ref = models[kind]
    X = data[kind][0]
    J.save_model(ref, tmp_path / "m")
    est = P.load_model(tmp_path / "m.npz", device="cpu")
    assert type(est) is getattr(P, _name(kind))
    for a, b in zip(est.trees_, ref.trees_):
        for k in FIELDS:
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
    np.testing.assert_array_equal(est._baseline_raw, ref._baseline_raw)
    _same(_answers(est, X), _answers(ref, X), kind)
    got = est.get_params()
    assert got.pop("device") == "cpu" and got == ref.get_params()
    np.testing.assert_array_equal(
        _margins(P.compile_model(est), X) if kind != "reg"
        else P.compile_model(est).predict(X), _margins(ref, X))


@pytest.mark.parametrize("kind", KINDS)
def test_port_file_loads_in_jax(tmp_path, models, data, kind):
    import mpitree_tpu as J

    est, _ = models[kind]
    X = data[kind][0]
    P.save_model(est, tmp_path / "m.npz")
    with np.load(tmp_path / "m.npz") as z:
        header = json.loads(bytes(z["__header__"]).decode())
        assert z["_baseline_raw"].dtype == np.float64
    assert header["class"] == _name(kind) and "device" not in header["params"]
    assert header["attrs"]["n_iter_"] == KW["max_iter"]
    ref = J.load_model(tmp_path / "m.npz")
    _same(_answers(ref, X), _answers(est, X), kind)
    again = P.load_model(tmp_path / "m.npz", device="cpu")
    _same(_answers(again, X), _answers(est, X), f"{kind} port")


@pytest.mark.parametrize("kind", KINDS)
def test_boosting_from_reference(models, data, kind):
    _, ref = models[kind]
    X = data[kind][0]
    est = boosting_from_reference(
        [dataclasses.asdict(t) for t in ref.trees_], ref._baseline_raw,
        n_features=ref.n_features_in_,
        classes=getattr(ref, "classes_", None),
        params={**ref.get_params(), "device": "cpu"})
    assert type(est) is getattr(P, _name(kind))
    assert est.n_iter_ == ref.n_iter_
    _same(_answers(est, X), _answers(ref, X), kind)
    cm = P.compile_model(est)
    np.testing.assert_array_equal(
        cm.predict(X) if kind == "reg" else cm.decision_function(X),
        _margins(ref, X))
    with pytest.raises(ValueError, match="whole rounds"):
        boosting_from_reference(
            [dataclasses.asdict(t) for t in ref.trees_][:1],
            np.zeros(3), n_features=X.shape[1], classes=np.arange(3))

"""The port's fused boosting rounds (``rounds_per_dispatch=K``) on the CPU.

- ``resolve_rounds_per_dispatch`` equals the JAX package's on a grid of
  loss, classes, early stopping, ``colsample_bytree``, depth, budget and
  pool size: the same K for explicit values and for every blocked
  ``"auto"``, and a raise where JAX raises;
- the device row mask (``ops/sampling.row_subsample_mask_dev``) equals
  the host's bit for bit;
- K = 4 fits against the port's host round loop (``rounds_per_dispatch=1``)
  within 2e-4, the JAX package's own bound
  (``tests/test_leafwise.py:515-527``), for binary logistic and squared
  error, with and without subsampling; two K = 4 fits bit for bit; the
  staged predictions replay the training margins; budgets bind; K > 1
  raises for multiclass, early stopping and ``colsample_bytree``; the
  dispatch bounds of the fixed-point exponents are held.

JAX's fused rounds fail on this container (``ROADMAP.md`` R1), so the
reference of the ensembles is the port's host loop.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import mpitree_tpu_torch as P  # noqa: E402
from mpitree_tpu_torch.boosting import fused_rounds as pfr  # noqa: E402
from mpitree_tpu_torch.obs import stats_view  # noqa: E402
from mpitree_tpu_torch.ops import sampling as psamp  # noqa: E402
from mpitree_tpu_torch.utils.datasets import (  # noqa: E402
    california_like,
    covtype_like,
)

GBF_KW = dict(max_iter=9, max_depth=3, learning_rate=0.3, random_state=0)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread for this module: under pytest-xdist's parallel
    workers torch's intra-op threads oversubscribe the cores; the fits do
    not depend on the thread count (exact sums, elementwise float)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reg_data(n=500, f=8, seed=1):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f)).astype(np.float32)
    y = (X[:, 0] * 2 + np.sin(X[:, 1])
         + 0.1 * rng.normal(size=n)).astype(np.float64)
    return X, y


def _cls_data(n=500, f=8, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f)).astype(np.float32)
    y = ((X[:, 0] + 0.5 * X[:, 1] > 0) ^ (X[:, 2] > 0.7)).astype(np.int64)
    return X, y


# -- the resolution -------------------------------------------------------------

BASE = dict(loss_kind="logistic", loss_K=1, early_stopping=False,
            colsample=1.0, max_depth=3, max_leaf_nodes=None)
GRID = [
    BASE,
    dict(BASE, loss_kind="squared_error"),
    dict(BASE, loss_kind=None, loss_K=3),
    dict(BASE, early_stopping=True),
    dict(BASE, colsample=0.5),
    dict(BASE, max_depth=None),
    dict(BASE, max_depth=None, max_leaf_nodes=31),
    dict(BASE, max_depth=16, n_samples=1_000_000, n_features=54,
         n_bins=256),
    dict(BASE, max_depth=16, max_leaf_nodes=255, n_samples=1_000_000,
         n_features=54, n_bins=256),
    dict(BASE, max_depth=16, max_leaf_nodes=255, n_samples=1_000_000,
         n_features=54, n_bins=256, hist_budget_bytes=1 << 20),
    dict(BASE, max_depth=6, n_samples=581_012, n_features=8, n_bins=256),
]


def _jax_resolve(param, platform, kw):
    from mpitree_tpu.boosting import fused_rounds as jfr

    try:
        return jfr.resolve_rounds_per_dispatch(param, platform=platform,
                                               **kw)
    except ValueError as e:
        return e


def _port_resolve(param, device_type, kw):
    try:
        return pfr.resolve_rounds_per_dispatch(
            param, device_type=device_type, **kw)
    except ValueError as e:
        return e


@pytest.mark.parametrize("i", range(len(GRID)))
@pytest.mark.parametrize("param", ["auto", 1, 4])
def test_resolve_rounds_per_dispatch_equals_jax(i, param, monkeypatch):
    monkeypatch.delenv(pfr.ROUNDS_ENV, raising=False)
    kw = GRID[i]
    want = _jax_resolve(param, "cpu", kw)
    got = _port_resolve(param, "cpu", kw)
    if isinstance(want, ValueError):
        assert isinstance(got, ValueError)
        assert "cannot apply" in str(got) and "cannot apply" in str(want)
        return
    assert got[0] == want[0]
    if param == "auto":
        # on an accelerator JAX engages K = 8 where nothing blocks; the
        # port engages ROUNDS_AUTO, measured on the card (PERF.md)
        k_tpu, reason = _jax_resolve("auto", "tpu", kw)
        k_cuda, _ = _port_resolve("auto", "cuda", kw)
        blocked = k_tpu == 1
        assert k_cuda == (1 if blocked else pfr.ROUNDS_AUTO["cuda"])
        if blocked:
            assert got[1].split("auto: ", 1)[1] == reason.split(
                "auto: ", 1)[1]


def test_resolve_rejects_zero_and_env_steers_auto(monkeypatch):
    with pytest.raises(ValueError, match=">= 1"):
        pfr.resolve_rounds_per_dispatch(0, device_type="cpu", **BASE)
    monkeypatch.setenv(pfr.ROUNDS_ENV, "3")
    k, reason = pfr.resolve_rounds_per_dispatch("auto", device_type="cpu",
                                                **BASE)
    assert k == 3 and "explicit" in reason
    k, reason = pfr.resolve_rounds_per_dispatch(
        "auto", device_type="cpu", **dict(BASE, early_stopping=True))
    assert k == 1 and "overridden" in reason and "early_stopping" in reason
    for bad in ("fast", "0"):
        monkeypatch.setenv(pfr.ROUNDS_ENV, bad)
        k, reason = pfr.resolve_rounds_per_dispatch(
            "auto", device_type="cpu", **BASE)
        assert k == 1 and "invalid" in reason and bad in reason


# -- the device mask ------------------------------------------------------------

@pytest.mark.parametrize("fraction", [0.25, 0.8, 0.999, 1.0])
def test_row_subsample_mask_dev_bit_for_bit(fraction):
    for seed in (0, 7, 2**32 - 1):
        for r in (0, 5, 123):
            want = psamp.row_subsample_mask(seed, r, 10_007, fraction)
            got = psamp.row_subsample_mask_dev(seed, r, 10_007, fraction,
                                               torch.device("cpu"))
            np.testing.assert_array_equal(got.numpy(), want)


# -- the ensembles --------------------------------------------------------------

@pytest.fixture(scope="module")
def fits():
    Xr, yr = _reg_data()
    X, y = _cls_data()
    out = {}
    for name, cls, Xd, yd, kw in (
            ("reg", P.GradientBoostingRegressor, Xr, yr, {}),
            ("reg_sub", P.GradientBoostingRegressor, Xr, yr,
             dict(subsample=0.7)),
            ("bin", P.GradientBoostingClassifier, X, y, {}),
            ("bin_sub", P.GradientBoostingClassifier, X, y,
             dict(subsample=0.75, random_state=7))):
        kk = dict(GBF_KW, **kw)
        out[name] = (Xd, yd,
                     cls(rounds_per_dispatch=4, device="cpu", **kk).fit(Xd, yd),
                     cls(rounds_per_dispatch=1, device="cpu", **kk).fit(Xd, yd))
    return out


def _margins(m, X):
    return m.decision_function(X) if hasattr(m, "classes_") else m.predict(X)


@pytest.mark.parametrize("name", ["reg", "reg_sub", "bin", "bin_sub"])
def test_k4_close_to_host_loop(fits, name):
    X, y, fused, host = fits[name]
    st = stats_view(fused.fit_report_)
    assert st["rounds_per_dispatch"] == {
        "value": 4, "reason": "explicit rounds_per_dispatch=4"}
    assert st["dispatches"] == 3  # ceil(9 / 4)
    assert len(fused.trees_) == len(host.trees_) == 9
    np.testing.assert_allclose(_margins(fused, X), _margins(host, X),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("name", ["reg_sub", "bin_sub"])
def test_two_k4_fits_bit_for_bit(fits, name):
    X, y, fused, _ = fits[name]
    cls = type(fused)
    again = cls(**fused.get_params()).fit(X, y)
    for a, b in zip(again.trees_, fused.trees_):
        for k in ("feature", "threshold", "left", "right", "count", "value",
                  "n_node_samples", "impurity"):
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
    np.testing.assert_array_equal(_margins(again, X), _margins(fused, X))


def test_staged_predictions_replay_training_margins():
    """The trees' float64 leaf values replay the card's float32 division,
    so the staged margins follow the training's float32 carry."""
    from mpitree_tpu_torch.boosting.losses import loss_for
    from mpitree_tpu_torch.core.builder import BuildConfig
    from mpitree_tpu_torch.ops.binning import bin_for_engine

    X, y = _reg_data()
    cpu = torch.device("cpu")
    binned = bin_for_engine(X, max_bins=256, binning="auto", device=cpu)
    loss = loss_for("squared_error", "regression", None)
    raw = np.tile(loss.init_raw(y, None), (len(y), 1))
    trees, scores = [], [-loss.loss(raw, y, None)]
    cfg = BuildConfig(task="gbdt", max_depth=3, min_leaf_rows=20.0,
                      min_child_weight=1e-3)
    pfr.run_fused_rounds(
        binned=binned, packed=None, y_tr=y, sw_tr=None, raw_tr=raw,
        trees=trees, train_scores=scores, max_iter=6, cfg=cfg, seed=0,
        lr=0.3, loss_kind="squared_error", rounds_per_dispatch=4,
        subsample=1.0)
    m = P.GradientBoostingRegressor(max_iter=6, max_depth=3,
                                    learning_rate=0.3, rounds_per_dispatch=4,
                                    device="cpu").fit(X, y)
    stages = list(m.staged_predict(X))
    assert len(stages) == 6
    np.testing.assert_allclose(stages[-1], raw[:, 0], rtol=1e-6, atol=1e-6)
    mse = [float(np.mean((s - y) ** 2)) for s in stages]
    assert mse[-1] < mse[0]
    assert len(scores) == 7 and scores[-1] > scores[0]


def test_fused_rounds_with_leafwise_budget():
    X, y = _cls_data()
    m = P.GradientBoostingClassifier(
        max_iter=6, max_depth=None, max_leaf_nodes=8, random_state=0,
        rounds_per_dispatch=3, device="cpu").fit(X, y)
    assert m.score(X, y) > 0.85
    assert stats_view(m.fit_report_)["dispatches"] == 2
    for t in m.trees_:
        assert int((t.left < 0).sum()) <= 8


@pytest.mark.parametrize("kw,match", [
    (dict(), "multiclass"),
    (dict(early_stopping=True), "early_stopping"),
    (dict(colsample_bytree=0.5), "colsample_bytree"),
])
def test_k_above_one_raises_where_jax_raises(kw, match):
    X, y = covtype_like(600, seed=1)
    if kw:  # binary for the other blockers
        y = (y == np.bincount(y).argmax()).astype(np.int64)
    with pytest.raises(ValueError, match="cannot apply") as e:
        P.GradientBoostingClassifier(max_iter=4, max_depth=3,
                                     rounds_per_dispatch=4, device="cpu",
                                     **kw).fit(X, y)
    assert match in str(e.value)


def test_dispatch_bounds_are_held(monkeypatch):
    """A payload past its dispatch's bounds (here made too tight) would
    make the fixed-point sums inexact: the dispatch raises."""
    monkeypatch.setattr(pfr, "_payload_tops",
                        lambda *a: np.array([1.0, 1e-3, 1e-3]))
    X, y = _reg_data()
    with pytest.raises(RuntimeError, match="bounds"):
        P.GradientBoostingRegressor(max_iter=2, max_depth=2,
                                    rounds_per_dispatch=2,
                                    device="cpu").fit(X, y)


def test_payload_bounds_cover_the_rounds():
    """Squared error: K rounds of a learning rate stay under the
    dispatch's bound on the real fit (no raise), at the largest learning
    rate JAX's tests take."""
    X, y = california_like(1_000, seed=5)
    m = P.GradientBoostingRegressor(max_iter=16, max_depth=4,
                                    learning_rate=1.0, rounds_per_dispatch=8,
                                    device="cpu").fit(X, y)
    assert stats_view(m.fit_report_)["dispatches"] == 2
    assert np.isfinite(m.train_score_).all()

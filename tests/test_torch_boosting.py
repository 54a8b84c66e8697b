"""The port's gradient boosting on the CPU against the JAX package.

- the losses (``init_raw``, ``grad_hess``, ``loss``, ``proba``) and the
  keyed round masks equal the JAX package's bit for bit;
- ``best_split_newton``: on histograms whose every partial sum is exact in
  float32 (dyadic values with few bits) every field of the decision equals
  JAX's; on random histograms the winner is a brute-force float64
  oracle's wherever the two best costs are more than 2**-18 apart,
  relative (the JAX counterpart: ``tests/test_boosting.py:346``);
- the estimators (``device="cpu"``) against JAX's default, which on the
  CPU is the host round loop over float64-accumulated (g, h) histograms:
  every tree field for field and every answer bit for bit for binary and
  regression fits (row and column subsampling, ``sample_weight``,
  ``reg_lambda``, ``min_split_gain``, ``min_child_weight``, early stopping
  with its ``n_iter_`` and ``validation_score_``). A multiclass fit on
  covtype-shaped rows first differs from JAX's at a node whose two
  candidates' float64 costs are equal (a class absent from a node leaves
  every candidate the same Newton gain, and JAX's float32 cumulative
  sums break that tie by rounding): the test holds that node to the
  near-tie rule (2**-18 relative) and every node and tree before it field
  for field; the margins after such a tie are not held to JAX's
  (``ROADMAP.md`` R8);
- the refusals, ``fit_stats_``, the staged surfaces, and accuracy parity
  with sklearn's ``HistGradientBoostingClassifier`` on breast cancer.

JAX's reference fits run once per module (3,000 rows, at most 8 rounds,
depth 4).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
pytest.importorskip("sklearn")

import mpitree_tpu_torch as P  # noqa: E402
from mpitree_tpu_torch.boosting import losses as plosses  # noqa: E402
from mpitree_tpu_torch.obs import stats_view  # noqa: E402
from mpitree_tpu_torch.ops import impurity as pimp  # noqa: E402
from mpitree_tpu_torch.ops import sampling as psamp  # noqa: E402
from mpitree_tpu_torch.utils.datasets import (  # noqa: E402
    california_like,
    covtype_like,
)

FIELDS = ("feature", "threshold", "left", "right", "parent", "depth",
          "value", "count", "n_node_samples", "impurity")
NEAR_TIE = 2.0 ** -18


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
    X, y = covtype_like(3_000, seed=4)
    yb = (y == np.bincount(y).argmax()).astype(np.int64)
    Xr, yr = california_like(3_000, seed=0)
    w = np.random.default_rng(2).uniform(0.5, 2, 3_000).astype(np.float32)
    return {"multi": (X, y), "binary": (X, yb), "reg": (Xr, yr), "w": w}


# (data, estimator parameters, sample_weight?)
CASES = {
    "binary_sub": ("binary", dict(max_iter=8, max_depth=4, subsample=0.8,
                                  colsample_bytree=0.5, random_state=1),
                   False),
    "binary_default": ("binary", dict(max_iter=8, max_depth=4), False),
    "binary_weights": ("binary", dict(max_iter=6, max_depth=4,
                                      reg_lambda=0.5, min_child_weight=0.5),
                       True),
    "binary_early_stop": ("binary", dict(
        max_iter=8, max_depth=4, early_stopping=True, n_iter_no_change=2,
        validation_fraction=0.2, learning_rate=0.5, tol=1e-2,
        random_state=3), False),
    "reg_sub": ("reg", dict(max_iter=8, max_depth=4, subsample=0.8,
                            colsample_bytree=0.5, random_state=2), False),
    "reg_lambda_gain": ("reg", dict(max_iter=8, max_depth=4, reg_lambda=1.0,
                                    min_split_gain=0.01, min_samples_leaf=5),
                        False),
    "reg_weights": ("reg", dict(max_iter=6, max_depth=3, subsample=0.7,
                                random_state=5), True),
}
MULTI = dict(max_iter=8, max_depth=4, subsample=0.8, colsample_bytree=0.5,
             random_state=0)


def _cls(task_data: str, pkg):
    name = ("GradientBoostingRegressor" if task_data == "reg"
            else "GradientBoostingClassifier")
    return getattr(pkg, name)


@pytest.fixture(scope="module")
def fits(data):
    """name -> (port estimator, JAX estimator, X, y, sample_weight)."""
    import mpitree_tpu as J

    out = {}
    for name, (key, kw, weighted) in {**CASES, "multi": (
            "multi", MULTI, False)}.items():
        X, y = data[key]
        sw = data["w"] if weighted else None
        j = _cls(key, J)(**kw).fit(X, y, sample_weight=sw)
        p = _cls(key, P)(**kw, device="cpu").fit(X, y, sample_weight=sw)
        out[name] = (p, j, X, y, sw)
    return out


def _same_tree(got, want, msg=""):
    assert got.n_nodes == want.n_nodes, msg
    for k in FIELDS:
        a, b = getattr(got, k), getattr(want, k)
        assert a.dtype == b.dtype, (msg, k)
        np.testing.assert_array_equal(a, b, err_msg=f"{msg} {k}")


def _answers(est, X) -> dict:
    out = {"predict": est.predict(X)}
    if hasattr(est, "decision_function"):
        out["decision_function"] = est.decision_function(X)
        out["predict_proba"] = est.predict_proba(X)
    return out


# -- losses and masks ---------------------------------------------------------

@pytest.mark.parametrize("kind", ["squared_error", "binary", "multinomial"])
@pytest.mark.parametrize("weighted", [False, True])
def test_losses_equal_jax_bit_for_bit(kind, weighted):
    from mpitree_tpu.boosting import losses as jlosses

    rng = np.random.default_rng(7)
    N = 500
    w = rng.uniform(0.1, 3, N) if weighted else None
    if kind == "squared_error":
        y = rng.normal(size=N) * 3
        pl, jl = plosses.loss_for("squared_error", "regression", None), \
            jlosses.loss_for("squared_error", "regression", None)
        K = 1
    else:
        K = 2 if kind == "binary" else 5
        y = rng.integers(0, K, N)
        pl, jl = (plosses.loss_for("log_loss", "classification", K),
                  jlosses.loss_for("log_loss", "classification", K))
    assert type(pl).__name__ == type(jl).__name__ and pl.K == jl.K
    np.testing.assert_array_equal(pl.init_raw(y, w), jl.init_raw(y, w))
    raw = rng.normal(size=(N, pl.K)) * 4
    for a, b in zip(pl.grad_hess(raw, y), jl.grad_hess(raw, y)):
        np.testing.assert_array_equal(a, b)
    assert pl.loss(raw, y, w) == jl.loss(raw, y, w)
    if kind != "squared_error":
        np.testing.assert_array_equal(pl.proba(raw), jl.proba(raw))


def test_loss_for_refuses_unknown_losses():
    with pytest.raises(ValueError, match="regression loss"):
        plosses.loss_for("huber", "regression", None)
    with pytest.raises(ValueError, match="classification loss"):
        plosses.loss_for("exponential", "classification", 2)


@pytest.mark.parametrize("seed,rnd,frac", [(0, 0, 0.8), (7, 3, 0.5),
                                           (2**32 - 1, 99, 0.1),
                                           (5, 1, 1.0)])
def test_round_masks_equal_jax(seed, rnd, frac):
    from mpitree_tpu.ops import sampling as jsamp

    np.testing.assert_array_equal(
        psamp.row_subsample_mask(seed, rnd, 10_001, frac),
        jsamp.row_subsample_mask(seed, rnd, 10_001, frac))
    np.testing.assert_array_equal(
        psamp.feature_subsample_mask(seed, rnd, 54, frac),
        jsamp.feature_subsample_mask(seed, rnd, 54, frac))
    if frac < 1.0:
        assert psamp.subsample_threshold_u32(frac) == \
            jsamp.subsample_threshold_u32(frac)
    with pytest.raises(ValueError):
        psamp.row_subsample_mask(seed, rnd, 10, 0.0)
    with pytest.raises(ValueError):
        psamp.feature_subsample_mask(seed, rnd, 10, 1.5)


# -- the Newton sweep ---------------------------------------------------------

def _newton_hist(rng, K, F, B, *, bits: int):
    """An int64 fixed-point (count, g, h) histogram whose values carry
    ``bits`` fraction bits (scale 2**bits), so every partial sum is exact
    in float32 when the magnitudes are small; empty cells hold zeros."""
    cnt = rng.integers(0, 6, size=(K, F, B))
    g = rng.integers(-40, 41, size=(K, F, B)) * (cnt > 0)
    h = rng.integers(1, 40, size=(K, F, B)) * (cnt > 0)
    q = np.stack([cnt, g, h], axis=2).astype(np.int64)
    return q, (0, bits, bits)


def _jax_newton(hist32, cand, lam, mcw, msl):
    import jax.numpy as jnp

    from mpitree_tpu.ops.impurity import best_split_newton

    return best_split_newton(
        jnp.asarray(hist32), jnp.asarray(cand),
        reg_lambda=jnp.float32(lam), min_child_weight=jnp.float32(mcw),
        min_samples_leaf=jnp.float32(msl))


@pytest.mark.parametrize("lam,mcw,msl", [(0.0, 0.0, 0.0), (0.5, 0.25, 3.0),
                                         (2.0, 1.0, 1.0)])
def test_newton_sweep_equals_jax_on_exact_sums(lam, mcw, msl):
    rng = np.random.default_rng(11)
    K, F, B = 6, 5, 16
    q, exp = _newton_hist(rng, K, F, B, bits=4)
    cand = rng.random((F, B)) < 0.9
    cand[:, -1] = False
    hist32 = (q * np.array([2.0 ** -e for e in exp])[None, None, :, None]
              ).astype(np.float32)
    got = pimp.best_split_newton(
        torch.from_numpy(q), torch.from_numpy(cand), scale_exp=exp,
        reg_lambda=lam, min_child_weight=mcw, min_samples_leaf=msl)
    want = _jax_newton(hist32, cand, lam, mcw, msl)
    for k in ("feature", "bin", "cost", "impurity", "n", "constant",
              "n_left"):
        np.testing.assert_array_equal(
            getattr(got, k).numpy(), np.asarray(getattr(want, k)),
            err_msg=k)
    np.testing.assert_array_equal(got.counts.numpy(),
                                  np.asarray(want.counts).astype(np.float64))


def test_newton_sweep_matches_a_float64_oracle():
    """Random float (g, h): the winner is the brute-force float64 oracle's
    wherever the best two candidates' costs are more than 2**-18 apart,
    relative; a slot with no valid candidate costs +inf."""
    rng = np.random.default_rng(1)
    K, F, B = 12, 4, 8
    lam = 0.3
    cnt = rng.integers(0, 5, size=(K, F, B)).astype(np.float64)
    g = rng.normal(size=(K, F, B)) * (cnt > 0)
    h = rng.uniform(0.1, 1.0, size=(K, F, B)) * (cnt > 0)
    exp = (0, 40, 40)
    q = np.stack([cnt, np.rint(g * 2.0 ** 40), np.rint(h * 2.0 ** 40)],
                 axis=2).astype(np.int64)
    g, h = q[:, :, 1] * 2.0 ** -40, q[:, :, 2] * 2.0 ** -40
    cand = np.ones((F, B), bool)
    cand[:, -1] = False
    dec = pimp.best_split_newton(torch.from_numpy(q),
                                 torch.from_numpy(cand), scale_exp=exp,
                                 reg_lambda=lam)
    checked = 0
    for k in range(K):
        costs = []
        for f in range(F):
            cl, gl, hl = (np.cumsum(a[k, f]) for a in (cnt, g, h))
            for b in range(B):
                if cand[f, b] and cl[b] > 0 and cl[-1] - cl[b] > 0:
                    costs.append((-0.5 * (
                        gl[b] ** 2 / (hl[b] + lam)
                        + (gl[-1] - gl[b]) ** 2 / (hl[-1] - hl[b] + lam)),
                        f, b))
        if not costs:
            assert np.isinf(float(dec.cost[k]))
            continue
        costs.sort()
        if len(costs) > 1 and (costs[1][0] - costs[0][0]) <= \
                NEAR_TIE * abs(costs[0][0]):
            continue
        assert (int(dec.feature[k]), int(dec.bin[k])) == costs[0][1:], k
        checked += 1
    assert checked >= K // 2


# -- estimators against JAX ---------------------------------------------------

@pytest.mark.parametrize("name", sorted(CASES))
def test_ensemble_equals_jax(fits, name):
    p, j, X, y, sw = fits[name]
    assert p.n_iter_ == j.n_iter_
    assert p.n_trees_per_iteration_ == j.n_trees_per_iteration_
    assert len(p.trees_) == len(j.trees_)
    for i, (a, b) in enumerate(zip(p.trees_, j.trees_)):
        _same_tree(a, b, f"{name} tree {i}")
    np.testing.assert_array_equal(p._baseline_raw, j._baseline_raw)
    np.testing.assert_array_equal(p.train_score_, j.train_score_)
    if j.validation_score_ is None:
        assert p.validation_score_ is None
    else:
        np.testing.assert_array_equal(p.validation_score_,
                                      j.validation_score_)
    got, want = _answers(p, X), _answers(j, X)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert p.score(X, y) == j.score(X, y)


def test_early_stopping_stops_where_jax_does(fits):
    p, j, *_ = fits["binary_early_stop"]
    assert p.n_iter_ < p.max_iter and stats_view(p.fit_report_)["early_stop"]
    assert len(p.validation_score_) == p.n_iter_ + 1


def _rows_at(tree, X, node: int) -> np.ndarray:
    """Rows of X whose descent passes through ``node``."""
    cur = np.zeros(len(X), np.int64)
    hit = cur == node
    for _ in range(max(tree.max_depth, 1)):
        f = tree.feature[cur]
        xf = X[np.arange(len(X)), np.maximum(f, 0)]
        nxt = np.where(xf <= tree.threshold[cur], tree.left[cur],
                       tree.right[cur])
        cur = np.where(f < 0, cur, nxt)
        hit |= cur == node
    return hit


def _first_divergence(got, want):
    """(tree, node) of the first node, in tree order and then id order,
    whose split differs; None when every tree is the same."""
    for t, (a, b) in enumerate(zip(got, want)):
        n = min(a.n_nodes, b.n_nodes)
        diff = np.flatnonzero(
            (a.feature[:n] != b.feature[:n])
            | ~((a.threshold[:n] == b.threshold[:n])
                | (np.isnan(a.threshold[:n]) & np.isnan(b.threshold[:n]))))
        if diff.size or a.n_nodes != b.n_nodes:
            return t, int(diff[0]) if diff.size else n
    return None


def test_multiclass_differs_from_jax_only_after_a_near_tie(fits):
    """The first divergent node of the multiclass fit is a float64 tie
    within 2**-18 (relative) between the port's and JAX's candidates, on
    the round's own (g, h); everything before it is the same."""
    p, j, X, y, _ = fits["multi"]
    assert len(p.trees_) == len(j.trees_)
    where = _first_divergence(p.trees_, j.trees_)
    if where is None:  # no tie met: then the answers are bit for bit
        for k, v in _answers(j, X).items():
            np.testing.assert_array_equal(_answers(p, X)[k], v)
        return
    t, node = where
    for i in range(t):
        _same_tree(p.trees_[i], j.trees_[i], f"tree {i}")
    a, b = p.trees_[t], j.trees_[t]
    for k in ("feature", "threshold", "left", "right", "n_node_samples"):
        np.testing.assert_array_equal(getattr(a, k)[:node],
                                      getattr(b, k)[:node], err_msg=k)
    assert a.feature[node] >= 0 and b.feature[node] >= 0
    # the round's (g, h), from the margins of the rounds before it
    K = p.n_trees_per_iteration_
    r, k = divmod(t, K)
    raw = np.tile(p._baseline_raw, (len(X), 1))
    for i in range(r * K):
        tr = p.trees_[i]
        leaf = np.zeros(len(X), np.int64)
        for _ in range(max(tr.max_depth, 1)):
            f = tr.feature[leaf]
            xf = X[np.arange(len(X)), np.maximum(f, 0)]
            nxt = np.where(xf <= tr.threshold[leaf], tr.left[leaf],
                           tr.right[leaf])
            leaf = np.where(f < 0, leaf, nxt)
        raw[:, i % K] += p.learning_rate * tr.count[leaf, 0]
    g, h = plosses.loss_for("log_loss", "classification", K).grad_hess(
        raw, y)
    mask = psamp.row_subsample_mask(0, r, len(X), MULTI["subsample"])
    g32 = (g[:, k] * mask).astype(np.float32).astype(np.float64)
    h32 = (h[:, k] * mask).astype(np.float32).astype(np.float64)
    rows = _rows_at(a, X, node) & (h32 > 0)

    def cost(f, thr):
        left = rows & (X[:, f] <= thr)
        right = rows & ~(X[:, f] <= thr)
        return -0.5 * sum(g32[s].sum() ** 2 / max(h32[s].sum(), 1e-12)
                          for s in (left, right))

    ca, cb = cost(a.feature[node], a.threshold[node]), \
        cost(b.feature[node], b.threshold[node])
    assert abs(ca - cb) <= NEAR_TIE * max(abs(ca), abs(cb)), (t, node, ca, cb)


def test_refit_is_bit_for_bit(fits):
    """A fit's sums take the fixed-point route (exact int64), so a second
    fit is the same ensemble, bit for bit (card against CPU:
    ``tests/test_torch_cuda.py``)."""
    p, _, X, y, _ = fits["multi"]
    again = P.GradientBoostingClassifier(**MULTI, device="cpu").fit(X, y)
    for a, b in zip(again.trees_, p.trees_):
        _same_tree(a, b)
    np.testing.assert_array_equal(again.decision_function(X),
                                  p.decision_function(X))


# -- the estimator surface ------------------------------------------------------

def test_fit_stats_staged_surfaces_and_params(fits, monkeypatch):
    p, _, X, y, _ = fits["multi"]
    st = stats_view(p.fit_report_)
    assert [r["round"] for r in p.fit_report_["rounds"]] == list(
        range(p.n_iter_))
    # the laps are timed only under MPITREE_TPU_PROFILE=1 (F8): without
    # it fit_stats_ is None and every round row's seconds too; with it the
    # phase summary and the rows' laps, which the old keys read back
    small = dict(max_iter=2, max_depth=3, device="cpu")
    monkeypatch.delenv("MPITREE_TPU_PROFILE", raising=False)
    off = P.GradientBoostingClassifier(**small).fit(X[:600], y[:600])
    assert off.fit_stats_ is None
    for k in ("seconds", "loss_seconds", "build_seconds", "refit_seconds"):
        assert all(r[k] is None for r in off.fit_report_["rounds"]), k
    monkeypatch.setenv("MPITREE_TPU_PROFILE", "1")
    on = P.GradientBoostingClassifier(**small).fit(X[:600], y[:600])
    lap = stats_view(on.fit_report_)
    for k in ("bin_seconds", "loss_seconds", "build_seconds",
              "refit_seconds"):
        assert lap[k] >= 0.0, k
    assert {"bin", "split"} <= set(on.fit_stats_)
    assert st["n_rounds"] == p.n_iter_ == MULTI["max_iter"]
    # a multiclass loss blocks the fused rounds: "auto" stays on the host
    # loop and says why
    assert st["rounds_per_dispatch"]["value"] == 1
    assert "multiclass" in st["rounds_per_dispatch"]["reason"]
    stages = list(p.staged_predict_proba(X))
    assert len(stages) == p.n_iter_
    np.testing.assert_array_equal(stages[-1], p.predict_proba(X))
    np.testing.assert_array_equal(list(p.staged_predict(X))[-1],
                                  p.predict(X))
    reg, _, Xr, _, _ = fits["reg_sub"]
    np.testing.assert_array_equal(list(reg.staged_predict(Xr))[-1],
                                  reg.predict(Xr))
    params = p.get_params()
    assert params["device"] == "cpu" and params["max_iter"] == 8
    import mpitree_tpu as J

    assert set(params) - {"device"} == set(
        J.GradientBoostingClassifier().get_params())
    assert p.set_params(max_iter=3).max_iter == 3
    p.set_params(max_iter=MULTI["max_iter"])


@pytest.mark.parametrize("kw,err,match", [
    (dict(max_leaf_nodes=8, rounds_per_dispatch=4, early_stopping=True),
     ValueError, "cannot apply"),
    (dict(max_leaf_nodes=1), ValueError, "larger than 1"),
    (dict(rounds_per_dispatch=4, colsample_bytree=0.5), ValueError,
     "cannot apply"),
    (dict(rounds_per_dispatch=0), ValueError, "rounds_per_dispatch"),
    (dict(rounds_per_dispatch=2.0), ValueError, "rounds_per_dispatch"),
    # item 17 is ported: boosting takes checkpoint=, and what stays
    # refused is the JAX package's own refusal, a compaction threshold
    # below two shards; the case keeps its id
    pytest.param(dict(checkpoint="ck", checkpoint_compact_every=1),
                 ValueError, "checkpoint_compact_every",
                 id="kw5-NotImplementedError-item 17"),
    # item 14 is ported: boosting takes n_devices, and what stays refused
    # there is the JAX package's own refusal, the fused rounds on a
    # (data, feature) mesh; the case keeps its id
    pytest.param(dict(n_devices=(4, 2), rounds_per_dispatch=4), ValueError,
                 "mesh2d_unsupported",
                 id="kw6-NotImplementedError-item 14"),
    (dict(backend="host"), ValueError, "device engine only"),
    (dict(backend="tpu"), ValueError, "device="),
    (dict(learning_rate=0.0), ValueError, "learning_rate"),
    (dict(subsample=1.5), ValueError, "subsample"),
    (dict(colsample_bytree=0.0), ValueError, "colsample_bytree"),
    (dict(reg_lambda=-1.0), ValueError, "reg_lambda"),
    (dict(checkpoint_every=0), ValueError, "checkpoint_every"),
])
def test_refusals(data, kw, err, match):
    """8 CPU shards, so that kw6's (4, 2) mesh is built and the fused
    rounds refuse it (``fused_rounds.resolve_rounds_per_dispatch``)."""
    from mpitree_tpu_torch.parallel import mesh

    X, y = data["binary"]
    prev = mesh.set_cpu_shards(8)
    try:
        with pytest.raises(err, match=match):
            P.GradientBoostingClassifier(max_iter=1, device="cpu", **kw).fit(
                X[:100], y[:100])
    finally:
        mesh.set_cpu_shards(prev)


def test_refusals_of_data_and_devices(data):
    X, y = data["binary"]
    # streaming is ported (item 16): dataset= takes a StreamedDataset only
    with pytest.raises(TypeError, match="must be a .*StreamedDataset"):
        P.GradientBoostingRegressor(max_iter=1, device="cpu").fit(
            X[:50], y[:50], dataset=object())
    with pytest.raises(ValueError, match="at least 2 classes"):
        P.GradientBoostingClassifier(max_iter=1, device="cpu").fit(
            X[:50], np.zeros(50))
    with pytest.raises(ValueError, match="validation_fraction"):
        P.GradientBoostingClassifier(
            max_iter=1, early_stopping=True, validation_fraction=1.0,
            device="cpu").fit(X[:50], y[:50])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            P.GradientBoostingClassifier(max_iter=1).fit(X[:50], y[:50])
    with pytest.raises(ValueError, match="not fitted|is not fitted"):
        P.GradientBoostingRegressor(device="cpu").predict(X[:5])


def test_nonfinite_gradients_fail_fast(data):
    """Margins that overflow make the next round's (g, h) totals
    non-finite: ``FloatingPointError`` before that round's tree; a
    gradient past float32's range is refused by the fixed-point route
    (``ValueError``) before any launch."""
    X, y = data["reg"]
    yy = y[:200].copy()
    yy[0] = 1e30
    with np.errstate(over="ignore", invalid="ignore"):
        with pytest.raises(FloatingPointError, match="round 1"):
            P.GradientBoostingRegressor(
                max_iter=3, learning_rate=1e300, device="cpu").fit(
                    X[:200], yy)
        yy[0] = 1e300
        with pytest.raises(ValueError, match="NaN or infinity"):
            P.GradientBoostingRegressor(max_iter=1, device="cpu").fit(
                X[:200], yy)


def test_logistic_parity_with_sklearn_hist_gbdt():
    """max_iter=100 on breast cancer within 0.01 accuracy of sklearn's
    HistGradientBoostingClassifier at matched depth and learning rate
    (``tests/test_boosting.py:144-158``)."""
    from sklearn.datasets import load_breast_cancer
    from sklearn.ensemble import HistGradientBoostingClassifier
    from sklearn.model_selection import train_test_split

    Xa, ya = load_breast_cancer(return_X_y=True)
    Xtr, Xte, ytr, yte = train_test_split(Xa, ya, test_size=0.25,
                                          random_state=0)
    sk = HistGradientBoostingClassifier(
        max_iter=100, max_depth=4, learning_rate=0.1, early_stopping=False,
        min_samples_leaf=20).fit(Xtr, ytr)
    ours = P.GradientBoostingClassifier(
        max_iter=100, max_depth=4, learning_rate=0.1, min_samples_leaf=20,
        device="cpu").fit(Xtr, ytr)
    acc_sk = float((sk.predict(Xte) == yte).mean())
    acc_us = float((ours.predict(Xte) == yte).mean())
    assert acc_us >= acc_sk - 0.01, (acc_us, acc_sk)

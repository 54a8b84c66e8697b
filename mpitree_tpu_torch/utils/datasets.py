"""The benchmark generators: covtype-shaped and California-shaped data.

Copies of ``covtype_like`` (``mpitree_tpu/utils/datasets.py:19``): 581,012
x 54 by default, 10 continuous columns with covtype's heterogeneous scales,
4 wilderness + 40 soil one-hot columns from latent categories, and 7
imbalanced classes from noisy axis-aligned rules; and ``california_like``
(``:70``): 20,640 x 8 by default, California housing's eight quantitative
columns and a smooth noisy target (``BASELINE.json`` config 4,
``DecisionTreeRegressor``). Same seed, same arrays as the JAX package's
generators. Both are synthetic: the machine with the card has no network,
so this is the full-size data there.

``load_covtype`` and ``load_california`` (``:105-146``) prefer the real
datasets where scikit-learn has a cached copy (``download_if_missing=
False``: they never download; ``sklearn.datasets`` is imported inside the
call only) and otherwise return the generators' data, under the names
``covtype_like`` and ``california_like``.
"""

from __future__ import annotations

import numpy as np


def covtype_like(n_samples: int = 581012, seed: int = 0):
    """Deterministic covtype-shaped classification problem (n x 54, 7 classes)."""
    rng = np.random.default_rng(seed)
    n = n_samples

    elev = rng.normal(2800, 400, n)
    aspect = rng.uniform(0, 360, n)
    slope = rng.gamma(2.0, 7.0, n)
    h_hydro = rng.gamma(1.5, 180.0, n)
    v_hydro = rng.normal(45, 60, n)
    h_road = rng.gamma(1.8, 1300.0, n)
    hill_9 = np.clip(rng.normal(212, 27, n), 0, 254)
    hill_noon = np.clip(rng.normal(223, 20, n), 0, 254)
    hill_3 = np.clip(rng.normal(143, 38, n), 0, 254)
    h_fire = rng.gamma(1.7, 1100.0, n)
    quant = np.column_stack(
        [elev, aspect, slope, h_hydro, v_hydro, h_road, hill_9, hill_noon,
         hill_3, h_fire]
    )

    wild_logits = rng.normal(size=(n, 4)) + np.column_stack(
        [elev / 400.0, -elev / 800.0, np.zeros(n), np.zeros(n)]
    )
    wild = np.eye(4, dtype=np.float64)[wild_logits.argmax(1)]
    soil_latent = (elev - 1800) / 250.0 + rng.normal(0, 2.0, n)
    soil_idx = np.clip(soil_latent.astype(int) % 40, 0, 39)
    soil = np.zeros((n, 40))
    soil[np.arange(n), soil_idx] = 1.0

    X = np.column_stack([quant, wild, soil]).astype(np.float32)

    score = np.zeros(n)
    score += 2.0 * (elev > 3000)
    score += 1.0 * (elev > 3250)
    score -= 1.5 * (elev < 2400)
    score += 1.0 * (h_hydro < 120)
    score -= 1.0 * (slope > 22)
    score += 0.8 * (hill_noon > 230)
    score += 0.6 * wild[:, 0] - 0.7 * wild[:, 3]
    score += 0.4 * ((soil_idx >= 20) & (soil_idx < 30))
    score += rng.normal(0, 0.55, n)
    edges = np.quantile(score, [0.365, 0.852, 0.913, 0.918, 0.934, 0.966])
    y = np.searchsorted(edges, score).astype(np.int64)
    return X, y


def california_like(n_samples: int = 20640, seed: int = 0):
    """Deterministic stand-in for California housing (n x 8, f64 target)."""
    rng = np.random.default_rng(seed)
    n = n_samples
    med_inc = rng.gamma(2.5, 1.55, n)                 # median income
    house_age = rng.uniform(1, 52, n)
    ave_rooms = np.clip(rng.normal(5.4, 2.3, n), 1, None)
    ave_bedrms = np.clip(ave_rooms / 5 + rng.normal(0, 0.2, n), 0.3, None)
    population = rng.gamma(1.8, 790.0, n)
    ave_occup = np.clip(rng.normal(3.0, 1.6, n), 0.7, None)
    latitude = rng.uniform(32.5, 42.0, n)
    longitude = rng.uniform(-124.3, -114.3, n)
    X = np.column_stack(
        [med_inc, house_age, ave_rooms, ave_bedrms, population, ave_occup,
         latitude, longitude]
    ).astype(np.float32)
    coast = np.hypot(latitude - 34.0, longitude + 118.2)  # LA-ish anchor
    y = (
        0.45 * med_inc
        + 0.7 * np.exp(-coast / 3.0)
        + 0.004 * house_age
        + 0.08 * np.log1p(ave_rooms)
        - 0.12 * np.log1p(ave_occup)
        + rng.normal(0, 0.35, n)
    )
    return X, np.clip(y, 0.15, 5.0).astype(np.float64)


def _subsample(X, y, n_samples, seed):
    if n_samples is not None and len(X) > n_samples:
        idx = np.random.default_rng(seed).permutation(len(X))[:n_samples]
        X, y = X[idx], y[idx]
    return X, y


def load_california(n_samples: int | None = None, seed: int = 0):
    """Real California housing when cached; california_like otherwise.

    Returns (X, y, name).
    """
    try:
        from sklearn.datasets import fetch_california_housing

        d = fetch_california_housing(download_if_missing=False)
        X = d.data.astype(np.float32)
        y = d.target.astype(np.float64)
        name = "california_housing"
    except Exception:
        X, y = california_like(20640 if n_samples is None else n_samples, seed)
        name = "california_like"
    return (*_subsample(X, y, n_samples, seed), name)


def load_covtype(n_samples: int | None = None, seed: int = 0):
    """Real covtype when a cached copy exists; covtype_like otherwise.

    Returns (X, y, name) with y relabelled to 0..6.
    """
    try:
        from sklearn.datasets import fetch_covtype

        d = fetch_covtype(download_if_missing=False)
        X = d.data.astype(np.float32)
        y = (d.target - 1).astype(np.int64)
        name = "covtype"
    except Exception:
        X, y = covtype_like(581012 if n_samples is None else n_samples, seed)
        name = "covtype_like"
    return (*_subsample(X, y, n_samples, seed), name)

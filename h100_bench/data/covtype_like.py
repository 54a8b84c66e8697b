"""Covtype-shaped data, frozen for the benchmark.

A copy of ``covtype_like`` as ``mpitree_tpu_torch/utils/datasets.py``
held it when the benchmark was defined (581,012 x 54: ten continuous
columns with covtype's heterogeneous scales, 4 wilderness and 40 soil
one-hot columns from latent categories, 7 imbalanced classes from noisy
axis-aligned rules), and of ``chip_smoke.py``'s ``binary`` rule (LIBSVM's
covtype.binary: the most frequent class against the rest). The copy keeps
the yardstick still when the program's own generator changes. Only the
seed is mapped: any whole number is taken, modulo 2**63.

As a generator of the benchmark (a configuration's ``data.generator``)
it makes the configuration's ``data.rows`` rows of its ``data.seed`` and
permutes them by the run's seed: every run of a configuration fits the
same rows, so runs differ in row order and in the host, not in the work.
Readings over many data instances set ``data.seed`` (``control.py``).
"""

from __future__ import annotations

import numpy as np


def covtype_like(n_samples: int = 581012, seed: int = 0):
    """Deterministic covtype-shaped classification problem (n x 54, 7 classes)."""
    rng = np.random.default_rng(int(seed) % (1 << 63))
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


def binary_top(y: np.ndarray) -> np.ndarray:
    """LIBSVM's covtype.binary: the most frequent class against the rest."""
    return (y == int(np.bincount(y).argmax())).astype(np.int64)


TARGETS = {"multiclass": lambda y: y, "binary_top": binary_top}


def make(data: dict, seed: int):
    """``(X, y)`` for a configuration's ``data`` block (``rows``,
    ``seed``, ``target``: a key of ``TARGETS``) and a run's seed: the data
    seed's rows, permuted by the run's seed."""
    X, y = covtype_like(int(data["rows"]), int(data["seed"]))
    order = np.random.default_rng(int(seed) % (1 << 63)).permutation(len(y))
    return (np.ascontiguousarray(X[order]),
            np.ascontiguousarray(TARGETS[data["target"]](y)[order]))

"""Boosting losses: baseline raw scores, per-row (g, h), and the loss.

A copy of ``mpitree_tpu/boosting/losses.py``, operation for operation, so
the gradients and hessians a round fits are bit for bit the JAX
package's. Everything here is host float64 numpy: (g, h) are O(N)
elementwise work once per round, and keeping them in float64 keeps the
exact Newton leaf refit (``gradient_boosting._newton_refit``) and the
early-stopping loss curves free of float32 noise. The card sees only the
float32 casts that feed the ``(count, g, h)`` histograms.

Conventions: ``raw`` is the (N, K) margin matrix (K = trees per round);
``g``/``h`` are the first and second derivatives of the per-row loss with
respect to the raw score, so the Newton leaf value is ``-G/(H + lambda)``
and every loss here is minimized. The multinomial softmax uses the
diagonal hessian ``p(1-p)`` (sklearn's HistGradientBoosting choice).
"""

from __future__ import annotations

import numpy as np


def _sigmoid(x: np.ndarray) -> np.ndarray:
    # tanh form: stable at both tails without piecewise masking
    return 0.5 * (1.0 + np.tanh(0.5 * x))


def _weighted_mean(v: np.ndarray, w: np.ndarray | None) -> float:
    if w is None:
        return float(np.mean(v))
    return float(np.sum(v * w) / max(np.sum(w), 1e-300))


class SquaredError:
    """1/2 (y - raw)^2; h == 1, so Newton boosting is gradient boosting."""

    K = 1
    # the JAX package's id of the loss's in-device twin (fused rounds)
    kind = "squared_error"

    def init_raw(self, y: np.ndarray, w: np.ndarray | None) -> np.ndarray:
        return np.array([_weighted_mean(y, w)])

    def grad_hess(self, raw: np.ndarray, y: np.ndarray):
        g = raw[:, 0] - y
        return g[:, None], np.ones_like(g)[:, None]

    def loss(self, raw: np.ndarray, y: np.ndarray,
             w: np.ndarray | None) -> float:
        return _weighted_mean(0.5 * (raw[:, 0] - y) ** 2, w)


class BinaryLogistic:
    """Binomial deviance on {0, 1} labels; one tree per round."""

    K = 1
    kind = "logistic"

    def init_raw(self, y: np.ndarray, w: np.ndarray | None) -> np.ndarray:
        p = np.clip(_weighted_mean(y.astype(np.float64), w), 1e-12, 1 - 1e-12)
        return np.array([np.log(p / (1.0 - p))])

    def grad_hess(self, raw: np.ndarray, y: np.ndarray):
        p = _sigmoid(raw[:, 0])
        return (p - y)[:, None], (p * (1.0 - p))[:, None]

    def loss(self, raw: np.ndarray, y: np.ndarray,
             w: np.ndarray | None) -> float:
        m = raw[:, 0]
        return _weighted_mean(np.logaddexp(0.0, m) - y * m, w)

    def proba(self, raw: np.ndarray) -> np.ndarray:
        p1 = _sigmoid(raw[:, 0])
        return np.stack([1.0 - p1, p1], axis=1)


class MultinomialLogistic:
    """Softmax cross-entropy; one tree per class per round."""

    kind = None  # no in-device twin: one tree per class per round

    def __init__(self, n_classes: int):
        self.K = n_classes

    def init_raw(self, y: np.ndarray, w: np.ndarray | None) -> np.ndarray:
        prior = np.zeros(self.K)
        for k in range(self.K):
            prior[k] = _weighted_mean((y == k).astype(np.float64), w)
        return np.log(np.clip(prior, 1e-12, None))

    def _softmax(self, raw: np.ndarray) -> np.ndarray:
        z = raw - raw.max(axis=1, keepdims=True)
        e = np.exp(z)
        return e / e.sum(axis=1, keepdims=True)

    def grad_hess(self, raw: np.ndarray, y: np.ndarray):
        p = self._softmax(raw)
        g = p.copy()
        g[np.arange(len(y)), y] -= 1.0
        return g, p * (1.0 - p)

    def loss(self, raw: np.ndarray, y: np.ndarray,
             w: np.ndarray | None) -> float:
        z = raw - raw.max(axis=1, keepdims=True)
        lse = np.log(np.exp(z).sum(axis=1))
        return _weighted_mean(lse - z[np.arange(len(y)), y], w)

    def proba(self, raw: np.ndarray) -> np.ndarray:
        return self._softmax(raw)


def loss_for(name: str, task: str, n_classes: int | None):
    """The estimator's ``loss`` parameter -> a loss object."""
    if task == "regression":
        if name in ("squared_error", "mse"):
            return SquaredError()
        raise ValueError(f"unknown regression loss: {name!r}")
    if name != "log_loss":
        raise ValueError(f"unknown classification loss: {name!r}")
    if n_classes == 2:
        return BinaryLogistic()
    return MultinomialLogistic(n_classes)

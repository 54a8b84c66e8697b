"""Per-node random feature subsets and random-split draws.

Counterpart of the host half of ``mpitree_tpu/ops/sampling.py``
(``seed_from`` ``:39``, ``sampler_for`` ``:60``, ``n_subspace_features``
``:80``, ``pcg_hash`` ``:129``, ``NodeFeatureSampler`` ``:366``,
``KeyStore`` ``:458``), with the same uint32 arithmetic bit for bit:

- every node carries a uint32 **key**: the root key hashes the tree seed,
  children hash the parent key with side-distinct salts, so keys follow the
  node's *path* and every engine that grows the same tree draws the same;
- a node's feature subset is the first ``k`` entries of a stable argsort
  of per-(node, feature) hash scores;
- ``splitter="random"`` draws one uint32 per (node, feature) under its own
  salt; the split sweep takes it modulo the node's count of valid
  candidate bins (``ops/impurity._drawn_bins``).

A node whose ``k`` features admit no valid split becomes a leaf; there is
no redraw (LightGBM's ``feature_fraction_bynode`` rule, as in the JAX
package). The levelwise engine keeps the keys on the host beside the
level's host decision, as the JAX levelwise engine does, and ships masks
and draws to the device once per chunk, the draws as int64 so ``draw %
count`` is exact. The fused engine keeps them on the device: the torch
twins :func:`pcg_hash_dev`, :func:`node_masks_dev`, :func:`node_draws_dev`
and :func:`child_keys_dev` (``pcg_hash_jnp`` ``:305``, ``node_masks_jnp``
``:320``, ``node_draws_jnp`` ``:344``, ``child_keys_jnp`` ``:355``)
compute the same bits. torch has no uint32 shifts on the CPU, so they
carry each key in int64 and mask to 32 bits after every multiply and add.

Boosting's round masks (``row_subsample_mask`` ``:138``,
``feature_subsample_mask`` ``:163``, ``subsample_threshold_u32`` ``:278``)
are keyed the same way, by (seed, round, row or feature), so a refit
draws the same subsample; :func:`row_subsample_mask_dev` draws the row
mask on the card for the fused boosting rounds (``row_subsample_mask_jnp``
``:286``).

The forests' keyed draws (``bootstrap_weights``, ``tree_seed`` and
``feature_subset``, ``:198-275``) are keyed by (seed, tree, row or
feature) the same way: a streamed forest always draws them (a host RNG
has no defined order over a chunk stream), an in-memory one under
``MPITREE_TPU_KEYED_BOOTSTRAP=1``, which makes it the streamed forest's
twin.
"""

from __future__ import annotations

import dataclasses
import math
import numbers

import numpy as np
import torch


def seed_from(random_state) -> int:
    """sklearn's ``random_state`` idioms: None (seed 0: fits are never
    nondeterministic), an int, a numpy Generator or RandomState."""
    if random_state is None:
        return 0
    if isinstance(random_state, np.random.Generator):
        return int(random_state.integers(2**32))
    if isinstance(random_state, np.random.RandomState):
        return int(random_state.randint(2**32))
    try:
        return int(random_state)
    except (TypeError, ValueError):
        raise ValueError(
            f"random_state must be None, an int, or a numpy "
            f"Generator/RandomState, got {random_state!r}"
        ) from None


def sampler_for(max_features, random_state, n_features: int,
                splitter: str = "best"):
    """The estimators' sampler for their parameters, or None when every
    node sees every feature and splits at its best bin."""
    if splitter not in ("best", "random"):
        raise ValueError(
            f"splitter must be 'best' or 'random', got {splitter!r}"
        )
    k = n_subspace_features(max_features, n_features)
    if k >= n_features and splitter == "best":
        return None
    return NodeFeatureSampler(
        k=min(k, n_features), n_features=n_features,
        seed=seed_from(random_state), random_split=(splitter == "random"),
    )


def n_subspace_features(max_features, n_features: int) -> int:
    """sklearn's ``max_features`` grammar -> the subset size k; invalid
    values raise."""
    if max_features is None:
        return n_features
    if isinstance(max_features, str):
        if max_features == "sqrt":
            return max(1, int(math.sqrt(n_features)))
        if max_features == "log2":
            return max(1, int(math.log2(n_features)))
        raise ValueError(
            f"max_features must be 'sqrt', 'log2', an int, a float in "
            f"(0, 1], or None, got {max_features!r}"
        )
    if isinstance(max_features, numbers.Real) and not isinstance(
            max_features, numbers.Integral):
        if not 0.0 < max_features <= 1.0:
            raise ValueError(
                f"float max_features must be in (0, 1], got {max_features!r}"
            )
        return max(1, int(max_features * n_features))
    k = int(max_features)
    if not 0 < k <= n_features:
        raise ValueError(
            f"int max_features must be in [1, n_features={n_features}], "
            f"got {max_features!r}"
        )
    return k


_MULT = np.uint32(747796405)
_INC = np.uint32(2891336453)
_FIN = np.uint32(277803737)
_LEFT_SALT = np.uint32(0x9E3779B9)
_RIGHT_SALT = np.uint32(0xC2B2AE35)
_FEAT_SALT = np.uint32(0x85EBCA6B)
_DRAW_SALT = np.uint32(0x27D4EB2F)  # random-split bin draws (ExtraTrees)
_ROW_SALT = np.uint32(0x51ED270B)  # per-round row subsampling (boosting)
_COL_SALT = np.uint32(0x6C62272E)  # per-round feature subsampling (boosting)
_BOOT_SALT = np.uint32(0x94D049BB)  # per-tree bootstrap draws (forests)


def pcg_hash(x: np.ndarray) -> np.ndarray:
    """The PCG-XSH-RR style uint32 -> uint32 hash, wrapping arithmetic."""
    with np.errstate(over="ignore"):
        x = (x.astype(np.uint32) * _MULT + _INC).astype(np.uint32)
        shift = ((x >> np.uint32(28)) + np.uint32(4)).astype(np.uint32)
        word = (((x >> shift) ^ x) * _FIN).astype(np.uint32)
        return ((word >> np.uint32(22)) ^ word).astype(np.uint32)


_U32 = 0xFFFFFFFF


def pcg_hash_dev(x: torch.Tensor) -> torch.Tensor:
    """:func:`pcg_hash` on a tensor of uint32 values held in int64, bit
    for bit; returns int64 in ``[0, 2**32)``. Every product stays below
    2**63 (a 32-bit value times a constant below 2**30)."""
    x = (x.to(torch.int64) & _U32) * int(_MULT) + int(_INC) & _U32
    shift = (x >> 28) + 4
    word = ((x >> shift) ^ x) * int(_FIN) & _U32
    return (word >> 22) ^ word


def _salted_dev(keys: torch.Tensor, n_features: int, salt) -> torch.Tensor:
    f = torch.arange(1, n_features + 1, dtype=torch.int64,
                     device=keys.device)
    return pcg_hash_dev(keys.to(torch.int64)[:, None]
                        ^ (f[None, :] * int(salt) & _U32))


def node_masks_dev(keys: torch.Tensor, k: int,
                   n_features: int) -> torch.Tensor:
    """:meth:`NodeFeatureSampler.node_masks` on the keys' device: (S,)
    int64 keys -> (S, F) bool, the first ``k`` of a stable argsort."""
    S = keys.shape[0]
    if k >= n_features:
        return torch.ones((S, n_features), dtype=torch.bool,
                          device=keys.device)
    order = torch.argsort(_salted_dev(keys, n_features, _FEAT_SALT), dim=1,
                          stable=True)
    mask = torch.zeros((S, n_features), dtype=torch.bool, device=keys.device)
    return mask.scatter_(1, order[:, :k], True)


def node_draws_dev(keys: torch.Tensor, n_features: int) -> torch.Tensor:
    """:meth:`NodeFeatureSampler.node_draws` on the keys' device: (S, F)
    int64 draws in ``[0, 2**32)``."""
    return _salted_dev(keys, n_features, _DRAW_SALT)


def child_keys_dev(keys: torch.Tensor):
    """:meth:`NodeFeatureSampler.child_keys` on the keys' device."""
    p = keys.to(torch.int64)
    return pcg_hash_dev(p ^ int(_LEFT_SALT)), pcg_hash_dev(
        p ^ int(_RIGHT_SALT))


def _round_base(seed: int, round_idx: int, salt) -> np.uint32:
    """The uint32 key of one boosting round's draws."""
    with np.errstate(over="ignore"):
        return np.uint32(
            pcg_hash(np.uint32(seed))
            ^ pcg_hash((np.uint32(round_idx) + salt).astype(np.uint32))
        )


def row_subsample_mask(seed: int, round_idx: int, n_rows: int,
                       fraction: float) -> np.ndarray:
    """(n_rows,) bool: the rows of one boosting round's subsample, each
    row in when ``pcg_hash(base(seed, round) + row)`` lies below
    :func:`subsample_threshold_u32` (Bernoulli(fraction) per row, without
    replacement; ``mpitree_tpu/ops/sampling.py:138``)."""
    if not 0.0 < fraction <= 1.0:
        raise ValueError(
            f"subsample fraction must be in (0, 1], got {fraction!r}")
    if fraction >= 1.0:
        return np.ones(n_rows, bool)
    base = _round_base(seed, round_idx, _ROW_SALT)
    with np.errstate(over="ignore"):
        keys = pcg_hash(base + np.arange(n_rows, dtype=np.uint32))
    return keys < subsample_threshold_u32(fraction)


def row_subsample_mask_dev(seed: int, round_idx: int, n_rows: int,
                           fraction: float,
                           device: torch.device) -> torch.Tensor:
    """:func:`row_subsample_mask` made on ``device`` (``(n_rows,)`` bool),
    bit for bit: the fused boosting rounds draw every round's subsample
    on the card (``row_subsample_mask_jnp``,
    ``mpitree_tpu/ops/sampling.py:286``). The round's base key is host
    arithmetic; the rows' hashes run in int64 masked to 32 bits
    (:func:`pcg_hash_dev`)."""
    if not 0.0 < fraction <= 1.0:
        raise ValueError(
            f"subsample fraction must be in (0, 1], got {fraction!r}")
    if fraction >= 1.0:
        return torch.ones(n_rows, dtype=torch.bool, device=device)
    base = int(_round_base(seed, round_idx, _ROW_SALT))
    rows = torch.arange(n_rows, dtype=torch.int64, device=device)
    keys = pcg_hash_dev((rows + base) & _U32)
    return keys < int(subsample_threshold_u32(fraction))


def feature_subsample_mask(seed: int, round_idx: int, n_features: int,
                           fraction: float) -> np.ndarray:
    """(n_features,) bool: exactly ``max(1, floor(fraction * F))``
    features of one boosting round (``colsample_bytree``), the first of a
    stable argsort of per-(round, feature) hash scores
    (``mpitree_tpu/ops/sampling.py:163``)."""
    if not 0.0 < fraction <= 1.0:
        raise ValueError(
            f"colsample fraction must be in (0, 1], got {fraction!r}")
    if fraction >= 1.0:
        return np.ones(n_features, bool)
    k = max(1, int(fraction * n_features))
    base = _round_base(seed, round_idx, _COL_SALT)
    with np.errstate(over="ignore"):
        f = np.arange(n_features, dtype=np.uint32)
        scores = pcg_hash(base + (f + np.uint32(1)) * _COL_SALT)
    mask = np.zeros(n_features, bool)
    mask[np.argsort(scores, kind="stable")[:k]] = True
    return mask


def _poisson1_cutoffs() -> np.ndarray:
    """uint32 inverse-CDF cutoffs of Poisson(1) multiplicities
    (``:198-215``): ``cutoffs[k] = round(CDF(k) * 2**32)``, and a uniform
    uint32 ``u`` draws ``searchsorted(cutoffs, u, side="right")``; the
    tail past 12 carries < 1e-12 of the mass."""
    pmf = np.empty(13, np.float64)
    pmf[0] = np.exp(-1.0)
    for k in range(1, 13):
        pmf[k] = pmf[k - 1] / k
    return np.minimum(
        np.round(np.cumsum(pmf) * 4294967296.0), 4294967296.0 - 1
    ).astype(np.uint64)


_POISSON1_CUTOFFS = _poisson1_cutoffs()


def bootstrap_weights(seed: int, tree_idx: int, n_rows: int) -> np.ndarray:
    """(n_rows,) float32 keyed bootstrap multiplicities of one forest tree
    (``:221-244``): each row's in-bag count a Poisson(1) draw keyed by
    (seed, tree, row), online bagging's stand-in for the multinomial
    draw, and a pure function of the global row index, so any chunking,
    mesh or process split draws the same bootstrap."""
    with np.errstate(over="ignore"):
        base = np.uint32(
            pcg_hash(np.uint32(seed))
            ^ pcg_hash((np.uint32(tree_idx) + _BOOT_SALT).astype(np.uint32))
        )
        keys = pcg_hash(base + np.arange(n_rows, dtype=np.uint32))
    return np.searchsorted(
        _POISSON1_CUTOFFS, keys.astype(np.uint64), side="right"
    ).astype(np.float32)


def tree_seed(seed: int, tree_idx: int) -> int:
    """One forest tree's uint32 sampler seed under keyed draws
    (``:247-260``): a pure function of (forest seed, tree)."""
    with np.errstate(over="ignore"):
        return int(pcg_hash(
            pcg_hash(np.uint32(seed))
            ^ ((np.uint32(tree_idx) + np.uint32(1)) * _BOOT_SALT)
            .astype(np.uint32)
        ))


def feature_subset(seed: int, tree_idx: int, n_features: int,
                   k: int) -> np.ndarray:
    """The sorted ``k``-feature subspace of one tree under keyed draws
    (``max_features_mode="tree"``, ``:263-275``): the lowest ``k`` of a
    stable argsort of per-(seed, tree, feature) hash scores."""
    with np.errstate(over="ignore"):
        base = np.uint32(
            pcg_hash(np.uint32(seed))
            ^ pcg_hash((np.uint32(tree_idx) + _FEAT_SALT).astype(np.uint32))
        )
        scores = pcg_hash(base + np.arange(n_features, dtype=np.uint32))
    return np.sort(np.argsort(scores, kind="stable")[:k])


def subsample_threshold_u32(fraction: float) -> np.uint32:
    """The uint32 threshold :func:`row_subsample_mask` compares against;
    callers take ``fraction < 1`` (1.0 would wrap)."""
    return np.uint32(int(fraction * 4294967296.0))


def _salted(keys: np.ndarray, n_features: int, salt) -> np.ndarray:
    """(S,) keys -> (S, F) uint32 ``pcg_hash(key ^ (f + 1) * salt)``."""
    f = np.arange(n_features, dtype=np.uint32)
    with np.errstate(over="ignore"):
        return pcg_hash(
            keys.astype(np.uint32)[:, None]
            ^ ((f[None, :] + np.uint32(1)) * salt).astype(np.uint32)
        )


@dataclasses.dataclass(frozen=True)
class NodeFeatureSampler:
    """Per-node feature subsets of size ``k`` out of ``n_features`` and,
    with ``random_split``, the per-(node, feature) bin draws, all derived
    from ``seed`` (a forest draws one per tree) or, for a subtree grown
    below a crown leaf, from that leaf's key ``root_key_value``."""

    k: int
    n_features: int
    seed: int
    root_key_value: int | None = None
    random_split: bool = False

    @property
    def active(self) -> bool:
        return self.k < self.n_features or self.random_split

    def root_key(self) -> np.uint32:
        if self.root_key_value is not None:
            return np.uint32(self.root_key_value)
        return pcg_hash(np.uint32(self.seed & 0xFFFFFFFF))

    def child_keys(self, parent_keys: np.ndarray):
        """(left keys, right keys) of an array of parent keys."""
        p = parent_keys.astype(np.uint32)
        return pcg_hash(p ^ _LEFT_SALT), pcg_hash(p ^ _RIGHT_SALT)

    def node_masks(self, keys: np.ndarray) -> np.ndarray:
        """(S,) keys -> (S, F) bool, True on each node's k features: the
        first k of a stable ascending argsort of the node's feature
        scores (hash collisions go to the lower feature index)."""
        if self.k >= self.n_features:
            return np.ones((len(keys), self.n_features), bool)
        order = np.argsort(_salted(keys, self.n_features, _FEAT_SALT),
                           axis=1, kind="stable")
        mask = np.zeros((len(keys), self.n_features), bool)
        np.put_along_axis(mask, order[:, : self.k], True, axis=1)
        return mask

    def node_draws(self, keys: np.ndarray) -> np.ndarray:
        """(S,) keys -> (S, F) uint32 draws of ``splitter="random"``."""
        return _salted(keys, self.n_features, _DRAW_SALT)

    def key_store(self, root_keys=None) -> KeyStore:
        return KeyStore(self, root_keys)

    def keys_for_tree(self, tree) -> np.ndarray:
        """Every node's key recomputed from the tree's structure, a depth
        level at a time (parents precede children): the refine tail seeds
        its subtree roots with the crown leaves' keys."""
        keys = np.zeros(tree.n_nodes, np.uint32)
        keys[0] = self.root_key()
        for d in range(int(tree.depth.max(initial=0)) + 1):
            parents = np.flatnonzero((tree.depth == d) & (tree.left >= 0))
            if not len(parents):
                continue
            lk, rk = self.child_keys(keys[parents])
            keys[tree.left[parents]] = lk
            keys[tree.right[parents]] = rk
        return keys


class KeyStore:
    """The growable per-node key array every level loop threads (device
    engine, host tier, batched tail), so no engine keeps its own copy of
    the bookkeeping."""

    def __init__(self, sampler: NodeFeatureSampler, root_keys=None):
        self._sampler = sampler
        if root_keys is None:
            self.keys = np.zeros(256, np.uint32)
            self.keys[0] = sampler.root_key()
        else:
            self.keys = np.asarray(root_keys, np.uint32).copy()

    def slice(self, lo: int, hi: int) -> np.ndarray:
        return self.keys[lo:hi]

    def masks(self, lo: int, hi: int) -> np.ndarray:
        return self._sampler.node_masks(self.keys[lo:hi])

    def draws(self, lo: int, hi: int) -> np.ndarray:
        return self._sampler.node_draws(self.keys[lo:hi])

    def assign_children(self, parent_ids, left_ids, right_ids, n_total: int):
        """Hand children their path-derived keys (growing the store)."""
        if n_total > len(self.keys):
            grown = np.zeros(max(n_total, 2 * len(self.keys)), np.uint32)
            grown[: len(self.keys)] = self.keys
            self.keys = grown
        lk, rk = self._sampler.child_keys(self.keys[parent_ids])
        self.keys[left_ids] = lk
        self.keys[right_ids] = rk

"""A depth-bounded classification tree, grown level by level, plainly.

Every level of the tree is one frontier; its nodes are taken in blocks,
each block's (node, feature, class, bin) counts are one ``bincount`` of
the block's rows in int64, and each node's split is chosen from them:

- a candidate ``(f, b)`` sends rows with ``bin <= b`` left; it needs
  weight on both sides and ``b`` below feature ``f``'s candidate count;
- its cost is the weighted child entropy ``(n_l H(l) + n_r H(r)) / n``,
  in float64: per class the left weight is the cumulative count over
  bins times the class weight, the side weights are the class weights
  added in class order, and ``H = -sum_c p_c log2 p_c`` over the classes
  present, with ``p_c = w_c / max(n, 1e-300)`` and ``log2 x = ln x *
  (1 / ln 2)``, added in class order;
- candidates rank by the cost's float32 value, then by the float32 of
  what that rounding dropped; the first of equals wins, lowest bin, then
  lowest feature;
- a node is a leaf when it holds one class, when every feature has at
  most one occupied bin, when its weight is below ``min_samples_split``,
  when no candidate is valid, or at ``max_depth``;
- children are numbered level by level, in the order of their parents,
  left before right.

Class weights (``class_w``, float64 copies of float32 values) multiply
the counts exactly: a count below 2**20 times a float32 value fits a
float64 mantissa. ``dtype=torch.float32`` runs the same arithmetic in
float32 and ranks by the float32 cost alone: the control that a check
has to reject.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_INV_LN2 = 1.0 / math.log(2.0)
_INV_LN2_F32 = float(np.float32(1.0) / np.float32(np.log(np.float32(2.0))))


def lex_argmin(hi: torch.Tensor, lo: torch.Tensor, dim: int) -> torch.Tensor:
    """First index of the lexicographic ``(hi, lo)`` minimum along ``dim``."""
    m_hi = hi.amin(dim=dim, keepdim=True)
    cand = hi == m_hi
    lo_m = torch.where(cand, lo, torch.full_like(lo, math.inf))
    cand = cand & (lo_m == lo_m.amin(dim=dim, keepdim=True))
    size = hi.shape[dim]
    shape = [1] * hi.dim()
    shape[dim] = size
    iota = torch.arange(size, device=hi.device).view(shape).expand_as(hi)
    return torch.where(cand, iota, torch.full_like(iota, size)).amin(dim=dim)


def _costs(hist: torch.Tensor, w, dtype):
    """(K, F, C, B) int64 counts -> ``(hi, lo, n_l, n_r)`` per candidate."""
    C = hist.shape[2]
    tiny = 1e-300 if dtype == torch.float64 else 1e-38
    inv = _INV_LN2 if dtype == torch.float64 else _INV_LN2_F32

    def left(c):
        v = torch.cumsum(hist[:, :, c, :], dim=2).to(dtype)
        return v if w is None else v * w[c]

    n_l = left(0)
    for c in range(1, C):
        n_l = n_l + left(c)
    n_t = n_l[:, :, -1:]
    n_r = n_t - n_l
    d_l, d_r, d_t = (torch.clamp(v, min=tiny) for v in (n_l, n_r, n_t))
    acc_l = acc_r = None
    for c in range(C):
        l_c = left(c)
        r_c = l_c[:, :, -1:] - l_c
        p_l, p_r = l_c / d_l, r_c / d_r
        t_l = torch.where(l_c > 0, p_l * (torch.log(torch.clamp(p_l, min=tiny))
                                          * inv), torch.zeros_like(p_l))
        t_r = torch.where(r_c > 0, p_r * (torch.log(torch.clamp(p_r, min=tiny))
                                          * inv), torch.zeros_like(p_r))
        acc_l = t_l if acc_l is None else acc_l + t_l
        acc_r = t_r if acc_r is None else acc_r + t_r
    cost = (n_l * -acc_l + n_r * -acc_r) / d_t
    hi = cost.to(torch.float32)
    if dtype == torch.float64:
        lo = (cost - hi.to(torch.float64)).to(torch.float32)
    else:
        lo = torch.zeros_like(hi)
    return hi, lo, n_l, n_r


def _decide(hist: torch.Tensor, cand: torch.Tensor, w, dtype) -> tuple:
    """A block's splits: ``(feature, bin, no_split_possible, counts)``,
    counts (K, C) float64 (exact)."""
    hi, lo, n_l, n_r = _costs(hist, w, dtype)
    valid = cand[None] & (n_l > 0) & (n_r > 0)
    hi = torch.where(valid, hi, torch.full_like(hi, math.inf))
    lo = torch.where(valid, lo, torch.zeros_like(lo))
    b_f = lex_argmin(hi, lo, dim=2)
    hi_f = torch.gather(hi, 2, b_f[:, :, None])[:, :, 0]
    lo_f = torch.gather(lo, 2, b_f[:, :, None])[:, :, 0]
    feat = lex_argmin(hi_f, lo_f, dim=1)
    b = torch.gather(b_f, 1, feat[:, None])[:, 0]
    none = torch.isinf(torch.gather(hi_f, 1, feat[:, None])[:, 0])
    occupied = (hist.sum(dim=2) > 0).sum(dim=2)
    constant = (occupied <= 1).all(dim=1)
    counts = hist[:, 0].sum(dim=-1).to(torch.float64)
    if w is not None:
        counts = counts * w.to(torch.float64)
    return feat, b, none | constant, counts


def _weight(counts: torch.Tensor) -> torch.Tensor:
    """A node's weight: its classes' weights added in class order."""
    n = torch.zeros_like(counts[:, 0])
    for c in range(counts.shape[1]):
        n = n + counts[:, c]
    return n


def fit_tree(xb: torch.Tensor, y: torch.Tensor, *, n_classes: int,
             n_cand: torch.Tensor, max_depth: int, class_w=None,
             min_samples_split: float = 2.0, dtype=torch.float64,
             block: int = 1024) -> dict:
    """Grow the tree of ``xb`` (N, F) uint8 bins and ``y`` (N,) int64
    classes. ``class_w`` (C,) float64 or None (unit weights). Returns
    numpy arrays ``feature`` (-1 on leaves), ``bin``, ``left``, ``right``
    (-1 on leaves) and ``count`` (n_nodes, C) float64."""
    dev = xb.device
    N, F = xb.shape
    C = int(n_classes)
    B = int(n_cand.max()) + 1
    cand = (torch.arange(B, device=dev)[None, :] < n_cand.to(dev)[:, None])
    w = None if class_w is None else torch.as_tensor(
        class_w, dtype=dtype, device=dev)
    w64 = None if class_w is None else torch.as_tensor(
        class_w, dtype=torch.float64, device=dev)
    xb64 = xb.to(torch.int64)
    feat_off = torch.arange(F, device=dev, dtype=torch.int64)[None, :]
    nid = torch.zeros(N, dtype=torch.int64, device=dev)
    feats, bins, lefts, counts_all = [], [], [], []
    flo, fsz, depth = 0, 1, 0
    while fsz > 0:
        hi_id = flo + fsz
        if depth == max_depth:
            live = (nid >= flo) & (nid < hi_id)
            key = (nid[live] - flo) * C + y[live]
            cnt = torch.bincount(key, minlength=fsz * C).view(fsz, C)
            cnt = cnt.to(torch.float64)
            if w64 is not None:
                cnt = cnt * w64
            feats.append(torch.full((fsz,), -1, dtype=torch.int64,
                                    device=dev))
            bins.append(torch.zeros(fsz, dtype=torch.int64, device=dev))
            lefts.append(torch.full((fsz,), -1, dtype=torch.int64,
                                    device=dev))
            counts_all.append(cnt)
            break
        f_lv, b_lv, stop_lv, c_lv = [], [], [], []
        for lo in range(flo, hi_id, block):
            K = min(block, hi_id - lo)
            rows = torch.nonzero((nid >= lo) & (nid < lo + K))[:, 0]
            slot = nid[rows] - lo
            key = (((slot[:, None] * F + feat_off) * C + y[rows][:, None])
                   * B + xb64[rows])
            hist = torch.bincount(key.reshape(-1),
                                  minlength=K * F * C * B).view(K, F, C, B)
            del key
            f, b, stop, cnt = _decide(hist, cand, w, dtype)
            del hist
            n = _weight(cnt)
            pure = (cnt > 0).sum(dim=1) <= 1
            stop = stop | pure | (n < min_samples_split)
            f_lv.append(f)
            b_lv.append(b)
            stop_lv.append(stop)
            c_lv.append(cnt)
        f = torch.cat(f_lv)
        b = torch.cat(b_lv)
        stop = torch.cat(stop_lv)
        split = ~stop
        rank = torch.cumsum(split.to(torch.int64), 0)
        lids = hi_id + 2 * (rank - 1)
        feats.append(torch.where(split, f, -1))
        bins.append(torch.where(split, b, 0))
        lefts.append(torch.where(split, lids, -1))
        counts_all.append(torch.cat(c_lv))
        # the level's rows move to their children; a leaf's rows stop
        at = (nid >= flo) & (nid < hi_id)
        k = torch.where(at, nid - flo, 0)
        go = at & split[k]
        x_f = torch.gather(xb64, 1, f[k][:, None])[:, 0]
        child = lids[k] + (x_f > b[k]).to(torch.int64)
        nid = torch.where(go, child, torch.where(at, -1, nid))
        n_split = int(rank[-1])
        flo, fsz, depth = hi_id, 2 * n_split, depth + 1
    feature = torch.cat(feats).cpu().numpy()
    left = torch.cat(lefts).cpu().numpy()
    return {"feature": feature,
            "bin": torch.cat(bins).cpu().numpy(),
            "left": left,
            "right": np.where(left >= 0, left + 1, -1),
            "count": torch.cat(counts_all).cpu().numpy()}

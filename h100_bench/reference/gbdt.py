"""Binary logistic boosting with best-first trees, plainly.

One tree a round, ``max_iter`` rounds, from float32 margins that start at
the float32 log-odds of the positive share:

1. ``p = 0.5 (1 + tanh(0.5 m))``, ``g = p - y``, ``h = p (1 - p)``, in
   float32; a row with ``h == 0`` adds nothing to a split's statistics;
2. each statistic becomes an integer at a fixed scale, ``round_half_even
   (v 2**k)``, ``k = 62 - ceil(log2 N) - ceil(log2 top)`` with the
   bounds ``top`` = 1 for the row count and ``g``, 1/4 for ``h``, so sums
   over rows are exact in int64;
3. the tree grows best first: the open leaf of the largest float32 gain
   ``-1/2 G^2/H (parent) + 1/2 (G_l^2/H_l + G_r^2/H_r)`` splits next (ties
   to the lowest node id, ids in order of creation), until ``max_leaf_nodes``
   leaves or no open leaf may split. A candidate needs at least
   ``min_samples_leaf`` rows and a hessian of ``min_child_weight`` on each
   side; sums are rounded from int64 to float32 once, and the float32
   costs rank as the tree reference's do (lowest bin, then feature, of
   equals). A node stops at ``max_depth``, below ``min_samples_split``
   rows, when no feature has two occupied bins, or without a valid
   candidate;
4. a leaf's value is ``-G / max(H + lambda, 1e-12)`` in float32 from its
   exact sums (int64, then float64, then float32), and every row's margin
   moves by ``learning_rate`` times its leaf's value, in float32;
5. the round's training loss is the float64 mean of ``logaddexp(0, m) -
   y m``.

The control (``stats_dtype=torch.bfloat16``) rounds ``g`` and ``h`` to
bfloat16 before step 2.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from h100_bench.reference.tree import lex_argmin

FIXED_POINT_BITS = 62


def exponents(n_rows: int, tops) -> list:
    row_bits = math.ceil(math.log2(max(int(n_rows), 1)))
    return [FIXED_POINT_BITS - row_bits - math.ceil(math.log2(t))
            for t in tops]


class _Grower:
    """One round's best-first tree over fixed-point row statistics."""

    def __init__(self, xb64, q, ks, cand, params):
        self.xb64, self.q, self.cand = xb64, q, cand
        self.N, self.F = xb64.shape
        self.B = cand.shape[1]
        dev = xb64.device
        self.scale32 = torch.tensor([2.0 ** -k for k in ks],
                                    dtype=torch.float32, device=dev)
        self.lam = torch.tensor(np.float32(params["reg_lambda"]), device=dev)
        self.eps = torch.tensor(np.float32(1e-12), device=dev)
        self.mcw = torch.tensor(np.float32(params["min_child_weight"]),
                                device=dev)
        self.msl = torch.tensor(np.float32(params["min_samples_leaf"]),
                                device=dev)
        self.p = params
        self.off = (torch.arange(self.F, device=dev)[:, None] * 3
                    + torch.arange(3, device=dev)[None, :]) * self.B

    def hist(self, rows: torch.Tensor) -> torch.Tensor:
        """(F, 3, B) int64 statistics of ``rows``."""
        key = self.off[None] + self.xb64[rows][:, :, None]  # (n, F, 3)
        vals = self.q[rows][:, None, :].expand(-1, self.F, 3)
        h = torch.zeros(self.F * 3 * self.B, dtype=torch.int64,
                        device=self.xb64.device)
        h.index_add_(0, key.reshape(-1), vals.reshape(-1))
        return h.view(self.F, 3, self.B)

    def score(self, g, h):
        return g * g / torch.maximum(h + self.lam, self.eps)

    def decide(self, hist: torch.Tensor) -> dict:
        cum = torch.cumsum(hist, dim=2)
        tot = cum[:, :, -1:]
        lft = [cum[:, c] for c in range(3)]
        rgt = [tot[:, c] - cum[:, c] for c in range(3)]
        f32 = [lambda a, c=c: a.to(torch.float32) * self.scale32[c]
               for c in range(3)]
        c_l, g_l, h_l = (f32[c](lft[c]) for c in range(3))
        c_r, g_r, h_r = (f32[c](rgt[c]) for c in range(3))
        cost = -0.5 * (self.score(g_l, h_l) + self.score(g_r, h_r))
        valid = (self.cand & (c_l > 0) & (c_r > 0) & (h_l >= self.mcw)
                 & (h_r >= self.mcw) & (c_l >= self.msl) & (c_r >= self.msl))
        cost = torch.where(valid, cost, torch.full_like(cost, math.inf))
        zeros = torch.zeros_like(cost)
        b_f = lex_argmin(cost, zeros, dim=1)
        cost_f = torch.gather(cost, 1, b_f[:, None])[:, 0]
        f = lex_argmin(cost_f, torch.zeros_like(cost_f), dim=0)
        parent = hist[0].sum(dim=-1)  # (3,) int64
        p32 = parent.to(torch.float32) * self.scale32
        imp = -0.5 * self.score(p32[1], p32[2])
        constant = ((hist[:, 0, :] > 0).sum(dim=1) <= 1).all()
        # one copy to the host: every field is exact in float64
        f, b, cost, imp, rows, const = torch.stack([
            f.to(torch.float64), b_f[f].to(torch.float64),
            cost_f[f].to(torch.float64), imp.to(torch.float64),
            parent[0].to(torch.float64) * float(self.scale32[0].double()),
            constant.to(torch.float64)]).tolist()
        return {"feature": int(f), "bin": int(b), "cost": np.float32(cost),
                "imp": np.float32(imp), "rows": rows, "constant": const > 0}

    def gain(self, d: dict, depth: int) -> float:
        """The decision's priority (float32 ``imp - cost``), ``-inf`` for a
        node that stops."""
        stop = (d["constant"] or d["rows"] < self.p["min_samples_split"]
                or math.isinf(d["cost"]) or depth >= self.p["max_depth"])
        with np.errstate(invalid="ignore", over="ignore"):
            g = float(d["imp"] - d["cost"])
        return -math.inf if stop or math.isnan(g) else g

    def grow(self) -> tuple:
        """``(nodes, nid)``: the nodes in order of creation and each row's
        final node. The smaller child's statistics are summed from its
        rows, the larger's are its parent's less the smaller's (exact in
        int64)."""
        dev = self.xb64.device
        nid = torch.zeros(self.N, dtype=torch.int64, device=dev)
        h0 = self.hist(torch.arange(self.N, device=dev))
        d0 = self.decide(h0)
        nodes = [{"depth": 0, "left": -1, "dec": d0, "hist": h0,
                  "gain": self.gain(d0, 0)}]
        open_ = [0]
        while len(open_) < self.p["max_leaf_nodes"]:
            best = max(open_, key=lambda i: (nodes[i]["gain"], -i))
            if nodes[best]["gain"] == -math.inf:
                break
            d = nodes[best]["dec"]
            f, b = d["feature"], d["bin"]
            lid = len(nodes)
            rows = torch.nonzero(nid == best)[:, 0]
            right = self.xb64[rows, f] > b
            nid[rows] = lid + right.to(torch.int64)
            n_right = int(right.sum())
            small = int(2 * n_right < rows.numel())  # 1: the right child
            h_small = self.hist(rows[right] if small else rows[~right])
            h_large = nodes[best].pop("hist") - h_small
            pair = (h_large, h_small) if small else (h_small, h_large)
            nodes[best].update(left=lid, f=f, b=b)
            depth = nodes[best]["depth"] + 1
            for h in pair:
                ds = self.decide(h)
                nodes.append({"depth": depth, "left": -1, "dec": ds,
                              "hist": h, "gain": self.gain(ds, depth)})
            open_.remove(best)
            open_ += [lid, lid + 1]
        return nodes, nid


def fit_gbdt(xb: torch.Tensor, y: torch.Tensor, *, n_cand: torch.Tensor,
             params: dict, stats_dtype=torch.float32) -> dict:
    """Boost ``params["max_iter"]`` rounds on ``xb`` (N, F) uint8 bins and
    binary ``y`` (N,) int64. Returns ``{"trees": [per round: numpy
    feature, bin, left, right, rows, value], "train_loss": (rounds + 1,)
    float64}``."""
    dev = xb.device
    N = xb.shape[0]
    xb64 = xb.to(torch.int64)
    B = int(n_cand.max()) + 1
    cand = torch.arange(B, device=dev)[None, :] < n_cand.to(dev)[:, None]
    y_np = y.cpu().numpy()
    p = float(np.clip(np.mean(y_np.astype(np.float64)), 1e-12, 1 - 1e-12))
    base = np.log(p / (1.0 - p))
    m0 = np.full(N, base)
    losses = [float(np.mean(np.logaddexp(0.0, m0) - y_np * m0))]
    y32 = y.to(torch.float32)
    y64 = y.to(torch.float64)
    raw = torch.full((N,), np.float32(base), dtype=torch.float32, device=dev)
    ks = exponents(N, (1.0, 1.0, 0.25))
    scale64 = torch.tensor([2.0 ** k for k in ks], dtype=torch.float64,
                           device=dev)
    inv64 = torch.tensor([2.0 ** -k for k in ks[1:]], dtype=torch.float64,
                         device=dev)
    lam = torch.tensor(np.float32(params["reg_lambda"]), device=dev)
    eps = torch.tensor(np.float32(1e-12), device=dev)
    lr32 = torch.tensor(np.float32(params["learning_rate"]), device=dev)
    trees = []
    for _ in range(int(params["max_iter"])):
        pr = 0.5 * (1.0 + torch.tanh(0.5 * raw))
        g, h = pr - y32, pr * (1.0 - pr)
        if stats_dtype != torch.float32:
            g = g.to(stats_dtype).to(torch.float32)
            h = h.to(stats_dtype).to(torch.float32)
        live = h > 0
        stats = torch.stack([live.to(torch.float32),
                             torch.where(live, g, torch.zeros_like(g)), h],
                            dim=1)
        q = torch.round(stats.to(torch.float64) * scale64).to(torch.int64)
        nodes, nid = _Grower(xb64, q, ks, cand, params).grow()
        # leaf sums from every row of the leaf, the row's own g
        gh = torch.round(torch.stack([g, h], dim=1).to(torch.float64)
                         * scale64[1:]).to(torch.int64)
        sums = torch.zeros((len(nodes), 2), dtype=torch.int64, device=dev)
        sums.index_add_(0, nid, gh)
        GH = (sums.to(torch.float64) * inv64).to(torch.float32)
        vals = -GH[:, 0] / torch.maximum(GH[:, 1] + lam, eps)
        raw = raw + lr32 * vals[nid]
        losses.append(float((torch.logaddexp(torch.zeros_like(
            raw, dtype=torch.float64), raw.to(torch.float64))
            - y64 * raw.to(torch.float64)).sum()) / N)
        vals_h = vals.cpu().numpy()
        left = np.array([n["left"] for n in nodes], np.int64)
        trees.append({
            "feature": np.array([n.get("f", -1) if n["left"] >= 0 else -1
                                 for n in nodes], np.int64),
            "bin": np.array([n.get("b", 0) for n in nodes], np.int64),
            "left": left,
            "right": np.where(left >= 0, left + 1, -1),
            "rows": np.array([float(n["dec"]["rows"]) for n in nodes]),
            "value": np.where(left < 0, vals_h, np.nan).astype(np.float32),
        })
    return {"trees": trees, "train_loss": np.asarray(losses)}

"""Ensemble traversal over depth-packed node tables: the plain tier.

Counterpart of ``mpitree_tpu/serving/traversal.py``, in plain PyTorch on
any device:

- :func:`descend` — the lockstep gather descent, (N, T) absolute leaf ids;
- :func:`flat_leaf_ids` — descent only, per-tree relative leaf ids (the
  estimators' ensemble predict path, ``ops/predict.stacked_leaf_ids``);
- :func:`traverse_gather` — descent + a single-tree leaf-value gather
  (``gather_counts``, ``gather_value``);
- :func:`traverse_accumulate` — descent + the ensemble reduction, for the
  four accumulate kinds.

:func:`accumulate` is the reduction in the kernel's three modes (``sum``,
``norm``, ``percls``) and, with :func:`descend`, the plain version of the
Hopper traversal kernel (``serving/serve_kernel.py``).

Exactness: the estimators aggregate leaf values on the host in float64,
tree by tree in member order (``forest.predict_proba``'s ``acc +=`` loop).
Float channels here are float64 and reduced in member order, the same
IEEE operations in the same order, on every device: the card has float64,
so the JAX CPU tier's bit-identity contract holds on the GPU too. There is
no jit, no compile registry and no donation; every call allocates its own
accumulator.
"""

from __future__ import annotations

import torch

GATHER_KINDS = ("gather_counts", "gather_value")
# Accumulate kind -> the kernel mode that computes it:
#   forest_proba  — per-tree normalized count rows, summed, / T;
#   forest_mean   — per-tree value column, summed, / T;
#   margin        — boosting: baseline + per-round (N, K) value blocks,
#                   tree t into column t mod K (values pre-scaled by lr);
#   forest_values — per-tree pre-normalized value rows, summed, / T.
ACC_AGG = {
    "forest_proba": "norm",
    "forest_mean": "sum",
    "margin": "percls",
    "forest_values": "sum",
}
ACC_KINDS = tuple(ACC_AGG)  # the kinds served by the accumulate kernels


def descend(X: torch.Tensor, feature: torch.Tensor, threshold: torch.Tensor,
            left: torch.Tensor, right: torch.Tensor, root: torch.Tensor,
            n_steps: int) -> torch.Tensor:
    """(N, T) int64 absolute leaf ids: every row starts at every root and
    takes ``n_steps`` steps (``x <= threshold`` goes left); rows on a leaf
    (``feature < 0``) keep their node id. ``X`` (N, F) float32; the table
    columns as :meth:`NodeTable.dev_arrays` gives them."""
    node = root.to(torch.int64)[None, :].expand(X.shape[0], -1)
    for _ in range(n_steps):
        f = feature[node].to(torch.int64)
        xf = torch.gather(X, 1, f.clamp(min=0))
        nxt = torch.where(xf <= threshold[node], left[node],
                          right[node]).to(torch.int64)
        node = torch.where(f < 0, node, nxt)
    return node


def flat_leaf_ids(X, feature, threshold, left, right, root, orig, *,
                  n_steps: int) -> torch.Tensor:
    """(N, T) per-tree relative leaf ids for a query batch."""
    node = descend(X, feature, threshold, left, right, root, n_steps)
    return orig[node]


def traverse_gather(X, feature, threshold, left, right, root, values, *,
                    kind: str, n_steps: int) -> torch.Tensor:
    """Descent + single-tree leaf-value gather: ``gather_counts`` -> the
    (N, C) rows, ``gather_value`` -> the (N,) first channel."""
    node = descend(X, feature, threshold, left, right, root, n_steps)[:, 0]
    if kind == "gather_counts":
        return values[node]
    if kind == "gather_value":
        return values[node, 0]
    raise ValueError(f"unknown serving gather kind {kind!r}")


def normalize_rows(v: torch.Tensor) -> torch.Tensor:
    """Each row over ``max(rowsum, 1)``: the per-tree term of ``norm``."""
    return v / torch.clamp(v.sum(dim=1, keepdim=True), min=1)


def accumulate(node: torch.Tensor, values: torch.Tensor, *, agg: str,
               n_out: int, baseline: torch.Tensor | None = None
               ) -> torch.Tensor:
    """Reduce the leaf rows ``values[node[:, t]]`` over the trees, in
    member order, into a fresh (N, n_out) accumulator (the ``baseline``
    row tiled, else zeros) of ``values``' dtype:

    - ``sum``: add the row (``n_out`` = the channel count);
    - ``norm``: add the row over ``max(rowsum, 1)`` (float channels);
    - ``percls``: tree ``t`` adds its channel 0 to column ``t mod n_out``.
    """
    N, T = node.shape
    if baseline is None:
        acc = torch.zeros((N, n_out), dtype=values.dtype,
                          device=values.device)
    else:
        acc = baseline.to(values.dtype).reshape(1, n_out).repeat(N, 1)
    for t in range(T):
        v = values[node[:, t]]
        if agg == "sum":
            acc = acc + v
        elif agg == "norm":
            acc = acc + normalize_rows(v)
        elif agg == "percls":
            c = t % n_out
            acc[:, c] = acc[:, c] + v[:, 0]
        else:
            raise ValueError(f"unknown traversal mode {agg!r}")
    return acc


def finish(out: torch.Tensor, kind: str, scale) -> torch.Tensor:
    """The per-kind tail after the reduction: margins are final, every
    other kind divides by ``scale`` (the tree count; a number or a 0-d
    tensor). The divisor is made a tensor on ``out``'s device: PyTorch's
    CUDA division by a host scalar multiplies by its reciprocal, which is
    not the correctly rounded quotient numpy takes."""
    if kind == "margin":
        return out
    return out / torch.as_tensor(scale, dtype=out.dtype, device=out.device)


def traverse_accumulate(X, feature, threshold, left, right, root, values,
                        scale, *, kind: str, n_steps: int,
                        baseline: torch.Tensor | None = None
                        ) -> torch.Tensor:
    """Descent + ensemble reduction for an accumulate kind (see
    ``ACC_AGG``). The output width is the channel count, or for ``margin``
    the baseline's length (the trees lie round-major, class-minor)."""
    try:
        agg = ACC_AGG[kind]
    except KeyError:
        raise ValueError(f"unknown serving accumulate kind {kind!r}") from None
    n_out = values.shape[1] if agg != "percls" else baseline.shape[0]
    node = descend(X, feature, threshold, left, right, root, n_steps)
    return finish(
        accumulate(node, values, agg=agg, n_out=n_out, baseline=baseline),
        kind, scale,
    )

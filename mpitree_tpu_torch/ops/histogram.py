"""Per-(node, feature, channel, bin) histograms — the build's hot op.

Counterpart of ``mpitree_tpu/ops/histogram.py``. Frontier nodes are
addressed by *slot* ``node_id - chunk_lo`` (node ids are assigned level by
level, so a frontier is a contiguous id range); rows parked in finished
leaves or at ``node_id == -1`` fall outside ``[0, n_slots)`` and add
nothing. The public layout is the JAX package's ``(S, F, C, B)``.

Every function runs the Hopper kernels on CUDA tensors and their plain
version on CPU tensors (``ops/hist_kernel.py``). A fit picks one of two
routes once, from its payload (:func:`payload_scale`; over the shards of
a data mesh, ``parallel/collective.payload_scale``):

- **integer**: class counts and integer weights, float32 sums below 2**24,
  exact and order-independent in float32; the histogram is float32;
- **fixed point**: every other payload (fractional weights, the regression
  moments of :func:`moment_payload`, GBDT's :func:`gbdt_payload`); values
  become int64 multiples of ``2**-k[c]`` and the histogram is their int64
  sum, exact and order-independent, so the card's fit equals the CPU's.

The optional ``packed`` (byte-wide bins), ``order`` / ``seg_start`` (rows
ordered by slot) and ``feat_bins`` arguments are
``hist_kernel.histogram``'s: what a fit prepares once and hands to every
call.

Sibling subtraction (``mpitree_tpu/ops/histogram.py:99-185``):
:func:`sibling_accumulate_slots` maps the rows of each pair's smaller
child to a compact half-width histogram, and :func:`sibling_reconstruct`
rebuilds the larger child as ``parent - small`` from the previous level's
resident histogram. Both routes subtract exactly: the float32 route only
takes payloads whose every channel sums below 2**24 in integers
(``hist_kernel.float32_exact``), and the fixed-point route subtracts
int64 sums. So the JAX package's float32-ceiling guard on subtraction
(``mpitree_tpu/core/builder.py:492-505``) has nothing to guard here.
"""

from __future__ import annotations

import torch

from mpitree_tpu_torch.ops.hist_kernel import (
    histogram,
    payload_stats,
    scale_from_stats,
)

__all__ = ["class_histogram", "class_payload", "gbdt_payload", "histogram",
           "moment_payload", "payload_scale", "sibling_accumulate_slots",
           "sibling_reconstruct", "sibling_reconstruct_pair"]


def class_payload(y: torch.Tensor, w: torch.Tensor | None,
                  n_classes: int) -> torch.Tensor:
    """(N,) labels + (N,) weights (None = 1) -> (N, C) ``w * onehot(y)``
    (``mpitree_tpu/ops/pallas_hist.py:245``)."""
    onehot = torch.nn.functional.one_hot(y.long(), n_classes).to(
        torch.float32)
    return onehot if w is None else onehot * w.to(torch.float32)[:, None]


def moment_payload(y: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(N,) targets + (N,) weights -> (N, 3) ``(w, w*y, w*y^2)`` in
    float32, the products in the JAX package's order
    (``mpitree_tpu/ops/pallas_hist.py:251``)."""
    y32 = y.to(torch.float32)
    w32 = w.to(torch.float32)
    return torch.stack([w32, w32 * y32, w32 * y32 * y32], dim=1)


def gbdt_payload(g: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """(N,) gradients + hessians -> (N, 3) ``(count, g, h)``
    (``mpitree_tpu/ops/pallas_hist.py:257``); ``h == 0`` marks rows outside
    a boosting round's subsample, which add to no channel, the count and
    the gradient included, as in ``grad_hess_histogram``
    (``mpitree_tpu/ops/histogram.py:300``)."""
    live = h > 0
    g32 = torch.where(live, g.to(torch.float32),
                      torch.zeros((), device=g.device))
    return torch.stack([live.to(torch.float32), g32, h.to(torch.float32)],
                       dim=1)


def payload_scale(payload: torch.Tensor):
    """The route of a fit, chosen once from its ``(N, C)`` payload: None
    (the integer route) when every value is an integer and every
    channel's ``|v|`` sums below 2**24 (``hist_kernel.float32_exact``'s
    rule), else the fixed-point exponents
    (``hist_kernel.fixed_point_exponents``; raises on a non-finite
    value). The one-payload case of ``parallel/collective.payload_scale``,
    from the same statistics (``hist_kernel.payload_stats``)."""
    stats = payload_stats(payload)
    return scale_from_stats(bool((stats[0] > 0).all()),
                            stats[1].cpu().numpy(), stats[2].cpu().numpy(),
                            n_rows=payload.shape[0], fixed=False)


def class_histogram(x_binned: torch.Tensor, y: torch.Tensor,
                    node_id: torch.Tensor, chunk_lo: int, *, n_slots: int,
                    n_bins: int, n_classes: int,
                    sample_weight: torch.Tensor | None = None,
                    **prepared) -> torch.Tensor:
    """Class counts (weighted by ``sample_weight``) into an
    (n_slots, F, n_classes, n_bins) histogram; signature of
    ``mpitree_tpu.ops.histogram.class_histogram``. ``prepared`` may name
    ``scale_exp`` (the fixed-point route)."""
    slot = (node_id - chunk_lo).to(torch.int32).contiguous()
    return histogram(
        x_binned.to(torch.int32).contiguous(),
        class_payload(y, sample_weight, n_classes).contiguous(), slot,
        n_slots=n_slots, n_bins=n_bins, **prepared,
    )


def sibling_accumulate_slots(node_id: torch.Tensor, chunk_lo: int,
                             is_small: torch.Tensor, *,
                             n_slots: int) -> torch.Tensor:
    """(N,) int32 compact slots for small-child-only accumulation.

    ``is_small`` (n_slots,) bool is True where the frontier slot holds the
    smaller sibling of its pair (one per live pair; pad slots True, so
    they read their pair's zero histogram in :func:`sibling_reconstruct`).
    Rows of small children map to their pair ``slot >> 1`` in an
    ``n_slots // 2``-slot histogram; rows of large children and rows
    outside the chunk map to -1, which every histogram route skips (the
    sorted route sorts them before ``seg_start[0]``)."""
    slot = node_id.to(torch.int64) - chunk_lo
    in_chunk = (slot >= 0) & (slot < n_slots)
    small = in_chunk & is_small[slot.clamp(0, n_slots - 1)]
    return torch.where(small, slot >> 1, -1).to(torch.int32)


def sibling_reconstruct(small_hist: torch.Tensor, parent_hist: torch.Tensor,
                        parent_slot: torch.Tensor,
                        is_small: torch.Tensor) -> torch.Tensor:
    """The (n_slots, ...) frontier histogram from the compact one.

    ``small_hist`` (n_slots // 2, ...) is the histogram of the rows
    :func:`sibling_accumulate_slots` kept; ``parent_hist`` the previous
    level's resident histogram (any width holding the parents);
    ``parent_slot`` (n_slots,) each slot's parent row in it (clamped, so
    pad slots may carry any value: they read their pair's zero histogram
    through ``is_small``). Small slots take their pair's histogram, large
    ones ``parent - small``: exact on both routes (float32 integer sums
    below 2**24, or int64). The dtype follows the inputs."""
    S = is_small.shape[0]
    pair = torch.arange(S, device=small_hist.device) >> 1
    ps = parent_slot.to(torch.int64).clamp(0, parent_hist.shape[0] - 1)
    small = small_hist.index_select(0, pair)
    parent = parent_hist.index_select(0, ps)
    mask = is_small.view((S,) + (1,) * (small.dim() - 1))
    return torch.where(mask, small, parent - small)


def sibling_reconstruct_pair(small_hist: torch.Tensor,
                             parent_hist: torch.Tensor,
                             is_small: torch.Tensor) -> torch.Tensor:
    """:func:`sibling_reconstruct` for one sibling pair, without a gather
    (the leaf-wise frontier expands one leaf a step): ``small_hist`` and
    ``parent_hist`` (1, ...), ``is_small`` (2,) bool; returns the (2, ...)
    pair histogram under the same exactness."""
    shape = (2,) + tuple(small_hist.shape[1:])
    small = small_hist.expand(shape)
    parent = parent_hist.expand(shape)
    mask = is_small.view((2,) + (1,) * (small_hist.dim() - 1))
    return torch.where(mask, small, parent - small)

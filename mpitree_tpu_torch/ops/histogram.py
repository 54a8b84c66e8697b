"""Per-(node, feature, channel, bin) histograms — the build's hot op.

Counterpart of ``mpitree_tpu/ops/histogram.py``. Frontier nodes are
addressed by *slot* ``node_id - chunk_lo`` (node ids are assigned level by
level, so a frontier is a contiguous id range); rows parked in finished
leaves or at ``node_id == -1`` fall outside ``[0, n_slots)`` and add
nothing. The public layout is the JAX package's ``(S, F, C, B)``.

Every function runs the Hopper kernels on CUDA tensors and their plain
version on CPU tensors (``ops/hist_kernel.py``). A fit picks one of two
routes once, from its payload (:func:`payload_scale`):

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
"""

from __future__ import annotations

import torch

from mpitree_tpu_torch.ops.hist_kernel import (
    fixed_point_exponents,
    float32_exact,
    histogram,
)

__all__ = ["class_histogram", "class_payload", "gbdt_payload", "histogram",
           "moment_payload", "payload_scale"]

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
    (the integer route) when ``hist_kernel.float32_exact`` accepts it,
    else the fixed-point exponents (``hist_kernel.fixed_point_exponents``;
    raises on a non-finite value). One device-to-host copy."""
    if float32_exact(payload):
        return None
    return fixed_point_exponents(payload)


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

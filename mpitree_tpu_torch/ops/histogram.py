"""Per-(node, feature, class, bin) histograms — the build's hot op.

Counterpart of ``mpitree_tpu/ops/histogram.py``. Frontier nodes are
addressed by *slot* ``node_id - chunk_lo`` (node ids are assigned level by
level, so a frontier is a contiguous id range); rows parked in finished
leaves or at ``node_id == -1`` fall outside ``[0, n_slots)`` and add
nothing. The public layout is the JAX package's ``(S, F, C, B)`` float32.

Both functions run the Hopper kernels on CUDA tensors and their plain
version on CPU tensors (``ops/hist_kernel.py``). Counts and integer weights
are integer-valued float32 below 2**24, so sums are exact and
order-independent. The optional ``packed`` (byte-wide bins), ``order`` /
``seg_start`` (rows ordered by slot) and ``feat_bins`` arguments are
``hist_kernel.histogram``'s: what a fit prepares once and hands to every
call.
"""

from __future__ import annotations

import torch

from mpitree_tpu_torch.ops.hist_kernel import histogram

__all__ = ["class_histogram", "class_payload", "histogram"]


def class_payload(y: torch.Tensor, w: torch.Tensor | None,
                  n_classes: int) -> torch.Tensor:
    """(N,) labels + (N,) weights (None = 1) -> (N, C) ``w * onehot(y)``."""
    onehot = torch.nn.functional.one_hot(y.long(), n_classes).to(
        torch.float32)
    return onehot if w is None else onehot * w.to(torch.float32)[:, None]


def class_histogram(x_binned: torch.Tensor, y: torch.Tensor,
                    node_id: torch.Tensor, chunk_lo: int, *, n_slots: int,
                    n_bins: int, n_classes: int,
                    sample_weight: torch.Tensor | None = None,
                    **prepared) -> torch.Tensor:
    """Class counts (weighted by ``sample_weight``) into an
    (n_slots, F, n_classes, n_bins) histogram; signature of
    ``mpitree_tpu.ops.histogram.class_histogram``."""
    slot = (node_id - chunk_lo).to(torch.int32).contiguous()
    return histogram(
        x_binned.to(torch.int32).contiguous(),
        class_payload(y, sample_weight, n_classes).contiguous(), slot,
        n_slots=n_slots, n_bins=n_bins, **prepared,
    )

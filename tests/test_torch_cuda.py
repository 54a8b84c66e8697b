"""The Hopper histogram kernels against their plain version, on the card.

These tests need a CUDA card and ``nvcc``; elsewhere they skip. Run them
on the machine with the card with ``python -m pytest -m cuda
tests/test_torch_cuda.py``. Integer-valued payloads sum exactly in float32
in any order, so the kernels must equal the plain version bit for bit.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from mpitree_tpu_torch.ops import hist_kernel

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("S", [1, 8, 40, 64, 128, 512, 2048])
def test_kernel_variants_equal_plain_version(cuda, S):
    rng = np.random.default_rng(S)
    N, F, C, B = 20_000, 54, 7, 256
    xb = torch.from_numpy(
        rng.integers(0, B, size=(N, F)).astype(np.int32)).to(cuda)
    xb[:, 10:] = xb[:, 10:] % 2  # one-hot-like two-bin columns
    y = torch.from_numpy(rng.integers(0, C, size=N)).to(cuda)
    w = torch.from_numpy(rng.integers(0, 4, size=N).astype(np.float32)).to(cuda)
    payload = (torch.nn.functional.one_hot(y, C).float() * w[:, None]).contiguous()
    slot = torch.from_numpy(
        rng.integers(-2, S + 2, size=N).astype(np.int32)).to(cuda)
    before = dict(hist_kernel.launches)
    got = hist_kernel.histogram(xb, payload, slot, n_slots=S, n_bins=B)
    torch.cuda.synchronize()
    variant = hist_kernel.plan(S, F, C, B)["variant"]
    assert hist_kernel.launches[variant] == before[variant] + 1
    want = hist_kernel.histogram_reference(xb, payload, slot, n_slots=S,
                                           n_bins=B)
    assert torch.equal(got, want)


def test_wrapper_refuses_what_the_kernels_do_not_take(cuda):
    xb = torch.zeros((8, 3), dtype=torch.int32, device=cuda)
    payload = torch.ones((8, 2), device=cuda)
    slot = torch.zeros(8, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="int32"):
        hist_kernel.histogram(xb.long(), payload, slot, n_slots=1, n_bins=2)
    with pytest.raises(ValueError, match="contiguous"):
        hist_kernel.histogram(xb.t().contiguous().t(), payload, slot,
                              n_slots=1, n_bins=2)
    with pytest.raises(ValueError, match="row counts"):
        hist_kernel.histogram(xb, payload[:4], slot, n_slots=1, n_bins=2)


def test_fractional_weights_refused_on_the_card(cuda):
    from mpitree_tpu_torch.tree import DecisionTreeClassifier
    from mpitree_tpu_torch.utils.datasets import covtype_like

    X, y = covtype_like(500, seed=0)
    w = np.full(len(y), 0.5, np.float32)
    with pytest.raises(NotImplementedError, match="fractional"):
        DecisionTreeClassifier(max_depth=3, device="cuda").fit(
            X, y, sample_weight=w
        )
    DecisionTreeClassifier(max_depth=3, device="cuda").fit(
        X, y, sample_weight=2 * w
    )

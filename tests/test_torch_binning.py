"""The port's binning against ``mpitree_tpu.ops.binning.bin_dataset``.

Host binning (numpy, modes auto/exact/quantile) and the torch binning on
the CPU (modes auto/quantile; exact is host-only in both packages) must
give bit-identical thresholds, candidate counts, bin ids and the
``quantized`` flag: edges are selected data values, never arithmetic.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from mpitree_tpu_torch.ops import binning as port_bin  # noqa: E402
from mpitree_tpu_torch.utils.datasets import covtype_like  # noqa: E402


def _data(kind):
    rng = np.random.default_rng(5)
    if kind == "covtype":
        return covtype_like(3000, seed=4)[0]
    if kind == "integers":  # few uniques: auto stays exact on every column
        return rng.integers(0, 9, size=(1500, 4)).astype(np.float32)
    # heavy duplicates mixed with continuous columns and a constant column
    X = rng.normal(size=(2500, 5)).astype(np.float32)
    X[:, 1] = np.round(X[:, 1] * 3)
    X[:, 3] = 2.5
    return X


def _same(got, want):
    np.testing.assert_array_equal(got.thresholds, want.thresholds)
    np.testing.assert_array_equal(got.n_cand, want.n_cand)
    assert got.n_bins == want.n_bins
    assert got.quantized == want.quantized
    xb = got.x_binned
    xb = xb.numpy() if isinstance(xb, torch.Tensor) else xb
    assert xb.dtype == np.int32
    np.testing.assert_array_equal(xb, np.asarray(want.x_binned))


@pytest.mark.parametrize("kind", ["covtype", "integers", "mixed"])
@pytest.mark.parametrize("binning", ["auto", "exact", "quantile"])
@pytest.mark.parametrize("max_bins", [16, 256])
def test_host_and_torch_binning_match_jax(kind, binning, max_bins):
    from mpitree_tpu.ops.binning import bin_dataset as jax_bin

    X = _data(kind)
    want = jax_bin(X, max_bins=max_bins, binning=binning)
    _same(port_bin.bin_dataset(X, max_bins=max_bins, binning=binning), want)
    _same(port_bin.bin_for_engine(X, max_bins=max_bins, binning=binning,
                                  device=torch.device("cpu")), want)
    if binning != "exact":
        _same(port_bin.bin_dataset_torch(
            X, max_bins=max_bins, binning=binning,
            device=torch.device("cpu"),
        ), want)


def test_torch_binning_refuses_exact_mode():
    with pytest.raises(ValueError, match="exact"):
        port_bin.bin_dataset_torch(
            np.zeros((3, 1), np.float32), binning="exact",
            device=torch.device("cpu"),
        )


def test_bin_with_thresholds_reproduces_ids():
    X = _data("mixed")
    b = port_bin.bin_dataset(X, max_bins=32)
    np.testing.assert_array_equal(
        port_bin.bin_with_thresholds(X, b.thresholds, b.n_cand), b.x_binned
    )

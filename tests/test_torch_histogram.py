"""The port's payload histogram (CPU, plain version) against the JAX package.

The same numpy inputs, made from a seed, go through
``mpitree_tpu_torch.ops.histogram`` on the CPU (the plain PyTorch version
of the Hopper kernel family, ``ops/hist_kernel.histogram_reference``) and
through three JAX references: the Pallas kernels K1/K2
(``pallas_hist.histogram_small`` in modes ``single`` and ``fgrid``) and K3
(``wide_hist.histogram_wide_pallas``), all in interpret mode as the JAX
package's own tests run them, plus the XLA scatter
``ops/histogram.class_histogram``.

Tolerances: integer-valued payloads (class counts times integer weights)
sum exactly in float32 in any order, so those comparisons are exact
equality. Non-integer payloads are compared with ``rtol=1e-5`` and
``atol=1e-5 * max|hist|``: float32 sums taken in another order.
"""

from __future__ import annotations

import ctypes

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from mpitree_tpu_torch.ops import hist_kernel  # noqa: E402
from mpitree_tpu_torch.ops import histogram as port_hist  # noqa: E402

# (N, F, C, B, S): S in {1, 8, 64, 256}, C in {2, 3, 7}, B in {5, 32, 256}
CASES = [
    (2000, 3, 2, 5, 1),
    (3000, 6, 7, 32, 8),
    (2500, 4, 3, 256, 8),
    (4000, 5, 7, 32, 64),
    (5000, 2, 3, 5, 256),
    (3000, 3, 7, 256, 256),
]


def _case(seed, N, F, C, B, S, *, weights="integer"):
    """Random bins, labels, weights and slots; slots run from -2 to S + 1
    so rows below and above the slot range are present."""
    rng = np.random.default_rng(seed)
    xb = rng.integers(0, B, size=(N, F)).astype(np.int32)
    y = rng.integers(0, C, size=N).astype(np.int32)
    slot = rng.integers(-2, S + 2, size=N).astype(np.int32)
    if weights == "integer":
        w = rng.integers(0, 4, size=N).astype(np.float32)
    else:
        w = rng.random(N).astype(np.float32) * 3.0
    return xb, y, slot, w


def _port(xb, y, slot, w, *, C, B, S):
    got = port_hist.class_histogram(
        torch.from_numpy(xb), torch.from_numpy(y.astype(np.int64)),
        torch.from_numpy(slot), 0, n_slots=S, n_bins=B, n_classes=C,
        sample_weight=torch.from_numpy(w),
    )
    assert got.dtype == torch.float32 and got.shape == (S, xb.shape[1], C, B)
    return got.numpy()


def _jax_ref(kind, xb, y, slot, w, *, C, B, S):
    import jax.numpy as jnp

    from mpitree_tpu.ops import histogram as jax_hist
    from mpitree_tpu.ops import pallas_hist as ph
    from mpitree_tpu.ops import wide_hist as wh

    if kind == "scatter":
        return np.asarray(jax_hist.class_histogram(
            jnp.asarray(xb), jnp.asarray(y), jnp.asarray(slot), jnp.int32(0),
            n_slots=S, n_bins=B, n_classes=C, sample_weight=jnp.asarray(w),
        ))
    payload = ph.class_payload(jnp.asarray(y), jnp.asarray(w), C)
    if kind in ("single", "fgrid"):
        return np.asarray(ph.histogram_small(
            jnp.asarray(xb), payload, jnp.asarray(slot), n_slots=S,
            n_bins=B, n_channels=C, interpret=True, mode=kind,
        ))
    return np.asarray(wh.histogram_wide_pallas(
        jnp.asarray(xb), payload, jnp.asarray(slot), n_slots=S, n_bins=B,
        n_channels=C, window=wh.WINDOW, interpret=True,
    ))


def _kinds(S):
    kinds = ["scatter", "single", "fgrid"]
    if S % 32 == 0:  # the K3 window layout needs S a multiple of WINDOW
        kinds.append("wide")
    return kinds


@pytest.mark.parametrize("case", CASES, ids=lambda c: "N{}F{}C{}B{}S{}".format(*c))
def test_class_histogram_exact_vs_jax_kernels(case):
    N, F, C, B, S = case
    xb, y, slot, w = _case(sum(case), *case)
    got = _port(xb, y, slot, w, C=C, B=B, S=S)
    for kind in _kinds(S):
        want = _jax_ref(kind, xb, y, slot, w, C=C, B=B, S=S)
        np.testing.assert_array_equal(got, want, err_msg=kind)


@pytest.mark.parametrize("case", CASES[1:4], ids=lambda c: "N{}F{}C{}B{}S{}".format(*c))
def test_class_histogram_fractional_weights_vs_scatter(case):
    """Non-integer payloads: float32 sums in another order (tolerance in
    the module docstring)."""
    N, F, C, B, S = case
    xb, y, slot, w = _case(7 + sum(case), *case, weights="fractional")
    got = _port(xb, y, slot, w, C=C, B=B, S=S)
    want = _jax_ref("scatter", xb, y, slot, w, C=C, B=B, S=S)
    np.testing.assert_allclose(
        got, want, rtol=1e-5, atol=1e-5 * float(np.abs(want).max())
    )


def test_generic_histogram_general_payload():
    """The generic (N, C) payload ABI (regression moments, gbdt triples in
    later slices) against a numpy loop, exact for integer payloads."""
    rng = np.random.default_rng(3)
    N, F, C, B, S = 700, 3, 3, 9, 5
    xb = rng.integers(0, B, size=(N, F)).astype(np.int32)
    payload = rng.integers(-3, 4, size=(N, C)).astype(np.float32)
    slot = rng.integers(-1, S + 1, size=N).astype(np.int32)
    got = port_hist.histogram(
        torch.from_numpy(xb), torch.from_numpy(payload),
        torch.from_numpy(slot), n_slots=S, n_bins=B,
    ).numpy()
    want = np.zeros((S, F, C, B), np.float32)
    for r in range(N):
        if 0 <= slot[r] < S:
            for f in range(F):
                want[slot[r], f, :, xb[r, f]] += payload[r]
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("S,variant", [
    (1, "small"), (8, "wide"), (64, "wide"), (128, "wide"), (512, "wide"),
    (2048, "wide"),
])
def test_plan_variant_and_shared_memory_budget(S, variant):
    """The launch plan at covtype width (F=54, C=7, B=256): which variant
    serves each frontier width, and the shared-memory tile within the
    227 KB a Hopper block may use."""
    p = hist_kernel.plan(S, 54, 7, 256)
    assert p["variant"] == variant
    if variant == "small":
        assert p["smem"] <= hist_kernel.SMEM_BYTES
        assert p["feat_per_block"] * p["n_fgroups"] >= 54
        assert p["feat_per_block"] * (p["n_fgroups"] - 1) < 54


def test_plan_forced_variant():
    """A named variant gets its own tiling, or ValueError where its tile
    cannot fit (``chip_smoke.py`` times the variants against each other)."""
    assert hist_kernel.plan(1, 54, 7, 256, "wide") == {"variant": "wide"}
    p = hist_kernel.plan(32, 54, 7, 256, "small")
    assert p["feat_per_block"] == 1 and p["smem"] <= hist_kernel.SMEM_BYTES
    with pytest.raises(ValueError, match="does not fit"):
        hist_kernel.plan(64, 54, 7, 256, "small")


def test_ctypes_signatures_match_the_c_source():
    """Every argument ctypes declares matches the extern "C" launch
    function's parameter list in csrc/histogram.cu: a pointer for each
    pointer (ctypes would cut an undeclared one to 32 bits), an int for
    each int."""
    import re
    from pathlib import Path

    src = (Path(hist_kernel.__file__).parents[1] / "csrc" /
           "histogram.cu").read_text()
    for name, argtypes in hist_kernel._SIGNATURES.items():
        params = re.search(name + r"\(([^)]*)\)", src).group(1).split(",")
        kinds = ["ptr" if "*" in q else "int" for q in params]
        want = ["ptr" if t is ctypes.c_void_p else "int" for t in argtypes]
        assert kinds == want, name


def test_cuda_entry_refuses_cpu_tensors():
    """``histogram_cuda`` takes CUDA tensors only: a CPU tensor reaching it
    raises instead of silently taking the plain path."""
    xb = torch.zeros((4, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        hist_kernel.histogram_cuda(
            xb, torch.ones((4, 2)), torch.zeros(4, dtype=torch.int32),
            n_slots=1, n_bins=2,
        )

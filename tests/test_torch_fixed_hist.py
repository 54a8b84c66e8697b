"""The histogram's fixed-point route on the CPU, against the JAX package.

Non-integer payloads (fractional class weights, the regression moments
``(w, w*y, w*y^2)``, GBDT's ``(count, g, h)``) take the int64 fixed-point
route of ``mpitree_tpu_torch/ops/hist_kernel.py``. Its plain version is
held here:

- against an exact float64 sum of the same float32 values, within the
  quantization bound (a value moves by at most ``2**-(k+1)``);
- against the JAX package's float32 XLA scatter (``moment_histogram``,
  ``class_histogram`` with fractional weights, ``grad_hess_histogram``)
  within float32 rounding: ``|port - jax| <= 1e-6 * sum |v|`` over the
  cell. The bound is relative to the cell's absolute mass because the
  signed channels (``w*y``, ``g``) cancel, and a float32 sum of a few
  hundred values errs by ~1e-7 of that mass (measured 3.3e-7 at most);
- bit for bit against itself under a shuffled row order, and with the
  fit's packed bins and slot order;

plus the route choice, the exponents, and the two sweeps that read the
int64 histogram. The kernels themselves are held against this plain
version on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``
phase 12).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from mpitree_tpu_torch.core.builder import BuildConfig, chunk_bytes_per_slot  # noqa: E402,E501
from mpitree_tpu_torch.ops import hist_kernel  # noqa: E402
from mpitree_tpu_torch.ops import histogram as ph  # noqa: E402
from mpitree_tpu_torch.ops import impurity as pimp  # noqa: E402

N, F, B, S = 3000, 6, 16, 5


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    xb = rng.integers(0, B, (N, F)).astype(np.int32)
    nid = rng.integers(-1, S + 1, N).astype(np.int32)
    return dict(
        xb=xb, nid=nid,
        y=rng.normal(0, 1.5, N).astype(np.float32),
        w=rng.uniform(0.5, 2, N).astype(np.float32),
        cls=rng.integers(0, 4, N).astype(np.int64),
        g=rng.normal(0, 1, N).astype(np.float32),
        h=np.where(rng.random(N) < 0.2, 0.0,
                   rng.uniform(0.05, 0.25, N)).astype(np.float32),
    )


def _port(d, payload):
    se = hist_kernel.fixed_point_exponents(payload)
    q = hist_kernel.histogram_reference(
        torch.from_numpy(d["xb"]), payload, torch.from_numpy(d["nid"]),
        n_slots=S, n_bins=B, scale_exp=se)
    assert q.dtype == torch.int64
    return q, se


def _mass(d, payload):
    """Per-cell sum of |v| (float64), the scale of the float32 bound."""
    out = np.zeros((S, F, payload.shape[1], B))
    live = (d["nid"] >= 0) & (d["nid"] < S)
    p = payload.abs().double().numpy()[live]
    s, xb = d["nid"][live], d["xb"][live]
    for c in range(payload.shape[1]):
        for f in range(F):
            np.add.at(out[:, f, c, :], (s, xb[:, f]), p[:, c])
    return out


def _exact(d, payload):
    """Exact float64 sums of the float32 payload (no cancellation trouble:
    these magnitudes span far fewer than 53 bits)."""
    out = np.zeros((S, F, payload.shape[1], B))
    live = (d["nid"] >= 0) & (d["nid"] < S)
    p = payload.double().numpy()[live]
    s, xb = d["nid"][live], d["xb"][live]
    for c in range(payload.shape[1]):
        for f in range(F):
            np.add.at(out[:, f, c, :], (s, xb[:, f]), p[:, c])
    return out


def _payload(d, kind):
    if kind == "moments":
        return ph.moment_payload(torch.from_numpy(d["y"]),
                                 torch.from_numpy(d["w"])).contiguous()
    if kind == "class":
        return ph.class_payload(torch.from_numpy(d["cls"]),
                                torch.from_numpy(d["w"]), 4).contiguous()
    return ph.gbdt_payload(torch.from_numpy(d["g"]),
                           torch.from_numpy(d["h"])).contiguous()


def _jax(d, kind):
    from mpitree_tpu.ops import histogram as jh

    xb, nid = jnp.asarray(d["xb"]), jnp.asarray(d["nid"])
    if kind == "moments":
        h = jh.moment_histogram(xb, jnp.asarray(d["y"]), nid, 0, n_slots=S,
                                n_bins=B, sample_weight=jnp.asarray(d["w"]))
    elif kind == "class":
        h = jh.class_histogram(xb, jnp.asarray(d["cls"]), nid, 0, n_slots=S,
                               n_bins=B, n_classes=4,
                               sample_weight=jnp.asarray(d["w"]))
    else:
        h = jh.grad_hess_histogram(xb, jnp.asarray(d["g"]),
                                   jnp.asarray(d["h"]), nid, 0, n_slots=S,
                                   n_bins=B)
    return np.asarray(h)


@pytest.mark.parametrize("kind", ["moments", "class", "gbdt"])
def test_fixed_route_matches_jax_scatter_within_float32(data, kind):
    payload = _payload(data, kind)
    q, se = _port(data, payload)
    got = hist_kernel.dequantize(q, se, dim=2).numpy()
    exact = _exact(data, payload)
    # each value moves by at most 2**-(k+1) when it is quantized
    bound = np.array([N * 2.0 ** -(k + 1) for k in se])[None, None, :, None]
    assert (np.abs(got - exact) <= bound).all()
    want = _jax(data, kind)
    assert want.shape == got.shape
    assert (np.abs(got - want) <= 1e-6 * _mass(data, payload)).all()


@pytest.mark.parametrize("kind", ["moments", "class", "gbdt"])
def test_fixed_route_is_bitwise_order_independent(data, kind):
    payload = _payload(data, kind)
    q, se = _port(data, payload)
    perm = np.random.default_rng(5).permutation(N)
    got = hist_kernel.histogram_reference(
        torch.from_numpy(data["xb"][perm]), payload[perm].contiguous(),
        torch.from_numpy(data["nid"][perm]), n_slots=S, n_bins=B,
        scale_exp=se)
    assert torch.equal(got, q)
    # the fit's packed bins and slot order give the same bits
    xb = torch.from_numpy(data["xb"])
    slot = torch.from_numpy(data["nid"])
    order, seg = hist_kernel.slot_segments(slot, S)
    again = ph.histogram(xb, payload, slot, n_slots=S, n_bins=B,
                         packed=hist_kernel.pack_bins(xb, B), order=order,
                         seg_start=seg, scale_exp=se)
    assert torch.equal(again, q)


def test_exponents_zero_channel_cap_and_non_finite():
    p = torch.tensor([[0.0, 1.5, 2.0 ** -80, 1.0],
                      [0.0, -0.25, 0.0, 3.0]])
    se = hist_kernel.fixed_point_exponents(p)
    # 62 - ceil(log2 2) - ceil(log2 max|v|); a zero channel gets 0
    assert se == (0, 62 - 1 - 1, hist_kernel.MAX_SCALE_EXP, 62 - 1 - 2)
    # no partial sum of N values can reach 2**63
    n = 1 << 20
    big = torch.full((4, 1), 7.9)
    (k,) = hist_kernel.fixed_point_exponents(big, n_rows=n)
    assert n * round(7.9 * 2.0 ** k) < 2 ** 63
    for bad in (np.nan, np.inf):
        p2 = p.clone()
        p2[1, 1] = bad
        with pytest.raises(ValueError, match="NaN or infinity"):
            hist_kernel.fixed_point_exponents(p2)


def test_quantize_is_exact_for_float32_weights():
    w = torch.from_numpy(np.random.default_rng(2).uniform(
        0.5, 2, 100_000).astype(np.float32))[:, None]
    se = hist_kernel.fixed_point_exponents(w)
    q = hist_kernel.quantize(w, se)
    assert torch.equal(hist_kernel.dequantize(q, se, dim=1), w.double())
    # round half to even, as the kernels' __double2ll_rn
    half = torch.tensor([[0.5], [1.5], [2.5], [-0.5]])
    assert hist_kernel.quantize(half, (0,))[:, 0].tolist() == [0, 2, 2, 0]


def test_payload_scale_picks_the_route():
    y = torch.tensor([0, 1, 2, 1])
    ints = ph.class_payload(y, torch.tensor([1.0, 0.0, 3.0, 2.0]), 3)
    assert ph.payload_scale(ints) is None
    frac = ph.class_payload(y, torch.tensor([1.0, 0.5, 3.0, 2.0]), 3)
    assert ph.payload_scale(frac) == hist_kernel.fixed_point_exponents(frac)
    # integer sums at 2**24 and beyond are not exact in float32
    heavy = torch.full((2, 1), 2.0 ** 23)
    assert ph.payload_scale(heavy) is not None


def test_float32_exact_rechecks_a_payload_changed_in_place():
    p = torch.tensor([[1.0, 0.0], [2.0, 3.0]])
    assert hist_kernel.float32_exact(p)
    assert hist_kernel.float32_exact(p)  # remembered
    p[0, 0] = 0.5
    assert not hist_kernel.float32_exact(p)
    p[0, 0] = 2.0 ** 24
    assert not hist_kernel.float32_exact(p)
    p[0, 0] = 4.0
    assert hist_kernel.float32_exact(p)
    assert hist_kernel.float32_exact(torch.zeros((0, 3)))


def test_planner_prices_eight_byte_cells():
    fb = [256] * 10 + [2] * 44  # covtype
    four = hist_kernel.plan(1, 54, 7, 256, feat_bins=fb, n_rows=581_012)
    eight = hist_kernel.plan(1, 54, 7, 256, feat_bins=fb, n_rows=581_012,
                             fixed=True)
    assert (four["cell_bytes"], eight["cell_bytes"]) == (4, 8)
    assert len(eight["groups"]) == 1 and eight["blocks_per_sm"] == 1
    cells = sum(7 * (v | 1) for v in fb)
    assert eight["smem"] >= 8 * cells > hist_kernel.SMEM_PER_SM // 2
    assert eight["smem"] <= hist_kernel.SMEM_BYTES
    assert four["blocks_per_sm"] == 2
    sorted8 = hist_kernel.plan(2048, 54, 7, 256, feat_bins=fb, fixed=True)
    assert sorted8["route"] == "sorted" and sorted8["cell_bytes"] == 8
    with pytest.raises(ValueError, match="8-byte cells"):
        hist_kernel.plan(64, 54, 7, 256, "stream", feat_bins=fb, fixed=True)
    assert chunk_bytes_per_slot(54, 256, 7, 8) - chunk_bytes_per_slot(
        54, 256, 7) == 54 * 256 * 7 * 4
    assert BuildConfig().task == "classification"


def test_classification_sweep_reads_the_int64_histogram(data):
    payload = _payload(data, "class")
    q, se = _port(data, payload)
    exact = torch.from_numpy(_exact(data, payload))
    cand = torch.ones((F, B), dtype=torch.bool)
    got = pimp.best_split_classification(q, cand, scale_exp=se)
    ref = pimp.cost_sweep_f64(exact, "entropy", f64_out=True)
    mine = pimp.cost_sweep_f64(q, "entropy", se, f64_out=True)
    for a, b in zip(mine, ref):
        if a is not None:
            assert torch.equal(a, b)
    assert got.counts.dtype == torch.float64
    assert torch.equal(got.counts, exact[:, 0].sum(dim=-1))
    assert torch.equal(got.n, exact[:, 0].sum(dim=(-1, -2)))


def test_regression_sweep_matches_jax_on_exact_sums(data):
    """On a float32 histogram that holds the exact sums, the JAX package's
    ``best_split_regression`` and the port's (which rounds its exact int64
    left/right sums to float32) pick the same splits."""
    from mpitree_tpu.ops import impurity as jimp

    payload = _payload(data, "moments")
    q, se = _port(data, payload)
    cand = np.random.default_rng(3).random((F, B)) < 0.9
    got = pimp.best_split_regression(q, torch.from_numpy(cand),
                                     scale_exp=se, min_child_weight=2.0)
    want = jimp.best_split_regression(
        jnp.asarray(hist_kernel.dequantize(q, se, dim=2).float().numpy()),
        jnp.asarray(cand), min_child_weight=2.0)
    assert got.feature.tolist() == np.asarray(want.feature).tolist()
    assert got.bin.tolist() == np.asarray(want.bin).tolist()
    np.testing.assert_allclose(got.cost.numpy(), np.asarray(want.cost),
                               rtol=1e-5)
    np.testing.assert_allclose(got.counts.numpy(), np.asarray(want.counts),
                               rtol=1e-6, atol=1e-3)
    assert got.constant.tolist() == np.asarray(want.constant).tolist()

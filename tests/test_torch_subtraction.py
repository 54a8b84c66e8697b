"""Sibling-subtraction histograms of the port against the JAX package.

- ``ops/histogram.py``: ``sibling_accumulate_slots``,
  ``sibling_reconstruct`` and ``sibling_reconstruct_pair`` equal the JAX
  package's bit for bit on seeded inputs, on integer float32 counts and on
  int64 sums beyond 2**32 (JAX with 64-bit types enabled); pad slots read
  zero.
- the levelwise engine (``core/builder.py``) grows the same tree with
  subtraction on and off, field for field, and the JAX levelwise engine's
  tree with ``hist_subtraction="on"``, including multi-chunk frontiers
  whose per-chunk parent histograms carry over (a small
  ``max_frontier_chunk``) and a ``hist_budget_bytes`` too small to keep
  them (the level then accumulates directly), on the integer and the
  fixed-point routes.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mpitree_tpu_torch.core import builder as pbuilder  # noqa: E402
from mpitree_tpu_torch.core.builder import BuildConfig, build_tree  # noqa: E402
from mpitree_tpu_torch.ops import histogram as ph  # noqa: E402
from mpitree_tpu_torch.ops.binning import bin_dataset  # noqa: E402
from mpitree_tpu_torch.utils.datasets import covtype_like  # noqa: E402

FIELDS = ("feature", "threshold", "left", "right", "parent", "depth",
          "value", "count", "n_node_samples", "impurity")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread for this module: under pytest-xdist's parallel
    workers torch's intra-op threads oversubscribe the cores; the trees do
    not depend on the thread count (exact sums)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same_tree(got, want, msg=""):
    assert got.n_nodes == want.n_nodes, msg
    for k in FIELDS:
        a, b = getattr(got, k), getattr(want, k)
        assert a.dtype == b.dtype, (msg, k)
        np.testing.assert_array_equal(a, b, err_msg=f"{msg} {k}")


def _pair_inputs(seed, S=16, P=8, dtype=np.float32, big=False):
    """A compact small-child histogram, a resident parent histogram that
    holds every small child, parent slots and a smaller-sibling mask whose
    last pair is padding."""
    rng = np.random.default_rng(seed)
    shape = (3, 2, 5)
    hi = 2**40 if big else 50
    small = rng.integers(0, hi, size=(S // 2,) + shape).astype(dtype)
    is_small = np.zeros(S, bool)
    is_small[0::2] = rng.random(S // 2) < 0.5
    is_small[1::2] = ~is_small[0::2]
    is_small[-2:] = True  # a pad pair
    small[-1] = 0  # pads accumulate nothing
    pslot = rng.integers(0, P, size=S // 2).repeat(2).astype(np.int32)
    pslot[-2:] = 10**6  # pads may carry any parent slot
    parent = rng.integers(0, hi, size=(P,) + shape).astype(dtype)
    np.add.at(parent, pslot[:-2:2], small[:-1])  # parents hold them
    return small, parent, pslot, is_small


def _jax_x64(fn):
    with jax.enable_x64(True):
        return np.asarray(fn())


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("route", ["float32", "int64"])
def test_sibling_reconstruct_bit_identical(seed, route):
    from mpitree_tpu.ops import histogram as jh

    big = route == "int64"
    dtype = np.int64 if big else np.float32
    small, parent, pslot, is_small = _pair_inputs(seed, dtype=dtype, big=big)
    got = ph.sibling_reconstruct(
        torch.from_numpy(small), torch.from_numpy(parent),
        torch.from_numpy(pslot), torch.from_numpy(is_small)).numpy()
    want = _jax_x64(lambda: jh.sibling_reconstruct(
        jnp.asarray(small), jnp.asarray(parent), jnp.asarray(pslot),
        jnp.asarray(is_small)))
    assert got.dtype == want.dtype == dtype
    np.testing.assert_array_equal(got, want)
    # pad slots read zero; each pair's two halves sum to its parent
    assert not got[-2:].any()
    live = slice(0, len(is_small) - 2)
    np.testing.assert_array_equal(
        got[live][0::2] + got[live][1::2], parent[pslot[live][0::2]])


@pytest.mark.parametrize("route", ["float32", "int64"])
def test_sibling_reconstruct_pair_bit_identical(route):
    from mpitree_tpu.ops import histogram as jh

    big = route == "int64"
    dtype = np.int64 if big else np.float32
    small, parent, _, _ = _pair_inputs(7, dtype=dtype, big=big)
    for flags in ([True, False], [False, True]):
        ism = np.array(flags)
        got = ph.sibling_reconstruct_pair(
            torch.from_numpy(small[:1]), torch.from_numpy(parent[:1]),
            torch.from_numpy(ism)).numpy()
        want = _jax_x64(lambda: jh.sibling_reconstruct_pair(
            jnp.asarray(small[:1]), jnp.asarray(parent[:1]),
            jnp.asarray(ism)))
        assert got.dtype == want.dtype == dtype
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got[0] + got[1], parent[0])


@pytest.mark.parametrize("chunk_lo", [0, 5, 16])
def test_sibling_accumulate_slots_bit_identical(chunk_lo):
    from mpitree_tpu.ops import histogram as jh

    rng = np.random.default_rng(chunk_lo)
    S = 16
    nid = rng.integers(-1, 40, size=500).astype(np.int32)
    ism = rng.random(S) < 0.5
    got = ph.sibling_accumulate_slots(
        torch.from_numpy(nid), chunk_lo, torch.from_numpy(ism), n_slots=S)
    want = jh.sibling_accumulate_slots(
        jnp.asarray(nid), jnp.int32(chunk_lo), jnp.asarray(ism), n_slots=S)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # rows of large siblings and outside the chunk sort before every
    # segment of the compact histogram
    from mpitree_tpu_torch.ops import hist_kernel

    order, seg = hist_kernel.slot_segments(got, S // 2)
    parked = (got < 0).sum().item()
    assert seg[0].item() == parked
    assert (got[order[:parked].long()] < 0).all()


# -- trees ------------------------------------------------------------------

@pytest.fixture(scope="module")
def data():
    X, y = covtype_like(4_000, seed=8)
    w = np.random.default_rng(8).uniform(0.5, 2.0, len(y)).astype(np.float32)
    return X, y, w


def _port_binned(X):
    b = bin_dataset(X, max_bins=32, binning="quantile")
    return dataclasses.replace(b, x_binned=torch.from_numpy(b.x_binned))


CASES = {
    "one-chunk": dict(max_depth=9),
    "multi-chunk": dict(max_depth=10, max_frontier_chunk=32,
                        frontier_tiers=(8,)),
    "over-budget": dict(max_depth=10, max_frontier_chunk=32,
                        frontier_tiers=(8,), hist_budget_bytes=2_000_000),
}


@pytest.fixture(scope="module")
def jax_trees(data):
    """The JAX levelwise engine with subtraction forced on, per case."""
    from mpitree_tpu.core.builder import BuildConfig as JConfig
    from mpitree_tpu.core.builder import build_tree as jbuild
    from mpitree_tpu.ops.binning import bin_dataset as jbin
    from mpitree_tpu.parallel import mesh as mesh_lib

    X, y, _ = data
    jb = jbin(X, max_bins=32, binning="quantile")
    mesh = mesh_lib.resolve_mesh(n_devices=1)
    out = {}
    for name, kw in CASES.items():
        jkw = dict(kw)
        jkw.pop("frontier_tiers", None)  # JAX levelwise keeps Pallas tiers only
        out[name] = jbuild(jb, y, config=JConfig(
            engine="levelwise", hist_subtraction="on", **jkw), mesh=mesh,
            n_classes=7)
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_levelwise_subtraction_on_off_and_jax(data, jax_trees, case,
                                              monkeypatch):
    X, y, _ = data
    binned = _port_binned(X)
    calls = []
    real = pbuilder.sibling_reconstruct
    monkeypatch.setattr(pbuilder, "sibling_reconstruct",
                        lambda *a: calls.append(1) or real(*a))
    trees = {
        sub: build_tree(binned, y, config=BuildConfig(
            engine="levelwise", hist_subtraction=sub, **CASES[case]),
            n_classes=7)
        for sub in ("off", "on")
    }
    _same_tree(trees["on"], trees["off"], "on vs off")
    _same_tree(trees["on"], jax_trees[case], "port vs JAX")
    assert trees["on"].n_nodes > 64  # frontiers past the 32-slot chunk
    assert calls, "subtraction never ran"


def test_levelwise_subtraction_fixed_point_route(data):
    """Fractional weights (the int64 route) and regression: subtraction
    on equals off, field for field."""
    from mpitree_tpu_torch.utils.datasets import california_like

    X, y, w = data
    binned = _port_binned(X)
    kw = CASES["multi-chunk"]
    a, b = (build_tree(binned, y, config=BuildConfig(
        engine="levelwise", hist_subtraction=sub, **kw), n_classes=7,
        sample_weight=w) for sub in ("off", "on"))
    _same_tree(b, a, "weighted")
    Xr, yr = california_like(3_000, seed=2)
    rb = _port_binned(Xr)
    y32 = (yr - yr.mean()).astype(np.float32)
    a, b = (build_tree(rb, y32, config=BuildConfig(
        task="regression", criterion="mse", engine="levelwise",
        hist_subtraction=sub, **kw), refit_targets=yr)
        for sub in ("off", "on"))
    _same_tree(b, a, "regression")


def test_resolve_hist_subtraction(monkeypatch):
    cpu = torch.device("cpu")
    monkeypatch.delenv(pbuilder.SUBTRACTION_ENV, raising=False)
    assert pbuilder.resolve_hist_subtraction(BuildConfig(), cpu) is \
        pbuilder.SUBTRACTION_AUTO["cpu"]
    assert pbuilder.resolve_hist_subtraction(
        BuildConfig(hist_subtraction="on"), cpu)
    monkeypatch.setenv(pbuilder.SUBTRACTION_ENV, "on")
    assert pbuilder.resolve_hist_subtraction(BuildConfig(), cpu)
    # the knob steers "auto" only
    assert not pbuilder.resolve_hist_subtraction(
        BuildConfig(hist_subtraction="off"), cpu)
    monkeypatch.setenv(pbuilder.SUBTRACTION_ENV, "sometimes")
    with pytest.raises(ValueError, match="MPITREE_TPU_HIST_SUBTRACTION"):
        pbuilder.resolve_hist_subtraction(BuildConfig(), cpu)
    with pytest.raises(ValueError, match="unknown hist_subtraction"):
        pbuilder.resolve_hist_subtraction(
            BuildConfig(hist_subtraction="yes"), cpu)

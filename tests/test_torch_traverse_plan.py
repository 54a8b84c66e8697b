"""The traversal kernels' host side on the CPU: planner, reduction order,
normalized channel and node records.

The kernels themselves (``csrc/traverse.cu``) run only on the card
(``tests/test_torch_cuda.py``); what they are told to do is decided here,
in Python, and is tested here:

- :func:`serve_kernel.plan` tiles every (row, tree) pair exactly once,
  within the shared-memory budget, and spreads small batches over the SMs;
- reducing the leaf terms over the plan's tree chunks, in chunk order and
  with the kernel's per-column tree indexing, equals the plain version bit
  for bit (non-integer float64 values; ``percls`` with ``n_out`` not
  dividing T);
- ``sum`` over the channel normalized once equals ``norm`` over the counts
  bit for bit, which is what lets a compiled forest serve ``sum``;
- :func:`serve_kernel.pack_nodes` keeps every column bit for bit.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from mpitree_tpu_torch.serving import compile_model, quantize, serve_kernel
from mpitree_tpu_torch.serving import traversal
from mpitree_tpu_torch.serving.tables import TreeList, tables_for
from mpitree_tpu_torch.tree import RandomForestClassifier
from mpitree_tpu_torch.utils.datasets import covtype_like

F = 54


@pytest.fixture(scope="module")
def forest():
    X, y = covtype_like(3_000, seed=0)
    rf = RandomForestClassifier(n_estimators=6, max_depth=5, random_state=0,
                                device="cpu").fit(X, y)
    return rf, covtype_like(300, seed=1)[0]


def _table(rf, n_trees):
    """A flat table of ``n_trees`` members (the fitted trees repeated)."""
    trees = TreeList((list(rf.trees_) * n_trees)[:n_trees])
    [table] = tables_for(trees, group_bytes=None)
    return table, trees


@pytest.mark.parametrize("N", [0, 1, 64, 4_096, 500_000])
@pytest.mark.parametrize("T", [1, 6, 50, 2_000])
def test_plan_covers_every_pair_once_within_budget(T, N):
    for form, agg in (("traverse", "sum"), ("traverse", "norm"),
                      ("traverse", "percls"), ("traverse_q", "sum")):
        for n_out in (1, 7, 12):
            p = serve_kernel.plan(form, N, T, n_out, n_features=F, agg=agg)
            R, tc = p["rows_per_block"], p["trees_per_chunk"]
            # row tiles [b*R, (b+1)*R) for b < blocks cover [0, N) once
            assert R >= 1 and p["blocks"] * R >= N > (p["blocks"] - 1) * R
            # tree chunks cover [0, T) once, in member order
            bounds = [t for c in p["chunks"] for t in c]
            assert bounds[:1] == [0] * (T > 0) and bounds[-1:] == [T] * (T > 0)
            assert all(a < b for a, b in p["chunks"])
            assert all(p["chunks"][i][1] == p["chunks"][i + 1][0]
                       for i in range(len(p["chunks"]) - 1))
            assert all(b - a <= tc for a, b in p["chunks"])
            # one thread per pair of a chunk, whole warps
            assert R * tc <= p["threads"] <= 1024 and p["threads"] % 32 == 0
            acc = 8 if form == "traverse" else 4
            assert p["smem"] == serve_kernel._smem_bytes(
                R, tc, n_out, F, acc, agg == "norm", p["stage_x"])
            assert p["stage_x"] and p["smem"] <= serve_kernel.SMEM_STATIC
            # a batch spreads over the card's SMs as far as its rows allow
            assert p["blocks"] >= min(N, serve_kernel.N_SMS // 2)


def test_plan_budget_and_override():
    p = serve_kernel.plan("traverse", 4_096, 50, 7, n_features=F,
                          rows_per_block=16)
    assert (p["rows_per_block"], p["trees_per_chunk"]) == (16, 16)
    assert p["chunks"] == ((0, 16), (16, 32), (32, 48), (48, 50))
    with pytest.raises(ValueError, match="rows_per_block"):
        serve_kernel.plan("traverse", 64, 50, 7, n_features=F,
                          rows_per_block=0)
    # one row too wide to stage: X is read from global memory instead
    wide = serve_kernel.plan("traverse", 64, 50, 7, n_features=60_000)
    assert not wide["stage_x"] and wide["smem"] <= serve_kernel.SMEM_STATIC
    # more output columns than one block's shared memory holds
    with pytest.raises(ValueError, match="shared memory"):
        serve_kernel.plan("traverse", 64, 50, 40_000, n_features=F)


def _kernel_order(node, values, p, *, agg, n_out):
    """The kernel's reduction, written out: the plan's chunks in order,
    each output column adding its chunk trees in member order (``percls``
    with the kernel's first-tree formula), norm's row sum in channel
    order."""
    acc = torch.zeros((node.shape[0], n_out), dtype=values.dtype)
    for t0, t1 in p["chunks"]:
        tc = t1 - t0
        for c in range(n_out):
            js = (range(((c - t0) % n_out + n_out) % n_out, tc, n_out)
                  if agg == "percls" else range(tc))
            for j in js:
                v = values[node[:, t0 + j]]
                if agg == "percls":
                    term = v[:, 0]
                elif agg == "norm":
                    rowsum = torch.zeros(len(v), dtype=v.dtype)
                    for k in range(v.shape[1]):
                        rowsum = rowsum + v[:, k]
                    term = v[:, c] / torch.clamp(rowsum, min=1)
                else:
                    term = v[:, c]
                acc[:, c] = acc[:, c] + term
    return acc


@pytest.mark.parametrize("T,agg,n_out,R", [
    (1, "sum", 7, None), (6, "percls", 4, None), (50, "percls", 3, None),
    (50, "sum", 12, 16), (50, "norm", 7, 32), (300, "sum", 7, None),
    (300, "percls", 7, 8),
], ids=lambda v: str(v))
def test_chunked_reduction_equals_plain_version(forest, T, agg, n_out, R):
    rf, Xq = forest
    table, trees = _table(rf, T)
    cols = table.dev_arrays(torch.device("cpu"))[:5]
    rng = np.random.default_rng(T + n_out)
    if agg == "norm":
        vals = np.concatenate([t.count for t in trees])[table.scatter_order()]
    else:  # non-integer values: the order of the adds is what is tested
        vals = rng.standard_normal((table.n_nodes,
                                    n_out if agg == "sum" else 1))
    values = torch.from_numpy(np.ascontiguousarray(vals, np.float64))
    X = torch.from_numpy(Xq)
    p = serve_kernel.plan("traverse", len(X), T, n_out, n_features=F,
                          agg=agg, rows_per_block=R)
    node = traversal.descend(X, *cols, table.n_steps)
    want = serve_kernel.traverse_reference(X, *cols, values,
                                           n_steps=table.n_steps, agg=agg,
                                           n_out=n_out)
    got = _kernel_order(node, values, p, agg=agg, n_out=n_out)
    assert torch.equal(got, want)


def test_normalized_sum_equals_norm_bit_for_bit(forest):
    rf, Xq = forest
    table, trees = _table(rf, 6)
    counts = torch.from_numpy(np.ascontiguousarray(
        np.concatenate([t.count for t in trees])[table.scatter_order()],
        np.float64))
    node = traversal.descend(torch.from_numpy(Xq),
                             *table.dev_arrays(torch.device("cpu"))[:5],
                             table.n_steps)
    norm = traversal.accumulate(node, counts, agg="norm", n_out=7)
    summed = traversal.accumulate(node, traversal.normalize_rows(counts),
                                  agg="sum", n_out=7)
    assert torch.equal(summed, norm)
    cm = compile_model(rf)
    assert cm._agg == "sum" and cm._record is None  # CPU: no kernel
    assert cm.exact and np.array_equal(cm.raw(Xq), rf.predict_proba(Xq))


def test_pack_nodes_keeps_every_column(forest):
    rf, Xq = forest
    table, trees = _table(rf, 6)
    cpu = torch.device("cpu")
    feature, threshold, left, right, root, _ = table.dev_arrays(cpu)
    rec = table.dev_record(cpu)
    assert rec is table.dev_record(cpu)  # packed once, kept on the table
    assert rec.dtype == torch.int32 and rec.shape == (table.n_nodes, 4)
    assert torch.equal(rec[:, 0], feature)
    assert torch.equal(rec[:, 1], threshold.view(torch.int32))  # NaNs too
    assert torch.equal(rec[:, 2], left) and torch.equal(rec[:, 3], right)
    counts = np.concatenate([t.count for t in trees])[table.scatter_order()]
    state = quantize.build_state(
        table, quantize.prepare_channel("forest_proba", counts),
        kind="forest_proba", scale=6, n_steps=table.n_steps, tol=1.0,
        device=cpu, n_features=F)
    q = state.record
    assert torch.equal(q[:, 0].to(torch.int16), state.feature)
    assert torch.equal(q[:, 0], state.feature.to(torch.int32))
    # the bfloat16 bits are the float32 word's top half, the rest zero
    assert torch.equal((q[:, 1] >> 16).to(torch.int16),
                       state.threshold.view(torch.int16))
    assert not (q[:, 1] & 0xFFFF).any()
    assert torch.equal(q[:, 2], left) and torch.equal(q[:, 3], right)
    # the wrapper checks a record, and the plain version ignores it
    X = torch.from_numpy(Xq)
    kw = dict(n_steps=table.n_steps, agg="sum", n_out=7, n_features=F)
    got = serve_kernel.traverse_q(X, state.feature, state.threshold, left,
                                  right, root, state.qvals, record=q, **kw)
    assert torch.equal(got, serve_kernel.traverse_q(
        X, state.feature, state.threshold, left, right, root, state.qvals,
        **kw))
    with pytest.raises(ValueError, match="record"):
        serve_kernel.traverse_q(X, state.feature, state.threshold, left,
                                right, root, state.qvals, record=q[:-1],
                                **kw)

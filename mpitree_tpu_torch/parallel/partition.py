"""Partition-rule table: one map from build-state array names to their
placement on a mesh.

Counterpart of ``mpitree_tpu/parallel/partition.py:46-93``: the same
regexes, each with the JAX ``PartitionSpec`` as a tuple of axis names
(None = that dimension whole). :func:`place` slices every named value for
each local shard by the spec's axes the mesh has (``data`` the rows,
``feature`` the columns or the feature dimension, ``tree`` the leading
per-tree axis) and drops the others, as JAX trims a spec to its mesh.
:func:`match_partition_rules` keeps the data-axis verdict, :data:`ROW`
or :data:`REPLICATED`. :func:`layout` is the ``(data, feature)`` grid of
``ingest_layout`` (``:160-205``); the streamed ingest that reads it is
``ROADMAP.md`` item 16.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from mpitree_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    FEATURE_AXIS,
    TREE_AXIS,
    data_shards,
    feature_shards,
)

ROW = "row"
REPLICATED = "replicated"

# name pattern -> spec (one axis name or None per dimension), first match
# wins; the order, the patterns and the specs are the JAX table's
PARTITION_RULES: tuple = (
    # the binned matrix: rows x features; raw inference rows
    (r"^x_binned$", (DATA_AXIS, FEATURE_AXIS)),
    (r"^x_rows$", (DATA_AXIS,)),
    # per-row state: targets, weights, node routing, boosting margins
    (r"^(y|weight|sample_weight|node_id|nid\w*|raw_margin)$", (DATA_AXIS,)),
    # the (F, B) candidate masks: feature-major
    (r"^cand_masks?$", (FEATURE_AXIS, None)),
    # resident (S, F, C, B) histogram slabs: each shard keeps its features
    (r"^(parent_hist|hist_keep|pair_hist)$",
     (None, FEATURE_AXIS, None, None)),
    # forest state: per-tree stacks over the tree axis; weight rows and
    # row ids follow the rows too
    (r"^tree_(weights|node_id)$", (TREE_AXIS, DATA_AXIS)),
    (r"^tree_\w+$", (TREE_AXIS,)),
    # per-node tables the host or the lead shard builds
    (r"^(parent_slot|is_small|is_split|feat|bin|left_id|right_id)$", ()),
    (r"^(node_mask|draws|mono_(cst|lo|hi))$", ()),
    # outputs after the reduction
    (r"^(counts|n_vec|parent_id|depth|n_nodes|decision|pair_keep)$", ()),
    (r"^(grad_tot|hess_tot|loss_sum|loss_weight|debug_fp)$", ()),
    (r".*", ()),
)


def spec_for(name: str, *, ndim: int | None = None) -> tuple:
    """The spec of ``name`` from the table; a scalar (``ndim=0``) is
    never partitioned, and a spec longer than ``ndim`` is a table bug."""
    if ndim == 0:
        return ()
    for pattern, spec in PARTITION_RULES:
        if re.search(pattern, name) is not None:
            if ndim is not None and len(spec) > ndim:
                raise ValueError(
                    f"partition rule {pattern!r} yields rank-{len(spec)} "
                    f"spec {spec} for rank-{ndim} array {name!r}")
            return spec
    raise ValueError(f"partition rule not found for array: {name!r}")


def match_partition_rules(name: str, *, ndim: int | None = None) -> str:
    """:data:`ROW` when ``name``'s spec shards the data axis, else
    :data:`REPLICATED`."""
    return ROW if DATA_AXIS in spec_for(name, ndim=ndim) else REPLICATED


def place(mesh, state: dict) -> list:
    """Every local shard's view of the named ``state``: a list of dicts,
    one per local shard. Each dimension whose spec axis the mesh has is
    split into that axis's width of equal blocks (rows already padded to
    the data axis, columns to the feature axis) and the shard takes the
    block of its coordinate; other dimensions stay whole. Tensors go to
    the shard's device (no copy where it is already there); numpy arrays
    stay on the host."""
    axes = dict(zip(mesh.axis_names, mesh.shape))
    specs = {name: spec_for(name, ndim=int(np.ndim(value)))
             for name, value in state.items()}
    dr = data_shards(mesh)
    rows = {state[k].shape[s.index(DATA_AXIS)] for k, s in specs.items()
            if DATA_AXIS in s and DATA_AXIS in axes}
    if len(rows) > 1 or any(n % dr for n in rows):
        raise ValueError(f"row-sharded arrays of {sorted(rows)} rows for "
                         f"{dr} shards")
    plans = {}
    for name, value in state.items():
        plan = []
        for dim, axis in enumerate(specs[name]):
            if axis in axes:
                n = value.shape[dim]
                if n % axes[axis]:
                    raise ValueError(f"{name!r}: {n} along {axis!r} for "
                                     f"{axes[axis]} shards")
                plan.append((dim, mesh.axis_names.index(axis),
                             n // axes[axis]))
        plans[name] = plan
    out = [{} for _ in range(mesh.n_local)]
    for i, dev in enumerate(mesh.devices):
        c = mesh.coords(i)
        for name, value in state.items():
            idx = [slice(None)] * int(np.ndim(value))
            for dim, a, per in plans[name]:
                idx[dim] = slice(c[a] * per, (c[a] + 1) * per)
            v = value[tuple(idx)] if plans[name] else value
            out[i][name] = v.to(dev) if isinstance(v, torch.Tensor) else v
    return out


def layout(mesh, n_rows: int, n_features: int) -> dict:
    """Where each row and column block lives (``ingest_layout``,
    ``mpitree_tpu/parallel/partition.py:160-205``): padded extents, each
    shard's block extents, and ``grid``, the (data, feature) array of
    global shard indices, so ``grid[di, fi]`` holds row block ``di`` of
    feature block ``fi``."""
    dr, df = data_shards(mesh), feature_shards(mesh)
    rows_pad = int(n_rows) + (-int(n_rows)) % dr
    feat_pad = int(n_features) + (-int(n_features)) % df
    return {
        "rows_pad": rows_pad,
        "feat_pad": feat_pad,
        "shard_rows": max(rows_pad // dr, 1),
        "shard_cols": max(feat_pad // df, 1),
        "grid": np.arange(dr * df).reshape(dr, df),
    }

"""Partition-rule table: one map from build-state array names to their
placement on the 1-D data mesh.

Counterpart of ``mpitree_tpu/parallel/partition.py:46-93``. The JAX table
maps names to ``PartitionSpec``s over a ``(data, feature)`` mesh; the
port's mesh has the data axis only, so each rule keeps its regex and says
what the JAX spec does on that axis: :data:`ROW` (the spec shards the
data axis: the rows are split over the shards) or :data:`REPLICATED`
(every shard holds the whole value). The tree and feature axes come with
the later parts of ``ROADMAP.md`` item 14, the streamed ingest layout
(``ingest_layout``) with item 16.
"""

from __future__ import annotations

import re

import numpy as np
import torch

ROW = "row"
REPLICATED = "replicated"

# name pattern -> placement on the data axis, first match wins; the order
# and the patterns are the JAX table's
PARTITION_RULES: tuple = (
    # the binned matrix and raw inference rows
    (r"^x_binned$", ROW),
    (r"^x_rows$", ROW),
    # per-row state: targets, weights, node routing, boosting margins
    (r"^(y|weight|sample_weight|node_id|nid\w*|raw_margin)$", ROW),
    # the (F, B) candidate masks: feature-major, whole on every shard
    (r"^cand_masks?$", REPLICATED),
    # resident (S, F, C, B) histograms: reduced, so whole everywhere
    (r"^(parent_hist|hist_keep|pair_hist)$", REPLICATED),
    # forest state: per-tree weight rows and row ids follow the rows
    (r"^tree_(weights|node_id)$", ROW),
    (r"^tree_\w+$", REPLICATED),
    # per-node tables the host or the lead shard builds
    (r"^(parent_slot|is_small|is_split|feat|bin|left_id|right_id)$",
     REPLICATED),
    (r"^(node_mask|draws|mono_(cst|lo|hi))$", REPLICATED),
    # outputs after the reduction
    (r"^(counts|n_vec|parent_id|depth|n_nodes|decision|pair_keep)$",
     REPLICATED),
    (r"^(grad_tot|hess_tot|loss_sum|loss_weight|debug_fp)$", REPLICATED),
    (r".*", REPLICATED),
)


def match_partition_rules(name: str, *, rules=PARTITION_RULES,
                          ndim: int | None = None) -> str:
    """:data:`ROW` or :data:`REPLICATED` for ``name`` from the table; a
    scalar (``ndim=0``) is never partitioned."""
    if ndim == 0:
        return REPLICATED
    for pattern, placement in rules:
        if re.search(pattern, name) is not None:
            return placement
    raise ValueError(f"partition rule not found for array: {name!r}")


def place(mesh, state: dict) -> list:
    """Every local shard's view of the named ``state``: a list of dicts,
    one per local shard. Row-sharded values (their rows already padded to
    a multiple of the mesh's shard count, ``mesh.pad_row_arrays``) take
    the shard's rows; replicated ones are whole. Tensors go to the shard's
    device (no copy where it is already there); numpy arrays stay on the
    host."""
    rows = {len(v) for k, v in state.items()
            if match_partition_rules(k, ndim=int(np.ndim(v))) == ROW}
    if len(rows) > 1 or any(n % mesh.size for n in rows):
        raise ValueError(f"row-sharded arrays of {sorted(rows)} rows for "
                         f"{mesh.size} shards")
    per = rows.pop() // mesh.size if rows else 0
    out = [{} for _ in range(mesh.n_local)]
    for name, value in state.items():
        row = match_partition_rules(name, ndim=int(np.ndim(value))) == ROW
        for i, dev in enumerate(mesh.devices):
            if row:
                g = mesh.shard_index(i)
                value_i = value[g * per:(g + 1) * per]
            else:
                value_i = value
            out[i][name] = (value_i.to(dev)
                            if isinstance(value_i, torch.Tensor)
                            else value_i)
    return out

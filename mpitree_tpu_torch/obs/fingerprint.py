"""obs.fingerprint — cheap u64 per-level build-state fingerprints.

Counterpart of ``mpitree_tpu/obs/fingerprint.py``, byte for byte in what
it hashes, so equal trees give equal hex digests in both packages. A
fingerprint row is three u64 hashes per tree level, one per state
**channel**, ordered by data flow:

- ``hist`` — each level node's total accumulated weight
  (``n_node_samples``): the 0th moment of the reduced histogram.
- ``winner`` — the packed winning splits: per-node ``(feature,
  threshold)`` (leaves contribute ``(-1, NaN)``).
- ``alloc`` — the child-id allocation: per-node ``(left, right)``.

Refine-tail subtrees commit under their own ``refine`` channel
(:func:`subtree_fingerprints`).

Fingerprints are host-side arithmetic over arrays the engines already
hold: no device work. The levelwise and host engines hash each level's
slice of the host tree buffer at their host boundary; the fused engines
(the fused tree and forest engines, the CUDA-graph leaf loop, fused
rounds) get the identical rows *replayed* from the finished tree
(:func:`tree_fingerprints`). Live and replayed rows hash the same bytes
from the same arrays.

Hashing is BLAKE2b (stdlib) truncated to 64 bits, rendered as 16 hex
chars. Only refit-stable fields are hashed: ``value``/``count``/
``impurity`` are overwritten after the build by the float64 refits.
"""

from __future__ import annotations

import hashlib

import numpy as np

# Bump on any change to which bytes a channel hashes — stored
# fingerprints are only comparable within one version.
# v2: refine-tail subtrees commit under their own "refine"
# channel instead of reusing hist/winner/alloc, so a streamed-vs-
# in-memory divergence localizes INTO the refine tail by name.
FINGERPRINT_VERSION = 2

# Data-flow order: histogram stats feed the winner sweep, winners feed
# child allocation, and the refine tail re-grows below all three — the
# bisect reports the FIRST divergent channel in this order, which names
# the most upstream divergent state. Crown rows carry the first three
# channels; refine-tail rows carry only "refine" (absent channels
# compare equal in the bisect), so mixed row lists never false-positive.
CHANNELS = ("hist", "winner", "alloc", "refine")


def _h64(*chunks: bytes) -> str:
    """64-bit BLAKE2b over the concatenated chunks, as 16 hex chars."""
    h = hashlib.blake2b(digest_size=8)
    for c in chunks:
        h.update(c)
    return h.hexdigest()


def _canon(a, dtype) -> bytes:
    """Canonical little-endian bytes regardless of the input's dtype."""
    return np.ascontiguousarray(np.asarray(a), dtype=dtype).tobytes()


def level_fingerprint(level: int, n_samples, feature, threshold,
                      left, right) -> dict:
    """One fingerprint row from a level's node slices (id order).

    The arrays are the level's slices of the host tree buffer — what the
    level-wise loop already has at its host boundary, and exactly what
    :func:`tree_fingerprints` re-slices from a finished tree, so the two
    paths can never hash different bytes.
    """
    # -0.0 -> +0.0 before hashing: a column holding both zeros may yield
    # either representative depending on which path selected the edge
    # (the device kernel's sort, the ingest sketch's chunk merge — both
    # documented non-contracts), and the ``x <= t`` predicate cannot
    # tell them apart. Hashing raw bytes would flag predicate-identical
    # trees as divergent. NaN leaf pads are unaffected.
    thr = np.ascontiguousarray(np.asarray(threshold), "<f4")
    thr = thr + np.float32(0.0)
    return {
        "level": int(level),
        "nodes": int(len(np.asarray(feature))),
        "hist": _h64(_canon(n_samples, "<i8")),
        "winner": _h64(_canon(feature, "<i4"), _canon(thr, "<f4")),
        "alloc": _h64(_canon(left, "<i4"), _canon(right, "<i4")),
    }


def tree_fingerprints(tree) -> list:
    """Per-level fingerprint rows replayed from a finished tree.

    ``tree`` is any struct-of-arrays carrying ``depth`` /
    ``n_node_samples`` / ``feature`` / ``threshold`` / ``left`` /
    ``right`` (a ``TreeArrays``). Nodes group by depth in id order —
    the engines allocate level nodes contiguously (level-wise) or
    BFS-renumber (leaf-wise/fused), so id order within a depth is the
    same canonical order the live path hashes.
    """
    depth = np.asarray(tree.depth, np.int64)
    ns = np.asarray(tree.n_node_samples)
    feat = np.asarray(tree.feature)
    thr = np.asarray(tree.threshold)
    left = np.asarray(tree.left)
    right = np.asarray(tree.right)
    rows = []
    for d in range(int(depth.max(initial=0)) + 1):
        ids = np.flatnonzero(depth == d)
        if not len(ids):
            continue
        rows.append(level_fingerprint(
            d, ns[ids], feat[ids], thr[ids], left[ids], right[ids]
        ))
    return rows


def subtree_fingerprints(depth, n_samples, feature, threshold, left,
                         right, ids=None) -> list:
    """Per-level rows for ONE subtree of a larger node buffer (the
    hybrid-refine tail, satellite).

    ``ids`` selects the subtree's nodes (None = the whole buffer is the
    subtree, e.g. a standalone per-subtree host build). Node ids are
    REMAPPED to the subtree's local id-rank order before hashing, so the
    two tail engines — the batched multi-root native frontier (subtree
    nodes interleaved in one buffer, buffer-global child ids) and the
    per-subtree host builds (ids local from 0) — commit byte-identical
    rows for identical subtrees; depths are likewise re-based at the
    subtree root. Leaves keep ``-1`` children.

    Rows carry the ``refine`` channel (v2): the per-level hist/winner/
    alloc states fold into ONE hash, so the bisect reports a refine-tail
    divergence as channel ``"refine"`` — "the tails re-grew differently"
    — instead of mislabeling it a histogram bug at some crown level. A
    streamed fit's tail consumes a gathered replay of the chunk stream;
    this channel is what proves the replay fed the same bytes.
    """
    depth = np.asarray(depth, np.int64)
    feature = np.asarray(feature)
    threshold = np.asarray(threshold)
    left = np.asarray(left, np.int64)
    right = np.asarray(right, np.int64)
    ns = np.asarray(n_samples)
    if ids is None:
        ids = np.arange(len(depth), dtype=np.int64)
    else:
        ids = np.asarray(ids, np.int64)
    if not len(ids):
        return []
    # id -> local rank (ids are ascending within a buffer's subtree; the
    # searchsorted remap keeps -1 leaves at -1).
    def remap(child):
        c = child[ids]
        local = np.searchsorted(ids, np.where(c < 0, ids[0], c))
        return np.where(c < 0, -1, local).astype(np.int64)

    l_loc, r_loc = remap(left), remap(right)
    d_loc = depth[ids] - int(depth[ids].min())
    feat_loc = feature[ids]
    thr_loc = threshold[ids]
    ns_loc = ns[ids]
    rows = []
    for d in range(int(d_loc.max(initial=0)) + 1):
        at = np.flatnonzero(d_loc == d)
        if not len(at):
            continue
        r = level_fingerprint(
            d, ns_loc[at], feat_loc[at], thr_loc[at], l_loc[at], r_loc[at]
        )
        rows.append({
            "level": r["level"], "nodes": r["nodes"],
            "refine": _h64(
                f"{r['hist']}:{r['winner']}:{r['alloc']}".encode()
            ),
        })
    return rows


def fold(rows: list, into=None):
    """Fold fingerprint rows into a running whole-fit BLAKE2b state.

    ``into``: an existing hash object (or None to start one). The
    observer folds every committed tree's rows through here and renders
    the final state as the record's whole-fit ``fingerprint`` — one u64
    that changes iff any level of any tree changed.
    """
    h = into if into is not None else hashlib.blake2b(digest_size=8)
    for r in rows:
        if "refine" in r:  # refine-tail row (v2): one channel
            h.update(f"{r['level']}:{r['refine']};".encode())
        else:
            h.update(
                f"{r['level']}:{r['hist']}:{r['winner']}:{r['alloc']};"
                .encode()
            )
    return h


def ensemble_fingerprint(trees) -> str:
    """Whole-model u64 over every member's per-level rows — the serving
    side's "am I serving the same model?" stamp (``serve_report_``)."""
    h = None
    for t in trees:
        h = fold(tree_fingerprints(t), h)
    return (h or fold([])).hexdigest()

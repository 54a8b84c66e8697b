"""Renderings of a fitted tree: text, Graphviz and the decision path.

Copies of ``mpitree_tpu/utils/export.py``:

- ``export_tree_text`` (``:30``), byte parity with the reference: glyphs
  ``┌──``/``├──``/``└──``, edge labels carrying the parent's threshold at
  ``precision`` decimals, an interior right child printed first (the
  reference's ``Node.__lt__`` ordering), and three-space indents under a
  ``└──`` node;
- ``export_tree_dot`` (``:86``), sklearn's ``export_graphviz`` idiom;
- ``tree_decision_path`` (``:159``), sklearn's ``decision_path`` CSR
  indicator (``scipy`` is imported when it is called).
"""

from __future__ import annotations

import numpy as np

from mpitree_tpu_torch.core.tree_struct import TreeArrays

_GLYPH_ROOT = "┌──"
_GLYPH_INTERIOR = "├──"
_GLYPH_LEAF = "└──"


def export_tree_text(
    tree: TreeArrays,
    *,
    feature_names=None,
    class_names=None,
    precision: int = 2,
    task: str = "classification",
) -> str:
    """Render ``tree`` as the reference's ``export_text``; a regression
    leaf reads ``value: <mean>`` at ``precision`` decimals."""
    lines: list[str] = []

    def label(i: int) -> str:
        if tree.feature[i] < 0:
            if task == "regression":
                return f"value: {float(tree.value[i]):.{precision}f}"
            v = int(tree.value[i])
            return class_names[v] if class_names is not None else f"class: {v}"
        f = int(tree.feature[i])
        return feature_names[f] if feature_names is not None else f"feature_{f}"

    stack = [(0, _GLYPH_ROOT, "")] if tree.n_nodes else []
    while stack:
        i, glyph, prefix = stack.pop()
        text = f"{glyph} {label(i)}"
        p = int(tree.parent[i])
        if p >= 0:
            sign = "<=" if int(tree.left[p]) == i else ">"
            text += f" [{sign} {float(tree.threshold[p]):.{precision}f}]"
        lines.append(prefix + text)

        if tree.feature[i] < 0:
            continue
        l, r = int(tree.left[i]), int(tree.right[i])
        if tree.feature[r] >= 0:
            order = [(r, _GLYPH_INTERIOR), (l, _GLYPH_LEAF)]
        else:
            order = [(l, _GLYPH_INTERIOR), (r, _GLYPH_LEAF)]
        child_prefix = prefix + ("   " if glyph == _GLYPH_LEAF else "│  ")
        for c, g in reversed(order):
            stack.append((c, g, child_prefix))
    return "\n".join(lines)


def check_feature_names(names, n_features: int):
    if names is not None and len(names) < n_features:
        raise ValueError(
            f"feature_names has {len(names)} entries; need >= {n_features}"
        )
    return np.asarray(names) if names is not None else None


def export_tree_dot(
    tree: TreeArrays, *, feature_names=None, class_names=None,
    precision: int = 2, task: str = "classification",
    n_features: int | None = None,
) -> str:
    """Graphviz ``digraph`` source for a fitted tree: interior nodes show
    the split (``f <= t``), leaves the class (or mean); classification
    nodes add the impurity and counts, regression nodes the impurity and
    ``n``; the root's edges are labelled True/False as sklearn's are."""
    width = (
        n_features if n_features is not None
        else int(tree.feature.max(initial=-1)) + 1
    )
    names = check_feature_names(feature_names, width)

    def esc(s) -> str:
        # DOT label strings: backslash first, then the quote delimiter.
        return str(s).replace("\\", "\\\\").replace('"', '\\"')

    def fname(f: int) -> str:
        return esc(names[f]) if names is not None else f"x[{f}]"

    lines = [
        "digraph Tree {",
        'node [shape=box, style="rounded", fontname="helvetica"];',
        'edge [fontname="helvetica"];',
    ]
    for i in range(tree.n_nodes):
        imp = float(tree.impurity[i])
        if tree.feature[i] >= 0:
            head = (
                f"{fname(int(tree.feature[i]))} <= "
                f"{float(tree.threshold[i]):.{precision}f}"
            )
        elif task == "classification":
            c = int(tree.value[i])
            head = (
                f"class = {esc(class_names[c])}" if class_names is not None
                else f"class = {c}"
            )
        else:
            head = f"value = {float(tree.count[i, 0]):.{precision}f}"
        if task == "classification":
            counts = ", ".join(
                str(int(v)) if float(v).is_integer() else f"{float(v):.4f}"
                for v in np.asarray(tree.count[i], dtype=float)
            )
            body = f"impurity = {imp:.{precision}f}\\ncounts = [{counts}]"
        else:
            body = (
                f"impurity = {imp:.{precision}f}\\n"
                f"n = {int(tree.n_node_samples[i])}"
            )
        lines.append(f'{i} [label="{head}\\n{body}"];')
        l_, r_ = int(tree.left[i]), int(tree.right[i])
        if l_ >= 0:
            extra = (
                ' [labeldistance=2.5, labelangle=45, headlabel="True"]'
                if i == 0 else ""
            )
            lines.append(f"{i} -> {l_}{extra};")
            extra = (
                ' [labeldistance=2.5, labelangle=-45, headlabel="False"]'
                if i == 0 else ""
            )
            lines.append(f"{i} -> {r_}{extra};")
    lines.append("}")
    return "\n".join(lines)


def tree_decision_path(tree: TreeArrays, leaf_ids: np.ndarray):
    """The (n_samples, n_nodes) CSR indicator of the nodes each sample
    passes, from its leaf ids: the parent chain is walked up on the host
    (parents have smaller ids), one segment per sample, root first."""
    from scipy import sparse

    n = len(leaf_ids)
    lens = tree.depth[leaf_ids] + 1
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(lens, out=indptr[1:])
    indices = np.empty(int(indptr[-1]), np.int64)
    cur = np.asarray(leaf_ids, np.int64).copy()
    pos = indptr[1:].copy() - 1  # each segment is filled from its back
    alive = np.ones(n, bool)
    while alive.any():
        indices[pos[alive]] = cur[alive]
        pos[alive] -= 1
        parents = tree.parent[cur[alive]]
        up = parents >= 0
        nxt = cur[alive]
        nxt[up] = parents[up]
        cur[alive] = nxt
        alive[alive] = up  # rows still below the root
    data = np.ones(len(indices), np.int8)
    return sparse.csr_matrix(
        (data, indices, indptr), shape=(n, tree.n_nodes)
    )

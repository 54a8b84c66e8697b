"""Text rendering of a fitted tree — byte parity with the reference.

A copy of ``export_tree_text`` (``mpitree_tpu/utils/export.py:30``): glyphs
``┌──``/``├──``/``└──``, edge labels carrying the parent's threshold at
``precision`` decimals, an interior right child printed first (the
reference's ``Node.__lt__`` ordering), and three-space indents under a
``└──`` node.
"""

from __future__ import annotations

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

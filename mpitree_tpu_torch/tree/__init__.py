"""Public import boundary, as in ``mpitree_tpu.tree``.

``from mpitree_tpu_torch.tree import DecisionTreeClassifier``.
"""

from mpitree_tpu_torch.models.classifier import DecisionTreeClassifier

__all__ = ["DecisionTreeClassifier"]

"""Public import boundary, as in ``mpitree_tpu.tree``.

``from mpitree_tpu_torch.tree import DecisionTreeClassifier,
RandomForestClassifier``.
"""

from mpitree_tpu_torch.models.classifier import DecisionTreeClassifier
from mpitree_tpu_torch.models.forest import RandomForestClassifier

__all__ = ["DecisionTreeClassifier", "RandomForestClassifier"]

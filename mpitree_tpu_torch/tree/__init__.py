"""Public import boundary, as in ``mpitree_tpu.tree``.

``from mpitree_tpu_torch.tree import DecisionTreeClassifier,
DecisionTreeRegressor, RandomForestClassifier``.
"""

from mpitree_tpu_torch.models.classifier import DecisionTreeClassifier
from mpitree_tpu_torch.models.forest import RandomForestClassifier
from mpitree_tpu_torch.models.regressor import DecisionTreeRegressor

__all__ = ["DecisionTreeClassifier", "DecisionTreeRegressor",
           "RandomForestClassifier"]

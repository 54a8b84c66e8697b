"""Public import boundary, as in ``mpitree_tpu.tree``.

``from mpitree_tpu_torch.tree import DecisionTreeClassifier,
DecisionTreeRegressor, RandomForestClassifier, RandomForestRegressor,
ExtraTreesClassifier, ExtraTreesRegressor, GradientBoostingClassifier,
GradientBoostingRegressor``.
"""

from mpitree_tpu_torch.boosting import (
    GradientBoostingClassifier,
    GradientBoostingRegressor,
)
from mpitree_tpu_torch.models.classifier import DecisionTreeClassifier
from mpitree_tpu_torch.models.forest import (
    ExtraTreesClassifier,
    ExtraTreesRegressor,
    RandomForestClassifier,
    RandomForestRegressor,
)
from mpitree_tpu_torch.models.regressor import DecisionTreeRegressor

__all__ = ["DecisionTreeClassifier", "DecisionTreeRegressor",
           "ExtraTreesClassifier", "ExtraTreesRegressor",
           "GradientBoostingClassifier", "GradientBoostingRegressor",
           "RandomForestClassifier", "RandomForestRegressor"]

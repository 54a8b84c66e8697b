"""Public import boundary, as in ``mpitree_tpu.tree``.

``from mpitree_tpu_torch.tree import DecisionTreeClassifier,
ParallelDecisionTreeClassifier, DecisionTreeRegressor,
RandomForestClassifier, RandomForestRegressor, ExtraTreesClassifier,
ExtraTreesRegressor, GradientBoostingClassifier,
GradientBoostingRegressor`` (``mpitree_tpu/tree/__init__.py:13``), and
``StreamedDataset`` for ``fit(dataset=...)`` (``mpitree_tpu/__init__.py:35``),
and the fitted tree's types ``BranchType``, ``Node`` and ``TreeArrays``
(``mpitree_tpu/tree/__init__.py:10``).
"""

from mpitree_tpu_torch.boosting import (
    GradientBoostingClassifier,
    GradientBoostingRegressor,
)
from mpitree_tpu_torch.core.tree_struct import BranchType, Node, TreeArrays
from mpitree_tpu_torch.ingest import StreamedDataset
from mpitree_tpu_torch.models.classifier import (
    DecisionTreeClassifier,
    ParallelDecisionTreeClassifier,
)
from mpitree_tpu_torch.models.forest import (
    ExtraTreesClassifier,
    ExtraTreesRegressor,
    RandomForestClassifier,
    RandomForestRegressor,
)
from mpitree_tpu_torch.models.regressor import DecisionTreeRegressor

__all__ = ["BranchType", "DecisionTreeClassifier", "DecisionTreeRegressor",
           "ExtraTreesClassifier", "ExtraTreesRegressor",
           "GradientBoostingClassifier", "GradientBoostingRegressor",
           "Node", "ParallelDecisionTreeClassifier",
           "RandomForestClassifier", "RandomForestRegressor",
           "StreamedDataset", "TreeArrays"]

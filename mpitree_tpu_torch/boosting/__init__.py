"""Histogram gradient-boosted trees on the card.

Counterpart of ``mpitree_tpu/boosting``: the host round loop of
``gradient_boosting.py`` over the losses of ``losses.py``, every round's
tree built on the card through ``core/builder.build_tree(task="gbdt")``,
and the fused rounds of ``fused_rounds.py`` (K rounds per dispatch).
"""

from mpitree_tpu_torch.boosting.gradient_boosting import (
    GradientBoostingClassifier,
    GradientBoostingRegressor,
)

__all__ = ["GradientBoostingClassifier", "GradientBoostingRegressor"]

"""mpitree_tpu_torch — the PyTorch/CUDA port of mpitree_tpu, for NVIDIA Hopper.

A second package beside the JAX one, mirroring its module paths. It
imports torch and numpy only: never jax, never ``mpitree_tpu`` and never
sklearn. Its hot ops are hand-written CUDA kernels built with ``nvcc`` at
first use: the (slot, feature, class, bin) histogram of every fit
(``csrc/histogram.cu``, bound through ``ops/hist_kernel.py``; float32
for integer payloads, exact int64 fixed point for every other) and the
ensemble traversal of the serving path (``csrc/traverse.cu``, bound
through ``serving/serve_kernel.py``). Entry points run on the GPU
(``device=None`` means ``"cuda"`` and raises without CUDA);
``device="cpu"`` runs the kernels' plain PyTorch versions.

Ported so far: ``DecisionTreeClassifier`` and ``DecisionTreeRegressor``
(levelwise device engine, host tier, refine tail, ``ccp_alpha``,
``sample_weight``/``class_weight``, ``max_features``/``splitter``,
``monotonic_cst``, ``decision_path``, ``export_text``/``export_dot``,
``nodes_``, ``n_devices`` on a data mesh over devices and processes, or
a ``(data, feature)`` mesh), ``ParallelDecisionTreeClassifier``,
``RandomForestClassifier``, ``RandomForestRegressor``,
``ExtraTreesClassifier`` and ``ExtraTreesRegressor`` (with OOB scores,
warm start, ``monotonic_cst`` and ``n_devices`` on a ``(tree, data)``
mesh), ``GradientBoostingClassifier`` and ``GradientBoostingRegressor``
(the host round loop over Newton trees built on the card, and the fused
rounds; ``n_devices`` on any mesh), ``save_model``/``load_model`` in the JAX package's
file format, serving (``compile_model``, ``ModelRegistry``; boosted
margins through the traversal kernel), streaming (``StreamedDataset``)
and resilience (``mpitree_tpu_torch.resilience``: the retry and
host-failover ladder, level and expansion resume, forest and boosting
``checkpoint=``, chaos seams) and observability
(``mpitree_tpu_torch.obs``: ``fit_report_``, traces, the memory and
compute ledgers, the flight store under ``MPITREE_TPU_RUN_DIR``, record
diffs and the evidence-driven ``"auto"`` policies); ``ROADMAP.md`` lists
what comes next.
"""

from mpitree_tpu_torch.boosting import (
    GradientBoostingClassifier,
    GradientBoostingRegressor,
)
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
from mpitree_tpu_torch.serving import ModelRegistry, compile_model
from mpitree_tpu_torch.utils.serialize import load_model, save_model

# the JAX package's version: the port ports that release
__version__ = "0.1.0"

__all__ = [
    "__version__",
    "DecisionTreeClassifier",
    "DecisionTreeRegressor",
    "ExtraTreesClassifier",
    "ExtraTreesRegressor",
    "GradientBoostingClassifier",
    "GradientBoostingRegressor",
    "ModelRegistry",
    "ParallelDecisionTreeClassifier",
    "RandomForestClassifier",
    "RandomForestRegressor",
    "StreamedDataset",
    "compile_model",
    "load_model",
    "save_model",
]

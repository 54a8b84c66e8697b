"""mpitree_tpu_torch — the PyTorch/CUDA port of mpitree_tpu, for NVIDIA Hopper.

A second package beside the JAX one, mirroring its module paths. It
imports torch and numpy only: never jax, never ``mpitree_tpu`` and never
sklearn. Its hot ops are hand-written CUDA kernels built with ``nvcc`` at
first use: the (slot, feature, class, bin) histogram of every fit
(``csrc/histogram.cu``, bound through ``ops/hist_kernel.py``) and the
ensemble traversal of the serving path (``csrc/traverse.cu``, bound
through ``serving/serve_kernel.py``). Entry points run on the GPU
(``device=None`` means ``"cuda"`` and raises without CUDA);
``device="cpu"`` runs the kernels' plain PyTorch versions.

Ported so far: the levelwise ``DecisionTreeClassifier``, the bagged
``RandomForestClassifier``, and serving (``compile_model``,
``ModelRegistry``); ``ROADMAP.md`` lists what comes next.
"""

from mpitree_tpu_torch.models.classifier import DecisionTreeClassifier
from mpitree_tpu_torch.models.forest import RandomForestClassifier
from mpitree_tpu_torch.serving import ModelRegistry, compile_model

__all__ = [
    "DecisionTreeClassifier",
    "ModelRegistry",
    "RandomForestClassifier",
    "compile_model",
]

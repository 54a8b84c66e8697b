"""mpitree_tpu_torch — the PyTorch/CUDA port of mpitree_tpu, for NVIDIA Hopper.

A second package beside the JAX one, mirroring its module paths. It
imports torch and numpy only: never jax, never ``mpitree_tpu`` and never
sklearn. The hot op, the (slot, feature, class, bin) histogram, is a
hand-written CUDA kernel family (``csrc/histogram.cu``, bound through
``ops/hist_kernel.py``) built with ``nvcc`` at first use. Entry points run
on the GPU (``device=None`` means ``"cuda"`` and raises without CUDA);
``device="cpu"`` runs the kernels' plain PyTorch versions.

This slice ports the levelwise ``DecisionTreeClassifier`` fit and its
``predict``; ``ROADMAP.md`` lists what comes next.
"""

from mpitree_tpu_torch.models.classifier import DecisionTreeClassifier

__all__ = ["DecisionTreeClassifier"]

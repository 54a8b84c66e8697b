"""Device resolution for every entry point of the port.

The port runs on the GPU. ``device=None`` means ``"cuda"``, and a missing
CUDA runtime is an error, never a silent move to the CPU: a fit that the
caller believes ran on the card must not have run anywhere else. Only an
explicit ``device="cpu"`` takes the CPU path, where every kernel wrapper
uses its plain PyTorch version (the tests run there).
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None``/``"cuda"``/``"cuda:N"``/``"cpu"`` (or a ``torch.device``)
    -> ``torch.device``; raises ``RuntimeError`` when CUDA is asked for
    and ``torch.cuda.is_available()`` is False."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(
            f"device must be 'cuda' or 'cpu', got {str(dev)!r}"
        )
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(dev)!r} (the default) needs CUDA, but "
            "torch.cuda.is_available() is False; pass device='cpu' "
            "explicitly to run the plain CPU path"
        )
    return dev

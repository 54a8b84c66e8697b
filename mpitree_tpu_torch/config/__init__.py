"""Package configuration: the typed env-knob registry (``config.knobs``),
counterpart of ``mpitree_tpu.config``."""

from mpitree_tpu_torch.config import knobs

__all__ = ["knobs"]

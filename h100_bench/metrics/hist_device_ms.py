"""Device milliseconds per profiled fit of the histogram kernels
(``ops/hist_kernel`` -> ``csrc/histogram.cu``, ``csrc/fixed_hist.cu``):
``hist_tile_kernel``, ``fixed_tile_kernel`` and ``hist_zero_split_kernel``."""

from h100_bench.metrics import device_ms_per_fit
from h100_bench.yardstick import PROFILE_KINDS

LAYER = "histogram kernels (ops/hist_kernel)"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "fit_s"
NAMES = dict(PROFILE_KINDS)["histogram kernels"]


def read(ctx):
    return device_ms_per_fit(ctx, lambda n: any(k in n for k in NAMES))

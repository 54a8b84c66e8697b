"""The histogram kernels' share of their roofline, in percent: the least
time of the fit's histogram work (``yardstick.fit_work``: the fitted
model's own per-node row counts, the smaller child's rows below each
split, over the HBM peak) over the kernels' device time per fit
(``hist_device_ms``)."""

from h100_bench import yardstick
from h100_bench.metrics import hist_device_ms

LAYER = "histogram kernels (ops/hist_kernel)"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "fit_s"


def read(ctx):
    ms = hist_device_ms.read(ctx)
    if not ms or "work" not in ctx:
        return None
    return 100.0 * yardstick.least_seconds(ctx["work"]["hist"]) / (ms / 1e3)

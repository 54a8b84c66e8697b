"""The whole fit's share of the chip's peak, in percent: the fit's least
time (``yardstick.fit_work``: its histogram and split-search work, each
part the larger of its operations over 67 TFLOP/s and its bytes over
3.35 TB/s, summed) over the mean seconds of the traced run's unprofiled
fits. A histogram fit does no matrix products, so the bytes decide it."""

import statistics

from h100_bench import yardstick

LAYER = "whole fit"
UNIT = "%"
SOURCE = "host_clock"
MOVES = "fit_s"


def read(ctx):
    if not ctx["walls"] or "work" not in ctx:
        return None
    least = sum(yardstick.least_seconds(w) for w in ctx["work"].values())
    return 100.0 * least / statistics.mean(ctx["walls"])

"""Percent of the profiled window in which nothing ran on the device:
one less the union of kernel, copy and memset intervals over the
window's length."""

LAYER = "device"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "fit_s"


def read(ctx):
    prof = ctx["profile"]
    if prof["window_s"] <= 0 or prof["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])

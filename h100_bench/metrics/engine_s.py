"""Seconds a fit spends in the tree engine (``core/fused_builder``): the
program's ``fused_build`` span, mean over the traced run's unprofiled
fits."""

from h100_bench.metrics import span_mean

LAYER = "tree engine (core/fused_builder)"
UNIT = "s"
SOURCE = "program_span"
MOVES = "fit_s"


def read(ctx):
    return span_mean(ctx, "fused_build")

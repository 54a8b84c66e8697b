"""Seconds a boosted fit spends in its fused rounds
(``boosting/fused_rounds``): the program's ``fused_rounds`` spans summed
over a fit's dispatches, mean over the traced run's unprofiled fits."""

from h100_bench.metrics import span_mean

LAYER = "boosting rounds (boosting/fused_rounds)"
UNIT = "s"
SOURCE = "program_span"
MOVES = "fit_s"


def read(ctx):
    return span_mean(ctx, "fused_rounds")

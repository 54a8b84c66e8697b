"""Seconds a fit spends binning (``ops/binning``): the program's ``bin``
span under ``MPITREE_TPU_PROFILE=1``, which ends when the card is idle;
mean over the traced run's unprofiled fits."""

from h100_bench.metrics import span_mean

LAYER = "binning (ops/binning)"
UNIT = "s"
SOURCE = "program_span"
MOVES = "fit_s"


def read(ctx):
    return span_mean(ctx, "bin")

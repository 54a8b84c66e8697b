"""Device milliseconds per profiled fit of the float64 split sweep
(``ops/impurity``): the device operations whose name carries ``double``
(``chip_smoke.py``'s ``PROFILE_KINDS`` rule, frozen in ``yardstick``)."""

from h100_bench.metrics import device_ms_per_fit
from h100_bench.yardstick import kind_of

LAYER = "split sweep (ops/impurity)"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "fit_s"


def read(ctx):
    return device_ms_per_fit(ctx, lambda n: kind_of(n) == "float64 sweep")

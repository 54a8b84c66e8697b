"""Device-to-host copies per profiled fit (the engine's round trips to
the host): the trace's memcpy events whose name says ``DtoH``."""

LAYER = "engine to host round trips"
UNIT = "count"
SOURCE = "device_trace"
MOVES = "fit_s"


def read(ctx):
    prof = ctx["profile"]
    if not prof["n_fits"]:
        return None
    return prof["d2h"] / prof["n_fits"]

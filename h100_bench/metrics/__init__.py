"""Per-layer metric readers, one module a metric, found by the metric's
name in ``BENCHMARK.json``. Each declares ``LAYER``, ``UNIT``, ``SOURCE``
and ``MOVES`` and has ``read(ctx)``, which returns the metric's value or
None where the run holds nothing to read (the harness then leaves the
metric out of the line). ``ctx`` (``harness.run_cell``) holds the traced
run's ``config``, ``traffic`` and estimator ``params``, ``stats`` (each
unprofiled fit's span summary), ``profile`` (``trace.summarize``),
``walls`` (the unprofiled fits' seconds) and, where the cell's check
counts it, ``work`` (``yardstick.fit_work`` of the fitted model)."""


def span_mean(ctx: dict, span: str):
    """Mean seconds per fit of one span of the program's record (summed
    over its calls in a fit), or None where no fit recorded it."""
    vals = [s[span]["seconds"] for s in ctx["stats"]
            if s and span in s]
    if not vals or len(vals) != len(ctx["stats"]):
        return None
    return sum(vals) / len(vals)


def device_ms_per_fit(ctx: dict, match) -> float | None:
    """Device milliseconds per profiled fit of the operations whose name
    ``match`` accepts, or None where none ran."""
    prof = ctx["profile"]
    secs = [v for n, v in prof["device_s_by_name"].items() if match(n)]
    if not secs or not prof["n_fits"]:
        return None
    return 1e3 * sum(secs) / prof["n_fits"]

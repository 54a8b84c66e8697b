"""How a traffic mix drives the estimator through the measured window,
one module a loop, found by the traffic's ``loop``. Each has
``window(s, traffic, *, seconds, trace) -> dict`` over the run's set-up
``s`` (``harness.Setup``: ``s.call()`` makes a fresh estimator and makes
the traffic's call on it, ending in a device synchronisation, and
``s.outputs(est)`` takes what it produced to the host), returning:

- ``t0``: the window's start (``time.monotonic()``);
- ``window_s``: its length in seconds;
- ``outs``: every call's outputs, in order; ``walls``: each call's
  seconds;
- ``profiled``, ``prof``: in a traced run, the outputs of the calls made
  under ``trace.profiled`` and the profiler; else ``[]`` and None;
- ``metrics``: the end-to-end metrics of ``BENCHMARK.json`` that the
  window measures, by name (the harness adds ``peak_gib`` and
  ``setup_s``).
"""

"""The checks that decide a run's ``correct``, one module a check, found
by a configuration's ``check``. Each has:

- ``LIMITS``: each compared number's limit (``PERF.md`` §2 gives the
  readings each was set from);
- ``outputs(est) -> dict``: what a fitted estimator produced, on the host,
  as plain numpy arrays in dicts and lists (every fit of a window has to
  produce the same);
- ``reference(params, X, y, device, *, control=False) -> dict``: the plain
  reference's model of the same rows, in the form ``numbers`` reads,
  worked out again from ``X`` and ``y`` alone; ``control`` computes it in
  the nearest precision below the one the configuration states;
- ``numbers(got, want) -> dict``: the compared numbers of ``got`` (the
  program's ``outputs`` or a control) against ``want`` (the reference);
- optionally ``work(out, params, X, y, want) -> dict``: the least
  histogram and split-search work (``yardstick.fit_work``) of a fit whose
  outputs are ``out``, which the roofline readers divide by.

``params`` are the estimator's parameters as the cell runs it: the
configuration's ``params`` with the traffic's ``estimator_params`` over
them.
"""

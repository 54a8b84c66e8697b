"""Data generators, one module a generator, found by a configuration's
``data.generator``. Each has ``make(data, seed) -> (X, y)``: host numpy
arrays from the configuration's ``data`` block and the run's seed, the
same for the same seed."""

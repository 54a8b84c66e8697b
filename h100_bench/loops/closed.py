"""The closed loop: one client makes the traffic's call (``fit`` on the
cell's host arrays) again and again, each call starting when the last
has ended, until ``seconds`` have passed. The window ends at the end of
the first call that finishes after ``seconds``; ``fit_s`` is its seconds
over the calls completed in it. A traced run first makes
``profile_fits`` calls under the profiler (each inside
``trace.fit_range``), then goes on unprofiled; it ends only once two
unprofiled calls have been made, so the per-call spans have two to read.

More clients than one are a loop of their own.
"""

from __future__ import annotations

import time

from h100_bench import trace as trace_lib


def window(s, traffic: dict, *, seconds: float, trace: bool) -> dict:
    if int(traffic.get("clients", 1)) != 1:
        raise ValueError("the closed loop drives one client")
    outs, walls, profiled, prof = [], [], [], None
    t0 = time.monotonic()
    if trace:
        with trace_lib.profiled(s.device) as prof:
            for _ in range(int(traffic["profile_fits"])):
                with trace_lib.fit_range():
                    est = s.call()
                profiled.append(s.outputs(est))
                del est
    while True:
        a = time.monotonic()
        est = s.call()
        b = time.monotonic()
        walls.append(b - a)
        outs.append(s.outputs(est))
        del est
        if b - t0 >= seconds and (not trace or len(outs) >= 2):
            break
    window_s = time.monotonic() - t0
    return {"t0": t0, "window_s": window_s, "outs": outs, "walls": walls,
            "profiled": profiled, "prof": prof,
            "metrics": {"fit_s": window_s / len(outs)}}

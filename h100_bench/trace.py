"""The traced run's device trace: ``torch.profiler`` over a few whole fits,
reduced to what the per-layer readers and the breakdown read.

Device time is the union of the intervals in which a kernel, a copy or a
memset ran, clipped to the profiled window (from the first profiled fit's
start to the last one's end, on the trace's own clock), so overlapping
streams count once. An idle gap is a stretch of the window with nothing
on the device; the host operation open at its middle (the innermost CPU
event that spans it) names what the host was doing then.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

FIT_RANGE = "h100_bench.fit"
# gaps named by their host operation, longest first; the rest are summed
# into the idle total only
NAMED_GAPS = 500
TOP = 10


@contextlib.contextmanager
def profiled(device):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof


def fit_range():
    return torch.profiler.record_function(FIT_RANGE)


def _union(iv: np.ndarray) -> np.ndarray:
    """Sorted, merged (start, end) intervals."""
    if not len(iv):
        return iv
    iv = iv[np.argsort(iv[:, 0])]
    out = [iv[0].copy()]
    for s, e in iv[1:]:
        if s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append(np.array([s, e]))
    return np.array(out)


def summarize(prof, *, n_fits: int) -> dict:
    """Device busy and window seconds, device time by operation name,
    copies by direction, and the breakdown's two top-10 lists."""
    dev_ev, cpu_ev, fits = [], [], []
    for e in prof.events():
        s, t = float(e.time_range.start), float(e.time_range.end)
        if e.device_type.name == "CUDA":
            # a record_function range is mirrored on the device's
            # timeline; it is no device work
            if e.name != FIT_RANGE and not getattr(
                    e, "is_user_annotation", False):
                dev_ev.append((e.name, s, t))
        else:
            if e.name == FIT_RANGE:
                fits.append((s, t))
            cpu_ev.append((e.name, s, t))
    if fits:
        w0, w1 = min(s for s, _ in fits), max(t for _, t in fits)
    else:
        w0 = min((s for _, s, _ in cpu_ev), default=0.0)
        w1 = max((t for _, _, t in cpu_ev), default=0.0)
    by_name: dict = {}
    d2h = 0
    iv = []
    for name, s, t in dev_ev:
        s, t = max(s, w0), min(t, w1)
        if t <= s:
            continue
        by_name[name] = by_name.get(name, 0.0) + (t - s) * 1e-6
        d2h += "DtoH" in name
        iv.append((s, t))
    busy = _union(np.array(iv, np.float64).reshape(-1, 2))
    busy_s = float((busy[:, 1] - busy[:, 0]).sum()) * 1e-6 if len(busy) else 0.0
    window_s = (w1 - w0) * 1e-6
    # idle gaps inside the window, each named by the host's innermost op
    edges = np.concatenate([[w0], busy.reshape(-1), [w1]]).reshape(-1, 2)
    gaps = edges[(edges[:, 1] - edges[:, 0]) > 0]
    order = np.argsort(gaps[:, 0] - gaps[:, 1])[:NAMED_GAPS]
    names = [n for n, _, _ in cpu_ev if n != FIT_RANGE]
    cs = np.array([s for n, s, _ in cpu_ev if n != FIT_RANGE], np.float64)
    ce = np.array([t for n, _, t in cpu_ev if n != FIT_RANGE], np.float64)
    idle: dict = {}
    for g in gaps[order]:
        mid = 0.5 * (g[0] + g[1])
        hit = np.flatnonzero((cs <= mid) & (ce >= mid))
        label = (names[hit[np.argmax(cs[hit])]] if len(hit)
                 else "(python: no operation open)")
        idle[label] = idle.get(label, 0.0) + (g[1] - g[0]) * 1e-6
    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    top_idle = sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]
    return {
        "n_fits": n_fits, "busy_s": busy_s, "window_s": window_s,
        "device_s_by_name": by_name,
        "d2h": d2h,
        "breakdown": {"device_ops": [[n[:120], v] for n, v in top_ops],
                      "idle_gaps": [[n[:120], v] for n, v in top_idle]},
    }

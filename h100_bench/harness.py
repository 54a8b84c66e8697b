"""One run of one cell: set-up, the measured window, the check, the metrics.

Everything that belongs to one cell is found by name, so a new cell, a
new configuration or a new per-layer metric is new files and new entries
of ``BENCHMARK.json``, and no edit here:

- a cell (an entry of ``BENCHMARK.json``'s ``workloads``) names a
  configuration and a traffic mix;
- a configuration is the file its ``BENCHMARK.json`` entry names
  (``configs/<config>.json``): the estimator and its ``params``, its
  ``data`` (whose ``generator`` is ``data/<generator>.py``) and its
  ``check`` (``checks/<check>.py``, which decides ``correct``);
- a traffic mix is ``traffic/<traffic>.json``: its ``loop``
  (``loops/<loop>.py``, which drives the window), the ``call`` the loop
  makes on the estimator, and the ``estimator_params`` it sets;
- a per-layer metric is ``metrics/<name>.py``.

The run (:func:`run_cell`):

1. set-up (:func:`setup`): the program's kernels built or found in its
   compile cache (inside the checkout), the cell's data made from the
   seed on the host, and one warm call of the cell's own shapes;
2. the window: the traffic's loop, which also works out the end-to-end
   metrics its window measures (``fit_s`` for the closed loop of fits);
3. after the window: the device's peak, the program's state freed, and
   the check's plain reference run on the same inputs and compared with
   the last call's outputs; every other call of the window has to have
   produced the same.
"""

from __future__ import annotations

import dataclasses
import hashlib
import importlib
import json
import math
import re
import time
from pathlib import Path

import numpy as np
import torch

from h100_bench.reference import compare

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
GIB = float(1 << 30)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def find(kind: str, name: str):
    """The module of ``name`` under ``h100_bench/<kind>/``: a check, a data
    generator, a loop or a per-layer metric. A ``-`` in the name is a
    ``_`` in the module's, a ``.`` a subpackage (``dispatch_ms.train`` is
    ``dispatch_ms/train.py``)."""
    if not NAME.match(name) or ".." in name or name.endswith("."):
        raise ValueError(f"{name!r} is not the name of a {kind} module")
    return importlib.import_module(
        f"h100_bench.{kind}.{name.replace('-', '_')}")


def cell_spec(name: str, overrides: dict | None = None) -> tuple:
    """``(cell, config, traffic)`` of the cell called ``name``;
    ``overrides`` replace keys of the configuration's ``params`` and
    ``data`` (a test's smaller sizes, a reading's own data seed)."""
    bench = benchmark()
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    cfg = json.loads((ROOT / entry["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{cell['traffic']}.json")
                         .read_text())
    ov = overrides or {}
    cfg = dict(cfg, params=dict(cfg["params"], **ov.get("params", {})),
               data=dict(cfg["data"], **ov.get("data", {})))
    return cell, cfg, traffic


def per_layer(cell: str) -> list:
    """The ``per_layer`` entries of ``BENCHMARK.json`` that ``cell``
    reports."""
    return [m for m in benchmark()["per_layer"]
            if cell in m.get("workloads", [cell])]


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class Setup:
    """A cell's run, set up: its specification, data and estimator."""

    cell: dict
    cfg: dict
    traffic: dict
    params: dict
    check: object
    X: np.ndarray
    y: np.ndarray
    device: torch.device

    def estimator(self):
        from mpitree_tpu_torch import tree as port

        cls = getattr(port, self.cfg["estimator"])
        return cls(device=self.device, **self.params)

    def call(self):
        """One user call: a fresh estimator, the traffic's call on the
        host arrays, and a device synchronisation. Returns the
        estimator."""
        est = self.estimator()
        getattr(est, self.traffic["call"])(self.X, self.y)
        sync(self.device)
        return est

    def outputs(self, est) -> dict:
        return {"model": self.check.outputs(est),
                "stats": getattr(est, "fit_stats_", None)}

    def reference(self, *, control: bool = False) -> dict:
        return self.check.reference(self.params, self.X, self.y,
                                    self.device, control=control)


def setup(name: str, seed: int, *, device=None, overrides=None,
          warm: bool = True) -> Setup:
    """Set cell ``name`` up for a run with ``seed``: the program's kernels
    (on the card), the data, and with ``warm`` one call of the cell's own
    shapes. ``device`` (default ``"cuda"``) and ``overrides`` let tests
    make the same run on the CPU at a small size."""
    device = torch.device("cuda" if device is None else device)
    cell, cfg, traffic = cell_spec(name, overrides)
    if device.type == "cuda":
        from mpitree_tpu_torch import _build

        _build.build_all()
    X, y = find("data", cfg["data"]["generator"]).make(cfg["data"], seed)
    s = Setup(cell=cell, cfg=cfg, traffic=traffic,
              params=dict(cfg["params"], **traffic.get("estimator_params",
                                                       {})),
              check=find("checks", cfg["check"]), X=X, y=y, device=device)
    if warm:
        s.call()
    return s


def _digest(model) -> str:
    """A digest of every array of a check's outputs, in order."""
    h = hashlib.blake2b(digest_size=16)

    def walk(v):
        if isinstance(v, dict):
            for k in sorted(v):
                h.update(k.encode())
                walk(v[k])
        elif isinstance(v, (list, tuple)):
            for x in v:
                walk(x)
        else:
            h.update(np.ascontiguousarray(v).tobytes())

    walk(model)
    return h.hexdigest()


def run_cell(name: str, *, seed: int, seconds: float, trace: bool,
             device=None, t_start: float | None = None,
             overrides: dict | None = None) -> dict:
    """One run of cell ``name``; returns the result line's fields. The
    caller has checked for the card; ``device`` and ``overrides`` are
    :func:`setup`'s."""
    t_start = time.monotonic() if t_start is None else t_start
    s = setup(name, seed, device=device, overrides=overrides)
    loop = find("loops", s.traffic["loop"])
    if s.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(s.device)
    w = loop.window(s, s.traffic, seconds=seconds, trace=trace)
    setup_s = w["t0"] - t_start
    peak = (torch.cuda.max_memory_allocated(s.device)
            if s.device.type == "cuda" else 0)

    # the check: the program's state freed, then the plain reference
    outs, profiled = w["outs"], w["profiled"]
    if s.device.type == "cuda":
        torch.cuda.empty_cache()
    last = outs[-1]["model"]
    want = s.reference()
    correct, table = compare.judge(s.check.LIMITS,
                                   s.check.numbers(last, want))
    ref_digest = _digest(last)
    failed = sum(_digest(o["model"]) != ref_digest for o in outs + profiled)
    correct = correct and failed == 0

    result = {"correct": bool(correct), "attempted": len(outs) + len(profiled),
              "failed": int(failed)}
    if not trace:
        # the loop's own end-to-end metrics, the card's peak and the set-up
        vals = dict(w["metrics"], peak_gib=peak / GIB, setup_s=setup_s)
        result["metrics"] = {m["name"]: {"value": vals[m["name"]],
                                         "unit": m["unit"]}
                             for m in benchmark()["end_to_end"]
                             if name in m.get("workloads", [name])}
    else:
        from h100_bench import trace as trace_lib

        summary = trace_lib.summarize(w["prof"], n_fits=len(profiled))
        ctx = {"config": s.cfg, "traffic": s.traffic, "params": s.params,
               "stats": [o["stats"] for o in outs], "profile": summary,
               "walls": w["walls"]}
        if hasattr(s.check, "work"):
            ctx["work"] = s.check.work(last, s.params, s.X, s.y, want)
        metrics = {}
        for m in per_layer(name):
            v = find("metrics", m["name"]).read(ctx)
            if v is not None and math.isfinite(v):
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        result["metrics"] = metrics
        result["breakdown"] = summary["breakdown"]
        result["device_extra"] = {"busy_s": summary["busy_s"],
                                  "window_s": summary["window_s"]}
    result["peak_bytes"] = int(peak)
    result["check"] = table
    result["walls"] = w["walls"]
    return result

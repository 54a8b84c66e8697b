"""The readings that the check's limits are set from (not run by the
benchmark's own runs).

    python h100_bench/control.py --workload <cell> --seeds 1 2 3 [--overrides JSON] [--out f.jsonl]

For each seed, in one process: the cell's set-up (``harness.setup``, no
warm call) with the seed as the run's seed and as the data seed, so the
readings span as many data instances as seeds; one call by the program
through the timed path's call; the check's plain reference; and the
reference one precision lower (the control). It prints one JSON line a
seed with the compared numbers of the program (``program``: the lower
readings) and of the control put in the program's place (``control``:
the upper readings). ``--overrides`` replaces keys of the configuration's
``params`` and ``data``, as ``harness.cell_spec`` takes them (a data seed
there holds for every seed).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(name: str, seed: int, *, device=None, overrides=None) -> dict:
    import torch

    from h100_bench import harness

    ov = dict(overrides or {})
    ov["data"] = {"seed": seed, **ov.get("data", {})}
    s = harness.setup(name, seed, device=device, overrides=ov, warm=False)
    t = time.monotonic()
    got = s.outputs(s.call())["model"]
    fit_s = time.monotonic() - t
    if s.device.type == "cuda":
        torch.cuda.empty_cache()
    want = s.reference()
    t = time.monotonic()
    ctrl = s.reference(control=True)
    ref_s = time.monotonic() - t
    return {"cell": name, "seed": seed, "data_seed": ov["data"]["seed"],
            "fit_s": fit_s, "reference_s": ref_s,
            "program": s.check.numbers(got, want),
            "control": s.check.numbers(ctrl, want)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--overrides", type=json.loads, default=None)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    for seed in args.seeds:
        line = json.dumps(readings(args.workload, seed,
                                   overrides=args.overrides))
        print(line, flush=True)
        if args.out:
            args.out.parent.mkdir(parents=True, exist_ok=True)
            with args.out.open("a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Run one cell of the benchmark once and print its result line.

    python h100_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds the program (``mpitree_tpu_torch``).
It needs as many CUDA cards as the cell asks for and never falls back to
the CPU: without them it exits with 2 and prints no result. The last line
of standard output is one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and
last ``check``, each compared number beside its limit); the compared
numbers are also the last lines of standard error. The process exits
with 3 and prints no result if JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "mpitree_tpu")


def _clean_env(trace: bool) -> None:
    """None of the program's knobs, no run store for its advisor; the
    span timing in traced runs only."""
    for k in [k for k in os.environ if k.startswith("MPITREE_TPU_")]:
        del os.environ[k]
    if trace:
        os.environ["MPITREE_TPU_PROFILE"] = "1"


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit() -> str | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def result_line(res: dict, device: dict, *, trace: bool) -> dict:
    """The contract's last line from :func:`harness.run_cell`'s result:
    ``correct``, ``attempted``, ``failed``, ``metrics``, ``device`` (with
    the traced window's ``busy_s`` and ``window_s``), ``breakdown`` in a
    traced run, and last the compared numbers with their limits."""
    if trace:
        device = dict(device, **res["device_extra"])
    line = {"correct": res["correct"], "attempted": res["attempted"],
            "failed": res["failed"], "metrics": res["metrics"],
            "device": device}
    if trace:
        line["breakdown"] = res["breakdown"]
    line["check"] = res["check"]
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _clean_env(bool(args.trace))
    sys.path.insert(0, str(ROOT))

    import torch

    from h100_bench import harness

    cell, _, _ = harness.cell_spec(args.workload)
    chips = int(cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); this machine "
              f"has {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    res = harness.run_cell(args.workload, seed=args.seed,
                           seconds=args.seconds, trace=bool(args.trace),
                           t_start=T_START)
    bad = forbidden_modules()
    if bad:
        print(f"loaded in the measured process: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": chips, "memory_peak_bytes": res["peak_bytes"],
              "power_limit": power_limit()}
    line = result_line(res, device, trace=bool(args.trace))
    print(f"fit walls (s): {res['walls']}", file=sys.stderr)
    for k, v in line["check"].items():
        print(f"check {k}: {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())

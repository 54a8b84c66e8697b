"""Knob-registry doc tooling: ``python -m mpitree_tpu_torch.config``.

Counterpart of ``mpitree_tpu/config/__main__.py`` for the port's table,
which lives in the README's port section between its own markers
(:data:`BEGIN` / :data:`END`); the JAX package's table and markers are
never read or written here.

- ``--markdown`` prints the registry as the port's knob table.
- ``--check [README]`` exits 1 when the table between the markers
  differs from the generated one.
- ``--write [README]`` rewrites that section in place.
"""

from __future__ import annotations

import argparse
import sys

from mpitree_tpu_torch.config import knobs
from mpitree_tpu_torch.utils.readme_table import DEFAULT_README, run_cli

BEGIN = "<!-- torch-knob-table:begin -->"
END = "<!-- torch-knob-table:end -->"


def main(argv: list | None = None) -> int:
    parser = argparse.ArgumentParser(prog="python -m mpitree_tpu_torch.config")
    return run_cli(parser, argv, table=knobs.markdown_table,
                   begin=BEGIN, end=END, what="knob table",
                   module="mpitree_tpu_torch.config", default=DEFAULT_README)


if __name__ == "__main__":
    sys.exit(main())

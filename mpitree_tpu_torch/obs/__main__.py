"""Event-registry doc tooling: ``python -m mpitree_tpu_torch.obs``.

Counterpart of ``mpitree_tpu/obs/__main__.py`` for the port's events
table (``obs/events.py``), which lives in the README's port section
between its own markers (:data:`BEGIN` / :data:`END`); the JAX package's
section and markers are never read or written here.

- ``--markdown`` prints the registry as the port's events section.
- ``--check [README]`` exits 1 when the section between the markers
  differs from the generated one.
- ``--write [README]`` rewrites that section in place.
"""

from __future__ import annotations

import argparse
import sys

from mpitree_tpu_torch.obs import events
from mpitree_tpu_torch.utils.readme_table import DEFAULT_README, run_cli

BEGIN = "<!-- torch-event-table:begin -->"
END = "<!-- torch-event-table:end -->"


def main(argv: list | None = None) -> int:
    parser = argparse.ArgumentParser(prog="python -m mpitree_tpu_torch.obs")
    return run_cli(parser, argv, table=events.markdown_table,
                   begin=BEGIN, end=END, what="events section",
                   module="mpitree_tpu_torch.obs", default=DEFAULT_README)


if __name__ == "__main__":
    sys.exit(main())

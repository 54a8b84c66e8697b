"""The README drift gate shared by the registries' CLIs
(``python -m mpitree_tpu_torch.config`` and ``python -m
mpitree_tpu_torch.obs``): a generated table lives between two marker
lines, and ``--check`` / ``--write`` compare or rewrite only that
section, so every other byte of the file stays as it is."""

from __future__ import annotations

import os
import sys

DEFAULT_README = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "README.md")


def split_readme(text: str, begin: str, end: str):
    """``(head, table, tail)`` around the markers, or None without them."""
    try:
        head, rest = text.split(begin, 1)
        table, tail = rest.split(end, 1)
    except ValueError:
        return None
    return head, table, tail


def run_cli(parser, argv, *, table, begin: str, end: str, what: str,
            module: str, default: str) -> int:
    """``--markdown`` / ``--check [README]`` / ``--write [README]`` for
    the table ``table()`` renders between ``begin`` and ``end``."""
    group = parser.add_mutually_exclusive_group(required=True)
    group.add_argument("--markdown", action="store_true",
                       help=f"print the {what} generated from the registry")
    group.add_argument("--check", nargs="?", const=default, metavar="README",
                       help=f"fail (exit 1) when the README {what} drifts "
                       "from the registry")
    group.add_argument("--write", nargs="?", const=default, metavar="README",
                       help=f"rewrite the README {what} from the registry")
    args = parser.parse_args(argv)
    rendered = table()
    if args.markdown:
        print(rendered, end="")
        return 0
    path = args.check or args.write
    with open(path, encoding="utf-8") as fh:
        text = fh.read()
    parts = split_readme(text, begin, end)
    if parts is None:
        print(f"{what} markers ({begin} / {end}) not found in {path}",
              file=sys.stderr)
        return 1
    head, current, tail = parts
    if args.write:
        with open(path, "w", encoding="utf-8") as fh:
            fh.write(f"{head}{begin}\n{rendered}{end}{tail}")
        print(f"{what} rewritten in {path}", file=sys.stderr)
        return 0
    if current.strip() != rendered.strip():
        print(f"README {what} in {path} drifted from the registry — run "
              f"`python -m {module} --write` to regenerate", file=sys.stderr)
        return 1
    print(f"README {what} matches the registry", file=sys.stderr)
    return 0

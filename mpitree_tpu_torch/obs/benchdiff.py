"""benchdiff — the regression gate over stored run and bench artifacts.

The port's twin of ``tools/benchdiff.py``, over the port's own
``obs.diff``, ``obs.flight`` and ``obs.record``: the same modes, verdict
grammar and exit codes. Run it as ``python -m
mpitree_tpu_torch.obs.benchdiff``. Comparison sources:

- two positional paths — ``dump_report(path)`` JSON files (full
  BuildRecords): digest metrics compare AND a fingerprint divergence
  bisects to the first divergent (tree, level, channel);
- ``--store <run_dir> [--kind fit] [--section S] [--platform P]`` — the
  newest flight envelope vs its lineage baseline
  (``obs.flight.FlightStore``). With ``--cross-platform <platform>``: vs
  its sibling lineage on another device type instead (``cpu`` for a
  lineage on the card) — structural metrics only (psum/wire/nodes/
  fingerprint), advisory, always exit 0;
- ``--bench A.json B.json ...`` — driver artifacts with a ``parsed``
  payload: the NEWEST file is the candidate, the previous parseable one
  the baseline, everything earlier the history that seeds noise
  thresholds;
- ``--jsonl FILE --section S`` — the newest stored section payload of a
  JSON-lines file vs the previous capture of the same section.

Exit code: 0 for ok/changed/improved, 1 for regression/diverged (the
gate), 2 for usage/IO problems. ``--format github`` emits workflow
annotations; ``--json`` prints the whole diff dict after the verdict.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from mpitree_tpu_torch.obs import diff as diff_mod
from mpitree_tpu_torch.obs import flight as flight_mod
from mpitree_tpu_torch.obs import record as record_mod

# The curated artifact comparison set: our build's wall/accuracy/
# throughput and the headline speedup. Reference-side walls are
# environment measurements, not ours — gating on them would fail CI on a
# slow runner with zero code change.
BENCH_METRICS = (
    "value", "vs_baseline", "ours_test_acc", "acc_delta_vs_sklearn",
    "throughput_cells_per_s", "tree_n_nodes", "tree_depth",
)


def bench_metrics(path: str) -> dict | None:
    """{metric: value} from one driver artifact, or None when its
    ``parsed`` payload is missing (a failed round — skipped, the
    tolerant-history contract)."""
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError):
        return None
    parsed = doc.get("parsed") if isinstance(doc, dict) else None
    if not isinstance(parsed, dict):
        return None
    flat = dict(parsed)
    detail = parsed.get("detail")
    if isinstance(detail, dict):
        for k, v in detail.items():
            flat.setdefault(k, v)
    return {
        k: flat[k] for k in BENCH_METRICS
        if isinstance(flat.get(k), (int, float))
        and not isinstance(flat.get(k), bool)
    }


def _env(metrics: dict | None = None, digest: dict | None = None,
         record: dict | None = None) -> dict:
    return {"metrics": metrics or {}, "digest": digest or {},
            "record": record}


def diff_bench(paths: list) -> tuple:
    """(diff, label) over driver artifacts, newest = candidate."""
    usable = [(p, m) for p, m in ((p, bench_metrics(p)) for p in paths)
              if m]
    if len(usable) < 2:
        return None, (
            f"need >= 2 parseable bench artifacts, got {len(usable)} of "
            f"{len(paths)} (rounds with parsed=null are skipped)"
        )
    (bp, bm), (cp, cm) = usable[-2], usable[-1]
    history = [_env(metrics=m) for _p, m in usable[:-1]]
    d = diff_mod.diff_envelopes(
        _env(metrics=bm), _env(metrics=cm), history=history)
    return d, f"{os.path.basename(bp)} -> {os.path.basename(cp)}"


def diff_jsonl(path: str, section: str) -> tuple:
    """Newest vs previous stored payload of one JSON-lines section."""
    payloads = []
    try:
        with open(path) as f:
            for ln in f:
                if not ln.strip():
                    continue
                try:
                    rec = json.loads(ln)
                except json.JSONDecodeError:
                    continue
                p = rec.get(section) if isinstance(rec, dict) else None
                if isinstance(p, dict):
                    payloads.append(p)
    except OSError as e:
        return None, f"cannot read {path}: {e}"
    if len(payloads) < 2:
        return None, (
            f"section {section!r} has {len(payloads)} stored payload(s) "
            "in the jsonl; need >= 2 to diff"
        )
    d = diff_mod.diff_payloads(
        payloads[-2], payloads[-1], history=payloads[:-1])
    return d, f"{section} (jsonl history n={len(payloads)})"


def _lineage_key(env: dict) -> tuple:
    return tuple(env.get(k) for k in flight_mod.LINEAGE_KEYS)


def _label(env: dict) -> str:
    return (f"{env.get('kind')}:"
            f"{env.get('section') or env.get('config_digest')}")


def diff_store(root: str, *, kind=None, section=None,
               platform=None) -> tuple:
    """Newest flight envelope vs its lineage baseline, from one read of
    the store (envelopes can embed full BuildRecords)."""
    store = flight_mod.FlightStore(root)
    rows = store.entries(kind=kind, section=section, platform=platform)
    if not rows:
        return None, f"no entries in {store.path} match the filters"
    cand = rows[-1]
    history = [e for e in rows[:-1] if _lineage_key(e) == _lineage_key(cand)]
    if not history:
        return None, (
            "newest entry has no lineage baseline yet (first run of this "
            f"config on {cand.get('platform')}) — nothing to diff"
        )
    d = diff_mod.diff_envelopes(history[-1], cand, history=history)
    return d, f"{_label(cand)} @ {cand.get('platform')}"


def _structural_env(env: dict) -> dict:
    """The envelope with every non-structural metric stripped: across
    device types only deterministic channels compare (psum/wire bytes,
    node counts, fingerprints); walls and rates measure different
    silicon."""
    def keep(d: dict | None) -> dict:
        return {
            k: v for k, v in (d or {}).items()
            if k == "fingerprint"
            or (diff_mod.spec_for(k) or {}).get("kind") == "structural"
        }
    return {"metrics": keep(env.get("metrics")),
            "digest": keep(env.get("digest")),
            "record": env.get("record")}


def diff_cross_platform(root: str, *, kind=None, section=None,
                        platform=None, other: str) -> tuple:
    """Newest flight envelope vs its sibling lineage on ``other`` (same
    kind, section and config digest, another device type). Structural
    metrics only — advisory, never the gate."""
    store = flight_mod.FlightStore(root)
    rows = store.entries(kind=kind, section=section, platform=platform)
    if not rows:
        return None, f"no entries in {store.path} match the filters"
    cand = rows[-1]
    if cand.get("platform") == other:
        return None, (
            f"newest entry is already on {other!r}; pass --platform to "
            "pick the candidate side"
        )
    siblings = store.sibling_lineage(cand, platform=other)
    if not siblings:
        return None, (
            f"no {other!r} sibling lineage for the newest "
            f"{cand.get('platform')!r} entry "
            f"(kind={cand.get('kind')}, section={cand.get('section')}) "
            "— capture the same config there first"
        )
    d = diff_mod.diff_envelopes(
        _structural_env(siblings[-1]), _structural_env(cand),
        history=[_structural_env(e) for e in siblings])
    return d, (f"{_label(cand)} @ {other} -> {cand.get('platform')} "
               "(structural only)")


def diff_reports(base_path: str, cand_path: str) -> tuple:
    """Two ``dump_report(path)`` JSON files — full BuildRecord diff."""
    try:
        with open(base_path) as f:
            base = json.load(f)
        with open(cand_path) as f:
            cand = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        return None, f"cannot read reports: {e}"
    d = diff_mod.diff_envelopes(
        _env(digest=record_mod.digest(base), record=base),
        _env(digest=record_mod.digest(cand), record=cand),
    )
    return d, (
        f"{os.path.basename(base_path)} -> {os.path.basename(cand_path)}")


def _emit(d: dict, label: str, args) -> None:
    print(f"benchdiff {label}")
    print(diff_mod.format_diff(d, args.format))
    if args.json:
        print(json.dumps(d, indent=2, sort_keys=True))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="benchdiff", description=__doc__.splitlines()[0])
    p.add_argument("reports", nargs="*",
                   help="two dump_report JSON files (base, candidate)")
    p.add_argument("--bench", nargs="+", metavar="ARTIFACT.json",
                   help="driver artifacts, oldest first; newest = "
                        "candidate, earlier = history")
    p.add_argument("--jsonl", help="JSON-lines file to read --section from")
    p.add_argument("--section", help="section name (with --jsonl/--store)")
    p.add_argument("--store", metavar="RUN_DIR",
                   help="flight run dir (obs.flight store)")
    p.add_argument("--kind", default=None,
                   help="flight envelope kind filter (fit/serve/bench)")
    p.add_argument("--platform", default=None)
    p.add_argument("--cross-platform", metavar="PLATFORM", default=None,
                   help="with --store: compare the newest envelope "
                        "against its sibling lineage on PLATFORM "
                        "(structural metrics only; warns, exit 0)")
    p.add_argument("--format", choices=("human", "github"),
                   default="human")
    p.add_argument("--json", action="store_true",
                   help="print the full diff dict as JSON")
    args = p.parse_args(argv)

    if args.bench:
        d, label = diff_bench(args.bench)
    elif args.jsonl:
        if not args.section:
            print("benchdiff: --jsonl needs --section", file=sys.stderr)
            return 2
        d, label = diff_jsonl(args.jsonl, args.section)
    elif args.store and args.cross_platform:
        d, label = diff_cross_platform(
            args.store, kind=args.kind, section=args.section,
            platform=args.platform, other=args.cross_platform)
        if d is None:
            print(f"benchdiff: {label}", file=sys.stderr)
            return 2
        _emit(d, label, args)
        if diff_mod.exit_code(d):
            # advisory by contract: a cross-device divergence is a
            # heads-up, not a gate failure
            print("benchdiff: cross-platform divergence is advisory "
                  "(warning, not a gate)")
        return 0
    elif args.store:
        d, label = diff_store(
            args.store, kind=args.kind, section=args.section,
            platform=args.platform)
    elif len(args.reports) == 2:
        d, label = diff_reports(args.reports[0], args.reports[1])
    else:
        p.print_usage(sys.stderr)
        print("benchdiff: pass two report files, --bench, --jsonl, or "
              "--store", file=sys.stderr)
        return 2

    if d is None:
        print(f"benchdiff: {label}", file=sys.stderr)
        return 2
    _emit(d, label, args)
    return diff_mod.exit_code(d)


if __name__ == "__main__":
    sys.exit(main())

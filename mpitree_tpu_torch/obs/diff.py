"""obs.diff — record diffing, divergence localization, and the
noise-aware regression sentinel.

Counterpart of ``mpitree_tpu/obs/diff.py``, with the same constants,
metric classes, verdict grammar and return dicts, so a store or a pair
of reports gives one verdict whichever package reads it. Given two
comparable runs — flight-store envelopes (``obs.flight``), bench section
payloads, or raw ``fit_report_`` dicts — it emits per-metric verdicts
and one overall verdict:

- ``ok`` — every metric within its threshold;
- ``improved`` — at least one metric better, none worse;
- ``changed`` — a deterministic (structural) metric moved with no
  better/worse direction (node counts, levels) — worth a look, not a
  gate failure;
- ``regression`` — a gated metric got worse past its threshold;
- ``diverged`` — the whole-fit build-state *fingerprint* differs: the
  two runs built different trees. The per-level fingerprint rows are
  then bisected (:func:`localize_divergence`) to the first divergent
  (tree/round, level) and the most upstream divergent channel
  (histogram → winner → allocation), so a broken bit-identity pin
  arrives as "round 3, level 2, hist channel" instead of a red diff.

The port's fingerprints equal the JAX package's on equal trees
(``obs/fingerprint.py``), so the channel names carry over unchanged.

Noise model — thresholds are **seeded from run history, not magic
constants**: metrics are classed *noisy* (wall clock, throughput,
latency, accuracy — rerunning the same config moves them) or
*structural* (psum/wire/HBM bytes, compile counts, node counts — a
deterministic function of config + code, where ANY change is signal).
Noisy metrics gate at ``max(floor, NOISE_Z × robust CV)`` where the
robust CV is ``1.4826·MAD/median`` over the lineage history
(:func:`threshold_for`); with fewer than :data:`MIN_HISTORY` prior runs
the documented floor applies. Structural metrics compare exactly.

Stdlib only. ``python -m mpitree_tpu_torch.obs.benchdiff`` is its CLI.
"""

from __future__ import annotations

import statistics

DIFF_SCHEMA = 1

# Mirrors obs/fingerprint.CHANNELS (kept literal here: stdlib only, and
# the order IS the bisect's upstream-first report order). "refine" (v2)
# rides only refine-tail rows — crown rows omit it, and absent channels
# compare equal below — so a refine divergence reports by name.
CHANNELS = ("hist", "winner", "alloc", "refine")

# Robust z-score a noisy metric must exceed (vs lineage dispersion), and
# the minimum history depth before dispersion supersedes the floor.
NOISE_Z = 3.0
MIN_HISTORY = 3

# Metric classes. ``better``: which direction is an improvement (None =
# directionless structural change → verdict "changed"). ``rel``/``abs``:
# the no-history floor. Matching is exact-name first, then suffix.
METRIC_SPECS: dict = {
    # noisy wall-clock / latency (lower is better; rerun noise is real)
    "wall_s": {"kind": "noisy", "better": "lower", "rel": 0.25},
    "warm_s": {"kind": "noisy", "better": "lower", "rel": 0.25},
    "cold_s": {"kind": "noisy", "better": "lower", "rel": 0.40},
    "fit_s": {"kind": "noisy", "better": "lower", "rel": 0.25},
    "round_s": {"kind": "noisy", "better": "lower", "rel": 0.25},
    "value": {"kind": "noisy", "better": "lower", "rel": 0.25},
    # noisy rates (higher is better)
    "throughput_cells_per_s": {
        "kind": "noisy", "better": "higher", "rel": 0.20,
    },
    "vs_baseline": {"kind": "noisy", "better": "higher", "rel": 0.25},
    # accuracy: absolute floor — 0.005 of accuracy is the parity budget;
    # relative thresholds are meaningless near 1.0
    "test_acc": {"kind": "noisy", "better": "higher", "abs": 0.005},
    "ours_test_acc": {"kind": "noisy", "better": "higher", "abs": 0.005},
    "acc_delta_vs_sklearn": {
        "kind": "noisy", "better": "higher", "abs": 0.005,
    },
    # structural: deterministic per (config, code) — any move is signal.
    # Directional ones gate (more bytes / more compiles = regression);
    # directionless ones report "changed".
    "psum_bytes": {"kind": "structural", "better": "lower"},
    "wire_bytes": {"kind": "structural", "better": "lower"},
    "wire_shard_bytes": {"kind": "structural", "better": "lower"},
    "hbm_peak_bytes": {"kind": "structural", "better": "lower"},
    "host_peak_bytes": {"kind": "structural", "better": "lower"},
    "compile_new": {"kind": "structural", "better": "lower"},
    "request_path_lowerings": {"kind": "structural", "better": "lower"},
    "events": {"kind": "structural", "better": "lower"},
    "n_nodes": {"kind": "structural", "better": None},
    "depth": {"kind": "structural", "better": None},
    "tree_depth": {"kind": "structural", "better": None},
    "tree_n_nodes": {"kind": "structural", "better": None},
    "levels": {"kind": "structural", "better": None},
    "expansions": {"kind": "structural", "better": None},
    "sub_frac": {"kind": "structural", "better": None},
    "feature_shards": {"kind": "structural", "better": None},
    "rounds_per_dispatch": {"kind": "structural", "better": None},
}

# Suffix fallbacks for section-payload scalars the table doesn't name
# (b64_p50_ms, sustained_rows_per_s, speedup_vs_estimator, ...).
_SUFFIX_SPECS = (
    ("_per_s", {"kind": "noisy", "better": "higher", "rel": 0.20}),
    ("_rows_per_s", {"kind": "noisy", "better": "higher", "rel": 0.20}),
    ("_p50_ms", {"kind": "noisy", "better": "lower", "rel": 0.35}),
    ("_p99_ms", {"kind": "noisy", "better": "lower", "rel": 0.50}),
    ("_ms", {"kind": "noisy", "better": "lower", "rel": 0.35}),
    ("_s", {"kind": "noisy", "better": "lower", "rel": 0.25}),
    ("_acc", {"kind": "noisy", "better": "higher", "abs": 0.005}),
    ("_bytes", {"kind": "structural", "better": "lower"}),
    ("_nodes", {"kind": "structural", "better": None}),
)

# Never compared (identity/bookkeeping fields that ride the same dicts).
_SKIP_KEYS = frozenset((
    "engine", "reason", "fingerprint", "record", "phases", "platform",
    "kernel", "ok", "partial", "ts", "git", "rows_cap",
))


def spec_for(metric: str) -> dict | None:
    """The metric's class spec, or None for uncompared keys."""
    if metric in _SKIP_KEYS:
        return None
    if metric in METRIC_SPECS:
        return METRIC_SPECS[metric]
    # First matching suffix wins; "_per_s" sits before "_s" so rates are
    # never misclassified as durations.
    for suffix, spec in _SUFFIX_SPECS:
        if metric.endswith(suffix):
            return spec
    return None


def scalar_metrics(payload: dict, *, prefix: str = "") -> dict:
    """Flatten a section payload / digest into comparable scalars.

    Top-level numeric scalars keep their names; an embedded ``record``
    digest contributes its own fields (digest names are already in the
    table). Booleans and strings are skipped.
    """
    out: dict = {}
    if not isinstance(payload, dict):
        return out
    for k, v in payload.items():
        if isinstance(v, bool) or k in _SKIP_KEYS and k != "record":
            continue
        if k == "record" and isinstance(v, dict):
            for rk, rv in v.items():
                if isinstance(rv, (int, float)) and not isinstance(rv, bool):
                    out.setdefault(rk, rv)
            continue
        if isinstance(v, (int, float)):
            out[prefix + k] = v
    return out


def history_values(history, metric: str) -> list:
    """The metric's numeric trajectory over lineage envelopes/payloads."""
    vals = []
    for h in history or ():
        m = {}
        m.update(scalar_metrics(h.get("digest") or {}))
        m.update(scalar_metrics(h.get("metrics") or {}))
        if not m:
            m = scalar_metrics(h)
        v = m.get(metric)
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            vals.append(float(v))
    return vals


def threshold_for(metric: str, spec: dict, history=None) -> dict:
    """``{"rel" | "abs": x, "source": ...}`` — the gate for one metric.

    Structural metrics compare exactly (rel 0 with a 1e-9 float grain).
    Noisy metrics: with >= MIN_HISTORY prior observations the threshold
    is ``max(floor, NOISE_Z * 1.4826 * MAD / |median|)`` — a lineage
    whose wall clock naturally wobbles 15% gets a wider gate than one
    that repeats to 1%; with thin history the documented floor applies.
    """
    if spec["kind"] == "structural":
        return {"rel": 1e-9, "source": "exact"}
    if "abs" in spec:
        return {"abs": float(spec["abs"]), "source": "floor"}
    floor = float(spec.get("rel", 0.25))
    vals = history_values(history, metric)
    if len(vals) >= MIN_HISTORY:
        med = statistics.median(vals)
        if med:
            mad = statistics.median([abs(v - med) for v in vals])
            cv = 1.4826 * mad / abs(med)
            noise = NOISE_Z * cv
            if noise > floor:
                return {
                    "rel": round(noise, 4),
                    "source": f"history dispersion (n={len(vals)})",
                }
    return {"rel": floor, "source": "floor"}


def _metric_row(metric: str, base, cand, spec: dict, history) -> dict:
    thr = threshold_for(metric, spec, history)
    base_f, cand_f = float(base), float(cand)
    delta = cand_f - base_f
    ratio = (cand_f / base_f) if base_f else None
    if "abs" in thr:
        breach = abs(delta) > thr["abs"]
    else:
        breach = base_f != 0 and abs(delta) / abs(base_f) > thr["rel"] or (
            base_f == 0 and cand_f != 0
        )
    verdict = "ok"
    if breach:
        better = spec.get("better")
        if better is None:
            verdict = "changed"
        else:
            worse = delta > 0 if better == "lower" else delta < 0
            verdict = "regression" if worse else "improvement"
    return {
        "metric": metric, "base": base, "cand": cand,
        "delta": round(delta, 6),
        "ratio": None if ratio is None else round(ratio, 4),
        "kind": spec["kind"], "threshold": thr, "verdict": verdict,
    }


def localize_divergence(fp_a: dict, fp_b: dict) -> dict | None:
    """Bisect two records' fingerprint rows to the first divergence.

    Returns ``{"tree", "level", "channel", "channels"}`` — the first
    divergent tree/round index, the first divergent level inside it, the
    most upstream divergent channel (:data:`CHANNELS` order) and every
    divergent channel at that level — or None when the rows match (or
    either side carries none).
    """
    ta = (fp_a or {}).get("trees") or []
    tb = (fp_b or {}).get("trees") or []
    if not ta or not tb:
        return None
    for t, (ra, rb) in enumerate(zip(ta, tb)):
        la = {r["level"]: r for r in ra}
        lb = {r["level"]: r for r in rb}
        for lvl in sorted(set(la) | set(lb)):
            a, b = la.get(lvl), lb.get(lvl)
            if a is None or b is None:
                return {
                    "tree": t, "level": lvl, "channel": "hist",
                    "channels": list(CHANNELS),
                    "note": "level present in only one run",
                }
            bad = [c for c in CHANNELS if a.get(c) != b.get(c)]
            if bad:
                return {
                    "tree": t, "level": lvl, "channel": bad[0],
                    "channels": bad,
                }
    if len(ta) != len(tb):
        return {
            "tree": min(len(ta), len(tb)), "level": 0, "channel": "hist",
            "channels": list(CHANNELS),
            "note": f"tree counts differ ({len(ta)} vs {len(tb)})",
        }
    return None


def diff_metrics(base: dict, cand: dict, *, history=None) -> list:
    """Per-metric verdict rows over the keys both sides carry."""
    rows = []
    for metric in sorted(set(base) & set(cand)):
        spec = spec_for(metric)
        if spec is None:
            continue
        b, c = base[metric], cand[metric]
        if not all(
            isinstance(v, (int, float)) and not isinstance(v, bool)
            for v in (b, c)
        ):
            continue
        rows.append(_metric_row(metric, b, c, spec, history))
    return rows


def _envelope_metrics(env: dict) -> dict:
    m = {}
    m.update(scalar_metrics(env.get("digest") or {}))
    m.update(scalar_metrics(env.get("metrics") or {}))
    return m


def diff_envelopes(base: dict, cand: dict, *, history=None) -> dict:
    """Diff two flight envelopes (or two ``{"digest","metrics","record"}``
    shaped dicts); ``history``: older lineage envelopes for thresholds.

    The sentinel verdict: fingerprint divergence dominates (different
    trees make perf deltas unattributable), then regressions, then
    structural changes, then improvements.
    """
    bm, cm = _envelope_metrics(base), _envelope_metrics(cand)
    rows = diff_metrics(bm, cm, history=history)
    fa = (base.get("digest") or {}).get("fingerprint")
    fb = (cand.get("digest") or {}).get("fingerprint")
    divergence = None
    if fa is not None and fb is not None and fa != fb:
        divergence = localize_divergence(
            (base.get("record") or {}).get("fingerprints") or {},
            (cand.get("record") or {}).get("fingerprints") or {},
        ) or {"tree": None, "level": None, "channel": None,
              "note": "whole-fit fingerprints differ; no per-level rows "
                      "stored to bisect"}
    regressions = [r["metric"] for r in rows if r["verdict"] == "regression"]
    changed = [r["metric"] for r in rows if r["verdict"] == "changed"]
    improved = [r["metric"] for r in rows if r["verdict"] == "improvement"]
    if divergence is not None:
        verdict = "diverged"
    elif regressions:
        verdict = "regression"
    elif changed:
        verdict = "changed"
    elif improved:
        verdict = "improved"
    else:
        verdict = "ok"
    return {
        "schema": DIFF_SCHEMA,
        "verdict": verdict,
        "metrics": rows,
        "regressions": regressions,
        "changed": changed,
        "improvements": improved,
        "fingerprint": {
            "base": fa, "cand": fb,
            "match": None if fa is None or fb is None else fa == fb,
            "divergence": divergence,
        },
        "n_history": len(history or ()),
    }


def diff_payloads(base_payload: dict, cand_payload: dict, *,
                  history=None) -> dict:
    """Diff two bench section payloads (one JSON line's sections):
    scalars + embedded record digests compare; ``history`` is earlier
    payloads of the same section."""
    return diff_envelopes(
        {"metrics": scalar_metrics(base_payload),
         "digest": (base_payload or {}).get("record") or {}},
        {"metrics": scalar_metrics(cand_payload),
         "digest": (cand_payload or {}).get("record") or {}},
        history=[
            {"metrics": scalar_metrics(h),
             "digest": (h or {}).get("record") or {}}
            for h in history or ()
        ],
    )


def exit_code(diff: dict) -> int:
    """Gate semantics: regressions and divergences fail; ok/changed/
    improved pass (changed still prints loudly)."""
    return 1 if diff.get("verdict") in ("regression", "diverged") else 0


def summary_line(diff: dict, *, label: str = "") -> str:
    """One log-friendly verdict line."""
    v = diff.get("verdict")
    parts = [f"{label + ': ' if label else ''}verdict={v}"]
    if diff.get("regressions"):
        worst = [
            r for r in diff["metrics"] if r["verdict"] == "regression"
        ]
        parts.append("regressed " + ", ".join(
            f"{r['metric']} {r['base']}→{r['cand']}" for r in worst[:4]
        ))
    dv = (diff.get("fingerprint") or {}).get("divergence")
    if dv:
        parts.append(
            f"diverged at tree={dv.get('tree')} level={dv.get('level')} "
            f"channel={dv.get('channel')}"
        )
    if diff.get("changed"):
        parts.append("changed " + ", ".join(diff["changed"][:4]))
    if v == "improved":
        parts.append("improved " + ", ".join(diff["improvements"][:4]))
    return " | ".join(parts)


def format_diff(diff: dict, fmt: str = "human") -> str:
    """Render a diff: ``human`` (one row per metric) or ``github``
    (workflow ``::error``/``::warning`` annotations — regressions and
    divergence error, changes warn)."""
    lines = []
    if fmt == "github":
        for r in diff["metrics"]:
            if r["verdict"] == "regression":
                lines.append(
                    f"::error title=benchdiff {r['metric']}::"
                    f"{r['metric']} regressed {r['base']} -> {r['cand']} "
                    f"(threshold {r['threshold']})"
                )
            elif r["verdict"] == "changed":
                lines.append(
                    f"::warning title=benchdiff {r['metric']}::"
                    f"{r['metric']} changed {r['base']} -> {r['cand']}"
                )
        dv = (diff.get("fingerprint") or {}).get("divergence")
        if dv:
            lines.append(
                "::error title=benchdiff divergence::builds diverged at "
                f"tree={dv.get('tree')} level={dv.get('level')} "
                f"channel={dv.get('channel')}"
            )
        lines.append(summary_line(diff))
        return "\n".join(lines)
    for r in diff["metrics"]:
        thr = r["threshold"]
        gate = (
            f"±{thr['abs']}" if "abs" in thr else f"±{thr['rel'] * 100:.1f}%"
        )
        lines.append(
            f"  {r['verdict']:<11} {r['metric']:<28} "
            f"{r['base']} -> {r['cand']}  ({gate}, {thr['source']})"
        )
    fpd = diff.get("fingerprint") or {}
    if fpd.get("match") is True:
        lines.append("  fingerprint  match")
    dv = fpd.get("divergence")
    if dv:
        lines.append(
            f"  DIVERGED at tree={dv.get('tree')} level={dv.get('level')} "
            f"channel={dv.get('channel')} (all: {dv.get('channels')})"
        )
    lines.append(summary_line(diff))
    return "\n".join(lines)

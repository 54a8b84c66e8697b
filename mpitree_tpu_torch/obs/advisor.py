"""obs.advisor — evidence-driven ``auto`` policies from the flight store.

Counterpart of ``mpitree_tpu/obs/advisor.py``, with its constants,
matching, noise gate and return dicts, so a store read by both packages
gives one answer. The static resolvers (``core/builder.
resolve_hist_subtraction``, the ``engine="auto"`` pick of
``core/builder.build_tree``, ``boosting/fused_rounds.
resolve_rounds_per_dispatch``, ``parallel/mesh.resolve_mesh_2d``)
encode preferences measured once and frozen into code
(``SUBTRACTION_AUTO``, ``ROUNDS_AUTO``, the fused engine, the
budget-driven mesh split). The flight store (``obs.flight``) holds the
A/B evidence those preferences were distilled from: ``kind="bench"``
envelopes under the sections ``subtraction_ab``, ``leafwise_ab``,
``gbdt_fusedK``, ``mesh2d_ab`` and ``serving``, with measured speedups
on THIS machine. An ``auto`` resolution may consult that lineage
history and pick the measured winner instead of the static guess.

Honesty contract (mirrors ``obs.diff``):

- Evidence is consulted only when the margin clears the lineage's own
  noise gate — ``max(floor, NOISE_Z * 1.4826 * MAD / |median|)``, the
  same robust dispersion model ``threshold_for`` uses. A lineage whose
  A/B ratio wobbles across 1.0 yields ``fallback="noise_gate"`` and the
  static policy applies bit-for-bit.
- Fewer than :data:`MIN_HISTORY` matched rows yields
  ``fallback="thin_history"`` — again the static policy, bit-for-bit.
- Evidence NEVER overrides a hard constraint: the fused-rounds
  blockers, and the leaf-wise reroute's bounds (finite depth, no
  feature axis, no monotonic constraints, no per-node sampling), are
  checked by the resolvers before the consultation; the advisor only
  replaces the *preference* heuristics.
- Every consultation is recorded as a typed ``advisor_<policy>``
  decision (winner, evidence count, margin, gate, fallback reason) so
  ``fit_report_`` explains why a policy flipped.

Gating: ``BuildConfig(policy_evidence="auto"|"off")`` (explicit config
wins) over the ambient ``MPITREE_TPU_POLICY_EVIDENCE`` knob, and the
store itself only exists under ``MPITREE_TPU_RUN_DIR`` — with no store
configured every consultation is a cheap ``None`` (two knob reads, no
I/O) and resolutions are exactly the static ones.

Workload matching: bench envelopes carry their workload shape in
``metrics`` (``n_samples`` / ``n_features`` / ...); a consultation ranks
same-platform rows by log-space distance over the shared shape keys and
reads the nearest :data:`NEAREST_K`. A stored row from a 10x larger
dataset still counts — nearest-first just prefers better-matched
evidence when it exists. The platform is the device type: ``"cuda"`` on
the card, ``"cpu"`` on the CPU.

:func:`advise_serving_kernel` is kept so that a store read by both
packages gives one answer, but nothing in the port calls it: the body a
served model's launches take (``csrc/traverse.cu``, or ``csrc/margin.cu``
for a boosted model of small trees) follows from the model alone, so
there is no choice for evidence to make and a served model records no
``advisor_serving_kernel`` decision (``MPITREE_TPU_SERVING_KERNEL`` is in
``config/knobs.NOT_ON_THE_CARD``).

Stdlib only.
"""

from __future__ import annotations

import math
import statistics

from mpitree_tpu_torch.config import knobs
from mpitree_tpu_torch.obs import diff as diff_mod
from mpitree_tpu_torch.obs import flight as flight_mod

POLICY_ENV = "MPITREE_TPU_POLICY_EVIDENCE"

MIN_HISTORY = diff_mod.MIN_HISTORY
NOISE_Z = diff_mod.NOISE_Z

# Evidence window: the nearest-by-shape rows a consultation reads. Wide
# enough for the MAD noise model to mean something, narrow enough that
# a store full of foreign workloads cannot outvote the matched ones.
NEAREST_K = 8

# Relative margin floor: even a perfectly quiet lineage must clear ±5%
# before evidence flips a policy — sub-noise "wins" are not wins.
MARGIN_FLOOR = 0.05

# Numeric envelope-metric keys that describe the workload (not the
# result); the nearest-match distance reads whichever of these both
# sides carry.
SHAPE_KEYS = (
    "n_samples", "n_features", "n_bins", "n_classes", "max_iter",
    "max_depth", "n_trees", "fit_rows", "n_devices",
)


def enabled(policy_evidence: str = "auto") -> bool:
    """Whether consultations may run: config gate, env knob, live store."""
    if str(policy_evidence) == "off":
        return False
    if knobs.value(POLICY_ENV) == "off":
        return False
    return flight_mod.enabled()


def _store():
    try:
        return flight_mod.FlightStore()
    except ValueError:  # no RUN_DIR and no explicit root
        return None


def _shape_distance(metrics: dict, shape: dict | None) -> float:
    """Log-space L2 distance over shared shape keys (inf: no overlap).

    Log-space because workloads differ multiplicatively — 1M rows vs
    100k rows should out-distance 64 bins vs 256 bins by the same factor
    regardless of the keys' absolute scales.
    """
    if not shape:
        return math.inf
    d, shared = 0.0, 0
    for k in SHAPE_KEYS:
        a, b = shape.get(k), metrics.get(k)
        if (isinstance(a, (int, float)) and not isinstance(a, bool)
                and isinstance(b, (int, float)) and not isinstance(b, bool)
                and a > 0 and b > 0):
            d += math.log(a / b) ** 2
            shared += 1
    return math.sqrt(d / shared) if shared else math.inf


def nearest_evidence(store, *, section: str, platform: str | None,
                     shape: dict | None, limit: int = NEAREST_K) -> list:
    """Same-platform ``kind="bench"`` envelopes of ``section``, nearest
    workload shape first (recency breaks ties), at most ``limit``."""
    rows = store.entries(kind="bench", section=section, platform=platform)
    scored = [
        (_shape_distance(env.get("metrics") or {}, shape), -i, env)
        for i, env in enumerate(rows)
    ]
    scored.sort(key=lambda t: (t[0], t[1]))
    return [env for _, _, env in scored[:limit]]


def _metric_values(rows: list, metric: str) -> list:
    vals = []
    for env in rows:
        v = (env.get("metrics") or {}).get(metric)
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            vals.append(float(v))
    return vals


def _noise_gate(values: list, floor: float = MARGIN_FLOOR) -> tuple:
    """(median, rel_gate): the lineage's own robust dispersion, floored."""
    med = statistics.median(values)
    if not med:
        return med, floor
    mad = statistics.median([abs(v - med) for v in values])
    return med, max(floor, NOISE_Z * 1.4826 * mad / abs(med))


def _advice(policy: str, value, *, section: str, n: int,
            median=None, margin=None, gate=None,
            fallback: str | None = None) -> dict:
    return {
        "policy": policy,
        "value": value,            # winner, or None -> static policy
        "section": section,        # evidence lineage consulted
        "evidence_n": n,           # matched rows that carried the metric
        "median": None if median is None else round(median, 4),
        "margin": None if margin is None else round(margin, 4),
        "gate": None if gate is None else round(gate, 4),
        "fallback": fallback,      # why value is None (None when decided)
    }


def _advise_ratio(store, *, policy: str, section: str, metric: str,
                  platform: str | None, shape: dict | None,
                  hi, lo) -> dict:
    """Generic A/B-ratio consultation: ``metric`` is a B-over-A speedup
    ratio; ``hi`` wins when the matched median clears ``1 + gate``,
    ``lo`` when it clears ``1 - gate``, static policy otherwise."""
    rows = nearest_evidence(
        store, section=section, platform=platform, shape=shape,
    )
    vals = _metric_values(rows, metric)
    if len(vals) < MIN_HISTORY:
        return _advice(
            policy, None, section=section, n=len(vals),
            fallback="thin_history",
        )
    med, gate = _noise_gate(vals)
    margin = abs(med - 1.0)
    if med > 1.0 + gate:
        value = hi
    elif med < 1.0 - gate:
        value = lo
    else:
        return _advice(
            policy, None, section=section, n=len(vals), median=med,
            margin=margin, gate=gate, fallback="noise_gate",
        )
    return _advice(
        policy, value, section=section, n=len(vals), median=med,
        margin=margin, gate=gate,
    )


# -- per-policy consultations ----------------------------------------------

def advise_hist_subtraction(*, platform: str, shape: dict | None = None,
                            policy_evidence: str = "auto",
                            store=None) -> dict | None:
    """"on" / "off" from stored ``subtraction_ab`` A/Bs, or None.

    Evidence metric: ``warm_speedup_on_vs_off`` (off-side warm wall over
    on-side warm wall — >1 means the subtraction won). Rows where auto
    resolved off record ``warm_speedup_off_vs_off`` instead, which is
    correctly invisible here: an off-vs-off "A/B" carries no evidence
    about the trick.
    """
    if not enabled(policy_evidence):
        return None
    store = store if store is not None else _store()
    if store is None:
        return None
    return _advise_ratio(
        store, policy="hist_subtraction", section="subtraction_ab",
        metric="warm_speedup_on_vs_off", platform=platform, shape=shape,
        hi="on", lo="off",
    )


def advise_engine(*, platform: str, shape: dict | None = None,
                  policy_evidence: str = "auto",
                  store=None) -> dict | None:
    """"leafwise" / "levelwise" from stored ``leafwise_ab`` A/Bs, or None.

    Evidence metric: ``warm_speedup_x`` (level-wise warm wall over
    leaf-wise warm wall on the same workload — >1 means the best-first
    frontier won). The caller owns the hard admissibility constraints a
    measured win can never override (leaf budget fits the level-wise
    node bound so trees stay bit-identical, no feature axis, no
    monotonic constraints); the consultation only replaces the "one
    fused program beats per-level dispatch" preference heuristic.
    """
    if not enabled(policy_evidence):
        return None
    store = store if store is not None else _store()
    if store is None:
        return None
    return _advise_ratio(
        store, policy="engine", section="leafwise_ab",
        metric="warm_speedup_x", platform=platform, shape=shape,
        hi="leafwise", lo="levelwise",
    )


def advise_rounds_per_dispatch(*, platform: str, shape: dict | None = None,
                               policy_evidence: str = "auto",
                               store=None) -> dict | None:
    """"fused" / "host" from stored ``gbdt_fusedK`` A/Bs, or None.

    Evidence metric: ``fit_speedup_x`` (host-loop fit wall over fused-K
    fit wall). A "fused" verdict also carries ``K`` — the median of the
    winning rows' recorded K — so the caller dispatches the K the
    evidence was measured at, not a hardcoded default.
    """
    if not enabled(policy_evidence):
        return None
    store = store if store is not None else _store()
    if store is None:
        return None
    adv = _advise_ratio(
        store, policy="rounds_per_dispatch", section="gbdt_fusedK",
        metric="fit_speedup_x", platform=platform, shape=shape,
        hi="fused", lo="host",
    )
    if adv["value"] == "fused":
        rows = nearest_evidence(
            store, section="gbdt_fusedK", platform=platform, shape=shape,
        )
        ks = [int(k) for k in _metric_values(rows, "K") if k >= 1]
        if ks:
            adv["K"] = int(statistics.median(ks))
    return adv


def advise_mesh_2d(*, platform: str, shape: dict | None = None,
                   policy_evidence: str = "auto",
                   store=None) -> dict | None:
    """"2d" / "1d" from stored ``mesh2d_ab`` A/Bs, or None.

    Evidence metric: ``warm_speedup_2d_vs_1d`` (1-D warm wall over 2-D
    warm wall on the same workload and device count).
    """
    if not enabled(policy_evidence):
        return None
    store = store if store is not None else _store()
    if store is None:
        return None
    return _advise_ratio(
        store, policy="mesh_2d", section="mesh2d_ab",
        metric="warm_speedup_2d_vs_1d", platform=platform, shape=shape,
        hi="2d", lo="1d",
    )


def advise_serving_kernel(*, platform: str, shape: dict | None = None,
                          policy_evidence: str = "auto",
                          store=None) -> dict | None:
    """"pallas" / "xla" from stored ``serving`` sections, or None.

    Serving rows are not A/B pairs — each run served one resolved kernel
    (``kernel_pallas`` 0/1) at a measured ``sustained_rows_per_s`` — so
    the consultation groups the matched rows by kernel and compares the
    groups' median throughputs. Both groups need :data:`MIN_HISTORY`
    rows; the margin must clear the noisier group's own gate. No module
    of the port calls it (the module docstring says why).
    """
    if not enabled(policy_evidence):
        return None
    store = store if store is not None else _store()
    if store is None:
        return None
    rows = nearest_evidence(
        store, section="serving", platform=platform, shape=shape,
        limit=NEAREST_K * 2,  # two groups share the window
    )
    groups: dict = {0: [], 1: []}
    for env in rows:
        m = env.get("metrics") or {}
        k = m.get("kernel_pallas")
        v = m.get("sustained_rows_per_s")
        if (k in (0, 1) and isinstance(v, (int, float))
                and not isinstance(v, bool)):
            groups[int(k)].append(float(v))
    n = len(groups[0]) + len(groups[1])
    if len(groups[0]) < MIN_HISTORY or len(groups[1]) < MIN_HISTORY:
        return _advice(
            "serving_kernel", None, section="serving", n=n,
            fallback="thin_history",
        )
    med_x, gate_x = _noise_gate(groups[0])
    med_p, gate_p = _noise_gate(groups[1])
    if not med_x:
        return _advice(
            "serving_kernel", None, section="serving", n=n,
            fallback="noise_gate",
        )
    ratio = med_p / med_x
    gate = max(gate_x, gate_p)
    margin = abs(ratio - 1.0)
    if ratio > 1.0 + gate:
        value = "pallas"
    elif ratio < 1.0 - gate:
        value = "xla"
    else:
        return _advice(
            "serving_kernel", None, section="serving", n=n, median=ratio,
            margin=margin, gate=gate, fallback="noise_gate",
        )
    return _advice(
        "serving_kernel", value, section="serving", n=n, median=ratio,
        margin=margin, gate=gate,
    )


def record_advice(obs, advice: dict | None) -> None:
    """One typed ``advisor_<policy>`` decision per consultation (no-op
    when the consultation never ran or there is no observer)."""
    if obs is None or advice is None:
        return
    value = advice["value"] if advice["value"] is not None else "static"
    reason = (
        f"flight-store evidence ({advice['section']}, "
        f"n={advice['evidence_n']}): measured winner"
        if advice["fallback"] is None else
        f"flight-store evidence ({advice['section']}, "
        f"n={advice['evidence_n']}) inconclusive "
        f"({advice['fallback']}); static policy applies"
    )
    obs.decision(
        f"advisor_{advice['policy']}", value, reason=reason,
        evidence_n=advice["evidence_n"], median=advice["median"],
        margin=advice["margin"], gate=advice["gate"],
        fallback=advice["fallback"],
    )

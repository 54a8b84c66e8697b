"""obs.cost — the compute ledger on the card.

Counterpart of ``mpitree_tpu/obs/cost.py``: the third sibling of the wire
ledger (``record.wire``) and the memory ledger (``record.memory``), with
its record section (``record.compute``), its join
(:func:`compute_section`: per-entry floors, achieved utilisation,
per-level floors and a roofline verdict) and its honesty contract (what
cannot be priced is ``None``, with the reason recorded). What differs is
the capture: the port has no XLA cost model, so each entry's per-dispatch
``{"flops", "bytes"}`` is the port's own count from the shapes
(:func:`hist_launch_cost`, :func:`levels_cost`, :func:`leafwise_cost`,
:func:`traverse_cost`, :func:`margin_cost`), taken once per static key of
the entry
(``BuildObserver.price_dispatch``) and reused by later fits with the same
key, as the JAX package reuses one lowering's analysis.

The bytes of a histogram launch are what it must read and write: the
slot vector, the byte-wide bins and float32 payload of every row in
range, the sorted route's order and segment offsets, and the output
once: the count ``chip_smoke.py`` divides by the card's memory rate for
the kernel table's ``bound_ms``. Its flops are one add per (row,
feature). A fit's entry adds the float64 split sweep's read of each
histogram to its bytes and nothing to its flops: no float32 peak applies
to float64 work, so the sweep is priced on its bytes alone (the entry's
``note`` says so).

:data:`PEAK_TABLE` keys the card's published peaks by a lowercase
substring of ``torch.cuda.get_device_name()``; ``MPITREE_TPU_PEAK_FLOPS``
and ``MPITREE_TPU_PEAK_HBM_GBPS`` override them field by field. The CPU
prices to ``None`` (as the JAX package's CPU backend does, silently); an
unknown card prices to ``None`` with a typed ``cost_unavailable`` event,
as does a count that fails.
"""

from __future__ import annotations

from mpitree_tpu_torch.config import knobs

PEAK_FLOPS_ENV = "MPITREE_TPU_PEAK_FLOPS"
PEAK_HBM_ENV = "MPITREE_TPU_PEAK_HBM_GBPS"

# Published peaks from the NVIDIA H100 Tensor Core GPU datasheet, keyed by
# a lowercase substring of torch.cuda.get_device_name(); first match wins,
# so the PCIe part comes before the generic row. ``flops`` is the float32
# non-tensor peak (the histogram adds run on the CUDA cores), ``hbm_gbps``
# the memory bandwidth, ``ici_gbps`` the NVLink bandwidth (the record
# keeps the JAX package's key for the interconnect leg).
PEAK_TABLE: tuple = (
    # H100 PCIe ("NVIDIA H100 PCIe"): HBM2e; no NVLink figure is used
    ("h100 pcie", dict(flops=51e12, hbm_gbps=2000.0, ici_gbps=None)),
    # H100 SXM ("NVIDIA H100 80GB HBM3"): HBM3, fourth-generation NVLink
    ("h100", dict(flops=67e12, hbm_gbps=3350.0, ici_gbps=900.0)),
)

# Where each entry's measured wall lives in the record: the phase its
# dispatches run under, and where its dispatch count comes from ("phase":
# the phase's own call count; "counter:<name>": an always-on counter;
# None: not recoverable, so no utilisation). The JAX package's names,
# for the port's engines of the same shape: ``split_fn``/``counts_fn``
# /``update_fn`` the levelwise engine's steps (one split span a level),
# ``fused_fn`` one fused build, ``forest_fn`` one batched forest build,
# ``leafwise_fn`` one fused best-first build (the CUDA-graph leaf loop),
# ``expand_fn`` one host-stepped expansion, ``fused_rounds_fn`` one
# K-round dispatch (its leaf loop's graph replays included),
# ``serving_traverse`` one served batch.
ENTRY_JOIN: dict = {
    "split_fn": ("split", "phase"),
    "counts_fn": ("counts", "phase"),
    "update_fn": ("update", None),
    "fused_fn": ("fused_build", "phase"),
    "forest_fn": ("forest_build", "phase"),
    "leafwise_fn": ("leafwise_build", "phase"),
    "expand_fn": (None, "counter:expansion_dispatches"),
    "fused_rounds_fn": ("fused_rounds", "counter:fused_round_dispatches"),
    "serving_traverse": (None, None),
}

# Host-tier work (the numpy/C++ builders and the refine tail): counted,
# never priced.
HOST_ENTRIES: dict = {
    "host_build": ("host_build", "counter:host_builds"),
    "refine_tail": ("refine", "counter:refine_candidates"),
}

SWEEP_NOTE = ("histogram launches priced on bytes and flops; the float64 "
              "split sweep on its histogram reads alone (no float32 peak "
              "applies to float64 work)")


# ---------------------------------------------------------------------------
# the port's analytic counts
# ---------------------------------------------------------------------------

def hist_launch_cost(*, n_rows: int, rows_in: float, n_features: int,
                     n_channels: int, n_bins: int, n_slots: int,
                     cell: int, packed_width: int,
                     sorted_route: bool) -> dict:
    """One histogram launch: ``n_rows`` slot ids read, ``rows_in`` rows
    in range (their byte-wide bins and float32 payload), the sorted
    route's order and segment offsets, and the (S, F, C, B) output
    written once; one add per (row in range, feature)."""
    out = int(n_slots) * n_features * n_channels * n_bins * int(cell)
    b = n_rows * 4 + rows_in * (packed_width + n_channels * 4) + out
    if sorted_route:
        b += rows_in * 4 + (int(n_slots) + 1) * 4
    return {"flops": float(rows_in * n_features), "bytes": float(b)}


def levels_cost(levels: list, *, n_rows: int, n_features: int,
                n_channels: int, n_bins: int, cell: int,
                packed_width: int, tiers: tuple, n_slots: int,
                stream_max_slots: int) -> dict:
    """A level-by-level build's histogram launches and split sweeps from
    its level rows (live or replayed): per non-terminal level its width
    (the narrowest tier that holds the frontier, else ``n_slots``
    chunks), the slots each chunk accumulates (half under subtraction,
    read off the row's ``hist_bytes``) and the rows it scanned
    (``rows_scanned``, every row when the row has none). Terminal levels
    launch no histogram."""
    flops = nbytes = 0.0
    slab = n_features * n_channels * n_bins * int(cell)
    for row in levels:
        if not row.get("hist_bytes"):
            continue
        f = int(row["frontier"])
        S = next((s for s in tiers if f <= s), n_slots)
        chunks = -(-f // S)
        acc = max(int(row["hist_bytes"]) // max(chunks * slab, 1), 1)
        rows_in = row.get("rows_scanned")
        rows_in = float(n_rows if rows_in is None else rows_in)
        for c in range(chunks):
            part = hist_launch_cost(
                n_rows=n_rows, rows_in=rows_in / chunks,
                n_features=n_features, n_channels=n_channels,
                n_bins=n_bins, n_slots=acc, cell=cell,
                packed_width=packed_width,
                sorted_route=acc > stream_max_slots)
            flops += part["flops"]
            nbytes += part["bytes"] + S * slab  # the sweep's read
    return {"flops": flops, "bytes": nbytes}


def leafwise_cost(*, expansions: int, rows_scanned: float, n_rows: int,
                  n_features: int, n_channels: int, n_bins: int,
                  cell: int, packed_width: int, subtraction: bool) -> dict:
    """A best-first build: the root's one-slot histogram, then one
    sibling-pair histogram per expansion (one slot of the smaller child
    under subtraction, else both), each swept once; ``rows_scanned`` is
    the rows all of them accumulate (the replay's counter)."""
    slab = n_features * n_channels * n_bins * int(cell)
    acc = 1 if subtraction else 2
    launches = 1 + int(expansions)
    flops = float(rows_scanned) * n_features
    nbytes = (launches * n_rows * 4
              + float(rows_scanned) * (packed_width + n_channels * 4)
              + (slab + int(expansions) * acc * slab)
              + (slab + int(expansions) * 2 * slab))  # the sweeps' reads
    return {"flops": flops, "bytes": float(nbytes)}


def traverse_cost(*, n_rows: int, n_trees: int, n_steps: int,
                  n_features: int, n_out: int, value_bytes: int) -> dict:
    """One served batch through the traversal kernel: the query rows
    read, at most ``n_steps`` 16-byte node records per (row, tree)
    descent and one leaf value each, and the output written; one compare
    per step."""
    visits = int(n_rows) * int(n_trees)
    nbytes = (n_rows * n_features * 4 + visits * (int(n_steps) * 16
                                                  + int(value_bytes))
              + n_rows * max(int(n_out), 1) * 8)
    return {"flops": float(visits * int(n_steps)), "bytes": float(nbytes)}


def margin_cost(*, n_rows: int, n_trees: int, n_steps: int,
                n_features: int, n_out: int, value_bytes: int,
                acc_bytes: int, pack_bytes: int, row_groups: int,
                staged: bool) -> dict:
    """One served batch through the boosted-margin body
    (``serving/serve_kernel.plan_margin``): every output column's blocks
    read all the query rows (``n_out`` reads of the batch); a staging
    block reads its column's share of the margin pack's records and
    values (``pack_bytes`` in all, once per row group), else each (row,
    tree) descent reads at most ``n_steps`` + 1 8-byte records and one
    leaf value; the output is written once. One compare per step."""
    visits = int(n_rows) * int(n_trees)
    table = (int(row_groups) * int(pack_bytes) if staged
             else visits * ((int(n_steps) + 1) * 8 + int(value_bytes)))
    nbytes = (int(n_rows) * int(n_features) * 4 * max(int(n_out), 1)
              + table + int(n_rows) * max(int(n_out), 1) * int(acc_bytes))
    return {"flops": float(visits * int(n_steps)), "bytes": float(nbytes)}


# ---------------------------------------------------------------------------
# capture and peaks
# ---------------------------------------------------------------------------

def capture(lower) -> dict | None:
    """The count ``lower()`` returns (``{"flops", "bytes"}``, either
    None when it does not apply, and an optional ``note``), or None when
    it fails."""
    try:
        info = lower()
        if not info:
            return None
        flops, nbytes = info.get("flops"), info.get("bytes")
        if flops is None and nbytes is None:
            return None
        out = {
            "flops": None if flops is None else float(flops),
            "bytes": None if nbytes is None else float(nbytes),
        }
        if info.get("note"):
            out["note"] = str(info["note"])
        return out
    except Exception:  # noqa: BLE001 — telemetry never aborts a dispatch
        return None


def device_kind(device=None) -> str | None:
    """``torch.cuda.get_device_name`` of ``device`` (a CUDA device), or
    None (the CPU, or no CUDA)."""
    try:
        import torch

        dev = torch.device("cuda" if device is None else device)
        if dev.type != "cuda" or not torch.cuda.is_available():
            return None
        return str(torch.cuda.get_device_name(dev))
    except Exception:  # noqa: BLE001 — no card, no kind
        return None


def platform_peaks(kind: str | None = None) -> dict:
    """The :data:`PEAK_TABLE` row of ``kind``, the env knobs over it field
    by field: ``{"flops", "hbm_gbps", "ici_gbps", "device_kind",
    "source"}``, the numbers None where unknown."""
    row = {"flops": None, "hbm_gbps": None, "ici_gbps": None}
    source = "unknown"
    if kind:
        low = kind.lower()
        for sub, peaks in PEAK_TABLE:
            if sub in low:
                row.update(peaks)
                source = "table"
                break
    env_flops = knobs.value(PEAK_FLOPS_ENV)
    env_hbm = knobs.value(PEAK_HBM_ENV)
    if env_flops is not None:
        row["flops"] = float(env_flops)
        source = "env"
    if env_hbm is not None:
        row["hbm_gbps"] = float(env_hbm)
        source = "env"
    row["device_kind"] = kind
    row["source"] = source
    return row


def priceable(peaks: dict) -> bool:
    return bool(peaks.get("flops") or peaks.get("hbm_gbps"))


# ---------------------------------------------------------------------------
# the join (the JAX package's arithmetic)
# ---------------------------------------------------------------------------

def _dispatches(source: str | None, entry_phase, report: dict):
    if source is None:
        return None
    if source == "phase":
        if entry_phase is None:
            return None
        calls = (report.get("phases", {}).get(entry_phase) or {}).get("calls")
        return int(calls) if calls else None
    kind, _, name = source.partition(":")
    if kind == "collective":
        calls = (report.get("collectives", {}).get(name) or {}).get("calls")
        return int(calls) if calls else None
    if kind == "counter":
        n = report.get("counters", {}).get(name)
        return int(n) if n else None
    return None


def _floor_seconds(flops, nbytes, peaks: dict):
    t_c = (flops / peaks["flops"]
           if peaks.get("flops") and flops is not None else None)
    t_h = (nbytes / (peaks["hbm_gbps"] * 1e9)
           if peaks.get("hbm_gbps") and nbytes is not None else None)
    return t_c, t_h


def compute_section(report: dict, captures: dict, peaks: dict) -> dict:
    """``record.compute`` from the captures (``{entry: {"flops", "bytes",
    "variants"[, "note"]}}``) and the record so far: per entry the
    per-dispatch floor ``max(flops / peak, bytes / bandwidth)``, the
    dispatch count, the measured wall and ``util_pct = 100 * floor *
    dispatches / wall``; per level the floor of its histogram bytes; the
    roofline verdict of the whole fit."""
    n_shards = max(int(report.get("wire", {}).get("n_shards") or 1), 1)
    entries: dict = {}
    opt_total = measured_total = flops_pd_total = bytes_pd_total = 0.0
    joined = False
    for entry, cap in sorted(captures.items()):
        phase, count_src = ENTRY_JOIN.get(entry, (None, None))
        flops_pd = None if cap["flops"] is None else cap["flops"] / n_shards
        bytes_pd = None if cap["bytes"] is None else cap["bytes"] / n_shards
        t_c, t_h = _floor_seconds(flops_pd, bytes_pd, peaks)
        floors = [t for t in (t_c, t_h) if t is not None]
        optimal = max(floors) if floors else None
        dispatches = _dispatches(count_src, phase, report)
        measured = ((report.get("phases", {}).get(phase) or {}).get("seconds")
                    if phase is not None else None)
        util = None
        if optimal is not None and dispatches and measured:
            total_floor = optimal * dispatches
            util = round(100.0 * total_floor / measured, 2)
            opt_total += total_floor
            measured_total += measured
            flops_pd_total += (flops_pd or 0.0) * dispatches
            bytes_pd_total += (bytes_pd or 0.0) * dispatches
            joined = True
        bound = None
        if t_c is not None and t_h is not None:
            bound = "compute" if t_c >= t_h else "hbm"
        row = {
            "flops": cap["flops"],
            "bytes": cap["bytes"],
            "flops_per_shard": flops_pd,
            "bytes_per_shard": bytes_pd,
            "variants": cap.get("variants", 1),
            "optimal_s": optimal,
            "dispatches": dispatches,
            "measured_s": measured,
            "util_pct": util,
            "bound": bound,
        }
        if cap.get("note"):
            row["note"] = cap["note"]
        entries[entry] = row
    axes = report.get("mesh", {}).get("axes") or {}
    dr = max(int(axes.get("data", n_shards) or 1), 1)
    levels = []
    for row in report.get("levels", []):
        hist_b = row.get("hist_bytes") or 0
        psum_b = row.get("psum_bytes") or 0
        t_h = (hist_b / (peaks["hbm_gbps"] * 1e9)
               if peaks.get("hbm_gbps") else None)
        t_i = (psum_b * (dr - 1) / dr / (peaks["ici_gbps"] * 1e9)
               if peaks.get("ici_gbps") and dr > 1 else None)
        floors = [t for t in (t_h, t_i) if t is not None]
        floor = max(floors) if floors else None
        sec = row.get("seconds")
        levels.append({
            "level": row.get("level"),
            "floor_s": floor,
            "seconds": sec,
            "util_pct": (round(100.0 * floor / sec, 2)
                         if floor is not None and sec else None),
        })
    wire_shard = report.get("wire", {}).get("wire_bytes_per_shard") or 0
    t_compute = (flops_pd_total / peaks["flops"]
                 if peaks.get("flops") and joined else None)
    t_hbm = (bytes_pd_total / (peaks["hbm_gbps"] * 1e9)
             if peaks.get("hbm_gbps") and joined else None)
    t_ici = (wire_shard / (peaks["ici_gbps"] * 1e9)
             if peaks.get("ici_gbps") and joined else None)
    roofline = None
    priced = [(n, t) for n, t in (("compute", t_compute), ("hbm", t_hbm),
                                  ("ici", t_ici)) if t is not None]
    if priced:
        roofline = max(priced, key=lambda nt: nt[1])[0]
    return {
        "peak": dict(peaks),
        "n_shards": n_shards,
        "entries": entries,
        "levels": levels,
        "optimal_s": round(opt_total, 6) if joined else None,
        "measured_s": round(measured_total, 6) if joined else None,
        "util_pct": (round(100.0 * opt_total / measured_total, 2)
                     if joined and measured_total else None),
        "roofline": roofline,
        "bounds_s": {"compute": t_compute, "hbm": t_hbm, "ici": t_ici},
    }


def host_entries(report: dict) -> dict:
    """Counted, unpriced rows for the host tier's dispatches."""
    rows: dict = {}
    for entry, (phase, count_src) in sorted(HOST_ENTRIES.items()):
        dispatches = _dispatches(count_src, phase, report)
        if not dispatches:
            continue
        measured = ((report.get("phases", {}).get(phase) or {}).get("seconds")
                    if phase is not None else None)
        rows[entry] = {
            "flops": None, "bytes": None,
            "flops_per_shard": None, "bytes_per_shard": None,
            "variants": 0, "optimal_s": None,
            "dispatches": dispatches, "measured_s": measured,
            "util_pct": None, "bound": None,
            "unpriced": "host-tier numpy/C++ dispatch: no device count",
        }
    return rows


def host_only_section(rows: dict) -> dict:
    """``record.compute`` of a fit with no priced entry."""
    return {
        "peak": {},
        "n_shards": 1,
        "entries": rows,
        "levels": [],
        "optimal_s": None,
        "measured_s": None,
        "util_pct": None,
        "roofline": None,
        "bounds_s": {"compute": None, "hbm": None, "ici": None},
    }

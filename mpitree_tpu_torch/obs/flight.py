"""obs.flight — the persistent run registry (flight recorder).

Counterpart of ``mpitree_tpu/obs/flight.py``: the same envelope, lineage
keys, config digests, torn-tail heal and per-lineage rotation, so one
store is read alike by both packages. Every fit/serve record the
observer finalizes can append one JSONL line to a durable run store,
stamped with the lineage keys that make records *comparable later*:
git sha, platform, mesh axes, and a config digest (a stable hash of the
workload statics). The store is the machine-readable trajectory
``obs.diff``, ``python -m mpitree_tpu_torch.obs.benchdiff`` and the
advisor (``obs/advisor.py``) query.

Store layout: one append-only ``flight.jsonl`` under
``MPITREE_TPU_RUN_DIR`` (the ambient gate — estimators append their
``fit_report_`` automatically whenever it is set; nothing is written
otherwise). Each line is an **envelope**::

    {"schema": 1, "ts": ..., "iso": ..., "kind": "fit"|"serve"|"bench",
     "section": ..., "git": ..., "platform": ..., "mesh_axes": ...,
     "config_digest": ..., "digest": {...}, "metrics": {...},
     "record": {...}}

``digest`` is the compact scalar summary (``obs.record.digest`` for
fits; a section's scalar payload for bench lines) — what verdicts
compare; ``record`` the full BuildRecord dict — what fingerprint
bisection reads. ``platform`` is the record's ``mesh.platform``:
``"cuda"`` for a fit on the card, ``"cpu"`` for one on the CPU. The
**lineage** of an envelope is every stored entry sharing its
``(kind, section, config_digest, platform)`` — the history dispersion
``obs.diff`` seeds noise thresholds from.

Contracts:

- **stdlib only**; every environment read goes through
  ``config.knobs``.
- **telemetry never aborts** — an unwritable store degrades to a warning
  and a ``None`` return; a torn line (SIGKILL mid-append) is skipped on
  read, never poisons the history.
- **bounded under an ambient RUN_DIR** — ``MPITREE_TPU_RUN_MAX_BYTES``
  size-caps the store via a per-lineage tail trim (see the retention
  knobs below): every lineage keeps its newest entries, so ``obs.diff``
  baselines survive rotation (histories shorter than ``MIN_HISTORY``
  degrade to the documented threshold floors, never a crash). The
  append path pays one ``os.stat``.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import time
import warnings
from mpitree_tpu_torch.config import knobs

FLIGHT_SCHEMA = 1
RUN_DIR_ENV = "MPITREE_TPU_RUN_DIR"
STORE_NAME = "flight.jsonl"

# Long-run hygiene: under an ambient RUN_DIR the store grows
# one envelope per fit forever. When the file exceeds
# MPITREE_TPU_RUN_MAX_BYTES (0/unset = unbounded), append rotates it
# through a per-lineage tail trim: keep the newest KEEP_PER_LINEAGE
# entries of every (kind, section, config_digest, platform) lineage —
# enough history for obs.diff's noise model (MIN_HISTORY = 3; fewer
# degrades to the documented floors, never a crash) — dropping only the
# old interior of each trajectory. The append path stays cheap: one
# os.stat per append; the full parse happens only on an actual rotate.
RUN_MAX_BYTES_ENV = "MPITREE_TPU_RUN_MAX_BYTES"
RUN_KEEP_ENV = "MPITREE_TPU_RUN_KEEP"
KEEP_PER_LINEAGE = 16

# (kind, section, config_digest, platform): the identity under which two
# entries are comparable — one lineage, one noise model.
LINEAGE_KEYS = ("kind", "section", "config_digest", "platform")

_GIT_SHA: str | None = None
_GIT_PROBED = False


def _env_int(name: str, default: int) -> int:
    raw = knobs.raw(name)
    if not raw:
        return default
    try:
        return int(raw)
    except ValueError:
        warnings.warn(
            f"ignoring malformed {name}={raw!r} (expected an integer)",
            stacklevel=3,
        )
        return default


def enabled() -> bool:
    """Whether the ambient store is configured (``MPITREE_TPU_RUN_DIR``)."""
    return bool(knobs.raw(RUN_DIR_ENV))


def git_sha(cwd: str | None = None) -> str | None:
    """Short HEAD sha, probed once per process (None outside a repo)."""
    global _GIT_SHA, _GIT_PROBED
    if _GIT_PROBED:
        return _GIT_SHA
    _GIT_PROBED = True
    try:
        r = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True, timeout=10,
            cwd=cwd or os.path.dirname(os.path.abspath(__file__)),
        )
        if r.returncode == 0 and r.stdout.strip():
            _GIT_SHA = r.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        _GIT_SHA = None
    return _GIT_SHA


def config_digest(config) -> str:
    """Stable 12-hex digest of a JSON-able config mapping (sorted keys,
    so dict ordering can never split a lineage)."""
    blob = json.dumps(config, sort_keys=True, default=str)
    return hashlib.blake2b(blob.encode(), digest_size=6).hexdigest()


def config_digest_from_record(record: dict, kind: str = "fit") -> str:
    """Lineage config key derived from a BuildRecord dict: the workload
    statics that make two runs "the same run repeated". Deliberately
    excludes anything data- or wall-clock-dependent (events, phases,
    results), so reruns of one config land in one lineage.

    Fits key on mesh axes + the resolved engine and its resolution
    inputs (rows/features/bins/chunk/depth/task) + the memory plan's
    pricing inputs. SERVE records key on the serving config only
    (compile kind, kernel tier, buckets, dtype) and deliberately EXCLUDE
    model-structure statics (tree/node counts): a retrained model must
    stay in one serving lineage — detecting "the model changed" is the
    fingerprint's job, and splitting the lineage on it would leave every
    fresh model with no baseline to diff against."""
    mem = record.get("memory") or {}
    dec = record.get("decisions") or {}
    if kind == "serve":
        inp = mem.get("inputs") or {}
        return config_digest({
            "kind": (dec.get("serving_compile") or {}).get("value"),
            "kernel": (dec.get("serving_kernel") or {}).get("value"),
            "buckets": inp.get("buckets"),
            "x64": inp.get("x64"),
            "n_out": inp.get("n_out"),
        })
    eng = record.get("engine") or {}
    return config_digest({
        "mesh_axes": (record.get("mesh") or {}).get("axes"),
        "engine": eng.get("value"),
        "inputs": eng.get("inputs"),
        "plan_inputs": mem.get("inputs"),
        "rounds_per_dispatch": (
            dec.get("rounds_per_dispatch") or {}
        ).get("value"),
    })


# Rotation progress guard, keyed by store path: once a trim fails to get
# a store under the cap (too many lineages x keep entries for the
# configured size), stand down instead of re-parsing the whole file on
# EVERY append forever — the one-os.stat contract. Module-level (not
# per handle) because the ambient path (``append_record``) constructs a
# FRESH FlightStore per append; per-instance state would re-trim and
# re-warn on every fit.
_ROTATION_STUCK: set = set()


class FlightStore:
    """Append/query handle over one run directory's ``flight.jsonl``."""

    def __init__(self, root: str | None = None):
        root = root or knobs.raw(RUN_DIR_ENV)
        if not root:
            raise ValueError(
                f"no flight run dir: pass root= or set {RUN_DIR_ENV}"
            )
        self.root = str(root)
        self.path = os.path.join(self.root, STORE_NAME)

    # -- append ------------------------------------------------------------
    def append(self, *, kind: str = "fit", record: dict | None = None,
               digest: dict | None = None, metrics: dict | None = None,
               section: str | None = None, config=None,
               platform: str | None = None,
               git: str | None = None) -> dict | None:
        """Append one envelope; returns it, or None when the sink is
        unwritable (warned, never raised — the telemetry contract).

        ``config``: an explicit config mapping (hashed), or None to
        derive the lineage key from ``record``. ``platform`` defaults to
        the record's mesh platform.
        """
        mesh = (record or {}).get("mesh") or {}
        if config is not None:
            cdig = config_digest(config)
        elif record is not None:
            cdig = config_digest_from_record(record, kind=str(kind))
        else:
            cdig = config_digest({"section": section})
        env = {
            "schema": FLIGHT_SCHEMA,
            "ts": time.time(),
            "iso": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
            "kind": str(kind),
            "section": section,
            "git": git if git is not None else git_sha(),
            "platform": platform or mesh.get("platform"),
            "mesh_axes": mesh.get("axes"),
            "config_digest": cdig,
            "digest": digest or {},
            "metrics": metrics or {},
            "record": record,
        }
        try:
            os.makedirs(self.root, exist_ok=True)
            with open(self.path, "a+b") as f:
                # Heal a torn tail first: a SIGKILL mid-append leaves a
                # partial line with no newline, and appending straight
                # onto it would corrupt THIS entry too — one lost line
                # must stay one lost line.
                f.seek(0, os.SEEK_END)
                if f.tell():
                    f.seek(-1, os.SEEK_END)
                    if f.read(1) != b"\n":
                        f.write(b"\n")
                f.write(
                    (json.dumps(env, sort_keys=True) + "\n").encode()
                )
        except OSError as e:
            warnings.warn(
                f"flight store unwritable ({e}); run not recorded at "
                f"{self.path}",
                stacklevel=2,
            )
            return None
        self._maybe_rotate()
        return env

    # -- retention ----------------------------------------------------------
    def _maybe_rotate(self) -> None:
        """One os.stat; rotate only past the size cap (see module knobs).
        Telemetry contract holds: any failure degrades to a warning."""
        cap = _env_int(RUN_MAX_BYTES_ENV, 0)
        key = os.path.abspath(self.path)
        if cap <= 0 or key in _ROTATION_STUCK:
            return
        try:
            if os.stat(self.path).st_size <= cap:
                return
        except OSError:
            return
        try:
            self.trim(keep=_env_int(RUN_KEEP_ENV, KEEP_PER_LINEAGE))
            if os.stat(self.path).st_size > cap:
                # The tail trim alone cannot satisfy this cap (many
                # lineages x keep entries exceed it). Warn once and stop
                # rotating this store for the process — re-trimming on
                # every append would turn each telemetry write into a
                # full-file rewrite that drops nothing.
                _ROTATION_STUCK.add(key)
                warnings.warn(
                    f"flight store still {os.stat(self.path).st_size} "
                    f"bytes after a per-lineage tail trim (cap {cap}); "
                    f"raise {RUN_MAX_BYTES_ENV} or lower {RUN_KEEP_ENV} "
                    "— rotation stands down for this process",
                    stacklevel=3,
                )
        except OSError as e:
            warnings.warn(
                f"flight store rotation failed ({e}); {self.path} keeps "
                "growing",
                stacklevel=3,
            )

    def trim(self, keep: int = KEEP_PER_LINEAGE) -> int:
        """Per-lineage tail trim: rewrite the store keeping the newest
        ``keep`` entries of every lineage (file order = append order);
        returns the number of entries dropped.

        Torn/unparseable lines are dropped with the trim (they are
        already invisible to every reader), and the rewrite is
        write-temp + ``os.replace`` so a crash leaves either the old or
        the new store — never a torn one. Appends from a concurrent
        process during the rewrite window can be lost; the store is
        telemetry, and one lost envelope beats an unbounded file.
        """
        keep = max(int(keep), 1)
        entries = self.entries()
        per: dict = {}
        for env in entries:
            key = tuple(env.get(k) for k in LINEAGE_KEYS)
            per.setdefault(key, []).append(env)
        kept = {
            id(env) for rows in per.values() for env in rows[-keep:]
        }
        out = [env for env in entries if id(env) in kept]
        dropped = len(entries) - len(out)
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            for env in out:
                f.write(json.dumps(env, sort_keys=True) + "\n")
        os.replace(tmp, self.path)
        # An explicit trim re-arms a stood-down rotation (the caller may
        # have raised the keep/cap knobs); _maybe_rotate re-stands-down
        # if the cap is still unsatisfiable.
        _ROTATION_STUCK.discard(os.path.abspath(self.path))
        return dropped

    # -- query -------------------------------------------------------------
    def entries(self, *, kind: str | None = None,
                section: str | None = None,
                config_digest: str | None = None,
                platform: str | None = None,
                limit: int | None = None) -> list:
        """Stored envelopes oldest→newest matching every given filter.
        Torn/foreign lines are skipped (the tolerant-parse contract)."""
        out = []
        try:
            f = open(self.path)
        except OSError:
            return out
        with f:
            for ln in f:
                if not ln.strip():
                    continue
                try:
                    env = json.loads(ln)
                except json.JSONDecodeError:
                    continue
                if not isinstance(env, dict):
                    continue
                if kind is not None and env.get("kind") != kind:
                    continue
                if section is not None and env.get("section") != section:
                    continue
                if (config_digest is not None
                        and env.get("config_digest") != config_digest):
                    continue
                if platform is not None and env.get("platform") != platform:
                    continue
                out.append(env)
        return out[-limit:] if limit else out

    def lineage(self, envelope: dict, *, limit: int | None = None) -> list:
        """Every stored entry comparable to ``envelope`` (same kind /
        section / config digest / platform), oldest→newest."""
        return self.entries(
            kind=envelope.get("kind"), section=envelope.get("section"),
            config_digest=envelope.get("config_digest"),
            platform=envelope.get("platform"), limit=limit,
        )

    def sibling_lineage(self, envelope: dict, *,
                        platform: str,
                        limit: int | None = None) -> list:
        """The envelope's lineage AS RUN ON ``platform`` — same kind /
        section / config digest, different backend. The cross-platform
        comparison base (``benchdiff --cross-platform``): only
        *structural* channels (psum/wire bytes, node counts,
        fingerprints) are comparable across it; wall-clock never is."""
        return self.entries(
            kind=envelope.get("kind"), section=envelope.get("section"),
            config_digest=envelope.get("config_digest"),
            platform=platform, limit=limit,
        )

    def latest(self, **filters) -> dict | None:
        rows = self.entries(**filters, limit=1)
        return rows[-1] if rows else None

    def baseline_for(self, envelope: dict) -> dict | None:
        """The newest lineage entry strictly older than ``envelope`` —
        what a fresh capture diffs against."""
        ts = envelope.get("ts")
        prior = [
            e for e in self.lineage(envelope)
            if ts is None or (e.get("ts") or 0) < ts
        ]
        return prior[-1] if prior else None


def append_record(record: dict, *, kind: str = "fit",
                  digest: dict | None = None,
                  section: str | None = None,
                  metrics: dict | None = None) -> dict | None:
    """Ambient-store append — what ``BuildObserver.report`` calls when
    ``MPITREE_TPU_RUN_DIR`` is set. No-op (None) when it isn't."""
    if not enabled():
        return None
    try:
        store = FlightStore()
    except ValueError:
        return None
    return store.append(
        kind=kind, record=record, digest=digest, section=section,
        metrics=metrics,
    )

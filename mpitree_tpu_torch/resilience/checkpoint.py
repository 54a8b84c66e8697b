"""BuildCheckpoint: sharded, fingerprint-guarded build persistence.

Counterpart of ``mpitree_tpu/resilience/checkpoint.py``, with its on-disk
layout and ``_FORMAT``, so either package reads the other's files: when
the process itself dies (a preemption, a kill, a card that outlives every
retry), the on-disk state is what resumes. Two estimator families use
it:

- **Forests** (:class:`ForestCheckpoint`): each completed tree group
  persists as it lands; a re-run with the same params and data resumes
  after the last finished group. Every per-tree draw happens up front
  either way, so a resumed forest equals an uninterrupted one.
- **Boosting** (:class:`BoostCheckpoint`): completed rounds persist in
  round groups together with the resume state (the float64 margins, the
  score history, the early-stopping counters). The subsample masks are
  keyed by (seed, round, row), so a resumed ensemble equals an
  uninterrupted one, margins bit for bit.

Layout (version 2):

- ``path`` holds a small JSON manifest: format, version, kind,
  fingerprint, item count, the shard list and the current state file;
- each append writes one new shard ``<path>.shard-NNNN.npz`` holding that
  group's trees (``tree{i}_<field>`` arrays and a JSON ``header``), then
  the state file (if any), then the manifest. Every write is write-temp +
  ``os.replace``, and the manifest goes last: a crash at any point leaves
  the previous manifest pointing at whole files.

A fingerprint of the params, data, targets and weights guards resume: a
checkpoint of other inputs (or a damaged file set) restarts from scratch
with a warning. The estimators leave ``checkpoint`` and ``device`` out of
the fingerprinted params: the card and the CPU grow the same trees, so a
fit checkpointed on the card may resume on the CPU. No pickle: arrays
via ``np.load(allow_pickle=False)``, headers JSON.
"""

from __future__ import annotations

import dataclasses
import glob
import hashlib
import json
import os
import warnings

import numpy as np

from mpitree_tpu_torch.core.tree_struct import TreeArrays
from mpitree_tpu_torch.resilience.retry import count

_CKPT_VERSION = 2
_FORMAT = "mpitree_tpu-checkpoint"
_TREE_FIELDS = [f.name for f in dataclasses.fields(TreeArrays)]


def _tree_arrays(prefix: str, tree: TreeArrays) -> dict:
    return {f"{prefix}{name}": getattr(tree, name) for name in _TREE_FIELDS}


def _read_tree(z, prefix: str) -> TreeArrays:
    return TreeArrays(**{
        name: z[f"{prefix}{name}"]
        for name in _TREE_FIELDS
        if f"{prefix}{name}" in z.files
    })

def _fingerprint(params: dict, X: np.ndarray, y: np.ndarray,
                 sample_weight) -> str:
    """Stable digest of everything that determines the fitted model.

    Hashes the constructor params (JSON), the data's shape/dtype and
    content, targets, and weights — resuming onto different inputs would
    silently mix two models, so a mismatch restarts from scratch instead.
    """
    h = hashlib.sha256()
    h.update(json.dumps(params, sort_keys=True, default=str).encode())
    for a in (X, y):
        a = np.ascontiguousarray(a)
        h.update(str((a.shape, str(a.dtype))).encode())
        h.update(a.tobytes())
    if sample_weight is not None:
        h.update(np.ascontiguousarray(sample_weight).tobytes())
    return h.hexdigest()


def _atomic_bytes(path: str, data: bytes) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


def _atomic_npz(path: str, payload: dict) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **payload)
    os.replace(tmp, path)


class BuildCheckpoint:
    """Incremental sharded persistence for an estimator build (see module
    docstring). ``kind`` distinguishes forest vs boosting manifests so a
    path can never resume across estimator families."""

    kind = "build"

    def __init__(self, path: str, fingerprint: str):
        self.path = os.fspath(path)
        self.fingerprint = fingerprint
        self.trees: list = []
        # Resume state (boosting): {name: ndarray} or None. Written on
        # every append that passes one; the manifest points at the file.
        self.state: dict | None = None
        self._shards: list = []  # [{"file": basename, "n": int}]
        self._state_file: str | None = None

    # -- paths -------------------------------------------------------------
    def _sibling(self, name: str) -> str:
        return os.path.join(os.path.dirname(self.path) or ".", name)

    def _shard_name(self, idx: int) -> str:
        return f"{os.path.basename(self.path)}.shard-{idx:04d}.npz"

    def _state_name(self) -> str:
        return f"{os.path.basename(self.path)}.state-{len(self.trees):06d}.npz"

    # -- open/resume -------------------------------------------------------
    @classmethod
    def open(cls, path, params: dict, X, y, sample_weight) -> "BuildCheckpoint":
        """Load a resumable checkpoint, or a fresh one on any mismatch."""
        fp = _fingerprint(params, X, y, sample_weight)
        ck = cls(path, fp)
        parent = os.path.dirname(ck.path)
        if parent:
            # Fail here (before any training work) or not at all: the
            # first flush happens AFTER completed groups, and an
            # unwritable path discovered there would abort the very fit
            # checkpointing exists to protect.
            os.makedirs(parent, exist_ok=True)
        if not os.path.exists(ck.path):
            return ck
        try:
            ck._load()
        except Exception as e:  # noqa: BLE001 — a bad checkpoint restarts
            warnings.warn(
                f"{cls.kind} checkpoint at {ck.path} not resumable "
                f"({type(e).__name__}: {e}); starting fresh",
                stacklevel=3,
            )
            ck.trees = []
            ck.state = None
            ck._shards = []
            ck._state_file = None
        return ck

    def _load(self) -> None:
        with open(self.path, "rb") as f:
            manifest = json.loads(f.read().decode())
        if (manifest.get("format") != _FORMAT
                or manifest.get("version") != _CKPT_VERSION):
            raise ValueError("unknown checkpoint format/version")
        if manifest.get("kind") != self.kind:
            raise ValueError(
                f"checkpoint kind {manifest.get('kind')!r} != {self.kind!r}"
            )
        if manifest.get("fingerprint") != self.fingerprint:
            raise ValueError("fingerprint mismatch")
        trees: list = []
        for sh in manifest.get("shards", ()):
            with np.load(self._sibling(sh["file"]), allow_pickle=False) as z:
                head = json.loads(str(z["header"]))
                if head["n"] != sh["n"]:
                    raise ValueError(f"shard {sh['file']} count mismatch")
                trees.extend(
                    _read_tree(z, f"tree{i}_") for i in range(int(sh["n"]))
                )
        if len(trees) != int(manifest["n_items"]):
            raise ValueError("manifest/shard item-count mismatch")
        state = None
        sf = manifest.get("state_file")
        if sf:
            with np.load(self._sibling(sf), allow_pickle=False) as z:
                head = json.loads(str(z["header"]))
                if int(head["n_items"]) != len(trees):
                    raise ValueError("state/manifest item-count mismatch")
                state = {
                    k[2:]: z[k] for k in z.files if k.startswith("s_")
                }
        self.trees = trees
        self.state = state
        self._shards = list(manifest.get("shards", ()))
        self._state_file = sf

    # -- append ------------------------------------------------------------
    def append(self, new_trees: list, state: dict | None = None) -> None:
        """Persist ``new_trees`` (and optional resume ``state``) as
        completed.

        O(group) write cost: one new shard file per call; earlier shards
        are never rewritten. Write order (shard -> state -> manifest, each
        atomic-by-rename) makes a crash at ANY point recoverable to the
        previous consistent manifest.
        """
        shard = self._shard_name(len(self._shards))
        payload: dict = {"header": json.dumps({"n": len(new_trees)})}
        for i, t in enumerate(new_trees):
            payload.update(_tree_arrays(f"tree{i}_", t))
        _atomic_npz(self._sibling(shard), payload)

        self.trees.extend(new_trees)
        self._shards.append({"file": shard, "n": len(new_trees)})

        prev_state_file = self._state_file
        if state is not None:
            sf = self._state_name()
            spay = {"header": json.dumps({"n_items": len(self.trees)})}
            spay.update({f"s_{k}": np.asarray(v) for k, v in state.items()})
            _atomic_npz(self._sibling(sf), spay)
            self.state = state
            self._state_file = sf

        manifest = {
            "format": _FORMAT,
            "version": _CKPT_VERSION,
            "kind": self.kind,
            "fingerprint": self.fingerprint,
            "n_items": len(self.trees),
            "shards": self._shards,
            "state_file": self._state_file,
        }
        _atomic_bytes(self.path, json.dumps(manifest).encode())
        if prev_state_file and prev_state_file != self._state_file:
            # Superseded state is garbage once the manifest moved on; a
            # crash before this unlink leaves a harmless orphan that
            # done() sweeps.
            try:
                os.unlink(self._sibling(prev_state_file))
            except OSError:
                pass

    @property
    def shard_count(self) -> int:
        """Shard files the manifest currently references — what the
        ``checkpoint_compact_every`` wiring compares against."""
        return len(self._shards)

    def maybe_compact(self, every, obs=None) -> bool:
        """The ONE ``checkpoint_compact_every`` trigger both boosting
        flush paths call: compact once the manifest references ``every``
        shard files (None = never), counting through ``obs``."""
        if every is None or self.shard_count < int(every):
            return False
        self.compact()
        count(obs, "checkpoint_compactions")
        return True

    def compact(self, min_shards: int = 2) -> bool:
        """Merge every referenced shard into one (long-run hygiene);
        returns whether a compaction happened.

        Very long forest/boosting builds otherwise accumulate one file
        per flush, and every resume pays one ``np.load`` per shard. The
        manifest stays the commit point: the merged shard is written
        first under a FRESH name (never overwriting a referenced file),
        the manifest flips to it atomically, and only then are the old
        shards unlinked — a crash at ANY point recovers to either the
        pre-compaction state (old manifest, merged file an ignored
        orphan) or the post-compaction state (new manifest, old shards
        harmless orphans ``done()`` sweeps). No-op below ``min_shards``.
        """
        if len(self._shards) < max(int(min_shards), 2):
            return False
        # Tree-count-salted name: unique across compaction generations
        # and disjoint from the plain shard-NNNN series, so it can never
        # collide with a file a (current or previous) manifest references.
        merged = (
            f"{os.path.basename(self.path)}"
            f".shard-merged-{len(self.trees):06d}.npz"
        )
        payload: dict = {"header": json.dumps({"n": len(self.trees)})}
        for i, t in enumerate(self.trees):
            payload.update(_tree_arrays(f"tree{i}_", t))
        _atomic_npz(self._sibling(merged), payload)

        old = self._shards
        self._shards = [{"file": merged, "n": len(self.trees)}]
        manifest = {
            "format": _FORMAT,
            "version": _CKPT_VERSION,
            "kind": self.kind,
            "fingerprint": self.fingerprint,
            "n_items": len(self.trees),
            "shards": self._shards,
            "state_file": self._state_file,
        }
        _atomic_bytes(self.path, json.dumps(manifest).encode())
        for sh in old:
            if sh["file"] == merged:
                continue
            try:
                os.unlink(self._sibling(sh["file"]))
            except OSError:
                pass  # a crash-window orphan; done() sweeps
        return True

    def done(self) -> None:
        """Remove manifest, shards, and state once the full fit succeeded
        (orphans from crashed appends included). ``glob.escape``: a
        checkpoint path with glob metacharacters (``run[1]/gb.ckpt``)
        must still sweep its siblings."""
        esc = glob.escape(self.path)
        for p in (
            [self.path]
            + glob.glob(esc + ".shard-*.npz")
            + glob.glob(esc + ".state-*.npz")
        ):
            try:
                os.unlink(p)
            except OSError:
                pass


class ForestCheckpoint(BuildCheckpoint):
    """Forest-build checkpoint: with ``RandomForestClassifier(
    checkpoint=path)`` the build runs in tree-axis sized groups, each
    persisted as it completes (see BuildCheckpoint for the file scheme
    and guarantees)."""

    kind = "forest"


class BoostCheckpoint(BuildCheckpoint):
    """Boosting checkpoint: completed rounds' trees plus the resume state
    (raw margins, score history, early-stopping counters) — see
    ``boosting/gradient_boosting.py`` for what the state carries."""

    kind = "gbdt"

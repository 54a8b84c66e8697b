"""Feature binning: map raw feature columns to integer bin ids.

Counterpart of ``mpitree_tpu/ops/binning.py``. Per feature ``f``:

- ``thresholds[f, 0:n_cand[f]]`` are strictly increasing split values;
  candidate ``b`` is the split ``x <= thresholds[f, b]``;
- ``bin(x) = searchsorted(thresholds[f], x, side="left")``, so
  ``x <= thresholds[f, b]  <=>  bin(x) <= b`` and the build never touches
  raw values after binning;
- "exact" keeps every unique value but the top one as a candidate
  (reference parity), "quantile" caps candidates at ``max_bins - 1``
  quantile edges, "auto" is exact per feature while the unique count fits
  ``max_bins``.

Two paths give bit-identical ``BinnedData``: the host path
(:func:`bin_dataset`, numpy, a copy of the JAX package's) and
:func:`bin_dataset_torch`, which sorts, gathers and searches on the fit's
device. Edges are *selected data values* (gathers of sorted columns at
the host-computed :func:`_quantile_indices`), never arithmetic on them,
so the two agree by construction.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class BinnedData:
    """Product of preprocessing; consumed by the builder.

    ``x_binned`` is an (N, F) int32 numpy array from the host path or an
    (N, F) int32 tensor on the fit's device from :func:`bin_dataset_torch`;
    ``thresholds`` ((F, n_bins - 1) float32, ``+inf``-padded past
    ``n_cand[f]``), ``n_cand`` ((F,) int32) and ``n_bins`` stay on the
    host. ``quantized`` is True when quantile binning capped some feature.
    """

    x_binned: object
    thresholds: np.ndarray
    n_cand: np.ndarray
    n_bins: int
    quantized: bool = False

    @property
    def n_samples(self) -> int:
        return self.x_binned.shape[0]

    @property
    def n_features(self) -> int:
        return self.x_binned.shape[1]

    def candidate_mask(self) -> np.ndarray:
        """(n_features, n_bins) bool — True where bin ``b`` is a valid candidate."""
        B = self.n_bins
        return np.arange(B)[None, :] < self.n_cand[:, None]


@dataclasses.dataclass(frozen=True)
class StreamedBinnedData(BinnedData):
    """BinnedData whose matrix was assembled chunk by chunk on the fit's
    devices (``ingest/place.assemble_binned``); the raw matrix never
    existed on any host.

    ``x_binned`` is a list of this process's local shards, in the mesh's
    local order: each an ``(shard_rows, shard_cols)`` int32 tensor on its
    shard's device, row block ``di`` of feature block ``fi`` of the
    ``(rows_pad, feat_pad)`` matrix ``parallel/partition.layout`` lays out
    (the counterpart of the JAX package's one global array,
    ``mpitree_tpu/ops/binning.py:86-117``). Padding rows and columns hold
    bin 0 and are inert (``node_id = -1``, no candidate). ``n_rows`` is
    the real row count and ``chunk_rows`` the chunk size the stream used;
    ``n_samples`` and ``n_features`` are the real extents, never the
    buffers'.
    """

    n_rows: int = 0
    chunk_rows: int = 0
    rows_pad: int = 0
    feat_pad: int = 0
    # a forest's regrouped shard blocks and their packed bins, by the
    # width of its data axis (core/fused_builder._grow_sharded): every
    # tree group of a fit, a checkpoint's too, grows from one exchange
    blocks: dict = dataclasses.field(default_factory=dict, repr=False,
                                     compare=False)

    @property
    def n_samples(self) -> int:
        return self.n_rows

    @property
    def n_features(self) -> int:
        return self.thresholds.shape[0]

    def single(self) -> BinnedData:
        """The plain ``BinnedData`` of a one-shard stream (one device: no
        padding), which every one-device consumer takes."""
        if len(self.x_binned) != 1 or self.rows_pad != self.n_rows \
                or self.feat_pad != self.n_features:
            raise ValueError(
                f"a stream of {len(self.x_binned)} shards padded to "
                f"({self.rows_pad}, {self.feat_pad}) is not one device's "
                "matrix; build on the mesh it was placed for")
        return BinnedData(
            x_binned=self.x_binned[0], thresholds=self.thresholds,
            n_cand=self.n_cand, n_bins=self.n_bins, quantized=self.quantized)


def _exact_edges(col: np.ndarray) -> np.ndarray:
    return np.unique(col)[:-1]


def _quantile_indices(n: int, max_bins: int) -> np.ndarray:
    """Sorted-column gather indices for the quantile edges — f64 on host,
    shared by both paths (``mpitree_tpu/ops/binning.py:130``)."""
    qs = np.arange(1, max_bins, dtype=np.float64) / max_bins
    return np.floor((n - 1) * qs).astype(np.int64)


def _quantile_edges_sorted(col_sorted: np.ndarray, max_bins: int) -> np.ndarray:
    return np.unique(col_sorted[_quantile_indices(len(col_sorted), max_bins)])


def pack_edges(per_feature_edges: list, *, quantized: bool = False) -> tuple:
    """Per-feature edge arrays -> ``(thresholds, n_cand, n_bins, quantized)``."""
    n_features = len(per_feature_edges)
    n_cand = np.array([len(e) for e in per_feature_edges], dtype=np.int32)
    n_bins = int(n_cand.max(initial=0)) + 1
    thresholds = np.full(
        (n_features, max(n_bins - 1, 1)), np.inf, dtype=np.float32
    )
    for f, edges in enumerate(per_feature_edges):
        thresholds[f, : len(edges)] = edges
    return thresholds, n_cand, n_bins, quantized


def bin_with_thresholds(
    X: np.ndarray, thresholds: np.ndarray, n_cand: np.ndarray
) -> np.ndarray:
    """Bin a raw (N, F) f32 matrix against an existing threshold table."""
    X = np.ascontiguousarray(X, dtype=np.float32)
    n_samples, n_features = X.shape
    Xt = np.ascontiguousarray(X.T)
    xbt = np.empty((n_features, n_samples), dtype=np.int32)
    for f in range(n_features):
        xbt[f] = np.searchsorted(
            thresholds[f, : n_cand[f]], Xt[f], side="left"
        )
    return np.ascontiguousarray(xbt.T)


def bin_dataset(
    X: np.ndarray, *, max_bins: int = 256, binning: str = "auto"
) -> BinnedData:
    """Bin a (n_samples, n_features) float matrix on the host (numpy)."""
    if binning not in ("auto", "exact", "quantile"):
        raise ValueError(f"unknown binning mode: {binning!r}")
    X = np.ascontiguousarray(X, dtype=np.float32)
    n_samples, n_features = X.shape
    Xt = np.ascontiguousarray(X.T)

    per_feature_edges: list[np.ndarray] = []
    quantized = False
    for f in range(n_features):
        col = Xt[f]
        if binning == "exact":
            edges = _exact_edges(col)
        elif binning == "quantile":
            edges = _quantile_edges_sorted(np.sort(col), max_bins)
            quantized = True
        else:  # auto
            col_sorted = np.sort(col)
            n = len(col_sorted)
            new_val = np.empty(n, bool)
            if n:
                new_val[0] = True
                np.not_equal(col_sorted[1:], col_sorted[:-1], out=new_val[1:])
                # collapse a trailing NaN run to one value, like np.unique
                nan_start = np.searchsorted(col_sorted, np.inf, side="right")
                if nan_start < n - 1:
                    new_val[nan_start + 1:] = False
            if int(new_val.sum()) <= max_bins:
                edges = col_sorted[new_val][:-1]
            else:
                edges = _quantile_edges_sorted(col_sorted, max_bins)
                quantized = True
        per_feature_edges.append(edges.astype(np.float32))

    thresholds, n_cand, n_bins, quantized = pack_edges(
        per_feature_edges, quantized=quantized
    )
    xbt = np.empty((n_features, n_samples), dtype=np.int32)
    for f, edges in enumerate(per_feature_edges):
        xbt[f] = np.searchsorted(edges, Xt[f], side="left")
    return BinnedData(
        x_binned=np.ascontiguousarray(xbt.T), thresholds=thresholds,
        n_cand=n_cand, n_bins=n_bins, quantized=quantized,
    )


def _compact(vals: torch.Tensor, mask: torch.Tensor, keep_n: torch.Tensor,
             Q: int) -> torch.Tensor:
    """First ``Q`` mask-marked values of each ascending row, ``+inf`` at and
    after ``keep_n``: the i-th marked value sits at the first position
    whose running mark count reaches i+1 (a batched binary search instead
    of a scatter compaction)."""
    F, M = vals.shape
    rank = torch.cumsum(mask.to(torch.int64), dim=1)
    want = torch.arange(1, Q + 1, device=vals.device,
                        dtype=torch.int64).expand(F, Q).contiguous()
    tgt = torch.searchsorted(rank, want, side="left").clamp_(max=M - 1)
    got = torch.gather(vals, 1, tgt)
    pos = torch.arange(Q, device=vals.device)[None, :]
    return torch.where(pos < keep_n[:, None], got,
                       torch.full_like(got, float("inf")))


def bin_dataset_torch(
    X: np.ndarray, *, max_bins: int = 256, binning: str = "auto",
    device: torch.device,
) -> BinnedData:
    """:func:`bin_dataset` computed on ``device``; bit-identical output.

    The torch counterpart of ``bin_dataset_device``
    (``mpitree_tpu/ops/binning.py:356``, kernel body ``:273``): per-feature
    sort, uniqueness mask, exact edges compacted by gathers, quantile edges
    gathered at the host-computed :func:`_quantile_indices` and deduped the
    same way, and bin ids by ``searchsorted`` against the ``+inf``-padded
    table. ``x_binned`` stays on ``device`` as an (N, F) int32 tensor;
    thresholds and candidate counts come back to the host. "exact" mode has
    a data-dependent candidate count and is host-only; NaN input and the
    degenerate shapes the JAX device path also routes to the host go to
    :func:`bin_dataset` and are then uploaded. Known non-contract, as in the
    JAX package: a column holding both -0.0 and 0.0 may give a -0.0/+0.0
    threshold difference; every predicate and bin id is unaffected.
    """
    if binning not in ("auto", "quantile"):
        raise ValueError(
            "bin_dataset_torch supports binning='auto'|'quantile' "
            f"(got {binning!r}); exact mode is host-only"
        )
    X = np.ascontiguousarray(X, dtype=np.float32)
    n_samples, n_features = X.shape
    if max_bins < 2 or n_samples < 1 or np.isnan(X).any():
        host = bin_dataset(X, max_bins=max_bins, binning=binning)
        return dataclasses.replace(
            host, x_binned=torch.from_numpy(host.x_binned).to(device)
        )
    Q = max_bins - 1
    Xt = torch.from_numpy(np.ascontiguousarray(X.T)).to(device)
    F = n_features
    srt = torch.sort(Xt, dim=1).values
    new_val = torch.ones_like(srt, dtype=torch.bool)
    new_val[:, 1:] = srt[:, 1:] != srt[:, :-1]
    n_uniq = new_val.sum(dim=1)
    # the top unique value is never a candidate: keep n_uniq - 1
    exact_thr = _compact(srt, new_val, n_uniq - 1, Q)

    qidx = torch.from_numpy(_quantile_indices(n_samples, max_bins)).to(device)
    qcand = srt[:, qidx]
    new_q = torch.ones_like(qcand, dtype=torch.bool)
    new_q[:, 1:] = qcand[:, 1:] != qcand[:, :-1]
    n_q = new_q.sum(dim=1)
    quant_thr = _compact(qcand, new_q, n_q, Q)

    if binning == "quantile":
        use_exact = torch.zeros(F, dtype=torch.bool, device=device)
    else:
        use_exact = n_uniq <= max_bins
    thresholds = torch.where(use_exact[:, None], exact_thr, quant_thr)
    n_cand = torch.where(use_exact, n_uniq - 1, n_q)
    xbt = torch.searchsorted(thresholds.contiguous(), Xt, side="left")
    x_binned = xbt.to(torch.int32).t().contiguous()

    n_cand_h = n_cand.cpu().numpy().astype(np.int32)
    n_bins = int(n_cand_h.max(initial=0)) + 1
    thr_h = thresholds.cpu().numpy().astype(np.float32)
    return BinnedData(
        x_binned=x_binned,
        thresholds=np.ascontiguousarray(thr_h[:, : max(n_bins - 1, 1)]),
        n_cand=n_cand_h, n_bins=n_bins,
        quantized=bool((~use_exact).any().item()),
    )


def bin_for_engine(X: np.ndarray, *, max_bins: int, binning: str,
                   device: torch.device) -> BinnedData:
    """Bin where the build runs: "auto"/"quantile" on ``device``
    (:func:`bin_dataset_torch`), "exact" on the host then uploaded. Either
    way ``x_binned`` comes back as an (N, F) int32 tensor on ``device``."""
    if binning == "exact":
        host = bin_dataset(X, max_bins=max_bins, binning=binning)
        return dataclasses.replace(
            host, x_binned=torch.from_numpy(host.x_binned).to(device)
        )
    return bin_dataset_torch(X, max_bins=max_bins, binning=binning,
                             device=device)

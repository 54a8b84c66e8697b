"""Quantized node tables: compressed serving state.

Counterpart of ``mpitree_tpu/serving/quantize.py``, the one copy of the
compression scheme:

- **thresholds** ride bfloat16, rounded toward -inf
  (:func:`quantize_thresholds`), compared after an exact upcast to
  float32;
- **feature ids** ride int16 (refused past 32767 features);
- **leaf values** ride int8 with a per-channel affine dequantization
  ``v = base + q * scale`` (:func:`affine_int8`), after a per-kind
  preparation (:func:`prepare_channel`: forest count rows are normalized
  first, so the grid spans [0, 1]);
- children and roots stay int32 (the model's one copy of those columns).

Quantization is lossy by contract: :func:`build_state` measures the
largest prediction delta against the float32 tables on a calibration
batch (:func:`exactness_report`, a numpy oracle) and raises
:class:`QuantizationError` past the tolerance, so a model that quantizes
badly fails when it is compiled, not under traffic.

A single regression tree (kind ``gather_value``) is served by
:func:`q_traverse_gather`, plain PyTorch on every device (the JAX
package's is XLA, not Pallas). Every other kind takes one quantized
kernel (K5, ``serve_kernel.traverse_q``) that sums the raw int8 lattice
in int32 over the trees, then one affine and the division by the tree
count in float32 (:func:`q_traverse_accumulate`), as the JAX package's
kernel tier does (``serving/model.py:343-412``). The
bfloat16 rounding uses ``torch.bfloat16`` and its bit pattern, which give
the same bits as the JAX package's ``ml_dtypes`` path.

A boosted model's margins (kind ``margin``) take K5's ``percls`` mode and
differ from the JAX package's float32 tier in two ways, both so that the
report measures what is served:

- the affine runs once per column (``T / K`` trees each) in float64, then
  the float64 baseline: margins sum a hundred or more trees of values
  near 1, where a float32 epilogue and a float32 report would each carry
  a few ulps of their own, more than the report's 1e-6 slack;
- the report accumulates in float64 too, with the quantized side summed
  as the served one is, and over ``n_out = K`` columns round by round:
  the JAX package's report applies a margin channel over all ``T`` trees
  into one column (``mpitree_tpu/serving/quantize.py:340``, ``n_out``
  read from the one-channel rows), which for more than one class mixes
  the classes' trees.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mpitree_tpu_torch.serving import serve_kernel, traversal

# int8 delta grid: 254 steps across the channel span, symmetric around 0
# (the -128 code is unused so dequantization never needs a clamp).
_Q_STEPS = 254.0
_Q_LO = -127

QUANTIZE_MODES = ("int8",)


class QuantizationError(ValueError):
    """Exactness refusal: the quantized tables' largest prediction delta
    on the calibration batch exceeded the tolerance. ``report`` holds the
    full exactness report."""

    def __init__(self, message: str, *, report: dict):
        super().__init__(message)
        self.report = report


def resolve_quantize(mode) -> str | None:
    """``quantize=`` argument -> ``"int8"`` or None; unknown spellings
    raise."""
    if mode in (None, False, "", "off", "0", "none"):
        return None
    if mode in QUANTIZE_MODES or mode is True:
        return "int8"
    raise ValueError(
        f"unknown serving quantize mode {mode!r} (expected one of "
        f"{QUANTIZE_MODES} or an off-value)"
    )


def prepare_channel(kind: str, flat: np.ndarray) -> np.ndarray:
    """Per-kind host float64 transform before quantization:
    ``forest_proba`` rows normalize to probabilities."""
    flat = np.asarray(flat, np.float64).reshape(flat.shape[0], -1)
    if kind == "forest_proba":
        return flat / np.maximum(flat.sum(axis=1, keepdims=True), 1.0)
    return flat


def affine_int8(prepared: np.ndarray):
    """(M, K) prepared float64 channel -> (q int8, scale f32, base f32):
    ``q = round((v - lo)/scale) + _Q_LO``, ``dequant = base + q*scale``
    with ``base = lo - _Q_LO*scale``. Constant channels get scale 0 and
    dequantize exactly to their value."""
    lo = prepared.min(axis=0)
    hi = prepared.max(axis=0)
    span = hi - lo
    scale = np.where(span > 0, span / _Q_STEPS, 1.0)
    q = np.clip(
        np.rint((prepared - lo[None, :]) / scale[None, :]) + _Q_LO,
        -127, 127,
    ).astype(np.int8)
    scale = np.where(span > 0, scale, 0.0).astype(np.float32)
    base = (lo - _Q_LO * scale).astype(np.float32)
    base = np.where(span > 0, base, lo).astype(np.float32)
    return q, scale, base


def dequantize(q: np.ndarray, scale: np.ndarray,
               base: np.ndarray) -> np.ndarray:
    """Host float32 dequantization (what the exactness report reads)."""
    return (base[None, :]
            + q.astype(np.float32) * scale[None, :]).astype(np.float32)


def quantize_thresholds(threshold: np.ndarray) -> torch.Tensor:
    """float32 thresholds -> (M,) bfloat16 tensor (CPU), rounded toward
    -inf; leaf NaNs become 0 (they never route).

    Floor rounding is what makes routing safe: the descent compares ``x <=
    thr``, and a rounded ``t_q`` misroutes exactly the x between the two.
    Rounding down puts that gap at ``(t_q, thr]``, which holds no bfloat16
    value, so every query whose features are bfloat16 values routes as
    with the float32 tables."""
    t = np.nan_to_num(np.asarray(threshold, np.float32), nan=0.0)
    q = torch.from_numpy(np.ascontiguousarray(t)).to(torch.bfloat16)
    qf = q.to(torch.float32).numpy()
    bits = q.view(torch.int16).numpy().view(np.uint16).copy()
    over = qf > t  # rounded up: step down one bfloat16 ulp
    bits[over & (qf > 0)] -= 1
    bits[over & (qf < 0)] += 1
    # rounded to +/-0 from below zero: the smallest-magnitude negative
    bits[over & (qf == 0)] = np.uint16(0x8001)
    return torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)


@dataclasses.dataclass
class QuantizedState:
    """Quantized model state on the model's device (built once)."""

    feature: torch.Tensor    # (M,) int16
    threshold: torch.Tensor  # (M,) bfloat16
    left: torch.Tensor       # (M,) int32 (the table's own device copy)
    right: torch.Tensor      # (M,) int32
    root: torch.Tensor       # (T,) int32
    record: torch.Tensor | None  # (M, 4) int32: serve_kernel.pack_nodes
    qvals: torch.Tensor      # (M, K) int8
    qscale: torch.Tensor     # (K,) float32: the affine's scale
    # (K,) trees per column x the affine's base: float32, float64 for a
    # margin
    qbase: torch.Tensor
    vscale: np.ndarray       # (K,) float32: the affine's scale, on the host
    vbase: np.ndarray        # (K,) float32: the affine's base, on the host
    report: dict             # the exactness report (serve_report_)
    # a margin's serve_kernel.pack_margin on the card where the margin
    # body serves it (its tables), else None
    margin: serve_kernel.MarginPack | None = None

    @property
    def q_host(self) -> np.ndarray:
        """(M, K) int8 lattice in flat-table order: a host copy of
        ``qvals``, made on each call (none is kept)."""
        return self.qvals.cpu().numpy()

    @property
    def rows_host(self) -> np.ndarray:
        """(M, K) float32 dequantized values in flat-table order, made
        from :attr:`q_host` on each call."""
        return dequantize(self.q_host, self.vscale, self.vbase)

    def _per_tree(self, flat: np.ndarray, trees, table) -> dict:
        """Invert the flat table's depth-pack scatter: ``id(tree) ->
        (n_nodes, K)`` rows in the tree's node order."""
        concat = np.empty_like(flat)
        concat[table.scatter_order()] = flat
        offs = np.cumsum([0] + [t.n_nodes for t in trees])
        return {id(t): concat[offs[i]:offs[i + 1]]
                for i, t in enumerate(trees)}

    def rows_per_tree(self, trees, table) -> dict:
        """Dequantized float32 value rows per tree (``id(tree) -> rows``):
        what the int8 tier serves, before the sum over trees."""
        return self._per_tree(self.rows_host, trees, table)

    def q_rows_per_tree(self, trees, table) -> dict:
        """Raw int8 lattice rows per tree: what K5 sums in int32 before
        the affine."""
        return self._per_tree(self.q_host, trees, table)


def build_state(table, prepared: np.ndarray, *, kind: str, scale,
                n_steps: int, tol: float, device: torch.device,
                calibration=None, n_features: int | None = None,
                n_out: int | None = None) -> QuantizedState:
    """Quantize one flat table + prepared channel onto ``device``; raise
    :class:`QuantizationError` when the calibration delta exceeds
    ``tol``. ``n_out`` is a margin's class count K (its trees lie
    round-major, class-minor); other kinds serve one column per
    channel."""
    if n_features is None:
        n_features = int(table.feature.max(initial=0)) + 1
    if n_features > np.iinfo(np.int16).max:
        raise QuantizationError(
            f"int16 feature ids cannot address {n_features} features",
            report={"ok": False, "reason": "n_features"},
        )
    q, vscale, vbase = affine_int8(prepared)
    rep = exactness_report(
        table, prepared, (q, vscale, vbase), kind=kind, scale=scale,
        n_steps=n_steps, tol=tol, calibration=calibration,
        n_features=n_features, n_out=n_out,
    )
    if not rep["ok"]:
        raise QuantizationError(
            f"quantized tables diverge past tolerance: max prediction "
            f"delta {rep['max_abs_delta']:.3e} > {tol:.3e} on "
            f"{rep['rows']} calibration rows",
            report=rep,
        )
    _f, _t, left, right, root, _o = table.dev_arrays(device)
    feature = torch.from_numpy(table.feature.astype(np.int16)).to(device)
    threshold = quantize_thresholds(table.threshold).to(device)
    qvals = torch.from_numpy(np.ascontiguousarray(q)).to(device)
    margin = None
    if kind == "margin" and device.type == "cuda":
        margin = serve_kernel.pack_margin(
            feature, threshold, left, right, root, qvals, n_out=int(n_out),
            form="traverse_q")
        if margin is not None and not margin.serves:
            margin = None
    return QuantizedState(
        feature=feature, threshold=threshold, left=left, right=right,
        root=root,
        # the general body's records, where the margin body does not serve
        record=(serve_kernel.pack_nodes(feature, threshold, left, right)
                if margin is None else None),
        qvals=qvals, margin=margin,
        qscale=torch.from_numpy(vscale).to(device),
        vscale=vscale, vbase=vbase,
        qbase=torch.from_numpy(
            (table.n_trees // int(n_out)) * vbase.astype(np.float64)
            if kind == "margin"
            else (table.n_trees * vbase).astype(np.float32)).to(device),
        report=rep,
    )


def q_traverse_accumulate(X: torch.Tensor, state: QuantizedState, *,
                          kind: str, n_steps: int, n_features: int,
                          scale, baseline: torch.Tensor | None = None
                          ) -> torch.Tensor:
    """The quantized serving tier: K5's int32 lattice sum (``sum`` mode
    for the forest kinds, then ``out * qscale + qbase`` and the division
    by ``scale`` (a number or a 0-d tensor) in float32; for ``margin``,
    ``percls`` into ``len(baseline)`` columns, the affine in float64 and
    the float64 ``baseline``). The affine is linear across the ensemble
    sum, so this serves the int8-affine values the exactness report
    covers."""
    if kind not in traversal.ACC_KINDS:
        raise ValueError(f"unknown quantized accumulate kind {kind!r}")
    margin = kind == "margin"
    out = serve_kernel.traverse_q(
        X, state.feature, state.threshold, state.left, state.right,
        state.root, state.qvals, n_steps=n_steps,
        agg="percls" if margin else "sum",
        n_out=baseline.shape[0] if margin else state.qvals.shape[1],
        n_features=n_features, record=state.record, pack=state.margin,
    )
    if margin:
        return (out.to(torch.float64) * state.qscale.to(torch.float64)
                + state.qbase + baseline)
    deq = out.to(torch.float32) * state.qscale + state.qbase
    return deq / torch.as_tensor(scale, dtype=torch.float32,
                                 device=deq.device)


def q_traverse_gather(X: torch.Tensor, feature, threshold, left, right,
                      root, qvals, vscale, vbase, *, n_steps: int
                      ) -> torch.Tensor:
    """A single tree's float channel, quantized: the descent over the
    compressed columns (int16 ids and bfloat16 thresholds, both upcasts
    exact), the int8 code gathered at each row's leaf and dequantized in
    float32 as ``vbase[0] + g * vscale[0]`` (two roundings: no fused
    multiply-add), (N,) float32 (the JAX package's
    ``mpitree_tpu/serving/quantize.py:439-444``)."""
    node = traversal.descend(X, feature.to(torch.int32),
                             threshold.to(torch.float32), left, right, root,
                             n_steps)[:, 0]
    g = qvals[node, 0].to(torch.float32)
    return vbase[0] + g * vscale[0]


# ---------------------------------------------------------------------------
# host reference (numpy): the exactness oracle
# ---------------------------------------------------------------------------

def _host_descend(X, feature, threshold, left, right, root,
                  n_steps: int) -> np.ndarray:
    """(N, T) absolute leaf ids, the numpy twin of the descent."""
    node = np.broadcast_to(
        root[None, :].astype(np.int64), (len(X), len(root))
    ).copy()
    for _ in range(n_steps):
        f = feature[node]
        thr = threshold[node]
        xf = np.take_along_axis(X, np.maximum(f, 0).astype(np.int64), axis=1)
        nxt = np.where(xf <= thr, left[node], right[node])
        node = np.where(f < 0, node, nxt)
    return node


def _margin_apply(node: np.ndarray, rows: np.ndarray, K: int
                  ) -> np.ndarray:
    """(N, K) float64 sums of a margin channel (float64 values, or the
    int8 codes summed exactly in int64) at leaf ids, round by round;
    baseline-free (the baseline is the same on both sides)."""
    N, T = node.shape
    acc = np.zeros((N, K), rows.dtype if rows.dtype.kind == "i"
                   else np.float64)
    for r in range(T // K):
        acc = acc + rows[node[:, r * K:(r + 1) * K], 0]
    return acc.astype(np.float64)


def _host_apply(kind: str, node: np.ndarray, rows: np.ndarray,
                scale: float, n_out: int) -> np.ndarray:
    """Apply a prepared float32 channel at leaf ids, per serving kind."""
    N, T = node.shape
    if kind == "gather_value":
        return rows[node[:, 0], 0:1]
    acc = np.zeros((N, rows.shape[1]), np.float32)
    for t in range(T):
        acc = acc + rows[node[:, t]]
    if kind == "forest_mean":
        acc = acc[:, 0:1]
    return acc / np.float32(scale)


def synthesize_calibration(table, n_features: int, rows: int = 256,
                           seed: int = 0) -> np.ndarray:
    """A deterministic calibration batch: per-feature uniform draws over
    (and 10% past) that feature's threshold range, snapped to the bfloat16
    lattice, so the default report isolates value quantization error.
    Features the table never splits on get [0, 1]."""
    rng = np.random.default_rng(seed)
    lo = np.zeros(n_features, np.float64)
    hi = np.ones(n_features, np.float64)
    inner = table.feature >= 0
    for f in range(n_features):
        thrs = table.threshold[inner & (table.feature == f)]
        if thrs.size:
            t_lo, t_hi = float(thrs.min()), float(thrs.max())
            pad = 0.1 * max(t_hi - t_lo, 1.0)
            lo[f], hi[f] = t_lo - pad, t_hi + pad
    X = rng.uniform(lo, hi, size=(rows, n_features)).astype(np.float32)
    # to the nearest bfloat16 (ties to even) and back
    return torch.from_numpy(X).to(torch.bfloat16).to(torch.float32).numpy()


def exactness_report(table, prepared: np.ndarray, quant, *, kind: str,
                     scale, n_steps: int, tol: float, calibration=None,
                     n_features: int | None = None,
                     n_out: int | None = None) -> dict:
    """Largest prediction delta of the quantized tables against the
    float32 tables on a calibration batch (numpy on both sides: same
    descent, same value application, so the delta isolates quantization;
    a margin in float64, as it is served)."""
    q, vscale, vbase = quant
    if n_features is None:
        n_features = int(table.feature.max(initial=0)) + 1
    X = (np.ascontiguousarray(np.asarray(calibration, np.float32))
         if calibration is not None
         else synthesize_calibration(table, n_features))
    rows_ref = np.asarray(prepared, np.float32)
    rows_q = dequantize(q, np.asarray(vscale), np.asarray(vbase))
    thr_ref = np.nan_to_num(np.asarray(table.threshold, np.float32), nan=0.0)
    thr_q = quantize_thresholds(table.threshold).to(torch.float32).numpy()
    if n_out is None:
        n_out = rows_ref.shape[1]
    ids_ref = _host_descend(
        X, table.feature, thr_ref, table.left, table.right, table.root,
        n_steps,
    )
    ids_q = _host_descend(
        X, table.feature, thr_q, table.left, table.right, table.root,
        n_steps,
    )
    if kind == "margin":  # float64, the codes summed as K5 sums them
        K = int(n_out)
        ref = _margin_apply(ids_ref, np.asarray(prepared, np.float64), K)
        got = (_margin_apply(ids_q, q.astype(np.int64), K)
               * np.float64(vscale[0])
               + (len(table.root) // K) * np.float64(vbase[0]))
    else:
        ref = _host_apply(kind, ids_ref, rows_ref, float(scale), n_out)
        got = _host_apply(kind, ids_q, rows_q, float(scale), n_out)
    max_abs = float(np.max(np.abs(ref - got))) if len(X) else 0.0
    denom = float(np.max(np.abs(ref))) if len(X) else 0.0
    return {
        "mode": "int8",
        "max_abs_delta": max_abs,
        "max_rel_delta": round(max_abs / denom, 6) if denom > 0 else 0.0,
        "rows": int(len(X)),
        "rerouted_rows": int((ids_ref != ids_q).any(axis=1).sum()),
        "tolerance": float(tol),
        "ok": bool(max_abs <= tol),
    }

"""Fused boosting rounds: K rounds per dispatch with no copy inside it.

Counterpart of ``mpitree_tpu/boosting/fused_rounds.py``. The host round
loop (``gradient_boosting.py``) copies every round's tree to the host,
refits it in float64 and updates float64 margins there, so the card waits
on the host between rounds. ``rounds_per_dispatch=K`` runs K rounds with
every piece of state on the card (the JAX package's ``lax.scan`` over
``_make_rounds_fn``, ``:260-368``); each round:

1. computes (g, h) from the carried float32 margins (:func:`_grad_hess`,
   the host's ``tanh`` form of the logistic), times ``sample_weight`` and
   the round's keyed row mask drawn on the card
   (``ops/sampling.row_subsample_mask_dev``, bit for bit the host's);
2. grows one best-first tree (``core/leafwise_builder._LeafLoop``)
   at the fixed trip count of ``P - 1`` expansions, which reads nothing;
3. sums every leaf's (G, H) exactly (int64 fixed point) and rounds the
   sums to float32 before the division ``-G / max(H + lambda, 1e-12)``;
4. moves the margins by ``learning_rate`` times their leaf's value.

The histograms take the fixed-point route, whose exponents come from the
payload's channel maxima: the host loop reads them once per round, which
here would be a copy in every round. So a dispatch fixes them from bounds
that hold for all its K rounds (:func:`_payload_tops`): the logistic's
``|g| <= max w`` and ``h <= max w / 4``; squared error's residual grows at
most by ``(1 + learning_rate)`` a round, so ``K`` rounds stay under the
dispatch's starting ``max |raw - y|`` times ``(1 + learning_rate)**K``
(with room for float32 rounding). Every round checks its payload against
those bounds on the card, and the dispatch raises if one was passed, so
no int64 sum can overflow. A dispatch copies its starting residual (squared
error) and then its K trees, leaf sums and losses: four copies per
dispatch, none inside it.

The ensembles are not bit-identical to ``rounds_per_dispatch=1`` (float32
margins here, float64 there; other fixed-point exponents): the JAX
package's own contract, margins within 2e-4. The leaf values replay the
card's float32 division bit for bit (:func:`_finalize_round_tree`), so
``staged_predict`` replays the training margins in float64.

Eligibility (:func:`resolve_rounds_per_dispatch`, ``:82-240``): one tree
a round (binary logistic or squared error), no early stopping, no
``colsample_bytree``, a leaf pool within :data:`FUSED_POOL_CEILING` and
the histogram budget, and no feature axis. On a data mesh every shard
keeps its rows' margins and the leaf loop steps without a CUDA graph
(:func:`run_fused_rounds`).

Resilience (``:552-590``, ``:666-678``): each dispatch runs inside the
retry ladder (``resilience.retry_device``), so a transient failure
re-runs that dispatch only, from the margins it started from, and counts
one ``device_retries`` (the JAX package saves an empty dispatch snapshot
for this and counts the same retry under ``level_retries``; the
closure's own start is the resume point here, with one budget a
dispatch all the same). The carried margins are replaced, never written
in place, and every attempt captures the leaf loop's CUDA graph anew, so
no graph whose launches failed is replayed); the ``fused_rounds`` chaos
seam is inside the retried closure and ``grad_hess`` corrupts the
margins it starts from, which the non-finite guard then refuses. A
``BoostCheckpoint`` flushes after each dispatch that crosses a multiple
of ``checkpoint_every`` rounds, so a resumed fit starts at a dispatch
boundary of the uninterrupted one and dispatches as it did: the same
exponents, trees and margins bit for bit.

Evidence (``obs/advisor.advise_rounds_per_dispatch``, ``:176-205``):
``"auto"`` consults the flight store's ``gbdt_fusedK`` A/Bs on this
device type after the blockers, which no measurement overrides: a
measured "host" gives K = 1, a measured "fused" the K it was measured
at, and no verdict leaves :data:`ROUNDS_AUTO`.
"""

from __future__ import annotations

import numpy as np
import torch

from mpitree_tpu_torch.config import knobs
from mpitree_tpu_torch.core import leafwise_builder as leafwise
from mpitree_tpu_torch.core.builder import (
    BuildConfig,
    FitInputs,
    evidence_shape,
    note_subtraction,
    resolve_hist_subtraction,
)
from mpitree_tpu_torch.obs import accounting as obs_acct
from mpitree_tpu_torch.obs import advisor
from mpitree_tpu_torch.obs import memory as memory_lib
from mpitree_tpu_torch.ops import hist_kernel
from mpitree_tpu_torch.ops.histogram import gbdt_payload
from mpitree_tpu_torch.ops.sampling import row_subsample_mask_dev
from mpitree_tpu_torch.parallel import collective
from mpitree_tpu_torch.resilience import chaos
from mpitree_tpu_torch.resilience.config import elastic_enabled
from mpitree_tpu_torch.resilience.failure import is_oom_failure
from mpitree_tpu_torch.resilience.retry import retry_device
from mpitree_tpu_torch.utils.profiling import PhaseTimer

DEFAULT_ROUNDS_PER_DISPATCH = 8
# Leaf-pool ceiling: every open leaf is one sequential expansion of a
# round (``:79``).
FUSED_POOL_CEILING = 4096
# What rounds_per_dispatch="auto" resolves to, per device type: K > 1 only
# where chip_smoke.py phase 26 measured the fused rounds faster than the
# host loop for both of its default fits (PERF.md); on the CPU the host
# loop, as in the JAX package. MPITREE_TPU_ROUNDS_PER_DISPATCH steers
# "auto".
ROUNDS_AUTO = {"cuda": DEFAULT_ROUNDS_PER_DISPATCH, "cpu": 1}
ROUNDS_ENV = "MPITREE_TPU_ROUNDS_PER_DISPATCH"
# JAX's refusal of the fused rounds on a feature axis (``:146-155``)
MESH2D_BLOCKER = (
    "(data, feature) mesh: the fused-rounds leaf pool has no feature-axis "
    "winner merge (mesh2d_unsupported) — use a 1-D data mesh or "
    "rounds_per_dispatch=1")
# Device-to-host copies of the fused rounds, counted here: the dispatches'
# residual reads and result copies.
copies = 0


def resolve_rounds_per_dispatch(param, *, device_type: str, loss_kind,
                                loss_K: int, early_stopping: bool,
                                colsample: float, max_depth, max_leaf_nodes,
                                n_samples=None, n_features=None, n_bins=None,
                                hist_budget_bytes=None,
                                feature_shards: int = 1,
                                policy_evidence: str = "auto",
                                obs=None) -> tuple:
    """``(K, reason)`` for the estimator's ``rounds_per_dispatch``
    (``:82-240``): the environment steers ``"auto"`` only; an explicit
    integer wins, and raises where a blocker forbids it (a ``(data,
    feature)`` mesh among them, ``:146-155``). When nothing blocks,
    ``"auto"`` follows the stored evidence (the module docstring;
    ``policy_evidence`` gates it, ``obs`` records the
    ``advisor_rounds_per_dispatch`` decision), else :data:`ROUNDS_AUTO`
    for ``device_type``."""
    blockers = []
    if n_samples is not None:
        pn = memory_lib.pool_capacity(
            max_leaf_nodes if max_leaf_nodes is not None else 1 << 30,
            max_depth, int(n_samples))
        pool_bytes = memory_lib.pool_hist_bytes(pn, int(n_features or 1),
                                                int(n_bins or 256))
        budget = int(hist_budget_bytes) if hist_budget_bytes else 4 << 30
        if pn > FUSED_POOL_CEILING or pool_bytes > budget:
            blockers.append(
                f"leaf pool of {pn} open leaves exceeds the fused-program "
                f"budget (> {FUSED_POOL_CEILING} sequential expansions "
                f"per round, or ~{pool_bytes >> 20} MiB pool histograms "
                "vs hist_budget_bytes) — set max_leaf_nodes to bound it"
            )
    if loss_K > 1 or loss_kind is None:
        blockers.append(
            "the loss has no in-device twin (multiclass softmax fits one "
            "tree per class per round)"
        )
    if early_stopping:
        blockers.append(
            "early_stopping scores the held-out slice per round on host"
        )
    if float(colsample) < 1.0:
        blockers.append(
            "colsample_bytree < 1 re-slices the binned matrix per round "
            "(one compiled shape per round set)"
        )
    if max_depth is None and max_leaf_nodes is None:
        blockers.append(
            "unbounded trees: the in-program leaf pool needs a static "
            "budget (set max_depth or max_leaf_nodes)"
        )
    if int(feature_shards) > 1:
        blockers.append(MESH2D_BLOCKER)
    flag = "auto" if param in (None, "auto") else param
    from_env = False
    env_note = ""
    if flag == "auto":
        env = (knobs.raw(ROUNDS_ENV) or "auto").strip().lower() or "auto"
        if env != "auto":
            try:
                ek = int(env)
            except ValueError:
                ek = -1
            if ek >= 1:
                flag, from_env = ek, True
            else:
                env_note = (
                    f"{ROUNDS_ENV}={env!r} invalid (ignored; use an integer "
                    ">= 1 or 'auto'); "
                )
    if flag == "auto":
        if blockers:
            return 1, env_note + "auto: " + "; ".join(blockers)
        adv = advisor.advise_rounds_per_dispatch(
            platform=device_type, policy_evidence=policy_evidence,
            shape={k: int(v) for k, v in (
                ("n_samples", n_samples), ("n_features", n_features),
                ("n_bins", n_bins)) if v is not None})
        advisor.record_advice(obs, adv)
        if adv is not None and adv["value"] == "host":
            return 1, env_note + (
                "evidence: the host per-round loop measured faster on "
                f"{device_type} (gbdt_fusedK history, n="
                f"{adv['evidence_n']}, median speedup {adv['median']}x)")
        if adv is not None and adv["value"] == "fused":
            k_ev = int(adv.get("K") or DEFAULT_ROUNDS_PER_DISPATCH)
            return k_ev, env_note + (
                f"evidence: K={k_ev} fused rounds measured "
                f"{adv['median']}x faster than the host loop "
                f"(gbdt_fusedK history, n={adv['evidence_n']})")
        k = ROUNDS_AUTO.get(device_type, 1)
        if k == 1:
            return 1, env_note + (
                f"auto: host-per-round on {device_type}: launches are "
                "cheap there and the leaf-wise rounds build more")
        return k, env_note + (
            f"auto: {k} rounds per dispatch on {device_type}, measured "
            "faster than the host loop (chip_smoke.py phase 26)")
    k = int(flag)
    if k < 1:
        raise ValueError(
            f"rounds_per_dispatch must be >= 1 or 'auto', got {param!r}"
        )
    if k > 1 and blockers:
        if from_env:
            return 1, (
                f"{ROUNDS_ENV}={k} overridden (env steers the auto default "
                "only): " + "; ".join(blockers)
            )
        raise ValueError(
            f"rounds_per_dispatch={k} cannot apply: " + "; ".join(blockers)
        )
    if from_env:
        return k, f"explicit {ROUNDS_ENV}={k}"
    return k, f"explicit rounds_per_dispatch={k}"


def _grad_hess(loss_kind: str, raw: torch.Tensor, y: torch.Tensor) -> tuple:
    """float32 (g, h) of the margins (``_grad_hess_jnp``, ``:242``): the
    residual and 1 for squared error; the host's ``tanh`` form of the
    logistic, stable at both tails."""
    if loss_kind == "squared_error":
        g = raw - y
        return g, torch.ones_like(g)
    p = 0.5 * (1.0 + torch.tanh(0.5 * raw))
    return p - y, p * (1.0 - p)


def _loss_rows(loss_kind: str, raw: torch.Tensor,
               y: torch.Tensor) -> torch.Tensor:
    """Per-row losses (``_loss_rows_jnp``, ``:252``), in the inputs'
    dtype."""
    if loss_kind == "squared_error":
        return 0.5 * (raw - y) ** 2
    return torch.logaddexp(torch.zeros_like(raw), raw) - y * raw


def _payload_tops(loss_kind: str, max_w: float, residual: float,
                  y_top: float, lr: float, k: int) -> np.ndarray:
    """Channel bounds of the ``(count, g, h)`` payload over a dispatch of
    ``k`` rounds (see the module docstring): the count is 0 or 1; the
    logistic's ``|g| <= max w``, ``h <= max w / 4``; squared error's
    ``|g| <= max w * R_k`` with ``R_k <= (R_0 + k 2**-22 max|y|) (1 +
    lr)**k`` (the term in ``max|y|`` covers the float32 rounding of the
    margin updates), doubled, and ``h = w``."""
    if loss_kind == "squared_error":
        r = (residual + k * 2.0 ** -22 * y_top) * (1.0 + lr) ** k * 2.0
        return np.array([1.0, max_w * r, max_w])
    return np.array([1.0, max_w, max_w * 0.25])


def _finalize_round_tree(binned, n_nodes: int, ints: np.ndarray,
                         counts: np.ndarray, G32: np.ndarray,
                         H32: np.ndarray, reg_lambda: float):
    """One round's expansion-ordered arrays -> a host TreeArrays with the
    card's leaf values (``_finalize_round_tree``, ``:370``): the float64
    Newton rollup of ``gradient_boosting._newton_refit`` started from the
    card's float32 leaf (G, H), with the leaves' values replayed in the
    card's float32 arithmetic bit for bit, so predicting replays the
    training margins."""
    tree, perm = leafwise._finalize_leafwise(
        binned, "gbdt", "mse", n_nodes, ints[0], ints[1], counts, ints[2],
        ints[3], ints[4], np.float64)
    G = np.zeros(tree.n_nodes)
    H = np.zeros(tree.n_nodes)
    G[perm] = np.asarray(G32[:n_nodes], np.float64)
    H[perm] = np.asarray(H32[:n_nodes], np.float64)
    for i in range(tree.n_nodes - 1, 0, -1):
        p = tree.parent[i]
        if p < 0:
            continue
        G[p] += G[i]
        H[p] += H[i]
    denom = np.maximum(H + reg_lambda, 1e-12)
    vals = -G / denom
    leaves = tree.left < 0
    vals32 = -G[leaves].astype(np.float32) / np.maximum(
        H[leaves].astype(np.float32) + np.float32(reg_lambda),
        np.float32(1e-12))
    vals[leaves] = vals32.astype(np.float64)
    tree.value = vals.astype(np.float32)
    tree.count[:, 0] = vals
    tree.impurity = 0.5 * G * G / denom
    return tree


def run_fused_rounds(*, binned, packed, y_tr: np.ndarray, sw_tr, raw_tr,
                     trees: list, train_scores: list, max_iter: int,
                     cfg: BuildConfig, seed: int, lr: float, loss_kind: str,
                     rounds_per_dispatch: int, subsample: float,
                     verbose: bool = False, mesh=None, start_round: int = 0,
                     ck=None, checkpoint_every: int = 10,
                     checkpoint_compact_every=None,
                     obs=None, rescue=None) -> int:
    """Drive a fit in dispatches of ``rounds_per_dispatch`` rounds
    (``run_fused_rounds``, ``:412``) from round ``start_round`` (a resumed
    checkpoint's). Appends the trees and the training scores to
    ``trees``/``train_scores``, writes the float32 margins of the
    dispatched rounds back into ``raw_tr[:, 0]``, and returns the round
    it reached: ``max_iter``, or earlier when an OOM ``rescue``
    (``resilience.recovery.OomRescue``) degraded ``rounds_per_dispatch``
    to 1, and the caller's host round loop takes the remaining rounds.
    The fit's memory ledger (``obs/memory.plan_fit`` of the pool, the
    margins and the (g, h) of the dispatch) is recorded and preflighted
    before anything is placed, and each dispatch is priced for the
    compute ledger (``fused_rounds_fn``).
    ``obs`` (the fit's observer) gets the JAX package's record of fused
    rounds (``:505-670``): the ``engine`` decision (``"fused_rounds"``),
    the leaf loop's ``frontier`` (with its CUDA-graph choice) and
    ``hist_subtraction``, the spans ``shard`` and ``fused_rounds``, one
    round row a round, the ``fused_round_dispatches`` and
    ``rounds_fused`` counters, and each round tree's level rows, scan
    counters and fingerprint rows replayed from the finished tree (never
    recorded inside the graph). Raises
    ``FloatingPointError`` on a non-finite round, as the host loop does,
    and ``RuntimeError`` if a payload passed its dispatch's bounds (which
    would make the fixed-point sums inexact). Each dispatch runs through
    ``retry_device`` (``obs`` takes the ladder's counters); ``ck`` (a
    ``BoostCheckpoint``) flushes
    the trees and the margins as the module docstring says.

    On a data ``mesh`` (``:260-360``, ``:413-565``) every shard keeps its
    rows' margins, targets, weights and row masks; the leaf loop grows
    each tree over the shards (its pair histograms reduced over the
    mesh, no CUDA graph), every leaf's exact (G, H) sums reduce over it,
    and the dispatch's residual bound is the maximum over it (MAX), so
    the exponents, the trees and the margins are the one-device ones bit
    for bit. The training losses sum per shard, then over the mesh: equal
    to the one-device loss up to float64 summation order."""
    global copies
    obs = PhaseTimer(enabled=False) if obs is None else obs
    dev = binned.x_binned.device if mesh is None else mesh.lead
    N = binned.n_samples
    sw = np.ones(N, np.float32) if sw_tr is None else np.asarray(
        sw_tr, np.float32)
    max_w, y_top = float(sw.max(initial=0.0)), float(
        np.abs(np.asarray(y_tr, np.float32)).max(initial=0.0))
    total_w = float(np.sum(sw, dtype=np.float64))
    cand = torch.from_numpy(binned.candidate_mask()).to(dev)
    pool = leafwise._pool_capacity(
        cfg.max_leaf_nodes if cfg.max_leaf_nodes is not None else 1 << 30,
        cfg.max_depth, N)
    M = 2 * pool - 1
    lam32 = torch.tensor(np.float32(cfg.reg_lambda), device=dev)
    eps32 = torch.tensor(np.float32(1e-12), device=dev)
    # one fit, one leaf loop: every round copies its (count, g, h) into the
    # same payload tensors, so the loop's captured step serves every round
    # of a dispatch (a dispatch's new exponents are a new capture)
    zeros = np.zeros(N, np.float32)
    plan = obs_acct.build_memory_plan(
        mesh=mesh, rows=int(N), features=int(binned.n_features), classes=2,
        bins=int(binned.n_bins), task="gbdt", max_depth=cfg.max_depth,
        max_leaf_nodes=int(pool), fixed=True,
        subtraction=resolve_hist_subtraction(
            cfg, dev, shape=evidence_shape(N, binned.n_features,
                                           binned.n_bins)),
        hist_budget_bytes=cfg.hist_budget_bytes,
        max_frontier_chunk=cfg.max_frontier_chunk,
        max_table_slots=cfg.max_table_slots,
        rounds_per_dispatch=int(rounds_per_dispatch), engine="fused_rounds",
        device_bin=isinstance(binned.x_binned, torch.Tensor))
    obs.memory_plan(plan.to_dict())
    memory_lib.preflight(plan, obs=obs, what="fused-rounds dispatch",
                         device=dev)
    with obs.span("shard"):
        fit = FitInputs(binned, zeros if mesh is not None else
                        torch.as_tensor(zeros, device=dev), cfg,
                        sample_weight=zeros, packed=packed,
                        scale_exp=(0, 0, 0), candidate_mask=cand, mesh=mesh)

    def rows(a):
        return fit.row_parts(torch.as_tensor(a, device=dev))

    y32 = rows(np.asarray(y_tr, np.float32))
    y64 = [v.to(torch.float64) for v in y32]
    w32 = rows(sw)
    w64 = [v.to(torch.float64) for v in w32]
    raw = rows(np.ascontiguousarray(raw_tr[:, 0], np.float32))
    # padding rows keep margin 0 (target 0, weight 0): they touch no bound
    real = [nid >= 0 for nid in fit.root_nids()]
    lr32 = [torch.tensor(np.float32(lr), device=sh.dev) for sh in fit.shards]
    loop = leafwise._LeafLoop(fit, cfg, pool=pool,
                              use_sub=leafwise.leafwise_subtraction(
                                  fit, cfg, pool, obs=obs),
                              entry="cuda_graph:fused_rounds")
    obs.decision(
        "engine", "fused_rounds",
        reason=(f"rounds_per_dispatch={rounds_per_dispatch}: K full "
                "boosting rounds (grad/hess, leaf-wise build, leaf refit, "
                "margin update) per dispatch, the margins on the device"),
        rounds_per_dispatch=int(rounds_per_dispatch), pool=int(pool))
    obs.decision(
        "frontier", "leafwise",
        reason=f"fused rounds: best-first pool of {pool} open leaves",
        max_leaf_nodes=cfg.max_leaf_nodes, pool=int(pool),
        graph=loop.use_graph, graph_reason=loop.graph_reason)
    note_subtraction(obs, loop.use_sub, leafwise=True)

    def dispatch(r: int, k: int, raw_in: list) -> tuple:
        """Rounds ``r .. r + k - 1`` from the margins ``raw_in`` (left as
        they are): the new margins and the dispatch's three host copies."""
        global copies
        chaos.step("fused_rounds")
        raw = chaos.corrupt("grad_hess", *raw_in)
        raw = list(raw) if len(raw_in) > 1 else [raw]
        residual = 0.0
        if loss_kind == "squared_error":
            residual = float(collective.psum(
                [(a - b).abs().max().view(1) for a, b in zip(raw, y32)],
                mesh, "max", site="gbdt_residual_pmax")[0])  # a dispatch's read
            copies += 1
            if not np.isfinite(residual):
                raise FloatingPointError(
                    f"non-finite margins at boosting round {r} (max |raw - "
                    f"y| = {residual}, at the start of a fused "
                    f"rounds_per_dispatch={rounds_per_dispatch} dispatch): "
                    "lower learning_rate, rescale targets/sample_weight, or "
                    "set rounds_per_dispatch=1 for the f64-margin host loop "
                    "— refusing to fit garbage rounds")
        tops = _payload_tops(loss_kind, max_w, residual, y_top, lr, k)
        exps = hist_kernel.exponents_from_top(tops[None], N)[0]
        fit.scale_exp = exps
        loop.recapture()
        over = torch.zeros((), dtype=torch.bool, device=dev)
        ints, floats, scalars = [], [], []
        for i in range(k):
            masks = None
            if subsample < 1.0:
                masks = rows(row_subsample_mask_dev(
                    seed, r + i, N, subsample, dev).to(torch.float32))
            gh = []
            for s, sh in enumerate(fit.shards):
                g, h = _grad_hess(loss_kind, raw[s], y32[s])
                g, h = g * w32[s], h * w32[s]
                if masks is not None:
                    g, h = g * masks[s], h * masks[s]
                sh.payload.copy_(gbdt_payload(g, h))
                tops_d = torch.as_tensor(tops, dtype=torch.float64,
                                         device=sh.dev)
                over = over | (sh.payload.abs().amax(dim=0).to(
                    torch.float64) > tops_d).any().to(dev)
                # every leaf's (G, H), summed exactly
                gh.append(hist_kernel.quantize(torch.stack([g, h], dim=1),
                                               exps[1:]))
            grown = loop.grow(check_every=None)
            GH = collective.node_sums(gh, grown.nid, 0, n_slots=M + 2,
                                      scale_exp=exps[1:], mesh=mesh).to(
                                          torch.float32)
            vals = -GH[:, 0] / torch.maximum(GH[:, 1] + lam32, eps32)
            loss = []
            for s, nid in enumerate(grown.nid):
                step = vals.to(nid.device).index_select(
                    0, nid.clamp(min=0).to(torch.int64))
                raw[s] = raw[s] + lr32[s] * torch.where(
                    real[s], step, torch.zeros_like(step))
                loss.append((w64[s] * _loss_rows(
                    loss_kind, raw[s].to(torch.float64), y64[s])).sum()
                    .view(1))
            loss = collective.psum(loss, mesh, site="gbdt_leaf_psum")[0]
            ints.append(grown.ints.clone())
            floats.append(torch.cat([grown.counts, GH.to(torch.float64)],
                                    dim=1))
            scalars.append(torch.stack([grown.n_nodes.to(torch.float64),
                                        loss]))
        # a bound passed on any process is passed on all: they raise together
        over = collective.psum([over.to(torch.int32).view(1)], mesh,
                               "max", site="gbdt_bound_pmax")[0] > 0
        # the dispatch's results: three copies (which wait for the card)
        ints_h = torch.stack(ints).cpu().numpy()
        floats_h = torch.stack(floats).cpu().numpy()
        scal_h = torch.cat([torch.stack(scalars).flatten(),
                            over.to(torch.float64).view(1)]).cpu().numpy()
        copies += 3
        return raw, ints_h, floats_h, scal_h

    dispatches = 0
    r = start_round
    while r < max_iter:
        if rescue is not None and rescue.rounds_per_dispatch:
            # an OOM rescue named the pool or the margins: none of them
            # scales with the dispatch width, so the remaining rounds go
            # to the host round loop (the caller), whose levelwise builds
            # hold the chunked split working set instead
            break
        k = min(int(rounds_per_dispatch), max_iter - r)
        # the margins carry every round before r: a retry re-runs this
        # dispatch only
        with obs.span("fused_rounds"):
            try:
                raw, ints_h, floats_h, scal_h = retry_device(
                    lambda: dispatch(r, k, raw),
                    what=f"gbdt fused rounds {r}..{r + k - 1}", obs=obs)
            except Exception as e:  # noqa: BLE001 — the OOM-rescue seam
                # the shrink changes the program, so the rescue cannot
                # re-run this closure: the loop's check above exits
                if not (rescue is not None and elastic_enabled()
                        and is_oom_failure(e)
                        and rescue.attempt(
                            e, what=f"gbdt fused rounds {r}..{r + k - 1}")):
                    raise
                continue
        dispatches += 1
        if scal_h[-1]:
            raise RuntimeError(
                f"fused rounds {r}..{r + k - 1}: a (g, h) payload passed its "
                "dispatch's bounds; its fixed-point sums would be inexact")
        scal_h = scal_h[:-1].reshape(k, 2)
        for i in range(k):
            n_nodes = int(scal_h[i, 0])
            G32, H32 = floats_h[i, :, 3], floats_h[i, :, 4]
            gt, ht = float(np.sum(G32)), float(np.sum(H32))
            if not (np.isfinite(gt) and np.isfinite(ht)
                    and np.isfinite(scal_h[i, 1])):
                err = (
                    f"non-finite gradient/hessian totals at boosting round "
                    f"{r + i} (G_total={gt}, H_total={ht}, in a fused "
                    f"rounds_per_dispatch={rounds_per_dispatch} dispatch): "
                    "the f32 margin carry has overflowed or the inputs "
                    "carry non-finite values; lower learning_rate, rescale "
                    "targets/sample_weight, or set rounds_per_dispatch=1 "
                    "for the f64-margin host loop — refusing to fit "
                    "garbage rounds"
                )
                obs.event("nonfinite_grad", err)
                raise FloatingPointError(err)
            tree = _finalize_round_tree(
                binned, n_nodes, ints_h[i], floats_h[i, :, :3], G32, H32,
                float(cfg.reg_lambda))
            trees.append(tree)
            mean_loss = float(scal_h[i, 1]) / max(total_w, 1e-300)
            train_scores.append(-mean_loss)
            # the round tree's record, replayed after the dispatch
            leafwise.replay_leafwise(obs, tree, fit, cfg, loop.use_sub,
                                     level_rows=True)
            obs.round(
                round=r + i, trees=1, subsample=float(subsample),
                colsample=1.0, train_loss=mean_loss, val_loss=None,
                stale=None, early_stop=False, seconds=None,
                rounds_per_dispatch=int(rounds_per_dispatch))
        obs.counter("fused_round_dispatches")
        obs.counter("rounds_fused", k)
        fresh = trees[-k:]
        obs_acct.price_leafwise(
            obs, "fused_rounds_fn", fit,
            {"rows_scanned": sum(obs_acct.leafwise_scan_rows(
                t, n_features=fit.F, n_bins=fit.B, n_channels=fit.C,
                task="gbdt", subtraction=loop.use_sub)[2]["rows_scanned"]
                for t in fresh)},
            expansions=sum(int(np.sum(t.left >= 0)) for t in fresh),
            subtraction=loop.use_sub, trees=k)
        new_r = r + k
        if verbose:
            print(f"[gbdt] rounds {r + 1}..{new_r}/{max_iter} (fused "
                  f"dispatch) train_loss={-train_scores[-1]:.6f}")
        if ck is not None and (new_r // int(checkpoint_every)
                               > r // int(checkpoint_every)):
            with obs.span("checkpoint_flush"):
                raw_tr[:, 0] = collective.gather_rows(raw, mesh,
                                                      N).cpu().numpy()
                copies += 1
                ck.append(trees[len(ck.trees):], {
                    "raw_tr": raw_tr,
                    "train_scores": np.asarray(train_scores, np.float64)})
                ck.maybe_compact(checkpoint_compact_every, obs)
        r = new_r
    if dispatches:
        # nothing dispatched (a resumed fit that had finished, or a rescue
        # before the first dispatch): the float64 margins stay as they are
        raw_tr[:, 0] = collective.gather_rows(raw, mesh, N).cpu().numpy()
        copies += 1
    return r

"""The streamed fit of the tree estimators.

Counterpart of ``mpitree_tpu/models/_streamed.py``.
``DecisionTreeClassifier``, ``ParallelDecisionTreeClassifier`` and
``DecisionTreeRegressor`` come here when ``fit`` receives a
:class:`~mpitree_tpu_torch.ingest.StreamedDataset` (as ``X`` or as
``dataset=``): the ingest sketches, bins and places the matrix chunk by
chunk (``mpitree_tpu_torch.ingest``), then the same device engines grow
the tree from the placed ``StreamedBinnedData``, the tree of an
in-memory fit of the same rows field for field while the sketch is
exact.

How a streamed fit differs from an in-memory one:

- it runs on the device engine only: ``backend="host"`` raises (the host
  tier needs a host-resident matrix, which a stream never builds);
- the refine tail gathers its candidates' raw rows by replaying the chunk
  stream once (``ingest/stream.StreamRowProvider``); fits across several
  processes stay crown-only (each process streams only its shard);
- the build runs inside the retry rungs of the resilience ladder
  (``resilience.retry_device``, the JAX package's ``:199``): a transient
  failure retries on the card (the levelwise engine from its last
  level), but there is no host rung: the host tier would need the
  host-resident matrix a stream never builds, so a terminal failure
  raises. The JAX package's OOM rescue waits for ``ROADMAP.md`` item 18e.
"""

from __future__ import annotations

import numpy as np

from mpitree_tpu_torch.core.builder import BuildConfig
from mpitree_tpu_torch.parallel.mesh import resolve_mesh
from mpitree_tpu_torch.utils.validation import (
    apply_class_weight,
    min_child_weight,
    min_decrease_scaled,
    resolve_refine,
    validate_fit_targets,
    validate_max_leaf_nodes,
    validate_sample_weight,
)


def is_streamed(X, dataset) -> bool:
    """Whether this fit call is a streamed one (``dataset=`` wins; a
    StreamedDataset passed as ``X`` routes here too)."""
    from mpitree_tpu_torch.ingest import StreamedDataset

    if dataset is not None and not isinstance(dataset, StreamedDataset):
        raise TypeError(
            "dataset= must be a mpitree_tpu_torch.ingest.StreamedDataset "
            f"(got {type(dataset).__name__}); in-memory fits pass X, y"
        )
    return isinstance(dataset, StreamedDataset) or isinstance(
        X, StreamedDataset
    )


def stream_of(X, dataset, y):
    """The StreamedDataset of a streamed fit call, after the JAX
    package's refusals of ``X`` and ``dataset=`` together and of a
    separate ``y``."""
    if dataset is not None and X is not None:
        raise ValueError("pass the StreamedDataset as X or dataset=, not both")
    if y is not None:
        # training on the dataset's own targets while the caller handed
        # other ones would be a wrong model, not an inconvenience
        raise ValueError(
            "a StreamedDataset carries its own targets; fit(dataset) "
            "takes no separate y — rebuild the dataset with the labels "
            "you want"
        )
    return X if dataset is None else dataset


def refuse_host(est) -> None:
    """A streamed fit runs the device engine only."""
    from mpitree_tpu_torch.models.classifier import host_tier

    if host_tier(est.backend):
        raise ValueError(
            "backend='host': a streamed fit runs the device engine only "
            "(the host tier needs a host-resident matrix, which a stream "
            "never builds); drop backend= (device= picks the card or the "
            "CPU)"
        )


def ingest_for(est, ds):
    """Ingest ``ds`` for ``est``: the mesh the chunks land on (resolved
    first: placement needs it before binning; one shard for one device),
    then both passes. Returns ``(IngestResult, build mesh or None for one
    device, FitClock, stats)``; sets ``est.ingest_stats_``. For one device
    ``res.binned`` is its one shard as a plain ``BinnedData``, which the
    one-device builds take; on a mesh it stays the placed shards."""
    from mpitree_tpu_torch.ingest import ingest_dataset
    from mpitree_tpu_torch.models.classifier import FitClock

    mesh = resolve_mesh(device=est.device, n_devices=est.n_devices)
    clock = FitClock(mesh.lead)
    res = ingest_dataset(ds, mesh=mesh, max_bins=est.max_bins,
                         binning=est.binning)
    stats = {"bin_seconds": clock.lap()}
    est.ingest_stats_ = res.stats
    if est.n_devices in (None, 1):
        res.binned, mesh = res.binned.single(), None
    return res, mesh, clock, stats


def stream_weight(res, sample_weight):
    """The fit's sample weights: per chunk or as the fit argument, not
    both."""
    if sample_weight is not None and res.sample_weight is not None:
        raise ValueError(
            "sample weights arrived both per-chunk and as a fit argument; "
            "pick one"
        )
    return validate_sample_weight(
        res.sample_weight if sample_weight is None else sample_weight,
        res.binned.n_samples,
    )


def streamed_fit(est, X, dataset, y=None, sample_weight=None):
    """Fit the tree estimator ``est`` from a StreamedDataset; returns
    ``est``."""
    from mpitree_tpu_torch.models.classifier import grow_tree
    from mpitree_tpu_torch.ops.sampling import sampler_for
    from mpitree_tpu_torch.utils.monotonic import validate_monotonic_cst
    from mpitree_tpu_torch.utils.profiling import debug_checks_enabled

    ds = stream_of(X, dataset, y)
    task = est._task
    if task == "regression" and est.criterion not in (
        "squared_error", "mse"
    ):
        raise ValueError(
            f"unknown regression criterion: {est.criterion!r}"
        )
    if task == "classification":
        est._check_slice()
    refuse_host(est)
    mln = validate_max_leaf_nodes(est)
    res, mesh, clock, stats = ingest_for(est, ds)
    binned = res.binned
    N, F = binned.n_samples, binned.n_features
    y_enc, classes = validate_fit_targets(res.y, task=task)
    sw = stream_weight(res, sample_weight)
    if task == "classification":
        sw = apply_class_weight(est.class_weight, y_enc, classes, sw)
    mono = validate_monotonic_cst(
        est.monotonic_cst, F, task=task,
        **({"n_classes": len(classes)} if task == "classification" else {}),
    )
    # the tail replays the chunk stream for its rows; across processes
    # each streamed only its shard, so those fits stay crown-only
    multihost = mesh is not None and mesh.n_procs > 1
    rd, refine, crown_depth = resolve_refine(
        est.max_depth, est.refine_depth,
        n_rows=N, quantized=binned.quantized,
    )
    if multihost or mono is not None or mln is not None:
        rd, refine, crown_depth = None, False, est.max_depth
    cfg = BuildConfig(
        task=task,
        criterion=est.criterion if task == "classification" else "mse",
        max_depth=crown_depth,
        max_leaf_nodes=mln,
        min_samples_split=est.min_samples_split,
        min_child_weight=min_child_weight(
            est.min_weight_fraction_leaf, sw, N, est.min_samples_leaf,
        ),
        min_decrease_scaled=min_decrease_scaled(
            est.min_impurity_decrease, sw, N
        ),
        debug=debug_checks_enabled(),
    )
    if task == "classification":
        y_build, refit, n_classes = y_enc, None, len(classes)
    else:
        est._y_mean = float(y_enc.mean()) if len(y_enc) else 0.0
        y_build = (y_enc - est._y_mean).astype(np.float32)
        refit, n_classes = y_enc, None
    est.tree_ = grow_tree(
        binned, res.row_provider(), y_build, host=False, cfg=cfg,
        max_depth=est.max_depth, rd=rd, refine=refine, n_classes=n_classes,
        sample_weight=sw, ccp_alpha=est.ccp_alpha, clock=clock, stats=stats,
        refit_targets=refit,
        feature_sampler=sampler_for(est.max_features, est.random_state, F,
                                    splitter=est.splitter),
        mono_cst=mono, mesh=mesh, what=f"{type(est).__name__}.fit streamed",
    )
    est.fit_stats_ = stats
    if task == "classification":
        est._set_fitted(classes, F)
    else:
        est._set_fitted(F)
    res.close()  # the spill store, if the ingest opened one
    return est

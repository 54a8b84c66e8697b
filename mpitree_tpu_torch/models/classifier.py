"""Decision-tree classifier with the JAX package's estimator surface.

Counterpart of ``mpitree_tpu/models/classifier.py``: the same constructor
parameters (``:161-190``) plus ``device``, and the same fitted attributes
(``n_features_``, ``classes_``, ``tree_``). ``predict_proba`` returns the
reference's **raw class counts** (``:398-403``), ``predict`` their argmax.

A fit follows the JAX package's order (``:226-367``): binning, the refine
decision (``utils/validation.resolve_refine``), the build to the crown
depth, the hybrid refine tail (``core/hybrid_builder.apply_refine``) and
``ccp_alpha`` pruning (``utils/pruning.ccp_prune``).

- ``backend=None`` runs the device engine on ``device``: the fused engine
  (``core/fused_builder.py``), or the levelwise one (``core/builder.py``)
  under ``MPITREE_TPU_ENGINE=levelwise``, growing the same tree.
  ``device=None`` means ``"cuda"`` and raises when CUDA is missing; only
  an explicit ``device="cpu"`` runs the plain CPU path. Unlike the JAX
  package, a small fit is not routed to the host tier: the card builds
  every ``backend=None`` fit. The trees agree with the JAX package's
  default either way: integer weights sum exactly on both tiers, and a
  fractionally weighted fit (``sample_weight``, ``class_weight``) takes
  the histogram's fixed-point route, whose counts are the exact float64
  sums the JAX host tier computes (the two differ only where two candidate
  costs tie within 1e-12 relative: the host's C++ sweep keeps the first of
  such near-ties, the device engine the smaller).
- ``backend="host"`` runs the host tier (host binning, then
  ``core/host_builder.build_tree_host``); ``"cpu"`` and ``"tpu"`` raise
  and point to ``device=``.
- ``refine_depth="auto"`` engages the refine tail as the JAX package does:
  when quantile binning capped a feature and the native C++ sweep builds
  (``native.lib()``), at a crown depth of ``round(log2(n_rows / 2048))``.
  An integer sets the crown depth; ``None`` builds the whole depth in one
  engine.

sklearn is not a dependency: ``get_params``/``set_params`` read the
``__init__`` signature and ``score`` is the (weighted) mean accuracy.
``class_weight`` (``"balanced"`` or a dict) multiplies ``sample_weight``
as the JAX package's ``apply_class_weight`` does (``:239-240``).

Every fit writes into a ``obs.BuildObserver`` (:func:`fit_observer`) and
keeps its record as ``fit_report_`` (the JAX package's schema 9: the
``engine`` that ran, ``"fused"`` or ``"levelwise"`` on the device as
``core/builder.resolve_engine`` picks it, or ``"host"``, with its reason;
the ``build_path``, ``refine`` and ``refine_tail`` decisions; counters,
level rows, events and fingerprints); ``dump_report(path)`` writes it.
``fit_stats_`` is, as in the JAX package, the phase summary (``bin``,
``shard``, ``fused_build``, ``host_finalize``, ``refine``, ``prune``,
...; each span ending when the card is idle) under
``MPITREE_TPU_PROFILE=1`` or a ``trace_to`` sink, and None otherwise.
``fit(..., trace_to=path_or_sink)`` renders the fit as a Chrome trace
(``obs/trace.py``). ``obs.record.STATS_MOVES`` lists where each key the
port's ``fit_stats_`` held before lives in ``fit_report_``.

``max_features`` samples a fresh feature subset at every node and
``splitter="random"`` draws each feature's split bin among its valid ones
(``ops/sampling.sampler_for``, the JAX package's ``:273-278``), on both
tiers and in the tail; a node whose sampled features cannot split becomes
a leaf. ``feature_importances_`` is sklearn's normalized total impurity
decrease (``utils/importances.feature_importances``).

``monotonic_cst`` (sklearn's, binary classification only;
``utils/monotonic.py``) gates every split on its child class fractions and
builds the whole depth in one engine, with no refine tail (``:244-250``);
the finished tree's ``value`` holds the bound-clipped labels, which
``predict`` reads, while ``predict_proba`` stays on the raw counts
(``:369-371``, ``:423-433``).

``decision_path``, ``export_dot``, ``export_text`` and ``nodes_`` render
or walk the fitted tree as the JAX package's do (``utils/export.py``,
``core/tree_struct.py``).

``max_leaf_nodes`` grows the tree best-first on the device engine
(``core/leafwise_builder.py``), the whole depth in one engine with no
refine tail (``:249-252``); ``backend="host"`` refuses it, as the JAX
package does. ``fit_report_`` then also holds the ``frontier`` decision
(``"leafwise"``) and the ``expansions`` counter.

``fit(dataset=StreamedDataset...)`` (or the dataset as ``X``) fits from
a chunk stream (``mpitree_tpu_torch.ingest``, ``models/_streamed.py``):
the raw matrix never exists on the host, the binned one only on the
devices, and the tree equals the in-memory fit's while the sketch is
exact; ``ingest_stats_`` holds the ingest's counts and seconds.

``n_devices`` (None or 1: one device) builds on a data mesh
(``parallel/mesh.resolve_mesh``: ``"all"``, -1 or an int; across the
processes that ``parallel/distributed.initialize`` joined): the rows
shard over the devices, every level's histograms reduce over them, and
the tree equals the one-device tree field for field; ``predict`` shards
its rows over this process's devices. ``n_devices=(dr, df)`` shards the
rows over ``dr`` and the features over ``df`` (the 2-D ``(data,
feature)`` mesh): each shard sweeps its feature slab and the winners
merge over the feature axis, still the one-device tree;
``monotonic_cst``, ``max_features`` sampling and ``max_leaf_nodes``
raise there, as in the JAX package. ``max_leaf_nodes`` works on a data
mesh. ``fit_report_`` then also holds the mesh and the reductions that
ran, per site under the JAX package's names (``split_hist_psum``,
``counts_psum``, the feature axis's ``feature_merge_all_gather`` and
``route_psum``, ``replication_check``: calls, bytes, seconds).
:class:`ParallelDecisionTreeClassifier` is the reference's MPI class,
``n_devices="all"`` by default; ``backend="host"`` ignores
``n_devices``, as the JAX package's host tier does.
"""

from __future__ import annotations

import inspect

import numpy as np
import torch

from mpitree_tpu_torch._device import resolve_device
from mpitree_tpu_torch.core.builder import BuildConfig, build_tree
from mpitree_tpu_torch.core.host_builder import build_tree_host
from mpitree_tpu_torch.core.hybrid_builder import apply_refine
from mpitree_tpu_torch.core.tree_struct import TreeArrays
from mpitree_tpu_torch.models._streamed import is_streamed, streamed_fit
from mpitree_tpu_torch.obs.observer import (
    BuildObserver,
    note_build_path,
    note_refine,
    observing,
)
from mpitree_tpu_torch.obs.record import ReportMixin
from mpitree_tpu_torch.ops.binning import bin_dataset, bin_for_engine
from mpitree_tpu_torch.ops.predict import predict_leaf_ids
from mpitree_tpu_torch.ops.sampling import sampler_for
from mpitree_tpu_torch.parallel.distributed import process_info
from mpitree_tpu_torch.parallel.mesh import resolve_mesh
from mpitree_tpu_torch.resilience.recovery import OomRescue, SnapshotSlot
from mpitree_tpu_torch.resilience.retry import (
    device_failover,
    retry_device,
    sync,
)
from mpitree_tpu_torch.serving.tables import note_serving
from mpitree_tpu_torch.utils.carry import tree_from_reference
from mpitree_tpu_torch.utils.export import (
    export_tree_dot,
    export_tree_text,
    tree_decision_path,
)
from mpitree_tpu_torch.utils.importances import feature_importances
from mpitree_tpu_torch.utils.monotonic import (
    clip_tree_values,
    validate_monotonic_cst,
)
from mpitree_tpu_torch.utils.profiling import debug_checks_enabled
from mpitree_tpu_torch.utils.pruning import ccp_prune, pruning_path_for
from mpitree_tpu_torch.utils.validation import (
    NotFittedError,
    apply_class_weight,
    feature_names_of,
    min_child_weight,
    min_decrease_scaled,
    record_sklearn_attributes,
    resolve_refine,
    sklearn_flavoured,
    validate_fit_data,
    validate_max_leaf_nodes,
    validate_predict_data,
    validate_sample_weight,
)


def host_tier(backend) -> bool:
    """True for ``backend="host"`` (the host tier), False for ``None``
    (the device engine on ``device``); the JAX package's platform names
    ``"cpu"``/``"tpu"`` raise and point to ``device=``."""
    if backend is None or backend == "host":
        return backend == "host"
    if backend in ("cpu", "tpu"):
        raise ValueError(
            f"backend={backend!r} is a JAX platform: the port runs its "
            "device engine where device= says ('cuda' or 'cpu'); "
            "backend='host' is the host tier"
        )
    raise ValueError(f"backend must be None or 'host', got {backend!r}")


def grow_tree(binned, X, y, *, host: bool, cfg: BuildConfig, max_depth, rd,
              refine: bool, n_classes, sample_weight, ccp_alpha,
              obs, packed=None,
              refit_targets=None, feature_sampler=None,
              feature_mask=None, mono_cst=None, mesh=None,
              host_binned=None, what: str = "fit") -> TreeArrays:
    """One tree in the JAX package's order: the build to the crown depth
    ``cfg.max_depth`` (the host tier when ``host``, in the ``host_build``
    span, else the device engine on ``binned``'s device, fused or
    levelwise as ``resolve_engine`` says), then :func:`finish_tree`. ``y``
    is what the builders take (class indices, or regression's float32
    centred targets, whose float64 ``refit_targets`` give the leaf
    values). ``obs`` (the fit's ``obs.BuildObserver``, whose ``device``
    is the fit's) receives the build's record: the engine that ran
    (``"fused"``, ``"levelwise"`` or ``"host"``), spans, counters, level
    rows, fingerprints and the tail's. ``feature_sampler``
    (``ops/sampling.py``) and ``feature_mask`` (a forest tree's subspace)
    go to both tiers and to the tail. ``mono_cst`` (the validated internal
    signs, or None) goes to both tiers, which then grow the whole depth
    (the caller passes ``refine=False``). A data ``mesh`` goes to the
    device engine, whose leaf ids then hold every row, so every process
    runs the same tail; its reductions join the record.

    The device build runs inside the resilience ladder
    (``resilience/retry.py``; the JAX package's
    ``mpitree_tpu/models/classifier.py:316-351``): a transient failure
    retries on the card, the levelwise engine from its last level, an
    OOM the memory ledger can shrink runs again on the card under the
    shrunk plan (``resilience.OomRescue``, at most three shrinks), and a
    terminal one (or a spent budget) raises, or, with
    ``MPITREE_TPU_ELASTIC=1``, rebuilds on the host tier when
    ``host_binned`` is given: a callable returning the host-binned matrix
    (``ops/binning.bin_dataset`` of the raw rows, bit-identical to the
    card's binning), which never reads a card tensor back, since after a
    sticky CUDA error there is no card to read. The rest of the fit then
    makes no CUDA call (``obs.device`` moves to the CPU). Without
    ``host_binned`` (a streamed fit), for a best-first build, which has
    no host twin, and on a mesh across processes, only the retry rungs
    run: a process that left for its host tier would leave its peers
    waiting in their next collective, so there the failure raises in
    every process, within the group's timeout. ``what`` names the fit in
    the ladder's warnings; its counters and events land in ``obs``."""
    kw = dict(config=cfg, n_classes=n_classes, sample_weight=sample_weight,
              return_leaf_ids=refine, refit_targets=refit_targets,
              feature_sampler=feature_sampler, feature_mask=feature_mask,
              mono_cst=mono_cst, timer=obs)
    with observing(obs):
        if host:
            with obs.phase("host_build"):
                res = build_tree_host(binned, y, **kw)
            obs.decision("engine", "host",
                         reason=obs.record.decisions["build_path"]["reason"])
        else:
            slot = SnapshotSlot()
            # an OOM the ledger can shrink runs again on the card: each
            # dispatch takes the rescue's shrinks so far
            rescue = OomRescue(obs=obs, snapshot_slot=slot)

            def device_build():
                out = build_tree(binned, y, packed=packed, mesh=mesh,
                                 snapshot_slot=slot,
                                 **dict(kw, config=rescue.apply(cfg)))
                sync(obs.device)  # a fault of this build raises here
                return out

            if (host_binned is None or cfg.max_leaf_nodes is not None
                    or (mesh is not None and mesh.n_procs > 1)):
                res = retry_device(
                    device_build, obs=obs, resume=slot, rescue=rescue,
                    what=f"{what} " + ("leaf-wise build"
                                       if cfg.max_leaf_nodes is not None
                                       else "device build"))
            else:
                def host_build():
                    obs.device = torch.device("cpu")
                    with obs.phase("host_build"):
                        out = build_tree_host(host_binned(), y, **kw)
                    obs.decision(
                        "engine", "host",
                        reason="device build failed; rebuilt on the host "
                        "tier (MPITREE_TPU_ELASTIC=1)")
                    return out

                res = device_failover(device_build, host_build, obs=obs,
                                      resume=slot, rescue=rescue,
                                      what=f"{what} device build")
        tree, leaf_ids = res if refine else (res, None)
        return finish_tree(
            tree, leaf_ids, X, y, cfg=cfg, max_depth=max_depth, rd=rd,
            refine=refine, n_classes=n_classes, sample_weight=sample_weight,
            ccp_alpha=ccp_alpha, obs=obs,
            refit_targets=refit_targets, feature_sampler=feature_sampler,
            feature_mask=feature_mask, mono_cst=mono_cst)


def finish_tree(tree, leaf_ids, X, y, *, cfg: BuildConfig, max_depth, rd,
                refine: bool, n_classes, sample_weight, ccp_alpha, obs,
                refit_targets=None, feature_sampler=None,
                feature_mask=None, mono_cst=None) -> TreeArrays:
    """A built crown finished as the JAX package's ``finish`` does it
    (``mpitree_tpu/models/forest.py:495-517``): the refine tail down to
    ``max_depth`` from the rows' ``leaf_ids`` when ``refine`` (the
    ``refine`` span), then ``ccp_alpha`` pruning (``prune``), then the
    clipped values of a constrained tree (``clip_tree_values``)."""
    if refine:
        tree = apply_refine(
            tree, leaf_ids, X, y, cfg=cfg, max_depth=max_depth, rd=rd,
            timer=obs, n_classes=n_classes, sample_weight=sample_weight,
            refit_targets=refit_targets, feature_mask=feature_mask,
            feature_sampler=feature_sampler,
        )
    if ccp_alpha:
        with obs.phase("prune"):
            tree = ccp_prune(tree, ccp_alpha, task=cfg.task)
    if mono_cst is not None:
        clip_tree_values(tree, mono_cst, cfg.task)
    return tree


def fit_observer(device, trace_to=None) -> BuildObserver:
    """A fit's observer: spans end when ``device`` is idle (when timing
    is on), and ``trace_to`` (a path or a shared ``obs.TraceSink``)
    renders the fit as a Chrome trace."""
    obs = BuildObserver()
    obs.device = device
    if trace_to is not None:
        obs.trace_to(trace_to)
    return obs


def finish_report(est, obs, *, tree=None, trees=None) -> None:
    """The fitted record, as the JAX package sets it: ``fit_stats_`` the
    phase summary under ``MPITREE_TPU_PROFILE=1`` (or a trace sink) and
    None otherwise, the serving-table note, then ``fit_report_``."""
    est.fit_stats_ = obs.summary() if obs.enabled else None
    note_serving(obs, [tree] if trees is None else trees)
    est.fit_report_ = obs.report(tree=tree, trees=trees)


def fit_mesh(est, host: bool):
    """The mesh of a tree fit (``parallel/mesh.resolve_mesh``: a data
    mesh, or ``(dr, df)``'s ``(data, feature)`` mesh), or None for one
    device and for the host tier, which ignores ``n_devices`` as the JAX
    package's does."""
    if host or est.n_devices in (None, 1):
        return None
    return resolve_mesh(device=est.device, n_devices=est.n_devices)


def predict_mesh(est):
    """The local shards a fitted tree predicts on: None for one device,
    else the mesh of ``n_devices`` (this process's devices only; no
    collective). Raises where that mesh cannot be resolved: predict never
    drops to one device on its own (unlike the JAX package's
    ``predict_mesh``, ``mpitree_tpu/ops/predict.py:109-118``)."""
    if est.n_devices in (None, 1):
        return None
    return resolve_mesh(device=est.device, n_devices=est.n_devices)


def _value_repr(v) -> str:
    """A parameter's value as sklearn's estimator printer writes it: dict
    items sorted by key, lists and tuples item by item, else ``repr``."""
    if isinstance(v, dict):
        items = sorted(v.items(), key=lambda kv: repr(kv[0]))
        return "{" + ", ".join(f"{_value_repr(k)}: {_value_repr(x)}"
                               for k, x in items) + "}"
    if isinstance(v, (list, tuple)):
        body = ", ".join(_value_repr(x) for x in v)
        if isinstance(v, list):
            return f"[{body}]"
        return f"({body},)" if len(v) == 1 else f"({body})"
    return repr(v)


class EstimatorBase(ReportMixin):
    """The estimators' shared surface, sklearn's estimator protocol without
    sklearn: ``get_params`` and ``set_params`` read the ``__init__``
    signature; ``__sklearn_tags__`` (imports ``sklearn.utils``, which only
    sklearn calls), ``_estimator_type`` (older sklearn),
    ``__sklearn_is_fitted__`` and sklearn's ``repr``; ``dump_report`` writes
    ``fit_report_`` (``obs/record.ReportMixin``). ``_repr_html_`` and
    metadata routing (``set_fit_request``) are not part of it."""

    @classmethod
    def _param_names(cls) -> list:
        sig = inspect.signature(cls.__init__)
        return sorted(p.name for p in sig.parameters.values()
                      if p.name != "self")

    @property
    def _estimator_type(self) -> str:
        return {"classification": "classifier",
                "regression": "regressor"}[self._task]

    def __sklearn_tags__(self):
        """sklearn's tags of the JAX counterpart (``BaseEstimator`` with
        ``ClassifierMixin`` or ``RegressorMixin``): a supervised estimator
        of dense 2-D numeric X and one 1-D target."""
        from sklearn.utils import (
            ClassifierTags,
            InputTags,
            RegressorTags,
            Tags,
            TargetTags,
        )

        classifier = self._estimator_type == "classifier"
        return Tags(
            estimator_type=self._estimator_type,
            target_tags=TargetTags(required=True),
            classifier_tags=ClassifierTags() if classifier else None,
            regressor_tags=None if classifier else RegressorTags(),
            input_tags=InputTags(),
        )

    def __sklearn_is_fitted__(self) -> bool:
        try:
            self._check_fitted()
        except NotFittedError:
            return False
        return True

    def __repr__(self) -> str:
        """sklearn's ``Name(param=value, ...)``: the parameters that differ
        from the constructor's defaults, sorted, on one line up to 80
        characters, else wrapped as sklearn's compact printer wraps them
        (``sklearn/utils/_pprint.py``)."""
        name = type(self).__name__
        defaults = {p.name: p.default for p in inspect.signature(
            type(self).__init__).parameters.values()}
        reps = [f"{k}={_value_repr(v)}" for k, v in self.get_params().items()
                if repr(v) != repr(defaults[k])]
        line = f"{name}({', '.join(reps)})"
        if len(line) <= 80:
            return line
        indent = len(name) + 1
        out, delim, delimnl = [name, "("], "", ",\n" + " " * indent
        width = max_width = 80 - indent + 1
        for i, rep in enumerate(reps):
            if i == len(reps) - 1:  # room for the closing parenthesis
                width, max_width = width - 1, max_width - 1
            w = len(rep) + 2
            if width < w:
                width = max_width
                delim = delimnl if delim else delim
            out += [delim, rep]
            if width >= w:
                width, delim = width - w, ", "
            else:  # longer than a line: the next one starts a line
                delim = delimnl
        return "".join(out) + ")"

    def get_params(self, deep=True) -> dict:
        return {k: getattr(self, k) for k in self._param_names()}

    def set_params(self, **params):
        valid = set(self._param_names())
        for k, v in params.items():
            if k not in valid:
                raise ValueError(
                    f"Invalid parameter {k!r} for estimator "
                    f"{type(self).__name__}. Valid parameters are: "
                    f"{sorted(valid)!r}."
                )
            setattr(self, k, v)
        return self

    def _not_fitted(self):
        return sklearn_flavoured(NotFittedError)(
            f"This {type(self).__name__} instance is not fitted yet. "
            "Call 'fit' with appropriate arguments before using this "
            "estimator."
        )


class ClassifierBase(EstimatorBase):
    """The classifiers' shared surface: ``score`` is the (weighted) mean
    accuracy of ``predict``."""

    _task = "classification"

    def score(self, X, y, sample_weight=None) -> float:
        """Mean accuracy (weighted by ``sample_weight`` when given)."""
        hit = (self.predict(X) == np.asarray(y)).astype(np.float64)
        if sample_weight is None:
            return float(hit.mean())
        return float(np.average(hit, weights=np.asarray(sample_weight)))

    def _set_fitted(self, classes, n_features: int, names=None) -> None:
        """The fitted surface: ``classes_``, the feature counts and
        :func:`record_sklearn_attributes`' (``names``: the fit's
        ``feature_names_in_``, None for a fit without names)."""
        self.classes_ = np.asarray(classes)
        self.n_features_ = int(n_features)
        self.n_features_in_ = int(n_features)
        record_sklearn_attributes(self, names, n_features,
                                  n_classes=len(self.classes_))


class DecisionTreeClassifier(ClassifierBase):
    """Decision-tree classifier (entropy or Gini) built on the GPU.

    Parameters are those of ``mpitree_tpu.tree.DecisionTreeClassifier``,
    plus ``device`` (``None`` = ``"cuda"``; ``"cpu"`` runs the plain
    versions of the kernels). See the module docstring for the options
    this slice refuses.
    """

    def __init__(self, *, max_depth=None, max_leaf_nodes=None,
                 min_samples_split=2,
                 criterion="entropy", splitter="best", max_bins=256,
                 binning="auto",
                 max_features=None, class_weight=None,
                 min_weight_fraction_leaf=0.0, min_samples_leaf=1,
                 random_state=None,
                 n_devices=None, backend=None, refine_depth="auto",
                 ccp_alpha=0.0, min_impurity_decrease=0.0,
                 monotonic_cst=None, device=None):
        self.max_depth = max_depth
        self.max_leaf_nodes = max_leaf_nodes
        self.min_samples_split = min_samples_split
        self.criterion = criterion
        self.splitter = splitter
        self.max_bins = max_bins
        self.binning = binning
        self.max_features = max_features
        self.class_weight = class_weight
        self.min_weight_fraction_leaf = min_weight_fraction_leaf
        self.min_samples_leaf = min_samples_leaf
        self.random_state = random_state
        self.n_devices = n_devices
        self.backend = backend
        self.refine_depth = refine_depth
        self.ccp_alpha = ccp_alpha
        self.min_impurity_decrease = min_impurity_decrease
        self.monotonic_cst = monotonic_cst
        self.device = device

    def _check_slice(self) -> None:
        if self.criterion not in ("entropy", "gini"):
            raise ValueError(
                f"unknown classification criterion: {self.criterion!r}"
            )

    # -- fitting -----------------------------------------------------------
    def fit(self, X=None, y=None, sample_weight=None, *, trace_to=None,
            dataset=None):
        if is_streamed(X, dataset):
            return streamed_fit(self, X, dataset, y, sample_weight,
                                trace_to=trace_to)
        self._check_slice()
        host = host_tier(self.backend)
        mesh = fit_mesh(self, host)
        device = resolve_device(self.device) if mesh is None else mesh.lead
        names = feature_names_of(X)
        X, y_enc, classes = validate_fit_data(X, y)
        mono = validate_monotonic_cst(
            self.monotonic_cst, X.shape[1], task="classification",
            n_classes=len(classes))
        mln = validate_max_leaf_nodes(self)
        sw = validate_sample_weight(sample_weight, X.shape[0])
        sw = apply_class_weight(self.class_weight, y_enc, classes, sw)
        obs = fit_observer(device, trace_to)
        note_build_path(obs, host=host, backend=self.backend,
                        n_rows=X.shape[0], n_features=X.shape[1])
        with obs.phase("bin"):
            binned = (
                bin_dataset(X, max_bins=self.max_bins, binning=self.binning)
                if host else bin_for_engine(
                    X, max_bins=self.max_bins, binning=self.binning,
                    device=device,
                )
            )
        rd, refine, crown_depth = resolve_refine(
            self.max_depth, self.refine_depth,
            n_rows=X.shape[0], quantized=binned.quantized,
        )
        if mono is not None or mln is not None:
            # one engine for the whole depth: a tail would grow past the
            # leaf budget
            rd, refine, crown_depth = None, False, self.max_depth
        note_refine(obs, refine=refine, rd=rd, crown_depth=crown_depth,
                    refine_depth_param=self.refine_depth,
                    constrained=mono is not None, leafwise=mln is not None)
        cfg = BuildConfig(
            criterion=self.criterion,
            max_depth=crown_depth,
            max_leaf_nodes=mln,
            min_samples_split=self.min_samples_split,
            min_child_weight=min_child_weight(
                self.min_weight_fraction_leaf, sw, X.shape[0],
                self.min_samples_leaf,
            ),
            min_decrease_scaled=min_decrease_scaled(
                self.min_impurity_decrease, sw, X.shape[0]
            ),
            debug=debug_checks_enabled(),
        )
        self.tree_ = grow_tree(
            binned, X, y_enc, host=host, cfg=cfg, max_depth=self.max_depth,
            rd=rd, refine=refine, n_classes=len(classes), sample_weight=sw,
            ccp_alpha=self.ccp_alpha, obs=obs,
            feature_sampler=sampler_for(self.max_features, self.random_state,
                                        X.shape[1], splitter=self.splitter),
            mono_cst=mono, mesh=mesh, what=f"{type(self).__name__}.fit",
            host_binned=lambda: bin_dataset(X, max_bins=self.max_bins,
                                            binning=self.binning),
        )
        finish_report(self, obs, tree=self.tree_)
        self._set_fitted(classes, X.shape[1], names)
        return self

    def cost_complexity_pruning_path(self, X, y, sample_weight=None):
        """sklearn's diagnostic: the effective alphas and total leaf
        impurities along the minimal cost-complexity pruning path of an
        unpruned fit (``utils/pruning.py``)."""
        return pruning_path_for(self, X, y, sample_weight=sample_weight)

    @classmethod
    def from_reference(cls, arrays, classes, n_features: int, **params):
        """A fitted estimator from the JAX package's fitted tree:
        ``arrays`` as :func:`utils.carry.tree_from_reference` takes them,
        ``classes`` the reference's ``classes_``, ``n_features`` its
        ``n_features_``; ``params`` go to the constructor (``device``)."""
        est = cls(**params)
        est.tree_ = tree_from_reference(arrays)
        est._set_fitted(classes, n_features)
        return est

    # -- inference ---------------------------------------------------------
    def _check_fitted(self) -> None:
        if not isinstance(getattr(self, "tree_", None), TreeArrays):
            raise self._not_fitted()

    def _leaf_ids(self, X) -> np.ndarray:
        self._check_fitted()
        X = validate_predict_data(X, self)
        mesh = predict_mesh(self)
        return predict_leaf_ids(
            X, self.tree_, resolve_device(self.device) if mesh is None
            else mesh.lead, mesh=mesh)

    def predict_proba(self, X):
        """Raw per-class leaf counts — the reference's quirk."""
        ids = self._leaf_ids(X)
        return self.tree_.count[ids]

    def apply(self, X):
        """The leaf index each sample lands in (int64)."""
        return self._leaf_ids(X).astype(np.int64)

    def decision_path(self, X):
        """sklearn's ``decision_path``: the (n_samples, n_nodes) CSR
        indicator of the nodes each sample passes (``scipy.sparse``)."""
        return tree_decision_path(self.tree_, self._leaf_ids(X))

    def predict(self, X):
        if self.monotonic_cst is not None:
            # the bound-clipped leaf labels clip_tree_values wrote: the
            # raw counts' argmax would ignore the clip where a bound binds
            return self.classes_[self.tree_.value[self._leaf_ids(X)]]
        idx = self.predict_proba(X).argmax(axis=1)
        return self.classes_[idx]

    # -- introspection -----------------------------------------------------
    def export_text(self, *, feature_names=None, class_names=None,
                    precision=2):
        self._check_fitted()
        return export_tree_text(
            self.tree_, feature_names=feature_names, class_names=class_names,
            precision=precision,
        )

    def export_dot(self, *, feature_names=None, class_names=None,
                   precision=2):
        """Graphviz source of the fitted tree (``utils/export.py``)."""
        self._check_fitted()
        return export_tree_dot(
            self.tree_, feature_names=feature_names,
            class_names=class_names, precision=precision,
            task="classification", n_features=self.n_features_,
        )

    @property
    def nodes_(self):
        """The reference's linked ``Node`` view of the fitted tree (its
        root; ``TreeArrays.to_nodes``)."""
        self._check_fitted()
        return self.tree_.to_nodes()

    @property
    def feature_importances_(self) -> np.ndarray:
        """Normalized total impurity decrease per feature (sklearn's)."""
        self._check_fitted()
        return feature_importances(self.tree_, self.n_features_,
                                   criterion=self.criterion, task=self._task)

    def get_depth(self) -> int:
        self._check_fitted()
        return self.tree_.max_depth

    def get_n_leaves(self) -> int:
        self._check_fitted()
        return self.tree_.n_leaves


class _ClassProperty:
    """A read-only property of the class itself (``WORLD_RANK``)."""

    def __init__(self, fget):
        self.fget = fget

    def __get__(self, obj, owner):
        return self.fget(owner)


class ParallelDecisionTreeClassifier(DecisionTreeClassifier):
    """The reference's MPI class on a data mesh
    (``mpitree_tpu/models/classifier.py:485-531``): ``n_devices="all"``
    by default, so the rows shard over every device of this process and
    of every process ``parallel/distributed.initialize`` joined, and each
    level's histograms reduce over them. The fitted tree is the
    one-device tree field for field (the integer route's float32 sums and
    the fixed-point route's int64 sums do not depend on the order), the
    reference's every-rank-holds-the-same-tree contract.

    ``WORLD_RANK`` is this process's index and ``WORLD_SIZE`` the global
    shard count ``n_devices="all"`` gives (``len(jax.devices())`` in the
    JAX package): the CUDA devices of a process times the processes, or,
    without CUDA, the CPU shard count (``parallel/mesh.cpu_shards``) times
    the processes. Both are counts only."""

    def __init__(self, *, max_depth=None, max_leaf_nodes=None,
                 min_samples_split=2,
                 criterion="entropy", splitter="best", max_bins=256,
                 binning="auto",
                 max_features=None, class_weight=None,
                 min_weight_fraction_leaf=0.0, min_samples_leaf=1,
                 random_state=None,
                 n_devices="all", backend=None, refine_depth="auto",
                 ccp_alpha=0.0, min_impurity_decrease=0.0,
                 monotonic_cst=None, device=None):
        super().__init__(
            max_depth=max_depth, max_leaf_nodes=max_leaf_nodes,
            min_samples_split=min_samples_split,
            criterion=criterion, splitter=splitter, max_bins=max_bins,
            binning=binning,
            max_features=max_features, class_weight=class_weight,
            min_weight_fraction_leaf=min_weight_fraction_leaf,
            min_samples_leaf=min_samples_leaf, random_state=random_state,
            n_devices=n_devices, backend=backend, refine_depth=refine_depth,
            ccp_alpha=ccp_alpha, min_impurity_decrease=min_impurity_decrease,
            monotonic_cst=monotonic_cst, device=device,
        )

    @_ClassProperty
    def WORLD_RANK(cls) -> int:
        return process_info()["process_index"]

    @_ClassProperty
    def WORLD_SIZE(cls) -> int:
        return process_info()["global_devices"]

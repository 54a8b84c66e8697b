"""The public surface of the JAX package and the port, read with ``ast``.

``surface(root)`` walks every module of a package without importing it
and returns its public names; ``lacking()`` lists every entry of the JAX
package's surface that the port lacks, as ``"path:qualname[:param]"``
keys. ``ALLOWED`` holds the entries the port leaves out on purpose, each
with its reason; ``missing()`` is what the port lacks and ``ALLOWED``
does not cover, ``stale()`` the entries that cover nothing.
``tests/test_torch_surface.py`` requires both to be empty.

What counts as the surface of a module (``path`` relative to the
package, ``mpitree_tpu/serving/model.py`` -> ``serving/model.py``):

- every public top-level function, class and UPPER_CASE constant
  (``path:name``);
- every public method of a public class, ``__init__`` and ``__call__``
  included (``path:Class.method``), and every property or class attribute;
- every parameter name of each such function or method
  (``path:qualname:param``);
- in an ``__init__.py``, every name it exports: its ``__all__`` and its
  from-imports (``path:name``).

The port has a name where its module at the same path defines or imports
it; a method where the class, or a base class the port defines anywhere,
has it; a parameter where the port's function names it. An entry of
``ALLOWED`` covers its key and every key below it (a module path covers
the module, ``path:name`` the function and its parameters).
"""

from __future__ import annotations

import ast
import functools
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
JAX_ROOT = REPO / "mpitree_tpu"
PORT_ROOT = REPO / "mpitree_tpu_torch"

_SKIP_PARAMS = {"self", "cls"}


def _public(name: str) -> bool:
    return not name.startswith("_") or name in ("__init__", "__call__")


def _params(fn) -> list:
    a = fn.args
    names = [p.arg for p in (*a.posonlyargs, *a.args, *a.kwonlyargs)]
    names += [p.arg for p in (a.vararg, a.kwarg) if p is not None]
    return [n for n in names if n not in _SKIP_PARAMS]


def _top_level(body):
    """Statements at module level, ``if``/``try`` bodies included."""
    for node in body:
        if isinstance(node, ast.If):
            yield from _top_level(node.body)
            yield from _top_level(node.orelse)
        elif isinstance(node, ast.Try):
            yield from _top_level(node.body)
            for h in node.handlers:
                yield from _top_level(h.body)
            yield from _top_level(node.orelse)
            yield from _top_level(node.finalbody)
        else:
            yield node


def _targets(node) -> list:
    if isinstance(node, ast.Assign):
        tgts = node.targets
    elif isinstance(node, ast.AnnAssign):
        tgts = [node.target]
    else:
        return []
    out = []
    for t in tgts:
        for n in ast.walk(t):
            if isinstance(n, ast.Name):
                out.append(n.id)
    return out


class Module:
    """One module's definitions, imports and classes."""

    def __init__(self, path: Path):
        tree = ast.parse(path.read_text(), filename=str(path))
        self.functions: dict = {}   # name -> FunctionDef
        self.classes: dict = {}     # name -> ClassDef
        self.assigned: set = set()  # top-level assigned names
        self.imported: set = set()  # names bound by imports
        self.all: list | None = None
        for node in _top_level(tree.body):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.functions[node.name] = node
            elif isinstance(node, ast.ClassDef):
                self.classes[node.name] = node
            elif isinstance(node, (ast.Import, ast.ImportFrom)):
                for a in node.names:
                    self.imported.add(
                        (a.asname or a.name).split(".")[0])
            for name in _targets(node):
                self.assigned.add(name)
                if name == "__all__" and isinstance(
                        node.value, (ast.List, ast.Tuple)):
                    self.all = [e.value for e in node.value.elts
                                if isinstance(e, ast.Constant)]
        self.from_imported = [
            (a.asname or a.name)
            for node in _top_level(tree.body)
            if isinstance(node, ast.ImportFrom)
            for a in node.names if a.name != "*"
        ]

    def names(self) -> set:
        return (set(self.functions) | set(self.classes) | self.assigned
                | self.imported)


def _members(cls) -> dict:
    """A class body's methods (name -> FunctionDef) and attributes
    (name -> None)."""
    out: dict = {}
    for node in cls.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.setdefault(node.name, node)
        for name in _targets(node):
            out.setdefault(name, None)
    return out


def _base_names(cls) -> list:
    out = []
    for b in cls.bases:
        if isinstance(b, ast.Name):
            out.append(b.id)
        elif isinstance(b, ast.Attribute):
            out.append(b.attr)
    return out


@functools.lru_cache(maxsize=None)
def load(root: Path) -> dict:
    """``path -> Module`` for every module under ``root``."""
    return {str(p.relative_to(root)): Module(p)
            for p in sorted(root.rglob("*.py"))
            if "__pycache__" not in p.parts}


def _class_index(mods: dict) -> dict:
    """Class name -> [ClassDef] over a whole package (bases resolve by
    name)."""
    idx: dict = {}
    for m in mods.values():
        for name, cls in m.classes.items():
            idx.setdefault(name, []).append(cls)
    return idx


def _function_index(mods: dict) -> dict:
    """Function name -> [FunctionDef] over a whole package (a name a module
    imports resolves by name)."""
    idx: dict = {}
    for m in mods.values():
        for name, fn in m.functions.items():
            idx.setdefault(name, []).append(fn)
    return idx


def _resolved_members(cls, idx: dict, seen=None) -> dict:
    seen = set() if seen is None else seen
    if id(cls) in seen:
        return {}
    seen.add(id(cls))
    out = dict(_members(cls))
    for base in _base_names(cls):
        for b in idx.get(base, []):
            for k, v in _resolved_members(b, idx, seen).items():
                out.setdefault(k, v)
    return out


def surface(root: Path) -> dict:
    """``key -> None`` for every public entry of the package at ``root``
    (insertion-ordered, so a listing reads module by module)."""
    out: dict = {}
    for path, m in load(root).items():
        if path.endswith("__init__.py"):
            for name in dict.fromkeys([*(m.all or []), *m.from_imported]):
                if _public(name) and not name.startswith("__"):
                    out[f"{path}:{name}"] = None
        for name, fn in m.functions.items():
            if not _public(name) or name.startswith("__"):
                continue
            out[f"{path}:{name}"] = None
            for p in _params(fn):
                out[f"{path}:{name}:{p}"] = None
        for name in sorted(m.assigned):
            if name.isupper() and _public(name):
                out[f"{path}:{name}"] = None
        for name, cls in m.classes.items():
            if not _public(name) or name.startswith("__"):
                continue
            out[f"{path}:{name}"] = None
            for member, fn in _members(cls).items():
                if not _public(member):
                    continue
                out[f"{path}:{name}.{member}"] = None
                if fn is not None:
                    for p in _params(fn):
                        out[f"{path}:{name}.{member}:{p}"] = None
    return out


def lacking(jax_root: Path = JAX_ROOT, port_root: Path = PORT_ROOT) -> list:
    """Every key of the JAX package's surface the port lacks."""
    port = load(port_root)
    idx, fidx = _class_index(port), _function_index(port)
    return [k for k in surface(jax_root) if not has(k, port, idx, fidx)]


def covers(entry: str, key: str) -> bool:
    """Whether allowlist ``entry`` covers surface ``key``: the same key,
    or a key below it (``path`` covers ``path:...``, ``path:f`` covers
    ``path:f:param``, ``path:C`` covers ``path:C.m`` and its params)."""
    if key == entry:
        return True
    if ":" not in entry:
        return key.startswith(entry + ":")
    return key.startswith((entry + ":", entry + "."))


def missing(lack=None) -> list:
    """The keys the port lacks that no ``ALLOWED`` entry covers."""
    lack = lacking() if lack is None else lack
    return [k for k in lack if not any(covers(e, k) for e in ALLOWED)]


def stale(lack=None, jax_surface=None) -> list:
    """``ALLOWED`` entries that name nothing of the JAX package's surface
    or cover nothing the port lacks (the port has it now)."""
    lack = lacking() if lack is None else lack
    jax_surface = surface(JAX_ROOT) if jax_surface is None else jax_surface
    return [e for e in ALLOWED
            if not any(covers(e, k) for k in jax_surface)
            or not any(covers(e, k) for k in lack)]


def has(key: str, port: dict, idx: dict, fidx: dict) -> bool:
    """Does the port (``load(PORT_ROOT)``, its classes ``idx`` and
    functions ``fidx`` by name) have the entry ``key``?"""
    path, qual, *param = key.split(":")
    m = port.get(path)
    if m is None:
        return False
    head, _, member = qual.partition(".")
    cls = m.classes.get(head)
    if cls is None and head in m.imported and idx.get(head):
        cls = idx[head][0]
    if not member:
        if not param:
            return head in m.names() or head in (m.all or [])
        fns = ([m.functions[head]] if head in m.functions
               else list(fidx.get(head, []))
               if head in m.imported else [])
        if cls is not None:
            fns.append(_resolved_members(cls, idx).get("__init__"))
        return any(f is not None and param[0] in _params(f) for f in fns)
    if cls is None:
        return False
    members = _resolved_members(cls, idx)
    if member not in members:
        return False
    if not param:
        return True
    fn = members[member]
    return fn is not None and param[0] in _params(fn)


# ---------------------------------------------------------------------------
# what the port leaves out, and why
# ---------------------------------------------------------------------------

ALLOWED: dict = {}


def _allow(reason: str, *entries: str) -> None:
    for e in entries:
        assert e not in ALLOWED, e
        ALLOWED[e] = reason


_allow("jax version shims (LEGACY_JAX); the port imports no jax "
       "(ROADMAP, package boundary)", "_compat.py")
_allow("Pallas/Mosaic kernels K1-K2 with their VMEM fits, payload builders "
       "and TPU availability probes; the port's counterparts are the Hopper "
       "kernels behind ops/hist_kernel.py (ROADMAP Queue 2)",
       "ops/pallas_hist.py")
_allow("Pallas/Mosaic kernel K3 (S >= 256) with its VMEM window and bf16 "
       "rule; the port's counterpart is ops/hist_kernel.py's sorted route "
       "(ROADMAP Queue 2)", "ops/wide_hist.py")
_allow("K4/K5's Mosaic tier: VMEM-resident kernel tables, their budgets, "
       "row tiles and resolve_serving_kernel's TPU tier pick; the port's "
       "counterpart is serving/serve_kernel.py, its body recorded as the "
       "serving_kernel decision (ROADMAP Queue 2)",
       "serving/pallas_serve.py", "serving/__init__.py:resolve_serving_kernel")

_allow("R3: at backend=None the port keeps every fit on its device engine; "
       "JAX's routing of small fits to its host tier is not ported",
       "core/builder.py:prefer_host_path", "core/builder.py:HOST_PATH_MAX_CELLS")
_allow("TPU histogram tiers (Pallas kernel, wide kernel, XLA scatter) and "
       "their knob; the port routes every payload through its Hopper "
       "kernels (ops/hist_kernel.py routes, ROADMAP Queue 2)",
       "core/builder.py:resolve_hist_kernel", "core/builder.py:resolve_wide_hist",
       "core/builder.py:resolve_wide_pallas", "core/builder.py:BuildConfig.hist_kernel")
_allow("the JAX package's float32 sweep and its float64 opt-in on XLA CPU; "
       "the port's split sweep ranks in float64 and accumulates (g, h) in "
       "float64 on every device (ROADMAP, parity contract)",
       "core/builder.py:resolve_exact_ties", "core/builder.py:exact_ties_fits",
       "core/builder.py:warn_exact_ties_gap", "core/builder.py:resolve_gbdt_x64",
       "core/builder.py:ledger_and_preflight:gbdt_x64",
       "parallel/collective.py:pair_split_stats:exact_ties",
       "parallel/collective.py:pair_split_stats:gbdt_x64")
_allow("float32 moment-cancellation tolerance of the JAX regression sweep; "
       "the port's float64 sweep from exact sums has no such noise floor "
       "(ROADMAP, parity contract)", "core/builder.py:BuildConfig.var_rel_tol")
_allow("the port's engines read MPITREE_TPU_LEVEL_RETRY alone "
       "(resilience/recovery.resolve_level_retry); JAX's BuildConfig field "
       "only carries the knob's value", "core/builder.py:BuildConfig.level_retry",
       "resilience/recovery.py:resolve_level_retry:flag")
_allow("the port's subtraction rule (core/builder.SUBTRACTION_AUTO, measured "
       "on the card) reads the device and the config: its sums are exact "
       "(integer or fixed point) on every payload, so no platform, task or "
       "payload input decides exactness",
       "core/builder.py:resolve_hist_subtraction:platform",
       "core/builder.py:resolve_hist_subtraction:task",
       "core/builder.py:resolve_hist_subtraction:integer_ok",
       "core/builder.py:resolve_hist_subtraction:gbdt_x64",
       "core/builder.py:resolve_hist_subtraction:total_weight")
_allow("the port's ledger reads the task from y and prices the torch device "
       "(device=); chunk width and fused rounds are planned inside it",
       "core/builder.py:ledger_and_preflight:task",
       "core/builder.py:ledger_and_preflight:platform",
       "core/builder.py:ledger_and_preflight:chunk_slots",
       "core/builder.py:ledger_and_preflight:rounds_per_dispatch",
       "core/builder.py:ledger_and_preflight:n_out")
_allow("multi-host gather of a jax.Array's row shards "
       "(multihost_utils); the port's row ids come back through "
       "parallel/collective.gather_rows", "core/builder.py:fetch_row_nodes")
_allow("the port resolves by the torch device's type (device_type=), not a "
       "JAX platform string",
       "boosting/fused_rounds.py:resolve_rounds_per_dispatch:platform")
_allow("a SnapshotSlot per dispatch boundary of JAX's fused rounds; the "
       "port's fused rounds resume from the boosting checkpoint (ck=) and "
       "retry a dispatch whole (resilience/retry.retry_device)",
       "boosting/fused_rounds.py:run_fused_rounds:slot")
_allow("operands of JAX's batched forest program (jnp samplers traced in); "
       "the port passes each tree's sampler (samplers=) and counts exactly "
       "on every payload",
       "core/fused_builder.py:build_forest_fused:integer_counts",
       "core/fused_builder.py:build_forest_fused:root_keys",
       "core/fused_builder.py:build_forest_fused:sample_k",
       "core/fused_builder.py:build_forest_fused:random_split")
_allow("read once at import in JAX; the port reads the knob "
       "MPITREE_TPU_FOREST_HBM_BUDGET at each fit "
       "(parallel/mesh.forest_hbm_budget, the card's capacity by default)",
       "core/fused_builder.py:FOREST_HBM_BUDGET_BYTES")
_allow("renamed in the port: y", "core/hybrid_builder.py:apply_refine:y_build")
_allow("picks a branch of JAX's fused lax.cond chain of frontier tiers, an "
       "XLA static-shape mechanism; the port prices levels with "
       "obs/accounting.effective_tiers",
       "obs/accounting.py:interior_big_reachable")
_allow("TPU lane padding (128-wide channel tiles) and VMEM budgets of the "
       "Mosaic serving tier; the port prices its own kernels' shared memory "
       "and node records (obs/memory.plan_serve)",
       "obs/memory.py:c_padded", "obs/memory.py:serve_kernel_row_tile",
       "obs/memory.py:serve_fits_vmem", "obs/memory.py:SERVE_VMEM_BUDGET_BYTES",
       "obs/memory.py:node_table_bytes")
_allow("renamed in the port (n_feat, n_chan, cell_bytes)",
       "obs/memory.py:chunk_bytes_per_slot:n_features",
       "obs/memory.py:chunk_bytes_per_slot:n_channels",
       "obs/memory.py:chunk_bytes_per_slot:itemsize")
_allow("renamed in the port (n_samples, n_feat, n_bins, n_chan)",
       "obs/memory.py:default_chunk_slots:rows",
       "obs/memory.py:default_chunk_slots:f_shard",
       "obs/memory.py:default_chunk_slots:bins",
       "obs/memory.py:default_chunk_slots:channels")
_allow("JAX's jnp binning program, kept for real TPUs only; the port's "
       "device binning is ops/binning.bin_dataset_torch, routed by the torch "
       "device (bin_for_engine(device=))",
       "ops/binning.py:bin_dataset_device", "ops/binning.py:bin_for_engine:backend")
_allow("pulls device-binned rows back for the host rung; the port's host "
       "rung bins the raw rows (models/classifier.grow_tree, ROADMAP: the "
       "host rung is opt-in)", "ops/binning.py:ensure_host_binned")
_allow("shard_map feature-slab indexing; the port's feature mesh hands each "
       "shard its slab (parallel/mesh.pad_features)",
       "ops/histogram.py:slab_local_features")
_allow("JAX's per-payload XLA scatters; the port builds the payload "
       "(ops/histogram.moment_payload, gbdt_payload) and sums it through "
       "one route (parallel/collective.split_hist, ops/hist_kernel)",
       "ops/histogram.py:moment_histogram", "ops/histogram.py:grad_hess_histogram")
_allow("jax.Array placement and jit-cache plumbing of JAX's predict path "
       "(device_put per tree, NamedSharding of the rows, an id-keyed cache "
       "outside sklearn's __dict__); the port's predict descends the cached "
       "serving table (serving/tables.NodeTable.dev_arrays) on the "
       "estimator's device",
       "ops/predict.py:WeakIdCache", "ops/predict.py:device_tree_arrays",
       "ops/predict.py:predict_mesh", "ops/predict.py:shard_rows",
       "ops/predict.py:predict_leaf_ids:tree_dev",
       "ops/predict.py:predict_leaf_ids:n_steps",
       "ops/predict.py:STACKED_GROUP_BYTES",
       "ops/predict.py:stacked_leaf_ids:group_bytes")
_allow("jnp twins of the samplers for traced programs; the port's samplers "
       "are torch (ops/sampling.py), held bit for bit to the numpy ones",
       "ops/sampling.py:row_subsample_mask_jnp", "ops/sampling.py:pcg_hash_jnp",
       "ops/sampling.py:node_masks_jnp", "ops/sampling.py:node_draws_jnp",
       "ops/sampling.py:child_keys_jnp")
_allow("shard_map bodies over named mesh axes (psum inside traced "
       "programs); the port's collectives act on a parallel/mesh.Mesh's "
       "shards (collective.node_sums, y_range, split_step)",
       "parallel/collective.py:node_counts_local",
       "parallel/collective.py:regression_y_range",
       "parallel/collective.py:make_split_fn",
       "parallel/collective.py:make_expand_fn",
       "parallel/collective.py:make_counts_fn",
       "parallel/collective.py:make_update_fn",
       "parallel/collective.py:select_global:dec",
       "parallel/collective.py:select_global:feature_axis")
_allow("the port's sibling pair step takes its payload and mesh "
       "(pair_split_stats(x_binned, payload, node_id, ..., mesh=)); JAX's "
       "names shard_map operands and its psum axis",
       *(f"parallel/collective.py:pair_split_stats:{p}" for p in (
           "xb", "nid", "w", "base_id", "phist", "mcw", "lam", "msl",
           "n_classes", "psum_axis")))
_allow("jax device lists and NamedSharding placement; the port's meshes "
       "take the torch device (device=) and place shards themselves "
       "(parallel/mesh.shard_build_inputs)",
       "parallel/mesh.py:available_devices", "parallel/mesh.py:shard_rows",
       "parallel/mesh.py:replicate", "parallel/mesh.py:resolve_mesh:backend",
       "parallel/mesh.py:resolve_mesh_2d:backend",
       "parallel/mesh.py:shard_build_inputs:binned")
_allow("shard_map PartitionSpecs and jax sharding trees; the port's "
       "partition rules name the mesh axis of each array "
       "(parallel/partition.match_partition_rules, spec_for)",
       "parallel/partition.py:match_partition_rules:rules",
       "parallel/partition.py:spec_for:mesh", "parallel/partition.py:trim_spec",
       "parallel/partition.py:in_specs_for", "parallel/partition.py:out_specs_for",
       "parallel/partition.py:ingest_layout", "parallel/partition.py:sharding_tree",
       "parallel/partition.py:shard_build_state")
_allow("an XLA runtime error type for the chaos seams; the port injects "
       "real torch types with CUDA/NCCL text (resilience/chaos.py)",
       "resilience/chaos.py:ChaosXlaError")
_allow("no caller in either package passes it; the rungs read "
       "ResilienceConfig.from_env()",
       "resilience/retry.py:retry_device:config",
       "resilience/retry.py:device_failover:config")
_allow("the port's quantized tier takes its QuantizedState and the "
       "boosting baseline (state=, baseline=) and launches K5; JAX's "
       "traced program takes the columns and a donated accumulator",
       *(f"serving/quantize.py:q_traverse_accumulate:{p}" for p in (
           "feature", "threshold", "left", "right", "root", "acc0", "qvals",
           "vscale", "vbase")))
_allow("jit dispatch through the XLA compile registry with donated "
       "buffers; the port's CompiledModel launches its kernel or plain "
       "version directly (serving/model.CompiledModel._compute)",
       "serving/quantize.py:dispatch", "serving/traversal.py:dispatch")
_allow("a donated accumulator of the traced program; the port starts from "
       "the boosting baseline (baseline=)",
       "serving/traversal.py:traverse_accumulate:acc0")
_allow("renamed in the port for what it holds: leaf_ids (JAX's docstring "
       "says per-sample leaf ids)",
       "utils/export.py:tree_decision_path:X_binned_ids")
_allow("checks inside a shard_map program over a named axis; the port's "
       "check fingerprints one tensor and compares it over a Mesh "
       "(replication_fingerprint(t), assert_replicated(t, mesh))",
       "utils/profiling.py:replication_fingerprint:arrays",
       "utils/profiling.py:assert_replicated:fingerprint",
       "utils/profiling.py:assert_replicated:axis")

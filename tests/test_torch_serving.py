"""The port's serving stack on the CPU against the JAX package.

One small JAX forest (``covtype_like(4_000, seed=0)``, 4 trees, depth 5)
is carried over to the port (``from_reference``), so both sides serve the
same trees. Tolerances:

- tables, leaf ids, the float64 plain tier and compiled ``raw`` are equal
  bit for bit: the port reduces in float64 in member order, as the JAX CPU
  tier does under ``enable_x64``;
- the kernel's plain version against the Pallas kernel in interpret mode:
  ``rtol=atol=1e-6``, because the Pallas kernel sums in float32 and the
  port in float64;
- quantization: the int8 affine, the bfloat16 threshold bits, the
  calibration batch, the exactness report and the integer lattice sums
  are equal exactly; the dequantized result is within ``atol=1e-6`` of
  the JAX quantized tier (both float32, different operation order).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from mpitree_tpu_torch.serving import (  # noqa: E402
    ModelRegistry,
    QuantizationError,
    compile_model,
    quantize,
    serve_kernel,
    traversal,
)
from mpitree_tpu_torch.serving.tables import tables_for  # noqa: E402
from mpitree_tpu_torch.tree import (  # noqa: E402
    DecisionTreeClassifier,
    RandomForestClassifier,
)
from mpitree_tpu_torch.utils.datasets import covtype_like  # noqa: E402

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def pair():
    """(X query rows, JAX forest, the port's copy of it, both tables)."""
    from mpitree_tpu.serving.tables import tables_for as jax_tables_for
    from mpitree_tpu.tree import RandomForestClassifier as JaxForest

    X, y = covtype_like(4_000, seed=0)
    jax_f = JaxForest(n_estimators=4, max_depth=5, random_state=0,
                      backend="cpu", refine_depth=None).fit(X, y)
    port = RandomForestClassifier.from_reference(
        [dataclasses.asdict(t) for t in jax_f.trees_], jax_f.classes_,
        jax_f.n_features_, device="cpu",
    )
    [jt] = jax_tables_for(jax_f.trees_, group_bytes=None)
    [pt] = tables_for(port.trees_, group_bytes=None)
    Xq, _ = covtype_like(600, seed=1)
    return Xq, jax_f, port, jt, pt


def _jax_cols(jt):
    return [np.asarray(a) for a in (jt.feature, jt.threshold, jt.left,
                                    jt.right, jt.root)]


def _port_cols(pt):
    return pt.dev_arrays(CPU)[:5]


def _depth_packed(trees, table, fn):
    flat = np.concatenate([np.asarray(fn(t)).reshape(t.n_nodes, -1)
                           for t in trees])
    return np.ascontiguousarray(flat[table.scatter_order()])


def test_node_table_equals_jax(pair):
    *_, jt, pt = pair
    for k in ("feature", "threshold", "left", "right", "orig", "root",
              "level_off"):
        a, b = getattr(pt, k), getattr(jt, k)
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    assert pt.n_steps == jt.n_steps
    np.testing.assert_array_equal(pt.scatter_order(), jt.scatter_order())


def test_flat_leaf_ids_equal_jax(pair):
    from mpitree_tpu.serving.traversal import flat_leaf_ids as jax_ids

    Xq, _, _, jt, pt = pair
    want = jax_ids(Xq, *_jax_cols(jt), np.asarray(jt.orig),
                   n_steps=jt.n_steps)
    got = traversal.flat_leaf_ids(torch.from_numpy(Xq), *pt.dev_arrays(CPU),
                                  n_steps=pt.n_steps)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _kind_inputs(kind, trees, table):
    """(values (M, K) float64, baseline or None) for an accumulate kind."""
    rng = np.random.default_rng(len(kind))
    M = table.n_nodes
    if kind == "forest_proba":
        return _depth_packed(trees, table, lambda t: t.count).astype(
            np.float64), None
    if kind == "forest_mean":
        return rng.standard_normal((M, 1)), None
    if kind == "margin":
        return rng.standard_normal((M, 1)), rng.standard_normal(2)
    return rng.standard_normal((M, 3)), None  # forest_values


@pytest.mark.parametrize("kind", traversal.ACC_AGG)
def test_traverse_accumulate_bit_identical_to_jax(pair, kind):
    from mpitree_tpu.serving.traversal import traverse_accumulate as jax_acc

    Xq, jax_f, _, jt, pt = pair
    values, baseline = _kind_inputs(kind, jax_f.trees_, jt)
    T = jt.n_trees
    n_out = values.shape[1] if baseline is None else len(baseline)
    acc0 = (np.zeros((len(Xq), n_out)) if baseline is None
            else np.tile(baseline, (len(Xq), 1)))
    with jax.enable_x64(True):
        want = np.asarray(jax_acc(
            Xq, *_jax_cols(jt), jax.device_put(acc0),
            jax.device_put(values), jax.device_put(np.float64(T)),
            kind=kind, n_steps=jt.n_steps,
        ))
    got = traversal.traverse_accumulate(
        torch.from_numpy(Xq), *_port_cols(pt), torch.from_numpy(values),
        float(T), kind=kind, n_steps=pt.n_steps,
        baseline=None if baseline is None else torch.from_numpy(baseline),
    )
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kind", traversal.GATHER_KINDS)
def test_traverse_gather_equal_jax(pair, kind):
    from mpitree_tpu.serving.tables import tables_for as jax_tables_for
    from mpitree_tpu.serving.traversal import traverse_gather as jax_gather

    Xq, jax_f, *_ = pair
    tree = jax_f.trees_[0]
    [jt1] = jax_tables_for([tree], group_bytes=None)
    [pt1] = tables_for([tree], group_bytes=None)
    values = (_depth_packed([tree], jt1, lambda t: t.count).astype(np.int32)
              if kind == "gather_counts"
              else np.random.default_rng(3).standard_normal((jt1.n_nodes, 1)))
    with jax.enable_x64(True):
        want = np.asarray(jax_gather(Xq, *_jax_cols(jt1),
                                     jax.device_put(values), kind=kind,
                                     n_steps=jt1.n_steps))
    got = traversal.traverse_gather(
        torch.from_numpy(Xq), *_port_cols(pt1), torch.from_numpy(values),
        kind=kind, n_steps=pt1.n_steps,
    ).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("agg", ["norm", "sum", "percls"])
def test_kernel_plain_version_matches_pallas_interpret(pair, agg):
    """K4's plain version on the flat table against the Pallas kernel on
    its stacked tables, set up as ``tests/test_serving.py`` does."""
    from mpitree_tpu.serving import pallas_serve

    Xq, jax_f, _, jt, pt = pair
    trees = list(jax_f.trees_)
    C = len(jax_f.classes_)
    X = Xq[:96]
    if agg == "norm":
        n_out, kv, fn = C, C, lambda t: np.asarray(t.count, np.float32)
    elif agg == "percls":
        n_out, kv, fn = 2, 1, lambda t: np.asarray(t.count[:, 0],
                                                   np.float32)
    else:
        n_out, kv, fn = 1, 1, lambda t: np.asarray(t.n_node_samples,
                                                   np.float32)
    tbl, _ = pallas_serve.build_kernel_tables(trees)
    vals = pallas_serve.build_kernel_values(trees, fn, kv)
    want = np.asarray(pallas_serve.traverse_batch_pallas(
        X, tbl, vals, n_steps=jt.n_steps, agg=agg, n_out=n_out, kv=kv,
        row_tile=32, interpret=True,
    ))
    values = torch.from_numpy(_depth_packed(trees, jt, fn).astype(
        np.float64))
    got = serve_kernel.traverse(
        torch.from_numpy(X), *_port_cols(pt), values, n_steps=pt.n_steps,
        agg=agg, n_out=n_out, n_features=X.shape[1],
    )
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n", [1, 37, 5_000])
def test_compiled_forest_raw_bit_identical_to_jax(pair, n):
    from mpitree_tpu.serving import compile_model as jax_compile

    Xq, jax_f, port, *_ = pair
    X = np.concatenate([Xq] * 9)[:n]
    cm = compile_model(port)
    assert cm.exact and cm.dispatch == "plain version of traverse"
    want = jax_compile(jax_f).raw(X)
    got = cm.raw(X)
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, port.predict_proba(X))
    np.testing.assert_array_equal(cm.predict(X), jax_f.predict(X))
    rep = cm.serve_report_
    assert rep["requests"] == 2 and rep["rows"] == 2 * n


def test_compiled_tree_serves_its_raw_counts(pair):
    """A single tree (the JAX forest's first member, carried over) is a
    plain int32 gather: its raw leaf counts, as ``predict_proba`` gives
    them and the JAX gather tier serves them (``test_traverse_gather``)."""
    Xq, jax_f, *_ = pair
    tree = DecisionTreeClassifier.from_reference(
        dataclasses.asdict(jax_f.trees_[0]), jax_f.classes_, 54,
        device="cpu",
    )
    cm = compile_model(tree, quantize="int8")
    # an integer channel is exact and minimal already: never quantized
    assert cm.quantize is None and cm.exact
    assert cm.dispatch == "plain gather"
    got = cm.raw(Xq[:70])
    assert got.dtype == np.int32
    np.testing.assert_array_equal(cm.predict_proba(Xq[:70]),
                                  tree.predict_proba(Xq[:70]))
    np.testing.assert_array_equal(got, tree.predict_proba(Xq[:70]))
    np.testing.assert_array_equal(cm.predict(Xq[:70]), tree.predict(Xq[:70]))


# ---------------------------------------------------------------------------
# quantization
# ---------------------------------------------------------------------------

def _prepared(trees, table):
    counts = _depth_packed(trees, table, lambda t: t.count)
    return quantize.prepare_channel("forest_proba", counts)


def test_affine_int8_equal_jax(pair):
    from mpitree_tpu.serving import quantize as jq

    _, jax_f, _, jt, _ = pair
    rng = np.random.default_rng(7)
    for prep in (_prepared(jax_f.trees_, jt),
                 np.concatenate([rng.normal(scale=4.0, size=(200, 3)),
                                 np.full((8, 3), 2.5)])):
        prep = prep.copy()
        prep[:, -1] = 1.25  # a constant channel
        for got, want in zip(quantize.affine_int8(prep),
                             jq.affine_int8(prep), strict=True):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
        q, s, b = quantize.affine_int8(prep)
        np.testing.assert_array_equal(quantize.dequantize(q, s, b),
                                      jq.dequantize(q, s, b))
    assert quantize.prepare_channel("forest_proba", prep).tolist() == \
        jq.prepare_channel("forest_proba", prep).tolist()


def test_quantize_thresholds_bits_equal_jax(pair):
    from mpitree_tpu.serving import quantize as jq

    *_, jt, _ = pair
    rng = np.random.default_rng(11)
    edge = np.array([0.0, -0.0, 1.0, -1.0, 1e-40, -1e-40, 3e38, -3e38,
                     2800.5, -2800.5, 1.00390625, 1.005859375, np.nan],
                    np.float32)
    for thr in (jt.threshold, edge,
                rng.standard_normal(5_000).astype(np.float32) * 1e3):
        got = quantize.quantize_thresholds(thr)
        assert got.dtype == torch.bfloat16
        want = np.asarray(jq.quantize_thresholds(thr)).view(np.uint16)
        np.testing.assert_array_equal(
            got.view(torch.int16).numpy().view(np.uint16), want)


def test_calibration_and_exactness_report_equal_jax(pair):
    from mpitree_tpu.serving import quantize as jq

    _, jax_f, _, jt, pt = pair
    np.testing.assert_array_equal(
        quantize.synthesize_calibration(pt, 54),
        jq.synthesize_calibration(jt, 54))
    prep = _prepared(jax_f.trees_, jt)
    quant = jq.affine_int8(prep)
    kw = dict(kind="forest_proba", scale=4.0, n_steps=jt.n_steps, tol=1e-2,
              n_features=54)
    assert quantize.exactness_report(pt, prep, quant, **kw) == \
        jq.exactness_report(jt, prep, quant, **kw)
    Xc = covtype_like(300, seed=9)[0]
    assert quantize.exactness_report(pt, prep, quant, calibration=Xc,
                                     **kw) == \
        jq.exactness_report(jt, prep, quant, calibration=Xc, **kw)


@pytest.mark.parametrize("agg", ["sum", "percls"])
def test_quantized_plain_qsum_equals_pallas_interpret(pair, agg):
    from mpitree_tpu.serving import compile_model as jax_compile
    from mpitree_tpu.serving import pallas_serve

    Xq, jax_f, port, *_ = pair
    X = Xq[:64]
    jcm = jax_compile(jax_f, quantize="int8", buckets=(64,))
    trees = jcm.trees
    n_out = jcm.n_out if agg == "sum" else 3
    tbl, _ = pallas_serve.build_kernel_tables_quantized(trees)
    per = jcm._quant.q_rows_per_tree(trees, jcm.table)
    vals = pallas_serve.build_kernel_values(trees, lambda t: per[id(t)],
                                            jcm.n_out, dtype=np.int8)
    want = np.asarray(pallas_serve.traverse_batch_pallas(
        X, tbl, vals, n_steps=jcm.table.n_steps, agg=agg, n_out=n_out,
        kv=jcm.n_out, row_tile=64, interpret=True, quantized=True,
    ))
    state = compile_model(port, quantize="int8")._quant
    got = serve_kernel.traverse_q(
        torch.from_numpy(X), state.feature, state.threshold, state.left,
        state.right, state.root, state.qvals, n_steps=jcm.table.n_steps,
        agg=agg, n_out=n_out, n_features=54,
    )
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_quantized_raw_close_to_jax(pair):
    from mpitree_tpu.serving import compile_model as jax_compile

    Xq, jax_f, port, *_ = pair
    cm = compile_model(port, quantize="int8")
    jcm = jax_compile(jax_f, quantize="int8")
    assert not cm.exact and cm.dispatch == "plain version of traverse_q"
    assert cm.serve_report_["quantization"] == \
        jcm.serve_report_["quantization"]
    got = cm.raw(Xq)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, jcm.raw(Xq), rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# registry, devices, refusals
# ---------------------------------------------------------------------------

def test_registry_publish_swap_and_refusal(pair):
    Xq, _, port, *_ = pair
    reg = ModelRegistry(buckets=(1, 64))
    m = reg.publish("rf", port)
    assert m.serve_report_["requests"] == 2  # the warm-up of each bucket
    before = reg.predict_proba("rf", Xq[:8])
    np.testing.assert_array_equal(before, port.predict_proba(Xq[:8]))
    np.testing.assert_array_equal(reg.predict("rf", Xq[:8]),
                                  port.predict(Xq[:8]))
    with pytest.raises(QuantizationError) as err:
        reg.publish("rf", port, quantize="int8", quantize_tol=1e-12)
    assert not err.value.report["ok"]
    # refused before the swap: generation 1 still serves
    assert reg.models()["rf"]["generation"] == 1
    assert reg.get("rf") is m
    reg.publish("rf", port, quantize="int8")
    assert reg.models()["rf"]["generation"] == 2
    assert reg.get("rf").quantize == "int8"
    np.testing.assert_allclose(reg.raw("rf", Xq[:8]), before, atol=0.3)
    reg.drop("rf")
    with pytest.raises(KeyError, match="no model"):
        reg.get("rf")


def test_registry_concurrent_requests_and_swap(pair):
    """16 threads answer through one slot while it is swapped: every
    answer is right, no request count is lost, the swap lands once."""
    import sys
    import threading

    Xq, _, port, *_ = pair
    reg = ModelRegistry(buckets=(1, 64))
    first = reg.publish("rf", port)
    want = port.predict_proba(Xq[:4])
    errors = []

    def worker():
        try:
            for _ in range(10):
                if not np.array_equal(reg.predict_proba("rf", Xq[:4]), want):
                    errors.append("wrong answer")
        except Exception as e:  # noqa: BLE001 — reported by the assert
            errors.append(repr(e))

    threads = [threading.Thread(target=worker) for _ in range(16)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        second = reg.publish("rf", port)
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    assert reg.get("rf") is second and reg.models()["rf"]["generation"] == 2
    # every worker request plus each model's warm-up of its two buckets
    served = (first.serve_report_["requests"]
              + second.serve_report_["requests"])
    assert served == 16 * 10 + 2 * 2


def test_compile_model_device_and_type(pair, monkeypatch):
    _, jax_f, port, *_ = pair
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    default = RandomForestClassifier.from_reference(
        [dataclasses.asdict(t) for t in jax_f.trees_], jax_f.classes_, 54)
    with pytest.raises(RuntimeError, match="CUDA"):
        compile_model(default)
    with pytest.raises(TypeError, match="unsupported"):
        compile_model(object())
    with pytest.raises(ValueError, match="unknown serving quantize"):
        compile_model(port, quantize="int4")


def test_kernel_wrappers_refuse_bad_inputs_on_cpu(pair):
    Xq, *_, pt = pair
    cols = _port_cols(pt)
    values = torch.ones((pt.n_nodes, 7), dtype=torch.float64)
    X = torch.from_numpy(Xq)
    kw = dict(n_steps=pt.n_steps, agg="sum", n_out=7)
    with pytest.raises(ValueError, match="features"):
        serve_kernel.traverse(X, *cols, values, n_features=53, **kw)
    with pytest.raises(ValueError, match="float64"):
        serve_kernel.traverse(X, *cols, values.float(), n_features=54, **kw)
    with pytest.raises(ValueError, match="mode"):
        serve_kernel.traverse_q(X, *cols, values, n_features=54,
                                n_steps=1, agg="norm", n_out=7)

"""The harness's files, its data and its result line, on the CPU."""

from __future__ import annotations

import hashlib
import importlib
import json
import re
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from h100_bench import harness
from h100_bench.data import covtype_like as covtype
from h100_bench.run import FORBIDDEN, result_line
from h100_bench.tests._small import SEED, SMALL

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = harness.benchmark()


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_generator_is_deterministic_by_seed():
    a = covtype.covtype_like(3000, SEED)
    b = covtype.covtype_like(3000, SEED)
    c = covtype.covtype_like(3000, SEED + 1)
    assert all(np.array_equal(u, v) for u, v in zip(a, b))
    assert not np.array_equal(a[0], c[0])
    assert a[0].shape == (3000, 54) and a[0].dtype == np.float32
    assert set(np.unique(a[1])) <= set(range(7))
    yb = covtype.binary_top(a[1])
    assert set(np.unique(yb)) == {0, 1}
    assert yb.sum() == (a[1] == np.bincount(a[1]).argmax()).sum()


def test_negative_and_large_seeds_make_data():
    for s in (-7, 2**40 + 3):
        X, y = covtype.covtype_like(100, s)
        assert X.shape == (100, 54) and len(y) == 100


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_is_found_by_name(cell):
    spec, cfg, traffic = harness.cell_spec(cell)
    assert spec["chips"] == 1
    assert cfg["name"] == spec["config"]
    entry = next(c for c in BENCH["configs"] if c["name"] == cfg["name"])
    assert entry["file"] == f"h100_bench/configs/{cfg['name']}.json"
    assert entry["reduced"] == cfg["reduced"]
    check = harness.find("checks", cfg["check"])
    assert set(check.LIMITS) and all(
        callable(getattr(check, f)) for f in ("outputs", "reference",
                                              "numbers"))
    assert callable(harness.find("data", cfg["data"]["generator"]).make)
    assert callable(harness.find("loops", traffic["loop"]).window)
    assert traffic["profile_fits"] >= 1
    reported = {m["name"] for m in harness.per_layer(cell)}
    assert reported, "every cell reports a per-layer metric"


@pytest.mark.parametrize("name", ["../x", "a/b", "", "a..b", "a."])
def test_find_refuses_what_is_no_name(name):
    with pytest.raises(ValueError):
        harness.find("checks", name)


def test_tree_check_class_weights():
    tree = harness.find("checks", "tree")
    y = np.array([0, 0, 0, 1, 2, 2])
    assert tree.class_weights({}, y) is None
    w = tree.class_weights({"class_weight": "balanced"}, y)
    np.testing.assert_array_equal(
        w, np.float32([6 / 9, 6 / 3, 6 / 6]).astype(np.float64))
    with pytest.raises(ValueError):
        tree.class_weights({"class_weight": {0: 2.0}}, y)


def _sha(root):
    return {p.relative_to(root).as_posix(): hashlib.sha256(
        p.read_bytes()).hexdigest() for p in sorted(root.rglob("*"))
        if p.is_file() and "__pycache__" not in p.parts}


TOY = {
    "data/toy_blobs.py": """
        import numpy as np

        def make(data, seed):
            rng = np.random.default_rng(int(data["seed"]))
            X = rng.normal(size=(int(data["rows"]), 4)).astype(np.float32)
            y = rng.integers(0, 2, int(data["rows"]))
            order = np.random.default_rng(int(seed)).permutation(len(y))
            return X[order], y[order]
        """,
    "checks/toy_depth.py": """
        import numpy as np

        LIMITS = {"depth_gap": 0}

        def outputs(est):
            return {"depth": np.asarray([np.asarray(est.tree_.depth).max()])}

        def reference(params, X, y, device, *, control=False):
            return {"depth": np.asarray([params["max_depth"] - control])}

        def numbers(got, want):
            return {"depth_gap": float(abs(got["depth"] - want["depth"])[0])}
        """,
    "loops/fixed_calls.py": """
        import time

        def window(s, traffic, *, seconds, trace):
            t0 = time.monotonic()
            outs, walls = [], []
            for _ in range(int(traffic["calls"])):
                a = time.monotonic()
                est = s.call()
                walls.append(time.monotonic() - a)
                outs.append(s.outputs(est))
            return {"t0": t0, "window_s": time.monotonic() - t0,
                    "outs": outs, "walls": walls, "profiled": [],
                    "prof": None, "metrics": {"fit_s": sum(walls) / 3}}
        """,
    "configs/toy.json": """
        {"name": "toy", "source": "none", "reduced": [], "assumed": {},
         "estimator": "DecisionTreeClassifier",
         "params": {"max_depth": 3},
         "data": {"generator": "toy_blobs", "seed": 5, "rows": 400},
         "check": "toy_depth"}
        """,
    "traffic/three_calls.json": """
        {"loop": "fixed_calls", "call": "fit", "calls": 3,
         "estimator_params": {}}
        """,
}


def test_a_new_check_generator_and_loop_are_new_files_only(tmp_path):
    """A cell with a check, a data generator and a loop of its own runs
    from files added beside a copy of the harness, no file of it
    edited."""
    bench = tmp_path / "h100_bench"
    shutil.copytree(harness.HERE, bench,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _sha(bench)
    for rel, text in TOY.items():
        (bench / rel).write_text(textwrap.dedent(text))
    b = dict(BENCH)
    b["configs"] = BENCH["configs"] + [{
        "name": "toy", "source": "none", "file": "h100_bench/configs/toy.json",
        "reduced": [], "why": "a throwaway"}]
    b["workloads"] = BENCH["workloads"] + [{
        "name": "toy.three", "config": "toy", "traffic": "three_calls",
        "chips": 1, "why": "a throwaway"}]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    code = (
        "import json, sys; sys.path[:0] = [sys.argv[1], sys.argv[2]];"
        "from h100_bench import harness;"
        "assert harness.ROOT.as_posix() == sys.argv[1], harness.ROOT;"
        "r = harness.run_cell('toy.three', seed=11, seconds=0, trace=False,"
        " device='cpu');"
        "print(json.dumps({k: r[k] for k in ('correct', 'attempted',"
        " 'failed', 'check')} | {'metrics': sorted(r['metrics'])}))")
    out = subprocess.run(
        [sys.executable, "-c", code, str(tmp_path.resolve()),
         str(harness.ROOT)], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res == {"correct": True, "attempted": 3, "failed": 0,
                   "check": {"depth_gap": {"value": 0.0, "limit": 0}},
                   "metrics": ["fit_s", "peak_gib", "setup_s"]}
    after = _sha(bench)
    assert {k: after[k] for k in before} == before
    assert set(after) - set(before) == set(TOY)


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_every_metric_has_its_reader(metric):
    m = next(x for x in BENCH["per_layer"] if x["name"] == metric)
    mod = importlib.import_module(f"h100_bench.metrics.{metric}")
    assert (mod.LAYER, mod.UNIT, mod.SOURCE, mod.MOVES) == (
        m["layer"], m["unit"], m["source"], m["moves"])
    assert callable(mod.read)


def test_benchmark_names_units_and_budget():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert all(NAME.match(n) for n in names)
    assert len(names) == len(set(names))
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    # a full check with 24 cells fits its 43,200 seconds
    rs = BENCH["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 180 + 1200 <= 43200
    assert BENCH["command"] == ["python3", "h100_bench/run.py"]
    assert BENCH["paths"] == ["h100_bench"]


def test_nothing_loads_jax_or_the_jax_package():
    code = (
        "import sys; sys.path.insert(0, '.');"
        "import mpitree_tpu_torch.tree;"
        "from h100_bench.run import forbidden_modules;"
        "import glob, importlib;"
        "[importlib.import_module(p[:-3].replace('/', '.'))"
        " for p in glob.glob('h100_bench/**/*.py', recursive=True)"
        " if '/tests/' not in p and not p.endswith('__init__.py')];"
        "print(forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=harness.ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
    assert set(FORBIDDEN) == {"jax", "jaxlib", "flax", "mpitree_tpu"}


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_keys(trace):
    res = harness.run_cell("covtype_tree.fit", seed=SEED, seconds=0.0,
                           trace=trace, device="cpu",
                           overrides=SMALL["covtype_tree.fit"])
    device = {"platform": "gpu", "kind": "test", "count": 1,
              "memory_peak_bytes": res["peak_bytes"]}
    line = result_line(res, device, trace=trace)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    keys += ["breakdown", "check"] if trace else ["check"]
    assert list(line) == keys
    assert line["correct"] is True and line["failed"] == 0
    assert json.loads(json.dumps(line)) == line
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(line["metrics"]) == {"fit_s", "peak_gib", "setup_s"}
    assert all(set(v) == {"value", "limit"} for v in line["check"].values())


@pytest.mark.cuda
def test_a_short_run_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "h100_bench/run.py", "--workload",
         "covtype_tree.fit", "--seed", str(SEED), "--seconds", "2",
         "--trace", "0"], capture_output=True, text=True,
        cwd=harness.ROOT, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["device"]["platform"] == "gpu"

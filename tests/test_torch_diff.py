"""The port's record diffing (``mpitree_tpu_torch/obs/diff.py``) and its
CLI (``python -m mpitree_tpu_torch.obs.benchdiff``) against the JAX
package's (``mpitree_tpu/obs/diff.py``, ``tools/benchdiff.py``).

- the constants, metric classes and thresholds equal JAX's;
- ``diff_envelopes``, ``diff_payloads``, ``exit_code``, ``summary_line``
  and ``format_diff`` of both packages give equal results on the same
  inputs (clean, slowed, structural changes, improvements, accuracy
  floors, history dispersion, divergence with and without rows);
- the sentinel from end to end on port fits (the JAX test at
  ``tests/test_obs_flight.py:281``): the clean twin diffs green, a
  slowed twin regresses naming ``wall_s``, a chaos-skewed twin diverges
  at the skewed round;
- ``localize_divergence`` on two port fits names the (tree, level,
  channel) the JAX package's names on its own fits of the same data;
- the CLI's modes and exit codes: injected regressions exit 1, clean
  and improved 0, usage errors 2, cross-platform always advisory (0, or
  2 without a sibling), and the same diff as ``tools/benchdiff.py``.
"""

from __future__ import annotations

import copy
import json
import os

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import mpitree_tpu as J  # noqa: E402
from mpitree_tpu.obs import diff as jax_diff  # noqa: E402
from mpitree_tpu.obs import flight as jax_flight  # noqa: E402
from tools import benchdiff as jax_benchdiff  # noqa: E402

import mpitree_tpu_torch as P  # noqa: E402
from mpitree_tpu_torch.obs import benchdiff  # noqa: E402
from mpitree_tpu_torch.obs import diff  # noqa: E402
from mpitree_tpu_torch.obs import flight  # noqa: E402
from mpitree_tpu_torch.resilience import chaos  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread for this module's fits."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_constants_and_metric_classes_equal_jax():
    assert diff.CHANNELS == jax_diff.CHANNELS
    assert (diff.NOISE_Z, diff.MIN_HISTORY, diff.DIFF_SCHEMA) == (
        jax_diff.NOISE_Z, jax_diff.MIN_HISTORY, jax_diff.DIFF_SCHEMA)
    assert diff.METRIC_SPECS == jax_diff.METRIC_SPECS
    assert diff._SUFFIX_SPECS == jax_diff._SUFFIX_SPECS
    assert diff._SKIP_KEYS == jax_diff._SKIP_KEYS
    for m in ("wall_s", "p50_ms", "b64_p99_ms", "sustained_rows_per_s",
              "test_acc", "wire_bytes", "tree_n_nodes", "engine", "x"):
        assert diff.spec_for(m) == jax_diff.spec_for(m), m


HIST = [{"digest": {"wall_s": w}} for w in (1.0, 1.3, 0.8, 1.25, 0.9)]


@pytest.mark.parametrize("metric, history", [
    ("wall_s", None), ("wall_s", HIST[:2]), ("wall_s", HIST),
    ("test_acc", HIST), ("psum_bytes", HIST), ("p99_ms", HIST)])
def test_threshold_for_equals_jax(metric, history):
    spec = diff.spec_for(metric)
    assert diff.threshold_for(metric, spec, history) == \
        jax_diff.threshold_for(metric, spec, history)


def _row(level, **kw):
    return {"level": level, "nodes": 1, "hist": "a", "winner": "b",
            "alloc": "c", **kw}


FP_A = {"trees": [[_row(0), _row(1)], [_row(0)]]}
FP_B = {"trees": [[_row(0), _row(1, winner="Y", alloc="Z")], [_row(0)]]}

CASES = {
    "clean": ({"digest": {"wall_s": 1.0, "n_nodes": 31}},
              {"digest": {"wall_s": 1.05, "n_nodes": 31}}, None),
    "slow": ({"digest": {"wall_s": 1.0}}, {"digest": {"wall_s": 3.0}},
             None),
    "faster": ({"digest": {"wall_s": 3.0}}, {"digest": {"wall_s": 1.0}},
               None),
    "structural": ({"digest": {"n_nodes": 31, "psum_bytes": 10}},
                   {"digest": {"n_nodes": 33, "psum_bytes": 10}}, None),
    "more_bytes": ({"metrics": {"wire_bytes": 100}},
                   {"metrics": {"wire_bytes": 101}}, None),
    "accuracy": ({"metrics": {"test_acc": 0.80}},
                 {"metrics": {"test_acc": 0.79}}, None),
    "dispersed": ({"digest": {"wall_s": 1.0}}, {"digest": {"wall_s": 1.5}},
                  HIST),
    "diverged_rows": (
        {"digest": {"fingerprint": "aa"}, "record": {"fingerprints": FP_A}},
        {"digest": {"fingerprint": "bb"}, "record": {"fingerprints": FP_B}},
        None),
    "diverged_bare": ({"digest": {"fingerprint": "aa"}},
                      {"digest": {"fingerprint": "bb"}}, None),
}


@pytest.mark.parametrize("name", list(CASES))
def test_diff_envelopes_and_renderings_equal_jax(name):
    base, cand, hist = CASES[name]
    got = diff.diff_envelopes(base, cand, history=hist)
    want = jax_diff.diff_envelopes(base, cand, history=hist)
    assert got == want
    assert diff.exit_code(got) == jax_diff.exit_code(want)
    assert diff.summary_line(got, label="x") == \
        jax_diff.summary_line(want, label="x")
    for fmt in ("human", "github"):
        assert diff.format_diff(got, fmt) == jax_diff.format_diff(want, fmt)


def test_verdict_grammar():
    v = {n: diff.diff_envelopes(b, c, history=h)["verdict"]
         for n, (b, c, h) in CASES.items()}
    assert v == {"clean": "ok", "slow": "regression", "faster": "improved",
                 "structural": "changed", "more_bytes": "regression",
                 "accuracy": "regression", "dispersed": "ok",
                 "diverged_rows": "diverged", "diverged_bare": "diverged"}
    dv = diff.diff_envelopes(*CASES["diverged_rows"][:2])
    assert dv["fingerprint"]["divergence"] == {
        "tree": 0, "level": 1, "channel": "winner",
        "channels": ["winner", "alloc"]}


def _payload(**over):
    base = {"warm_s": 10.0, "test_acc": 0.75,
            "record": {"engine": "fused", "n_nodes": 100, "wall_s": 10.0,
                       "psum_bytes": 1000, "wire_bytes": 5000,
                       "fingerprint": "aa" * 8}}
    rec = over.pop("record", {})
    base.update(over)
    base["record"] = {**base["record"], **rec}
    return base


@pytest.mark.parametrize("over", [
    {}, {"warm_s": 30.0, "record": {"wall_s": 30.0}},
    {"record": {"wire_bytes": 9000}}, {"test_acc": 0.60},
    {"record": {"fingerprint": "bb" * 8}}])
def test_diff_payloads_equals_jax(over):
    hist = [_payload(), _payload(warm_s=10.5)]
    got = diff.diff_payloads(_payload(), _payload(**copy.deepcopy(over)),
                             history=hist)
    assert got == jax_diff.diff_payloads(
        _payload(), _payload(**copy.deepcopy(over)), history=hist)


def test_localize_divergence_equals_jax():
    for a, b in ((FP_A, FP_B), (FP_A, FP_A), ({"trees": [[_row(0)]]}, FP_A),
                 ({"trees": [[_row(0)]]}, {"trees": [[_row(1)]]}),
                 ({}, FP_A)):
        assert diff.localize_divergence(a, b) == \
            jax_diff.localize_divergence(a, b)


# -- the sentinel, end to end, on port fits ------------------------------------

def _gbdt(X, y):
    return P.GradientBoostingClassifier(
        max_iter=3, max_depth=3, max_bins=32, device="cpu").fit(X, y)


def test_sentinel_end_to_end_clean_slow_and_corrupt(tmp_path, monkeypatch):
    rng = np.random.default_rng(3)
    X = rng.standard_normal((2500, 8)).astype(np.float32)
    y = (X[:, 0] + 0.5 * X[:, 1] > 0).astype(np.int64)
    monkeypatch.setenv(flight.RUN_DIR_ENV, str(tmp_path))
    _gbdt(X, y)
    _gbdt(X, y)
    # round 2 (0-based 1) gets a finite skewed gradient payload: a valid
    # but different tree
    with chaos.active(chaos.Fault("grad_hess", 2, "skew", 4.0)):
        _gbdt(X, y)
    a, b, corrupt = flight.FlightStore(str(tmp_path)).entries(kind="fit")
    assert a["config_digest"] == corrupt["config_digest"]
    # the verdicts, not this host's timing, are under test: pin the one
    # noisy channel (the slowdown below is injected)
    for env, w in ((a, 1.0), (b, 1.02), (corrupt, 1.01)):
        env["digest"]["wall_s"] = w
    clean = diff.diff_envelopes(a, b, history=[a])
    assert clean["verdict"] in ("ok", "improved")
    assert clean["fingerprint"]["match"] is True
    assert diff.exit_code(clean) == 0
    slow = copy.deepcopy(b)
    slow["digest"]["wall_s"] = 4.06
    d_slow = diff.diff_envelopes(a, slow, history=[a, b])
    assert d_slow["verdict"] == "regression"
    assert "wall_s" in d_slow["regressions"]
    assert "wall_s" in diff.summary_line(d_slow)
    assert diff.exit_code(d_slow) == 1
    d_div = diff.diff_envelopes(b, corrupt, history=[a, b])
    assert d_div["verdict"] == "diverged"
    dv = d_div["fingerprint"]["divergence"]
    assert dv["tree"] == 1 and dv["level"] is not None
    assert dv["channel"] in ("hist", "winner", "alloc")
    assert diff.exit_code(d_div) == 1
    # the JAX package reads the port's envelopes to the same verdicts
    for args in ((a, b, [a]), (a, slow, [a, b]), (b, corrupt, [a, b])):
        assert jax_diff.diff_envelopes(*args[:2], history=args[2]) == \
            diff.diff_envelopes(*args[:2], history=args[2])


@pytest.fixture(scope="module")
def parted():
    """Two fits per package of one configuration on labels that differ
    in one slice of rows."""
    from mpitree_tpu_torch.utils.datasets import covtype_like

    X, y = covtype_like(3_000, seed=1)
    y2 = y.copy()
    sl = slice(1000, 1400)
    y2[sl] = np.where(y2[sl] == 1, 2, np.where(y2[sl] == 2, 1, y2[sl]))
    kw = dict(max_depth=6, refine_depth=None)
    port = [P.DecisionTreeClassifier(device="cpu", **kw).fit(X, t)
            for t in (y, y2)]
    ref = [J.DecisionTreeClassifier(backend="cpu", **kw).fit(X, t)
           for t in (y, y2)]
    return port, ref


def test_localize_divergence_on_port_fits_equals_jax(parted):
    port, ref = parted
    fp = [m.fit_report_["fingerprints"] for m in port]
    fj = [m.fit_report_["fingerprints"] for m in ref]
    got = diff.localize_divergence(*fp)
    assert got is not None and got["channel"] in diff.CHANNELS
    assert got == jax_diff.localize_divergence(*fj)
    assert diff.localize_divergence(fp[0], fp[0]) is None


# -- the CLI --------------------------------------------------------------------

def _jsonl(path, payloads, section="secX"):
    with open(path, "w") as f:
        for p in payloads:
            f.write(json.dumps({section: p}) + "\n")


@pytest.mark.parametrize("doctor, metric", [
    ({"warm_s": 30.0, "record": {"wall_s": 30.0}}, "warm_s"),
    ({"record": {"wire_bytes": 9000}}, "wire_bytes"),
    ({"test_acc": 0.60}, "test_acc"),
])
def test_cli_exits_1_on_an_injected_regression(tmp_path, capsys, doctor,
                                               metric):
    path = str(tmp_path / "bench.jsonl")
    _jsonl(path, [_payload(), _payload(**doctor)])
    assert benchdiff.main(["--jsonl", path, "--section", "secX"]) == 1
    out = capsys.readouterr().out
    assert "regression" in out and metric in out


def test_cli_clean_bench_and_usage_modes(tmp_path, capsys):
    path = str(tmp_path / "bench.jsonl")
    _jsonl(path, [_payload(), _payload(warm_s=10.4)])
    assert benchdiff.main(["--jsonl", path, "--section", "secX"]) == 0
    assert benchdiff.main(["--jsonl", path]) == 2
    assert benchdiff.main(["--jsonl", path, "--section", "nope"]) == 2
    assert benchdiff.main([]) == 2
    rounds = [{"parsed": None},
              {"parsed": {"value": 10.0, "detail": {"ours_test_acc": 0.74}}},
              {"parsed": {"value": 9.0, "detail": {"ours_test_acc": 0.74}}}]
    paths = []
    for i, doc in enumerate(rounds):
        p = str(tmp_path / f"r{i}.json")
        with open(p, "w") as f:
            json.dump(doc, f)
        paths.append(p)
    assert benchdiff.main(["--bench", *paths]) == 0  # improved
    assert benchdiff.main(["--bench", paths[0]]) == 2
    with open(paths[-1], "w") as f:
        json.dump({"parsed": {"value": 30.0,
                              "detail": {"ours_test_acc": 0.74}}}, f)
    capsys.readouterr()
    assert benchdiff.main(["--bench", *paths, "--format", "github"]) == 1
    assert "::error" in capsys.readouterr().out


def _xplat(platform, *, wire=2000, fp="aa", ts=1.0):
    return {"schema": 1, "kind": "fit", "section": None,
            "config_digest": "cfgA", "platform": platform, "ts": ts,
            "metrics": {"psum_bytes": 1000, "wire_bytes": wire,
                        "wall_s": 9.0 if platform == "cuda" else 90.0},
            "digest": {"n_nodes": 31, "fingerprint": fp, "wall_s": 9.0}}


def test_cli_store_and_cross_platform(tmp_path, capsys):
    rows = [_xplat("cpu", ts=1.0), _xplat("cpu", ts=2.0),
            _xplat("cuda", ts=3.0), _xplat("cuda", ts=4.0)]
    path = tmp_path / "flight.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in rows))
    # newest cuda envelope vs its cuda baseline
    assert benchdiff.main(["--store", str(tmp_path)]) == 0
    # vs its cpu sibling: structural only, walls never enter
    capsys.readouterr()
    assert benchdiff.main(["--store", str(tmp_path),
                           "--cross-platform", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "structural only" in out and "wall_s" not in out
    # a structural divergence across platforms warns, exit 0
    path.write_text(path.read_text() + json.dumps(
        _xplat("cuda", wire=9000, fp="bb", ts=5.0)) + "\n")
    assert benchdiff.main(["--store", str(tmp_path),
                           "--cross-platform", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "wire_bytes" in out and "advisory" in out
    # ...while the same-platform store diff gates on it
    assert benchdiff.main(["--store", str(tmp_path)]) == 1
    # no sibling on the named platform, or the candidate already there
    assert benchdiff.main(["--store", str(tmp_path),
                           "--cross-platform", "tpu"]) == 2
    assert benchdiff.main(["--store", str(tmp_path), "--platform", "cpu",
                           "--cross-platform", "cpu"]) == 2
    assert benchdiff.main(["--store", str(tmp_path / "empty")]) == 2


@pytest.mark.parametrize("mode", ["store", "cross", "jsonl"])
def test_cli_diff_equals_tools_benchdiff(tmp_path, capsys, mode):
    path = tmp_path / "flight.jsonl"
    rows = [_xplat("cpu", ts=1.0), _xplat("cuda", ts=2.0),
            _xplat("cuda", ts=3.0, wire=3000)]
    path.write_text("".join(json.dumps(r) + "\n" for r in rows))
    jl = str(tmp_path / "b.jsonl")
    _jsonl(jl, [_payload(), _payload(warm_s=20.0)])
    args = {"store": ["--store", str(tmp_path)],
            "cross": ["--store", str(tmp_path), "--cross-platform", "cpu"],
            "jsonl": ["--jsonl", jl, "--section", "secX"]}[mode]
    rcs, outs = [], []
    for cli in (benchdiff, jax_benchdiff):
        capsys.readouterr()
        rcs.append(cli.main([*args, "--json"]))
        outs.append(capsys.readouterr().out)
    assert rcs[0] == rcs[1]
    assert outs[0] == outs[1]


def test_cli_report_mode_bisects(parted, tmp_path):
    port, _ = parted
    pa, pb = str(tmp_path / "a.json"), str(tmp_path / "b.json")
    port[0].dump_report(pa)
    port[1].dump_report(pb)
    assert benchdiff.main([pa, pa]) == 0
    assert benchdiff.main([pa, pb]) == 1
    assert benchdiff.main([pa, str(tmp_path / "missing.json")]) == 2


def test_cli_runs_as_a_module(tmp_path):
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    rows = [_xplat("cpu", ts=1.0), _xplat("cpu", ts=2.0)]
    (tmp_path / "flight.jsonl").write_text(
        "".join(json.dumps(r) + "\n" for r in rows))
    r = subprocess.run(
        [sys.executable, "-m", "mpitree_tpu_torch.obs.benchdiff",
         "--store", str(tmp_path)],
        capture_output=True, text=True, cwd=root, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "verdict=ok" in r.stdout
    # the JAX package reads the same store to the same verdict
    assert jax_flight.FlightStore(str(tmp_path)).entries() == rows

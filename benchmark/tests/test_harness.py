"""The harness: parts found by name, the contract's last line, the
profile's arithmetic, no card, no JAX."""

import json
import os
import re
import shutil
import subprocess
import sys
import time

import pytest

from benchmark import profiles, run, spec
from benchmark.tests.conftest import ROOT, tiny

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_parts_found_by_name():
    for w in BENCH["workloads"]:
        assert spec.cell(w["name"], BENCH) is w
        assert spec.config(w["config"], BENCH)["name"] == w["config"]
        assert spec.traffic(w["traffic"])["call"]
    for m in BENCH["per_layer"]:
        assert callable(spec.metric_reader(m["name"]).read)
    assert set(spec.limits()) >= {"hist_bins_off", "unitigs_off", "bubbles_off", "model_gap"}


@pytest.mark.parametrize("lookup", [
    lambda: spec.cell("no.such", BENCH),
    lambda: spec.config("no_such", BENCH),
    lambda: spec.traffic("no_such"),
    lambda: spec.metric_reader("no_such"),
])
def test_unknown_name_fails(lookup):
    with pytest.raises(KeyError):
        lookup()


def test_benchmark_json_keeps_the_contract():
    b = BENCH
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    assert b["paths"] == ["benchmark"] and len(b["command"]) <= 32
    used = {w["config"] for w in b["workloads"]}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert c["file"].startswith("benchmark/") and os.path.exists(os.path.join(ROOT, c["file"]))
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
        assert all(NAME.match(r) for r in c["reduced"]) and len(c["reduced"]) <= 16
    pairs = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names)) and "setup_s" in names
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    cells = {w["name"] for w in b["workloads"]}
    for m in b["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in {e["name"] for e in b["end_to_end"]}
        assert set(m["workloads"]) <= cells and 1 <= len(m["layer"]) <= 200
    for w in cells:  # every cell reports set-up, another end-to-end and a per-layer metric
        assert len(spec.metrics_of(w, "end_to_end", b)) >= 2
        assert spec.metrics_of(w, "per_layer", b)
    assert len(json.dumps(b)) < 64 * 1024


def test_k1_bytes_equal_the_smoke_bound():
    """K1's bytes at bench5m's batch, [16384, 160] at k = 25, give the
    bound that chip_smoke.py's time_extract reports."""
    from ploidyfrost_tpu_torch.kmer.extract_bench import bound_ms

    B, L, k = 16384, 160, 25
    ms, by = bound_ms(B, L, k)
    assert by == "bytes"
    assert profiles.k1_bytes([(B, L, k)]) / profiles.HBM_BYTES_PER_S * 1e3 == pytest.approx(ms, rel=1e-12)


def events(k1=3, search=1, em=9):
    ev = [("extract_canonical_kernel(...)", 0.1 * i, 0.1 * i + 0.01) for i in range(k1)]
    ev += [("void superbubble_search<16>(...)", 1.0, 1.001)] * search
    ev += [("em_kernel(Fit, int)", 2.0 + i * 0.01, 2.0 + i * 0.01 + 0.002) for i in range(em)]
    ev += [("Memcpy HtoD (Pageable -> Device)", 0.05, 0.06)]
    return ev


def test_complete_profile_gives_roofline_and_idle():
    launched = {"K1": 3, "search": 1, "EM": 9, "NW": 0}
    stages = {"read": 0.5, "count": 0.5, "build_graph": 1.0, "sites": 1.0}
    p = profiles.reduce_events(events(), 3.0, stages, [(16384, 160, 25)] * 3, launched)
    assert p["complete"]
    assert p["busy_s"] == pytest.approx(0.03 + 0.01 + 0.001 + 0.018)
    assert p["idle_pct"] == pytest.approx(100 * (1 - p["busy_s"] / 3.0))
    assert p["k1_roofline_pct"] == pytest.approx(
        100 * profiles.k1_bytes([(16384, 160, 25)] * 3) / profiles.HBM_BYTES_PER_S / 0.03)
    assert len(p["breakdown"]["device_ops"]) <= 10 and len(p["breakdown"]["idle_gaps"]) <= 10
    run_ = {"profile": p, "stage_sums": {}, "calls": 1}
    assert spec.metric_reader("k1_roofline_pct").read(run_) == p["k1_roofline_pct"]


@pytest.mark.parametrize("short", ["K1", "search", "EM"])
def test_profile_missing_events_gives_no_metric(short):
    launched = {"K1": 3, "search": 1, "EM": 9, "NW": 0}
    kw = {"k1": 3, "search": 1, "em": 9}
    kw[{"K1": "k1", "search": "search", "EM": "em"}[short]] -= 1
    p = profiles.reduce_events(events(**kw), 3.0, {}, [(16384, 160, 25)] * 3, launched)
    assert not p["complete"]
    run_ = {"profile": p, "stage_sums": {}, "calls": 1}
    assert spec.metric_reader("k1_roofline_pct").read(run_) is None
    assert spec.metric_reader("device_idle_pct").read(run_) is None


def test_stage_readers_divide_by_calls():
    run_ = {"stage_sums": {"read": 3.0, "sites": 1.5}, "calls": 3, "profile": None}
    assert spec.metric_reader("read_s").read(run_) == 1.0
    assert spec.metric_reader("sites_s").read(run_) == 0.5
    assert spec.metric_reader("color_graph_s").read(run_) is None


def _cli(args, cwd, env=None):
    return subprocess.run([sys.executable, "-m", "benchmark.run", *args], cwd=cwd,
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, CUDA_VISIBLE_DEVICES="", **(env or {})))


def test_no_card_exits_nonzero_without_a_result():
    p = _cli(["--workload", "snj17.full", "--seed", "1", "--seconds", "1", "--trace", "0"], ROOT)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_benchmark_alone_exits_nonzero(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _cli(["--workload", "snj17.full", "--seed", "1", "--seconds", "1", "--trace", "0"],
             str(tmp_path))
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_last_line_keys(tmp_path):
    cell = spec.cell("snj17.full", BENCH)
    cfg = tiny(spec.config("snj17", BENCH))
    here = os.getcwd()
    try:
        r = run.run_cell(cell, cfg, spec.traffic("full"), 2**31 + 3, 0.0, False, "cpu",
                         time.time(), spec.limits(), BENCH, str(tmp_path), processes=1)
    finally:
        os.chdir(here)
    res = r["result"]
    assert list(res) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert res["correct"] is True and res["attempted"] == 1 and res["failed"] == 0
    assert set(res["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert {"setup_s", "call_s"} <= set(res["metrics"])
    for row in res["checks"].values():
        assert set(row) == {"value", "limit"}
    json.dumps(res, allow_nan=False)


SCRIPT = """
import os, sys, time, json
sys.path.insert(0, {root!r})
import benchmark.check, benchmark.control, benchmark.profiles
import benchmark.reference.kmers, benchmark.reference.graph
import benchmark.reference.gmm, benchmark.reference.sites
ref_only = sorted({{m.split(".")[0] for m in sys.modules}})
from benchmark import run, spec
b = spec.benchmark()
for m in b["per_layer"]:
    spec.metric_reader(m["name"])
cell = spec.cell("snj3.full", b)
cfg = dict(spec.config("snj3", b), genome_bp=20000)
wd = {wd!r}
r = run.run_cell(cell, cfg, spec.traffic("full"), 7, 0.0, True, "cpu", time.time(),
                 spec.limits(), b, wd, processes=1)
print(json.dumps([ref_only, sorted({{m.split(".")[0] for m in sys.modules}}), run.forbidden_modules()]))
"""


def test_nothing_imports_jax(tmp_path):
    """The harness with the reference and a whole traced run load the
    port (ploidyfrost_tpu_torch) but never jax, jaxlib, flax or the JAX
    package (ploidyfrost_tpu), compared by whole top-level names; the
    reference alone loads nothing of the port."""
    code = SCRIPT.format(root=ROOT, wd=str(tmp_path))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=600, cwd=str(tmp_path))
    assert p.returncode == 0, p.stderr[-3000:]
    ref_only, after, bad = json.loads(p.stdout.strip().splitlines()[-1])
    for name in ("jax", "jaxlib", "flax", "ploidyfrost_tpu"):
        assert name not in after
    assert "ploidyfrost_tpu_torch" in after and bad == []
    assert "ploidyfrost_tpu_torch" not in ref_only


def test_forbidden_names_compare_whole(monkeypatch):
    """`ploidyfrost_tpu_torch` begins with `ploidyfrost_tpu` and is allowed;
    a module under a forbidden top-level name is caught."""
    import types

    monkeypatch.setitem(sys.modules, "ploidyfrost_tpu_torch_probe.sub", types.ModuleType("p"))
    assert "ploidyfrost_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "ploidyfrost_tpu.probe", types.ModuleType("q"))
    monkeypatch.setitem(sys.modules, "jaxlib.probe", types.ModuleType("r"))
    assert {"ploidyfrost_tpu", "jaxlib"} <= set(run.forbidden_modules())

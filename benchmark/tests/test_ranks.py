"""The harness's rank path (benchmark/ranks.py) on the CPU: four gloo
ranks of the port's launcher, started once, every call on all of them.
The functions above the tests are hooks that `ranks.serve` runs in every
rank (`hook="benchmark.tests.test_ranks:<name>"`): they break the timed
path underneath, or plant a module, inside the ranks.

The four-card cell is not in BENCHMARK.json yet (PERF.md section 7):
`FOUR` is BENCHMARK.json with the cell's entries as a later change adds
them, and the rank path is held to it."""

import copy
import json
import os
import shutil
import subprocess
import sys
import time
import types

import numpy as np
import pytest
import torch

from benchmark import ranks, run, spec
from benchmark.tests.conftest import ROOT, tiny

BENCH = spec.benchmark()
CELL = {"name": "snj17.full.4card", "config": "snj17", "traffic": "full_ranks", "chips": 4,
        "why": "snj17's reads through pipeline --devices=4, the ranks started once"}
FINALIZE = {"name": "finalize_s", "unit": "s", "better": "lower", "source": "program_span",
            "layer": "counter on a group: finalize span (parallel/sharded.py)",
            "moves": "call_s", "workloads": [CELL["name"]]}
# on a group the table reaches rank 0's host in `finalize`, and one sample has no colors
NOT_ON_FOUR = ("graph_d2h_s", "color_graph_s")


def with_four_cards(bench: dict) -> dict:
    b = copy.deepcopy(bench)
    b["workloads"].append(CELL)
    for m in b["per_layer"]:
        if m["name"] not in NOT_ON_FOUR:
            m["workloads"].append(CELL["name"])
    b["per_layer"].append(FINALIZE)
    return b


FOUR = with_four_cards(BENCH)
HOOK = "benchmark.tests.test_ranks:"


def exchange_left_out(group):
    """The all_to_all left out: each rank merges the keys it counted."""
    from ploidyfrost_tpu_torch.kmer.pack import SENTINEL
    from ploidyfrost_tpu_torch.parallel import sharded

    def flush(self):
        if self._slots == 0:
            return
        keys = self._buf[: self._fill]
        self._tkm, self._tct = sharded._collapse(self._tkm, self._tct, keys[keys != SENTINEL],
                                                 self.counter_max)
        self._fill = self._slots = 0
        self._total_local += int(self._n_valid_dev)
        self._n_valid_dev.zero_()

    sharded.ShardedKmerCounter.flush = flush


def state_unchanged(group):
    """The counter's step returns its state unchanged, on every rank."""
    from ploidyfrost_tpu_torch.parallel import sharded

    sharded.ShardedKmerCounter.add_reads = lambda self, codes: None


def half_batch(group):
    """Half of every read batch left out, on every rank."""
    from ploidyfrost_tpu_torch.parallel import sharded

    add = sharded.ShardedKmerCounter.add_reads

    def half(self, codes):
        codes = torch.as_tensor(codes)
        return add(self, codes[: codes.shape[0] // 2])

    sharded.ShardedKmerCounter.add_reads = half


def count_altered(group):
    """One count of the table altered where rank 0 produces it."""
    from ploidyfrost_tpu_torch.parallel import sharded

    arrays = sharded.ShardedKmerCounter.arrays

    def altered(self):
        km, ct = arrays(self)
        ct = np.array(ct, copy=True)
        ct[len(ct) // 2] += 1
        return km, ct

    sharded.ShardedKmerCounter.arrays = altered


def planted_module(group):
    """Rank 2 loads a module under a forbidden top-level name."""
    if group.rank == 2:
        sys.modules["jaxlib"] = types.ModuleType("jaxlib")


def rank_dies(group):
    """Rank 2's process ends in the middle of the warm-up call."""
    if group.rank == 2:
        from ploidyfrost_tpu_torch import cli

        cli.cmd_pipeline = lambda *a, **kw: os._exit(7)


def rank_raises(group):
    """Rank 1's call fails while the others wait for it in a collective."""
    if group.rank == 1:
        from ploidyfrost_tpu_torch import cli

        def fails(*a, **kw):
            raise RuntimeError("planted")

        cli.cmd_pipeline = fails


def drive(tmp_path, trace=False, hook=None, cell_name=CELL["name"], seed=2**31 + 11):
    cell = spec.cell(cell_name, FOUR)
    cfg = tiny(spec.config(cell["config"], FOUR), 40_000)
    here = os.getcwd()
    try:
        return run.runner(cell)(cell, cfg, spec.traffic(cell["traffic"]), seed, 0.0, trace,
                                "cpu", time.time(), spec.limits(), FOUR, str(tmp_path),
                                processes=1, **({"hook": HOOK + hook} if hook else {}))
    finally:
        os.chdir(here)


def outputs(workdir):
    """Every file a call wrote, by its path under the run's directory."""
    files = {}
    for d, _, names in os.walk(workdir):
        rel = os.path.relpath(d, workdir)
        if rel.split(os.sep)[0] in ("reads", "warmup_reads"):
            continue
        for n in names:
            if not n.endswith(".log") and ".log." not in n:
                files[os.path.normpath(os.path.join(rel, n))] = os.path.join(d, n)
    return files


def children_gone(timeout_s=30.0):
    import multiprocessing

    end = time.monotonic() + timeout_s
    while multiprocessing.active_children() and time.monotonic() < end:
        time.sleep(0.2)
    return not multiprocessing.active_children()


@pytest.mark.parametrize("case", ["sound", "exchange_left_out"])
def test_four_ranks_sound_and_without_exchange(tmp_path, case):
    """Four ranks through the harness: correct, every per-layer metric of
    the cell read from rank 0 (on the CPU the device ones have nothing
    to read), and every output byte-identical to one rank's (the count
    table's arrays equal); with the exchange between ranks left out, not
    correct."""
    if case != "sound":
        assert_not_correct(tmp_path, case)
        return
    r = drive(tmp_path / "four", trace=True)
    res = r["result"]
    assert res["correct"] is True, res["checks"]
    assert res["device"]["count"] == 4 and res["attempted"] == 1 and res["failed"] == 0
    assert list(res) == ["correct", "attempted", "failed", "metrics", "device", "breakdown",
                         "checks"]
    want = {m["name"] for m in spec.metrics_of(CELL["name"], "per_layer", FOUR)}
    assert want - set(res["metrics"]) == {"device_idle_pct", "k1_roofline_pct"}
    assert res["metrics"]["finalize_s"]["value"] > 0
    assert set(r["info"]["rank_modules"]) == {0, 1, 2, 3}

    one = drive(tmp_path / "one", cell_name="snj17.full")
    assert one["result"]["correct"] is True
    a, b = outputs(tmp_path / "four"), outputs(tmp_path / "one")
    assert set(a) == set(b) and "out.gfa" in a and len(a) > 10
    for name in a:
        if name.endswith(".npz"):
            za, zb = np.load(a[name]), np.load(b[name])
            assert set(za.files) == set(zb.files)
            for key in za.files:
                assert np.array_equal(za[key], zb[key]), (name, key)
        else:
            with open(a[name], "rb") as fa, open(b[name], "rb") as fb:
                assert fa.read() == fb.read(), name


def assert_not_correct(tmp_path, hook):
    """The run with `hook` planted in every rank is not correct: its
    result says so, or the program fails under the fault and the run ends
    with RankFailure, every rank gone (the run then exits non-zero and
    prints no result)."""
    try:
        res = drive(tmp_path, hook=hook)["result"]
    except ranks.RankFailure:
        assert children_gone()
        return
    assert res["correct"] is False
    assert any(row["value"] > row["limit"] for row in res["checks"].values())
    assert {"call_s", "setup_s", "peak_device_GiB"} <= set(res["metrics"])


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "count_altered"])
def test_four_ranks_fault_is_not_correct(tmp_path, fault):
    """The other faults the four-card cell can have, planted in the ranks."""
    assert_not_correct(tmp_path, fault)


def test_rank_with_a_forbidden_module_exits_3(tmp_path, capsys):
    r = drive(tmp_path, hook="planted_module")
    assert "jaxlib" in r["info"]["rank_modules"][2]
    assert "jaxlib" not in run.forbidden_modules()
    capsys.readouterr()
    assert run.report(r) == 3
    out, err = capsys.readouterr()
    assert out == "" and "rank 2: jaxlib" in err


@pytest.mark.parametrize("hook", ["rank_dies", "rank_raises"])
def test_failed_rank_ends_the_run(tmp_path, monkeypatch, hook):
    """A rank that dies, or fails while the others wait for it in a
    collective, ends the run with RankFailure at once, every rank gone."""
    monkeypatch.setenv("PLOIDYFROST_TIMEOUT", "120")
    t = time.monotonic()
    with pytest.raises(ranks.RankFailure):
        drive(tmp_path, hook=hook)
    assert children_gone()
    assert time.monotonic() - t < 100


def test_plan_takes_the_cells_cards():
    plan = ranks.plan_for(CELL, spec.traffic("full_ranks"), "cpu")
    assert (plan.local, plan.world, plan.backend) == (4, 4, "gloo")
    with pytest.raises(ValueError):
        ranks.plan_for(dict(CELL, chips=2), spec.traffic("full_ranks"), "cpu")
    steps = ranks.steps_of(spec.traffic("full_ranks"), spec.config("snj17", BENCH), "out",
                           [["a_1.fq.gz", "a_2.fq.gz"]])
    assert steps == [("pipeline", ["-k", "25", "-o", "out", "a_1.fq.gz", "a_2.fq.gz"])]


def test_finalize_reader_reads_the_span():
    reader = spec.metric_reader("finalize_s")
    assert reader.read({"stage_sums": {"finalize": 3.0, "count": 5.0}, "calls": 4,
                        "profile": None}) == 0.75
    assert reader.read({"stage_sums": {"count": 5.0}, "calls": 4, "profile": None}) is None


def test_no_four_cards_exits_nonzero_without_a_result(tmp_path):
    """A checkout whose BENCHMARK.json holds the four-card cell, without
    four CUDA devices: exit 2, no result."""
    with open(tmp_path / "BENCHMARK.json", "w") as f:
        json.dump(FOUR, f)
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", CELL["name"],
                        "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=str(tmp_path),
                       capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert p.returncode == 2 and p.stdout.strip() == ""
    assert "4 CUDA device(s)" in p.stderr

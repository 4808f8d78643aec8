"""The per-layer metrics read from the port's spans: one reader a span,
and a traced CPU run of a cell that reports every one."""

import os
import time

import pytest

from benchmark import run, spec

BENCH = spec.benchmark()
SPAN_METRICS = {
    "graph_d2h_s": "table_d2h", "graph_link_s": "link", "graph_assemble_s": "assemble",
    "graph_write_s": "write_graph", "load_table_s": "load_table", "search_s": "search",
    "replay_s": "replay", "coverage_s": "coverage", "sites_wait_s": "coverage_wait",
    "sites_align_s": "align", "sites_windows_s": "window_coverage",
    "sites_write_s": "write_tables", "unstaged_s": "unstaged",
}


@pytest.mark.parametrize("name", sorted(SPAN_METRICS))
def test_span_reader_divides_by_calls(name):
    key = SPAN_METRICS[name]
    reader = spec.metric_reader(name)
    assert reader.read({"stage_sums": {key: 3.0, "read": 1.0}, "calls": 4, "profile": None}) == 0.75
    assert reader.read({"stage_sums": {"read": 1.0}, "calls": 4, "profile": None}) is None
    assert reader.read({"stage_sums": {key: 3.0}, "calls": 0, "profile": None}) is None


def test_span_metrics_are_declared_for_both_cells():
    declared = {m["name"]: m for m in BENCH["per_layer"]}
    for name in SPAN_METRICS:
        m = declared[name]
        assert (m["unit"], m["better"], m["source"], m["moves"]) == (
            "s", "lower", "program_span", "call_s")
        assert m["workloads"] == ["snj17.full", "snj3.full"]


def test_traced_cpu_run_reports_every_span_metric(tmp_path):
    """A traced run of snj3.full at 20 kb on the CPU gives each of the
    span metrics a value."""
    cell = spec.cell("snj3.full", BENCH)
    cfg = dict(spec.config("snj3", BENCH), genome_bp=20000)
    here = os.getcwd()
    try:
        r = run.run_cell(cell, cfg, spec.traffic("full"), 7, 0.0, True, "cpu", time.time(),
                         spec.limits(), BENCH, str(tmp_path), processes=1)
    finally:
        os.chdir(here)
    metrics = r["result"]["metrics"]
    for name in SPAN_METRICS:
        assert metrics[name]["unit"] == "s" and metrics[name]["value"] >= 0, name
    assert r["result"]["correct"] is True

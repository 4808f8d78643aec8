"""Where the benchmark finds its parts, by the names in BENCHMARK.json.

A cell (`workloads` entry) names a configuration and a traffic mix. A
configuration is `configs[].file`; a traffic mix is
`benchmark/traffic/<traffic>.json`; a per-layer metric is the reader
`benchmark/metrics/<name>.py`; a compared number's limit is in
`benchmark/limits.json`. Adding any of them adds files and entries and
edits none.
"""

from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def cell(name: str, bench: dict) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload named {name!r} in BENCHMARK.json")


def config(name: str, bench: dict, root: str = ROOT) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            with open(os.path.join(root, c["file"])) as f:
                return json.load(f)
    raise KeyError(f"no configuration named {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    path = os.path.join(HERE, "traffic", name + ".json")
    if not os.path.exists(path):
        raise KeyError(f"no traffic mix named {name!r} (looked for {path})")
    with open(path) as f:
        return json.load(f)


def metric_reader(name: str):
    """The module of benchmark/metrics/<name>.py; its `read(run)` returns
    the metric's value, or None when the run has nothing to read."""
    path = os.path.join(HERE, "metrics", name + ".py")
    if not os.path.exists(path):
        raise KeyError(f"no reader for metric {name!r} (looked for {path})")
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{len(name)}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def limits() -> dict:
    with open(os.path.join(HERE, "limits.json")) as f:
        return json.load(f)


def metrics_of(cell_name: str, kind: str, bench: dict) -> list[dict]:
    """The `end_to_end` or `per_layer` metrics the cell reports."""
    return [m for m in bench[kind] if "workloads" not in m or cell_name in m["workloads"]]

"""The control: the reference's GMM fits one precision below the
configuration's float64, in the program's place, fail `model_gap`;
the program's own fits pass it."""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from benchmark import control, run, spec
from benchmark.reference import gmm
from benchmark.tests.conftest import ROOT, tiny

BENCH = spec.benchmark()


def test_float32_fits_fail_and_float64_fits_pass(tmp_path):
    cell = spec.cell("snj17.full", BENCH)
    cfg = tiny(spec.config("snj17", BENCH), 150_000)
    here = os.getcwd()
    try:
        r = run.run_cell(cell, cfg, spec.traffic("full"), 2**31 + 21, 0.0, False, "cpu",
                         time.time(), spec.limits(), BENCH, str(tmp_path), processes=1)
        gap, _, n = control.control_gap(str(tmp_path))
    finally:
        os.chdir(here)
    limit = spec.limits()["model_gap"]
    assert n > 1000
    assert r["result"]["checks"]["model_gap"]["value"] <= limit
    assert gap > limit


def test_gap_reads_the_layout():
    a = "ploidy : 2\tgauss : 1\navg loglikelihood : 1.62479\n"
    assert gmm.gap(a, a) == 0.0
    assert gmm.gap(a, a.replace("1.62479", "1.62478")) == pytest.approx(1 / 162478, rel=1e-6)
    assert gmm.gap(a, a + "AIC : 3\n") == float("inf")


def test_reference_fit_is_the_upstreams():
    """Means fixed, weights summing to one, the variance of one
    component the data's own about its fixed mean."""
    rng = np.random.default_rng(3)
    af = np.clip(rng.normal(0.5, 0.05, 4000), 0, 1)
    w, v, ll, steps = gmm.fit(af, 1, np.float64)
    assert w.sum() == pytest.approx(1.0)
    assert v[0] == pytest.approx(((af - 0.5) ** 2).mean(), rel=1e-12)
    text, ploidy = gmm.model_result(af)
    assert ploidy == 2 and text.endswith("estimated ploidy level is : 2\n")


@pytest.mark.card
def test_control_on_the_card(card):
    """The control script on the card at the cell's size: one seed, the
    program correct, the control failing."""
    p = subprocess.run([sys.executable, "-m", "benchmark.control", "--workload", "snj17.full",
                        "--seeds", "5"], cwd=ROOT,
                       capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    row = json.loads(p.stdout.strip().splitlines()[-1])
    assert row["correct"] and row["control"]["fails"]

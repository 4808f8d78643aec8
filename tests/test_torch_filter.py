"""The port's `filter`, `filter-multi` and `drawfreq` against the JAX
package's: the same synthetic coverage tables through both (the port by
its CLI, the JAX package by its command function), every output file
byte-equal."""

import os
import sys

import numpy as np
import pytest

from ploidyfrost_tpu.filter import cmd_filter as jax_cmd_filter
from ploidyfrost_tpu_torch.cli import main
from ploidyfrost_tpu_torch.filter import FilterOptions, drawfreq, filter_tables
from test_filter import write_tables
from test_torch_helpers import few_torch_threads  # noqa: F401  (autouse fixture)

OUTPUTS = ["bicov", "tricov", "tetracov", "pentacov", "allele_frequency"]

# (name, multi tables, filter arguments); the first five are the cases
# of tests/test_filter.py
CASES = [
    ("single", False, ["-S", "-I", "-l", "10", "-u", "60"]),
    ("keeps_tetra_when_sum_ok", False, ["-l", "10", "-u", "100"]),
    ("multi_cramer_low", True, ["-l", "1", "-u", "100", "-v", "0.5"]),
    ("multi_cramer_high", True, ["-l", "1", "-u", "100", "-v", "0.9"]),
    ("multi_color", True, ["-l", "1", "-u", "100", "-c", "1"]),
    ("snp_keeps_indels", False, ["--snp", "--low", "10", "--up", "100"]),
    ("num_distance_size", False, ["-n", "2", "-d", "10", "-s", "2", "-q", "0.4"]),
    ("defaults", False, []),
]


@pytest.mark.parametrize("name,multi,args", CASES, ids=[c[0] for c in CASES])
def test_filter_outputs_equal_the_jax_package(tmp_path, monkeypatch, name, multi, args):
    write_tables(str(tmp_path), multi=multi)
    monkeypatch.chdir(tmp_path)
    assert jax_cmd_filter(["-i", "in", "-o", "ref", *args], multi=multi) == 0
    sub = "filter-multi" if multi else "filter"
    assert main([sub, "-i", "in", "-o", "out", *args]) == 0
    for suffix in OUTPUTS:
        with open(f"out_{suffix}.txt", "rb") as f1, open(f"ref_{suffix}.txt", "rb") as f2:
            assert f1.read() == f2.read(), suffix
    if name == "single":
        # --simple drops isStrict=0, --indel drops VarType>0, low=10 drops
        # the 5-coverage row; the tetra row fails the sum-of-four gate
        with open("out_bicov.txt") as f:
            assert f.read().splitlines() == ["20\t22\t1\t0\t1\t1\t30"]
        with open("out_allele_frequency.txt") as f:
            fre = [float(x) for x in f.read().split()]
        assert fre == [float(np.round(20 / 42, 7)), float(np.round(22 / 42, 7))]


def test_filter_frequency_bounds(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with open("in_bicov.txt", "w") as f:
        f.write("99\t1\t1\t0\t1\t1\t30\t\n")  # freq 0.99/0.01
    for name in ("tri", "tetra", "penta"):
        open(f"in_{name}cov.txt", "w").close()
    opt = FilterOptions(inprefix="in", outprefix="outq", low=0, up=1000, frequency=0.05)
    assert filter_tables(opt, multi=False) == 0
    with open("outq_allele_frequency.txt") as f:
        assert f.read() == ""
    assert jax_cmd_filter(["-i", "in", "-o", "ref", "-l", "0", "-u", "1000"], multi=False) == 0
    with open("outq_bicov.txt", "rb") as f1, open("ref_bicov.txt", "rb") as f2:
        assert f1.read() == f2.read()


def test_filter_error_paths(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    assert main(["filter", "-i", "absent", "-o", "out"]) == 1
    assert "does not exists" in capsys.readouterr().err
    assert main(["filter", "-i", "absent", "-q", "0.6"]) == 1
    assert "frequency should < 0.5" in capsys.readouterr().err
    with pytest.raises(SystemExit, match="unknown filter option"):
        main(["filter", "--nope"])
    assert os.listdir(tmp_path) == []


def _write_frequencies(path):
    rng = np.random.default_rng(0)
    data = np.concatenate([rng.normal(0.33, 0.03, 300), rng.normal(0.67, 0.03, 300)])
    np.savetxt(path, np.clip(data, 0.01, 0.99))


def test_drawfreq(tmp_path, monkeypatch):
    pytest.importorskip("matplotlib")
    monkeypatch.chdir(tmp_path)
    _write_frequencies("fre.txt")
    assert drawfreq("fre.txt", "plot", "test", 3) == 0
    assert os.path.getsize("plot_allele_frequency.png") > 0
    assert main(["drawfreq", "-f", "fre.txt", "-o", "cli", "-t", "t", "-p", "3"]) == 0
    assert os.path.getsize("cli_allele_frequency.png") > 0
    assert drawfreq("missing.txt", "plot") == 1


def test_drawfreq_without_matplotlib(tmp_path, monkeypatch, capsys):
    """No matplotlib: one line naming the package, exit code 1, no file."""
    monkeypatch.chdir(tmp_path)
    _write_frequencies("fre.txt")
    monkeypatch.setitem(sys.modules, "matplotlib", None)  # import raises ImportError
    assert main(["drawfreq", "-f", "fre.txt", "-o", "plot", "-p", "3"]) == 1
    err = capsys.readouterr().err
    assert "matplotlib" in err and len(err.strip().splitlines()) == 1
    assert os.listdir(tmp_path) == ["fre.txt"]

"""The port's `figures` against the JAX package's on the golden tables:
the same prefixes through both, `_site_stats.tsv` byte-equal,
`_loglikelihood.tsv` within 1e-6 relative (the port fits the GMM with
device="cpu"), and the tables half runs without matplotlib."""

import os
import sys

import numpy as np
import pytest

from ploidyfrost_tpu import figures as jax_figures
from ploidyfrost_tpu_torch import figures
from ploidyfrost_tpu_torch.cli import main
from test_torch_helpers import few_torch_threads  # noqa: F401  (autouse fixture)

GOLD = os.path.join(os.path.dirname(__file__), "golden")
SINGLE = os.path.join(GOLD, "single_diploid", "gold")
MULTI = os.path.join(GOLD, "multi_colored", "gold")
PNGS = ["_frequency_density.png", "_coverage_density.png", "_loglikelihood.png"]


def _same_bytes(a, b):
    with open(a, "rb") as f1, open(b, "rb") as f2:
        return f1.read() == f2.read()


def _assert_ll_close(mine, ref, rel=1e-6):
    with open(mine) as f1, open(ref) as f2:
        a, b = f1.read().splitlines(), f2.read().splitlines()
    assert a[0] == b[0] and len(a) == len(b)
    for la, lb in zip(a[1:], b[1:]):
        pa, pb = la.split("\t"), lb.split("\t")
        assert pa[0] == pb[0]
        va, vb = np.array(pa[1:], float), np.array(pb[1:], float)
        assert np.all(np.isfinite(va))
        np.testing.assert_allclose(va, vb, rtol=rel, atol=0)


@pytest.mark.parametrize("prefix,multi", [(SINGLE, False), (MULTI, True)])
def test_read_cov_tables(prefix, multi):
    cov, fre = figures.read_cov_tables(prefix, multi=multi)
    jcov, jfre = jax_figures.read_cov_tables(prefix, multi=multi)
    assert set(cov) == set(jcov) and set(fre) == set(jfre)
    for mine, ref in ((cov, jcov), (fre, jfre)):
        for key in ref:
            np.testing.assert_array_equal(mine[key], ref[key], err_msg=key)
    # frequencies sum to 1 within each site: total mass == site rows
    assert fre["fre"].sum() == pytest.approx(len(cov["coverage"]))


@pytest.mark.parametrize("prefix,multi,covs", [(SINGLE, False, [13.0]),
                                               (MULTI, True, [13.0, 12.0, 14.0])])
def test_site_stats(prefix, multi, covs):
    cov, _ = figures.read_cov_tables(prefix, multi=multi)
    tiers = figures.filter_tiers(cov, multi=multi, cramer=0.25)
    header, rows = figures.site_stats(cov, tiers, covs, 2, multi, None)
    jcov, _ = jax_figures.read_cov_tables(prefix, multi=multi)
    jtiers = jax_figures.filter_tiers(jcov, multi=multi, cramer=0.25)
    assert [t[0] for t in tiers] == [t[0] for t in jtiers]
    assert (header, rows) == jax_figures.site_stats(jcov, jtiers, covs, 2, multi, None)
    if not multi:
        arr, num, size = cov["coverage"], cov["varnum"], cov["varsize"]
        out = (arr < 13.0) | (arr > 39.0)
        m5 = (num <= 5) & (size <= 10)
        assert rows[0][1:6] == [len(arr), int(out.sum()), int(m5.sum()),
                                m5.sum() / len(arr), int(out.sum()) - int((out & m5).sum())]


def test_make_figures_single(tmp_path):
    pytest.importorskip("matplotlib")
    out, ref = str(tmp_path / "fig"), str(tmp_path / "ref")
    assert figures.make_figures(SINGLE, out, [13.0], 2, gauss_lower=1, gauss_upper=2,
                                device="cpu") == 0
    assert jax_figures.make_figures(SINGLE, ref, [13.0], 2, gauss_lower=1, gauss_upper=2) == 0
    assert _same_bytes(out + "_site_stats.tsv", ref + "_site_stats.tsv")
    _assert_ll_close(out + "_loglikelihood.tsv", ref + "_loglikelihood.tsv")
    with open(out + "_loglikelihood.tsv") as f:
        lines = f.read().splitlines()
    assert len(lines) == 4 and lines[0].split("\t") == ["filter", "2", "3"]
    for suffix in PNGS:
        assert os.path.getsize(out + suffix) > 0, suffix


def test_make_figures_multi(tmp_path):
    pytest.importorskip("matplotlib")
    out, ref = str(tmp_path / "figm"), str(tmp_path / "refm")
    kw = dict(multi=True, cramer=0.25, names=["s0", "s1", "s2"], with_model=False)
    assert figures.make_figures(MULTI, out, [13.0, 13.0, 13.0], 2, device="cpu", **kw) == 0
    assert jax_figures.make_figures(MULTI, ref, [13.0, 13.0, 13.0], 2, **kw) == 0
    assert _same_bytes(out + "_site_stats.tsv", ref + "_site_stats.tsv")
    with open(out + "_site_stats.tsv") as f:
        lines = f.read().splitlines()
    assert len(lines) == 4 and lines[1].startswith("s0\t")
    assert "Cramer's V >= 0.25" in lines[0]
    assert not os.path.exists(out + "_loglikelihood.tsv")
    assert not os.path.exists(out + "_loglikelihood.png")


def test_multi_loglikelihood_close_to_the_jax_package(tmp_path):
    """The four multi-sample tiers (the Cramer split at 0.58, near the
    median, so that neither side is empty) through both GMM fits, three
    gauss counts each."""
    _, fre = figures.read_cov_tables(MULTI, multi=True)
    tiers = figures.filter_tiers(fre, multi=True, cramer=0.58)
    assert all(mask.any() for _, mask in tiers)
    ploidies, curves = figures.ll_curves(fre, tiers, 1, 3, device="cpu")
    jploidies, jcurves = jax_figures.ll_curves(fre, tiers, 1, 3)
    assert ploidies == jploidies == [2, 3, 4] and list(curves) == list(jcurves)
    for label in curves:
        np.testing.assert_allclose(curves[label], jcurves[label], rtol=1e-6, atol=0)


def test_cli_dispatch(tmp_path):
    pytest.importorskip("matplotlib")
    out = str(tmp_path / "cli")
    rc = main(["figures", "-i", SINGLE, "-o", out, "-c", "13", "-p", "2", "--no-model",
               "--device=cpu"])
    assert rc == 0
    assert os.path.exists(out + "_site_stats.tsv")
    with pytest.raises(SystemExit, match="unknown figures option"):
        main(["figures", "--nope", "--device=cpu"])
    with pytest.raises(SystemExit, match="are required"):
        main(["figures", "-i", SINGLE, "--device=cpu"])


def test_missing_prefix_errors():
    with pytest.raises(SystemExit):
        figures.read_cov_tables("/nonexistent/nope", multi=False)


def test_tables_need_no_matplotlib(tmp_path, monkeypatch, capsys):
    """With matplotlib hidden the two tables are written as ever, then
    the command says in one line what is missing and returns 1."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)  # import raises ImportError
    out = str(tmp_path / "fig")
    tables = figures.figure_tables(SINGLE, out, [13.0], 2, gauss_lower=1, gauss_upper=1,
                                   device="cpu")
    assert tables["ploidies"] == [2] and len(tables["curves"]) == 3
    first = {s: open(out + s, "rb").read() for s in ("_site_stats.tsv", "_loglikelihood.tsv")}
    rc = main(["figures", "-i", SINGLE, "-o", out, "-c", "13", "-p", "2", "--gauss-low", "1",
               "--gauss-up", "1", "--device=cpu"])
    assert rc == 1
    err = capsys.readouterr().err
    assert "matplotlib" in err and len(err.strip().splitlines()) == 1
    assert sorted(os.listdir(tmp_path)) == ["fig_loglikelihood.tsv", "fig_site_stats.tsv"]
    for suffix, data in first.items():
        with open(out + suffix, "rb") as f:
            assert f.read() == data


def test_figures_refuses_without_cuda(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["figures", "-i", SINGLE, "-o", str(tmp_path / "x"), "-c", "13"])
    assert os.listdir(tmp_path) == []

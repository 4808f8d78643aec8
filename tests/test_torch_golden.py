"""Golden end-to-end test of the torch port on the CPU.

The port's `pipeline` runs with device="cpu" on the single_diploid reads
(the same generator as tests/test_golden.py) and must reproduce the 12
reference output tables and gold_model_result.txt byte for byte, with
cutoffs (10, 37) and ploidy 2. Also: importing the port's CLI loads
neither jax nor ploidyfrost_tpu, and the entry points refuse to run
when CUDA is asked for (the default) and absent.
"""

import os
import subprocess
import sys

import pytest
import torch

from test_golden import FILES, GOLD, make_reads
from test_torch_helpers import ahead_stages, few_torch_threads  # noqa: F401  (autouse fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    from ploidyfrost_tpu_torch.cli import Options, parse_options
    from ploidyfrost_tpu_torch.pipeline import run_pipeline_cli

    d = tmp_path_factory.mktemp("torch_golden")
    cwd = os.getcwd()
    os.chdir(d)
    try:
        make_reads("reads.fa")
        opt = parse_options(["-o", "gold", "reads.fa"], Options(), extras="c")
        assert run_pipeline_cli(opt, device="cpu") == 0
        yield str(d), opt
    finally:
        os.chdir(cwd)


@pytest.mark.parametrize("name", FILES)
def test_table_matches_reference(port_run, name):
    d, _ = port_run
    with open(os.path.join(d, "PloidyFrost_output", f"gold_{name}.txt"), "rb") as f1, open(
        os.path.join(GOLD, f"gold_{name}.txt"), "rb"
    ) as f2:
        assert f1.read() == f2.read(), f"{name} differs from reference output"


def test_model_result_matches_reference(port_run):
    d, _ = port_run
    with open(os.path.join(d, "gold_model_result.txt"), "rb") as f1, open(
        os.path.join(GOLD, "gold_model_result.txt"), "rb"
    ) as f2:
        assert f1.read() == f2.read()


def test_cutoffs_and_ploidy(port_run):
    d, opt = port_run
    assert (opt.coverage_lower, opt.coverage_upper) == (10, 37)
    with open(os.path.join(d, "gold_model_result.txt")) as f:
        assert f.read().rstrip().endswith("estimated ploidy level is : 2")
    assert set(opt.stage_seconds) == {
        "read", "count", "build_graph", "load_graph", "superbubbles", "sites", "model",
        "table_d2h", "link", "assemble", "write_graph", "load_table", "search", "replay",
        "coverage", "coverage_wait", "align", "window_coverage", "write_tables", "unstaged",
    } | ahead_stages()


def test_run_subcommand_on_pipeline_outputs(port_run, tmp_path):
    """`run` on the GFA and count table that `pipeline` wrote gives the
    same tables (the CLI path, with --device=cpu)."""
    from ploidyfrost_tpu_torch.cli import main

    d, _ = port_run
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        rc = main([
            "-g", os.path.join(d, "gold.gfa"), "-d", os.path.join(d, "gold.kmers.npz"),
            "-o", "again", "-l", "10", "-u", "37", "--device=cpu",
        ])
        assert rc == 0
        for name in FILES:
            with open(os.path.join("PloidyFrost_output", f"again_{name}.txt"), "rb") as f1, open(
                os.path.join(GOLD, f"gold_{name}.txt"), "rb"
            ) as f2:
                assert f1.read() == f2.read(), name
        fre = os.path.join("PloidyFrost_output", "again_allele_frequency.txt")
        assert main(["model", "-g", fre, "-o", "again", "--device=cpu"]) == 0
        with open("again_model_result.txt", "rb") as f1, open(
            os.path.join(GOLD, "gold_model_result.txt"), "rb"
        ) as f2:
            assert f1.read() == f2.read()
    finally:
        os.chdir(cwd)


def test_run_shuts_the_coverage_pool_when_the_search_raises(port_run, tmp_path, monkeypatch):
    """`run` probes the unitig coverage on a pool beside the superbubble
    search; when the search raises, the pool is shut down before the
    error leaves `run`."""
    import concurrent.futures

    from ploidyfrost_tpu_torch import cli
    from ploidyfrost_tpu_torch.bubble import batched

    pools = []

    class Pool(concurrent.futures.ThreadPoolExecutor):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            self.shut = False
            pools.append(self)

        def shutdown(self, *args, **kw):
            self.shut = True
            super().shutdown(*args, **kw)

    def search_fails(*args, **kw):
        raise RuntimeError("search failed")

    monkeypatch.setattr(concurrent.futures, "ThreadPoolExecutor", Pool)
    monkeypatch.setattr(batched, "find_superbubbles_device", search_fails)
    d, _ = port_run
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="search failed"):
        cli._main(["-g", os.path.join(d, "gold.gfa"), "-d", os.path.join(d, "gold.kmers.npz"),
                   "-o", "fails", "-l", "10", "-u", "37"], "cpu", False)
    assert pools and all(p.shut for p in pools)


def test_port_imports_no_jax():
    """Every module of the package imports, in a fresh interpreter,
    without loading jax or the JAX package (and so without a GPU
    toolchain: none is needed at import)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import ploidyfrost_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'ploidyfrost_tpu' or m.startswith('ploidyfrost_tpu.')]\n"
        "print(len(names), bad)\n"
        "sys.exit(1 if bad or len(names) < 30 else 0)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    for name in ("graph.colors", "io.bfg", "io.kmc", "sites.emit_colored", "parallel.mesh",
                 "parallel.sharded"):
        assert os.path.exists(os.path.join(ROOT, "ploidyfrost_tpu_torch", *name.split(".")) + ".py")


_ENTRIES = [
    "pipeline", "run_analysis", "run_model", "cli",
    "pipeline_multi", "run_colored_analysis", "build_graph", "build_colored_graph",
    "build_graph_from_reads", "kmer_counter",
    "cli_count", "cli_build", "cli_build_c", "cli_pipeline_multi", "cli_run_f",
]


@pytest.mark.parametrize("entry", _ENTRIES)
def test_entry_points_refuse_without_cuda(entry, tmp_path, monkeypatch):
    """Without device=, an entry point asks for CUDA; on a host without
    it, it raises before doing any work instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from ploidyfrost_tpu_torch import cli, pipeline
    from ploidyfrost_tpu_torch.graph.construct import build_graph_from_reads
    from ploidyfrost_tpu_torch.kmer.count import KmerCounter
    from ploidyfrost_tpu_torch.model.gmm import run_model

    monkeypatch.chdir(tmp_path)
    fre = tmp_path / "af.txt"
    fre.write_text("0.5\n0.4\n0.6\n")
    reads = tmp_path / "r.fa"
    reads.write_text(">r1\n" + "ACGTTGCAAGGCTTAACCGGTACGTAGCTAGGATCCA" * 3 + "\n")
    (tmp_path / "cov.txt").write_text("10\t40\n")
    opt = cli.parse_options(["-o", "x", str(reads)], cli.Options())
    opt.coverage_vec = [(10, 40)]
    colored = ["-g", "x.gfa", "-f", "x.colors.npz", "-d", "list.txt", "-C", "cov.txt"]
    calls = {
        "pipeline": lambda: pipeline.run_pipeline_cli(opt),
        "run_analysis": lambda: pipeline.run_analysis(opt),
        "run_model": lambda: run_model(str(tmp_path / "m"), fre_file=str(fre)),
        "cli": lambda: cli.main(["model", "-g", str(fre), "-o", str(tmp_path / "m")]),
        "pipeline_multi": lambda: pipeline.run_multisample_pipeline_cli(opt),
        "run_colored_analysis": lambda: pipeline.run_colored_analysis(opt),
        "build_graph": lambda: pipeline.build_graph_cli(opt),
        "build_colored_graph": lambda: pipeline.build_colored_graph_cli(opt),
        "build_graph_from_reads": lambda: build_graph_from_reads([str(reads)], 25),
        "kmer_counter": lambda: KmerCounter(25),
        "cli_count": lambda: cli.main(["count", "-o", "x", str(reads)]),
        "cli_build": lambda: cli.main(["build", "-o", "x", str(reads), "--device-build"]),
        "cli_build_c": lambda: cli.main(["build", "-c", "-o", "x", str(reads)]),
        "cli_pipeline_multi": lambda: cli.main(["pipeline-multi", "-o", "x", str(reads)]),
        "cli_run_f": lambda: cli.main(colored),
    }
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calls[entry]()
    # nothing was written: no result, no histogram, no table, no graph
    assert sorted(os.listdir(tmp_path)) == ["af.txt", "cov.txt", "r.fa"]


@pytest.mark.parametrize("cmd,module", [("filter", "filter"), ("filter-multi", "filter"),
                                        ("drawfreq", "drawfreq"), ("figures", "figures")])
def test_post_processing_subcommands_reach_their_parsers(cmd, module, capsys):
    """The four post-processing subcommands are dispatched to their own
    argument parsers, which name themselves when they refuse an option
    (tests/test_torch_cli_edges.py drives each to its outputs)."""
    from ploidyfrost_tpu_torch.cli import main

    with pytest.raises(SystemExit, match=f"unknown {module} option --nope"):
        main([cmd, "--nope", "--device=cpu"])
    assert "not part of this package" not in capsys.readouterr().err

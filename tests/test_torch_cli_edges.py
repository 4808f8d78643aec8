"""CLI edge cases of the torch port (the cases of tests/test_cli_edges.py
with --device=cpu), the dispatch of the four post-processing
subcommands, and --devices refused where no card is visible."""

import os

import numpy as np
import pytest

from ploidyfrost_tpu_torch import cli
from ploidyfrost_tpu_torch.cli import main
from ploidyfrost_tpu_torch.io.trim import TrimConfig, trim_read
from test_filter import write_tables
from test_torch_helpers import few_torch_threads  # noqa: F401  (autouse fixture)

SINGLE = os.path.join(os.path.dirname(__file__), "golden", "single_diploid", "gold")


def test_invalid_option_prints_usage_and_exits_clean(capsys):
    """Unknown option: 'Invalid option' + usage + nonzero exit, no
    traceback (src/Main.cpp:193-197)."""
    rc = main(["-Z", "nope", "--device=cpu"])
    out = capsys.readouterr().out
    assert rc == 1
    assert "Invalid option" in out
    assert "ploidyfrost-tpu-torch" in out


@pytest.mark.parametrize("args", [["-e", "x"], ["-R", "x"], ["-N"], ["-S"], ["-c"],
                                  ["model", "-e", "x"], ["count", "-N", "r.fa"]],
                         ids=lambda a: " ".join(a))
def test_orphan_optstring_letters_hard_fail(args, capsys, tmp_path, monkeypatch):
    """-e/-R/-N/-S are declared in the reference optstring but have no
    case handler, so they hit ``default:`` -> "Invalid option" + usage
    + exit(EXIT_FAILURE) (src/Main.cpp:124, 193-197). Same for -c on
    the main run path (only the build/pipeline subcommands accept it)."""
    monkeypatch.chdir(tmp_path)
    rc = main([*args, "--device=cpu"])
    out = capsys.readouterr().out
    assert rc == 1
    assert "Invalid option" in out
    assert os.listdir(tmp_path) == []


def test_b_flag_does_not_stop_run(tmp_path, monkeypatch):
    """-b never stops before ploidyEstimation: the reference forces
    bubble=true and p defaults true with no way to unset
    (src/Main.cpp:463, 92-120, 836-850)."""
    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(0)
    G = 6000
    g1 = rng.integers(0, 4, G).astype(np.uint8)
    g2 = g1.copy()
    snp = rng.random(G) < 0.01
    g2[snp] = (g2[snp] + rng.integers(1, 4, snp.sum())) % 4
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    with open("reads.fa", "w") as f:
        n = 0
        for hap in (g1, g2):
            for _ in range(20):
                for s in rng.integers(0, G - 100, G // 100):
                    n += 1
                    f.write(f">r{n}\n" + bases[hap[s : s + 100]].tobytes().decode() + "\n")
    assert main(["count", "-k", "15", "-o", "db", "reads.fa", "--device=cpu"]) == 0
    assert main(["build", "-k", "15", "-o", "graph", "reads.fa", "--device=cpu"]) == 0
    rc = main(["-g", "graph.gfa", "-d", "db.kmers.npz", "-o", "o", "-b", "-l", "2", "-u",
               "10000", "--device=cpu"])
    assert rc == 0
    # ploidyEstimation ran: the coverage tables exist
    assert (tmp_path / "PloidyFrost_output" / "o_bicov.txt").exists()


@pytest.mark.parametrize("spec", ["LEADING", "SLIDINGWINDOW:3"])
def test_trim_malformed_spec_is_friendly(spec):
    with pytest.raises(SystemExit) as e:
        main(["pipeline", f"--trim={spec}", "x.fa", "--device=cpu"])
    assert "malformed trim step" in str(e.value)


def test_sliding_window_drops_short_reads():
    """Reads shorter than the window are dropped when SLIDINGWINDOW is
    enabled (Trimmomatic SlidingWindowTrimmer semantics)."""
    cfg = TrimConfig(leading=0, trailing=0, window=5, window_quality=20, minlen=1)
    seq = b"ACG"
    qual = bytes([33 + 30] * 3)  # high quality, but shorter than window
    assert trim_read(seq, qual, cfg) == b""
    # window disabled: kept
    cfg2 = TrimConfig(leading=0, trailing=0, window=0, window_quality=20, minlen=1)
    assert trim_read(seq, qual, cfg2) == seq


def test_multiline_fastq(tmp_path):
    """Multi-line FASTQ (kseq-supported) parses correctly."""
    from ploidyfrost_tpu_torch.io.fastx import iter_sequences_with_qual

    p = tmp_path / "ml.fq"
    p.write_bytes(
        b"@r1\nACGTAC\nGTACGT\n+\nIIIIII\nIIIIII\n"
        b"@r2\nACGT\n+r2\nIIII\n"
    )
    recs = list(iter_sequences_with_qual(str(p)))
    assert recs == [
        (b"ACGTACGTACGT", b"IIIIIIIIIIII"),
        (b"ACGT", b"IIII"),
    ]


@pytest.mark.parametrize("cmd", ["filter", "filter-multi", "drawfreq", "figures"])
def test_post_processing_subcommands_dispatch(cmd, tmp_path, monkeypatch):
    """Each of the four subcommands reaches its own module and does its
    work (the default device where it needs none, --device=cpu where the
    GMM fits run)."""
    monkeypatch.chdir(tmp_path)
    assert not hasattr(cli, "_NOT_PORTED")
    if cmd in ("filter", "filter-multi"):
        write_tables(".", multi=cmd == "filter-multi")
        assert main([cmd, "-i", "in", "-o", "out", "-l", "1", "-u", "100"]) == 0
        with open("out_bicov.txt") as f:
            assert len(f.read().splitlines()) == 4
        with open("out_allele_frequency.txt") as f:
            assert len(f.read().split()) == 12
    elif cmd == "drawfreq":
        pytest.importorskip("matplotlib")
        np.savetxt("fre.txt", np.linspace(0.2, 0.8, 50))
        assert main([cmd, "-f", "fre.txt", "-o", "d", "-p", "2"]) == 0
        assert os.path.getsize("d_allele_frequency.png") > 0
        assert main([cmd, "-f", "absent.txt"]) == 1
    else:
        pytest.importorskip("matplotlib")
        assert main([cmd, "-i", SINGLE, "-o", "f", "-c", "13", "--gauss-low", "1",
                     "--gauss-up", "1", "--device=cpu"]) == 0
        assert sorted(os.listdir(".")) == [
            "f_coverage_density.png", "f_frequency_density.png", "f_loglikelihood.png",
            "f_loglikelihood.tsv", "f_site_stats.tsv"]


@pytest.mark.parametrize("args", [
    ["--devices=2", "-g", "x.gfa", "-d", "x", "-o", "o"],
    ["--devices", "-g", "x.gfa", "-d", "x", "-o", "o"],
    ["pipeline", "--devices=4", "-o", "o", "r.fa"],
    ["count", "-o", "o", "r.fa", "--devices=1"],
    ["model", "--devices", "-g", "af.txt"],
], ids=lambda a: " ".join(a[:2]))
def test_devices_flag_is_rejected(args, capsys, tmp_path, monkeypatch):
    """--devices[=N] is the CLI's own flag (parallel/mesh.py), never an
    unknown option. On a host without CUDA, with --device=cuda (the
    default), every form of it is refused before any work: a count above
    the visible cards (none) with the JAX package's message, one device
    (or auto, which finds no card) because CUDA is absent. Runs on
    several devices are tested in tests/test_torch_cli_mesh.py."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.chdir(tmp_path)
    n = max((int(a.split("=")[1]) for a in args if a.startswith("--devices=")), default=1)
    if n > 1:
        with pytest.raises(SystemExit, match=f"--devices={n} but only 0 devices visible"):
            main(args)
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(args)
    assert "Invalid option" not in capsys.readouterr().out
    assert os.listdir(tmp_path) == []

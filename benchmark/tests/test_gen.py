"""The read generator: seeded, the recipe's rates, the paired layout."""

import gzip

import numpy as np
import pytest

from benchmark import spec
from benchmark.gen import reads

BENCH = spec.benchmark()


def small(name="snj17", **kw):
    return dict(spec.config(name, BENCH), genome_bp=20_000, **kw)


def test_same_seed_same_bytes(tmp_path):
    cfg = small()
    a = reads.write_mate(cfg, 2**31 + 5, 0, 1, str(tmp_path / "a.fq.gz"))
    b = reads.write_mate(cfg, 2**31 + 5, 0, 1, str(tmp_path / "b.fq.gz"))
    assert a == b
    assert (tmp_path / "a.fq.gz").read_bytes() == (tmp_path / "b.fq.gz").read_bytes()


def test_other_seed_other_bytes(tmp_path):
    cfg = small()
    reads.write_mate(cfg, 1, 0, 2, str(tmp_path / "a.fq.gz"))
    reads.write_mate(cfg, 2, 0, 2, str(tmp_path / "b.fq.gz"))
    assert (tmp_path / "a.fq.gz").read_bytes() != (tmp_path / "b.fq.gz").read_bytes()


def test_fastq_records(tmp_path):
    cfg = small()
    path = str(tmp_path / "m.fq.gz")
    reads.write_mate(cfg, 9, 0, 1, path)
    lines = gzip.open(path, "rt").read().splitlines()
    n = 2 * reads.pairs_per_haplotype(cfg, 0)
    assert len(lines) == 4 * n
    assert lines[0].startswith("@r") and lines[0].endswith("/1")
    assert set(lines[1]) <= set("ACGT") and len(lines[1]) == cfg["read_len"]
    assert lines[2] == "+" and lines[3] == "I" * cfg["read_len"]


def test_depth_per_haplotype():
    cfg = small()
    L, k = cfg["read_len"], cfg["k"]
    pairs = reads.pairs_per_haplotype(cfg, 0)
    depth = 2 * L * pairs / cfg["genome_bp"]
    assert depth == pytest.approx(39.3 * L / (L - k + 1), rel=1e-3)
    assert reads.expected_reads(spec.config("snj17", BENCH)) == pytest.approx(3.12e6, rel=0.01)
    assert reads.expected_reads(spec.config("snj3", BENCH)) == pytest.approx(9.93e6, rel=0.01)


def test_heterozygosity():
    cfg = dict(small(), genome_bp=400_000)
    h0, h1 = reads.haplotypes(cfg, 3, 0)
    share = float((h0 != h1).mean())
    # binomial sampling error at 400 kb: sd = sqrt(0.01 * 0.99 / 4e5) = 1.6e-4
    assert abs(share - 0.01) < 5 * 1.6e-4


def test_error_rate_and_mates():
    """Errors drawn apart from the fragments: the same seed without
    errors gives the same reads up to the substitutions, at the rate."""
    cfg = small()
    clean = dict(cfg, error_rate=0.0)
    noisy = dict(cfg, error_rate=0.01)
    a = np.concatenate(list(reads.mate_codes(clean, 4, 0, 1)))
    b = np.concatenate(list(reads.mate_codes(noisy, 4, 0, 1)))
    share = float((a != b).mean())
    sd = (0.01 * 0.99 / a.size) ** 0.5
    assert abs(share - 0.01) < 5 * sd
    # every error-free read lies on a haplotype, on one strand or the other
    haps = ["".join("ACGT"[c] for c in h) for h in reads.haplotypes(cfg, 4, 0)]
    comp = str.maketrans("ACGT", "TGCA")
    hay = haps + [h.translate(comp)[::-1] for h in haps]
    m2 = np.concatenate(list(reads.mate_codes(clean, 4, 0, 2)))
    for row in list(a[:20]) + list(m2[:20]):
        s = "".join("ACGT"[c] for c in row)
        assert any(s in h for h in hay)


def test_samples_share_the_genome():
    cfg = dict(spec.config("snj3", BENCH), genome_bp=50_000)
    a = reads.haplotypes(cfg, 8, 0)
    b = reads.haplotypes(cfg, 8, 2)
    assert (a[0] == b[0]).all()
    assert not (a[1] == b[1]).all()


def test_no_window_twice_or_its_own_reverse_complement():
    """No (k-1)-mer of any haplotype of any sample occurs at two places or
    reads the same on both strands, and few bases were changed for it."""
    cfg = dict(spec.config("snj3", BENCH), genome_bp=200_000)
    m = cfg["k"] - 1
    g = reads.genome(cfg, 2**31 + 17)
    raw = reads._rng(2**31 + 17, 0).integers(0, 4, cfg["genome_bp"], dtype=np.uint8)
    assert int((g != raw).sum()) <= 8
    at: dict[int, set] = {}
    for s in range(len(cfg["samples"])):
        for h in reads.haplotypes(cfg, 2**31 + 17, s):
            vals, pal = reads._windows(h, m)
            assert not pal.any()
            for p, v in enumerate(vals.tolist()):
                at.setdefault(v, set()).add(p)
    assert all(len(p) == 1 for p in at.values())


def test_planted_repeat_and_palindrome_are_broken():
    rng = np.random.default_rng(5)
    g = rng.integers(0, 4, 5000, dtype=np.uint8)
    g[3000:3030] = g[1000:1030]  # a repeat
    half = rng.integers(0, 4, 12, dtype=np.uint8)
    g[4000:4024] = np.concatenate([half, 3 - half[::-1]])  # a palindrome
    out = reads._unique_windows(g, [], 24)
    vals, pal = reads._windows(out, 24)
    assert not pal.any() and len(np.unique(vals)) == len(vals)
    assert 2 <= int((out != g).sum()) <= 12  # a base in each window found twice

"""The read generator: seeded, the recipe's rates, the paired layout."""

import gzip
import hashlib
import math

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


# sha256 of each mate file's FASTQ text at genome_bp 30 000, seed 3000000019,
# as the generator wrote them before it took shared sites and indels
DIGESTS = {
    "snj17": ["8e214578720ac91a05567d898cd733596ef61d5ba1290fc0c80f20fba07ba94a",
              "d46503775042f917e384980a684343353cde57c9b4acc9871fbd14dfbe062dee"],
    "snj3": ["b2fdbf9f7a29d783448b76d2dfb1c72640bb5553ca108fead90b6690a1f09b70",
             "5b2ca4f9d0f9a218a6e766f9c87221f81d3a80c021de89f5a669d4002b53cc46",
             "52f675b0b268c3a2ad9c6aea942747b1a5f484ba46edfe89cea37f11f463abea",
             "cefcb3909ac538179b96d5af9b0f987fb41293fefa893d3d6f7a5e6a2b36b9f2",
             "a3143aa7b8cc31ffd63585944f026c176ad5c2bbe216f35b66ddf7459bae440a",
             "7c3df56bbf37d54ed1f6ab3900832b259daa8118781c8ebe233783d5aacb5af2"],
}


@pytest.mark.parametrize("name", sorted(DIGESTS))
def test_configurations_without_the_new_keys_keep_their_bytes(name, tmp_path):
    cfg = dict(spec.config(name, BENCH), genome_bp=30_000)
    assert not reads.edited(cfg)
    paths, _ = reads.write_all(cfg, 3000000019, str(tmp_path), 1)
    got = [hashlib.sha256(gzip.open(p).read()).hexdigest() for pair in paths for p in pair]
    assert got == DIGESTS[name]


def tetraploid(genome_bp, **kw):
    cfg = dict(spec.config("snj17", BENCH), genome_bp=genome_bp, ploidy=4,
               samples=[{"name": "t", "monoploid_coverage": 18.0, "het": 0.0}],
               shared_site_rate=0.006, shared_site_carry=0.6, indel_rate=0.0003,
               indel_max_len=6, indel_runs_per_mbp=8)
    cfg.update(kw)
    return cfg


def test_shared_sites_give_every_dosage():
    """Each of the three derived haplotypes carries a site with
    probability 0.6: among the sites carried at all, dosage d of 3 has the
    binomial share; some sites show three or four alleles."""
    cfg = tetraploid(400_000, indel_rate=0.0, indel_runs_per_mbp=0)
    haps = np.stack(reads.haplotypes(cfg, 2**31 + 23, 0))
    alt = haps[1:] != haps[0]
    dosage = alt.sum(0)[alt.any(0)]
    p = 0.6
    share0 = (1 - p) ** 3
    n = len(dosage)
    assert abs(n - 400_000 * 0.006 * (1 - share0)) < 5 * math.sqrt(400_000 * 0.006)
    for d in (1, 2, 3):
        want = math.comb(3, d) * p ** d * (1 - p) ** (3 - d) / (1 - share0)
        assert abs(float((dosage == d).mean()) - want) < 5 * math.sqrt(want * (1 - want) / n)
    alleles = np.array([len(set(col)) for col in haps[:, alt.any(0)].T])
    assert (alleles >= 3).sum() > 0.1 * n


def test_indels_lengths_and_clustered_runs():
    cfg = tetraploid(1_000_000)
    g = reads.genome(cfg, 2**31 + 29)
    derived = reads._derived(cfg, 2**31 + 29, 0)
    haps = reads.haplotypes(cfg, 2**31 + 29, 0)
    for (sub, (pos, length, insertion, bases)), h in zip(derived, haps[1:]):
        assert 1 <= length.min() and length.max() <= cfg["indel_max_len"]
        assert set(length.tolist()) == set(range(1, cfg["indel_max_len"] + 1))
        assert abs(float(insertion.mean()) - 0.5) < 5 * math.sqrt(0.25 / len(pos))
        assert len(bases) == int(length[insertion].sum())
        assert len(h) == len(g) + int(length[insertion].sum()) - int(length[~insertion].sum())
        # scattered: about 300 a Mbp; runs: 3 or more single-base indels in 60 bases
        assert abs(len(pos) - 300 - 8 * 4) < 5 * math.sqrt(300)
        single = pos[length == 1]
        clustered = {int(single[i]) for i in range(len(single) - 2)
                     if single[i + 2] - single[i] < reads.RUN_SPAN}
        runs = sorted(clustered)
        starts = [p for i, p in enumerate(runs) if i == 0 or p - runs[i - 1] >= reads.RUN_SPAN]
        assert 5 <= len(starts) <= 10


def test_haplotypes_with_indels_have_no_window_twice_or_palindromic():
    """No (k-1)-mer occurs twice in a haplotype or reads the same on both
    strands, and one value in two haplotypes lies within k - 1 bases of
    one genome position."""
    cfg = tetraploid(300_000)
    m = cfg["k"] - 1
    seed = 2**31 + 31
    g = reads.genome(cfg, seed)
    derived = reads._derived(cfg, seed, 0)
    at: dict[int, list[int]] = {}
    edited = [(g, np.arange(len(g)))] + [reads._edit(reads._apply(g, sub), ev)
                                          for sub, ev in derived]
    assert any(len(h) != len(g) for h, _ in edited)
    for h, coord in edited:
        vals, pal = reads._windows(h, m)
        assert not pal.any()
        assert len(np.unique(vals)) == len(vals)
        for v, c in zip(vals.tolist(), coord[:len(vals)].tolist()):
            at.setdefault(v, []).append(c)
    assert all(max(c) - min(c) <= m - 1 for c in at.values())


def test_a_palindrome_with_four_alleles_at_its_middle_is_broken():
    """A window that reads the same on both strands but for its middle
    base, where three derived haplotypes carry the other three bases: one
    haplotype always holds the palindrome whatever the genome's base, so
    the base changed has to move off the middle."""
    rng = np.random.default_rng(7)
    m = 24
    g = rng.integers(0, 4, 3000, dtype=np.uint8)
    half = rng.integers(0, 4, m // 2, dtype=np.uint8)
    g[2000:2000 + m] = np.concatenate([half, 3 - half[::-1]])
    site = np.array([2000 + m // 2])
    no_indel = (np.zeros(0, np.int64), np.zeros(0, np.int64), np.zeros(0, bool),
                np.zeros(0, np.uint8))
    derived = [((site, np.array([s], dtype=np.uint8)), no_indel) for s in (1, 2, 3)]
    out = reads._unique_windows_edited(g, derived, m)
    for sub, ev in derived:
        _, pal = reads._windows(reads._edit(reads._apply(out, sub), ev)[0], m)
        assert not pal.any()
    assert not reads._windows(out, m)[1].any()

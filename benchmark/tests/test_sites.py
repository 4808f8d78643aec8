"""The reference's site check (benchmark/reference/sites.py, align.py)
against the upstream: on the tables that the upstream binary wrote for
the repository's three golden sets (tests/golden/), with the reference's
own count of each set's reads, every block and every row holds."""

import importlib
import os
import sys

import numpy as np
import pytest
import torch

from benchmark import check
from benchmark.reference import align, graph, kmers, sites
from benchmark.tests.conftest import ROOT

K = 25
CAP = 10000
GOLDEN = {  # set: (module of its reads, function, colored, cutoffs of the fixture run)
    "single_diploid": ("test_golden", "make_reads", False, [(10, 37)]),
    "multi_colored": ("test_golden_colored", "make_sample_reads", True,
                      [(10, 39), (10, 41), (10, 37)]),
    "indel_dense": ("test_golden_indel", "make_indel_reads", False, [(10, 83)]),
}


def fasta_table(path: str) -> tuple[torch.Tensor, torch.Tensor]:
    """(sorted keys, counts capped at CAP) of a FASTA file's reads."""
    lut = np.full(256, 255, dtype=np.uint8)
    for i, ch in enumerate(b"ACGT"):
        lut[ch] = i
    with open(path, "rb") as f:
        reads = [line.strip() for line in f if not line.startswith(b">")]
    parts = []
    for n in sorted({len(r) for r in reads}):
        same = [r for r in reads if len(r) == n]
        codes = torch.from_numpy(lut[np.frombuffer(b"".join(same), dtype=np.uint8)].reshape(-1, n))
        parts.append(kmers.window_keys(codes, K).reshape(-1))
    keys, counts = torch.unique(torch.cat(parts), return_counts=True)
    return keys, counts.clamp_(max=CAP)


def golden_readings(name: str, tmp_path) -> dict:
    module, fn, colored, fixture_cutoffs = GOLDEN[name]
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    try:
        make = getattr(importlib.import_module(module), fn)
    finally:
        sys.path.remove(os.path.join(ROOT, "tests"))
    if colored:
        paths = make(str(tmp_path))
    else:
        paths = [str(tmp_path / "reads.fa")]
        make(paths[0])
    tables = [fasta_table(p) for p in paths]
    cutoffs, filtered = [], []
    for keys, counts in tables:
        hist = kmers.histogram(counts, CAP)
        lo = kmers.cutoff_lower(hist)
        cutoffs.append((lo, kmers.cutoff_upper(hist)))
        filtered.append(keys[counts >= lo])
    assert cutoffs == fixture_cutoffs
    union = torch.unique(torch.cat(filtered))
    gkeys, labels = graph.compacted(union, K)
    gold = os.path.join(ROOT, "tests", "golden", name)
    useqs = check._unitig_ids(os.path.join(gold, "gold_Unitig_Id.txt"))
    assert graph.unitigs_off(gkeys, labels, useqs, K)["off"] == 0
    bub = check._superbubbles(gold, "gold", K, useqs, tables, cutoffs, filtered, "cpu")
    assert bub["off"] == 0
    return sites.check(gold, "gold", K, useqs, bub["search"], bub["facts"], tables, filtered,
                       "cpu")


@pytest.mark.parametrize("name", sorted(GOLDEN))
def test_every_block_and_row_of_the_golden_tables_holds(name, tmp_path):
    res = golden_readings(name, tmp_path)
    assert {n: res[n] for n in ("align_off",) + sites.KINDS} == dict.fromkeys(
        ("align_off",) + sites.KINDS, 0), res
    assert res["_rows_checked"] == res["_rows"] > 0
    assert res["_blocks_bad"] == 0
    assert res["rows_compensated"] == 0
    if name == "indel_dense":  # the sets that need them have gapped and multi-allele blocks
        assert res["_multi_rows"] > 0 and res["_branching_rows"] > 0
    # the bubbles without a block are those the upstream's traceback empties
    assert res["_no_alignment"] == (2 if name == "indel_dense" else 0)


@pytest.mark.parametrize("name", sorted(GOLDEN))
def test_the_upstream_keeps_each_golden_block(name):
    """The reference's run of the upstream's traceback and progressive
    steps keeps, among its alignments, the rows the upstream wrote for
    every block that has gaps or more than two rows."""
    blocks, _ = sites.read_blocks(os.path.join(ROOT, "tests", "golden", name, "gold_alignseq.txt"))
    hard = [b for b in blocks if len(b.rows) > 2 or any("-" in r for r in b.rows)]
    assert len(hard) > 0
    for b in hard:
        assert b.rows in align.upstream_alignments([r.replace("-", "") for r in b.rows]), b.var_id


def _mutate(rng, s: str) -> str:
    s = list(s)
    for _ in range(int(rng.integers(1, 5))):
        p, r = int(rng.integers(1, len(s) - 1)), rng.random()
        if r < 0.4:
            s[p] = "ACGT"[rng.integers(4)]
        elif r < 0.7:
            s[p:p] = list("ACGT"[rng.integers(4)] * int(rng.integers(1, 4)))
        else:
            del s[p:p + int(rng.integers(1, 4))]
    return "".join(s)


def test_the_port_alignments_are_optimal_and_a_moved_gap_is_not():
    """The port's progressive alignments (its own test oracle of the
    upstream's) reach the optimum at every step; row 1 with its first
    gap moved one column to the left mostly does not."""
    from ploidyfrost_tpu_torch.align.msa import SeqAlign

    rng = np.random.default_rng(11)
    good, moved = [], []
    for _ in range(120):
        base = "".join("ACGT"[x] for x in rng.integers(0, 4, int(rng.integers(30, 80))))
        rows, *_ = SeqAlign().sequence_alignment([base] + [_mutate(rng, base)
                                                           for _ in range(int(rng.integers(1, 4)))])
        if not rows:
            continue
        R = [np.frombuffer(r.encode(), dtype=np.uint8) for r in rows]
        good += align.steps(R)
        g = rows[1].find("-")
        if g > 1 and rows[1][g - 1] != "-":
            r1 = rows[1][:g - 1] + "-" + rows[1][g - 1] + rows[1][g + 1:]
            moved += align.steps([R[0], np.frombuffer(r1.encode(), dtype=np.uint8)])
    assert len(good) > 150 and align.optimal(good, "cpu").all()
    assert len(moved) > 40 and align.optimal(moved, "cpu").mean() < 0.1


def test_the_traceback_follows_the_port_oracle():
    """On random branch sets, many with runs of gaps past the cap, the
    reference's traceback keeps the port's alignments (its test oracle of
    the upstream's), and its progressive steps keep none exactly where the
    port's keep none."""
    from ploidyfrost_tpu_torch.align import nw
    from ploidyfrost_tpu_torch.align.msa import SeqAlign

    rng = np.random.default_rng(13)
    empty = 0
    for i in range(150):
        base = "".join("ACGT"[x] for x in rng.integers(0, 4, int(rng.integers(20, 80))))
        edits = 3 if i % 2 else 1
        strs = [base]
        for _ in range(int(rng.integers(1, 4))):
            s = base
            for _ in range(edits):
                s = _mutate(rng, s)
            strs.append(s)
        kept = [(a.str1, a.str2, a.gap_pos) for a in nw.needleman_wunsch(strs[0], strs[1])]
        assert align.traceback(strs[0], strs[1]) == kept
        rows = SeqAlign().sequence_alignment(strs)[0]
        assert bool(align.upstream_alignments(strs)) == bool(rows)
        empty += not rows
    assert empty > 5


@pytest.mark.parametrize("rows, want", [
    (["ACGTA", "ACTTA"], [(2, [1, 2], 0, False)]),
    (["ACGTA", "ACTTA", "ACGAA"], [(2, [1, 2, 1], 0, False), (3, [1, 1, 2], 0, False)]),
    (["AC--TA", "ACGGTA"], [(2, [1, 2], 2, True)]),
    (["AC-GTA", "ACG-TA"], [(2, [1, 2], 1, True), (3, [1, 2], 1, True)]),
    (["AC--TA", "ACG-TA", "ACTATA"], [(2, [1, 2, 3], 1, True), (3, [1, 1, 2], 1, True)]),
    (["AC--TA", "ACGATA", "ACGCTA"], [(2, [1, 2, 2], 2, True), (3, [1, 2, 3], 0, False)]),
])
def test_sites_follow_compare_str_pair(rows, want):
    """A gap run is one site with its length, a change of the gap pattern
    starts another, a later column of the run with three symbols is a site
    of its own; alleles in the order the rows first show them."""
    R = np.stack([np.frombuffer(r.encode(), dtype=np.uint8) for r in rows])
    assert sites.sites_of(R) == want


def test_sites_match_the_port_compare_str_pair():
    from ploidyfrost_tpu_torch.align.msa import SeqAlign

    rng = np.random.default_rng(12)
    n = 0
    for _ in range(200):
        base = "".join("ACGT"[x] for x in rng.integers(0, 4, int(rng.integers(30, 70))))
        rows, snp, indel, part, lens = SeqAlign().sequence_alignment(
            [base] + [_mutate(rng, base) for _ in range(int(rng.integers(1, 4)))])
        if not rows:
            continue
        got = sites.sites_of(np.stack([np.frombuffer(r.encode(), dtype=np.uint8) for r in rows]))
        cols = [c for c in range(len(part)) if part[c][-1] > 0]
        assert [g[0] for g in got] == cols
        assert [g[1] for g in got] == [part[c] for c in cols]
        assert [g[0] for g in got if g[3]] == indel
        # a run that reaches the last column never closes: no VarType
        assert [g[2] for g in got if g[3] and g[2] is not None] == lens
        n += len(got)
    assert n > 300


def test_frequencies_over_the_left_to_right_sum_and_the_compensated_one():
    """The upstream adds a row's coverages left to right in doubles; the
    port's Python sum() compensates. For 923/25, 514/25, 483/25 the last
    frequency prints 0.251562 one way and 0.251563 the other: a row is the
    same (1) by the first, accepted and counted apart (2) by the second,
    and different (0) by neither."""
    covs = [923 / 25, 514 / 25, 483 / 25]
    fres, alt = sites._frequencies(covs, covs)
    assert [f"{x:.6g}" for x in fres][2] == "0.251562"
    assert [f"{x:.6g}" for x in alt][2] == "0.251563"
    row = sites.Row()
    row.n, row.covs, row.color, row.simple = 3, ["36.92", "20.56", "19.32"], 0, True
    row.vt, row.var_id, row.var_num, row.var_dis = 0, 7, 1, 27
    expected = (3, covs, fres, alt, 0, True, 0, 7, 1, 27)
    for printed, verdict in (("0.251562", 1), ("0.251563", 2), ("0.251564", 0)):
        row.fre = ["0.480729", "0.267708", printed]
        assert row.same(expected) == verdict

"""Alignment tests of the port (align/nw.py, align/msa.py): wavefront DP
vs literal scalar port, traceback behavior, and progressive MSA on
bubble-shaped inputs. The cases of tests/test_align.py, run against
ploidyfrost_tpu_torch; the MSA cases also hold the port's result equal
to the JAX package's."""

import numpy as np
import pytest

from ploidyfrost_tpu.align.msa import SeqAlign as JaxSeqAlign
from ploidyfrost_tpu_torch.align.msa import SeqAlign
from ploidyfrost_tpu_torch.align.nw import (
    _nw_matrix,
    _nw_matrix_scalar,
    needleman_wunsch,
    variant_analyze,
)

M, D, G = 2.0, -1.0, -3.0


def _jax_msa(strs):
    return tuple(JaxSeqAlign(M, D, G).sequence_alignment(list(strs)))


@pytest.mark.parametrize("seed", range(8))
def test_wavefront_matches_scalar(seed):
    rng = np.random.default_rng(seed)
    n1 = rng.integers(3, 40)
    n2 = rng.integers(3, 40)
    A = "".join(rng.choice(list("ACGT"), n1))
    B = "".join(rng.choice(list("ACGT"), n2))
    for a, b in [(A, B), (A + "-" * 3 + A, B)]:
        w = _nw_matrix(a, b, M, D, G)
        s = _nw_matrix_scalar(a, b, M, D, G)
        for wm, sm in zip(w, s):
            np.testing.assert_array_equal(wm, sm)


def test_identical_strings():
    aus = needleman_wunsch("ACGTACGT", "ACGTACGT", M, D, G)
    assert len(aus) == 1
    assert aus[0].str1 == "ACGTACGT"
    assert aus[0].str2 == "ACGTACGT"
    assert aus[0].snp == 0 and aus[0].indel == 0


def test_single_snp():
    aus = needleman_wunsch("ACGTACGT", "ACGAACGT", M, D, G)
    assert len(aus) >= 1
    au = aus[0]
    assert au.str1 == "ACGTACGT"
    assert au.str2 == "ACGAACGT"
    assert au.snp == 1 and au.indel == 0
    assert au.pos == [3]


def test_single_insertion():
    # B has one extra base
    aus = needleman_wunsch("ACGTACGT", "ACGTTACGT", M, D, G)
    au = aus[0]
    assert au.indel == 1
    assert au.snp == 0
    assert "-" in au.str1 or "+" in au.str1 or len(au.str1) == len(au.str2)


def test_variant_analyze_counts():
    au = variant_analyze("AC-TA", "ACGTT", M, D, G)
    assert au.indel == 1
    assert au.snp == 1
    assert au.pos == [2, 4]
    # score: 2 + 2 + (-3) + 2 + (-1) = 2
    assert au.score == 2


def test_variant_analyze_min_distance_quirk():
    # multiple positions: final term uses pos[0], not pos.back()
    # (src/SeqAlign.cpp:296-302)
    au = variant_analyze("AAAACAAAAT", "AAAAGAAAAA", M, D, G)
    assert au.pos == [4, 9]
    # min( pos[1]-pos[0]-1 = 4, len-pos[0]-1 = 5, start pos[0]=4 ) -> 4
    assert au.min_distance == 4


def test_msa_three_branches_snp():
    # three bubble branches sharing flanks, SNP in the middle
    sa = SeqAlign(M, D, G)
    strs = ["AAAACGTTT", "AAAAGGTTT", "AAAATGTTT"]
    rows, snp_pos, indel_pos, partition, indel_len = sa.sequence_alignment(list(strs))
    assert (rows, snp_pos, indel_pos, partition, indel_len) == _jax_msa(strs)
    assert len(rows) == 3
    assert snp_pos == [4]
    assert indel_pos == []
    # partition at the SNP column: three distinct alleles 1,2,3
    assert sorted(partition[4]) == [1, 2, 3]
    # non-variant columns all zeros
    assert partition[0] == [0, 0, 0]


def test_msa_two_branches_indel():
    sa = SeqAlign(M, D, G)
    strs = ["AAAACCGGTTT", "AAAACGGTTT"]  # one-base deletion in branch 2
    rows, snp_pos, indel_pos, partition, indel_len = sa.sequence_alignment(list(strs))
    assert (rows, snp_pos, indel_pos, partition, indel_len) == _jax_msa(strs)
    assert len(rows) == 2
    assert len(indel_pos) == 1
    assert indel_len[0] >= 1
    assert any("-" in r for r in rows)


def test_msa_deterministic_under_candidate_ties():
    sa = SeqAlign(M, D, G)
    strs = ["ACACACACAC", "ACACACAC"]
    r1 = sa.sequence_alignment(list(strs))
    r2 = sa.sequence_alignment(list(strs))
    assert r1[0] == r2[0]
    assert tuple(r1) == _jax_msa(strs)

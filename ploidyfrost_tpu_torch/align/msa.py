# Copied from ploidyfrost_tpu/align/msa.py; imports point at this package.
"""Progressive multiple alignment + final-candidate selection.

Exact behavioral port of SeqAlign::SequenceAlignment
(src/SeqAlign.cpp:550-640) and compareStrPair (src/SeqAlign.cpp:8-236).

The progressive phase re-aligns the FIRST row of each candidate MSA to
every additional sequence, propagates the new gaps into the other rows
via gap_pos splicing, scores each row pair with variantAnalyze, and keeps
the co-optimal candidate set. compareStrPair then picks the final MSA by
the cascade: fewest snp+indel sites, fewest indels, largest indel
spacing, largest snp spacing, largest overall spacing, right-most
site extremes, lexicographically-greatest rows — and extracts the
per-column allele partition + snp/indel positions.
"""

from __future__ import annotations

from .nw import INT_MAX, INT_MIN, needleman_wunsch, variant_analyze


class SeqAlign:
    """API mirror of class SeqAlign (src/SeqAlign.hpp:7-22)."""

    def __init__(self, match: float = 2.0, dis_match: float = -1.0, gap: float = -3.0):
        self.match = match
        self.dis_match = dis_match
        self.gap = gap

    def needleman_wunsch(self, A: str, B: str):
        return needleman_wunsch(A, B, self.match, self.dis_match, self.gap)

    def variant_analyze(self, A: str, B: str):
        return variant_analyze(A, B, self.match, self.dis_match, self.gap)

    # -- final selection -------------------------------------------------

    def compare_str_pair(self, str_pairs: list[list[str]]):
        """compareStrPair (src/SeqAlign.cpp:8-236).

        Returns (max_pair, snp_pos, indel_pos, num_all, indel_len).
        """

        def compute_dis(v: list[int]) -> int:
            # src/SeqAlign.cpp:10-38 — note the reference-length quirk:
            # distances measure against the LAST candidate's LAST row
            count = 0
            if v:
                ref_len = len(str_pairs[-1][-1])
                if len(v) == 1:
                    left = v[0]
                    right = ref_len - v[0] - 1
                    if left > right:
                        count = left + 1
                    else:
                        count = right
                else:
                    count = v[0]
                    for i in range(1, len(v)):
                        count = min(v[i] - v[i - 1] - 1, count)
                    count = min(count, ref_len - v[-1] - 1)
            return count

        max_pair: list[str] = []
        max_snp_pos: list[int] = []
        max_indel_pos: list[int] = []
        max_num_all: list[list[int]] = []
        max_indel_len: list[int] = []
        snp_dis = INT_MAX
        indel_dis = INT_MAX
        snp_count = INT_MAX // 2
        indel_count = INT_MAX // 2
        all_dis = INT_MAX
        site_l = -1
        site_r = -1
        for cand in str_pairs:
            snp_pos: list[int] = []
            indel_pos: list[int] = []
            indel_len: list[int] = []
            num_all: list[list[int]] = []
            INDEL = False
            indel = 0
            snp = 0
            nrows = len(cand)
            last = cand[-1]
            for j in range(len(last)):
                col = [row[j] for row in cand]
                char_set = set(col)
                num = [0] * nrows
                if len(char_set) > 1:
                    if "-" not in char_set:
                        if INDEL:
                            indel_len.append(j - indel_pos[indel - 1])
                            INDEL = False
                        snp_pos.append(j)
                        snp += 1
                        count_snp = 0
                        for ki in range(nrows):
                            is_same = False
                            for kj in range(ki):
                                if col[kj] == col[ki]:
                                    is_same = True
                                    num[ki] = num[kj]
                                    break
                            if not is_same:
                                count_snp += 1
                                num[ki] = count_snp
                    else:
                        old_indel = True
                        if INDEL:
                            for kj in range(nrows):
                                if (cand[kj][j] == "-" and cand[kj][j - 1] != "-") or (
                                    cand[kj][j] != "-" and cand[kj][j - 1] == "-"
                                ):
                                    old_indel = False
                                    break
                            if not old_indel:
                                indel_len.append(j - indel_pos[indel - 1])
                                indel += 1
                                indel_pos.append(j)
                        else:
                            old_indel = False
                            indel += 1
                            indel_pos.append(j)
                            INDEL = True
                        if not old_indel or len(char_set) > 2:
                            count_char = 0
                            for ki in range(nrows):
                                is_same = False
                                for kii in range(ki):
                                    if cand[kii][j] == cand[ki][j]:
                                        is_same = True
                                        num[ki] = num[kii]
                                        break
                                    else:
                                        is_same = False
                                if not is_same:
                                    count_char += 1
                                    num[ki] = count_char
                else:
                    if INDEL:
                        indel_len.append(j - indel_pos[indel - 1])
                        INDEL = False
                num_all.append(num)
            # --- tie-break cascade (src/SeqAlign.cpp:158-233) ---
            flag = False
            if snp + indel < snp_count + indel_count:
                flag = True
            elif snp + indel == snp_count + indel_count:
                if indel < indel_count:
                    flag = True
                elif indel == indel_count:
                    now_indel_dis = compute_dis(indel_pos)
                    if now_indel_dis > indel_dis:
                        flag = True
                    elif now_indel_dis == indel_dis:
                        now_snp_dis = compute_dis(snp_pos)
                        if now_snp_dis > snp_dis:
                            flag = True
                        elif now_snp_dis == snp_dis:
                            temp_vec = sorted(snp_pos + indel_pos)
                            now_all_dis = compute_dis(temp_vec)
                            if now_all_dis > all_dis:
                                flag = True
                            elif now_all_dis == all_dis:
                                now_site_l = temp_vec[0] if temp_vec else INT_MIN
                                now_site_r = temp_vec[-1] if temp_vec else INT_MIN
                                if now_site_l > site_l or now_site_r > site_r:
                                    flag = True
                                elif now_site_l == site_l and now_site_r == site_r:
                                    for m in range(nrows):
                                        if cand[m] > max_pair[m]:
                                            all_dis = now_all_dis
                                            site_l = now_site_l
                                            site_r = now_site_r
                                            snp_count = snp
                                            indel_count = indel
                                            snp_dis = now_snp_dis
                                            indel_dis = now_indel_dis
                                            max_pair = cand
                                            max_snp_pos = snp_pos
                                            max_indel_pos = indel_pos
                                            max_num_all = num_all
                                            max_indel_len = indel_len
                                            break
            if flag:
                temp_vec = sorted(snp_pos + indel_pos)
                all_dis = compute_dis(temp_vec)
                # quirk: max() with the previous extremes, not assignment
                # (src/SeqAlign.cpp:222-223)
                site_l = max(site_l, temp_vec[0] if temp_vec else -1)
                site_r = max(site_r, temp_vec[-1] if temp_vec else -1)
                snp_count = snp
                indel_count = indel
                snp_dis = compute_dis(snp_pos)
                indel_dis = compute_dis(indel_pos)
                max_pair = cand
                max_snp_pos = snp_pos
                max_indel_pos = indel_pos
                max_num_all = num_all
                max_indel_len = indel_len
        return max_pair, max_snp_pos, max_indel_pos, max_num_all, max_indel_len

    def sequence_alignment_gapless(self, strs: list[str]):
        """SequenceAlignment for branch sets where EVERY pairwise NW has
        the unique gapless-diagonal optimum (equal lengths, <=2
        mismatches per pair under the default scoring — the provable
        condition of emit._fast_snp_positions, applied pairwise): the
        progressive MSA collapses to the stacked input rows with no gap
        propagation and a singleton candidate set, so only
        compareStrPair runs. tests/test_fastpath.py cross-validates
        against sequence_alignment on random multi-branch sets."""
        return self.compare_str_pair([list(strs)])

    # -- progressive MSA ---------------------------------------------------

    def sequence_alignment(self, strs: list[str], first_align=None):
        """SequenceAlignment (src/SeqAlign.cpp:550-640).

        Returns (aligned_rows, snp_pos, indel_pos, partition, indel_len)
        where aligned_rows replaces the input vector (the reference
        mutates `str` in place).

        first_align: optional precomputed needleman_wunsch(strs[0],
        strs[1]) result — the device-batched analysis phase computes the
        first-pair alignments of ALL bubbles in one kernel call and
        passes them in here (align/batch_nw.py).
        """
        align_vec = (
            first_align
            if first_align is not None
            else self.needleman_wunsch(strs[0], strs[1])
        )
        str_pairs: list[list[str]] = [[au.str1, au.str2] for au in align_vec]
        for i in range(2, len(strs)):
            temp_pairs = str_pairs
            str_pairs = []
            max_score = INT_MIN
            for kk in range(len(temp_pairs)):
                max_score_k = 0
                align_temp = self.needleman_wunsch(temp_pairs[kk][0], strs[i])
                str_pair_vec_all: list[list[str]] = [
                    [au.str1] for au in align_temp
                ]
                valid_au_pos = list(range(len(align_temp)))
                for j in range(1, i):
                    max_score_j = INT_MIN
                    au_max = None
                    valid_au_pos_j: list[int] = []
                    for c in valid_au_pos:
                        gp = align_temp[c].gap_pos
                        if gp:
                            pre = 0
                            parts = []
                            for s in range(len(gp) - 1, -1, -1):
                                parts.append(temp_pairs[kk][j][pre : gp[s]])
                                parts.append("-")
                                pre = gp[s]
                            parts.append(temp_pairs[kk][j][pre:])
                            temp_str = "".join(parts)
                        else:
                            temp_str = temp_pairs[kk][j]
                        au = self.variant_analyze(temp_str, align_temp[c].str2)
                        diff = 1 if au_max is None else au.cmp(au_max)
                        if diff > 0:
                            au_max = au
                            max_score_j = au_max.score
                            valid_au_pos_j = [c]
                            str_pair_vec_all[c].append(temp_str)
                        elif diff == 0:
                            max_score_j = au_max.score
                            valid_au_pos_j.append(c)
                            str_pair_vec_all[c].append(temp_str)
                    valid_au_pos = valid_au_pos_j
                    max_score_k += max_score_j
                if max_score_k > max_score:
                    max_score = max_score_k
                    str_pairs = []
                    for c in valid_au_pos:
                        str_pair_vec_all[c].append(align_temp[c].str2)
                        str_pairs.append(str_pair_vec_all[c])
                elif max_score_k == max_score:
                    for c in valid_au_pos:
                        str_pair_vec_all[c].append(align_temp[c].str2)
                        str_pairs.append(str_pair_vec_all[c])
        return self.compare_str_pair(str_pairs)

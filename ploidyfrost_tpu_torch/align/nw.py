# Copied from ploidyfrost_tpu/align/nw.py; imports point at this package.
"""Needleman-Wunsch with co-optimal traceback enumeration.

Exact behavioral port of src/SeqAlign.cpp:237-549, with the DP matrix
computed as a vectorized anti-diagonal wavefront (numpy; the same
recurrence is the Pallas batch kernel's shape) instead of the reference's
scalar double loop.

Reference quirks replicated deliberately (all output-visible):
  * +1 continuation bonus when extending a move in the same direction as
    the predecessor cell's recorded move (src/SeqAlign.cpp:512-525).
  * a Left move into a position where the NEXT char of A is '-' is
    forbidden (src/SeqAlign.cpp:528-532).
  * scores are accumulated into integer cells — C++ truncates the double
    score_func result on every assignment (int up_score = ...).
  * the traceback enumerates ALL co-optimal paths but caps gap-run
    counts at 5 per sequence, *tightening* the cap to the best
    alignment's run counts as it goes (src/SeqAlign.cpp:313-354);
    the indel2 counter is incremented when CONTINUING a run (resB[0]
    == '-') — inverted w.r.t. indel1 (src/SeqAlign.cpp:395-400) — and
    both decrement on run boundaries when backtracking.
  * AlignUnit ordering: score desc, then fewer variant positions, then
    fewer indels (src/SeqAlign.hpp:43-67).
  * variantAnalyze's min_distance mixes pos[0] into the final term
    (src/SeqAlign.cpp:296-302).
"""

from __future__ import annotations

from collections import deque

import numpy as np

INT_MIN = -(2**31)
INT_MAX = 2**31 - 1


class AlignUnit:
    """Mirror of struct AlignUnit (src/SeqAlign.hpp:30-68)."""

    __slots__ = (
        "str1",
        "str2",
        "gap_pos",
        "score",
        "pos",
        "snp",
        "indel",
        "min_distance",
    )

    def __init__(self):
        self.str1 = ""
        self.str2 = ""
        self.gap_pos: list[int] = []
        self.score = 0
        self.pos: list[int] = []
        self.snp = 0
        self.indel = 0
        self.min_distance = 0

    def cmp(self, x: "AlignUnit") -> int:
        """self - x: >0 self better, 0 tie, <0 x better
        (src/SeqAlign.hpp:43-67)."""
        if self.score == x.score:
            if len(self.pos) == len(x.pos):
                if self.indel == x.indel:
                    return 0
                return x.indel - self.indel
            return len(x.pos) - len(self.pos)
        return 1 if self.score > x.score else -1


def variant_analyze(A: str, B: str, match: float, dis_match: float, gap: float) -> AlignUnit:
    """variantAnalyze (src/SeqAlign.cpp:237-305)."""
    au = AlignUnit()
    au.score = 0
    au.str1 = A
    au.str2 = B
    flag = 0
    score = 0.0
    int_score = 0
    for i in range(len(A)):
        a, b = A[i], B[i]
        if a == "-" or b == "-":
            s = gap
        elif a == b:
            s = match
        else:
            s = dis_match
        # au.score is a C++ long: += double truncates the SUM toward zero
        int_score = int(int_score + s)
        if a != b:
            if a == "-":
                if flag != 1:
                    flag = 1
                    au.indel += 1
                    au.pos.append(i)
            elif b == "-":
                if flag != 2:
                    flag = 2
                    au.indel += 1
                    au.pos.append(i)
            else:
                au.snp += 1
                flag = 0
                au.pos.append(i)
        else:
            flag = 0
    au.score = int_score
    if au.pos:
        if len(au.pos) == 1:
            au.min_distance = min(au.pos[0], len(A) - au.pos[0] - 1)
        else:
            au.min_distance = au.pos[0]
            for i in range(len(au.pos) - 1, 0, -1):
                au.min_distance = min(au.pos[i] - au.pos[i - 1] - 1, au.min_distance)
            au.min_distance = min(len(A) - au.pos[0] - 1, au.min_distance)
    return au


def _nw_matrix(A: str, B: str, match: float, dis_match: float, gap: float):
    """DP matrix as an anti-diagonal wavefront (vectorized).

    Returns (Up, LeftUp, Left) uint8 arrays of shape (m+1, n+1).
    Recurrence per cell (src/SeqAlign.cpp:508-546):
        up     = score[i-1,j]   + gap + (Up[i-1,j] == 1)
        leftup = score[i-1,j-1] + s(A[i-1],B[j-1]) + (LeftUp[i-1,j-1]==1)
        left   = score[i,j-1]   + gap + (Left[i,j-1] == 1)
        max3; if max == left and i != m and A[i] == '-':
            left = INT_MIN; max = max(up, leftup)
        flags = (dir == max)
    """
    m, n = len(A), len(B)
    score = np.zeros((m + 1, n + 1), dtype=np.int64)
    Up = np.zeros((m + 1, n + 1), dtype=np.uint8)
    LeftUp = np.zeros((m + 1, n + 1), dtype=np.uint8)
    Left = np.zeros((m + 1, n + 1), dtype=np.uint8)
    gi = np.arange(m + 1, dtype=np.float64) * gap
    score[:, 0] = np.trunc(gi).astype(np.int64)
    gj = np.arange(n + 1, dtype=np.float64) * gap
    score[0, :] = np.trunc(gj).astype(np.int64)
    Up[1:, 0] = 1
    Left[0, 1:] = 1

    a = np.frombuffer(A.encode(), dtype=np.uint8)
    b = np.frombuffer(B.encode(), dtype=np.uint8)
    # substitution score for (A[i-1], B[j-1]): a==b -> match,
    # '-' either -> gap, else dis_match  (NW order, src/SeqAlign.cpp:498-506)
    dash = ord("-")
    sub = np.where(
        a[:, None] == b[None, :],
        match,
        np.where((a[:, None] == dash) | (b[None, :] == dash), gap, dis_match),
    )
    # next-char-of-A is '-' mask for the forbidden-Left rule: applies at
    # row i when i != m and A[i] == '-' (0-based A[i] = next char)
    a_next_dash = np.zeros(m + 1, dtype=bool)
    if m > 1:
        a_next_dash[1:m] = a[1:] == dash

    # wavefront over anti-diagonals d = i + j, i in [1..m], j in [1..n]
    for d in range(2, m + n + 1):
        i_lo = max(1, d - n)
        i_hi = min(m, d - 1)
        if i_lo > i_hi:
            continue
        i = np.arange(i_lo, i_hi + 1)
        j = d - i
        # C++ truncates the double SUM into an int, THEN adds the bonus
        up = np.trunc(score[i - 1, j] + gap).astype(np.int64) + (Up[i - 1, j] == 1)
        leftup = np.trunc(score[i - 1, j - 1] + sub[i - 1, j - 1]).astype(
            np.int64
        ) + (LeftUp[i - 1, j - 1] == 1)
        left = np.trunc(score[i, j - 1] + gap).astype(np.int64) + (
            Left[i, j - 1] == 1
        )
        mx = np.maximum(np.maximum(up, leftup), left)
        forbid = (mx == left) & (i != m) & a_next_dash[i]
        left = np.where(forbid, INT_MIN, left)
        mx = np.where(forbid, np.maximum(up, leftup), mx)
        score[i, j] = mx
        Up[i, j] = (up == mx).astype(np.uint8)
        LeftUp[i, j] = (leftup == mx).astype(np.uint8)
        Left[i, j] = (left == mx).astype(np.uint8)
    return Up, LeftUp, Left


def _nw_matrix_scalar(A: str, B: str, match: float, dis_match: float, gap: float):
    """Literal scalar port of the reference DP (test oracle for the
    wavefront; src/SeqAlign.cpp:480-548)."""
    m, n = len(A), len(B)
    score = [[0] * (n + 1) for _ in range(m + 1)]
    Up = [[0] * (n + 1) for _ in range(m + 1)]
    LeftUp = [[0] * (n + 1) for _ in range(m + 1)]
    Left = [[0] * (n + 1) for _ in range(m + 1)]
    for i in range(1, m + 1):
        score[i][0] = int(gap * i)
        Up[i][0] = 1
    for j in range(1, n + 1):
        score[0][j] = int(gap * j)
        Left[0][j] = 1

    def sf(x, y):
        if x == y:
            return match
        if x == "-" or y == "-":
            return gap
        return dis_match

    for i in range(1, m + 1):
        for j in range(1, n + 1):
            up = int(score[i - 1][j] + gap)
            if Up[i - 1][j] == 1:
                up += 1
            leftup = int(score[i - 1][j - 1] + sf(A[i - 1], B[j - 1]))
            if LeftUp[i - 1][j - 1] == 1:
                leftup += 1
            left = int(score[i][j - 1] + gap)
            if Left[i][j - 1] == 1:
                left += 1
            mx = max(up, leftup, left)
            if mx == left and i != m and A[i] == "-":
                left = INT_MIN
                mx = up if up > leftup else leftup
            score[i][j] = mx
            Up[i][j] = 1 if up == mx else 0
            LeftUp[i][j] = 1 if leftup == mx else 0
            Left[i][j] = 1 if left == mx else 0
    return (
        np.array(Up, dtype=np.uint8),
        np.array(LeftUp, dtype=np.uint8),
        np.array(Left, dtype=np.uint8),
    )


def _traceback(Up, LeftUp, Left, str1: str, str2: str, match, dis_match, gap):
    """traceback (src/SeqAlign.cpp:306-478): stack-driven enumeration of
    co-optimal alignments with the (quirky) gap-run caps."""
    au_vec: list[AlignUnit] = []
    stack: list[tuple[int, int]] = [(len(str1), len(str2))]
    resA: deque[str] = deque()  # built right-to-left: resA[0] is the head
    resB: deque[str] = deque()
    indel1 = 0
    indel2 = 0
    indel1_max = 5
    indel2_max = 5
    # matrix (permanent kills) and matrix_temp (per-path consumption)
    M_Up, M_LeftUp, M_Left = Up.copy(), LeftUp.copy(), Left.copy()
    T_Up, T_LeftUp, T_Left = Up.copy(), LeftUp.copy(), Left.copy()
    gap_pos: list[int] = []

    while stack:
        pi, pj = stack[-1]
        if pi == 0 and pj == 0 and indel1 <= indel1_max and indel2 <= indel2_max:
            res_temp = list(resA)
            gl = len(gap_pos)
            for j in range(gl):
                res_temp[gap_pos[j] + gl - j - 1] = "-"
            au = variant_analyze("".join(res_temp), "".join(resB), match, dis_match, gap)
            au.gap_pos = list(gap_pos)
            if au_vec:
                diff = au_vec[-1].cmp(au)
                if diff == 0:
                    au_vec.append(au)
                    indel1_max = indel1
                    indel2_max = indel2
                elif diff < 0:
                    au_vec.clear()
                    au_vec.append(au)
                    indel1_max = indel1
                    indel2_max = indel2
            else:
                au_vec.append(au)
                indel1_max = indel1
                indel2_max = indel2
        if T_Left[pi, pj]:
            if indel1 < indel1_max:
                if not resA or resA[0] != "+":
                    indel1 += 1
                stack.append((pi, pj - 1))
                resA.appendleft("+")
                gap_pos.append(pi)
                resB.appendleft(str2[pj - 1])
            elif indel1 == indel1_max:
                if resA[0] != "+":
                    M_Left[pi, pj] = 0
                    T_Left[pi, pj] = 0
                    continue
                else:
                    stack.append((pi, pj - 1))
                    resA.appendleft("+")
                    gap_pos.append(pi)
                    resB.appendleft(str2[pj - 1])
            else:
                M_Left[pi, pj] = 0
                T_Left[pi, pj] = 0
                continue
            T_Left[pi, pj] = 0
        elif T_Up[pi, pj]:
            if indel2 < indel2_max:
                # NOTE: increments when CONTINUING a '-' run — the
                # reference's inverted condition (src/SeqAlign.cpp:395-400)
                if not resB or resB[0] == "-":
                    indel2 += 1
                stack.append((pi - 1, pj))
                resA.appendleft(str1[pi - 1])
                resB.appendleft("-")
            elif indel2 == indel2_max:
                if resB[0] != "-":
                    T_Up[pi, pj] = 0
                    M_Up[pi, pj] = 0
                    continue
                stack.append((pi - 1, pj))
                resA.appendleft(str1[pi - 1])
                resB.appendleft("-")
            else:
                T_Up[pi, pj] = 0
                M_Up[pi, pj] = 0
                continue
            T_Up[pi, pj] = 0
        elif T_LeftUp[pi, pj]:
            stack.append((pi - 1, pj - 1))
            resA.appendleft(str1[pi - 1])
            resB.appendleft(str2[pj - 1])
            T_LeftUp[pi, pj] = 0
        else:
            if not resA:
                break
            stack.pop()
            T_Up[pi, pj] = M_Up[pi, pj]
            T_LeftUp[pi, pj] = M_LeftUp[pi, pj]
            T_Left[pi, pj] = M_Left[pi, pj]
            if resA[0] == "+":
                if len(resA) >= 2:
                    if resA[1] != "+":
                        indel1 -= 1
                else:
                    indel1 -= 1
            if resB[0] == "-":
                if len(resB) >= 2:
                    if resB[1] != "-":
                        indel2 -= 1
                else:
                    indel2 -= 1
            if resA[0] == "+":
                gap_pos.pop()
            resA.popleft()
            resB.popleft()
    return au_vec


def nw_matrices_native(
    pairs: list[tuple[str, str]], match: float, dis_match: float, gap: float
):
    """Batch DP flag matrices via the native C kernel
    (native/nw_flags.cpp). Returns a list of (Up, LeftUp, Left) uint8
    arrays identical to _nw_matrix per pair, or None when the kernel is
    unavailable or the scoring parameters are not integers."""
    if not all(float(v).is_integer() for v in (match, dis_match, gap)):
        return None
    from ..native import load_nw_library

    lib = load_nw_library()
    if lib is None:
        return None
    import ctypes

    n = len(pairs)
    a_off = np.zeros(n + 1, np.int64)
    b_off = np.zeros(n + 1, np.int64)
    o_off = np.zeros(n + 1, np.int64)
    for i, (A, B) in enumerate(pairs):
        a_off[i + 1] = a_off[i] + len(A)
        b_off[i + 1] = b_off[i] + len(B)
        o_off[i + 1] = o_off[i] + 3 * (len(A) + 1) * (len(B) + 1)
    abuf = np.frombuffer(
        ("".join(A for A, _ in pairs)).encode() or b"\0", dtype=np.uint8
    )
    bbuf = np.frombuffer(
        ("".join(B for _, B in pairs)).encode() or b"\0", dtype=np.uint8
    )
    out = np.empty(int(o_off[-1]) or 1, dtype=np.uint8)

    def u8p(arr):
        return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))

    def i64p(arr):
        return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))

    lib.pf_nw_flags_batch(
        u8p(abuf), i64p(a_off), u8p(bbuf), i64p(b_off),
        ctypes.c_int64(n),
        ctypes.c_int32(int(match)), ctypes.c_int32(int(dis_match)),
        ctypes.c_int32(int(gap)),
        u8p(out), i64p(o_off),
    )
    results = []
    for i, (A, B) in enumerate(pairs):
        m, nn = len(A), len(B)
        cells = (m + 1) * (nn + 1)
        base = out[int(o_off[i]) : int(o_off[i + 1])]
        results.append(
            (
                base[:cells].reshape(m + 1, nn + 1),
                base[cells : 2 * cells].reshape(m + 1, nn + 1),
                base[2 * cells :].reshape(m + 1, nn + 1),
            )
        )
    return results


def needleman_wunsch(
    A: str, B: str, match: float = 2.0, dis_match: float = -1.0, gap: float = -3.0
) -> list[AlignUnit]:
    """needlemanWunch (src/SeqAlign.cpp:480-549)."""
    nat = nw_matrices_native([(A, B)], match, dis_match, gap)
    if nat is not None:
        Up, LeftUp, Left = nat[0]
    else:
        Up, LeftUp, Left = _nw_matrix(A, B, match, dis_match, gap)
    return _traceback(Up, LeftUp, Left, A, B, match, dis_match, gap)

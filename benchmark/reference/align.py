"""Plain reference of the site tables' alignments: is each block of
`<out>_alignseq.txt` an optimal alignment under the upstream's scoring?

The upstream aligns a bubble's branches progressively
(SeqAlign::SequenceAlignment, PloidyFrost src/SeqAlign.cpp:550-640):
row 0 against row 1 first, then, for each further row i, row 0 as it
stands by then (with its gaps) against branch i, each new gap spliced
into every row before. Each step is the upstream's global alignment
(needlemanWunch, src/SeqAlign.cpp:480-549): match 2, mismatch -1, gap
-3 (a gap in the first string scores as a gap against any base), one
point more for a step in the direction its predecessor cell recorded,
and no step to the left into a row whose next character of the first
string is a gap. The first row and column hold gap * index.

From a block the step of row i is read back: the first string is row
0 over the columns that some row before i fills, the second is row i
without its gaps, and the path takes the columns that some row up to
i fills (a column no row before i fills is a step to the left, one
where row i has a gap a step up, any other a diagonal step). The path
scores as the upstream's recurrence scores it, from where it leaves
the first row or column; it has to reach the optimum of the whole
table. The tables are filled for all pairs at once, an anti-diagonal a
step, in torch on the given device; pairs are grouped by size, and a
table is held by its anti-diagonals, so that each step reads slices.

Which alignment the upstream keeps is recomputed only where a bubble
has no block: `traceback` and `upstream_alignments` run the upstream's
traceback (its caps on runs of gaps, src/SeqAlign.cpp:306-478) and its
progressive steps again, on the host, one bubble at a time, and give
the alignments it keeps; where there are none, the upstream writes no
block. compareStrPair's choice among them (src/SeqAlign.cpp:8-236) is
not recomputed.
"""

from __future__ import annotations

import numpy as np
import torch

MATCH, MISMATCH, GAP = 2, -1, -3
GAP_CODE = ord("-")
UP, DIAG, LEFT = 0, 1, 2
CELLS = 1 << 24  # table cells of one group of pairs: bounds the device memory


def steps(rows: list[np.ndarray]) -> list[tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """(first string, second string, moves) of each progressive step
    i = 1 .. len(rows) - 1 of a block; rows as uint8 arrays of one length."""
    gap = np.stack(rows) == GAP_CODE
    out = []
    before = ~gap[0]  # columns some row before i fills
    for i in range(1, len(rows)):
        upto = before | ~gap[i]
        move = np.where(~before, LEFT, np.where(gap[i], UP, DIAG))[upto]
        out.append((rows[0][before], rows[i][~gap[i]], move.astype(np.int8)))
        before = upto
    return out


def _padded(parts: list[np.ndarray], lens: np.ndarray, width: int, fill: int, dtype) -> np.ndarray:
    out = np.full((len(parts), width), fill, dtype=dtype)
    flat = np.concatenate(parts) if parts else np.zeros(0, dtype)
    rows = np.repeat(np.arange(len(parts)), lens)
    cols = np.arange(len(flat)) - np.repeat(np.cumsum(lens) - lens, lens)
    out[rows, cols] = flat
    return out


def _group(pairs, device) -> tuple[np.ndarray, np.ndarray]:
    """(path score, optimum) of each pair of one group."""
    P = len(pairs)
    lm = np.array([len(a) for a, _, _ in pairs])
    ln = np.array([len(b) for _, b, _ in pairs])
    lt = np.array([len(x) for _, _, x in pairs])
    M, N, T = int(lm.max()), int(ln.max()), int(lt.max())
    A = _padded([a for a, _, _ in pairs], lm, M + 1, 255, np.uint8)
    B = _padded([b for _, b, _ in pairs], ln, N + 1, 254, np.uint8)
    mv = _padded([x for _, _, x in pairs], lt, T, -1, np.int8)
    m, n = torch.from_numpy(lm).to(device), torch.from_numpy(ln).to(device)
    A, B = torch.from_numpy(A).to(device), torch.from_numpy(B).to(device)
    mv = torch.from_numpy(mv).to(device).long()
    idx = torch.arange(M + 1, device=device)
    # the forbidden left step: row i < m whose next character A[i] is a gap
    next_gap = (A == GAP_CODE) & (idx[None, :] < m[:, None]) & (idx[None, :] >= 1)
    # tables by anti-diagonal: cell (i, j) at [i + j, i], so a diagonal
    # is a slice and its predecessors are slices of the two before it
    D = M + N + 1
    dd = torch.arange(D, device=device)[:, None]
    ii = idx[None, :]
    jj = dd - ii
    inside = (ii >= 1) & (jj >= 1) & (jj <= N)
    ai = (ii - 1).clamp(0, M - 1).expand(D, M + 1)
    bj = (jj - 1).clamp(0, N - 1)
    a_at = A[:, :M].long().gather(1, ai.reshape(1, -1).expand(P, -1)).view(P, D, M + 1)
    b_at = B[:, :N].long().gather(1, bj.reshape(1, -1).expand(P, -1)).view(P, D, M + 1)
    sub = torch.where(a_at == b_at, MATCH, torch.where(a_at == GAP_CODE, GAP, MISMATCH))
    sub = sub.to(torch.int32)
    del a_at, b_at
    score = torch.zeros((P, D, M + 1), dtype=torch.int32, device=device)
    up_f = torch.zeros((P, D, M + 1), dtype=torch.bool, device=device)
    diag_f = torch.zeros_like(up_f)
    left_f = torch.zeros_like(up_f)
    edge_i = torch.arange(1, M + 1, device=device)
    score[:, edge_i, edge_i] = (GAP * edge_i).to(torch.int32)  # (i, 0)
    up_f[:, edge_i, edge_i] = True
    edge_j = torch.arange(1, N + 1, device=device)
    score[:, edge_j, 0] = (GAP * edge_j).to(torch.int32)  # (0, j)
    left_f[:, edge_j, 0] = True
    low = torch.iinfo(torch.int32).min // 2
    for d in range(2, D):
        live = inside[d, 1:]
        up = score[:, d - 1, :M] + GAP + up_f[:, d - 1, :M]
        dg = score[:, d - 2, :M] + sub[:, d, 1:] + diag_f[:, d - 2, :M]
        lf = score[:, d - 1, 1:] + GAP + left_f[:, d - 1, 1:]
        best = torch.maximum(torch.maximum(up, dg), lf)
        forbid = (best == lf) & next_gap[:, 1:]
        lf = torch.where(forbid, low, lf)
        best = torch.where(forbid, torch.maximum(up, dg), best)
        score[:, d, 1:] = torch.where(live, best, score[:, d, 1:])
        up_f[:, d, 1:] = torch.where(live, up == best, up_f[:, d, 1:])
        diag_f[:, d, 1:] = torch.where(live, dg == best, diag_f[:, d, 1:])
        left_f[:, d, 1:] = torch.where(live, lf == best, left_f[:, d, 1:])
    rows = torch.arange(P, device=device)
    optimum = score[rows, m + n, m]
    # the path: cell after each move, the cell before it
    valid = mv >= 0
    di = (valid & (mv != LEFT)).long()
    dj = (valid & (mv != UP)).long()
    ci, cj = di.cumsum(1), dj.cumsum(1)
    pi, pj = ci - di, cj - dj
    r = rows[:, None].expand_as(ci)
    inner = valid & (ci >= 1) & (cj >= 1)
    ci = ci.clamp(max=M)
    pd = (pi + pj).clamp(max=D - 1)
    w = torch.where(mv == UP, GAP + up_f[r, pd, pi].long(),
                    torch.where(mv == DIAG, sub[r, (ci + cj).clamp(max=D - 1), ci].long()
                                + diag_f[r, pd, pi].long(),
                                GAP + left_f[r, pd, pi].long()))
    forbidden = inner & (mv == LEFT) & next_gap[r, ci]
    total = (w * inner).sum(1)
    # where the path leaves the first row or column: gap * its index
    first = torch.where(inner.any(1), inner.long().argmax(1), torch.full_like(m, T - 1))
    edge = GAP * (pi[rows, first] + pj[rows, first])
    path = torch.where(inner.any(1), edge + total, GAP * (m + n))
    path = torch.where(forbidden.any(1), torch.full_like(path, low), path)
    # a path that does not end in the last cell reaches nothing
    ends = (ci[:, -1] == m) & (cj[:, -1] == n)
    path = torch.where(ends, path, torch.full_like(path, low))
    return path.cpu().numpy(), optimum.long().cpu().numpy()


def _flags(a: str, b: str) -> list[np.ndarray]:
    """[up, diag, left] direction flags [m + 1, n + 1] of the upstream's
    table of `a` against `b` (needlemanWunch), an anti-diagonal a step."""
    m, n = len(a), len(b)
    A = np.frombuffer(a.encode(), dtype=np.uint8).astype(np.int64)
    B = np.frombuffer(b.encode(), dtype=np.uint8).astype(np.int64)
    score = np.zeros((m + 1, n + 1), dtype=np.int64)
    up, dg, lf = (np.zeros((m + 1, n + 1), dtype=bool) for _ in range(3))
    score[:, 0] = GAP * np.arange(m + 1)
    score[0, :] = GAP * np.arange(n + 1)
    up[1:, 0] = True
    lf[0, 1:] = True
    next_gap = np.zeros(m + 1, dtype=bool)
    next_gap[1:m] = A[1:] == GAP_CODE
    for d in range(2, m + n + 1):
        i = np.arange(max(1, d - n), min(m, d - 1) + 1)
        if not len(i):
            continue
        j = d - i
        s = np.where(A[i - 1] == B[j - 1], MATCH,
                     np.where((A[i - 1] == GAP_CODE) | (B[j - 1] == GAP_CODE), GAP, MISMATCH))
        u = score[i - 1, j] + GAP + up[i - 1, j]
        g = score[i - 1, j - 1] + s + dg[i - 1, j - 1]
        left = score[i, j - 1] + GAP + lf[i, j - 1]
        best = np.maximum(np.maximum(u, g), left)
        forbid = (best == left) & next_gap[i]
        left = np.where(forbid, np.iinfo(np.int64).min, left)
        best = np.where(forbid, np.maximum(u, g), best)
        score[i, j] = best
        up[i, j], dg[i, j], lf[i, j] = u == best, g == best, left == best
    return [up, dg, lf]


def _analyze(x: str, y: str) -> tuple[int, int, int]:
    """(score, sites, indels) of two aligned rows, as the upstream's
    variantAnalyze counts them (src/SeqAlign.cpp:237-305): a site is a
    mismatch, or the first column of a run of gaps on one side."""
    score = sites = indels = 0
    flag = 0
    for p, q in zip(x, y):
        score += GAP if "-" in (p, q) else MATCH if p == q else MISMATCH
        if p == q:
            flag = 0
        elif p == "-" or q == "-":
            side = 1 if p == "-" else 2
            if flag != side:
                flag = side
                sites += 1
                indels += 1
        else:
            sites += 1
            flag = 0
    return score, sites, indels


def _worse(x: tuple[int, int, int], y: tuple[int, int, int]) -> int:
    """AlignUnit's order (src/SeqAlign.hpp:43-67): > 0 where y is better
    than x (a higher score, then fewer sites, then fewer indels), 0 on a
    tie."""
    if x[0] != y[0]:
        return 1 if y[0] > x[0] else -1
    if x[1] != y[1]:
        return x[1] - y[1]
    return x[2] - y[2]


def traceback(a: str, b: str) -> list[tuple[str, str, list[int]]]:
    """(row a, row b, the positions in `a` of the gaps opened in it) of
    each alignment the upstream's traceback keeps (src/SeqAlign.cpp:
    306-478): a depth-first walk from the last cell over the recorded
    directions, left before up before diagonal, that counts runs of gaps
    in each row against a cap of five and, once an alignment is kept,
    against that alignment's counts; a step the cap refuses is struck from
    the table for the rest of the walk. The counts are kept as the
    upstream keeps them, the second row's quirk included (its count rises
    where a gap continues a run). Empty where the caps leave no path."""
    m, n = len(a), len(b)
    keep = _flags(a, b)  # struck steps are cleared here for good
    todo = [f.copy() for f in keep]  # the steps a cell has left on this path
    up, dg, lf = todo
    stack = [(m, n)]
    ra: list[str] = []  # row a right to left ('+' a gap); ra[-1] the head
    rb: list[str] = []
    opened: list[int] = []
    runs = [0, 0]
    cap = [5, 5]
    kept: list[tuple[str, str, list[int]]] = []
    best = None
    while stack:
        i, j = stack[-1]
        if i == 0 and j == 0 and runs[0] <= cap[0] and runs[1] <= cap[1]:
            x, y = "".join(reversed(ra)).replace("+", "-"), "".join(reversed(rb))
            v = _analyze(x, y)
            order = 1 if best is None else _worse(best, v)
            if order >= 0:
                if order > 0:
                    kept.clear()
                kept.append((x, y, list(opened)))
                best = v
                cap = list(runs)
        if lf[i, j]:
            head = ra[-1] if ra else None
            if runs[0] < cap[0] or (runs[0] == cap[0] and head == "+"):
                if runs[0] < cap[0] and head != "+":
                    runs[0] += 1
                stack.append((i, j - 1))
                ra.append("+")
                opened.append(i)
                rb.append(b[j - 1])
                lf[i, j] = False
            else:
                keep[2][i, j] = lf[i, j] = False
        elif up[i, j]:
            head = rb[-1] if rb else None
            if runs[1] < cap[1] or (runs[1] == cap[1] and head == "-"):
                if runs[1] < cap[1] and (head is None or head == "-"):
                    runs[1] += 1
                stack.append((i - 1, j))
                ra.append(a[i - 1])
                rb.append("-")
                up[i, j] = False
            else:
                keep[0][i, j] = up[i, j] = False
        elif dg[i, j]:
            stack.append((i - 1, j - 1))
            ra.append(a[i - 1])
            rb.append(b[j - 1])
            dg[i, j] = False
        else:
            if not ra:
                break
            stack.pop()
            for t, f in zip(todo, keep):
                t[i, j] = f[i, j]
            if ra[-1] == "+" and (len(ra) < 2 or ra[-2] != "+"):
                runs[0] -= 1
            if rb[-1] == "-" and (len(rb) < 2 or rb[-2] != "-"):
                runs[1] -= 1
            if ra[-1] == "+":
                opened.pop()
            ra.pop()
            rb.pop()
    return kept


def _spliced(row: str, opened: list[int]) -> str:
    """The row with a gap put in before each of `opened`'s positions."""
    parts, pre = [], 0
    for p in reversed(opened):
        parts += [row[pre:p], "-"]
        pre = p
    return "".join(parts) + row[pre:]


def upstream_alignments(strs: list[str]) -> list[list[str]]:
    """The alignments of the strings, a row a string, that the upstream's
    progressive alignment (SeqAlign::SequenceAlignment, src/SeqAlign.cpp:
    550-640) keeps for compareStrPair to choose from; a bubble with none
    writes no block. Row 0 of each
    alignment kept so far is aligned to the next string; of the
    alignments of one such step, those whose spliced rows score best
    against the new row, row by row, carry on; the steps whose summed
    best scores are highest are kept."""
    cands = [[x, y] for x, y, _ in traceback(strs[0], strs[1])]
    for s in strs[2:]:
        nxt, top = [], None
        for cand in cands:
            steps_ = traceback(cand[0], s)
            rows = [[x] for x, _, _ in steps_]
            live = list(range(len(steps_)))
            total = 0
            for j in range(1, len(cand)):
                best, keep = None, []
                for c in live:
                    row = _spliced(cand[j], steps_[c][2])
                    v = _analyze(row, steps_[c][1])
                    order = 1 if best is None else _worse(best, v)
                    if order > 0:
                        best, keep = v, [c]
                        rows[c].append(row)
                    elif order == 0:
                        keep.append(c)
                        rows[c].append(row)
                live = keep
                total += best[0] if best is not None else np.iinfo(np.int32).min
            if top is None or total > top:
                top, nxt = total, []
            if total == top:
                nxt += [rows[c] + [steps_[c][1]] for c in live]
        cands = nxt
    return cands


def optimal(pairs: list[tuple[np.ndarray, np.ndarray, np.ndarray]], device) -> np.ndarray:
    """Whether each (first string, second string, moves) reaches the
    optimum of its table."""
    ok = np.zeros(len(pairs), dtype=bool)
    if not pairs:
        return ok
    side = np.array([max(len(a), len(b)) + 1 for a, b, _ in pairs])
    order = np.argsort(side, kind="stable")
    lo = 0
    while lo < len(order):
        hi = lo + 1
        while hi < len(order) and (hi - lo + 1) * side[order[hi]] ** 2 <= CELLS:
            hi += 1
        idx = order[lo:hi]
        path, best = _group([pairs[i] for i in idx], device)
        ok[idx] = path == best
        lo = hi
    return ok

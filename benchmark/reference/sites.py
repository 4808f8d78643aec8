"""Reference check of the site tables: every block of `<out>_alignseq.txt`
and every row of the two- to five-allele tables (`<out>_{bi,tri,tetra,
penta}{cov,fre}.txt`, and `<out>_allele_frequency.txt`).

A block is one bubble the sites pass emitted: its VarId, isSimple, the
entrance and exit ids, and the bubble's branches aligned, a row each.
The reference holds each block to its own graph (the program's unitigs,
held to the reference's first) and its own superbubble search
(reference/bubbles.py), as the upstream's ploidyEstimation (PloidyFrost
src/CDBG.cpp:1101-1705; colored src/CCDBG.cpp:2759-3531) reads them:

* the blocks are the bubbles the upstream's walk reaches (`walk`: its
  order, its entrance sides, its exits), each admitted one once, in that
  order, and isSimple is the search's strict flag; VarIds run 1, 2, ...;
* a strict bubble's rows, gaps removed, are its branch unitigs as they
  leave the entrance, each admitted (one sample: its least k-mer count
  strictly inside the cutoffs; several: every color carried on all its
  k-mers or on none, each carried color inside that sample's cutoffs,
  and some color carried by two branches), in the upstream's order
  (sortSeq_simple: mean count, then the stored sequence, from the
  largest; several samples: the number of colors, the length, the
  sequence); a bubble that is not admitted writes no block;
* a non-strict bubble's rows, gaps removed, are all the paths of the
  graph from the entrance to the exit (the entrance's last k bases to
  the exit's first k), longest first, then the greatest string;
* the rows are of one length and each progressive step of the alignment
  reaches the optimum of the upstream's scoring (reference/align.py);
  which of several optimal alignments the upstream keeps is not
  recomputed.

A block that fails any of these counts in `align_off`. From the rows of
each block that holds, the reference derives the sites as the upstream's
compareStrPair does (src/SeqAlign.cpp:8-236): a column where the rows
differ and no row has a gap is a SNP site; a column with a gap starts an
indel site where the rows' gap pattern changes from the column before,
and the run of columns of one pattern is its VarType; a later column of
that run with more than two symbols is a site of its own, with VarType 0.
A site's alleles are its symbols in the order the rows first show them.
For each site it computes the row of each table the upstream writes:

* strict: each allele's coverage is the sum of its branches' mean k-mer
  counts in the reference table (several samples: of each color that
  branch carries and is inside for, 0 otherwise); one sample writes one
  row, in the table of the number of alleles; several write a row for
  each color with two alleles or more of coverage above 0, of those
  alleles;
* non-strict: each row's k-window around the site (the upstream's
  gap-skipping rebuild, src/CDBG.cpp:1471-1596), the distinct windows
  of each allele, and the allele's coverage the sum of their mean
  counts (readCov(s, lower, upper)); a window with a count outside the
  cutoffs drops the site. Several samples: a window belongs to the
  colors of its first k-mer, every color has to be met, and each color's
  coverage is summed from its own table;
* VarNum, VarDis (the distance to the next site, the entrance's or the
  exit's length at the ends), and each frequency, coverage over the
  row's sum; numbers as C++ prints a double (six significant digits).
  Cramer's V (several samples) is not recomputed.

Rows are compared VarId by VarId and table by table, in order, and
`<out>_allele_frequency.txt` against the frequencies of every row in
the order they were emitted (the single-thread path, which writes the
frequencies of every table there). A row that differs, is missing or is
extra counts in `strict_rows_off` (strict bubbles of two branches),
`multi_rows_off` (strict bubbles of three to five) or
`branching_rows_off` (non-strict bubbles); so do the rows of a block
that fails, and each bubble the walk reaches, admitted, that has no
block. The upstream writes no block where its progressive alignment
keeps nothing: each traceback's walk counts the runs of gaps in each
row against a cap of five and strikes what the cap refuses, so a
bubble whose branches need many gaps can lose every path (two bubbles
of the indel_dense golden set). For each bubble without a block the
reference runs the upstream's traceback and progressive steps again
(reference/align.py, `upstream_alignments`, at most RECOMPUTE bubbles a
run); one where they keep nothing is not due (`_no_alignment`).

A frequency is compared as the upstream prints it, over the row's sum
taken left to right. One printed over the sum Python's compensated
`sum()` gives (the port's, where a row sums three values or more:
PERF.md section 7, C6) is counted in `rows_compensated`, which has a
limit of its own; a left-to-right sum in the port takes it to 0.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from . import align
from .bubbles import COMPLEX, MINUS_SET, PLUS_SET, STRICT
from .graph import lookup, sequence_keys

COMP = str.maketrans("ACGT", "TGCA")
TABLES = {2: "bi", 3: "tri", 4: "tetra", 5: "penta"}
GAP = ord("-")
MAX_WALK = 100_000  # DFS steps of one path enumeration before it gives up
RECOMPUTE = 64  # bubbles without a block whose alignment is run again; the rest are due
KINDS = ("strict_rows_off", "multi_rows_off", "branching_rows_off")
NUMBERS = ("align_off",) + KINDS + ("rows_compensated",)  # the compared numbers
NOTES = 12  # disagreements kept for the run's log


def _rc(s: str) -> str:
    return s.translate(COMP)[::-1]


def _oriented(seqs: list[str], node: int) -> str:
    s = seqs[node >> 1]
    return s if node & 1 else _rc(s)


def _same(text: str, value: float) -> bool:
    try:
        return float(text) == float(f"{value:.6g}")
    except ValueError:
        return False


def _lines(path: str) -> list[str]:
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [line.rstrip("\n") for line in f if line.strip()]


class Block:
    __slots__ = ("var_id", "simple", "ent", "ext", "rows")

    def __init__(self, var_id, simple, ent, ext):
        self.var_id, self.simple, self.ent, self.ext = var_id, simple, ent, ext
        self.rows: list[str] = []


def read_blocks(path: str) -> tuple[list[Block], int]:
    """The blocks of `_alignseq.txt` in file order, and malformed lines."""
    blocks: list[Block] = []
    bad = 0
    for line in _lines(path):
        r = line.split("\t")
        try:
            key = (int(r[0]), r[1] == "1", int(r[2]), int(r[3]))
        except (ValueError, IndexError):
            bad += 1
            continue
        if not blocks or (blocks[-1].var_id, blocks[-1].simple, blocks[-1].ent, blocks[-1].ext) != key:
            blocks.append(Block(*key))
        blocks[-1].rows.append(r[4] if len(r) > 4 else "")
    return blocks, bad


class Row:
    """One row of a cov table with its frequency lines."""

    __slots__ = ("n", "covs", "color", "simple", "vt", "var_id", "var_num", "var_dis", "fre")

    def same(self, e: tuple) -> int:
        """0: the row differs from the expected one; 1: it is the same;
        2: the same but for frequencies over the compensated sum."""
        n, covs, fres, alt, color, simple, vt, var_id, var_num, var_dis = e
        if not (self.n == n and self.color == color and self.simple == simple
                and (self.vt, self.var_id, self.var_num, self.var_dis) == (vt, var_id, var_num, var_dis)
                and all(_same(t, v) for t, v in zip(self.covs, covs))):
            return 0
        if all(_same(t, v) for t, v in zip(self.fre, fres)):
            return 1
        return 2 if all(_same(t, v) for t, v in zip(self.fre, alt)) else 0


def read_rows(pre: str, colored: bool) -> tuple[dict[int, list[Row]], int, list[tuple[str, int]]]:
    """({VarId: its rows, in table order then file order}, rows in all,
    [(unreadable row's isSimple or '', its table)])."""
    by_var: dict[int, list[Row]] = {}
    total = 0
    bad: list[tuple[str, int]] = []
    tail = 7 if colored else 5
    for n, name in TABLES.items():
        cov = _lines(f"{pre}_{name}cov.txt")
        fre = _lines(f"{pre}_{name}fre.txt")
        total += len(cov)
        whole = len(fre) == n * len(cov)
        for i, line in enumerate(cov):
            r = line.split("\t")
            if r and r[-1] == "":
                r = r[:-1]
            try:
                if not whole or len(r) != n + tail:
                    raise ValueError
                row = Row()
                row.n, row.covs, row.fre = n, r[:n], fre[n * i:n * i + n]
                rest = r[n:]
                row.color = int(rest.pop(0)) if colored else 0
                row.simple = rest[0] == "1"
                row.vt, row.var_id, row.var_num = int(rest[1]), int(rest[2]), int(rest[3])
                row.var_dis = int(rest[-1])
            except (ValueError, IndexError):
                bad.append((r[n + (1 if colored else 0)] if len(r) > n + 1 else "", n))
                continue
            by_var.setdefault(row.var_id, []).append(row)
    return by_var, total, bad


def _alleles(cols: np.ndarray) -> np.ndarray:
    """[rows, sites] allele numbers, 1 up, in the order the rows first show
    each symbol of a column."""
    n, s = cols.shape
    out = np.ones((n, s), dtype=np.int64)
    count = np.ones(s, dtype=np.int64)
    for r in range(1, n):
        eq = cols[:r] == cols[r]
        seen = eq.any(0)
        first = eq.argmax(0)
        count += ~seen
        out[r] = np.where(seen, out[first, np.arange(s)], count)
    return out


def sites_of(R: np.ndarray) -> list[tuple[int, list[int], int | None, bool]]:
    """(column, alleles, VarType, is an indel site) of each site of a
    block's rows ([rows, columns] uint8), by compareStrPair's rules;
    VarType None where a run never closes."""
    if len(R) == 2 and GAP not in R:
        return [(c, [1, 2], 0, False) for c in np.flatnonzero(R[0] != R[1]).tolist()]
    differ = (R != R[0]).any(0)
    gap = R == GAP
    if not gap.any():
        cols = np.flatnonzero(differ)
        part = _alleles(R[:, cols])
        return [(int(c), part[:, i].tolist(), 0, False) for i, c in enumerate(cols)]
    out = []
    runs: list[list] = []  # [start, length or None] of each indel site
    in_run = False
    for j in range(R.shape[1]):
        if not differ[j]:
            if in_run:
                runs[-1][1] = j - runs[-1][0]
                in_run = False
            continue
        if not gap[:, j].any():
            if in_run:
                runs[-1][1] = j - runs[-1][0]
                in_run = False
            out.append([j, None, False])
            continue
        same = in_run and j > 0 and bool((gap[:, j] == gap[:, j - 1]).all())
        if in_run and not same:
            runs[-1][1] = j - runs[-1][0]
        if not same:
            runs.append([j, None])
            in_run = True
            out.append([j, len(runs) - 1, True])
        elif len(set(R[:, j].tolist())) > 2:
            out.append([j, None, False])
    if not out:
        return []
    cols = np.array([o[0] for o in out])
    part = _alleles(R[:, cols])
    return [(c, part[:, i].tolist(), runs[r][1] if ind else 0, ind)
            for i, (c, r, ind) in enumerate(out)]


def var_distance(i: int, cols: list[int], u_size: int, x_size: int) -> int:
    """var_distance (src/CDBG.cpp:1279-1298)."""
    if i == 0:
        return min(cols[1] - cols[0] - 1, u_size) if len(cols) > 1 else min(u_size, x_size)
    if i == len(cols) - 1:
        return min(cols[i] - cols[i - 1] - 1, x_size)
    return min(cols[i] - cols[i - 1] - 1, cols[i + 1] - cols[i] - 1)


def _next_base(row: str, at: int, k_len: str, k: int) -> str:
    while len(k_len) < k:
        c = row[at]
        if c != "-":
            k_len += c
        at += 1
    return k_len


def snp_windows(rows: list[str], site: int, indels_before: int, k: int) -> list[str]:
    """Each row's k-window ending at a SNP site (src/CDBG.cpp:1559-1596)."""
    if indels_before == 0:
        return [r[max(site - k + 1, 0):site + 1] for r in rows]
    out = []
    for r in rows:
        head = r[:site + 1].replace("-", "")
        out.append(_next_base(r, site + 1, head, k) if len(head) < k else head[-k:])
    return out


def indel_windows(rows: list[str], site: int, indels_before: int, k: int) -> list[str]:
    """Each row's k-window around an indel site (src/CDBG.cpp:1471-1525):
    the rows' bases from the site on, gaps skipped, read in step until
    they differ, behind as much as the window holds before the site."""
    at = [site] * len(rows)
    grown = [""] * len(rows)
    while True:
        seen = set()
        for s, r in enumerate(rows):
            while r[at[s]] == "-":
                at[s] += 1
            grown[s] += r[at[s]]
            seen.add(r[at[s]])
            at[s] += 1
        if len(seen) > 1:
            break
    step = len(grown[0])
    if indels_before == 0:
        return [r[max(site - k + step, 0):site] + g for r, g in zip(rows, grown)]
    out = []
    for s, r in enumerate(rows):
        head = r[:site].replace("-", "")
        if len(head) < k - step:
            out.append(_next_base(r, at[s], head + grown[s], k))
        else:
            out.append(head[len(head) - (k - step):] + grown[s])
    return out


def _paths(search, seqs: list[str], node: int, x: int, k: int) -> list[str] | None:
    """Every path string from `node` to unitig x: the entrance's last k
    bases to the exit's first k; None past MAX_WALK steps."""
    out = []
    stack = [(node, _oriented(seqs, node)[-k:])]
    steps = 0
    while stack:
        v, s = stack.pop()
        for w in search.succ[v]:
            steps += 1
            if steps > MAX_WALK:
                return None
            ws = _oriented(seqs, w)
            if w >> 1 == x:
                out.append(s + ws[k - 1])
            else:
                stack.append((w, s + ws[k - 1:]))
    return out


class Facts:
    """Per unitig (the program's numbering), per sample: the mean and the
    least k-mer count in the reference table, whether every k-mer counts
    strictly inside the sample's cutoffs, and (several samples) whether
    the unitig carries the sample's color on all its k-mers."""

    def __init__(self, mean, least, inside, full, uniform, cutoffs):
        self.mean, self.least, self.inside, self.full = mean, least, inside, full
        self.uniform, self.cutoffs = uniform, cutoffs
        self.colored = full is not None
        if self.colored:
            self.n_full = full.sum(1)
            self.admitted = full & inside
        else:
            lo, up = cutoffs[0]
            self.least_in = (least[:, 0] > lo) & (least[:, 0] < up)


def _strict_order(facts: Facts, seqs, branches: list[int]) -> tuple[bool, list[int]]:
    """(admitted, the branches in the upstream's order) of a strict bubble."""
    us = [v >> 1 for v in branches]
    if facts.colored:
        ok = all(facts.uniform[u] for u in us) and bool(
            (facts.admitted[us].sum(0) >= 2).any())
        key = [(int(facts.n_full[u]), len(seqs[u]), seqs[u]) for u in us]
    else:
        ok = all(facts.least_in[u] for u in us)
        key = [(float(facts.mean[u, 0]), seqs[u]) for u in us]
    order = sorted(range(len(us)), key=lambda i: key[i], reverse=True)
    return ok, [branches[i] for i in order]


def walk(search, seqs: list[str], facts: Facts) -> list[tuple[int, int, int, bool, bool]]:
    """The bubbles the upstream's ploidyEstimation walk reaches, in the
    order it emits them (src/CDBG.cpp:1101-1705): (entrance, its side, the
    exit node, strict, admitted). Unitigs in id order that have a side
    with a partner, the plus side first; a complex side is passed over; a
    strict bubble's exit is its first branch's first successor, a
    non-strict one's the end of the chain of first successors that meets
    the partner; a bubble whose entrance sequence is below its exit's is
    left to the exit's side. Every bubble reached marks its entrance side
    and its exit's side visited, so a side taken as an exit is not walked
    from again."""
    unvisited = [f & (PLUS_SET | MINUS_SET) for f in search.flags]
    out = []
    for u in [u for u, f in enumerate(unvisited) if f]:
        while unvisited[u]:
            side = 1 if unvisited[u] & PLUS_SET else 0
            bit = PLUS_SET if side else MINUS_SET
            if search.flags[u] & COMPLEX[side]:
                unvisited[u] &= ~bit
                if side:
                    continue
                break
            node = 2 * u + side
            strict = bool(search.flags[u] & STRICT[side])
            e = None
            if strict:
                branches = search.succ[node]
                if branches and search.succ[branches[0]]:
                    e = search.succ[branches[0]][0]
            elif search.succ[node]:
                e, steps = search.succ[node][0], 0
                while e is not None and e >> 1 != search.ptr[side][u]:
                    steps += 1
                    e = search.succ[e][0] if search.succ[e] and steps <= len(seqs) else None
            if e is None or seqs[u] < seqs[e >> 1]:
                unvisited[u] &= ~bit
                continue
            admitted = _strict_order(facts, seqs, search.succ[node])[0] if strict else True
            out.append((u, side, e, strict, admitted))
            unvisited[u] &= ~bit
            unvisited[e >> 1] &= ~(MINUS_SET if e & 1 else PLUS_SET)
    return out


def _branch_strings(u: int, side: int, e: int, strict: bool, seqs, search, facts: Facts,
                    k: int) -> list[str] | None:
    """The strings the upstream aligns for the walk's bubble: a strict
    bubble's branches in its order, a non-strict one's paths."""
    node = 2 * u + side
    if strict:
        return [_oriented(seqs, v) for v in _strict_order(facts, seqs, search.succ[node])[1]]
    paths = _paths(search, seqs, node, e >> 1, k)
    return None if paths is None else sorted(paths, key=lambda s: (len(s), s), reverse=True)


def _bubble_of(block: Block, job, seqs, search, facts: Facts, k: int):
    """(reference branch nodes, or None for a non-strict bubble) when the
    block's ungapped rows are the branches of the walk's bubble `job`,
    else False."""
    u, side, e, strict, admitted = job
    if strict != block.simple or not admitted:
        return False
    if [r.replace("-", "") for r in block.rows] != _branch_strings(u, side, e, strict, seqs,
                                                                    search, facts, k):
        return False
    return _strict_order(facts, seqs, search.succ[2 * u + side])[1] if strict else None


def _window_table(windows: list[str], k: int, tables, cutoffs, filtered, device) -> dict:
    """{window: (means [C], inside [C], colors [C])}."""
    uniq = sorted(set(windows))
    good = [w for w in uniq if len(w) >= k and not w.strip("ACGT")]
    C = len(tables)
    out = {w: (np.zeros(C), np.zeros(C, dtype=bool), np.zeros(C, dtype=bool))
           for w in uniq}
    if not good:
        return out
    q, owner = sequence_keys(good, k, device)
    nk = np.bincount(owner, minlength=len(good))
    starts = np.concatenate([[0], np.cumsum(nk)[:-1]])
    heads = q[torch.from_numpy(starts.astype(np.int64)).to(q.device)]
    means = np.zeros((len(good), C))
    inside = np.zeros((len(good), C), dtype=bool)
    colors = np.zeros((len(good), C), dtype=bool)
    for c, ((tk, tc), (lo, up)) in enumerate(zip(tables, cutoffs)):
        ti, tf = lookup(tk, q)
        cnt = np.where(tf, tc.cpu().numpy()[ti], 0)
        means[:, c] = np.add.reduceat(cnt, starts) / nk
        inside[:, c] = np.minimum.reduceat((tf & (cnt > lo) & (cnt < up)).astype(np.int8), starts) > 0
        if filtered is not None:
            colors[:, c] = lookup(filtered[c], heads)[1]
    for i, w in enumerate(good):
        out[w] = (means[i], inside[i], colors[i])
    return out


def _frequencies(values: list[float], summed: list[float]) -> tuple[list[float], list[float]]:
    """Each value over the sum of `summed`: the sum taken left to right, as
    the upstream's C++ adds doubles, and the sum Python's built-in sum()
    gives, compensated since Python 3.12, which the port takes where a row
    sums three values or more (PERF.md, section 7)."""
    total = 0.0
    for v in summed:
        total += v
    compensated = sum(summed)
    return [v / total for v in values], [v / compensated for v in values]


def _strict_rows(block: Block, sites, branches, facts: Facts, seqs, C: int) -> list[tuple]:
    us = [v >> 1 for v in branches]
    cols = [s[0] for s in sites]
    u_size, x_size = len(seqs[block.ent - 1]), len(seqs[block.ext - 1])
    rows = []
    for i, (col, part, vt, _) in enumerate(sites):
        vd = var_distance(i, cols, u_size, x_size)
        groups = max(part)
        if not facts.colored:
            covs = [float(facts.mean[u, 0]) for u in us]
            g = [0.0] * groups
            for j, p in enumerate(part):
                g[p - 1] += covs[j]
            rows.append((groups, g, *_frequencies(g, covs), 0, True, vt, block.var_id,
                         len(sites), vd))
            continue
        for c in range(C):
            g = [0.0] * groups
            for j, p in enumerate(part):
                u = us[j]
                g[p - 1] += float(facts.mean[u, c]) if facts.admitted[u, c] else 0.0
            res = [x for x in g if x > 0.0]
            if len(res) < 2:
                continue
            rows.append((len(res), res, *_frequencies(res, res), c, True, vt, block.var_id,
                         len(sites), vd))
    return rows


def _branching_windows(block: Block, sites, k: int) -> list[list[list[str]]] | None:
    """Each site's distinct windows of each allele, sorted; None where a
    window cannot be rebuilt."""
    out = []
    indels = 0
    try:
        for col, part, _, is_indel in sites:
            if is_indel:
                w = indel_windows(block.rows, col, indels, k)
                indels += 1
            else:
                w = snp_windows(block.rows, col, indels, k)
            groups = [set() for _ in range(max(part))]
            for j, p in enumerate(part):
                groups[p - 1].add(w[j])
            out.append([sorted(g) for g in groups])
    except IndexError:
        return None
    return out


def _branching_rows(block: Block, sites, windows, wcov: dict, seqs, C: int,
                    colored: bool) -> list[tuple]:
    cols = [s[0] for s in sites]
    u_size, x_size = len(seqs[block.ent - 1]), len(seqs[block.ext - 1])
    rows = []
    for i, ((col, part, vt, _), groups) in enumerate(zip(sites, windows)):
        vd = var_distance(i, cols, u_size, x_size)
        if not colored:
            covs, ok = [], True
            for grp in groups:
                c = 0.0
                for w in grp:
                    mean, inside, _ = wcov[w]
                    if not inside[0]:
                        ok = False
                        break
                    c += float(mean[0])
                if not ok:
                    break
                covs.append(c)
            if not ok:
                continue
            fres, _ = _frequencies(covs, covs)
            rows.append((len(covs), covs, fres, fres, 0, False, vt, block.var_id, len(sites), vd))
            continue
        cov = np.zeros((C, len(groups)))
        met = np.zeros(C, dtype=bool)
        ok = True
        for gi, grp in enumerate(groups):
            for w in grp:
                mean, inside, colors = wcov[w]
                for c in np.flatnonzero(colors):
                    met[c] = True
                    if not inside[c]:
                        ok = False
                        break
                    cov[c, gi] += mean[c]
                if not ok:
                    break
            if not ok:
                break
        if not ok or not met.all():
            continue
        for c in range(C):
            res = [float(x) for x in cov[c] if x > 0.0]
            if len(res) < 2:
                continue
            rows.append((len(res), res, *_frequencies(res, res), c, False, vt, block.var_id,
                         len(sites), vd))
    return rows


def _note(notes: list[str], text: str) -> None:
    """Keep the first few disagreements, for the run's log."""
    if len(notes) < NOTES:
        notes.append(text[:400])


def _show(r: Row) -> str:
    return " ".join(r.covs + [str(r.color), str(int(r.simple)), str(r.vt), str(r.var_num),
                              str(r.var_dis)] + r.fre)


def _show_expected(e: tuple) -> str:
    n, covs, fres, _, color, simple, vt, _, var_num, var_dis = e
    return " ".join([f"{c:.6g}" for c in covs] + [str(color), str(int(simple)), str(vt),
                                                  str(var_num), str(var_dis)]
                    + [f"{f:.6g}" for f in fres])


def _kind(simple: bool, branches: int) -> str:
    if not simple:
        return "branching_rows_off"
    return "strict_rows_off" if branches <= 2 else "multi_rows_off"


def check(outdir: str, prefix: str, k: int, seqs: list[str], search, facts: Facts,
          tables, filtered, device) -> dict:
    """{each of NUMBERS} and counts beside them (names that start with
    '_')."""
    t0 = time.time()
    pre = os.path.join(outdir, prefix)
    colored = facts.colored
    C = len(tables)
    res = dict.fromkeys(NUMBERS, 0)
    notes: list[str] = []
    blocks, bad_lines = read_blocks(pre + "_alignseq.txt")
    by_var, n_rows, bad_rows = read_rows(pre, colored)
    res["align_off"] += bad_lines
    for simple, n in bad_rows:
        res[_kind(simple == "1", n)] += 1

    # 1. each block against the walk's next bubble, and its alignment
    jobs = [j for j in walk(search, seqs, facts) if j[4]]
    found = []  # (block, branch nodes or None, rows) of blocks whose branches hold
    pairs, owner = [], []
    bad_block = set()
    diag: dict[int, np.ndarray] = {}
    missing = []  # bubbles the walk emits that have no block
    at = 0
    for i, b in enumerate(blocks):
        j = at
        while j < len(jobs) and (jobs[j][0] + 1, (jobs[j][2] >> 1) + 1) != (b.ent, b.ext):
            j += 1
        if j < len(jobs):
            missing += jobs[at:j]
            at = j + 1
        shape_ok = len(b.rows) >= 2 and len({len(r) for r in b.rows}) == 1 and len(b.rows[0]) > 0
        br = (_bubble_of(b, jobs[j], seqs, search, facts, k)
              if shape_ok and j < len(jobs) else False)
        if b.var_id != i + 1 or br is False:
            bad_block.add(i)
            continue
        M = np.frombuffer("".join(b.rows).encode(), dtype=np.uint8).reshape(len(b.rows), -1)
        found.append((i, br, M))
        if len(b.rows) == 2 and "-" not in b.rows[0] and "-" not in b.rows[1]:
            L = M.shape[1]  # the common case: one diagonal path
            if L not in diag:
                diag[L] = np.full(L, align.DIAG, dtype=np.int8)
            pairs.append((M[0], M[1], diag[L]))
            owner.append(i)
            continue
        for p in align.steps(list(M)):
            pairs.append(p)
            owner.append(i)
    optimal = align.optimal(pairs, device)
    for i, ok in zip(owner, optimal):
        if not ok:
            bad_block.add(i)
    res["align_off"] += len(bad_block)

    # 2. the rows due from each block that holds
    expected: dict[int, list[tuple]] = {}
    kind_of: dict[int, str] = {}
    pending = []
    windows: list[str] = []
    for i, br, M in found:
        b = blocks[i]
        kind_of[b.var_id] = _kind(b.simple, len(b.rows))
        if i in bad_block:
            continue
        sites = sites_of(M)
        if any(s[2] is None for s in sites):
            bad_block.add(i)
            res["align_off"] += 1
            continue
        if b.simple:
            expected[b.var_id] = _strict_rows(b, sites, br, facts, seqs, C)
        else:
            w = _branching_windows(b, sites, k)
            if w is None:
                bad_block.add(i)
                res["align_off"] += 1
                continue
            pending.append((b, sites, w))
            windows.extend(s for site in w for grp in site for s in grp)
    for i in bad_block:
        kind_of[blocks[i].var_id] = _kind(blocks[i].simple, len(blocks[i].rows))
    if pending:
        wcov = _window_table(windows, k, tables, facts.cutoffs, filtered if colored else None,
                             device)
        for b, sites, w in pending:
            expected[b.var_id] = _branching_rows(b, sites, w, wcov, seqs, C, colored)

    # 3. the program's rows against them, VarId by VarId, table by table
    checked = 0
    for var_id, rows in by_var.items():
        kind = kind_of.get(var_id, _kind(rows[0].simple, rows[0].n))
        if var_id not in expected:
            res[kind] += len(rows)
            continue
        checked += len(rows)
        exp = expected[var_id]
        for n in TABLES:
            got = [r for r in rows if r.n == n]
            due = [e for e in exp if e[0] == n]
            same = [g.same(e) for g, e in zip(got, due)]
            res["rows_compensated"] += same.count(2)
            wrong = same.count(0) + abs(len(got) - len(due))
            if wrong:
                res[kind] += wrong
                _note(notes, f"{kind} VarId {var_id} table {n}: program "
                      + "; ".join(_show(g) for g in got) + " | reference "
                      + "; ".join(_show_expected(e) for e in due))
    for var_id, exp in expected.items():
        if exp and var_id not in by_var:
            res[kind_of[var_id]] += len(exp)
    for i in bad_block:
        if blocks[i].var_id not in by_var:
            res[kind_of[blocks[i].var_id]] += 1

    # 4. the bubbles the walk emits that have no block: due, unless the
    # upstream's alignment of their branches keeps nothing
    missing += jobs[at:]
    due = {name: 0 for name in KINDS}
    for u, side, e, strict, _ in jobs:
        due[_kind(strict, len(search.succ[2 * u + side]))] += 1
    no_alignment = 0
    for n_run, (u, side, e, strict, _) in enumerate(missing):
        strs = _branch_strings(u, side, e, strict, seqs, search, facts, k)
        where = f"bubble {u + 1} {(e >> 1) + 1} has no block"
        if (n_run < RECOMPUTE and strs is not None and len(strs) >= 2
                and not align.upstream_alignments(strs)):
            no_alignment += 1
            _note(notes, f"{where}: the upstream keeps no alignment of its {len(strs)} "
                  f"branches of {min(map(len, strs))}-{max(map(len, strs))} bases, not due")
            continue
        kind = _kind(strict, len(search.succ[2 * u + side]))
        res[kind] += 1
        _note(notes, f"{kind} {where}, due")

    # 5. the allele frequency file against every row, in emission order
    if not bad_block:
        lines = _lines(pre + "_allele_frequency.txt")
        at = 0
        for b in blocks:
            for e in expected.get(b.var_id, []):
                for v, alt in zip(e[2], e[3]):
                    if at >= len(lines) or not (_same(lines[at], v) or _same(lines[at], alt)):
                        res[kind_of[b.var_id]] += 1
                        _note(notes, f"{kind_of[b.var_id]} allele frequency line {at + 1} "
                              f"(VarId {b.var_id}): reference {v:.6g}")
                    at += 1
        res["strict_rows_off"] += max(len(lines) - at, 0)

    res.update(_blocks=len(blocks), _blocks_bad=len(bad_block), _nw_pairs=len(pairs),
               _rows=n_rows, _rows_checked=checked,
               _table_rows={TABLES[n]: sum(r.n == n for rows in by_var.values() for r in rows)
                            for n in TABLES},
               _strict_rows=sum(len(v) for k_, v in by_var.items()
                                if kind_of.get(k_) == "strict_rows_off"),
               _multi_rows=sum(len(v) for k_, v in by_var.items()
                               if kind_of.get(k_) == "multi_rows_off"),
               _branching_rows=sum(len(v) for k_, v in by_var.items()
                                   if kind_of.get(k_) == "branching_rows_off"),
               _strict_due=due["strict_rows_off"], _multi_due=due["multi_rows_off"],
               _branching_due=due["branching_rows_off"], _no_alignment=no_alignment,
               _sites_s=round(time.time() - t0, 3))
    if notes:
        res["_disagreements"] = notes
    return res

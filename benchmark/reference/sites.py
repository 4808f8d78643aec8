"""Reference check of the site tables' strict two-branch bubbles.

A strict (simple) bubble is an entrance unitig, branch unitigs that each
have the entrance as their one predecessor and the exit as their one
successor, and the exit. For every row of `<out>_bicov.txt` that a
strict bubble wrote (isSimple 1), the reference takes the bubble's two
branch sequences from `<out>_alignseq.txt` (gaps removed) and the
entrance and exit from `<out>_Unitig_Id.txt`, and holds the row to its
own graph and count tables:

* each branch is exactly one unitig of the reference graph, and (one
  sample) its least k-mer count lies strictly between the cutoffs;
* the entrance ends with each branch's first k - 1 bases, and the exit
  starts with each branch's last k - 1 bases (in some orientation);
* the row's two coverages are the branches' mean k-mer counts in the
  reference table (of the row's color, on several samples), and the two
  frequencies that the row wrote to `<out>_bifre.txt` are each
  coverage over their sum, all as C++ prints a double.

Rows of bubbles that are not strict (branches assembled from k-windows
of enumerated paths) are counted but not recomputed, and so are the rows
that a strict bubble of three or more branches writes to the two-allele
table (a site whose bases split its branches in two groups, or on
several samples a color that lacks all but two of them).

The other way round, `missing_strict` lists the rows each strict
two-branch bubble of the reference's own search (reference/bubbles.py)
is due to write, and counts those the table lacks or has beyond. One
sample: a bubble is due when each branch's least k-mer count lies
strictly between the cutoffs. Several: when each branch carries every
color on all its k-mers or on none, and counts strictly between that
sample's cutoffs on all its k-mers for each color it carries; each color
both branches carry gets rows. The branches have one length (the recipe
has no indels); two that differ in d <= 2 bases write d rows a color
(the aligner's gapless case), two that differ in more at least one.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .bubbles import NULL, STRICT as STRICT_BIT
from .graph import lookup, sequence_keys

COMP = str.maketrans("ACGT", "TGCA")


def _rc(s: str) -> str:
    return s.translate(COMP)[::-1]


def _same(text: str, value: float) -> bool:
    return float(text) == float(f"{value:.6g}")


def _read_rows(path: str) -> list[list[str]]:
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [line.rstrip("\n").split("\t") for line in f if line.strip()]


def check_strict(outdir: str, prefix: str, k: int, keys: torch.Tensor, labels: np.ndarray,
                 tables: list[tuple[torch.Tensor, torch.Tensor]], cutoffs: list[tuple[int, int]]) -> dict:
    """{rows, checked, off, other}: bicov rows, strict rows recomputed,
    strict rows that disagree, rows not recomputed."""
    pre = os.path.join(outdir, prefix)
    colored = len(tables) > 1
    unitig = {int(r[0]): r[1] for r in _read_rows(pre + "_Unitig_Id.txt")}
    bubbles: dict[int, list[tuple[int, int, str]]] = {}
    for r in _read_rows(pre + "_alignseq.txt"):
        bubbles.setdefault(int(r[0]), []).append((int(r[2]), int(r[3]), r[4]))
    cov_rows = _read_rows(pre + "_bicov.txt")
    fre = [line.strip() for line in open(pre + "_bifre.txt") if line.strip()]
    if len(fre) != 2 * len(cov_rows):
        return {"rows": len(cov_rows), "checked": 0, "off": len(cov_rows) + 1, "other": 0}
    # the branches of every strict bubble that has rows, resolved at once
    strict_ids = sorted({int(r[5 if colored else 4]) for r in cov_rows
                         if r[3 if colored else 2] == "1"})
    branch_seqs, owners = [], []
    for vid in strict_ids:
        for b, (_, _, row) in enumerate(bubbles.get(vid, [])[:2]):
            if len(row.replace("-", "")) >= k:
                branch_seqs.append(row.replace("-", ""))
                owners.append((vid, b))
    q, seq_of = sequence_keys(branch_seqs, k, keys.device)
    idx, found = lookup(keys, q)
    lab = np.where(found, labels[idx] if len(labels) else -1, -1)
    size_ref = np.bincount(labels) if len(labels) else np.zeros(1, dtype=np.int64)
    branch = {}
    if owners:
        cnt = np.bincount(seq_of, minlength=len(owners))
        offs = np.concatenate([[0], np.cumsum(cnt)[:-1]])
        lo = np.minimum.reduceat(lab, offs)
        hi = np.maximum.reduceat(lab, offs)
        whole = (lo >= 0) & (lo == hi) & (size_ref[np.maximum(lo, 0)] == cnt)
        means, inside = [], np.ones(len(owners), dtype=bool)
        for (tkeys, tcounts), (clo, cup) in zip(tables, cutoffs):
            ti, tf = lookup(tkeys, q)
            c = np.where(tf, tcounts.cpu().numpy()[ti], 0)
            means.append(np.add.reduceat(c, offs) / cnt)
            if not colored:  # the upstream's readCov(u): the least count decides
                least = np.minimum.reduceat(c, offs)
                inside &= (least > clo) & (least < cup)
        for s_i, key in enumerate(owners):
            branch[key] = (bool(whole[s_i] and inside[s_i]), [float(m[s_i]) for m in means])
    off = checked = other = 0
    for i, r in enumerate(cov_rows):
        vid = int(r[5 if colored else 4])
        rows = bubbles.get(vid, [])
        if r[3 if colored else 2] != "1" or len(rows) > 2:
            other += 1
            continue
        checked += 1
        ok = len(rows) == 2 and all(branch.get((vid, b), (False,))[0] for b in range(2))
        if ok:
            ent, ext = unitig.get(rows[0][0], ""), unitig.get(rows[0][1], "")
            seqs = [x[2].replace("-", "") for x in rows]
            ok = (any(all(e.endswith(s[:k - 1]) for s in seqs) for e in (ent, _rc(ent)))
                  and any(all(x.startswith(s[-(k - 1):]) for s in seqs) for x in (ext, _rc(ext))))
        if ok:
            color = int(r[2]) if colored else 0
            covs = [branch[(vid, b)][1][color] for b in range(2)]
            ok = _same(r[0], covs[0]) and _same(r[1], covs[1])
            if ok:
                tot = covs[0] + covs[1]
                ok = _same(fre[2 * i], covs[0] / tot) and _same(fre[2 * i + 1], covs[1] / tot)
        off += not ok
    return {"rows": len(cov_rows), "checked": checked, "off": off, "other": other}



def _oriented(seqs: list[str], node: int) -> str:
    s = seqs[node >> 1]
    return s if node & 1 else _rc(s)


def missing_strict(outdir: str, prefix: str, search, seqs: list[str], admitted: list[np.ndarray],
                   uniform: np.ndarray | None) -> dict:
    """{due, missing}: rows the reference's strict two-branch bubbles are
    due to write to the bicov table, and how many it lacks or has beyond.

    admitted[c][u]: unitig u may be a branch of a row of sample c (one
    sample: its least k-mer count lies strictly between the cutoffs;
    several: it carries color c on all its k-mers and they all count
    strictly between c's cutoffs); uniform[u] (several samples): u
    carries each color on all its k-mers or on none, and every color it
    carries counts inside; None on one sample."""
    pre = os.path.join(outdir, prefix)
    colored = uniform is not None
    pair = {int(r[0]): (int(r[2]), int(r[3])) for r in _read_rows(pre + "_alignseq.txt")}
    have: dict[tuple, int] = {}
    for r in _read_rows(pre + "_bicov.txt"):
        if r[3 if colored else 2] != "1":
            continue
        e, x = pair.get(int(r[5 if colored else 4]), (0, 0))
        key = (min(e, x) - 1, max(e, x) - 1, int(r[2]) if colored else 0)
        have[key] = have.get(key, 0) + 1
    due = missing = 0
    done = set()
    for u, f in enumerate(search.flags):
        for side in (1, 0):
            x = search.ptr[side][u]
            b = search.succ[2 * u + side]
            if not f & STRICT_BIT[side] or x in (NULL, u) or len(b) != 2:
                continue
            if (min(u, x), max(u, x)) in done:
                continue
            done.add((min(u, x), max(u, x)))
            if any([w >> 1 for w in search.succ[v]] != [x] for v in b):
                continue
            bu = [v >> 1 for v in b]
            if colored and not all(uniform[v] for v in bu):
                continue
            one, two = _oriented(seqs, b[0]), _oriented(seqs, b[1])
            d = sum(p != q for p, q in zip(one, two)) if len(one) == len(two) else 3
            rows = d if d <= 2 else 1
            for c, adm in enumerate(admitted):
                if not (adm[bu[0]] and adm[bu[1]]):
                    continue
                got = have.get((min(u, x), max(u, x), c), 0)
                due += rows
                missing += abs(got - rows) if d <= 2 else int(got == 0)
    return {"due": due, "missing": missing}

"""The comparison that decides `correct`: what the window's last call
wrote, held to the plain reference (benchmark/reference/).

The reference makes the reads again from the seed and recomputes, on
its own, each sample's count table and histogram, the cutoffs, the
compacted graph (and its colors on several samples), the superbubbles
(the upstream's search, run on its own graph in the program's unitig
numbering), every block and row of the site tables (reference/sites.py),
and the GMM fits. Each compared number is a count of disagreements
(limit 0) except `model_gap`, the largest relative gap between the
model_result numbers of the program and of the reference's float64
fits, and `rows_compensated` (sites.py). The GMM reference reads the
program's allele frequency file: it follows the program from there, and
every line of that file is recomputed apart, with the rows it belongs to.
"""

from __future__ import annotations

import os
import re

import numpy as np
import torch

from .reference import bubbles, gmm, graph, kmers, sites

FAILED = 1e300  # the reading of a number that could not be compared
COMPLEX_SIZE = 8  # the upstream's -z default: a bubble of more unitigs is complex


def _hist_file(path: str, cap: int) -> np.ndarray:
    h = np.zeros(cap + 1, dtype=np.int64)
    with open(path) as f:
        for line in f:
            if line.strip():
                c, n = line.split("\t")[:2]
                if 1 <= int(c) <= cap:
                    h[int(c)] = int(n)
    return h


def _table_off(path: str, keys: torch.Tensor, counts: torch.Tensor, k: int) -> int:
    z = np.load(path)
    if int(z["k"]) != k:
        return max(len(z["kmers"]), keys.numel()) or 1
    pk = torch.from_numpy(np.ascontiguousarray(z["kmers"]).view(np.int64)).to(keys.device)
    pc = torch.from_numpy(np.asarray(z["counts"], dtype=np.int64)).to(keys.device)
    if pk.numel() != keys.numel():
        return abs(pk.numel() - keys.numel())
    return int(((pk != keys) | (pc != counts)).sum())


def program_cutoffs(log: str, workdir: str, out: str, samples: int) -> list[tuple[int, int]]:
    """The cutoffs the call printed (one sample) or wrote (several)."""
    if samples == 1:
        m = re.findall(r"pipeline: cutoffs L=(\d+) U=(\d+)", log)
        return [(int(a), int(b)) for a, b in m[-1:]]
    path = os.path.join(workdir, out + ".coverage_cutoff.txt")
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [tuple(int(x) for x in line.split()) for line in f if line.strip()]


def program_ploidy(log: str) -> int | None:
    m = re.findall(r"estimated ploidy level is : (\d+)", log)
    return int(m[-1]) if m else None


def _gfa_seqs(path: str) -> list[str]:
    seqs = []
    with open(path) as f:
        for line in f:
            if line.startswith("S\t"):
                seqs.append(line.split("\t")[2].upper())
    return seqs


def _colors_off(path: str, seqs: list[str], k: int, filtered: list[torch.Tensor]) -> int:
    z = np.load(path, allow_pickle=False)
    bits = np.unpackbits(z["bits"], axis=0)[: int(z["rows"])].astype(bool)
    q, _ = graph.sequence_keys(seqs, k, filtered[0].device if filtered else "cpu")
    if bits.shape != (q.numel(), len(filtered)):
        return max(bits.size, q.numel() * len(filtered)) or 1
    off = 0
    for c, keys in enumerate(filtered):
        _, found = graph.lookup(keys, q)
        off += int((found != bits[:, c]).sum())
    return off


def _unitig_ids(path: str) -> list[str] | None:
    """The sequences of `_Unitig_Id.txt` in id order, or None unless the
    ids run 1, 2, ... in order."""
    if not os.path.exists(path):
        return None
    seqs = []
    with open(path) as f:
        for i, line in enumerate(f):
            uid, seq = line.rstrip("\n").split("\t")[:2]
            if int(uid) != i + 1:
                return None
            seqs.append(seq.upper())
    return seqs


def _superbubbles(outdir: str, out: str, k: int, useqs: list[str], tables, cutoffs, filtered,
                  device) -> dict:
    """{off, search, facts, listed}: the reference's search over its own
    graph, named as the program names its unitigs, against the program's
    `_super_bubble.txt`, and each unitig's counts (sites.Facts)."""
    n = len(useqs)
    q, owner = graph.sequence_keys(useqs, k, device)
    nkm = np.bincount(owner, minlength=n)
    starts = np.concatenate([[0], np.cumsum(nkm)[:-1]]) if n else np.zeros(0, dtype=np.int64)

    def per_unitig(values: np.ndarray, how) -> np.ndarray:
        return how.reduceat(values, starts) if n else np.zeros(0, dtype=values.dtype)

    colored = len(tables) > 1
    mean, least, inside, carried = [], [], [], []
    for (tk, tc), (lo, up), fk in zip(tables, cutoffs, filtered):
        ti, tf = graph.lookup(tk, q)
        c = np.where(tf, tc.cpu().numpy()[ti], 0)
        mean.append(per_unitig(c, np.add) / np.maximum(nkm, 1))
        least.append(per_unitig(c, np.minimum))
        inside.append(per_unitig((tf & (c > lo) & (c < up)).astype(np.int8), np.minimum) > 0)
        if colored:
            _, inf = graph.lookup(fk, q)
            carried.append(per_unitig(inf.astype(np.int64), np.add))  # k-mers carrying the color
    mean, least, inside = np.stack(mean, 1), np.stack(least, 1), np.stack(inside, 1)
    colors = full = uniform = None
    if colored:
        bits = np.stack(carried, 1)
        full = bits == nkm[:, None]
        size = bits.sum(1)
        uniform = (size == full.sum(1) * nkm) & ~(full & ~inside).any(1)
        colors = (full.tolist(), size.tolist(), nkm.tolist())
    facts = sites.Facts(mean, least, inside, full, uniform, cutoffs)
    search = bubbles.Search(bubbles.adjacency(useqs, k), COMPLEX_SIZE, colors)
    search.run()
    program = bubbles.read_listing(os.path.join(outdir, out + "_super_bubble.txt"))
    return {"off": bubbles.listing_off(program, search.listing()), "search": search,
            "facts": facts, "listed": len(program)}


def compare(cfg: dict, seed: int, workdir: str, out: str, log: str, device) -> dict:
    """{name: value} of every compared number, and a few counts beside
    them under names that start with '_' (not compared)."""
    k, cap = cfg["k"], cfg["counter_max"]
    n = len(cfg["samples"])
    res = {"hist_bins_off": 0, "table_keys_off": 0, "cutoffs_off": 0}
    tables, ref_cut, filtered = [], [], []
    names = [out] if n == 1 else [f"{out}.s{i}" for i in range(n)]
    for s in range(n):
        keys, counts = kmers.count_sample(cfg, seed, s, device)
        hist = kmers.histogram(counts, cap)
        lo, up = kmers.cutoff_lower(hist), kmers.cutoff_upper(hist)
        ref_cut.append((lo, up))
        hpath = os.path.join(workdir, names[s] + ".hist.txt")
        tpath = os.path.join(workdir, names[s] + ".kmers.npz")
        res["hist_bins_off"] += (int((_hist_file(hpath, cap) != hist).sum())
                                 if os.path.exists(hpath) else cap)
        res["table_keys_off"] += (_table_off(tpath, keys, counts, k)
                                  if os.path.exists(tpath) else max(keys.numel(), 1))
        tables.append((keys, counts))
        filtered.append(keys[counts >= lo])
    res["_cutoffs"] = ref_cut
    pcut = program_cutoffs(log, workdir, out, n)
    res["cutoffs_off"] = (sum(abs(a - c) + abs(b - d) for (a, b), (c, d) in zip(pcut, ref_cut))
                          if len(pcut) == n else 2 * n)
    union = torch.unique(torch.cat(filtered)) if n > 1 else filtered[0]
    gkeys, labels = graph.compacted(union, k)
    gfa = os.path.join(workdir, out + ".gfa")
    seqs = _gfa_seqs(gfa) if os.path.exists(gfa) else []
    u = graph.unitigs_off(gkeys, labels, seqs, k)
    res["unitigs_off"] = u["off"]
    res["_unitigs"] = u["ref_unitigs"]
    if n > 1:
        cpath = os.path.join(workdir, out + ".colors.npz")
        res["colors_off"] = _colors_off(cpath, seqs, k, filtered) if os.path.exists(cpath) else 1
    outdir = os.path.join(workdir, "PloidyFrost_output")
    useqs = _unitig_ids(os.path.join(outdir, out + "_Unitig_Id.txt"))
    bub = None
    if (u["off"] == 0 and useqs is not None and sorted(useqs) == sorted(seqs)
            and os.path.exists(os.path.join(outdir, out + "_super_bubble.txt"))):
        bub = _superbubbles(outdir, out, k, useqs, tables, ref_cut, filtered, device)
    res["bubbles_off"] = bub["off"] if bub else 1
    if bub:
        res.update(sites.check(outdir, out, k, useqs, bub["search"], bub["facts"], tables,
                               filtered, device))
    else:  # no graph to read the sites against
        res.update(dict.fromkeys(sites.NUMBERS, 1))
    res["_superbubbles"] = bub["listed"] if bub else 0
    del bub
    del tables, filtered, union, gkeys
    fre = os.path.join(outdir, out + "_allele_frequency.txt")
    mres = os.path.join(workdir, out + "_model_result.txt")
    if os.path.exists(fre) and os.path.exists(mres):
        af = gmm.read_frequencies(fre)
        ref_text, ref_ploidy = gmm.model_result(af[(af >= 0.0) & (af <= 1.0)])
        with open(mres) as f:
            res["model_gap"] = min(gmm.gap(f.read(), ref_text), FAILED)
        res["_frequencies"] = len(af)
    else:
        res["model_gap"], ref_ploidy = FAILED, None
    p = program_ploidy(log)
    res["ploidy_off"] = abs(p - ref_ploidy) if p is not None and ref_ploidy is not None else 1
    res["_ploidy"] = p
    return res


def verdict(res: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {value, limit}}) over the compared numbers."""
    rows = {}
    ok = True
    for name, value in res.items():
        if name.startswith("_"):
            continue
        lim = limits[name]
        rows[name] = {"value": value, "limit": lim}
        ok &= bool(value <= lim)
    return ok, rows

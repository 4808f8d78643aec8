"""Paired-end reads of a configuration, made from the run's seed.

A configuration (benchmark/configs/<name>.json) fixes the genome length,
the ploidy, each sample's monoploid k-mer coverage and heterozygosity,
the read length, the fragment length, the error rate and k. The same
seed gives the same genome, the same haplotypes, the same fragments and
the same errors, so the same bytes.

Recipe (the read sets of chip_smoke.py's make_bench5m_reads and
make_sample_reads, vectorised, made paired and given errors):

* one random genome (uniform ACGT) shared by every sample, in which no
  (k-1)-mer occurs twice or is its own reverse complement, in any
  haplotype of any sample: a base of each such window is changed until
  none is left (a handful of bases in 5 Mbp). A repeat or palindrome
  joins the graph's one chain to itself; the upstream's superbubble
  search, seeded there, then walks on to the genome's end and marks
  every unitig it passed as in no bubble, so that a seed with one made a
  quarter of the bubbles of the others at 5 Mbp;
* each sample: haplotype 0 is the genome, every other haplotype carries
  substitutions at the sample's heterozygosity (a site list of its own);
* optional keys, for a polyploid whose haplotypes share their variants
  (the recipe of the repository's indel_dense golden set); a
  configuration without them draws nothing more and makes the same
  bytes as before they existed:
  - `shared_site_rate`, `shared_site_carry`: one list of sites a
    sample, drawn once over the genome at the rate; each derived
    haplotype carries each site with the carry probability, with an
    alternative base drawn for that haplotype (dosage 1 to ploidy - 1,
    and three or more alleles at some sites). A het SNP at a shared
    site gives way to it;
  - `indel_rate`, `indel_max_len`: scattered indels in each derived
    haplotype at the rate a base, each 1 to `indel_max_len` bases, half
    insertions of random bases and half deletions;
  - `indel_runs_per_mbp`: clustered runs a Mbp in each derived
    haplotype, each 3 to 5 single-base indels within 60 bases.
  Indels lie in genome coordinates, each at least one untouched base
  from the one before (an event that would touch another is dropped),
  and are applied after the substitutions. Haplotypes then differ in
  length. Uniqueness holds in every haplotype: windows of one value
  within k - 1 bases of one genome position, in two haplotypes, are one
  place (an indel in a run of repeated bases moves a window by a few
  bases), and are no repeat;
* each haplotype: `pairs_per_haplotype` fragments, lengths normal
  (mean, sd) clipped to [read_len, 2 * mean], uniform start over the
  haplotype's own length, either
  strand; mate 1 is the fragment's first read_len bases, mate 2 the
  reverse complement of its last read_len bases;
* each mate file: substitutions at `error_rate` a base, drawn apart for
  the two files; quality `I` throughout.

Base depth a haplotype = monoploid k-mer coverage * L / (L - k + 1).
"""

from __future__ import annotations

import gzip
import json
import math
import os

import numpy as np

ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)
CHUNK = 131072  # pairs a block: bounds the host memory of a writer
EDIT_KEYS = ("shared_site_rate", "indel_rate", "indel_runs_per_mbp")
RUN_INDELS = (3, 5)  # single-base indels in a clustered run, fewest and most
RUN_SPAN = 60  # bases a clustered run spreads over


def _rng(seed: int, *path: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([int(seed) & (2**64 - 1), *path]))


def pairs_per_haplotype(cfg: dict, sample: int) -> int:
    L, k = cfg["read_len"], cfg["k"]
    depth = cfg["samples"][sample]["monoploid_coverage"] * L / (L - k + 1)
    return int(round(depth * cfg["genome_bp"] / (2 * L)))


def _variants(cfg: dict, seed: int, sample: int) -> list[tuple[np.ndarray, np.ndarray]]:
    """(positions, base shifts 1..3) of each haplotype after the first."""
    rng = _rng(seed, 1, sample)
    het = cfg["samples"][sample]["het"]
    out = []
    for _ in range(cfg["ploidy"] - 1):
        snp = np.flatnonzero(rng.random(cfg["genome_bp"]) < het)
        out.append((snp, rng.integers(1, 4, len(snp), dtype=np.uint8)))
    return out


def _apply(g: np.ndarray, variant: tuple[np.ndarray, np.ndarray]) -> np.ndarray:
    snp, shift = variant
    h = g.copy()
    h[snp] = (h[snp] + shift) % 4
    return h


def edited(cfg: dict) -> bool:
    """Whether the configuration asks for shared sites or indels."""
    return any(cfg.get(key) for key in EDIT_KEYS)


def _substitutions(cfg: dict, seed: int, sample: int) -> list[tuple[np.ndarray, np.ndarray]]:
    """_variants with the sample's shared sites added (edited configurations)."""
    het = _variants(cfg, seed, sample)
    if not cfg.get("shared_site_rate"):
        return het
    rng = _rng(seed, 4, sample)
    sites = np.flatnonzero(rng.random(cfg["genome_bp"]) < cfg["shared_site_rate"])
    out = []
    for snp, shift in het:
        carry = sites[rng.random(len(sites)) < cfg["shared_site_carry"]]
        alt = rng.integers(1, 4, len(carry), dtype=np.uint8)
        keep = ~np.isin(snp, carry)
        pos = np.concatenate([snp[keep], carry])
        order = np.argsort(pos, kind="stable")
        out.append((pos[order], np.concatenate([shift[keep], alt])[order]))
    return out


def _indels(cfg: dict, seed: int, sample: int, hap: int):
    """(positions, lengths, insertion flags, inserted bases) of one derived
    haplotype, in genome coordinates, sorted, none touching another."""
    rng = _rng(seed, 5, sample, hap)
    G = cfg["genome_bp"]
    pos = np.flatnonzero(rng.random(G) < cfg.get("indel_rate", 0.0))
    length = rng.integers(1, int(cfg.get("indel_max_len", 1)) + 1, len(pos))
    runs = int(round(cfg.get("indel_runs_per_mbp", 0) * G / 1e6))
    start = rng.integers(1, G - RUN_SPAN - int(cfg.get("indel_max_len", 1)), runs)
    per = rng.integers(RUN_INDELS[0], RUN_INDELS[1] + 1, runs)
    in_run = np.repeat(start, per) + rng.integers(0, RUN_SPAN, int(per.sum()))
    pos = np.concatenate([pos, in_run])
    length = np.concatenate([length, np.ones(len(in_run), dtype=length.dtype)])
    insertion = rng.random(len(pos)) < 0.5
    order = np.argsort(pos, kind="stable")
    pos, length, insertion = pos[order], length[order], insertion[order]
    keep = np.zeros(len(pos), dtype=bool)
    free = 1  # the first genome position an event may touch
    for i, (p, n, ins) in enumerate(zip(pos.tolist(), length.tolist(), insertion.tolist())):
        end = p + 1 if ins else p + n  # past the last genome base the event touches
        if p >= free and end < G:
            keep[i] = True
            free = end + 1
    pos, length, insertion = pos[keep], length[keep], insertion[keep]
    bases = rng.integers(0, 4, int(length[insertion].sum()), dtype=np.uint8)
    return pos, length, insertion, bases


def _edit(h: np.ndarray, events) -> tuple[np.ndarray, np.ndarray]:
    """(the haplotype with its indels, the genome position of each base;
    an inserted base takes that of the base it was inserted before)."""
    pos, length, insertion, bases = events
    keep = np.ones(len(h), dtype=bool)
    dl = length[~insertion]
    if len(dl):
        first = np.repeat(pos[~insertion], dl)
        keep[first + np.arange(len(first)) - np.repeat(np.cumsum(dl) - dl, dl)] = False
    at = np.repeat(pos[insertion], length[insertion])
    kept = np.insert(keep, at, True)
    return (np.insert(h, at, bases)[kept],
            np.insert(np.arange(len(h)), at, at)[kept])


def _derived(cfg: dict, seed: int, sample: int) -> list[tuple]:
    """(substitutions, indels) of each haplotype after the first."""
    subs = _substitutions(cfg, seed, sample)
    no_indel = (np.zeros(0, np.int64), np.zeros(0, np.int64), np.zeros(0, bool),
                np.zeros(0, np.uint8))
    indels = cfg.get("indel_rate") or cfg.get("indel_runs_per_mbp")
    return [(v, _indels(cfg, seed, sample, h + 1) if indels else no_indel)
            for h, v in enumerate(subs)]


def _windows(h: np.ndarray, m: int) -> tuple[np.ndarray, np.ndarray]:
    """(canonical m-mer of every window, whether it is its own reverse
    complement), 2 bits a base, the first base highest; m < 32. Built
    by doubling: a window of 2w bases from two of w."""
    fwd = {1: h.astype(np.int64)}
    rev = {1: 3 - fwd[1]}
    w = 1
    while 2 * w <= m:
        f, r = fwd[w], rev[w]
        fwd[2 * w] = (f[:-w] << (2 * w)) | f[w:]
        rev[2 * w] = r[:-w] | (r[w:] << (2 * w))
        w *= 2
    f, r, have = fwd[w], rev[w], w
    for part in sorted(fwd, reverse=True):
        if have + part <= m:
            f = (f[:-part] << (2 * part)) | fwd[part][have:]
            r = r[:-part] | (rev[part][have:] << (2 * have))
            have += part
    return np.minimum(f, r), f == r


def _unique_windows(g: np.ndarray, variants: list, m: int) -> np.ndarray:
    """Change bases of `g` until no m-mer of any haplotype occurs at two
    places or is its own reverse complement."""
    g = g.copy()
    for _ in range(64):
        vals, pal = _windows(g, m)
        n = len(vals)
        pos = [np.arange(n)]
        allv = [vals]
        for v in variants:
            hv, hpal = _windows(_apply(g, v), m)
            touched = np.zeros(len(g) + 1, dtype=np.int64)
            np.add.at(touched, v[0] + 1, 1)
            touched = np.cumsum(touched)
            hit = (touched[m:m + n] - touched[:n]) > 0  # windows holding a variant
            pal |= hit & hpal
            sel = np.flatnonzero(hit & (hv != vals))
            pos.append(sel)
            allv.append(hv[sel])
        pos_a, val_a = np.concatenate(pos), np.concatenate(allv)
        s = np.sort(val_a)
        twice = np.isin(val_a, s[1:][s[1:] == s[:-1]])
        # a value at one place in two haplotypes is no repeat
        pv = np.unique(np.stack([val_a[twice], pos_a[twice]], 1), axis=0)
        again = np.zeros(len(pv), dtype=bool)
        again[1:] = pv[1:, 0] == pv[:-1, 0]
        bad = np.union1d(pv[again, 1], np.flatnonzero(pal))
        if len(bad) == 0:
            return g
        mid = bad + m // 2
        g[mid] = (g[mid] + 1) % 4
    raise RuntimeError("the genome keeps repeated windows")


def _unique_windows_edited(g: np.ndarray, derived: list[tuple], m: int) -> np.ndarray:
    """_unique_windows for haplotypes with shared sites and indels: change
    bases of `g` until no m-mer occurs twice in one haplotype, or in two
    at genome positions more than m - 1 apart, or is its own reverse
    complement. A haplotype's window equal to the genome's at the same
    position is the genome's. A bad window's middle base is changed; every
    fourth round the base changed moves one on, since a shared site of four
    alleles there would leave one haplotype's window bad whatever the
    genome's base."""
    g = g.copy()
    for rnd in range(64):
        off = m // 2 + (rnd // 4) % (m - m // 2)  # the base changed, from the window's start
        vals, pal = _windows(g, m)
        n = len(vals)
        value, at, hap, mid = [vals], [np.arange(n)], [np.zeros(n, np.int64)], [np.arange(n) + off]
        bad = [np.flatnonzero(pal) + off]
        for t, (sub, events) in enumerate(derived, 1):
            h, coord = _edit(_apply(g, sub), events)
            hv, hpal = _windows(h, m)
            c = coord[:len(hv)]
            new = np.flatnonzero((c >= n) | (hv != vals[np.minimum(c, n - 1)]))
            value.append(hv[new])
            at.append(c[new])
            hap.append(np.full(len(new), t, dtype=np.int64))
            mid.append(coord[new + off])
            bad.append(coord[np.flatnonzero(hpal) + off])
        value, at, hap, mid = (np.concatenate(x) for x in (value, at, hap, mid))
        o = np.lexsort((at, value))
        v, c = value[o], at[o]
        starts = np.r_[True, v[1:] != v[:-1]]
        first = c[np.maximum.accumulate(np.where(starts, np.arange(len(v)), 0))]
        bad.append(mid[o][~starts & (c - first > m - 1)])
        o = np.lexsort((hap, value))  # twice in one haplotype
        twice = np.r_[False, (value[o][1:] == value[o][:-1]) & (hap[o][1:] == hap[o][:-1])]
        bad.append(mid[o][twice])
        bad = np.unique(np.concatenate(bad))
        if len(bad) == 0:
            return g
        g[bad] = (g[bad] + 1) % 4
    raise RuntimeError("the genome keeps repeated windows")


_GENOME_CACHE: dict = {}


def genome(cfg: dict, seed: int) -> np.ndarray:
    key = (json.dumps(cfg, sort_keys=True), int(seed))
    if key not in _GENOME_CACHE:
        g = _rng(seed, 0).integers(0, 4, cfg["genome_bp"], dtype=np.uint8)
        _GENOME_CACHE.clear()
        if edited(cfg):
            derived = [d for s in range(len(cfg["samples"])) for d in _derived(cfg, seed, s)]
            _GENOME_CACHE[key] = _unique_windows_edited(g, derived, cfg["k"] - 1)
        else:
            variants = [v for s in range(len(cfg["samples"])) for v in _variants(cfg, seed, s)]
            _GENOME_CACHE[key] = _unique_windows(g, variants, cfg["k"] - 1)
    return _GENOME_CACHE[key]


def haplotypes(cfg: dict, seed: int, sample: int) -> list[np.ndarray]:
    g = genome(cfg, seed)
    return [g] + [_edit(_apply(g, sub), events)[0] for sub, events in _derived(cfg, seed, sample)]


def _fragments(cfg: dict, seed: int, sample: int, hap: int, n: int, G: int):
    rng = _rng(seed, 2, sample, hap)
    L = cfg["read_len"]
    mean, sd = cfg["fragment_mean"], cfg["fragment_sd"]
    flen = np.clip(np.rint(rng.normal(mean, sd, n)), L, min(2 * mean, G)).astype(np.int64)
    start = (rng.random(n) * (G - flen + 1)).astype(np.int64)
    reverse = rng.random(n) < 0.5
    return start, flen, reverse


def mate_codes(cfg: dict, seed: int, sample: int, mate: int):
    """Yield [n, read_len] uint8 code blocks (0..3 = ACGT) of one mate
    file of one sample, in file order, errors included."""
    L = cfg["read_len"]
    n = pairs_per_haplotype(cfg, sample)
    erng = _rng(seed, 3, sample, mate)
    cols = np.arange(L, dtype=np.int64)
    for hap, h in enumerate(haplotypes(cfg, seed, sample)):
        start, flen, reverse = _fragments(cfg, seed, sample, hap, n, len(h))
        for lo in range(0, n, CHUNK):
            s, f, r = start[lo:lo + CHUNK], flen[lo:lo + CHUNK], reverse[lo:lo + CHUNK]
            # forward strand: mate 1 at the fragment's start, mate 2 (rc)
            # at its end; reverse strand: the other way round
            at_end = r if mate == 1 else ~r
            pos = np.where(at_end, s + f - L, s)
            block = h[pos[:, None] + cols[None, :]]
            # the reverse-complemented mate is the one read from the end
            block[at_end] = 3 - block[at_end][:, ::-1]
            err = erng.random(block.shape) < cfg["error_rate"]
            ne = int(err.sum())
            if ne:
                block[err] = (block[err] + erng.integers(1, 4, ne, dtype=np.uint8)) % 4
            yield block


def _fastq_block(codes: np.ndarray, first: int, mate: int, width: int) -> bytes:
    """Fixed-width FASTQ records: @r<index, `width` digits>/<mate>."""
    n, L = codes.shape
    head = 2 + width + 3  # '@r' digits '/m\n'
    rec = head + L + 1 + 2 + L + 1
    out = np.empty((n, rec), dtype=np.uint8)
    out[:, 0] = ord("@")
    out[:, 1] = ord("r")
    idx = np.arange(first, first + n, dtype=np.int64)
    for p in range(width):
        out[:, 2 + p] = 48 + (idx // 10 ** (width - 1 - p)) % 10
    out[:, 2 + width] = ord("/")
    out[:, 3 + width] = 48 + mate
    out[:, 4 + width] = 10
    out[:, head:head + L] = ACGT[codes]
    out[:, head + L] = 10
    out[:, head + L + 1] = ord("+")
    out[:, head + L + 2] = 10
    out[:, head + L + 3:head + 2 * L + 3] = ord("I")
    out[:, -1] = 10
    return out.tobytes()


def write_mate(cfg: dict, seed: int, sample: int, mate: int, path: str) -> int:
    """Write one gzipped FASTQ mate file; returns the bytes written."""
    width = max(9, len(str(2 * cfg["ploidy"] * pairs_per_haplotype(cfg, sample))))
    n = 0
    with open(path, "wb") as raw, gzip.GzipFile(fileobj=raw, mode="wb", compresslevel=1,
                                                 mtime=0, filename="") as gz:
        for block in mate_codes(cfg, seed, sample, mate):
            gz.write(_fastq_block(block, n, mate, width))
            n += len(block)
    return os.path.getsize(path)


def expected_reads(cfg: dict) -> int:
    return sum(2 * cfg["ploidy"] * pairs_per_haplotype(cfg, s) for s in range(len(cfg["samples"])))


def mate_paths(cfg: dict, directory: str) -> list[list[str]]:
    """[[mate1, mate2] for each sample] under `directory`."""
    return [[os.path.join(directory, f"s{s}_{m}.fq.gz") for m in (1, 2)]
            for s in range(len(cfg["samples"]))]


def _write_job(args) -> int:
    cfg, seed, sample, mate, path = args
    return write_mate(cfg, seed, sample, mate, path)


def write_all(cfg: dict, seed: int, directory: str, processes: int | None = None) -> tuple[list[list[str]], int]:
    """Every mate file of every sample, one process a file. Returns the
    paths and the bytes written."""
    import multiprocessing

    paths = mate_paths(cfg, directory)
    jobs = [(cfg, seed, s, m + 1, p) for s, pair in enumerate(paths) for m, p in enumerate(pair)]
    n = processes or len(jobs)
    if n <= 1:
        sizes = [_write_job(j) for j in jobs]
    else:
        with multiprocessing.get_context("spawn").Pool(min(n, len(jobs))) as pool:
            sizes = pool.map(_write_job, jobs)
    return paths, int(sum(sizes))


def sanity(cfg: dict) -> None:
    """Refuse a configuration the recipe cannot make."""
    L = cfg["read_len"]
    if cfg["genome_bp"] < 2 * cfg["fragment_mean"] or cfg["fragment_mean"] < L:
        raise ValueError("genome shorter than two fragments, or fragments shorter than a read")
    if not 0 <= cfg["error_rate"] < 1 or any(not 0 <= s["het"] < 1 for s in cfg["samples"]):
        raise ValueError("rates must lie in [0, 1)")
    if math.isnan(float(cfg["fragment_sd"])):
        raise ValueError("fragment_sd is not a number")
    if not (0 <= cfg.get("shared_site_rate", 0) < 1 and 0 <= cfg.get("shared_site_carry", 0) <= 1
            and 0 <= cfg.get("indel_rate", 0) < 1 and cfg.get("indel_runs_per_mbp", 0) >= 0
            and cfg.get("indel_max_len", 1) >= 1):
        raise ValueError("shared-site and indel rates must lie in [0, 1), lengths at least 1")
    if cfg.get("shared_site_rate") and "shared_site_carry" not in cfg:
        raise ValueError("shared_site_rate needs shared_site_carry")

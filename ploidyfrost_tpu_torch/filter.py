# Copied from ploidyfrost_tpu/filter.py; a missing matplotlib fails drawfreq with one line.
"""Post-processing layer: Filter.R / Filter-multi.R / Drawfreq.R ports.

The reference ships its site filtering and plotting as R scripts
(script/Filter.R:1-159, script/Filter-multi.R:1-186, script/
Drawfreq.R:1-53). This module reimplements them natively so the whole
pipeline is one tool with no R dependency.

Semantics mirrored exactly, including the quirks:
  * `--snp` KEEPS VarType>0 rows (i.e. "filter snp" retains indels,
    Filter.R:95-101) and `--indel` keeps VarType==0;
  * the tetra and penta coverage filters additionally require the sum
    of the first FOUR coverages < up (Filter.R:108-113 — penta sums
    only CovA..CovD);
  * the recomputed allele frequencies are emitted COLUMN-MAJOR per
    class: all first-allele frequencies, then all second-allele, ...
    (the `c(bifre[1,], bifre[2,])` concatenation, Filter.R:124-152);
  * frequencies are rounded half-to-even to 7 decimals and bounded to
    the OPEN interval (frequency, 1-frequency) (Filter.R:159).

Filter-multi adds the `color` column after the coverages and the
`Cramer` column between VarNum and VarDis, plus `Cramer > cramer` and
optional `color == color_id` filters (Filter-multi.R:106-135).
"""

from __future__ import annotations

import os
import sys
from dataclasses import dataclass, field

import numpy as np

CLASSES = [("bi", 2), ("tri", 3), ("tetra", 4), ("penta", 5)]

# drawfreq and the pictures of figures draw with matplotlib, imported
# where it is used; without it they write no picture and return 1
MATPLOTLIB_MISSING = (
    "Error: {what} needs the matplotlib package to draw its PNG files, "
    "and it is not installed"
)


@dataclass
class FilterOptions:
    """Defaults mirror the R optparse definitions (Filter.R:5-28,
    Filter-multi.R:5-32)."""

    simple: bool = False
    outprefix: str = "filtered"
    color: int = -1  # multi only
    inprefix: str = "input"
    low: int = 0
    up: int = 10000
    indel: bool = False
    snp: bool = False
    num: int = 10000
    distance: int = -1
    size: int = 10000
    frequency: float = 0.05
    cramer: float = 0.0  # multi only


def _r_num(x: float) -> str:
    """R write.table numeric formatting: shortest decimal
    representation (integers without a trailing .0)."""
    if x == int(x) and abs(x) < 1e15:
        return str(int(x))
    return repr(float(x))


def _read_cov_table(path: str, n_cov: int, multi: bool):
    """Parse a {bi,tri,tetra,penta}cov table into numeric rows.

    Columns: Cov1..CovN [color] isStrict VarType VarId VarNum [Cramer]
    VarDis (README.md:218-233; src/CCDBG.cpp:3021-3046)."""
    rows = []
    with open(path) as f:
        for line in f:
            parts = line.split("\t")
            parts = [p for p in parts if p.strip() != ""]
            if not parts:
                continue
            rows.append([float(p) for p in parts])
    return rows


def filter_tables(opt: FilterOptions, multi: bool = False) -> int:
    """Filter.R / Filter-multi.R main body."""
    if opt.frequency > 0.5:
        print("frequency should < 0.5 ", file=sys.stderr)
        return 1
    tables = {}
    for name, n in CLASSES:
        path = f"{opt.inprefix}_{name}cov.txt"
        if not os.path.exists(path):
            print(f"This file ( {path} ) does not exists !", file=sys.stderr)
            return 1
        tables[name] = _read_cov_table(path, n, multi)

    # column indices within a row
    def cols(n):
        if multi:
            # covs, color, isStrict, VarType, VarId, VarNum, Cramer, VarDis
            return {
                "color": n,
                "strict": n + 1,
                "vartype": n + 2,
                "varnum": n + 4,
                "cramer": n + 5,
                "vardis": n + 6,
            }
        return {
            "strict": n,
            "vartype": n + 1,
            "varnum": n + 3,
            "vardis": n + 4,
        }

    out = {}
    for name, n in CLASSES:
        c = cols(n)
        rows = tables[name]
        if opt.simple:
            rows = [r for r in rows if r[c["strict"]] == 1]
        if opt.indel:
            rows = [r for r in rows if r[c["vartype"]] == 0]
        if opt.snp:
            rows = [r for r in rows if r[c["vartype"]] > 0]
        kept = []
        for r in rows:
            covs = r[:n]
            if not all(opt.low < cv < opt.up for cv in covs):
                continue
            # tetra/penta extra gate: sum of the first four coverages
            # must also be < up (Filter.R:108,113)
            if not multi and n >= 4 and sum(covs[:4]) >= opt.up:
                continue
            if not (
                r[c["varnum"]] < opt.num
                and r[c["vardis"]] > opt.distance
                and r[c["vartype"]] < opt.size
            ):
                continue
            if multi:
                if not r[c["cramer"]] > opt.cramer:
                    continue
                if opt.color >= 0 and r[c["color"]] != opt.color:
                    continue
            kept.append(r)
        out[name] = kept
        with open(f"{opt.outprefix}_{name}cov.txt", "w") as f:
            for r in kept:
                f.write("\t".join(_r_num(v) for v in r) + "\n")

    # recompute frequencies COLUMN-MAJOR per class (Filter.R:124-152)
    fre_all: list[float] = []
    for name, n in CLASSES:
        kept = out[name]
        if not kept:
            continue
        sums = [sum(r[:n]) for r in kept]
        for a in range(n):
            fre_all.extend(r[a] / s for r, s in zip(kept, sums))
    with open(f"{opt.outprefix}_allele_frequency.txt", "w") as f:
        for v in fre_all:
            if opt.frequency < v < 1 - opt.frequency:
                f.write(_r_num(float(np.round(v, 7))) + "\n")
    return 0


def _parse_filter_args(argv) -> FilterOptions:
    opt = FilterOptions()
    i = 0
    flags = {
        "-S": "simple",
        "--simple": "simple",
        "-I": "indel",
        "--indel": "indel",
        "-P": "snp",
        "--snp": "snp",
    }
    values = {
        "-o": ("outprefix", str),
        "--outprefix": ("outprefix", str),
        "-c": ("color", int),
        "--color": ("color", int),
        "-i": ("inprefix", str),
        "--inprefix": ("inprefix", str),
        "-l": ("low", int),
        "--low": ("low", int),
        "-u": ("up", int),
        "--up": ("up", int),
        "-n": ("num", int),
        "--num": ("num", int),
        "-d": ("distance", int),
        "--distance": ("distance", int),
        "-s": ("size", int),
        "--size": ("size", int),
        "-q": ("frequency", float),
        "--frequency": ("frequency", float),
        "-v": ("cramer", float),
        "--cramer": ("cramer", float),
    }
    while i < len(argv):
        a = argv[i]
        if a in flags:
            setattr(opt, flags[a], True)
        elif a in values:
            name, typ = values[a]
            i += 1
            setattr(opt, name, typ(argv[i]))
        else:
            raise SystemExit(f"unknown filter option {a}")
        i += 1
    return opt


def cmd_filter(argv, multi: bool = False) -> int:
    """`ploidyfrost-tpu-torch filter` / `filter-multi` subcommands."""
    return filter_tables(_parse_filter_args(argv), multi)


def drawfreq(
    fre_file: str,
    outprefix: str = "allele_frequency",
    title: str = "title",
    ploidy: int = 0,
) -> int:
    """Drawfreq.R port: density plot of allele frequencies with dashed
    vlines at i/ploidy (script/Drawfreq.R:28-53). Saves
    {outprefix}_allele_frequency.png. Without matplotlib: one line on
    stderr, no file, return 1."""
    if not os.path.exists(fre_file):
        print(f"This file:{fre_file} is not exists!")
        return 1
    try:
        import matplotlib
    except ImportError:
        print(MATPLOTLIB_MISSING.format(what="drawfreq"), file=sys.stderr)
        return 1
    data = np.loadtxt(fre_file, ndmin=1)
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from scipy.stats import gaussian_kde

    fig, ax = plt.subplots(figsize=(8, 5))
    if len(data) > 1 and np.std(data) > 0:
        # R geom_density default: gaussian kernel, nrd0 bandwidth
        sd = np.std(data, ddof=1)
        iqr = np.subtract(*np.percentile(data, [75, 25]))
        sigma = min(sd, iqr / 1.34) if iqr > 0 else sd
        bw = 0.9 * sigma * len(data) ** (-0.2)
        kde = gaussian_kde(data, bw_method=bw / sd)
        xs = np.linspace(min(data) - 3 * bw, max(data) + 3 * bw, 512)
        ys = kde(xs)
        ax.fill_between(xs, ys, color="#6EBFEC")
        ax.plot(xs, ys, color="black", linewidth=1)
    else:
        ax.hist(data, bins=50, color="#6EBFEC", edgecolor="black")
    for i in range(1, max(ploidy, 0)):
        ax.axvline(i / ploidy, linestyle="--", color="black", linewidth=1)
    ax.set_xticks(np.arange(0, 1.01, 0.1))
    ax.set_xlabel("frequency")
    ax.set_ylabel("density")
    ax.set_title(title)
    fig.tight_layout()
    fig.savefig(f"{outprefix}_allele_frequency.png", dpi=120)
    plt.close(fig)
    return 0


def cmd_drawfreq(argv) -> int:
    fre_file = ""
    outprefix = "allele_frequency"
    title = "title"
    ploidy = 0
    i = 0
    while i < len(argv):
        a = argv[i]
        if a in ("-f", "--file"):
            i += 1
            fre_file = argv[i]
        elif a in ("-o", "--outprefix"):
            i += 1
            outprefix = argv[i]
        elif a in ("-t", "--title"):
            i += 1
            title = argv[i]
        elif a in ("-p", "--ploidy"):
            i += 1
            ploidy = int(argv[i])
        else:
            raise SystemExit(f"unknown drawfreq option {a}")
        i += 1
    return drawfreq(fre_file, outprefix, title, ploidy)

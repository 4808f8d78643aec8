# Ported from ploidyfrost_tpu/figures.py; the tables and the pictures are two functions.
"""`figures` subcommand: the engine-native generalization of the
reference's paper-analysis notebook (script/paper_figures.R).

The notebook repeats one workflow per dataset (SNJ17 at
paper_figures.R:213-355, LSX118 :357-504, F. ananassa :505-655, the
3-sample colored snj run :656-846):

1.  read the `_{bi,tri,tetra,penta}cov.txt` tables and derive a site
    coverage table (row-sum of allele coverages + VarNum + VarSize)
    and an allele-frequency table (each allele's coverage / row sum)
    (`readcov` paper_figures.R:2-103, `colour.readcov` :107-209);
2.  build filter tiers — all / VarNum<=5&VarSize<=10 /
    VarNum==1&VarSize<=10 for single-sample (:221-228), and
    all / VarNum<=5&VarSize<=10 / Cramer>=t / Cramer<t for
    multi-sample (:674-689);
3.  emit a site-statistics table: per tier, site counts and the
    fraction of out-of-range sites (coverage outside
    [(p-1)c, (p+1)c] for monoploid coverage c and ploidy p) removed
    by the filter (:245-259 single, :717-744 per-color multi);
4.  plot the allele-frequency density per tier with vlines at i/p
    (:290-307), the coverage density with vlines at (p-1)c and (p+1)c
    and the x-axis clipped at the 99th percentile (:309-327);
5.  plot average log-likelihood vs candidate ploidy per tier
    (:329-355) — where the notebook pastes numbers from separate
    `PloidyFrost model` runs, this command fits the GMM (model/gmm.py,
    the exact EM of src/GmmModel.cpp) on each tier's frequencies live.

Unlike the notebook this is dataset-agnostic: any output prefix works,
so it is an engine capability rather than a one-off script. Figure
styling is matplotlib-idiomatic, not a ggplot clone; the *numbers*
(tiers, densities with R's nrd0 bandwidth, vline positions, site
statistics, log-likelihoods) match the notebook's definitions.

The work is split in two: `figure_tables` reads the tables, builds the
tiers, fits the GMM on `device` and writes the two .tsv files, and needs
no matplotlib; `draw_figures` draws the PNG files from its result and
imports matplotlib when called. `make_figures` runs one after the other.
With `group` (parallel/mesh.Group) the GMM fits split over the ranks and
only rank 0 writes the tables and draws.
"""

from __future__ import annotations

import os
import sys

import numpy as np

# (class name, allele count) in emission order — README.md:218-233
CLASSES = (("bi", 2), ("tri", 3), ("tetra", 4), ("penta", 5))


def read_cov_tables(prefix: str, multi: bool):
    """readcov / colour.readcov (paper_figures.R:2-103, 107-209).

    Returns (coverage, frequency) dicts of 1-D arrays. coverage holds
    one entry per site row: total coverage (sum of allele coverages),
    varnum, varsize (the VarType column), and for multi also color and
    coe (Cramer's V). frequency holds one entry per ALLELE: fre =
    cov_i / row-sum, with the row's varnum/varsize (and coe/color)
    repeated per allele, in the notebook's column-major order
    (all first alleles, then all second alleles, ... :72,81,90,99).

    A missing class file is treated as empty with a warning on stderr
    (the notebook `message()`s and then errors on NULL; every real run
    emits all four files)."""
    cov_total, cov_num, cov_size = [], [], []
    cov_color, cov_coe = [], []
    fre, fre_num, fre_size = [], [], []
    fre_color, fre_coe = [], []
    for name, n in CLASSES:
        path = f"{prefix}_{name}cov.txt"
        if not os.path.exists(path):
            print(
                f"This file ( {path} ) does not exists !", file=sys.stderr
            )
            continue
        rows = []
        with open(path) as f:
            for line in f:
                parts = [p for p in line.split("\t") if p.strip() != ""]
                if parts:
                    rows.append([float(p) for p in parts])
        if not rows:
            continue
        arr = np.asarray(rows, dtype=np.float64)
        covs = arr[:, :n]
        # column layout after the covs: single = isStrict VarType VarId
        # VarNum VarDis; multi = color isStrict VarType VarId VarNum
        # Cramer VarDis (README.md:218-233; src/CCDBG.cpp:3021-3046)
        off = n + (1 if multi else 0)
        vartype = arr[:, off + 1]
        varnum = arr[:, off + 3]
        total = covs.sum(axis=1)
        cov_total.append(total)
        cov_num.append(varnum)
        cov_size.append(vartype)
        if multi:
            color = arr[:, n]
            coe = arr[:, off + 4]
            cov_color.append(color)
            cov_coe.append(coe)
        # frequency rows, column-major over alleles like the notebook
        with np.errstate(invalid="ignore"):
            f_mat = covs / total[:, None]
        for a in range(n):
            fre.append(f_mat[:, a])
            fre_num.append(varnum)
            fre_size.append(vartype)
            if multi:
                fre_color.append(color)
                fre_coe.append(coe)
    if not cov_total:
        raise SystemExit(
            f"figures: no coverage tables found for prefix {prefix}"
        )

    def cat(parts):
        return np.concatenate(parts) if parts else np.zeros(0)

    coverage = {
        "coverage": cat(cov_total),
        "varnum": cat(cov_num),
        "varsize": cat(cov_size),
    }
    frequency = {
        "fre": cat(fre),
        "varnum": cat(fre_num),
        "varsize": cat(fre_size),
    }
    if multi:
        coverage["color"] = cat(cov_color)
        coverage["coe"] = cat(cov_coe)
        frequency["color"] = cat(fre_color)
        frequency["coe"] = cat(fre_coe)
    return coverage, frequency


def filter_tiers(table, multi: bool, cramer: float):
    """The notebook's filter tiers as (label, boolean-mask) pairs.

    Single-sample: all / VarNum<=5&VarSize<=10 / VarNum=1&VarSize<=10
    (paper_figures.R:221-228). Multi-sample: all / VarNum<=5&VarSize<=10
    / Cramer's V >= t / Cramer's V < t (:674-689, t=0.25 there)."""
    num = table["varnum"]
    size = table["varsize"]
    n = len(num)
    tiers = [
        ("all", np.ones(n, dtype=bool)),
        ("VarNum<=5&VarSize<=10", (num <= 5) & (size <= 10)),
    ]
    if multi:
        coe = table["coe"]
        tiers.append((f"Cramer's V >= {cramer:g}", coe >= cramer))
        tiers.append((f"Cramer's V < {cramer:g}", coe < cramer))
    else:
        tiers.append(("VarNum=1&VarSize<=10", (num == 1) & (size <= 10)))
    return tiers


def _out_of_range(cov, c, p):
    return (cov < (p - 1) * c) | (cov > (p + 1) * c)


def site_stats(coverage, tiers, covs, ploidy, multi: bool, names):
    """The site.dt statistics table (paper_figures.R:245-259; per-color
    :717-744). One row per sample (single-sample = one row). Columns,
    per non-'all' tier T: num.T, remain.proportion.T,
    num.T.filter.outrange, filter.proportion.outrange.T — plus the
    unfiltered count and its out-of-range count."""
    cov_arr = coverage["coverage"]
    rows = []
    header = ["sample", "num.unfiltered", "num.unfiltered.outrange"]
    for label, _ in tiers[1:]:
        header += [
            f"num[{label}]",
            f"remain.proportion[{label}]",
            f"num.filter.outrange[{label}]",
            f"filter.proportion.outrange[{label}]",
        ]
    samples = (
        sorted(set(coverage["color"].astype(int))) if multi else [None]
    )
    for si, s in enumerate(samples):
        c = covs[si] if si < len(covs) else covs[-1]
        sel = (
            coverage["color"].astype(int) == s
            if multi
            else np.ones(len(cov_arr), dtype=bool)
        )
        base = cov_arr[sel]
        base_out = int(_out_of_range(base, c, ploidy).sum())
        name = (
            names[si]
            if names and si < len(names)
            else (str(s) if multi else "sample")
        )
        row = [name, len(base), base_out]
        for _, mask in tiers[1:]:
            kept = cov_arr[sel & mask]
            kept_out = int(_out_of_range(kept, c, ploidy).sum())
            row += [
                len(kept),
                len(kept) / len(base) if len(base) else 0.0,
                base_out - kept_out,
                1.0 - kept_out / base_out if base_out else 0.0,
            ]
        rows.append(row)
    return header, rows


def _nrd0_density(data, xs):
    """R's stats::density defaults — gaussian kernel, bw.nrd0 — the
    same bandwidth rule Drawfreq.R inherits (filter.drawfreq)."""
    from scipy.stats import gaussian_kde

    data = data[np.isfinite(data)]
    if len(data) < 2 or np.std(data) == 0:
        return None
    sd = np.std(data, ddof=1)
    iqr = np.subtract(*np.percentile(data, [75, 25]))
    sigma = min(sd, iqr / 1.34) if iqr > 0 else sd
    bw = 0.9 * sigma * len(data) ** (-0.2)
    kde = gaussian_kde(data, bw_method=bw / sd)
    return kde(xs)


def ll_curves(frequency, tiers, gauss_lower, gauss_upper, device="cuda", group=None):
    """Average log-likelihood vs candidate ploidy per tier — the live
    computation behind the notebook's pasted vectors
    (paper_figures.R:329-334): for each tier, fit the GMM at every
    gauss count g in [gauss_lower, gauss_upper] on that tier's allele
    frequencies (the exact EM of src/GmmModel.cpp via model/gmm.py, on
    `device`, or over `group`'s ranks) and record ll/N. Returns
    (ploidies, {label: [ll]})."""
    from .model.gmm import GmmModel

    ploidies = list(range(gauss_lower + 1, gauss_upper + 2))
    curves = {}
    for label, mask in tiers:
        model = GmmModel(device, group)
        data = frequency["fre"][mask]
        data = data[np.isfinite(data)]
        model.read_data(data)
        lls = []
        for g in range(gauss_lower, gauss_upper + 1):
            model.resize(g)
            model.em_iterate()
            n = max(len(data), 1)
            lls.append(model.get_log_likelihood() / n)
        curves[label] = lls
    return ploidies, curves


def figure_tables(
    prefix: str,
    outprefix: str,
    covs,
    ploidy: int,
    multi: bool = False,
    cramer: float = 0.25,
    names=None,
    gauss_lower: int = 1,
    gauss_upper: int = 9,
    with_model: bool = True,
    device="cuda",
    group=None,
) -> dict:
    """Everything of the workflow that is not a picture: read the
    coverage tables, build the tiers, write {outprefix}_site_stats.tsv
    and, with with_model, fit the GMM on `device` and write
    {outprefix}_loglikelihood.tsv. Returns what `draw_figures` draws."""
    from . import resolve_device
    from .parallel.mesh import is_primary

    device = resolve_device(device)
    primary = is_primary(group)
    coverage, frequency = read_cov_tables(prefix, multi)
    cov_tiers = filter_tiers(coverage, multi, cramer)
    fre_tiers = filter_tiers(frequency, multi, cramer)

    # --- site statistics table (paper_figures.R:245-259, 717-744)
    header, rows = site_stats(
        coverage, cov_tiers, covs, ploidy, multi, names
    )
    with open(f"{outprefix}_site_stats.tsv" if primary else os.devnull, "w") as f:
        f.write("\t".join(header) + "\n")
        for row in rows:
            f.write(
                "\t".join(
                    f"{v:.6g}" if isinstance(v, float) else str(v)
                    for v in row
                )
                + "\n"
            )

    # --- avg log-likelihood vs ploidy per tier (:329-355)
    ploidies, curves = [], {}
    if with_model:
        ploidies, curves = ll_curves(
            frequency, fre_tiers, gauss_lower, gauss_upper, device, group
        )
        with open(f"{outprefix}_loglikelihood.tsv" if primary else os.devnull, "w") as f:
            f.write("filter\t" + "\t".join(map(str, ploidies)) + "\n")
            for label, lls in curves.items():
                f.write(
                    label
                    + "\t"
                    + "\t".join(f"{v:.6g}" for v in lls)
                    + "\n"
                )
    return {
        "coverage": coverage,
        "frequency": frequency,
        "cov_tiers": cov_tiers,
        "fre_tiers": fre_tiers,
        "ploidies": ploidies,
        "curves": curves,
    }


def draw_figures(tables: dict, outprefix: str, covs, ploidy: int) -> int:
    """The pictures of `figure_tables`' result:
    {outprefix}_frequency_density.png, {outprefix}_coverage_density.png
    and, where the model was fitted, {outprefix}_loglikelihood.png.
    Without matplotlib: one line on stderr, no file, return 1."""
    try:
        import matplotlib
    except ImportError:
        from .filter import MATPLOTLIB_MISSING

        print(MATPLOTLIB_MISSING.format(what="figures"), file=sys.stderr)
        return 1
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    coverage, frequency = tables["coverage"], tables["frequency"]
    cov_tiers, fre_tiers = tables["cov_tiers"], tables["fre_tiers"]
    ploidies, curves = tables["ploidies"], tables["curves"]

    # vlines at i/p (paper_figures.R:263-268)
    vls = [i / ploidy for i in range(1, ploidy)]

    # --- allele-frequency density, one facet per tier (:290-307)
    fig, axes = plt.subplots(
        1, len(fre_tiers), figsize=(4 * len(fre_tiers), 3.2), sharey=True
    )
    axes = np.atleast_1d(axes)
    xs = np.linspace(0.0, 1.0, 512)
    for ax, (label, mask) in zip(axes, fre_tiers):
        ys = _nrd0_density(frequency["fre"][mask], xs)
        if ys is not None:
            ax.fill_between(xs, ys, alpha=0.6)
            ax.plot(xs, ys, linewidth=1)
        for v in vls:
            ax.axvline(v, linestyle=":", color="black", linewidth=1)
        ax.set_title(label, fontsize=9)
        ax.set_xlabel("allele frequency")
    axes[0].set_ylabel("density")
    fig.tight_layout()
    fig.savefig(f"{outprefix}_frequency_density.png", dpi=120)
    plt.close(fig)

    # --- coverage density scaled to counts, x clipped at the 99th
    # percentile, vlines at (p-1)c and (p+1)c (:309-327)
    fig, axes = plt.subplots(
        1, len(cov_tiers), figsize=(4 * len(cov_tiers), 3.2), sharey=True
    )
    axes = np.atleast_1d(axes)
    cov_all = coverage["coverage"]
    xmax = float(np.quantile(cov_all, 0.99)) if len(cov_all) else 1.0
    xs_c = np.linspace(0.0, xmax, 512)
    cmean = float(np.mean(covs)) if covs else 0.0
    for ax, (label, mask) in zip(axes, cov_tiers):
        data = cov_all[mask]
        ys = _nrd0_density(data, xs_c)
        if ys is not None:
            ax.fill_between(xs_c, ys * len(data), alpha=0.6)
            ax.plot(xs_c, ys * len(data), linewidth=1)
        if cmean > 0:
            ax.axvline(
                cmean * (ploidy - 1), linestyle=":", color="black",
                linewidth=1,
            )
            ax.axvline(
                cmean * (ploidy + 1), linestyle=":", color="black",
                linewidth=1,
            )
        ax.set_title(label, fontsize=9)
        ax.set_xlabel("k-mer coverage")
        ax.set_xlim(0, xmax)
    axes[0].set_ylabel("count")
    fig.tight_layout()
    fig.savefig(f"{outprefix}_coverage_density.png", dpi=120)
    plt.close(fig)

    if curves:
        fig, ax = plt.subplots(figsize=(6, 4))
        for label, lls in curves.items():
            ax.plot(ploidies, lls, marker="o", markersize=3, label=label)
            if ploidy in ploidies:
                ax.axhline(
                    lls[ploidies.index(ploidy)],
                    linestyle=":",
                    linewidth=0.8,
                    color="gray",
                )
        ax.set_xlabel("ploidy")
        ax.set_ylabel("average log-likelihood")
        ax.set_xticks(ploidies)
        ax.legend(fontsize=7)
        fig.tight_layout()
        fig.savefig(f"{outprefix}_loglikelihood.png", dpi=120)
        plt.close(fig)
    return 0


def make_figures(
    prefix: str,
    outprefix: str,
    covs,
    ploidy: int,
    multi: bool = False,
    cramer: float = 0.25,
    names=None,
    gauss_lower: int = 1,
    gauss_upper: int = 9,
    with_model: bool = True,
    device="cuda",
    group=None,
) -> int:
    """Run the full per-dataset workflow of paper_figures.R on any
    PloidyFrost output prefix. Writes {outprefix}_site_stats.tsv,
    {outprefix}_frequency_density.png, {outprefix}_coverage_density.png
    and, with with_model, {outprefix}_loglikelihood.{tsv,png}. The
    tables are written first; without matplotlib they are all that is
    written and the result is 1."""
    tables = figure_tables(
        prefix, outprefix, covs, ploidy, multi, cramer, names,
        gauss_lower, gauss_upper, with_model, device, group,
    )
    from .parallel.mesh import is_primary

    if not is_primary(group):
        return 0
    return draw_figures(tables, outprefix, covs, ploidy)


def cmd_figures(argv, device="cuda", group=None) -> int:
    """CLI: ploidyfrost-tpu-torch figures -i prefix -o out -c covs -p ploidy
    [--multi] [--cramer T] [--names a,b,...] [--no-model]
    [--gauss-low L --gauss-up U]."""
    prefix = outprefix = ""
    covs = []
    ploidy = 2
    multi = False
    cramer = 0.25
    names = None
    gl, gu = 1, 9
    with_model = True
    i = 0
    while i < len(argv):
        a = argv[i]
        if a in ("-i", "--inprefix"):
            i += 1
            prefix = argv[i]
        elif a in ("-o", "--outprefix"):
            i += 1
            outprefix = argv[i]
        elif a in ("-c", "--coverage"):
            i += 1
            covs = [float(x) for x in argv[i].split(",") if x]
        elif a in ("-p", "--ploidy"):
            i += 1
            ploidy = int(argv[i])
        elif a == "--multi":
            multi = True
        elif a == "--cramer":
            i += 1
            cramer = float(argv[i])
        elif a == "--names":
            i += 1
            names = argv[i].split(",")
        elif a == "--no-model":
            with_model = False
        elif a == "--gauss-low":
            i += 1
            gl = int(argv[i])
        elif a == "--gauss-up":
            i += 1
            gu = int(argv[i])
        else:
            raise SystemExit(f"unknown figures option {a}")
        i += 1
    if not prefix or not covs:
        raise SystemExit(
            "figures: -i <prefix> and -c <monoploid coverage[,per "
            "sample...]> are required (-p ploidy defaults to 2)"
        )
    if not outprefix:
        outprefix = prefix
    return make_figures(
        prefix,
        outprefix,
        covs,
        ploidy,
        multi=multi,
        cramer=cramer,
        names=names,
        gauss_lower=gl,
        gauss_upper=gu,
        with_model=with_model,
        device=device,
        group=group,
    )

# Ported from ploidyfrost_tpu/sites/emit_colored.py and ploidyfrost_tpu/sites/emit.py.
"""What is colored in the sites pass of several samples (sites/emit.py
runs the pass).

Behavioral port of the analysis phase of CCDBG::ploidyEstimation_ptr
(src/CCDBG.cpp:2759-3531): per-color coverage vectors, the uniformly-
colored-branch requirement, Cramér's V association between samples, and
the colored output row formats (Color column after the coverages,
Cramer column between VarNum and VarDis). All k-mer count probes
resolve in one fused host search over the union table
(MultiColorCountDB).

Deliberately-mirrored reference quirks (documented, not accidental):
  * the entrance-unitig "core" coverage loop's failure branch contains
    `flag == false;` (a comparison, not an assignment,
    src/CCDBG.cpp:2852) — so a failing color only stops the summation,
    it never drops the bubble;
  * Cramér's V is computed ONCE per bubble over the branch coverage
    vectors in the strict path (src/CCDBG.cpp:2957-2963) but PER SITE
    over the allele-group coverages in the branching path
    (src/CCDBG.cpp:3280-3287);
  * std::max(coefficient, v) keeps `coefficient` when v is NaN
    (0/0 expected counts); Python's max() would propagate NaN, so the
    comparison is written out explicitly.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from ..bubble.superbubble import BubbleState
from ..graph.cdbg import CDBGraph
from ..graph.colors import ColorMatrix
from ..util.format import cpp_double
from ..util.profiling import add_count
from .emit import _row_total, analyze, write_tables


def cramer_v(A, B) -> float:
    """Cramér's V between two coverage vectors
    (CCDBG::computeCramerVCoefficient, src/CCDBG.cpp:330-366).

    Pure python doubles in the reference's exact accumulation order —
    IEEE-identical to the C++ loop (and to the previous np.float64
    scalar version) at a fraction of the per-call overhead; this runs
    once per color pair per strict bubble."""
    a = [float(x) for x in A]
    b = [float(x) for x in B]
    p = [x + y for x, y in zip(a, b)]
    n = _seq_sum(p)
    nA = _seq_sum(a)
    nB = _seq_sum(b)
    if sum(1 for x in p if x != 0.0) < 2:
        return 0.0
    chi = 0.0
    for i in range(len(a)):
        if p[i] == 0.0:
            continue
        exA = nA * p[i] / n
        exB = nB * p[i] / n
        # 0/0 -> NaN propagates, exactly as the C++ doubles do
        try:
            chi = chi + (a[i] - exA) ** 2 / exA
            chi = chi + (b[i] - exB) ** 2 / exB
        except ZeroDivisionError:
            chi = math.nan
    return math.sqrt(chi / n) if chi == chi and chi >= 0.0 else math.nan


def _seq_sum(v):
    s = 0.0
    for x in v:
        s += x
    return s


def max_cramer(cov_vec: np.ndarray) -> float:
    """max over color pairs, with std::max's NaN-keeps-left semantics
    (src/CCDBG.cpp:2957-2963)."""
    C = cov_vec.shape[0]
    coefficient = 0.0
    for ci in range(C - 1):
        for cj in range(ci + 1, C):
            v = cramer_v(cov_vec[ci], cov_vec[cj])
            coefficient = v if coefficient < v else coefficient
    return coefficient


def max_cramer_batch(covs: np.ndarray) -> np.ndarray:
    """Vectorized max_cramer over a [N, C, B] stack of coverage
    vectors — IEEE-identical to the scalar loop for B <= 3 branches
    (the dominant population: 2-branch strict bubbles).

    Exactness argument: the reference accumulates chi as
    `chi += aterm_i; chi += bterm_i` over branches in order
    (src/CCDBG.cpp:330-366); the interleaved 2B-term row reduce below
    is strictly left-to-right for row lengths <= 7 (numpy pairwise
    summation only reorders above 8 elements), so every partial sum
    matches the C++ double sequence bit-for-bit. Rows with B > 3 fall
    back to the scalar path."""
    N, C, B = covs.shape
    if N == 0:
        return np.zeros(0, dtype=np.float64)
    if 2 * B > 7:
        return np.array([max_cramer(c) for c in covs], dtype=np.float64)
    covs = covs.astype(np.float64, copy=False)
    pairs = [(ci, cj) for ci in range(C - 1) for cj in range(ci + 1, C)]
    vs = np.empty((N, len(pairs)), dtype=np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        for pi, (ci, cj) in enumerate(pairs):
            a = covs[:, ci]  # [N, B]
            b = covs[:, cj]
            p = a + b
            n = np.add.reduce(p, axis=1)
            nA = np.add.reduce(a, axis=1)
            nB = np.add.reduce(b, axis=1)
            pmask = p != 0.0
            exA = nA[:, None] * p / n[:, None]
            exB = nB[:, None] * p / n[:, None]
            ta = (a - exA) ** 2 / exA  # 0/0 -> NaN, as the C++ doubles
            tb = (b - exB) ** 2 / exB
            terms = np.empty((N, 2 * B), dtype=np.float64)
            terms[:, 0::2] = np.where(pmask, ta, 0.0)
            terms[:, 1::2] = np.where(pmask, tb, 0.0)
            chi = np.add.reduce(terms, axis=1)
            v = np.sqrt(chi / n)  # NaN/negative chi -> NaN
            v = np.where((chi == chi) & (chi >= 0.0), v, np.nan)
            v = np.where(pmask.sum(axis=1) < 2, 0.0, v)
            vs[:, pi] = v
    # sequential `coefficient = v if coefficient < v else coefficient`
    # from 0.0 == max over the non-NaN vs and 0.0
    vv = np.where(np.isnan(vs), -np.inf, vs)
    return np.maximum(0.0, vv.max(axis=1))


@dataclass
class ColoredSiteEmission:
    maxnum: int
    is_simple: bool
    var_type_indel_len: int
    var_id: int
    var_num: int
    var_dis: int
    # strict: per-color per-group coverages + the per-bubble coefficient
    color_group_cov: np.ndarray | None = None  # [C, maxnum]
    coefficient: float | None = None
    # branching: per allele group, SORTED distinct window strings
    group_windows: list[list[str]] | None = None


@dataclass
class ColoredBubbleEmission:
    var_id: int
    is_simple: bool
    entrance_id: int
    exit_id: int
    aligned_rows: list[str]
    core_cov: float
    sites: list[ColoredSiteEmission] = field(default_factory=list)


def _fused(dbs):
    """Cached MultiColorCountDB over the color dbs. The cache tuple
    holds STRONG references to the db list and compares with `is`, so a
    recycled id() of a garbage-collected db can never alias a stale
    fused table (the cycle through dbs[0] is collectable)."""
    from ..kmer.countdb import MultiColorCountDB

    cached = getattr(dbs[0], "_fused_cache", None)
    if (
        cached is not None
        and len(cached[0]) == len(dbs)
        and all(a is b for a, b in zip(cached[0], dbs))
    ):
        return cached[1]
    fused = MultiColorCountDB(dbs)
    dbs[0]._fused_cache = (tuple(dbs), fused)
    return fused


def unitig_coverage_colored(dbs, g: CDBGraph, cutoffs):
    """Batched readCovUni for every (unitig, color)
    (src/CCDBG.cpp:123-156): per-color mean k-mer count and an
    all-k-mers-within-(low,up) validity flag — ONE fused probe pass for
    all colors (kmer/countdb.MultiColorCountDB)."""
    flat, lens = g.store.all_kmers(g.k)
    starts = np.zeros(len(lens), dtype=np.int64)
    np.cumsum(lens[:-1], out=starts[1:])
    C = len(dbs)
    call_t, hit = _fused(dbs).lookup_t(flat)
    mean = np.empty((len(lens), C), dtype=np.float64)
    ok = np.empty((len(lens), C), dtype=bool)
    for c in range(C):
        low, up = cutoffs[c]
        counts = call_t[c]  # contiguous int64; sums < 2^53 stay exact,
        # so int64 reduceat + one float divide == the float64 reduceat
        inb = hit & (counts > low) & (counts < up)
        ok[:, c] = np.minimum.reduceat(inb.view(np.uint8), starts) > 0
        mean[:, c] = np.add.reduceat(counts, starts) / lens
    return mean, ok


def window_coverage_colored(dbs, strings: list[str], cutoffs):
    """Batched readCov(s, low, up, color) (src/CCDBG.cpp:89-122) for
    every distinct window string against every color database.
    Returns dict window -> (means[C], oks[C])."""
    from ..graph.seqstore import SeqStore
    from ..kmer.pack import encode_bases

    uniq = sorted(set(strings))
    add_count("windows", len(uniq))
    out: dict[str, tuple[np.ndarray, np.ndarray]] = {}
    if not uniq:
        return out
    k = dbs[0].k
    # one vectorized encode + word-gather extraction (see
    # emit.window_coverage)
    lens = np.array([len(s) - k + 1 for s in uniq], dtype=np.int64)
    offs = np.zeros(len(lens) + 1, dtype=np.int64)
    np.cumsum(lens, out=offs[1:])
    wstore = SeqStore.from_codes(
        encode_bases("".join(uniq)),
        np.array([len(s) for s in uniq], dtype=np.int64),
    )
    flat, _ = wstore.all_kmers(k)
    starts = offs[:-1]
    C = len(dbs)
    call_t, hit = _fused(dbs).lookup_t(flat)
    means = np.empty((len(lens), C), dtype=np.float64)
    oks = np.empty((len(lens), C), dtype=bool)
    for c in range(C):
        low, up = cutoffs[c]
        counts = call_t[c]
        inb = hit & (counts > low) & (counts < up)
        oks[:, c] = np.minimum.reduceat(inb.view(np.uint8), starts) > 0
        means[:, c] = np.add.reduceat(counts, starts) / lens
    for i, s in enumerate(uniq):
        out[s] = (means[i], oks[i])
    return out


class SeveralSamples:
    """What a site's coverage is with several samples (src/CCDBG.cpp):
    a vector of per-color mean counts, a branch admitted when each color
    it holds covers every one of its k-mers within that color's bounds.

    The other side of emit.OneSample's seam."""

    Bubble = ColoredBubbleEmission
    Site = ColoredSiteEmission

    def __init__(self, g: CDBGraph, colors: ColorMatrix, umean, uok):
        self.g = g
        self.colors = colors
        self.umean = umean
        self.uok = uok
        full_all = colors.full_colors_all()
        # branch admission (src/CCDBG.cpp:2880-2902), per unitig b:
        #   every contained color must be coverage-valid, and the color set
        #   must cover ALL k-mers uniformly: size(b) == count(full) * len
        self.n_full = full_all.sum(axis=1)  # [n] j = number of full colors
        lens_km = np.diff(colors.offsets)
        self.branch_ok = (~(full_all & ~uok).any(axis=1)) & (
            colors.size_all() == self.n_full * lens_km
        )
        # per-branch per-color coverage contribution when admitted
        self.branch_cov = np.where(full_all & uok, umean, 0.0)  # [n, C]

    def core(self) -> list[float]:
        """Every unitig's core coverage: per-color means summed until the
        first failing color (src/CCDBG.cpp:2840-2855's early break), the
        sum over the cumulative-AND prefix of uok."""
        okpfx = np.cumprod(self.uok, axis=1).astype(bool)  # [n, C]
        # left-to-right accumulation (adding exact 0.0 for masked colors)
        # keeps the float64 sequence identical to the scalar loop
        core_all = np.zeros(len(self.umean), dtype=np.float64)
        for ci in range(self.colors.n_colors):
            core_all = core_all + np.where(okpfx[:, ci], self.umean[:, ci], 0.0)
        return core_all.tolist()

    def gather(self, valid: np.ndarray, bidx: np.ndarray):
        """Whole-batch admission of the strict pairs ([P, 4] branch
        slots): every branch admitted, and some color covering two
        branches or more (src/CCDBG.cpp:2906-2924). Returns the verdicts
        and each pair's (per-branch color coverages, per-branch full
        color counts), as lists."""
        adm = np.where(valid, self.branch_ok[bidx], True).all(axis=1) & valid.any(
            axis=1
        )
        cov_p = np.where(valid[:, :, None], self.branch_cov[bidx], 0.0)  # [P, 4, C]
        adm &= ((cov_p != 0.0).sum(axis=1) > 1).any(axis=1)
        nf_p = np.where(valid, self.n_full[bidx], 0)
        return adm.tolist(), list(zip(cov_p.tolist(), nf_p.tolist()))

    def branches(self, pay, slots: list[int], refs: list[str]):
        """An admitted pair's branch order (sortSeq_simple: color count
        desc, then length desc, then lexicographic desc,
        src/CCDBG.cpp:368-472) and its [C, nb] coverages in that order."""
        covr, nf_r = pay
        path_color = [nf_r[s] for s in slots]
        order = sorted(
            range(len(slots)),
            key=lambda i: (path_color[i], len(refs[i]), refs[i]),
            reverse=True,
        )
        return order, np.array([covr[slots[i]] for i in order], dtype=np.float64).T

    def bubble_values(self, jobs) -> list:
        """What every site of a strict bubble shares: its Cramér
        coefficient over the branch coverage vectors, for every strict
        job in one vectorized pass per branch count (max_cramer_batch)."""
        out: list = [None] * len(jobs)
        by_b: dict[int, list[int]] = {}
        for i, j in enumerate(jobs):
            if j.is_strict:
                by_b.setdefault(j.payload.shape[1], []).append(i)
        for idxs in by_b.values():
            coeffs = max_cramer_batch(np.stack([jobs[i].payload for i in idxs]))
            for i, v in zip(idxs, coeffs):
                out[i] = float(v)
        return out

    def strict_site(self, cov_vec, coefficient, part, maxnum, vt, var_id, var_num, var_dis):
        """A strict site's rows: each color's allele-group coverages."""
        if maxnum == len(part) and part == list(range(1, maxnum + 1)):
            # identity partition (the fast-path norm): each branch is its
            # own group
            group_cov = cov_vec.astype(np.float64, copy=True)
        else:
            group_cov = np.zeros((self.colors.n_colors, maxnum), dtype=np.float64)
            for ci in range(self.colors.n_colors):
                for j in range(len(part)):
                    group_cov[ci, part[j] - 1] += cov_vec[ci, j]
        return ColoredSiteEmission(
            maxnum, True, vt, var_id, var_num, var_dis,
            color_group_cov=group_cov, coefficient=coefficient,
        )

    def window_colors(self, strings: list[str]) -> dict[str, np.ndarray]:
        """Each window's colors: those of its first k-mer
        (findUnitig(s, 0, len), src/CCDBG.cpp:3250)."""
        out: dict[str, np.ndarray] = {}
        kindex = None
        for w in strings:
            if w not in out:
                if kindex is None:
                    kindex = self.g.kmer_pos_index()
                wi, pos, hit = kindex.find_string_head(w)
                assert hit, f"window head k-mer not in graph: {w[:self.g.k]}"
                out[w] = self.colors.colors_at(wi, pos).copy()
        return out


def analyze_bubbles_colored(
    g: CDBGraph,
    colors: ColorMatrix,
    state: BubbleState,
    umean: np.ndarray,
    uok: np.ndarray,
    match: float = 2.0,
    mismatch: float = -1.0,
    gap: float = -3.0,
    device=None,
):
    """Colored ploidyEstimation analysis (src/CCDBG.cpp:2759-3531,
    emit.analyze).

    umean/uok: per-(unitig, color) mean coverage and validity from
    unitig_coverage_colored. Returns (emissions, window strings,
    window->contained-colors map)."""
    seam = SeveralSamples(g, colors, umean, uok)
    emissions, window_strings = analyze(g, state, seam, match, mismatch, gap, device)
    return emissions, window_strings, seam.window_colors(window_strings)


def write_outputs_colored(
    emissions: list[ColoredBubbleEmission],
    window_cov: dict[str, tuple[np.ndarray, np.ndarray]],
    window_colors: dict[str, np.ndarray],
    n_colors: int,
    outpre: str,
    outdir: str = "PloidyFrost_output",
) -> dict:
    """The colored tables (emit.write_tables): a row a color of a site,
    the color's number after the coverages and the Cramér coefficient
    between VarNum and VarDis (src/CCDBG.cpp:3021-3046, 3300-3330). A
    color whose coverages hold fewer than two non-zero values writes no
    row."""
    C = n_colors

    def color_rows(rows_list, tail: str, row):
        for ci in range(C):
            res = [float(c) for c in rows_list[ci] if c > 0.0]
            if len(res) >= 2:
                row(res, _row_total(res), f"{ci}\t" + tail)

    def site_rows(site: ColoredSiteEmission, row):
        if site.color_group_cov is not None:
            # strict: tail = isSimple, VarType, VarId, VarNum,
            # Cramer, VarDis (src/CCDBG.cpp:3021-3033)
            tail = (
                f"1\t{site.var_type_indel_len}\t{site.var_id}\t"
                f"{site.var_num}\t{cpp_double(site.coefficient)}\t"
                f"{site.var_dis}\t\n"
            )
            color_rows(site.color_group_cov.tolist(), tail, row)
            return
        # branching: resolve per-color window coverage
        cov_vec = np.zeros((C, site.maxnum), dtype=np.float64)
        color_set: set[int] = set()
        for gi, grp in enumerate(site.group_windows):
            for w in grp:
                means, oks = window_cov[w]
                for ci in np.nonzero(window_colors[w])[0]:
                    color_set.add(int(ci))
                    if not oks[ci]:
                        return
                    cov_vec[ci, gi] += means[ci]
        if len(color_set) != C:
            return
        tail = (
            f"0\t{site.var_type_indel_len}\t{site.var_id}\t"
            f"{site.var_num}\t{cpp_double(max_cramer(cov_vec))}\t"
            f"{site.var_dis}\t\n"
        )
        color_rows(cov_vec, tail, row)

    return write_tables(emissions, site_rows, outpre, outdir)

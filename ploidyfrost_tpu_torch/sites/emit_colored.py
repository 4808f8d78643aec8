# Copied from ploidyfrost_tpu/sites/emit_colored.py; imports point at this package.
"""Colored (multi-sample) variant-site extraction + emission.

Behavioral port of the analysis phase of CCDBG::ploidyEstimation_ptr
(src/CCDBG.cpp:2759-3531): per-color coverage vectors, the uniformly-
colored-branch requirement, Cramér's V association between samples, and
the colored output row formats (Color column after the coverages,
Cramer column between VarNum and VarDis).

Same two-pass structure as the uncolored path (sites/emit.py):
pass 1 walks the bubble state machine on host and records pending
per-color coverage references; all k-mer count probes resolve in one
fused host search over the union table (MultiColorCountDB); pass 2 applies the
reference's gates and writes rows in the original sequential order.

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

from ..align.msa import SeqAlign
from ..bubble.superbubble import NULL, BubbleState
from ..graph.cdbg import CDBGraph
from ..graph.colors import ColorMatrix, KmerPosIndex
from ..util.format import cpp_double
from ..util.profiling import add_count
from .emit import (
    _enumerate_paths,
    _indel_windows,
    _snp_windows,
    _sorted_desc_by_len_then_str,
    _var_distance,
)


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
    # pipeline.window_coverage)
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


@dataclass
class _ColoredAlignJob:
    """One admitted colored bubble awaiting alignment."""

    str_vec: list[str]
    var_id: int
    is_strict: bool
    entrance_id: int
    exit_id: int
    u_size: int
    exit_size: int
    core: float
    cov_vec: np.ndarray | None  # strict: [C, n_branches], sorted order


def _collect_colored_jobs(
    g: CDBGraph,
    colors: ColorMatrix,
    state: BubbleState,
    umean: np.ndarray,
    uok: np.ndarray,
) -> list[_ColoredAlignJob]:
    """Walk phase of the colored ploidyEstimation
    (src/CCDBG.cpp:2759-3531): admission gates + branch ordering, with
    alignment deferred (same job-collection structure as emit.py)."""
    C = colors.n_colors
    jobs: list[_ColoredAlignJob] = []
    candidates = np.flatnonzero(state.flags & 0x03)
    if len(candidates) > len(g) // 8:
        g.seqs.materialize()  # bulk corpus decode beats per-unitig calls
    full_all = colors.full_colors_all()
    size_all = colors.size_all()

    # ---- vectorized per-unitig gate precomputation -------------------
    # core coverage: per-color means summed until the first failing
    # color (src/CCDBG.cpp:2840-2855's early-break) == sum over the
    # cumulative-AND prefix of uok
    okpfx = np.cumprod(uok, axis=1).astype(bool)  # [n, C]
    # left-to-right accumulation (adding exact 0.0 for masked colors)
    # keeps the float64 sequence identical to the scalar loop
    core_all = np.zeros(len(umean), dtype=np.float64)
    for ci in range(C):
        core_all = core_all + np.where(okpfx[:, ci], umean[:, ci], 0.0)
    # branch admission (src/CCDBG.cpp:2880-2902), per unitig b:
    #   every contained color must be coverage-valid, and the color set
    #   must cover ALL k-mers uniformly: size(b) == count(full) * len
    n_full = full_all.sum(axis=1)  # [n] j = number of full colors
    lens_km = np.diff(colors.offsets)
    branch_ok_all = (~(full_all & ~uok).any(axis=1)) & (
        size_all == n_full * lens_km
    )
    # per-branch per-color coverage contribution when admitted
    branch_cov_all = np.where(full_all & uok, umean, 0.0)  # [n, C]
    succ_flat = np.asarray(g._succ)  # [n, 2, 4] packed (idx*2+strand)

    # ---- whole-batch strict-pair gates (no per-bubble numpy) ---------
    # every (ui, strand) with the strict bit gets one row: its branch
    # slots, exit, admission verdict, per-branch-color coverages and
    # color counts — all gathered in a handful of array ops, then
    # converted to python lists so the sequential walk below touches no
    # numpy at all for gate decisions
    sp = np.flatnonzero(state.flags & 0x10)  # strict, strand True
    sm = np.flatnonzero(state.flags & 0x08)  # strict, strand False
    pair_key = np.concatenate([sp * 2 + 1, sm * 2])
    Pn = len(pair_key)
    if Pn:
        pu = pair_key >> 1
        ps = pair_key & 1
        srows = succ_flat[pu, ps]  # [P, 4]
        valid = srows >= 0
        bidx = np.where(valid, srows >> 1, 0)
        adm = np.where(valid, branch_ok_all[bidx], True).all(axis=1) & valid.any(
            axis=1
        )
        cov_p = np.where(
            valid[:, :, None], branch_cov_all[bidx], 0.0
        )  # [P, 4, C]
        # some color must cover >= 2 branches (src/CCDBG.cpp:2906-2924)
        adm &= ((cov_p != 0.0).sum(axis=1) > 1).any(axis=1)
        any_b = valid.any(axis=1)
        rows_i = np.arange(Pn)
        b0 = srows[rows_i, np.argmax(valid, axis=1)]
        erow = succ_flat[
            np.where(any_b, b0 >> 1, 0), np.where(any_b, b0 & 1, 0)
        ]
        evalid = erow >= 0
        e0 = erow[rows_i, np.argmax(evalid, axis=1)]
        exitp = np.where(any_b & evalid.any(axis=1), e0, -1)
        nf_p = np.where(valid, n_full[bidx], 0)
        srows_l = srows.tolist()
        exitp_l = exitp.tolist()
        adm_l = adm.tolist()
        cov_l = cov_p.tolist()
        nf_l = nf_p.tolist()
        row_of = np.full(2 * len(g), -1, dtype=np.int64)
        row_of[pair_key] = rows_i
        row_of_l = row_of.tolist()
    else:
        row_of_l = [-1] * (2 * len(g))
    seqs = g.seqs
    ids_l = g.ids.tolist()
    core_l = core_all.tolist()
    from ..graph.cdbg import revcomp as _rc

    for ui in candidates:
        ui = int(ui)
        while not state.is_both_visited(ui):
            if not state.is_plus_visited(ui):
                strand = True
                if state.is_complex(ui, True):
                    state.set_visited(ui, True)
                    continue
            elif not state.is_minus_visited(ui):
                strand = False
                if state.is_complex(ui, False):
                    state.set_visited(ui, False)
                    break
            else:
                break
            is_strict = state.is_strict(ui, strand)
            # entrance "core" coverage precomputed vectorized (core_all;
            # the reference's `flag == false;` is a no-op comparison so
            # failure never drops the bubble, src/CCDBG.cpp:2840-2855)
            core = core_l[ui]
            if is_strict:
                # strict registration guarantees every branch has the
                # exit as its only successor (src/CCDBG.cpp:1497-1520);
                # the whole-batch gate rows carry branches/exit/verdict
                r = row_of_l[ui * 2 + (1 if strand else 0)]
                exit_p = exitp_l[r] if r >= 0 else -1
                if exit_p < 0:
                    state.set_visited(ui, strand)
                    continue
                exit_idx = exit_p >> 1
                exit_strand = bool(exit_p & 1)
                useq = seqs[ui]
                eseq = seqs[exit_idx]
                if useq < eseq:
                    state.set_visited(ui, strand)
                    continue
                if adm_l[r]:
                    # sortSeq_simple: color count desc, then length desc,
                    # then lexicographic desc (src/CCDBG.cpp:368-472)
                    row = srows_l[r]
                    slots = [s for s in range(4) if row[s] >= 0]
                    nf_r = nf_l[r]
                    path_color = [nf_r[s] for s in slots]
                    refs = [seqs[row[s] >> 1] for s in slots]
                    order = sorted(
                        range(len(slots)),
                        key=lambda i: (path_color[i], len(refs[i]), refs[i]),
                        reverse=True,
                    )
                    covr = cov_l[r]
                    cov_vec = np.array(
                        [covr[slots[i]] for i in order], dtype=np.float64
                    ).T  # [C, nb]
                    str_vec = [
                        refs[i] if (row[slots[i]] & 1) else _rc(refs[i])
                        for i in order
                    ]
                    jobs.append(
                        _ColoredAlignJob(
                            str_vec,
                            0,  # VarId assigned post-alignment
                            True,
                            ids_l[ui],
                            ids_l[exit_idx],
                            len(useq),
                            len(eseq),
                            core,
                            cov_vec,
                        )
                    )
            else:
                u = g.handle(ui, strand)
                partner = state.bubble_exit(ui, strand)
                if partner == NULL:
                    state.set_visited(ui, strand)
                    continue
                exit_h = u.successors()[0]
                steps = 0
                while exit_h.idx != partner:
                    succ = exit_h.successors()
                    steps += 1
                    if not succ or steps > len(g):
                        exit_h = None
                        break
                    exit_h = succ[0]
                if exit_h is None:
                    state.set_visited(ui, strand)
                    continue
                exit_idx = exit_h.idx
                exit_strand = exit_h.strand
                if u.seq < exit_h.seq:
                    state.set_visited(ui, strand)
                    continue
                str_vec = _enumerate_paths(g, u, exit_h)
                str_vec = _sorted_desc_by_len_then_str(str_vec)
                if not str_vec:
                    # a VarId is consumed only for non-empty enumerations
                    # (src/CCDBG.cpp:1002-1007 `if (str_vec.size() != 0)`)
                    state.set_visited(ui, strand)
                    state.set_visited(exit_idx, not exit_strand)
                    continue
                jobs.append(
                    _ColoredAlignJob(
                        str_vec,
                        0,  # VarId assigned post-alignment
                        False,
                        ids_l[ui],
                        ids_l[exit_idx],
                        u.size,
                        exit_h.size,
                        core,
                        None,
                    )
                )
            state.set_visited(ui, strand)
            state.set_visited(exit_idx, not exit_strand)
    return jobs


def analyze_bubbles_colored(
    g: CDBGraph,
    colors: ColorMatrix,
    state: BubbleState,
    umean: np.ndarray,
    uok: np.ndarray,
    match: float = 2.0,
    mismatch: float = -1.0,
    gap: float = -3.0,
    batch_align: bool = True,
    device=None,
):
    """Colored ploidyEstimation analysis (src/CCDBG.cpp:2759-3531).

    umean/uok: per-(unitig, color) mean coverage and validity from
    unitig_coverage_colored. Returns (emissions, window strings,
    window->contained-colors map).

    Same structure as emit.analyze_bubbles: the walk collects jobs,
    the first-pair NW DP of every bubble runs as one batched call
    (align/batch_nw.py; `device` is where its wavefront runs when the
    native flag kernel is missing), site extraction finishes on host."""
    from .emit import _BATCH_MIN

    seqalign = SeqAlign(match, mismatch, gap)
    k = g.k
    C = colors.n_colors
    kindex: KmerPosIndex | None = None
    window_strings: list[str] = []
    window_colors: dict[str, np.ndarray] = {}

    jobs = _collect_colored_jobs(g, colors, state, umean, uok)

    # fast path: 2-branch equal-length <=2-mismatch bubbles under the
    # default scoring have a provably unique gapless-diagonal alignment
    # (emit._fast_snp_positions) — the dominant population; they skip
    # the DP + traceback + MSA entirely, as in the uncolored path
    from .emit import _fast_snp_positions_batch, _gapless_eligible

    fast: list = [None] * len(jobs)
    gapless = [False] * len(jobs)
    if (match, mismatch, gap) == (2.0, -1.0, -3.0):
        fast = _fast_snp_positions_batch(jobs)
        gapless = [
            fast[i] is None and _gapless_eligible(jobs[i].str_vec)
            for i in range(len(jobs))
        ]
    slow_idx = [
        i for i in range(len(jobs)) if fast[i] is None and not gapless[i]
    ]
    add_count("nw_pairs", len(slow_idx))

    firsts: list = [None] * len(jobs)
    if (
        batch_align
        and len(slow_idx) >= _BATCH_MIN
        and all(float(v).is_integer() for v in (match, mismatch, gap))
    ):
        from ..align.batch_nw import needleman_wunsch_batch

        slow_firsts = needleman_wunsch_batch(
            [(jobs[i].str_vec[0], jobs[i].str_vec[1]) for i in slow_idx],
            match, mismatch, gap, device=device,
        )
        for i, fa in zip(slow_idx, slow_firsts):
            firsts[i] = fa

    # per-bubble Cramér coefficients for every strict job in one
    # vectorized pass per branch-count group (max_cramer_batch)
    coeffs: dict[int, float] = {}
    by_b: dict[int, list[int]] = {}
    for i, j in enumerate(jobs):
        if j.is_strict:
            by_b.setdefault(j.cov_vec.shape[1], []).append(i)
    for _b, idxs in by_b.items():
        out = max_cramer_batch(np.stack([jobs[i].cov_vec for i in idxs]))
        for i, v in zip(idxs, out):
            coeffs[i] = float(v)

    emissions: list[ColoredBubbleEmission] = []
    # VarIds are consumed POST-alignment: an empty compareStrPair result
    # (all co-optimal tracebacks over the 5-indel-run cap) consumes no
    # id and emits nothing (src/CCDBG.cpp:2945-2947)
    var_count = 0
    for job_i, (job, fa, fsnp, gl) in enumerate(
        zip(jobs, firsts, fast, gapless)
    ):
        if fsnp is not None:
            # unique diagonal alignment: rows are the branches
            # unchanged, every variant column is a biallelic SNP with
            # partition [1, 2] (validated vs the generic path by
            # tests/test_fastpath.py::test_colored_fast_matches_generic)
            rows = job.str_vec
            var_site = [int(p) for p in fsnp]
            partition = {vs: [1, 2] for vs in var_site}
            indel_pos: list[int] = []
            indel_len: list[int] = []
        else:
            rows, snp_pos, indel_pos, partition, indel_len = (
                seqalign.sequence_alignment_gapless(job.str_vec)
                if gl
                else seqalign.sequence_alignment(job.str_vec, first_align=fa)
            )
            if not rows:
                continue
            var_site = [
                i for i in range(len(partition)) if partition[i][-1] > 0
            ]
        var_count += 1
        job.var_id = var_count
        be = ColoredBubbleEmission(
            job.var_id,
            job.is_strict,
            job.entrance_id,
            job.exit_id,
            rows,
            job.core,
        )
        indel = 0
        if job.is_strict:
            cov_vec = job.cov_vec
            coefficient = coeffs[job_i]
            for i, vs in enumerate(var_site):
                part = partition[vs]
                maxnum = max(part)
                if maxnum == len(part) and part == list(range(1, maxnum + 1)):
                    # identity partition (the fast-path norm): each
                    # branch is its own group
                    group_cov = cov_vec.astype(np.float64, copy=True)
                else:
                    group_cov = np.zeros((C, maxnum), dtype=np.float64)
                    for ci in range(C):
                        for j in range(len(part)):
                            group_cov[ci, part[j] - 1] += cov_vec[ci, j]
                vd = _var_distance(i, var_site, job.u_size, job.exit_size)
                if vs in indel_pos:
                    indel += 1
                    vt = indel_len[indel - 1]
                else:
                    vt = 0
                be.sites.append(
                    ColoredSiteEmission(
                        maxnum,
                        True,
                        vt,
                        job.var_id,
                        len(var_site),
                        vd,
                        color_group_cov=group_cov,
                        coefficient=coefficient,
                    )
                )
        else:
            for i, vs in enumerate(var_site):
                part = partition[vs]
                maxnum = max(part)
                vd = _var_distance(i, var_site, job.u_size, job.exit_size)
                if vs in indel_pos:
                    windows = _indel_windows(rows, vs, indel, k)
                    indel += 1
                    vt = indel_len[indel - 1]
                else:
                    windows = _snp_windows(rows, vs, indel, indel_len, k)
                    vt = 0
                group_sets: list[set[str]] = [set() for _ in range(maxnum)]
                for pi in range(len(part)):
                    group_sets[part[pi] - 1].add(windows[pi])
                gw = [sorted(s) for s in group_sets]
                for grp in gw:
                    for w in grp:
                        window_strings.append(w)
                        if w not in window_colors:
                            # findUnitig(s,0,len) -> colors of the
                            # window's first k-mer (src/CCDBG.cpp:3250)
                            if kindex is None:
                                kindex = g.kmer_pos_index()
                            wi, pos, hit = kindex.find_string_head(w)
                            assert hit, f"window head k-mer not in graph: {w[:k]}"
                            window_colors[w] = colors.colors_at(wi, pos).copy()
                be.sites.append(
                    ColoredSiteEmission(
                        maxnum,
                        False,
                        vt,
                        job.var_id,
                        len(var_site),
                        vd,
                        group_windows=gw,
                    )
                )
        emissions.append(be)
    return emissions, window_strings, window_colors


def write_outputs_colored(
    emissions: list[ColoredBubbleEmission],
    window_cov: dict[str, tuple[np.ndarray, np.ndarray]],
    window_colors: dict[str, np.ndarray],
    n_colors: int,
    outpre: str,
    outdir: str = "PloidyFrost_output",
) -> dict:
    """Pass 2: resolve pending per-color coverages and write the colored
    output tables (row formats src/CCDBG.cpp:3021-3046, 3300-3330).
    ``outdir=None`` computes stats but discards bytes (multi-host
    non-primary processes, see sites/emit.write_outputs)."""
    import os

    if outdir is not None:
        os.makedirs(outdir, exist_ok=True)

    def op(name):
        if outdir is None:
            return open(os.devnull, "w")
        return open(os.path.join(outdir, outpre + name), "w")

    C = n_colors
    allele = [0, 0, 0, 0]
    core_cov = 0
    core_num = 0
    with op("_allele_frequency.txt") as allfre, op("_bifre.txt") as bifre, op(
        "_trifre.txt"
    ) as trifre, op("_tetrafre.txt") as tetrafre, op("_pentafre.txt") as pentafre, op(
        "_bicov.txt"
    ) as bicov, op("_tricov.txt") as tricov, op("_tetracov.txt") as tetracov, op(
        "_pentacov.txt"
    ) as pentacov, op("_alignseq.txt") as s_var:
        fre_files = {2: bifre, 3: trifre, 4: tetrafre, 5: pentafre}
        cov_files = {2: bicov, 3: tricov, 4: tetracov, 5: pentacov}

        def emit_color_rows(res_cov: list[float], ci: int, tail: str):
            total = sum(res_cov)
            fre_info = "".join(cpp_double(c / total) + "\n" for c in res_cov)
            cov_info = (
                "".join(cpp_double(c) + "\t" for c in res_cov) + f"{ci}\t" + tail
            )
            allfre.write(fre_info)
            if 2 <= len(res_cov) <= 5:
                allele[len(res_cov) - 2] += 1
                fre_files[len(res_cov)].write(fre_info)
                cov_files[len(res_cov)].write(cov_info)

        for be in emissions:
            for row in be.aligned_rows:
                s_var.write(
                    f"{be.var_id}\t{1 if be.is_simple else 0}\t"
                    f"{be.entrance_id}\t{be.exit_id}\t{row}\n"
                )
            core_cov += int(be.core_cov)
            core_num += 1
            for site in be.sites:
                if site.color_group_cov is not None:
                    # strict: tail = isSimple, VarType, VarId, VarNum,
                    # Cramer, VarDis (src/CCDBG.cpp:3021-3033)
                    tail = (
                        f"1\t{site.var_type_indel_len}\t{site.var_id}\t"
                        f"{site.var_num}\t{cpp_double(site.coefficient)}\t"
                        f"{site.var_dis}\t\n"
                    )
                    rows_list = site.color_group_cov.tolist()
                    for ci in range(C):
                        res = [c for c in rows_list[ci] if c > 0.0]
                        if len(res) < 2:
                            continue
                        emit_color_rows(res, ci, tail)
                else:
                    # branching: resolve per-color window coverage
                    cov_vec = np.zeros((C, site.maxnum), dtype=np.float64)
                    color_set: set[int] = set()
                    ok = True
                    for gi, grp in enumerate(site.group_windows):
                        for w in grp:
                            contained = window_colors[w]
                            means, oks = window_cov[w]
                            for ci in np.nonzero(contained)[0]:
                                color_set.add(int(ci))
                                if not oks[ci]:
                                    ok = False
                                    break
                                cov_vec[ci, gi] += means[ci]
                            if not ok:
                                break
                        if not ok:
                            break
                    if len(color_set) != C:
                        continue
                    if not ok:
                        continue
                    coefficient = max_cramer(cov_vec)
                    tail_mid = (
                        f"0\t{site.var_type_indel_len}\t{site.var_id}\t"
                        f"{site.var_num}\t{cpp_double(coefficient)}\t"
                        f"{site.var_dis}\t\n"
                    )
                    for ci in range(C):
                        res = [float(c) for c in cov_vec[ci] if c > 0.0]
                        if len(res) < 2:
                            continue
                        emit_color_rows(res, ci, tail_mid)
    return {"allele": allele, "core_cov": core_cov, "core_num": core_num}

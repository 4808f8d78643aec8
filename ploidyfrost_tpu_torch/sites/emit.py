# Ported from ploidyfrost_tpu/sites/emit.py and ploidyfrost_tpu/sites/emit_colored.py (the coverage probes from ploidyfrost_tpu/pipeline.py).
"""The sites pass: variant-site extraction and allele coverage and
frequency tables, for one sample and for several.

Behavioral port of the analysis phase of CDBG::ploidyEstimation_ptr
(src/CDBG.cpp:1101-1705) and of CCDBG::ploidyEstimation_ptr
(src/CCDBG.cpp:2759-3531): the visited-strand state machine, the strict
(simple-bubble) branch-coverage path and the branching path-enumeration
+ k-window extraction path, with the emission row formats of the
reference's output tables.

The reference probes its k-mer database one k-mer at a time inside the
bubble loop (readCov, src/CDBG.cpp:29-120). Here the probes are split
out of it:

  coverage: every unitig's coverage in one bulk probe of the sorted
         count table (`unitig_coverage`), on a thread beside the
         superbubble search;
  walk:  the state machine admits bubbles and orders their branches
         (`collect_align_jobs`);
  align: the fast paths, one NW batch and the progressive MSA, then
         the sites of each bubble in the walk's order (`analyze`),
         recording k-window strings where a branching site needs them;
  windows: every window string in one bulk probe (`window_coverage`);
  write: the reference's bounds gates and rows in the original
         sequential order (`write_tables`).

What a site's coverage is differs between one sample and several, and
only there: that sits behind the seam of `OneSample` here and
`emit_colored.SeveralSamples`, and each writer's `site_rows`.

Output rows and orderings are identical to the reference single-thread
path (the t=1 fallback of ploidyEstimation_multithread_ptr) — the
multithread variant's interleavings are nondeterministic, so the
deterministic ordering is the canonical one (SURVEY §7 hard-part 2).
"""

from __future__ import annotations

import contextlib
import os
from dataclasses import dataclass, field

import numpy as np

from ..align.msa import SeqAlign
from ..bubble.superbubble import NULL, BubbleState
from ..graph.cdbg import CDBGraph
from ..util.format import cpp_double
from ..util.profiling import add_count


@dataclass
class SiteEmission:
    """One variant site row (destined for {bi,tri,tetra,penta}{cov,fre})."""

    maxnum: int
    is_simple: bool
    var_type_indel_len: int  # 0 for SNP, indel length for indel sites
    var_id: int
    var_num: int
    var_dis: int
    # strict: group coverages are known at pass-1 time
    group_cov: list[float] | None = None
    # branching: per-group sets of k-window strings, resolved in pass 2
    group_windows: list[list[str]] | None = None
    sum_cov: float | None = None  # strict: total branch cov


@dataclass
class BubbleEmission:
    var_id: int
    is_simple: bool
    entrance_id: int
    exit_id: int
    aligned_rows: list[str]
    core_cov: float
    sites: list[SiteEmission] = field(default_factory=list)


def _sorted_desc_by_cov_then_seq(covs: list[float], seqs: list[str]):
    """sortSeq_simple order: coverage desc, tie refseq desc
    (src/CDBG.cpp:482-551)."""
    if len(covs) == 2:
        # dominant case (biallelic); equal keys keep input order like
        # the stable reverse sort below
        if covs[0] != covs[1]:
            return [0, 1] if covs[0] > covs[1] else [1, 0]
        return [0, 1] if seqs[0] >= seqs[1] else [1, 0]
    idx = sorted(range(len(covs)), key=lambda i: (covs[i], seqs[i]), reverse=True)
    return idx


def _sorted_desc_by_len_then_str(strs: list[str]) -> list[str]:
    """sortSeq_branching order: length desc, tie string desc
    (src/CDBG.cpp:417-480)."""
    return sorted(strs, key=lambda s: (len(s), s), reverse=True)


def _var_distance(i: int, var_site: list[int], u_size: int, exit_size: int) -> int:
    """var_distance (src/CDBG.cpp:1279-1298)."""
    if i == 0:
        if i != len(var_site) - 1:
            return min(var_site[i + 1] - var_site[i] - 1, u_size)
        return min(u_size, exit_size)
    if i == len(var_site) - 1:
        return min(var_site[i] - var_site[i - 1] - 1, exit_size)
    return min(var_site[i] - var_site[i - 1] - 1, var_site[i + 1] - var_site[i] - 1)


def _indel_windows(str_vec: list[str], site: int, indel_seen: int, k: int):
    """k-length window strings around an INDEL site
    (src/CDBG.cpp:1471-1525). Returns one window string per aligned row."""
    n = len(str_vec)
    site_vec = [site] * n
    k_length = [""] * n
    while True:
        site_char = set()
        for s in range(n):
            c = str_vec[s][site_vec[s]]
            while c == "-":
                site_vec[s] += 1
                c = str_vec[s][site_vec[s]]
            site_vec[s] += 1
            k_length[s] += c
            site_char.add(c)
        if len(site_char) > 1:
            break
    if indel_seen == 0:
        for s in range(n):
            indel_i = len(k_length[s])
            k_length[s] = str_vec[s][site - k + indel_i : site] + k_length[s]
    else:
        for s in range(n):
            indel_i = len(k_length[s])
            temp = str_vec[s][:site].replace("-", "")
            if len(temp) < k - indel_i:
                k_length[s] = temp + k_length[s]
                ext = site_vec[s]
                while len(k_length[s]) < k:
                    c = str_vec[s][ext]
                    if c != "-":
                        k_length[s] += c
                    ext += 1
            else:
                k_length[s] = temp[len(temp) - (k - indel_i) :] + k_length[s]
    return k_length


def _snp_windows(
    str_vec: list[str], site: int, indel_seen: int, indel_len: list[int], k: int
):
    """k-length window strings around a SNP site (src/CDBG.cpp:1559-1596)."""
    n = len(str_vec)
    k_length = [""] * n
    if indel_seen > 0:
        for s in range(n):
            temp = str_vec[s][: site + 1].replace("-", "")
            if len(temp) < k:
                k_length[s] = temp
                ext = site + 1
                while len(k_length[s]) < k:
                    c = str_vec[s][ext]
                    if c != "-":
                        k_length[s] += c
                    ext += 1
            else:
                k_length[s] = temp[len(temp) - k :]
    else:
        for s in range(n):
            k_length[s] = str_vec[s][site - k + 1 : site + 1]
    return k_length


def _enumerate_paths(g: CDBGraph, entrance, exit_h) -> list[str]:
    """Path-string enumeration between entrance and exit via the
    major/minor stack DFS (src/CDBG.cpp:1364-1412)."""
    str_vec: list[str] = []
    major = []
    minor = [entrance]
    bubble_str = ""
    u_len = entrance.length
    while minor:
        umi = minor.pop()
        major.append(umi)
        s = umi.mapped_seq
        bubble_str += s[: umi.length]
        if umi.same_unitig(exit_h):
            bubble_str += s[umi.length :]
            str_vec.append(
                bubble_str[u_len - 1 : u_len - 1 + len(bubble_str) - u_len + 1 - umi.length + 1]
            )
            bubble_str = bubble_str[: len(bubble_str) - len(s)]
            major.pop()
            while major and minor:
                f = False
                for uma in major[-1].successors():
                    if uma == minor[-1]:
                        f = True
                        break
                if not f:
                    bubble_str = bubble_str[: len(bubble_str) - major[-1].length]
                    major.pop()
                else:
                    break
        else:
            for u in umi.successors():
                minor.append(u)
    return str_vec


def unitig_coverage(db, g):
    """Batched readCov(u) for every unitig (src/CDBG.cpp:66-120): mean
    and min k-mer count per unitig, resolved in one bulk probe batch
    against the sorted table (host-side by design: the probes are
    latency-bound and measured faster on host than via device
    round-trips — see kmer/countdb.py).

    The k-mer feed comes straight from the packed SeqStore (vectorized
    extraction, graph/seqstore.py) — no per-unitig string walks."""
    flat, lens = g.store.all_kmers(g.k)
    counts, hit = db.lookup(flat)
    if not hit.all():
        from ..kmer.pack import decode_kmers

        missing = decode_kmers([flat[int(np.argmin(hit))]], g.k)[0]
        print(f"CDBG::readCov():{missing} kmer can not found .")
        raise SystemExit(1)
    offs = np.zeros(len(lens), dtype=np.int64)
    np.cumsum(lens[:-1], out=offs[1:])
    # segment mean/min via reduceat (ufunc.at is orders slower); int64
    # segment sums are exact, so the float64 means match the former
    # float64 reduceat bit-for-bit without copying the 8B/k-mer array
    mean = np.add.reduceat(counts, offs) / lens
    mn = np.minimum.reduceat(counts, offs)
    return mean, mn


def window_coverage(db, strings: list[str], lower: int, upper: int):
    """Batched readCov(s, lower, upper) (src/CDBG.cpp:29-60): for each
    window string, (mean k-mer count, all-counts-in-(lower,upper) flag)."""
    from ..graph.seqstore import SeqStore
    from ..kmer.pack import encode_bases

    uniq = sorted(set(strings))
    add_count("windows", len(uniq))
    out: dict[str, tuple[float, bool]] = {}
    if not uniq:
        return out
    # one vectorized encode + word-gather k-mer extraction over the
    # whole window corpus (the per-window string_kmers_np loop costs
    # ~130 us/window in python)
    lens = np.array([len(s) - db.k + 1 for s in uniq], dtype=np.int64)
    offs = np.zeros(len(lens) + 1, dtype=np.int64)
    np.cumsum(lens, out=offs[1:])
    wstore = SeqStore.from_codes(
        encode_bases("".join(uniq)),
        np.array([len(s) for s in uniq], dtype=np.int64),
    )
    flat, _ = wstore.all_kmers(db.k)
    counts, hit = db.lookup(flat)
    if not hit.all():
        from ..kmer.pack import decode_kmers

        missing = decode_kmers([flat[int(np.argmin(hit))]], db.k)[0]
        print(f"CDBG::readCov():{missing} kmer can not found .")
        raise SystemExit(1)
    inb = (counts > lower) & (counts < upper)
    starts = offs[:-1]
    ok = np.minimum.reduceat(inb.view(np.uint8), starts) > 0
    mean = np.add.reduceat(counts, starts) / lens
    for i, s in enumerate(uniq):
        out[s] = (float(mean[i]), bool(ok[i]))
    return out


def _row_total(covs) -> float:
    """The total a row's frequencies divide by. Python's sum() of floats
    is compensated since 3.12, where the upstream adds left to right, so
    a row of three or more values can print another last digit."""
    return sum(covs)


class OneSample:
    """What a site's coverage is with one sample (src/CDBG.cpp): the
    mean k-mer count of a unitig, admitted when every count of each
    branch lies within (lower, upper).

    The seam of the sites pass: `core`, `gather` and `branches` serve
    the walk, `bubble_values` and `strict_site` the site loop;
    emit_colored.SeveralSamples is the other side."""

    Bubble = BubbleEmission
    Site = SiteEmission

    def __init__(self, unitig_cov, unitig_min, lower: int, upper: int):
        self.cov = unitig_cov
        self.min = unitig_min
        self.lower = lower
        self.upper = upper

    def core(self) -> list[float]:
        """Every unitig's core coverage: its mean count."""
        return [float(c) for c in self.cov]

    def gather(self, valid: np.ndarray, bidx: np.ndarray):
        """Whole-batch admission of the strict pairs ([P, 4] branch
        slots): every branch's least count within (lower, upper). Returns
        the verdicts and each pair's branch coverages, as lists."""
        mins = self.min[bidx]
        adm = np.where(valid, (mins > self.lower) & (mins < self.upper), True).all(
            axis=1
        ) & valid.any(axis=1)
        return adm.tolist(), np.where(valid, self.cov[bidx], 0.0).tolist()

    def branches(self, covr: list[float], slots: list[int], refs: list[str]):
        """An admitted pair's branch order (sortSeq_simple) and its
        coverages in that order."""
        covs = [covr[s] for s in slots]
        order = _sorted_desc_by_cov_then_seq(covs, refs)
        return order, [covs[i] for i in order]

    def bubble_values(self, jobs) -> list:
        """What every site of a strict bubble shares: its branches'
        total coverage."""
        return [_row_total(j.payload) if j.is_strict else None for j in jobs]

    def strict_site(self, covs, total, part, maxnum, vt, var_id, var_num, var_dis):
        """A strict site's row: each allele group's summed coverage."""
        temp_cov = [0.0] * maxnum
        for j in range(len(part)):
            temp_cov[part[j] - 1] += covs[j]
        return SiteEmission(
            maxnum, True, vt, var_id, var_num, var_dis, group_cov=temp_cov, sum_cov=total
        )


@dataclass
class _AlignJob:
    """One admitted bubble awaiting alignment (collected by the walk)."""

    str_vec: list[str]
    var_id: int
    is_strict: bool
    entrance_id: int
    exit_id: int
    u_size: int
    exit_size: int
    core: float
    payload: object  # strict only: the seam's branch coverages, in str_vec's order


def collect_align_jobs(g: CDBGraph, state: BubbleState, seam) -> list[_AlignJob]:
    """The walk of ploidyEstimation (src/CDBG.cpp:1101-1705,
    src/CCDBG.cpp:2759-3531): walk every unvisited strand in unitig-id
    order, apply the admission gates, and record one alignment job per
    admitted bubble. The walk's visited-bit state machine is identical to
    the reference's; alignment results never feed back into it, so
    alignment is deferred and batched.

    Only strands whose pointer bits are set (registered bubble
    entrances/exits) are 'unvisited' after the search phase, so the walk
    iterates just those instead of all n unitigs.
    """
    jobs: list[_AlignJob] = []
    candidates = np.flatnonzero(state.flags & 0x03)
    if len(candidates) > len(g) // 8:
        # the walk reads entrance/exit/branch strings of ~every bubble:
        # one vectorized corpus decode beats per-unitig decode calls
        g.seqs.materialize()
    succ_flat = np.asarray(g._succ)  # [n, 2, 4] packed (idx*2+strand)

    # ---- whole-batch strict-pair gates --------------------------------
    # one gather pass computes branches / exit / admission verdict /
    # branch payload for EVERY strict (unitig, strand) pair; the walk
    # then reads python lists only
    sp = np.flatnonzero(state.flags & 0x10)  # strict, strand True
    sm = np.flatnonzero(state.flags & 0x08)  # strict, strand False
    pair_key = np.concatenate([sp * 2 + 1, sm * 2])
    Pn = len(pair_key)
    if Pn:
        srows = succ_flat[pair_key >> 1, pair_key & 1]  # [P, 4]
        valid = srows >= 0
        adm_l, pay_l = seam.gather(valid, np.where(valid, srows >> 1, 0))
        any_b = valid.any(axis=1)
        rows_i = np.arange(Pn)
        b0 = srows[rows_i, np.argmax(valid, axis=1)]
        erow = succ_flat[
            np.where(any_b, b0 >> 1, 0), np.where(any_b, b0 & 1, 0)
        ]
        evalid = erow >= 0
        e0 = erow[rows_i, np.argmax(evalid, axis=1)]
        exitp = np.where(any_b & evalid.any(axis=1), e0, -1)
        srows_l = srows.tolist()
        exitp_l = exitp.tolist()
        row_of = np.full(2 * len(g), -1, dtype=np.int64)
        row_of[pair_key] = rows_i
        row_of_l = row_of.tolist()
    else:
        row_of_l = [-1] * (2 * len(g))
    seqs = g.seqs
    ids_l = g.ids.tolist()
    # entrance "core" coverage; in the colored reference a failing color
    # only stops the summation (`flag == false;` is a comparison,
    # src/CCDBG.cpp:2840-2855), so it never drops the bubble
    core_l = seam.core()
    from ..graph.cdbg import revcomp as _rc

    # candidates: any unitig with a set pointer bit (not-visited strand)
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
            core = core_l[ui]
            is_strict = state.is_strict(ui, strand)
            if is_strict:
                # strict registration guarantees every branch has the
                # exit as its only successor (src/CDBG.cpp:1019-1041,
                # src/CCDBG.cpp:1497-1520); the whole-batch gate rows
                # carry branches/exit/verdict
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
                    row = srows_l[r]
                    slots = [s for s in range(4) if row[s] >= 0]
                    refs = [seqs[row[s] >> 1] for s in slots]
                    order, payload = seam.branches(pay_l[r], slots, refs)
                    str_vec = [
                        refs[i] if (row[slots[i]] & 1) else _rc(refs[i])
                        for i in order
                    ]
                    jobs.append(
                        _AlignJob(
                            str_vec,
                            0,  # VarId assigned post-alignment
                            True,
                            ids_l[ui],
                            ids_l[exit_idx],
                            len(useq),
                            len(eseq),
                            core,
                            payload,
                        )
                    )
            else:
                u = g.handle(ui, strand)
                partner = state.bubble_exit(ui, strand)
                if partner == NULL:
                    # inconsistent state (should not happen): bail out
                    state.set_visited(ui, strand)
                    continue
                exit_h = u.successors()[0]
                steps = 0
                while exit_h.idx != partner:
                    # bounded: an inconsistent chain must not loop forever
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
                    # the reference consumes a VarId (and core-coverage
                    # slot) only for non-empty enumerations
                    # (src/CDBG.cpp:1424-1431 `if (str_vec.size() != 0)`)
                    state.set_visited(ui, strand)
                    state.set_visited(exit_idx, not exit_strand)
                    continue
                jobs.append(
                    _AlignJob(
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
            # mark entrance + exit strands visited (src/CDBG.cpp:1656-1679)
            state.set_visited(ui, strand)
            state.set_visited(exit_idx, not exit_strand)
    return jobs


# minimum number of bubbles before the device NW kernel pays for itself
_BATCH_MIN = 16


def _fast_snp_positions(job: _AlignJob) -> np.ndarray | None:
    """Fast-path eligibility check for one alignment job.

    For a 2-branch bubble whose branches have EQUAL length and differ in
    at most 2 positions, the reference's co-optimal NW traceback
    provably returns exactly one alignment — the gapless diagonal —
    under the default scoring (match=2, mismatch=-1, gap=-3): any
    alignment using a gap pair pays >= 7 (two gap opens at -3 plus a
    lost diagonal) but can recover at most +6 from rescuing two
    mismatches, so the diagonal is strictly optimal and unique
    (validated exhaustively for L<=11 over a binary alphabet and on
    ~200k random/adversarial repeat cases against align/nw.py, which is
    itself the tested bit-exact port of src/SeqAlign.cpp:306-549).

    Returns the mismatch positions (= the final snp_pos) when eligible,
    else None. Eligible jobs skip the DP, traceback, progressive MSA
    and compareStrPair entirely — this is the dominant population
    (isolated het SNPs).
    """
    sv = job.str_vec
    if len(sv) != 2 or len(sv[0]) != len(sv[1]):
        return None
    a = np.frombuffer(sv[0].encode(), dtype=np.uint8)
    b = np.frombuffer(sv[1].encode(), dtype=np.uint8)
    neq = a != b
    if int(neq.sum()) > 2:
        return None
    return np.flatnonzero(neq)


def _fast_snp_positions_batch(jobs) -> list:
    """_fast_snp_positions for every job in ~5 whole-corpus numpy ops
    (the per-job version costs 3 small numpy calls x 17k+ jobs).
    Returns a list aligned with `jobs`: mismatch-position array when
    the 2-branch equal-length <=2-mismatch fast path applies, else
    None. Identical decisions to the scalar function."""
    out: list = [None] * len(jobs)
    cand = [
        i
        for i, j in enumerate(jobs)
        if len(j.str_vec) == 2 and len(j.str_vec[0]) == len(j.str_vec[1])
    ]
    if not cand:
        return out
    a_all = np.frombuffer(
        "".join(jobs[i].str_vec[0] for i in cand).encode(), dtype=np.uint8
    )
    b_all = np.frombuffer(
        "".join(jobs[i].str_vec[1] for i in cand).encode(), dtype=np.uint8
    )
    lens = np.array([len(jobs[i].str_vec[0]) for i in cand], dtype=np.int64)
    offs = np.zeros(len(cand) + 1, dtype=np.int64)
    np.cumsum(lens, out=offs[1:])
    neq = a_all != b_all
    counts = np.add.reduceat(neq, offs[:-1])
    counts[lens == 0] = 0  # reduceat quirk on empty segments
    pos_all = np.flatnonzero(neq)
    job_of = np.searchsorted(offs, pos_all, side="right") - 1
    rel = pos_all - offs[job_of]
    # job_of ascends, so each job's positions are one contiguous slice
    starts = np.searchsorted(job_of, np.arange(len(cand)))
    for ci in np.flatnonzero(counts <= 2):
        ci = int(ci)
        out[cand[ci]] = rel[starts[ci] : starts[ci] + counts[ci]]
    return out


def _gapless_eligible(str_vec: list[str]) -> bool:
    """True when EVERY branch pair is equal-length with <=2 mismatches —
    each pairwise NW then has the unique gapless-diagonal optimum (the
    _fast_snp_positions proof applied per pair), so the progressive MSA
    is the stacked input rows (SeqAlign.sequence_alignment_gapless).
    Used for >2-branch bubbles; 2-branch ones take the fast path."""
    if not 2 <= len(str_vec) <= 8:
        # pairwise check is quadratic; >8 equal-length branches within
        # 2 mismatches of EACH OTHER are combinatorially implausible
        return False
    L = len(str_vec[0])
    if any(len(s) != L for s in str_vec[1:]):
        return False
    arrs = [np.frombuffer(s.encode(), dtype=np.uint8) for s in str_vec]
    for i in range(len(arrs) - 1):
        a = arrs[i]
        for j in range(i + 1, len(arrs)):
            if int((a != arrs[j]).sum()) > 2:
                return False
    return True


def analyze(g: CDBGraph, state: BubbleState, seam, match, mismatch, gap, device):
    """The sites pass up to its tables: walk every unvisited strand,
    align, extract sites. Returns (bubble emissions, every window string
    a branching site needs).

    Structure: the walk collects alignment jobs; the first-pair NW DP
    of every bubble that needs one runs as one batched call
    (align/batch_nw.py: the native flag kernel, or without it the
    wavefront on `device`, or the numpy wavefront); traceback,
    progressive MSA of the rare >2-branch bubbles, and site extraction
    remain host passes in the original emission order.
    """
    seqalign = SeqAlign(match, mismatch, gap)
    jobs = collect_align_jobs(g, state, seam)

    # fast paths under the default scoring: 2-branch equal-length
    # <=2-mismatch bubbles bypass alignment entirely
    # (_fast_snp_positions); >2-branch sets whose pairs all qualify
    # skip the DP/traceback/MSA and run only compareStrPair
    # (_gapless_eligible + sequence_alignment_gapless)
    fast: list[np.ndarray | None] = [None] * len(jobs)
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
    if len(slow_idx) >= _BATCH_MIN and all(
        float(v).is_integer() for v in (match, mismatch, gap)
    ):
        from ..align.batch_nw import needleman_wunsch_batch

        slow_firsts = needleman_wunsch_batch(
            [(jobs[i].str_vec[0], jobs[i].str_vec[1]) for i in slow_idx],
            match,
            mismatch,
            gap,
            device=device,
        )
        for i, fa in zip(slow_idx, slow_firsts):
            firsts[i] = fa

    emissions = []
    window_strings: list[str] = []
    # VarIds are consumed POST-alignment: when every co-optimal
    # traceback dies on the 5-indel-run cap, compareStrPair returns an
    # empty vector, SequenceAlignment assigns it back into str_vec, and
    # the reference's `if (str_vec.size() != 0)` consumes no id and
    # emits nothing (src/SeqAlign.cpp:639 + src/CDBG.cpp:1424-1431)
    var_count = 0
    for job, value, fsnp, fa, gl in zip(
        jobs, seam.bubble_values(jobs), fast, firsts, gapless
    ):
        aligned = _align(job, seqalign, fsnp, fa, gl)
        if not aligned[0]:
            continue
        var_count += 1
        job.var_id = var_count
        emissions.append(_emit(job, seam, value, aligned, g.k, window_strings))
    return emissions, window_strings


def _align(job: _AlignJob, seqalign: SeqAlign, fsnp, first_align, gapless: bool):
    """One job's alignment: (rows, variant columns, partition, indel
    columns, indel lengths), rows empty where no co-optimal traceback
    survives. A fast-path job (`fsnp`, its mismatch positions) has the
    gapless diagonal as its unique alignment: its rows are its branches
    and every variant column is a biallelic SNP with partition [1, 2]."""
    if fsnp is not None:
        var_site = [int(p) for p in fsnp]
        return job.str_vec, var_site, {vs: [1, 2] for vs in var_site}, [], []
    rows, _snp_pos, indel_pos, partition, indel_len = (
        seqalign.sequence_alignment_gapless(job.str_vec)
        if gapless
        else seqalign.sequence_alignment(job.str_vec, first_align=first_align)
    )
    var_site = [i for i in range(len(partition)) if partition[i][-1] > 0]
    return rows, var_site, partition, indel_pos, indel_len


def _emit(job: _AlignJob, seam, value, aligned, k: int, window_strings: list[str]):
    """The sites of one aligned job, per variant column
    (src/CDBG.cpp:2050-2147, 2331-2473). `value` is what the seam's
    `bubble_values` gave the job; a branching site's windows are
    appended to `window_strings`."""
    rows, var_site, partition, indel_pos, indel_len = aligned
    be = seam.Bubble(
        job.var_id, job.is_strict, job.entrance_id, job.exit_id, rows, job.core
    )
    nv = len(var_site)
    indel = 0  # indel columns before this one
    for i, vs in enumerate(var_site):
        part = partition[vs]
        maxnum = max(part)
        vd = _var_distance(i, var_site, job.u_size, job.exit_size)
        is_indel = vs in indel_pos
        vt = indel_len[indel] if is_indel else 0
        if job.is_strict:
            site = seam.strict_site(job.payload, value, part, maxnum, vt, job.var_id, nv, vd)
        else:
            windows = (
                _indel_windows(rows, vs, indel, k)
                if is_indel
                else _snp_windows(rows, vs, indel, indel_len, k)
            )
            # group -> SORTED set of distinct windows (std::set
            # iteration order, src/CDBG.cpp:1449, 1527-1530)
            group_sets: list[set[str]] = [set() for _ in range(maxnum)]
            for pi in range(len(part)):
                group_sets[part[pi] - 1].add(windows[pi])
            gw = [sorted(s) for s in group_sets]
            for grp in gw:
                window_strings.extend(grp)
            site = seam.Site(maxnum, False, vt, job.var_id, nv, vd, group_windows=gw)
        be.sites.append(site)
        indel += is_indel
    return be


def analyze_bubbles(
    g: CDBGraph,
    state: BubbleState,
    unitig_cov: np.ndarray,
    unitig_min: np.ndarray,
    lower: int,
    upper: int,
    match: float = 2.0,
    mismatch: float = -1.0,
    gap: float = -3.0,
    device=None,
) -> tuple[list[BubbleEmission], list[str]]:
    """ploidyEstimation analysis of one sample (`analyze`). Returns
    (bubble emissions, all window strings needed).

    unitig_cov/unitig_min: per-unitig mean and min k-mer coverage
    (the batched readCov(u) replacement, src/CDBG.cpp:66-120)."""
    seam = OneSample(unitig_cov, unitig_min, lower, upper)
    return analyze(g, state, seam, match, mismatch, gap, device)


_TABLES = (
    "_allele_frequency.txt",
    "_bifre.txt",
    "_trifre.txt",
    "_tetrafre.txt",
    "_pentafre.txt",
    "_bicov.txt",
    "_tricov.txt",
    "_tetracov.txt",
    "_pentacov.txt",
    "_alignseq.txt",
)


def write_tables(emissions, site_rows, outpre: str, outdir: str) -> dict:
    """Pass 2: write the ten output tables of the sites pass with the
    reference's exact formats (src/CDBG.cpp:1125-1135, 1303-1317,
    1552-1557, 1622-1628; src/CCDBG.cpp:3021-3046, 3300-3330).

    `site_rows(site, row)` resolves one site and calls
    `row(coverages, total, tail)` for each row it writes: the
    coverages, their frequencies over `total`, and `tail`, the columns
    after the coverages. Returns summary stats
    {allele: [n2,n3,n4,n5], core_cov, core_num}."""
    os.makedirs(outdir, exist_ok=True)
    allele = [0, 0, 0, 0]
    core_cov = 0
    core_num = 0
    with contextlib.ExitStack() as stack:
        files = [
            stack.enter_context(open(os.path.join(outdir, outpre + name), "w"))
            for name in _TABLES
        ]
        allfre, s_var = files[0], files[9]
        fre_files = dict(zip(range(2, 6), files[1:5]))
        cov_files = dict(zip(range(2, 6), files[5:9]))

        def row(covs: list[float], total: float, tail: str):
            fre_info = "".join(cpp_double(c / total) + "\n" for c in covs)
            allfre.write(fre_info)
            n = len(covs)
            if 2 <= n <= 5:
                allele[n - 2] += 1
                fre_files[n].write(fre_info)
                cov_files[n].write("".join(cpp_double(c) + "\t" for c in covs) + tail)

        for be in emissions:
            for aligned in be.aligned_rows:
                s_var.write(
                    f"{be.var_id}\t{1 if be.is_simple else 0}\t"
                    f"{be.entrance_id}\t{be.exit_id}\t{aligned}\n"
                )
            core_cov += int(be.core_cov)
            core_num += 1
            for site in be.sites:
                site_rows(site, row)
    return {"allele": allele, "core_cov": core_cov, "core_num": core_num}


def write_outputs(
    emissions: list[BubbleEmission],
    window_cov: dict[str, tuple[float, bool]],
    outpre: str,
    outdir: str = "PloidyFrost_output",
) -> dict:
    """The tables of one sample (`write_tables`): a row a site.

    window_cov: window string -> (mean cov, within-bounds flag), from
    window_coverage. A branching site whose window lies out of bounds
    writes no row."""

    def site_rows(site: SiteEmission, row):
        tail = (
            f"{1 if site.is_simple else 0}\t{site.var_type_indel_len}\t"
            f"{site.var_id}\t{site.var_num}\t{site.var_dis}\t\n"
        )
        if site.group_cov is not None:
            row(site.group_cov, site.sum_cov, tail)
            return
        temp_cov = []
        total = 0.0  # left to right, as the reference adds
        for grp in site.group_windows:
            c = 0.0
            for w in grp:
                mean, inb = window_cov[w]
                if not inb:
                    return
                c += mean
            temp_cov.append(c)
            total += c
        row(temp_cov, total, tail)

    return write_tables(emissions, site_rows, outpre, outdir)

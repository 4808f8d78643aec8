# Copied from ploidyfrost_tpu/graph/construct.py; imports point at this package, the device link step is torch.
"""Native compacted-DBG construction from a k-mer table.

Replaces Bifrost's build path (CompactedDBG::{filter,construct,
splitAllUnitigs,joinUnitigs}, bifrost/src/CompactedDBG.tcc:248-3320) with
a bulk-synchronous, fully vectorized design — no Bloom filters, no
locks, no hash walks:

  1. the distinct canonical k-mer set IS the node set (exact counting
     replaces the reference's blocked-Bloom approximate membership —
     no false-positive cleanup pass needed);
  2. per-node out-degrees in both orientations come from 8 batched
     membership probes (4 bases x 2 strands) against the sorted table —
     device `searchsorted` gathers;
  3. a k-mer links forward to its unique successor iff
     outdeg(x,o) == 1 and indeg(y,o') == 1 (the unitig-interior rule,
     CompactedDBG.tcc construct/joinUnitigs semantics);
  4. maximal chains are extracted with pointer-doubling list ranking
     (O(log n) gathers) instead of sequential walks;
  5. each unitig appears once per direction; the duplicate is dropped by
     head/tail node-id comparison. Orientation + ordering are made
     deterministic (lexicographic), so construction is reproducible and
     mesh-shape-invariant (unlike Bifrost's thread-order-dependent
     insertion ids).

Optional `simplify` mirrors Bifrost `-i -d` (clip short tips / delete
short isolated unitigs, bifrost/src/CompactedDBG.tcc:745-770) by
removing the affected k-mers and recompacting.
"""

from __future__ import annotations

import numpy as np

from ..kmer.pack import decode_kmers
from ..util.profiling import span
from .cdbg import CDBGraph, revcomp


def _revcomp_np(kmers: np.ndarray, k: int) -> np.ndarray:
    if len(kmers) > (1 << 20):
        from ..native import load_construct_library

        lib = load_construct_library()
        if lib is not None:
            import ctypes

            src = np.ascontiguousarray(kmers, dtype=np.uint64)
            out = np.empty_like(src)
            p = ctypes.POINTER(ctypes.c_uint64)
            lib.pf_revcomp(
                src.ctypes.data_as(p), ctypes.c_int64(len(src)),
                ctypes.c_int32(k), out.ctypes.data_as(p),
            )
            return out
    x = (~kmers).astype(np.uint64)
    for shift, mask in (
        (2, 0x3333333333333333),
        (4, 0x0F0F0F0F0F0F0F0F),
        (8, 0x00FF00FF00FF00FF),
        (16, 0x0000FFFF0000FFFF),
    ):
        m = np.uint64(mask)
        s = np.uint64(shift)
        x = ((x >> s) & m) | ((x & m) << s)
    x = (x >> np.uint64(32)) | (x << np.uint64(32))
    return x >> np.uint64(64 - 2 * k)


def _canon_np(kmers: np.ndarray, k: int) -> np.ndarray:
    return np.minimum(kmers, _revcomp_np(kmers, k))


def _member(sorted_kmers: np.ndarray, queries: np.ndarray) -> np.ndarray:
    idx = np.searchsorted(sorted_kmers, queries)
    idx = np.clip(idx, 0, len(sorted_kmers) - 1)
    return sorted_kmers[idx] == queries, idx


def _links_probes(km: np.ndarray, rc: np.ndarray, k: int) -> np.ndarray:
    """Unitig-interior links via 16 membership probes (the original
    design; kept as the oracle for the junction-sort fast path and as
    the exact fallback for palindromic-junction stubs).

    Returns nxt_node int64[2n]: node = 2*i + o (o=0 canonical
    orientation, o=1 revcomp); -1 = no unique link."""
    n = len(km)
    mask = np.uint64((1 << (2 * k)) - 1)
    succ_idx = np.full((2, 4, n), -1, dtype=np.int64)  # index of next canon
    succ_flip = np.zeros((2, 4, n), dtype=bool)  # next is stored as rc
    outdeg = np.zeros((2, n), dtype=np.int8)
    for o, base_km in ((0, km), (1, rc)):
        for b in range(4):
            nxt = ((base_km << np.uint64(2)) | np.uint64(b)) & mask
            nxt_rc = _revcomp_np(nxt, k)
            nxt_canon = np.minimum(nxt, nxt_rc)
            present, idx = _member(km, nxt_canon)
            succ_idx[o, b] = np.where(present, idx, -1)
            succ_flip[o, b] = nxt != nxt_canon  # arriving in rc orientation
            outdeg[o] += present.astype(np.int8)

    # link (i,o) -> (j,o') iff outdeg[o,i]==1 and indeg(j,o')==1,
    # where indeg(j, o') == outdeg[1-o', j] (predecessors of one side are
    # the successors of the twin side, NeighborIterator semantics)
    nxt_node = np.full(2 * n, -1, dtype=np.int64)
    for o in range(2):
        uniq = outdeg[o] == 1
        j = np.where(
            uniq,
            np.max(np.where(succ_idx[o] >= 0, succ_idx[o], -1), axis=0),
            -1,
        )
        flip = np.zeros(n, dtype=bool)
        for b in range(4):
            sel = uniq & (succ_idx[o, b] >= 0)
            flip[sel] = succ_flip[o, b][sel]
        o2 = flip.astype(np.int64)  # arriving orientation bit
        ok = uniq & (j >= 0)
        jj = np.where(ok, j, 0)
        indeg_ok = outdeg[1 - o2, jj] == 1
        # no self-loop links (k-mer following itself)
        not_self = jj != np.arange(n)
        ok = ok & indeg_ok & not_self
        nxt_node[2 * np.arange(n) + o] = np.where(ok, 2 * j + o2, -1)

    # drop links whose reverse direction disagrees (safety for palindromic
    # edge cases): link a->b must have twin(b)->twin(a)
    a = np.arange(2 * n)
    b = nxt_node
    has = b >= 0
    back = np.where(has, nxt_node[np.where(has, b, 0) ^ 1], -1)
    ok = has & (back == (a ^ 1))
    return np.where(ok, nxt_node, -1)


def _probe_unique_succ(km, rc, k, nodes):
    """Per packed node (idx*2+o): out-degree and the (last-present)
    successor as a packed node — the subset form of _links_probes'
    per-orientation probe loop."""
    mask = np.uint64((1 << (2 * k)) - 1)
    base = np.where((nodes & 1) == 1, rc[nodes >> 1], km[nodes >> 1])
    deg = np.zeros(len(nodes), dtype=np.int64)
    succ_packed = np.full(len(nodes), -1, dtype=np.int64)
    for b in range(4):
        nxt = ((base << np.uint64(2)) | np.uint64(b)) & mask
        nxt_rc = _revcomp_np(nxt, k)
        nxt_canon = np.minimum(nxt, nxt_rc)
        present, idx = _member(km, nxt_canon)
        deg += present
        cand = idx * 2 + (nxt != nxt_canon)
        succ_packed = np.where(present, cand, succ_packed)
    return deg, succ_packed


def _probe_rule(km, rc, k, nodes):
    """Tentative link of each packed node under the probe rule
    (outdeg==1, indeg==1, not-self) — before back-link filtering."""
    if len(nodes) == 0:
        return np.full(0, -1, dtype=np.int64)
    deg, succ = _probe_unique_succ(km, rc, k, nodes)
    tw = np.where(succ >= 0, succ ^ 1, 0)
    deg2, _ = _probe_unique_succ(km, rc, k, tw)
    ok = (
        (deg == 1)
        & (succ >= 0)
        & (deg2 == 1)
        & ((succ >> 1) != (nodes >> 1))
    )
    return np.where(ok, succ, -1)


def _links_probes_subset(km, rc, k, req):
    """Probe-rule links (incl. the back-link consistency filter) for
    just the requested packed nodes — O(|req|) probes instead of the
    16 full-table passes of _links_probes. Used for palindromic-
    junction stubs (a handful per genome); equivalence with the full
    pass is asserted by tests/test_construct.py."""
    req = np.asarray(req, dtype=np.int64)
    if len(req) == 0:
        return req.copy()
    t1 = _probe_rule(km, rc, k, req)
    has = t1 >= 0
    q = t1[has] ^ 1
    uq = np.unique(q)
    tq = _probe_rule(km, rc, k, uq)
    back = tq[np.searchsorted(uq, q)] if len(uq) else q
    okb = back == (req[has] ^ 1)
    out = np.full(len(req), -1, dtype=np.int64)
    idxs = np.flatnonzero(has)
    out[idxs[okb]] = t1[has][okb]
    return out


def _links_junctions(km: np.ndarray, rc: np.ndarray, k: int) -> np.ndarray:
    """Unitig-interior links via ONE sort over (k-1)-mer junctions.

    Every (k-mer, orientation) drops one out-stub at the canonical form
    of its (k-1)-suffix. A traversal edge v_o -> w_o' exists iff
    suffix(v_o) == prefix(w_o'), i.e. the two out-stubs (v, o) and
    (w, 1-o') meet at the same junction with opposite polarity (polarity
    = whether the suffix equals the canonical junction form). The
    reference's unitig-interior rule (outdeg==1 and indeg==1,
    bifrost CompactedDBG construct/join semantics) becomes: the junction
    has EXACTLY one stub of each polarity. Those runs link their two
    stubs mutually — back-link consistency is automatic.

    Palindromic junctions (suffix == its own revcomp; possible since
    k-1 is even) make polarity meaningless; stubs in such runs — a
    handful per genome — are resolved with the exact probe logic.

    Equivalence with _links_probes is asserted by
    tests/test_construct.py on random k-mer sets."""
    n = len(km)
    mask_j = np.uint64((1 << (2 * (k - 1))) - 1)
    # out-stub suffix per node (2i + o): o=0 canonical value, o=1 revcomp
    suf = np.empty(2 * n, dtype=np.uint64)
    suf[0::2] = km & mask_j
    suf[1::2] = rc & mask_j
    suf_rc = _revcomp_np(suf, k - 1)
    jc = np.minimum(suf, suf_rc)
    pol = suf == jc
    pal = suf == suf_rc

    order = np.argsort(jc, kind="stable")
    js = jc[order]
    run_start = np.empty(len(js), dtype=bool)
    run_start[0] = True
    run_start[1:] = js[1:] != js[:-1]
    run_id = np.cumsum(run_start) - 1
    n_runs = int(run_id[-1]) + 1 if len(js) else 0
    pol_o = pol[order]
    pal_o = pal[order]
    nf = np.bincount(run_id[pol_o], minlength=n_runs)
    nr = np.bincount(run_id[~pol_o], minlength=n_runs)
    has_pal = np.zeros(n_runs, dtype=bool)
    np.logical_or.at(has_pal, run_id, pal_o)

    nxt_node = np.full(2 * n, -1, dtype=np.int64)
    linkable = (nf == 1) & (nr == 1) & ~has_pal
    if linkable.any():
        starts = np.flatnonzero(run_start)
        s2 = starts[linkable]  # runs of exactly two stubs
        a_pos = np.where(pol_o[s2], s2, s2 + 1)  # the polarity-1 stub
        b_pos = np.where(pol_o[s2], s2 + 1, s2)
        a_node = order[a_pos]
        b_node = order[b_pos]
        ok = (a_node >> 1) != (b_node >> 1)  # not_self
        a_node, b_node = a_node[ok], b_node[ok]
        nxt_node[a_node] = b_node ^ 1
        nxt_node[b_node] = a_node ^ 1

    if has_pal.any():
        run_pal = has_pal[run_id]
        _apply_pal_fallback(km, rc, k, nxt_node, order[run_pal])
    return nxt_node


def _apply_pal_fallback(km, rc, k, nxt_node, pal_nodes):
    """Exact local resolution of palindromic-junction stubs: recompute
    the out-links of just those nodes with the probe rule, then
    overwrite their partners' mutual links to match — subset probes
    only (the round-3 fix for the 16-full-pass _links_probes fallback
    that dominated large builds)."""
    sub = _links_probes_subset(km, rc, k, pal_nodes)
    nxt_node[pal_nodes] = sub
    # mutual consistency: a->b requires twin(b)->twin(a)
    tgt = sub[sub >= 0]
    t2 = np.unique(tgt ^ 1)
    nxt_node[t2] = _links_probes_subset(km, rc, k, t2)


def _rank_chains(nxt_node: np.ndarray):
    """List-rank the link chains: returns (order, run boundaries) where
    `order` lists node ids grouped by chain in walk order.

    Pointer jumping with active-set compaction: each node chases its
    predecessor pointer, doubling the stride every round but dropping
    out as soon as it resolves its head — total work O(n log L_avg)
    instead of O(n log L_max)."""
    N = len(nxt_node)
    a = np.arange(N, dtype=np.int64)
    prev = np.full(N, -1, dtype=np.int64)
    valid_to = nxt_node[nxt_node >= 0]
    prev[valid_to] = a[nxt_node >= 0]

    is_head = prev < 0
    headof = np.where(is_head, a, -1)
    pos = np.zeros(N, dtype=np.int64)
    jump = prev.copy()
    active = np.flatnonzero(~is_head)
    pos[active] = 1
    for _ in range(64):
        if len(active) == 0:
            break
        j = jump[active]
        done = is_head[j]
        fin = active[done]
        headof[fin] = j[done]
        active = active[~done]
        if len(active) == 0:
            break
        j = j[~done]
        pos[active] += pos[j]
        jump[active] = jump[j]
    if len(active):
        # cycles: no head reachable. Break each at its minimum node id.
        cyc = np.zeros(N, dtype=bool)
        cyc[active] = True
        mn = a.copy()
        jp = prev.copy()
        for _ in range(64):
            act = cyc & (jp >= 0)
            if not act.any():
                break
            ji = np.where(act, jp, 0)
            mn = np.where(act, np.minimum(mn, mn[ji]), mn)
            jp = np.where(act, jp[ji], jp)
        headof = np.where(cyc, mn, headof)
        cyc_heads = np.unique(headof[cyc])
        pr = prev[cyc_heads]
        nxt_node[pr[pr >= 0]] = -1
        prev[cyc_heads] = -1
        for h in cyc_heads:
            p = 0
            node = h
            while True:
                pos[node] = p
                node = nxt_node[node]
                p += 1
                if node < 0 or node == h:
                    break
    # single fused sort key (headof < 2n < 2^32, pos < n): ~3x cheaper
    # than np.lexsort's two passes
    key = (headof.astype(np.uint64) << np.uint64(32)) | pos.astype(np.uint64)
    return np.argsort(key, kind="stable"), headof


def _links_junctions_fast(
    km: np.ndarray, rc: np.ndarray, k: int
) -> np.ndarray:
    """_links_junctions via the native radix-sort kernel
    (native/construct_kernels.cpp) when available; identical semantics
    including the palindromic-junction probe fallback."""
    from ..native import load_construct_library

    lib = load_construct_library()
    n = len(km)
    # the native kernel packs node ids into 30 bits (u32 payload radix
    # sort); beyond ~500 Mbp of distinct k-mers use the numpy path
    if lib is None or 2 * n >= (1 << 30):
        return _links_junctions(km, rc, k)
    import ctypes

    nxt = np.full(2 * n, -1, dtype=np.int64)
    pal = np.zeros(2 * n, dtype=np.uint8)

    def u64p(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))

    lib.pf_link_junctions(
        u64p(np.ascontiguousarray(km)),
        u64p(np.ascontiguousarray(rc)),
        ctypes.c_int64(n),
        ctypes.c_int32(k),
        nxt.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        pal.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    if pal.any():
        _apply_pal_fallback(km, rc, k, nxt, np.flatnonzero(pal))
    return nxt


def device_link_step(jc, pol, pal):
    """Core of the device linking path on tensors of one device: a
    stable sort of the 2n junction keys `jc` (int64), pair detection
    with shifted comparisons, and a scatter back to node order.

    pol[i]: stub i's junction is in its canonical orientation; pal[i]:
    the junction is its own reverse complement. Returns nxt [2n] int64:
    the partner node of every stub, -1 where the junction's run is not
    exactly one stub of each polarity (or holds a palindrome, or pairs
    a k-mer with itself)."""
    import torch

    N = jc.shape[0]
    js, idx_o = torch.sort(jc, stable=True)
    pol_o = pol[idx_o]
    pal_o = pal[idx_o]
    # the rolls wrap around at the ends; first/nxt1/nxt2 are set at the
    # ends so that no wrapped value is ever used
    first = torch.ones(N, dtype=torch.bool, device=jc.device)
    first[1:] = js[1:] != js[:-1]
    nxt1 = torch.ones_like(first)
    nxt1[:-1] = first[1:]
    nxt2 = torch.ones_like(first)
    nxt2[:-2] = first[2:]
    pol_n = torch.roll(pol_o, -1)
    pal_n = torch.roll(pal_o, -1)
    idx_n = torch.roll(idx_o, -1)
    pair_start = (
        first
        & ~nxt1
        & nxt2
        & (pol_o != pol_n)
        & ~pal_o
        & ~pal_n
        & ((idx_o >> 1) != (idx_n >> 1))  # not_self
    )
    pair_second = torch.zeros_like(first)
    pair_second[1:] = pair_start[:-1]
    val = torch.where(
        pair_start,
        idx_n ^ 1,
        torch.where(pair_second, torch.roll(idx_o, 1) ^ 1, -1),
    )
    # back to node order: idx_o is a permutation, so this is a scatter
    nxt = torch.empty_like(val)
    nxt[idx_o] = val
    return nxt


def _links_junctions_device(
    km: np.ndarray, rc: np.ndarray, k: int, device
) -> np.ndarray:
    """_links_junctions with the junction keys, their sort and the pair
    detection on `device` (the `--device-build` path): identical
    semantics, the same junction keys, the same exactly-one-stub-per-
    polarity pairing, the same palindromic-probe fallback on the host.
    Junction keys are (k-1)-mers, below 2^60 for k <= 31, so they are
    int64 on the device."""
    import torch

    from ..kmer.pack import revcomp_kmers

    n = len(km)
    if n == 0:
        return np.full(0, -1, dtype=np.int64)
    dev = torch.device(device)
    mask_j = (1 << (2 * (k - 1))) - 1
    both = np.stack(
        [np.ascontiguousarray(km, dtype=np.uint64), np.ascontiguousarray(rc, dtype=np.uint64)],
        axis=1,
    )
    # [n, 2] row-major = stubs interleaved: node 2i is km[i], 2i+1 rc[i]
    suf = torch.from_numpy(both.view(np.int64)).to(dev).reshape(-1) & mask_j
    suf_rc = revcomp_kmers(suf, k - 1)
    jc = torch.minimum(suf, suf_rc)
    pal = suf == suf_rc
    nxt_node = device_link_step(jc, suf == jc, pal).cpu().numpy()
    if bool(pal.any()):
        # every stub of a run that holds a palindrome goes to the probes
        pal_nodes = torch.isin(jc, jc[pal]).nonzero().reshape(-1).cpu().numpy()
        _apply_pal_fallback(km, rc, k, nxt_node, pal_nodes)
    return nxt_node


def _rank_chains_fast(nxt_node: np.ndarray):
    """(order, chain_start) via the native O(n) walk
    (native/chain_rank.cpp) when available, else the numpy
    pointer-doubling path. Chain ORDER may differ between the two —
    assembly is chain-order-independent (the final unitig order is the
    separate lexicographic sort) — grouping and walk order are
    identical (tests/test_construct.py cross-checks)."""
    from ..native import load_chain_library

    lib = load_chain_library()
    if lib is not None and len(nxt_node):
        import ctypes

        n2 = len(nxt_node)
        nxt = np.ascontiguousarray(nxt_node, dtype=np.int64)
        order = np.empty(n2, dtype=np.int64)
        chain_start = np.zeros(n2, dtype=np.uint8)
        lib.pf_chain_rank(
            nxt.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            ctypes.c_int64(n2),
            order.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            chain_start.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        )
        return order, chain_start.astype(bool)
    order, headof = _rank_chains(nxt_node)
    sorted_heads = headof[order]
    chain_start = np.concatenate(
        [[True], sorted_heads[1:] != sorted_heads[:-1]]
    )
    return order, chain_start


def build_graph_from_kmers(
    kmers: np.ndarray, k: int, link_device=None
) -> CDBGraph:
    """Compact a sorted distinct canonical k-mer set into unitigs.
    `link_device` (a torch.device) moves the junction sort of the link
    step there (_links_junctions_device); None keeps it in the native
    host kernel. The graph is the same either way. Spans: `link` (the
    reverse complements, links and chain ranks) and `assemble`."""
    km = np.asarray(kmers, dtype=np.uint64)
    n = len(km)
    if n == 0:
        return CDBGraph([], k)
    with span("link"):
        rc = _revcomp_np(km, k)
        if link_device is not None:
            nxt_node = _links_junctions_device(km, rc, k, link_device)
        else:
            nxt_node = _links_junctions_fast(km, rc, k)
        order, chain_start = _rank_chains_fast(nxt_node)
    with span("assemble"):
        return _assemble(km, rc, k, order, chain_start)


def _assemble(km, rc, k: int, order, chain_start) -> CDBGraph:
    """The ranked chains as unitigs: decoded, packed, each in its
    canonical orientation, in lexicographic order."""
    starts = np.flatnonzero(chain_start)
    ends = np.append(starts[1:], len(order))

    # ---- decode chains -> packed unitig codes, fully vectorized --------
    # twin chain's head is twin(tail); keep the decisive copy:
    # keep iff head <= twin(tail)
    head_nodes = order[starts]
    tail_nodes = order[ends - 1]
    keep = head_nodes <= (tail_nodes ^ 1)
    kstarts = starts[keep]
    kends = ends[keep]
    m = kends - kstarts  # nodes per kept chain
    nc = len(kstarts)
    if nc == 0:
        return CDBGraph([], k)
    lengths = k + m - 1  # unitig base length

    from ..native import load_construct_library

    lib = load_construct_library()
    if lib is not None:
        # native assembly: decode + canonicalize + pack in one C pass
        import ctypes

        from .seqstore import SeqStore

        nwords = (lengths + 31) // 32
        off_w = np.zeros(nc + 1, dtype=np.int64)
        np.cumsum(nwords, out=off_w[1:])
        words = np.zeros(int(off_w[-1]), dtype=np.uint64)

        def i64p(a):
            return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))

        def u64p(a):
            return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))

        lib.pf_assemble_unitigs(
            i64p(np.ascontiguousarray(order)),
            i64p(np.ascontiguousarray(kstarts)),
            i64p(np.ascontiguousarray(kends)),
            ctypes.c_int64(nc),
            u64p(np.ascontiguousarray(km)),
            u64p(np.ascontiguousarray(rc)),
            ctypes.c_int32(k),
            u64p(words),
            i64p(off_w),
        )
        store = SeqStore(words, off_w, lengths)
        return CDBGraph(store.reorder(_lex_perm(store)), k)
    off_b = np.zeros(nc + 1, dtype=np.int64)
    np.cumsum(lengths, out=off_b[1:])
    codes = np.empty(int(off_b[-1]), dtype=np.uint8)
    # oriented value of every chain node (o==0: canonical form, o==1: rc)
    onodes = order  # all nodes in chain order
    oriented_all = np.where((onodes & 1) == 0, km[onodes >> 1], rc[onodes >> 1])
    # first k-mer of each kept chain -> k leading codes (MSB-first)
    firsts = oriented_all[kstarts]
    for t in range(k):
        codes[off_b[:-1] + t] = (
            (firsts >> np.uint64(2 * (k - 1 - t))) & np.uint64(3)
        ).astype(np.uint8)
    # every subsequent node contributes its last base
    if int(m.max()) > 1:
        chain_of = np.repeat(np.arange(nc), m)
        gpos = (
            np.arange(int(m.sum()), dtype=np.int64)
            - np.repeat(np.cumsum(m) - m, m)
        )  # position within chain
        # global chain-order index of each kept-chain node
        src = np.repeat(kstarts, m) + gpos
        non_first = gpos > 0
        tgt = off_b[chain_of[non_first]] + k + gpos[non_first] - 1
        codes[tgt] = (oriented_all[src[non_first]] & np.uint64(3)).astype(np.uint8)

    # ---- canonical form: min(seq, revcomp) per unitig, vectorized ------
    P = int(off_b[-1])
    seg = np.repeat(np.arange(nc), lengths)
    gstart = off_b[seg]
    gend = off_b[seg + 1]
    p = np.arange(P, dtype=np.int64)
    rc_codes = (3 - codes[gstart + gend - 1 - p]).astype(np.uint8)
    diff = codes != rc_codes
    dpos = np.where(diff, p, P)
    firstdiff = np.minimum.reduceat(dpos, off_b[:-1])
    fd = np.minimum(firstdiff, P - 1)
    take_rc = (firstdiff < P) & (rc_codes[fd] < codes[fd])
    codes = np.where(take_rc[seg], rc_codes, codes)

    from .seqstore import SeqStore

    store = SeqStore.from_codes(codes, lengths)
    return CDBGraph(store.reorder(_lex_perm(store)), k)


def _lex_perm(store) -> np.ndarray:
    """Deterministic unitig order: lexicographic over the decoded
    corpus — computed on the PACKED words (three 32-base MSB-first u64
    keys + length), not by decoding strings and sorting in Python.

    'A'-padding inside a partial key word plus the ascending-length
    tie-break reproduces string prefix ordering exactly for any pair
    decided within 96 bases; the rare pairs still tied there (both
    > 96 bases, identical 96-prefix) are resolved by decoding just
    those groups."""
    from .seqstore import _reverse_2bit_groups

    n = len(store)
    nw = (store.lengths + 31) // 32
    w0 = store.off_w[:-1]
    keys = []
    for t in range(3):
        idx = np.minimum(w0 + t, len(store.words) - 1) if len(store.words) else w0
        w = np.where(nw > t, store.words[idx], np.uint64(0)) if len(
            store.words
        ) else np.zeros(n, np.uint64)
        keys.append(_reverse_2bit_groups(np.ascontiguousarray(w)))
    perm = np.lexsort((store.lengths, keys[2], keys[1], keys[0]))
    k0, k1, k2 = (k[perm] for k in keys)
    ls = store.lengths[perm]
    tied = (
        (k0[1:] == k0[:-1])
        & (k1[1:] == k1[:-1])
        & (k2[1:] == k2[:-1])
        & (ls[1:] > 96)
        & (ls[:-1] > 96)
    )
    if tied.any():
        # resolve >96-base ties by decoding just those runs
        bounds = np.flatnonzero(
            np.diff(np.concatenate([[False], tied, [False]]).astype(np.int8))
        ).reshape(-1, 2)
        for a, b in bounds:
            grp = perm[a : b + 1]
            strs = [store.decode(int(i)) for i in grp]
            perm[a : b + 1] = grp[
                np.array(sorted(range(len(grp)), key=strs.__getitem__))
            ]
    return perm


def _stub_links(
    suf0: np.ndarray, suf1: np.ndarray, kj: int, affected_jc: np.ndarray
):
    """Junction-run linking over UNITIG-END stubs: the unitig-level
    twin of _links_junctions (a whole unitig behaves exactly like one
    k-mer whose two oriented suffixes are its end (k-1)-mers).

    Only junctions in `affected_jc` (sorted canonical junction keys
    that LOST a stub to the drop) may change state — every other
    junction keeps its original build-time resolution, so pal stubs,
    self-pairs, or apparent 1-1 runs there are left strictly alone.
    Returns (nxt_node over packed 2i+o nodes, bail-reason-or-None);
    bailing falls back to the full recompaction: an AFFECTED junction
    with a palindromic stub needs the k-mer-level probes, an affected
    self-join closes a circular unitig the rebuild would re-rotate."""
    m = len(suf0)
    suf = np.empty(2 * m, dtype=np.uint64)
    suf[0::2] = suf0
    suf[1::2] = suf1
    suf_rc = _revcomp_np(suf, kj)
    jc = np.minimum(suf, suf_rc)
    pol = suf == jc
    pal = suf == suf_rc

    order = np.argsort(jc, kind="stable")
    js = jc[order]
    run_start = np.empty(len(js), dtype=bool)
    if len(js):
        run_start[0] = True
        run_start[1:] = js[1:] != js[:-1]
    run_id = np.cumsum(run_start) - 1
    n_runs = int(run_id[-1]) + 1 if len(js) else 0
    starts = np.flatnonzero(run_start)
    pol_o = pol[order]
    pal_o = pal[order]
    nf = np.bincount(run_id[pol_o], minlength=n_runs)
    nr = np.bincount(run_id[~pol_o], minlength=n_runs)
    pos = np.searchsorted(affected_jc, js[starts])
    pos = np.clip(pos, 0, max(len(affected_jc) - 1, 0))
    affected = (
        affected_jc[pos] == js[starts]
        if len(affected_jc)
        else np.zeros(n_runs, dtype=bool)
    )
    linkable = (nf == 1) & (nr == 1) & affected

    nxt = np.full(2 * m, -1, dtype=np.int64)
    if pal_o.any():
        pal_runs = np.zeros(n_runs, dtype=bool)
        np.logical_or.at(pal_runs, run_id, pal_o)
        if (pal_runs & affected & (nf + nr >= 2)).any():
            return nxt, "palindromic stub in an affected junction"
        linkable &= ~pal_runs
    if linkable.any():
        s2 = starts[linkable]
        a_pos = np.where(pol_o[s2], s2, s2 + 1)
        b_pos = np.where(pol_o[s2], s2 + 1, s2)
        a_node = order[a_pos]
        b_node = order[b_pos]
        if ((a_node >> 1) == (b_node >> 1)).any():
            return nxt, "self-join (circular unitig)"
        nxt[a_node] = b_node ^ 1
        nxt[b_node] = a_node ^ 1
    return nxt, None


def _log_simplify_bail(reason: str) -> None:
    import sys

    print(f"simplify: unitig-level fast path bailed ({reason}); "
          "recompacting the k-mer set", file=sys.stderr, flush=True)


def _simplify_fast(g: CDBGraph, k: int, drop: np.ndarray):
    """Drop the marked unitigs and re-join at the (few) junctions their
    removal opened — O(#unitigs) instead of a full recompaction of the
    k-mer set. Returns None on the edge cases the unitig-level view
    cannot resolve (see _stub_links); tests/test_construct.py asserts
    equivalence with the full rebuild on random graphs."""
    kept = np.flatnonzero(~drop)
    store = g.store
    if len(kept) == 0:
        return CDBGraph([], k)
    mask_j = np.uint64((1 << (2 * (k - 1))) - 1)
    head_all = store.head_kmers(k)
    tail_all = store.tail_kmers(k)
    head = head_all[kept]
    tail = tail_all[kept]
    suf0 = tail & mask_j
    suf1 = _revcomp_np(head, k) & mask_j
    # junctions that LOSE a stub: the dropped unitigs' end junctions
    dropped = np.flatnonzero(drop)
    dsuf = np.concatenate(
        [
            tail_all[dropped] & mask_j,
            _revcomp_np(head_all[dropped], k) & mask_j,
        ]
    )
    affected_jc = np.unique(np.minimum(dsuf, _revcomp_np(dsuf, k - 1)))
    nxt, bail = _stub_links(suf0, suf1, k - 1, affected_jc)
    if bail is not None:
        _log_simplify_bail(bail)
        return None
    if not (nxt >= 0).any():
        # pure drop: a subset of a lex-sorted store stays lex-sorted
        return CDBGraph(store.reorder(kept), k)
    nxt_orig = nxt.copy()
    order, headof = _rank_chains(nxt)
    sorted_heads = headof[order]
    chain_start = np.concatenate([[True], sorted_heads[1:] != sorted_heads[:-1]])
    starts = np.flatnonzero(chain_start)
    ends = np.append(starts[1:], len(order))
    if (nxt_orig[order[ends - 1]] >= 0).any():
        _log_simplify_bail("join closed a cycle")
        return None
    head_nodes = order[starts]
    tail_nodes = order[ends - 1]
    keep_chain = head_nodes <= (tail_nodes ^ 1)
    untouched: list[int] = []
    merged: list[str] = []
    for s, e in zip(starts[keep_chain], ends[keep_chain]):
        if e - s == 1:
            untouched.append(int(order[s]) >> 1)
            continue
        parts = []
        for node in order[s:e]:
            u = kept[int(node) >> 1]
            seq = store.decode(int(u))
            if int(node) & 1:
                seq = revcomp(seq)
            parts.append(seq if not parts else seq[k - 1 :])
        seq = "".join(parts)
        r = revcomp(seq)
        merged.append(min(seq, r))
    from .seqstore import SeqStore

    sub = store.reorder(kept[np.array(untouched, dtype=np.int64)])
    if merged:
        add = SeqStore.from_strings(merged)
        combined = SeqStore(
            np.concatenate([sub.words, add.words]),
            np.concatenate([sub.off_w, sub.off_w[-1] + add.off_w[1:]]),
            np.concatenate([sub.lengths, add.lengths]),
        )
    else:
        combined = sub
    return CDBGraph(combined.reorder(_lex_perm(combined)), k)


def simplify(g: CDBGraph, k: int) -> CDBGraph:
    """Bifrost `-i -d`: delete short isolated unitigs and clip short
    tips (< 2k bases), then re-join what the removal opened
    (CompactedDBG.tcc:745-770). The unitig-level fast path touches only
    the affected junction stubs; its (rare) unresolvable cases fall
    back to a full recompaction of the surviving k-mer set — the two
    are equivalent by construction (maximal chains of the same k-mer
    set) and cross-checked in tests/test_construct.py. An `assemble`
    span (the fallback's construction has its own spans)."""
    with span("assemble"):
        lens = g.store.lengths
        deg_fw = g._out_deg[:, 1]
        deg_bw = g._out_deg[:, 0]
        drop = (lens < 2 * k) & ((deg_fw == 0) | (deg_bw == 0))
        if not drop.any():
            return g
        fast = _simplify_fast(g, k, np.asarray(drop))
    if fast is not None:
        return fast
    return _simplify_rebuild(g, k, np.asarray(drop))


def _simplify_rebuild(g: CDBGraph, k: int, drop: np.ndarray) -> CDBGraph:
    """Full recompaction of the surviving k-mer set — the oracle the
    fast path is tested against, and the fallback for its bail cases."""
    with span("assemble"):
        flat, nk = g.store.all_kmers(k)
        seg = np.repeat(np.arange(len(nk)), nk)
        kept = flat[~drop[seg]]
        if len(kept) == 0:
            return CDBGraph([], k)
        allkm = np.unique(_canon_np(kept, k))
    return build_graph_from_kmers(allkm, k)


def build_graph_from_reads(
    paths, k: int, min_count: int = 1, device="cuda", link_device=None, group=None
):
    """Count reads (over `group`'s ranks when given), threshold,
    compact, simplify. Returns (graph, counter); over a group the graph
    is None on every rank but 0, which alone receives the table."""
    from ..io.fastx import read_batches
    from ..parallel.mesh import is_primary, make_counter

    counter = make_counter(k, device, group)
    for batch in read_batches(paths, k):
        counter.add_reads(batch)
    if not is_primary(group):
        counter.finalize()  # the reduction, and this rank's shard to rank 0
        return None, counter
    km, ct = counter.arrays()
    if min_count > 1:
        km = km[ct >= min_count]
    g = build_graph_from_kmers(km, k, link_device=link_device)
    g = simplify(g, k)
    return g, counter

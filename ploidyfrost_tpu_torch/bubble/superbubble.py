# Copied from ploidyfrost_tpu/bubble/superbubble.py; imports point at this package.
"""Superbubble detection (replaces src/CDBG.cpp:178-846 and MyUnitig).

Algorithm: Onodera-style superbubble search seeded at every
(unitig, strand) with out-degree > 1 — a DFS over the oriented graph
where a vertex is pushed only when all its predecessors are visited; the
bubble closes when exactly one frontier vertex remains and nothing else
is merely 'seen' (src/CDBG.cpp:253-372). Tips abort the bubble; cycles
mark every involved vertex non-super.

Per-unitig state replaces MyUnitig's bit flags + entrance/exit pointer
pairs (src/MyUnitig.hpp:18-129) with numpy arrays:

  flags  uint8 — same bit layout as MyUnitig::b:
      0x01 plus-pointer-set   (is_plus_visited()  == bit CLEAR)
      0x02 minus-pointer-set  (is_minus_visited() == bit CLEAR)
      0x04 non_super
      0x08 strict(minus)  0x10 strict(plus)
      0x20 complex(minus) 0x40 complex(plus)
  plus/minus int64 — -1 NULL, own index for 'self', else partner index.

Bubble ids are assigned deterministically in unitig-id order
(the reference single-thread numbering, src/CDBG.cpp:222-249; the
multithread variant's fetch_add ids are nondeterministic and start at 0,
src/CDBG.cpp:1829 — we standardize on the deterministic one).

Classification (setNoBubble_ptr, src/CDBG.cpp:700-846):
  strict ('simple')  — seen-set <= 6 and every interior unitig has the
      entrance as its only predecessor and the exit as its only successor
      (src/CDBG.cpp:765-788);
  complex — seen-set > complex_size (z, default 8) (src/CDBG.cpp:789-793).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..graph.cdbg import CDBGraph, UnitigHandle

NULL = -1


class BubbleState:
    """MyUnitig-equivalent per-unitig bubble annotation arrays."""

    def __init__(self, n: int):
        self.flags = np.zeros(n, dtype=np.uint8)
        self.plus = np.full(n, NULL, dtype=np.int64)
        self.minus = np.full(n, NULL, dtype=np.int64)

    # --- pointer ops (MyUnitig.hpp:27-59) ---
    def set_plus_self(self, i):
        self.plus[i] = i
        self.flags[i] &= 0xFE

    def set_minus_self(self, i):
        self.minus[i] = i
        self.flags[i] &= 0xFD

    def set_plus(self, i, p):
        self.plus[i] = p
        self.flags[i] |= 0x01

    def set_minus(self, i, p):
        self.minus[i] = p
        self.flags[i] |= 0x02

    def get_ptr(self, i, strand: bool) -> int:
        return int(self.plus[i] if strand else self.minus[i])

    def set_self(self, i, strand: bool):
        if strand:
            self.set_plus_self(i)
        else:
            self.set_minus_self(i)

    # mirror of the repeated "detach partner then self-link" block
    # (src/CDBG.cpp:554-585 et al.)
    def detach_and_self(self, i):
        for arr, setter in ((self.plus, True), (self.minus, False)):
            ex = int(arr[i])
            if ex != NULL and ex != i:
                if int(self.plus[ex]) == i:
                    self.set_plus_self(ex)
                else:
                    self.set_minus_self(ex)
            if setter:
                self.set_plus_self(i)
            else:
                self.set_minus_self(i)

    # --- flag ops ---
    def set_non_super(self, i):
        self.flags[i] |= 0x04

    def is_non_super(self, i) -> bool:
        return bool(self.flags[i] & 0x04)

    def set_strict(self, i, strand: bool):
        self.flags[i] |= 0x10 if strand else 0x08

    def is_strict(self, i, strand: bool) -> bool:
        return bool(self.flags[i] & (0x10 if strand else 0x08))

    def set_complex(self, i, strand: bool):
        self.flags[i] |= 0x40 if strand else 0x20

    def is_complex(self, i, strand: bool) -> bool:
        return bool(self.flags[i] & (0x40 if strand else 0x20))

    # --- visited semantics (inverted bits: pointer-set == NOT visited) ---
    def is_plus_visited(self, i) -> bool:
        return (self.flags[i] & 0x01) == 0

    def is_minus_visited(self, i) -> bool:
        return (self.flags[i] & 0x02) == 0

    def is_visited(self, i, strand: bool) -> bool:
        return self.is_plus_visited(i) if strand else self.is_minus_visited(i)

    def set_visited(self, i, strand: bool):
        if strand:
            self.flags[i] &= 0xFE
        else:
            self.flags[i] &= 0xFD

    def is_both_visited(self, i) -> bool:
        return (self.flags[i] & 0x03) == 0

    def bubble_exit(self, i, strand: bool) -> int:
        """get_bubble_id analog: partner unitig index (MyUnitig.hpp:93-96)."""
        return int(self.plus[i] if strand else self.minus[i])


@dataclass
class Bubble:
    bubble_id: int
    entrance: int  # unitig index
    strand: bool
    exit: int
    strict: bool
    complex: bool


def _set_no_bubble_all(state: BubbleState, vec_seen, p_first, p_second):
    """setNoBubble_ptr(vec, p) for tip/cycle-found-exit case
    (src/CDBG.cpp:603-699): everything non-super, endpoints self-linked."""
    pf, ps = p_first, p_second
    i = pf.idx
    if pf.strand:
        ex = int(state.plus[i])
        if ex != NULL:
            if int(state.plus[ex]) == i:
                state.set_plus_self(ex)
            else:
                state.set_minus_self(ex)
        state.set_plus_self(i)
    else:
        ex = int(state.minus[i])
        if ex != NULL:
            if int(state.plus[ex]) == i:
                state.set_plus_self(ex)
            else:
                state.set_minus_self(ex)
        state.set_minus_self(i)
    j = ps.idx
    if not ps.strand:
        ex = int(state.plus[j])
        if ex != NULL:
            if int(state.plus[ex]) == j:
                state.set_plus_self(ex)
            else:
                state.set_minus_self(ex)
        state.set_plus_self(j)
    else:
        ex = int(state.minus[j])
        if ex != NULL:
            if int(state.plus[ex]) == j:
                state.set_plus_self(ex)
            else:
                state.set_minus_self(ex)
        state.set_minus_self(j)
    for ucm in vec_seen:
        if ucm == pf or ucm == ps:
            continue
        state.detach_and_self(ucm.idx)
        state.set_non_super(ucm.idx)


def _set_no_bubble_cycle(state: BubbleState, vec_seen, p_first, p_second):
    """setNoBubble_ptr_cycle (src/CDBG.cpp:552-602)."""
    for ucm in vec_seen:
        state.detach_and_self(ucm.idx)
        state.set_non_super(ucm.idx)
    state.set_self(p_first.idx, p_first.strand)
    # exit: strand==false -> plus self, else minus self
    if not p_second.strand:
        state.set_plus_self(p_second.idx)
    else:
        state.set_minus_self(p_second.idx)


def _register_bubble(
    g: CDBGraph,
    state: BubbleState,
    vec_seen,
    p_first,
    p_second,
    complex_size: int,
    colors=None,
):
    """setNoBubble_ptr(p, vec) — the REAL-bubble registration
    (src/CDBG.cpp:700-846; colored variant src/CCDBG.cpp:2402-2660).

    When `colors` (a ColorMatrix) is given, the colored gates apply
    before the entrance<->exit link is installed:
      1. entrance fully colored by EVERY color (src/CCDBG.cpp:2531-2550);
      2. exit likewise — with the reference's size(p.first) argument
         quirk, observable only for nested full-color sets
         (src/CCDBG.cpp:2552-2571);
      3. color continuity: every color carried by a non-exit bubble
         unitig must be fully carried by at least one of its successors
         (src/CCDBG.cpp:2573-2621).
    """
    if len(vec_seen) < 4:
        return
    pf, ps = p_first, p_second
    if state.is_non_super(ps.idx) or state.is_non_super(pf.idx):
        for ucm in vec_seen:
            if ucm == pf:
                state.set_self(pf.idx, pf.strand)
                continue
            if ucm == ps:
                # note inverted strand handling vs the cycle variant
                if ps.strand:
                    state.set_minus_self(ps.idx)
                else:
                    state.set_plus_self(ps.idx)
                continue
            state.detach_and_self(ucm.idx)
            state.set_non_super(ucm.idx)
        return
    if len(vec_seen) <= 6:
        flag = True
        for ucm in vec_seen:
            if ucm == pf or ucm == ps:
                continue
            preds = ucm.predecessors()
            succs = ucm.successors()
            if (
                len(preds) == 1
                and preds[0].same_unitig(pf)
                and len(succs) == 1
                and succs[0].same_unitig(ps)
            ):
                continue
            flag = False
            break
        if flag:
            state.set_strict(pf.idx, pf.strand)
            state.set_strict(ps.idx, not ps.strand)
    if len(vec_seen) > complex_size:
        state.set_complex(pf.idx, pf.strand)
        state.set_complex(ps.idx, not ps.strand)
    for ucm in vec_seen:
        if ucm == pf or ucm == ps:
            continue
        state.detach_and_self(ucm.idx)
        state.set_non_super(ucm.idx)
    if colors is not None:
        C = colors.n_colors

        def endpoints_self():
            state.set_self(pf.idx, pf.strand)
            if not ps.strand:
                state.set_plus_self(ps.idx)
            else:
                state.set_minus_self(ps.idx)

        f = True
        if colors.size(pf.idx) != pf.length * C:
            f = False
            state.set_non_super(pf.idx)
            endpoints_self()
        if colors.size_as(ps.idx, pf.length) != ps.length * C:
            f = False
            state.set_non_super(ps.idx)
            endpoints_self()
        if f:
            required = {
                pf.idx: list(range(C)),
                ps.idx: list(range(C)),
            }
            for ucm in vec_seen:
                if ucm == ps:
                    continue
                if ucm.idx not in required:
                    required[ucm.idx] = [
                        i for i in range(C) if colors.contains_all(ucm.idx, i)
                    ]
                suc_color = set()
                for suc in ucm.successors():
                    for col in required[ucm.idx]:
                        if colors.contains_all(suc.idx, col):
                            suc_color.add(col)
                if len(suc_color) != len(required[ucm.idx]):
                    f = False
                    break
            if not f:
                endpoints_self()
        if not f:
            return
    if pf.strand:
        state.set_plus(pf.idx, ps.idx)
    else:
        state.set_minus(pf.idx, ps.idx)
    if ps.strand:
        state.set_minus(ps.idx, pf.idx)
    else:
        state.set_plus(ps.idx, pf.idx)


def extract_superbubble(
    g: CDBGraph, state: BubbleState, s: UnitigHandle, complex_size: int, colors=None
):
    """extractSuperBubble_ptr (src/CDBG.cpp:253-415)."""
    flag_cycle = False
    flag_tip = False
    vertices_visit: list[UnitigHandle] = []
    vec_km_seen: list[UnitigHandle] = []
    state_map: dict[int, int] = {}
    strand_map: dict[int, bool] = {}
    cycle_set: set[UnitigHandle] = set()
    # O(1) replacement for the reference's O(|seen|) "anything still
    # seen?" scan at every stack-size-1 event (src/CDBG.cpp:2744-2778
    # — quadratic in the DFS size, which is why the reference binary
    # wedges for the better part of an hour on flooding searches at the
    # 50 Mbp scale point): count2 tracks #{idx: state == 0x02}, and
    # vec_strand records each vec entry's ORIGINAL strand so the
    # handle-inequality `cucm != top` (strand included) stays exact.
    count2 = 0
    vec_strand: dict[int, bool] = {}
    v = s
    vertices_visit.append(v)
    vec_km_seen.append(v)
    vec_strand[s.idx] = s.strand
    while vertices_visit:
        v = vertices_visit.pop()
        if state_map.get(v.idx) == 0x02:
            count2 -= 1
        state_map[v.idx] = 0x01
        strand_map[v.idx] = v.strand
        succs = v.successors()
        if not succs:
            flag_tip = True
        else:
            for u in succs:
                if u == s:
                    flag_cycle = True
                    cycle_set.add(s)
                    cycle_set.add(v)
                    continue
                if state_map.get(u.idx) != 0x01:
                    if u.idx not in state_map:
                        vec_km_seen.append(u)
                        strand_map[u.idx] = u.strand
                        vec_strand[u.idx] = u.strand
                        count2 += 1
                    else:
                        if strand_map[u.idx] != u.strand:
                            flag_cycle = True
                            cycle_set.add(u)
                            cycle_set.add(v)
                    state_map[u.idx] = 0x02
                    all_pred_visited = True
                    for pred in u.predecessors():
                        if pred.idx in state_map:
                            if state_map[pred.idx] != 0x01:
                                all_pred_visited = False
                            if strand_map[pred.idx] != pred.strand:
                                flag_cycle = True
                                cycle_set.add(u)
                                cycle_set.add(pred)
                        else:
                            all_pred_visited = False
                    if all_pred_visited:
                        vertices_visit.append(u)
                else:
                    flag_cycle = True
                    cycle_set.add(v)
                    cycle_set.add(u)
        if len(vertices_visit) == 1:
            top = vertices_visit[0]
            top2 = (
                1
                if (
                    state_map.get(top.idx) == 0x02
                    and vec_strand.get(top.idx) == top.strand
                )
                else 0
            )
            # == the reference scan: exists cucm in vec_km_seen with
            # cucm != top (handle inequality) and state == 0x02
            not_seen = count2 == top2
            if not_seen:
                p_first = s
                p_second = vertices_visit[0]
                for succ in vertices_visit[0].successors():
                    if succ == s:
                        _set_no_bubble_cycle(state, vec_km_seen, p_first, p_second)
                        return
                if flag_cycle or flag_tip:
                    _set_no_bubble_all(state, vec_km_seen, p_first, p_second)
                    return
                _register_bubble(
                    g, state, vec_km_seen, p_first, p_second, complex_size, colors
                )
                return
    if flag_cycle:
        for ucm in cycle_set:
            state.detach_and_self(ucm.idx)
            state.set_non_super(ucm.idx)
        state.set_self(s.idx, s.strand)
    return


def find_superbubbles(
    g: CDBGraph, complex_size: int = 8, colors=None
) -> tuple[BubbleState, list[Bubble]]:
    """findSuperBubble over the whole graph (src/CDBG.cpp:178-252):
    seeds in iteration order, then a deterministic listing pass assigning
    ids 1..N in unitig order (plus strand before minus). With `colors`,
    registration applies the CCDBG color gates (src/CCDBG.cpp:2531-2621).

    This is the sequential host reference path; the production engine is
    bubble/batched.py's find_superbubbles_device (identical outputs,
    device-parallel search)."""
    state = BubbleState(len(g))
    for i in range(len(g)):
        if g.out_degree(i, True) > 1 and state.get_ptr(i, True) == NULL:
            extract_superbubble(g, state, g.handle(i, True), complex_size, colors)
        if g.out_degree(i, False) > 1 and state.get_ptr(i, False) == NULL:
            extract_superbubble(g, state, g.handle(i, False), complex_size, colors)
    return state, list_bubbles(state, len(g), colors)


def list_bubbles(state: BubbleState, n: int, colors=None) -> list[Bubble]:
    # listing pass mirrors the reference exactly — and the uncolored and
    # colored references genuinely differ here:
    #   CDBG (uncolored) lists by the visited BITS per side
    #     (!is_plus_visited(), src/CDBG.cpp:222-249);
    #   CCDBG (colored) skips is_both_visited() unitigs, then lists each
    #     side with a non-NULL POINTER — including self-links left behind
    #     by color-gate failures when the other side carries a live link
    #     (is_super() == !is_both_visited(), MyUnitig.hpp:56-59;
    #      src/CCDBG.cpp:2106-2133).
    bubbles = []
    nb = 0
    # vectorized candidate scan (the per-unitig Python loop is O(n) with
    # attribute lookups; at 10^6+ unitigs that dominates listing)
    both_visited = (state.flags & 0x03) == 0
    if colors is not None:
        plus_cand = (state.plus != NULL) & ~both_visited
        minus_cand = (state.minus != NULL) & ~both_visited
    else:
        plus_cand = ((state.flags & 0x01) != 0) & ~both_visited
        minus_cand = ((state.flags & 0x02) != 0) & ~both_visited
    for i in np.flatnonzero(plus_cand | minus_cand):
        i = int(i)
        if plus_cand[i]:
            nb += 1
            bubbles.append(
                Bubble(
                    nb,
                    i,
                    True,
                    int(state.plus[i]),
                    state.is_strict(i, True),
                    state.is_complex(i, True),
                )
            )
        if minus_cand[i]:
            nb += 1
            bubbles.append(
                Bubble(
                    nb,
                    i,
                    False,
                    int(state.minus[i]),
                    state.is_strict(i, False),
                    state.is_complex(i, False),
                )
            )
    return bubbles


def write_superbubble_file(
    g: CDBGraph, bubbles: list[Bubble], outpre: str, outdir: str = "PloidyFrost_output"
):
    """_super_bubble.txt (src/CDBG.cpp:221-249)."""
    import os

    os.makedirs(outdir, exist_ok=True)
    with open(os.path.join(outdir, outpre + "_super_bubble.txt"), "w") as f:
        f.write("BubbleId\tEntrance\tStrand\tExit\tisSimple\tisComplex\n")
        for b in bubbles:
            f.write(
                f"{b.bubble_id}\t{int(g.ids[b.entrance])}\t"
                f"{'+' if b.strand else '-'}\t{int(g.ids[b.exit])}\t"
                f"{1 if b.strict else 0}\t{1 if b.complex else 0}\n"
            )

"""Plain reference of the superbubble search and its listing.

The upstream's findSuperBubble (PloidyFrost src/CDBG.cpp:178-415 and
552-846; the colored gates of src/CCDBG.cpp:2402-2660), written out
plainly: each branching (unitig, strand), in unitig-id order, seeds a
walk that visits a unitig only once all its predecessors are visited;
the walk ends when one unitig is left to visit and none is merely seen.
That unitig is the exit. A walk that met a dead end or a cycle marks
what it saw as in no bubble; otherwise the entrance and the exit point
at each other, the unitigs between are marked as in no other bubble,
and the bubble is strict when it saw at most 6 unitigs, each between
the two with the entrance as its one predecessor and the exit as its
one successor, and complex when it saw more than `complex_size`. A
walk that never ends so marks only the unitigs of the cycles it met.
On several samples a bubble is kept only when its entrance and exit
carry every color on every k-mer, and each color that a unitig of the
bubble carries on all its k-mers goes on, all over, to one of its
successors.

The graph is the reference's own k-mer set; the program's unitig ids
and orientations (`<out>_Unitig_Id.txt`) only name its unitigs, and are
held to the reference's unitigs first. A strand is a node `2 * unitig
+ 1` (the unitig as written) or `2 * unitig` (its reverse complement).
"""

from __future__ import annotations

import numpy as np

NULL = -1
PLUS_SET, MINUS_SET, NON_SUPER = 0x01, 0x02, 0x04
STRICT = {1: 0x10, 0: 0x08}
COMPLEX = {1: 0x40, 0: 0x20}
SEEN, VISITED = 2, 1


def _pack(seqs: list[str], k: int, last: bool) -> np.ndarray:
    """The first (or last) k bases of each sequence, 2 bits a base."""
    lut = np.zeros(256, dtype=np.int64)
    for i, ch in enumerate(b"ACGT"):
        lut[ch] = i
    ends = "".join(s[-k:] if last else s[:k] for s in seqs).encode()
    codes = lut[np.frombuffer(ends, dtype=np.uint8)].reshape(len(seqs), k)
    out = np.zeros(len(seqs), dtype=np.int64)
    for j in range(k):
        out = (out << 2) | codes[:, j]
    return out


def _rc(x: np.ndarray, k: int) -> np.ndarray:
    out = np.zeros_like(x)
    for _ in range(k):
        out = (out << 2) | (3 - (x & 3))
        x = x >> 2
    return out


def adjacency(seqs: list[str], k: int) -> list[list[int]]:
    """succ[node]: the nodes that follow it, by the next base A, C, G, T.
    A node is entered at its first k-mer as written."""
    n = len(seqs)
    if n == 0:
        return []
    head, tail = _pack(seqs, k, False), _pack(seqs, k, True)
    entry = np.concatenate([head, _rc(tail, k)])
    node = np.concatenate([2 * np.arange(n) + 1, 2 * np.arange(n)])
    order = np.argsort(entry, kind="stable")
    entry, node = entry[order], node[order]
    mask = (1 << (2 * (k - 1))) - 1
    suffix = np.empty(2 * n, dtype=np.int64)
    suffix[1::2] = tail & mask  # the unitig as written ends so
    suffix[0::2] = _rc(head, k) & mask  # its reverse complement ends so
    nxt = np.full((2 * n, 4), NULL, dtype=np.int64)
    for b in range(4):
        q = (suffix << 2) | b
        i = np.minimum(np.searchsorted(entry, q), len(entry) - 1)
        nxt[:, b] = np.where(entry[i] == q, node[i], NULL)
    return [[int(x) for x in row if x >= 0] for row in nxt.tolist()]


class Search:
    """The pointer and flag state of every unitig, and the walks."""

    def __init__(self, succ: list[list[int]], complex_size: int = 8, colors=None):
        self.succ = succ
        self.pred = [[x ^ 1 for x in succ[v ^ 1]] for v in range(len(succ))]
        n = len(succ) // 2
        self.ptr = {1: [NULL] * n, 0: [NULL] * n}
        self.flags = [0] * n
        self.complex_size = complex_size
        self.colors = colors  # (full[u][c] as lists, size[u], k-mers[u]) or None

    # pointers: a side set to a partner is "not visited"; to itself, visited
    def set_self(self, u: int, side: int) -> None:
        self.ptr[side][u] = u
        self.flags[u] &= ~(PLUS_SET if side else MINUS_SET)

    def set_partner(self, u: int, side: int, p: int) -> None:
        self.ptr[side][u] = p
        self.flags[u] |= PLUS_SET if side else MINUS_SET

    def unlink(self, u: int, side: int) -> None:
        """Point `u`'s side at itself, and its partner's side that points
        back at it (the plus side when that holds u, else the minus)."""
        ex = self.ptr[side][u]
        if ex != NULL:
            self.set_self(ex, 1 if self.ptr[1][ex] == u else 0)
        self.set_self(u, side)

    def unlink_both(self, u: int) -> None:
        for side in (1, 0):
            ex = self.ptr[side][u]
            if ex != NULL and ex != u:
                self.set_self(ex, 1 if self.ptr[1][ex] == u else 0)
            self.set_self(u, side)

    def drop(self, u: int) -> None:
        self.unlink_both(u)
        self.flags[u] |= NON_SUPER

    def walk(self, s: int) -> None:
        succ, pred = self.succ, self.pred
        stack, seen_list = [s], [s]
        state: dict[int, int] = {}
        strand: dict[int, int] = {}
        listed = {s >> 1: s & 1}  # the strand each unitig was first seen on
        n_seen = 0  # unitigs in state SEEN
        cycle = tip = False
        cyc: set[int] = set()
        while stack:
            v = stack.pop()
            vu = v >> 1
            if state.get(vu) == SEEN:
                n_seen -= 1
            state[vu] = VISITED
            strand[vu] = v & 1
            if not succ[v]:
                tip = True
            for x in succ[v]:
                if x == s:
                    cycle = True
                    cyc.update((s, v))
                    continue
                xu = x >> 1
                if state.get(xu) == VISITED:
                    cycle = True
                    cyc.update((v, x))
                    continue
                if xu not in state:
                    seen_list.append(x)
                    listed[xu] = x & 1
                    strand[xu] = x & 1
                    n_seen += 1
                elif strand[xu] != x & 1:
                    cycle = True
                    cyc.update((x, v))
                state[xu] = SEEN
                ready = True
                for p in pred[x]:
                    pu = p >> 1
                    if pu not in state:
                        ready = False
                        continue
                    if state[pu] != VISITED:
                        ready = False
                    if strand[pu] != p & 1:
                        cycle = True
                        cyc.update((x, p))
                if ready:
                    stack.append(x)
            if len(stack) == 1:
                top = stack[0]
                tu = top >> 1
                top_seen = int(state.get(tu) == SEEN and listed.get(tu) == top & 1)
                if n_seen == top_seen:
                    if s in succ[top]:
                        self._no_bubble_cycle(seen_list, s, top)
                    elif cycle or tip:
                        self._no_bubble(seen_list, s, top)
                    else:
                        self._register(seen_list, s, top)
                    return
        if cycle:
            for c in cyc:
                self.drop(c >> 1)
            self.set_self(s >> 1, s & 1)

    def _no_bubble(self, seen_list, s, e) -> None:
        self.unlink(s >> 1, s & 1)
        self.unlink(e >> 1, 1 - (e & 1))
        for c in seen_list:
            if c != s and c != e:
                self.drop(c >> 1)

    def _no_bubble_cycle(self, seen_list, s, e) -> None:
        for c in seen_list:
            self.drop(c >> 1)
        self.set_self(s >> 1, s & 1)
        self.set_self(e >> 1, 1 - (e & 1))

    def _register(self, seen_list, s, e) -> None:
        if len(seen_list) < 4:
            return
        su, eu = s >> 1, e >> 1
        if (self.flags[su] | self.flags[eu]) & NON_SUPER:
            for c in seen_list:
                if c == s:
                    self.set_self(su, s & 1)
                elif c == e:
                    self.set_self(eu, 1 - (e & 1))
                else:
                    self.drop(c >> 1)
            return
        if len(seen_list) <= 6 and all(
                c in (s, e) or ([p >> 1 for p in self.pred[c]] == [su]
                                and [x >> 1 for x in self.succ[c]] == [eu])
                for c in seen_list):
            self.flags[su] |= STRICT[s & 1]
            self.flags[eu] |= STRICT[1 - (e & 1)]
        if len(seen_list) > self.complex_size:
            self.flags[su] |= COMPLEX[s & 1]
            self.flags[eu] |= COMPLEX[1 - (e & 1)]
        for c in seen_list:
            if c != s and c != e:
                self.drop(c >> 1)
        if self.colors is not None and not self._colors_hold(seen_list, s, e):
            return
        self.set_partner(su, s & 1, eu)
        self.set_partner(eu, 1 - (e & 1), su)

    def _colors_hold(self, seen_list, s, e) -> bool:
        full, size, nkm = self.colors
        C = len(full[0])
        su, eu = s >> 1, e >> 1
        ok = True
        for u in (su, eu):
            if size[u] != nkm[u] * C:
                ok = False
                self.flags[u] |= NON_SUPER
                self.set_self(su, s & 1)
                self.set_self(eu, 1 - (e & 1))
        if not ok:
            return False
        need = {su: list(range(C)), eu: list(range(C))}
        for c in seen_list:
            if c == e:
                continue
            cu = c >> 1
            if cu not in need:
                need[cu] = [col for col in range(C) if full[cu][col]]
            went_on = {col for x in self.succ[c] for col in need[cu] if full[x >> 1][col]}
            if len(went_on) != len(need[cu]):
                self.set_self(su, s & 1)
                self.set_self(eu, 1 - (e & 1))
                return False
        return True

    def run(self) -> None:
        n = len(self.flags)
        for u in range(n):
            for side in (1, 0):
                if len(self.succ[2 * u + side]) > 1 and self.ptr[side][u] == NULL:
                    self.walk(2 * u + side)

    def listing(self) -> list[tuple[int, str, int, int, int]]:
        """(entrance id, strand, exit id, strict, complex) of every
        listed side, in id order, plus before minus. One sample lists a
        side whose pointer is set to a partner; several list every side
        whose pointer is set at all (the upstream's two listings differ
        so), unless both sides are visited."""
        rows = []
        for u, f in enumerate(self.flags):
            if f & (PLUS_SET | MINUS_SET) == 0:
                continue
            for side, bit in ((1, PLUS_SET), (0, MINUS_SET)):
                listed = self.ptr[side][u] != NULL if self.colors is not None else f & bit
                if listed:
                    rows.append((u + 1, "+" if side else "-", self.ptr[side][u] + 1,
                                 int(bool(f & STRICT[side])), int(bool(f & COMPLEX[side]))))
        return rows


def read_listing(path: str) -> list[tuple[int, tuple]]:
    """(BubbleId, (entrance, strand, exit, isSimple, isComplex)) of each
    row of a `_super_bubble.txt`."""
    out = []
    with open(path) as f:
        next(f, None)
        for line in f:
            if line.strip():
                b, ent, strand, ext, simple, cplx = line.split()[:6]
                out.append((int(b), (int(ent), strand, int(ext), int(simple), int(cplx))))
    return out


def listing_off(program: list[tuple[int, tuple]], reference: list[tuple]) -> int:
    """Rows in one listing and not the other (as multisets), plus the
    program's rows whose BubbleId is not their place, 1 up."""
    from collections import Counter

    p = Counter(r for _, r in program)
    q = Counter(reference)
    misnumbered = sum(1 for i, (b, _) in enumerate(program) if b != i + 1)
    return sum(((p - q) + (q - p)).values()) + misnumbered

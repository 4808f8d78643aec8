# Copied from ploidyfrost_tpu/graph/colors.py; imports point at this package, color_graph probes natively.
"""Color (multi-sample) annotation of a compacted DBG.

Dense-matrix replacement for Bifrost's UnitigColors/DataStorage stack
(bifrost/src/ColorSet.{hpp,cpp}, DataStorage.{hpp,tcc}): instead of
per-unitig Roaring/TinyBitmap sets behind a hash-addressed store, colors
live in ONE dense boolean matrix over all unitig k-mer positions —
`bits[global_kmer_position, color]` — with a per-unitig offset table.
Every query the analysis needs (contains-on-all-kmers, per-color k-mer
counts, single-position membership) is a slice/reduction, and the whole
matrix is built with batched host `searchsorted` probes of the
per-sample k-mer tables (no re-streaming of reads, no locks).

Semantics matched to the reference:
  * contains(um, color) == color present on ALL k-mers of the mapping
    (bifrost/src/ColorSet.hpp:248-255) -> `full_colors`/`contains_all`.
  * size(um) == number of (k-mer position, color) pairs
    (ColorSet.hpp:259-261) -> `size`.
  * single k-mer mapping contains (used via findUnitig on window strings,
    src/CCDBG.cpp:3250-3260) -> `contains_at`.
"""

from __future__ import annotations

import numpy as np

from ..kmer.pack import canonical_np
from .cdbg import CDBGraph


def _flat_canonical_kmers(g: CDBGraph):
    """(offsets[n+1], canonical k-mer per global unitig position) —
    vectorized extraction from the packed SeqStore."""
    flat, lens = g.store.all_kmers(g.k)
    offs = np.zeros(len(lens) + 1, dtype=np.int64)
    np.cumsum(lens, out=offs[1:])
    return offs, canonical_np(flat, g.k)


class ColorMatrix:
    """Dense (total unitig k-mers x colors) boolean color matrix."""

    def __init__(
        self,
        offsets: np.ndarray,
        bits: np.ndarray,
        names: list[str],
        full_counts: np.ndarray | None = None,
    ):
        assert bits.ndim == 2 and offsets[-1] == bits.shape[0]
        self.offsets = offsets.astype(np.int64)
        self.bits = bits.astype(bool)
        self.names = list(names)
        # number of colors stored in the source's "full" sub-set (the
        # nested flag-4 representation, ColorSet.cpp:902-907). Nonzero
        # only for ColorMatrix objects decoded from Bifrost files; it
        # reproduces the size(um) argument quirk in the colored exit
        # gate (src/CCDBG.cpp:2552).
        self.full_counts = (
            np.zeros(len(offsets) - 1, dtype=np.int64)
            if full_counts is None
            else full_counts.astype(np.int64)
        )

    @property
    def n_colors(self) -> int:
        return self.bits.shape[1]

    def unitig_bits(self, ui: int) -> np.ndarray:
        """bool[len, C] color bits of unitig ui's k-mer positions."""
        return self.bits[self.offsets[ui] : self.offsets[ui + 1]]

    def full_colors(self, ui: int) -> np.ndarray:
        """bool[C]: colors present on ALL k-mers of unitig ui
        (UnitigColors::contains(um, c) for the full-unitig mapping)."""
        return self.unitig_bits(ui).all(axis=0)

    def full_colors_all(self) -> np.ndarray:
        """bool[n, C]: full_colors for EVERY unitig in one reduceat pass
        (the colored walk consults this per branch; per-call slicing
        measured hot)."""
        cached = getattr(self, "_full_all", None)
        if cached is None:
            starts = self.offsets[:-1]
            n = len(starts)
            if len(self.bits) == 0 or n == 0:
                cached = np.zeros((n, self.n_colors), dtype=bool)
            else:
                mins = np.minimum.reduceat(
                    self.bits.view(np.uint8), starts, axis=0
                )
                cached = mins.astype(bool)
                empty = self.offsets[1:] == starts
                cached[empty] = True  # all() of an empty slice
            self._full_all = cached
        return cached

    def size_all(self) -> np.ndarray:
        """int64[n]: size(ui) for every unitig in one reduceat pass."""
        cached = getattr(self, "_size_all", None)
        if cached is None:
            starts = self.offsets[:-1]
            if len(self.bits) == 0 or len(starts) == 0:
                cached = np.zeros(len(starts), dtype=np.int64)
            else:
                per_pos = self.bits.sum(axis=1, dtype=np.int64)
                csum = np.concatenate([[0], np.cumsum(per_pos)])
                cached = csum[self.offsets[1:]] - csum[starts]
            self._size_all = cached
        return cached

    def contains_all(self, ui: int, color: int) -> bool:
        return bool(self.unitig_bits(ui)[:, color].all())

    def contains_at(self, ui: int, pos: int, color: int) -> bool:
        """Color presence on the single k-mer at `pos` of unitig ui
        (UnitigColors::contains for a len-1 mapping)."""
        return bool(self.bits[self.offsets[ui] + pos, color])

    def colors_at(self, ui: int, pos: int) -> np.ndarray:
        return self.bits[self.offsets[ui] + pos]

    def size(self, ui: int) -> int:
        """Number of (k-mer position, color) pairs of unitig ui
        (UnitigColors::size(um), ColorSet.hpp:259-261)."""
        return int(self.unitig_bits(ui).sum())

    def size_as(self, ui: int, num_km_other: int) -> int:
        """UnitigColors::size(um) evaluated with ANOTHER unitig's k-mer
        count — the exit-gate quirk (src/CCDBG.cpp:2552, size(p.first)
        on p.second's set; ColorSet.cpp:902-907). Identical to size()
        unless the set was decoded from a nested full/partial split."""
        nf = int(self.full_counts[ui])
        if nf == 0:
            return self.size(ui)
        own = int(self.offsets[ui + 1] - self.offsets[ui])
        return nf * num_km_other + (self.size(ui) - nf * own)

    def color_kmer_counts(self, ui: int) -> np.ndarray:
        """int[C]: per-color number of colored k-mers of unitig ui."""
        return self.unitig_bits(ui).sum(axis=0)

    def gate_arrays(self):
        """Vectorized per-unitig gate inputs for the flat colored
        replay (bubble/batched._replay_fast): (sizes int64[n],
        contains_all bool[n, C], n_kmers int64[n]) — size(ui),
        full-unitig color membership, and k-mer counts for every unitig
        in three reduceat passes. Cached."""
        cached = getattr(self, "_gate_cache", None)
        if cached is not None:
            return cached
        starts = self.offsets[:-1]
        n_km = np.diff(self.offsets)
        if self.bits.shape[0] and len(starts):
            sizes = np.add.reduceat(
                self.bits.sum(axis=1, dtype=np.int64), starts
            )
            ca = (
                np.minimum.reduceat(
                    self.bits.view(np.uint8), starts, axis=0
                )
                > 0
            )
        else:
            sizes = np.zeros(len(starts), dtype=np.int64)
            ca = np.zeros((len(starts), self.n_colors), dtype=bool)
        self._gate_cache = (sizes, ca, n_km)
        return self._gate_cache

    def size_as_flat(self, ui: int, num_km_other: int) -> int:
        """size_as via the cached gate arrays (no row slicing)."""
        nf = int(self.full_counts[ui])
        sizes, _, n_km = self.gate_arrays()
        if nf == 0:
            return int(sizes[ui])
        return nf * num_km_other + int(sizes[ui]) - nf * int(n_km[ui])


class KmerPosIndex:
    """Canonical k-mer -> (unitig, position) lookup over a CDBGraph.

    The batched replacement of CompactedDBG::findUnitig's
    minimizer-index walk (bifrost/src/CompactedDBG.tcc:629-652): all
    unitig k-mers are held sorted once; queries are vectorized
    searchsorted probes.
    """

    def __init__(self, g: CDBGraph):
        self.g = g
        offs, flat = _flat_canonical_kmers(g)
        lens = np.diff(offs)
        self.offsets = offs
        self.flat = flat  # canonical k-mer per global position
        order = np.argsort(flat, kind="stable")
        self._sorted = flat[order]
        self._order = order
        self._uidx = np.repeat(np.arange(len(lens)), lens)[order]
        self._pos = (np.arange(int(offs[-1])) - offs[self._uidx_unsorted()])[order]

    def _uidx_unsorted(self):
        lens = np.diff(self.offsets)
        return np.repeat(np.arange(len(lens)), lens)

    def find(self, queries: np.ndarray):
        """For canonical packed k-mers: (unitig index, position, found)."""
        q = np.asarray(queries, dtype=np.uint64)
        idx = np.clip(
            np.searchsorted(self._sorted, q), 0, max(len(self._sorted) - 1, 0)
        )
        hit = (
            self._sorted[idx] == q
            if len(self._sorted)
            else np.zeros(len(q), dtype=bool)
        )
        return self._uidx[idx], self._pos[idx], hit

    def find_string_head(self, s: str):
        """findUnitig(s, 0, len): locate the first k-mer of s.

        Scalar path: encodes just the head k-mer with python int ops —
        the array pipeline (sequence_kmers_np) costs ~190 us per call
        and this runs once per distinct branching-site window."""
        from ..kmer.pack import encode_kmer_string

        k = self.g.k
        v = encode_kmer_string(s[:k])
        # scalar reverse complement of a 2-bit-packed k-mer
        x = ~v & ((1 << (2 * k)) - 1)
        r = 0
        for _ in range(k):
            r = (r << 2) | (x & 3)
            x >>= 2
        km = np.array([min(v, r)], dtype=np.uint64)
        ui, pos, hit = self.find(km)
        return int(ui[0]), int(pos[0]), bool(hit[0])


def color_graph(
    g: CDBGraph, sample_kmers: list[np.ndarray], names: list[str] | None = None
) -> ColorMatrix:
    """Build the color matrix: bit (p, c) set iff the canonical k-mer at
    global position p occurs in sample c's (filtered) k-mer set.

    Replaces ColoredCDBG::buildColors' read re-streaming
    (bifrost/src/ColoredCDBG.tcc:407-417) with batched sorted-array
    membership probes, one pass per sample.
    """
    from ..kmer.countdb import SortedU64Index

    offs, flat = _flat_canonical_kmers(g)
    C = len(sample_kmers)
    bits = np.zeros((int(offs[-1]), C), dtype=bool)
    for c, km in enumerate(sample_kmers):
        km = np.sort(np.asarray(km, dtype=np.uint64))
        if len(km):
            # the probes come in unitig order, random against the sorted
            # set: the native bucketed search, not np.searchsorted
            idx = SortedU64Index(km, 2 * g.k).lower_bound(flat)
            np.minimum(idx, len(km) - 1, out=idx)
            bits[:, c] = km[idx] == flat
    if names is None:
        names = [f"sample{c}" for c in range(C)]
    return ColorMatrix(offs, bits, names)

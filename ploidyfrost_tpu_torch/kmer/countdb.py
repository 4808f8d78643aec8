# Ported from ploidyfrost_tpu/kmer/countdb.py: host probes copied, the device lookup in torch.
"""Batched random-access k-mer count lookups (replaces KMC kmc_api).

The reference probes its on-disk KMC database one k-mer at a time:
CKmerAPI::from_string + CKMCFile::IsKmer/CheckKmer per k-mer of every
unitig and window string (src/CDBG.cpp:29-120, KMC/kmc_api/kmc_file.cpp).
Here the whole table is a sorted host array and probes are batched:
one native bucketed search (native/lookup.cpp) covers every k-mer of
every branch of every bubble in an analysis phase.

Lookups are strand-symmetric: queries are canonicalized before the
search, which reproduces the reference's `IsKmer(km) ? km : reverse(km)`
dance (src/CDBG.cpp:38-42) for canonically-counted databases
(GetBothStrands() == true).
"""

from __future__ import annotations

import numpy as np


def _fused_native_lookup(index, q, counts_2d, C, transpose=False):
    """One threaded native pass: canonicalize + bucketed probe + [n, C]
    count-row gather (native/lookup.cpp pf_lookup_canon_multi_t).
    Returns (counts int64 — [nq, C], or [C, nq] when `transpose` —
    and hit [nq] bool), or None when the native library is unavailable
    / the batch is too small to matter.

    `index` is the KmerCountDB holding the sorted key table; counts_2d
    is a row-major int64 [n_keys(, padded ok), C] array."""
    from ..native import load_lookup_library

    lib = load_lookup_library()
    if lib is None or len(q) < 4096:
        return None
    import ctypes

    lut, shift, bmax = index._make_lut()
    q = np.ascontiguousarray(q, dtype=np.uint64)
    counts_2d = np.ascontiguousarray(counts_2d, dtype=np.int64)
    out = np.empty((C, len(q)) if transpose else (len(q), C), dtype=np.int64)
    hit = np.empty(len(q), dtype=np.uint8)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.pf_lookup_canon_multi_t(
        index._km_np.ctypes.data_as(u64p),
        ctypes.c_int64(index._n),
        lut.ctypes.data_as(i64p),
        ctypes.c_int32(shift),
        ctypes.c_int32(index.k),
        ctypes.c_int64(bmax),
        q.ctypes.data_as(u64p),
        ctypes.c_int64(len(q)),
        counts_2d.ctypes.data_as(i64p),
        ctypes.c_int32(C),
        out.ctypes.data_as(i64p),
        hit.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int32(0),
        ctypes.c_int32(1 if transpose else 0),
    )
    return out, hit.astype(bool)


def lookup_device(table_km, table_ct, queries, k: int):
    """Device counterpart of KmerCountDB.lookup on int64 tensors.

    table_km: sorted canonical k-mers [n] int64, table_ct: their counts
    [n] int64, queries: packed k-mers of either strand, any shape, all
    on one device. Returns (counts int64, hit bool) shaped like
    `queries`; a miss has count 0. Nothing on the pipeline path calls
    this (its probes start and end on the host, see KmerCountDB.lookup);
    it serves callers whose queries already live on the device.
    """
    import torch

    from .pack import canonical_kmers

    canon = canonical_kmers(queries, k)
    n = table_km.shape[0]
    if n == 0:
        return torch.zeros_like(canon), torch.zeros_like(canon, dtype=torch.bool)
    idx = torch.searchsorted(table_km, canon).clamp_(max=n - 1)
    hit = table_km[idx] == canon
    counts = torch.where(hit, table_ct[idx], 0)
    return counts, hit


def sorted_union(arrays) -> np.ndarray:
    """Sorted distinct union of uint64 key arrays: one sort of the
    concatenation and an adjacent-difference pass, the result of
    np.unique. np.unique itself hashes integer keys in recent numpy
    versions and then takes seconds for ten million of them."""
    cat = np.concatenate([np.asarray(a, dtype=np.uint64) for a in arrays])
    cat.sort()
    if len(cat) < 2:
        return cat
    keep = np.empty(len(cat), dtype=bool)
    keep[0] = True
    np.not_equal(cat[1:], cat[:-1], out=keep[1:])
    return cat[keep]


class SortedU64Index:
    """Reusable native bucketed lower_bound over a sorted uint64 table:
    np.searchsorted semantics through the block-prefetched kernel
    (native/lookup.cpp pf_lookup_u64_b). Builds the adaptive prefix LUT
    once; falls back to np.searchsorted without the native library.
    Used by the adjacency build (graph/cdbg._build_adjacency), whose 8
    entry-k-mer probes were the GFA load's dominant term after the
    packing fix."""

    def __init__(self, table: np.ndarray, key_bits: int):
        self.table = np.ascontiguousarray(table, dtype=np.uint64)
        n = len(self.table)
        bits = min(22, max(16, max(n, 1).bit_length()))
        bits = min(bits, key_bits)
        self.shift = key_bits - bits
        nb = 1 << bits
        cnt = np.bincount(
            (self.table >> np.uint64(self.shift)).astype(np.int64),
            minlength=nb,
        )
        self.lut = np.zeros(nb + 1, dtype=np.int64)
        np.cumsum(cnt, out=self.lut[1:])
        self.bmax = nb - 1

    def lower_bound(self, q: np.ndarray) -> np.ndarray:
        from ..native import load_lookup_library

        lib = load_lookup_library()
        if lib is None or len(q) < 4096:
            return np.searchsorted(self.table, q)
        import ctypes

        q = np.ascontiguousarray(q, dtype=np.uint64)
        out = np.empty(len(q), dtype=np.int64)
        u64p = ctypes.POINTER(ctypes.c_uint64)
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.pf_lookup_u64_b(
            self.table.ctypes.data_as(u64p),
            ctypes.c_int64(len(self.table)),
            self.lut.ctypes.data_as(i64p),
            ctypes.c_int32(self.shift),
            ctypes.c_int64(self.bmax),
            q.ctypes.data_as(u64p),
            ctypes.c_int64(len(q)),
            out.ctypes.data_as(i64p),
        )
        return out


class KmerCountDB:
    """Sorted host (k-mer -> count) table with batched probes."""

    def __init__(self, kmers: np.ndarray, counts: np.ndarray, k: int):
        self.k = k
        km = np.asarray(kmers, dtype=np.uint64)
        ct = np.asarray(counts, dtype=np.int64)
        self._n = len(km)
        # pad the table to a power of two (pad keys are u64 max, above
        # any canonical k-mer for k <= 31, so they never match; an
        # empty table still has one row for the clipped probe)
        cap = 1 << max(self._n - 1, 1).bit_length()
        kmp = np.full(cap, np.uint64(0xFFFFFFFFFFFFFFFF), dtype=np.uint64)
        ctp = np.zeros(cap, dtype=np.int64)
        kmp[: self._n] = km
        ctp[: self._n] = ct
        # host table: probe batches are latency-bound pointer chases
        self._km_np = kmp
        self._ct_np = ctp
        self._lut = None  # native bucketed-search prefix LUT (lazy)

    def _make_lut(self):
        if self._lut is None:
            # adaptive prefix width: larger tables get more buckets
            # (up to 2^22), shrinking the per-bucket binary search
            bits = min(22, max(16, max(self._n, 1).bit_length()))
            bits = min(bits, 2 * self.k)
            shift = 2 * self.k - bits
            nb = 1 << bits
            # O(n) construction: bucket counts + cumsum, not one
            # searchsorted per bucket bound. Real keys only — the pad
            # sentinels stay outside every bucket, which is fine: no
            # canonical query (< 2^2k) ever probes past lut[nb] = n.
            cnt = np.bincount(
                (self._km_np[: self._n] >> np.uint64(shift)).astype(
                    np.int64
                ),
                minlength=nb,
            )
            lut = np.zeros(nb + 1, dtype=np.int64)
            np.cumsum(cnt, out=lut[1:])
            self._lut = (lut, shift, nb - 1)
        return self._lut

    def __len__(self):
        return self._n

    def lookup(self, queries: np.ndarray):
        """counts, found  for a flat batch of packed (any-strand) k-mers.

        Resolved on the host (canonicalize + one bucketed search):
        binary probes are latency-bound pointer chases, and every
        caller on the pipeline path holds its queries on the host."""
        q = np.asarray(queries, dtype=np.uint64).ravel()
        n = len(q)
        if n == 0:
            return np.zeros(0, np.int64), np.zeros(0, bool)
        fused = _fused_native_lookup(
            self, q, self._ct_np.reshape(-1, 1), 1
        )
        if fused is not None:
            counts, hit = fused
            return counts[:, 0], hit
        from .pack import canonical_np

        canon = canonical_np(q, self.k)
        idx = self._search(canon)
        np.clip(idx, 0, max(self._n - 1, 0), out=idx)
        hit = self._km_np[idx] == canon
        counts = np.where(hit, self._ct_np[idx], 0)
        return counts, hit

    def _search(self, canon: np.ndarray) -> np.ndarray:
        """lower_bound indexes of `canon` in the table: the native
        bucketed binary search (native/lookup.cpp, an adaptive 2^16..22
        prefix LUT + per-bucket lower_bound — the same two-level
        structure as KMC's .kmc_pre prefix table,
        KMC/kmc_api/kmc_file.cpp:136-230), with np.searchsorted as the
        portable fallback."""
        from ..native import load_lookup_library

        lib = load_lookup_library()
        if lib is None or len(canon) < 4096:
            return np.searchsorted(self._km_np, canon)
        import ctypes

        lut, shift, bmax = self._make_lut()
        canon = np.ascontiguousarray(canon, dtype=np.uint64)
        out = np.empty(len(canon), dtype=np.int64)
        lib.pf_lookup_u64_b(
            self._km_np.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            ctypes.c_int64(len(self._km_np)),
            lut.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            ctypes.c_int32(shift),
            ctypes.c_int64(bmax),
            canon.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            ctypes.c_int64(len(canon)),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        )
        return out


class MultiColorCountDB:
    """Fused multi-database probe table for the colored path.

    The colored coverage passes (sites/emit_colored.py) probe the SAME
    query k-mers against every color's database; per-color lookups
    repeat the canonicalization and the latency-bound binary probes C
    times over. This table unions the keys once (sequencing replicates
    share almost all k-mers) and answers every color with ONE search
    plus a [n, C] gather.
    """

    def __init__(self, dbs: list[KmerCountDB]):
        assert dbs
        self.k = dbs[0].k
        self.C = len(dbs)
        keys = [d._km_np[: len(d)] for d in dbs]
        if all(
            len(km) == len(keys[0]) and np.array_equal(km, keys[0])
            for km in keys[1:]
        ):
            union = keys[0]
            counts = np.stack(
                [d._ct_np[: len(d)] for d in dbs], axis=1
            )
        else:
            union = sorted_union(keys)
            counts = np.zeros((len(union), self.C), dtype=np.int64)
            for c, d in enumerate(dbs):
                pos = np.searchsorted(union, keys[c])
                counts[pos, c] = d._ct_np[: len(d)]
        # reuse KmerCountDB's padded table + native bucketed search
        self._index = KmerCountDB(
            union, np.zeros(len(union), np.int64), self.k
        )
        self._counts = counts

    def lookup(self, queries):
        """(counts [n, C] int64, hit [n] bool) — one canonicalization,
        one search, C gathers."""
        counts_t, hit = self.lookup_t(queries)
        return counts_t.T, hit

    def lookup_t(self, queries):
        """(counts [C, n] int64, hit [n] bool) — transposed layout:
        each color's counts are CONTIGUOUS, which is what the reduceat
        passes in sites/emit_colored.py consume."""
        from .pack import canonical_np

        q = np.asarray(queries, dtype=np.uint64).ravel()
        if len(q) == 0 or len(self._counts) == 0:
            return (
                np.zeros((self.C, len(q)), np.int64),
                np.zeros(len(q), bool),
            )
        fused = _fused_native_lookup(
            self._index, q, self._counts, self.C, transpose=True
        )
        if fused is not None:
            return fused
        canon = canonical_np(q, self.k)
        idx = self._index._search(canon)
        np.clip(idx, 0, max(len(self._index) - 1, 0), out=idx)
        hit = self._index._km_np[idx] == canon
        counts = np.where(
            hit[:, None], self._counts[np.minimum(idx, len(self._counts) - 1)], 0
        )
        return np.ascontiguousarray(counts.T), hit

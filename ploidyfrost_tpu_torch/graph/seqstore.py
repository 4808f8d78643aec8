# Copied from ploidyfrost_tpu/graph/seqstore.py; imports point at this package.
"""2-bit packed, word-aligned unitig sequence storage.

Replaces Bifrost's CompressedSequence (bifrost/src/CompressedSequence.hpp:
1-197) role for the analysis graph: unitig sequences live as one flat
uint64 array (32 bases/word, LSB-first within the word) plus per-unitig
word offsets and base lengths — flat memory at genome scale instead of
per-unitig Python str objects, and a layout the device k-mer pipeline
can consume directly.

Everything here is vectorized numpy (no per-base or per-unitig Python
loops):

  * ``from_strings``  — one table-lookup encode + one scatter + one
    or-reduce pack for the whole corpus;
  * ``all_kmers``     — every k-mer of every unitig in k shifted adds
    over the unpacked corpus (the batched readCov(u) feed,
    src/CDBG.cpp:66-120);
  * ``head/tail_kmers`` — the adjacency-build probes;
  * ``decode_all``    — one unpack + one bytes translation for output
    writing (the only place strings are materialized in bulk).

Strings remain available per unitig through ``decode`` for the host
analysis paths (alignment, window extraction), which only ever touch
the small subset of unitigs inside bubbles.
"""

from __future__ import annotations

import numpy as np

from ..kmer.pack import INVALID_BASE, encode_bases

_BASES_U8 = np.frombuffer(b"ACGT", dtype=np.uint8)
_SHIFTS = (2 * np.arange(32, dtype=np.uint64)).astype(np.uint64)

_M6 = np.uint64(0x0303030303030303)
_M4 = np.uint64(0x0C0C0C0C0C0C0C0C)
_M2 = np.uint64(0x3030303030303030)
_M0 = np.uint64(0xC0C0C0C0C0C0C0C0)


def _reverse_2bit_groups(x: np.ndarray) -> np.ndarray:
    """Reverse the 32 2-bit groups of each uint64: group g -> 31-g.

    byteswap reverses byte order; the masked shifts reverse the four
    groups inside each byte. Turns an LSB-first 32-base word into the
    MSB-first packing in ~6 vectorized ops."""
    x = x.byteswap()
    return (
        ((x & _M6) << np.uint64(6))
        | ((x & _M4) << np.uint64(2))
        | ((x & _M2) >> np.uint64(2))
        | ((x & _M0) >> np.uint64(6))
    )


class SeqStore:
    """Packed sequence corpus: words[uint64], word offsets, base lengths."""

    __slots__ = ("words", "off_w", "lengths", "_codes_cache", "_all_kmers_cache")

    def __init__(self, words: np.ndarray, off_w: np.ndarray, lengths: np.ndarray):
        self.words = np.asarray(words, dtype=np.uint64)
        self.off_w = np.asarray(off_w, dtype=np.int64)
        self.lengths = np.asarray(lengths, dtype=np.int64)
        self._codes_cache = None

    # -- constructors -----------------------------------------------------

    @classmethod
    def from_codes(cls, codes: np.ndarray, lengths: np.ndarray) -> "SeqStore":
        """codes: flat uint8 base codes (0..3), unitigs concatenated in
        order with NO padding; lengths: base length per unitig."""
        lengths = np.asarray(lengths, dtype=np.int64)
        n = len(lengths)
        nwords = (lengths + 31) // 32
        off_w = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(nwords, out=off_w[1:])
        total_w = int(off_w[-1])
        off_b = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(lengths, out=off_b[1:])
        # native one-pass packer (lookup.cpp pf_pack_codes): linear
        # read of the code bytes, no per-base index arrays — the numpy
        # scatter below costs ~40 s at 62M bases (50 Mbp GFA load)
        if total_w >= (1 << 12):
            from ..native import load_lookup_library

            lib = load_lookup_library()
            if lib is not None and hasattr(lib, "pf_pack_codes"):
                import ctypes

                codes_c = np.ascontiguousarray(codes, dtype=np.uint8)
                words = np.zeros(total_w, dtype=np.uint64)
                lib.pf_pack_codes(
                    codes_c.ctypes.data_as(
                        ctypes.POINTER(ctypes.c_uint8)
                    ),
                    off_b.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                    off_w.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                    ctypes.c_int64(n),
                    words.ctypes.data_as(
                        ctypes.POINTER(ctypes.c_uint64)
                    ),
                    ctypes.c_int32(0),
                )
                return cls(words, off_w, lengths)
        # numpy fallback: scatter each base into its padded slot, then
        # pack 32 per word
        seg = np.repeat(np.arange(n), lengths)
        pos_in = np.arange(off_b[-1], dtype=np.int64) - off_b[seg]
        padded = np.zeros(total_w * 32, dtype=np.uint8)
        padded[off_w[seg] * 32 + pos_in] = np.asarray(codes, dtype=np.uint8)
        # pack 32 LSB-first 2-bit codes per u64 with two uint8-wide
        # halving passes + a little-endian byte view (base j sits at
        # bits [2j, 2j+2), so byte b of the word is bases 4b..4b+3 —
        # exactly the native byte order). ~8x less memory traffic than
        # the former 32-lane uint64 broadcast+reduce.
        p = padded.reshape(total_w, 32)
        s1 = p[:, 0::2] | (p[:, 1::2] << 2)
        s2 = np.ascontiguousarray(s1[:, 0::2] | (s1[:, 1::2] << 4))
        words = s2.reshape(-1).view(np.uint64)
        return cls(words, off_w, lengths)

    @classmethod
    def from_strings(cls, seqs: list[str]) -> "SeqStore":
        lengths = np.fromiter((len(s) for s in seqs), dtype=np.int64, count=len(seqs))
        blob = "".join(seqs).encode()
        codes = encode_bases(np.frombuffer(blob, dtype=np.uint8))
        if (codes >= INVALID_BASE).any():
            bad = np.flatnonzero(codes >= INVALID_BASE)[0]
            raise ValueError(f"invalid base {blob[bad:bad+1]!r} in sequences")
        return cls.from_codes(codes, lengths)

    # -- core views --------------------------------------------------------

    def __len__(self) -> int:
        return len(self.lengths)

    @property
    def total_bases(self) -> int:
        return int(self.lengths.sum())

    def unpack(self) -> np.ndarray:
        """Padded uint8 code array [n_words * 32]; pad lanes decode as 0
        ('A') and are excluded by every consumer via length masks. Cached
        (the adjacency build and coverage feed share it)."""
        if self._codes_cache is None:
            lanes = (self.words[:, None] >> _SHIFTS) & np.uint64(3)
            self._codes_cache = lanes.astype(np.uint8).reshape(-1)
        return self._codes_cache

    def drop_cache(self):
        self._codes_cache = None

    # -- decoding ----------------------------------------------------------

    def decode(self, i: int) -> str:
        w0 = int(self.off_w[i])
        ln = int(self.lengths[i])
        lanes = (self.words[w0 : w0 + (ln + 31) // 32, None] >> _SHIFTS) & np.uint64(3)
        codes = lanes.astype(np.uint8).reshape(-1)[:ln]
        return _BASES_U8[codes].tobytes().decode()

    def decode_all(self) -> list[str]:
        """All sequences as strings: one unpack + one translation, then
        per-unitig slicing of a single bytes object."""
        padded = self.unpack()
        blob = _BASES_U8[padded].tobytes()
        out = []
        for i in range(len(self.lengths)):
            s = int(self.off_w[i]) * 32
            out.append(blob[s : s + int(self.lengths[i])].decode())
        return out

    # -- k-mer extraction (vectorized) --------------------------------------

    def _kmer_acc(self, k: int) -> np.ndarray:  # retained as a test oracle
        """acc[p] = MSB-first packed k-mer starting at padded position p
        (valid only where the window stays inside one unitig)."""
        codes = self.unpack()
        P = len(codes)
        n_out = P - k + 1
        acc = np.zeros(n_out, dtype=np.uint64)
        for j in range(k):
            acc = (acc << np.uint64(2)) | codes[j : j + n_out].astype(np.uint64)
        return acc

    def kmer_start_mask(self, k: int) -> np.ndarray:
        """Bool mask over padded positions: True where a k-mer window
        starts inside a unitig (pos_in <= len - k)."""
        P = int(self.off_w[-1]) * 32
        delta = np.zeros(P + 1, dtype=np.int32)
        starts = self.off_w[:-1] * 32
        nk = self.lengths - k + 1
        good = nk > 0
        np.add.at(delta, starts[good], 1)
        np.add.at(delta, starts[good] + nk[good], -1)
        return np.cumsum(delta[:-1]) > 0

    def all_kmers(self, k: int) -> tuple[np.ndarray, np.ndarray]:
        """(kmers, n_per_unitig): every forward-strand k-mer of every
        unitig, concatenated in unitig order. Word-gather extraction at
        the valid start positions (kmers_at) — ~5x faster than the
        unpack + k-step shift-accumulate corpus scan it replaces.
        Memoized per k (several analysis passes consume the same
        arrays; treat the result as read-only)."""
        cache = getattr(self, "_all_kmers_cache", None)
        if cache is None:
            cache = self._all_kmers_cache = {}
        if k not in cache:
            mask = self.kmer_start_mask(k)
            pos = np.flatnonzero(mask)
            nk = np.maximum(self.lengths - k + 1, 0)
            cache[k] = (self.kmers_at(pos, k), nk)
        return cache[k]

    def kmers_at(self, upos: np.ndarray, k: int) -> np.ndarray:
        """MSB-first packed k-mer starting at each absolute padded base
        position (k <= 31; the window must lie inside one unitig). Reads
        at most two words per query — O(q * k) instead of the corpus
        scan of _kmer_acc. Large batches go through the threaded native
        kernel (native/lookup.cpp pf_extract_kmers, one scalar pass per
        query vs ~14 whole-array numpy passes)."""
        upos = np.asarray(upos, dtype=np.int64)
        if len(upos) >= (1 << 14):
            from ..native import load_lookup_library

            lib = load_lookup_library()
            if lib is not None and hasattr(lib, "pf_extract_kmers"):
                import ctypes

                upos_c = np.ascontiguousarray(upos)
                out = np.empty(len(upos), dtype=np.uint64)
                lib.pf_extract_kmers(
                    self.words.ctypes.data_as(
                        ctypes.POINTER(ctypes.c_uint64)
                    ),
                    ctypes.c_int64(len(self.words)),
                    upos_c.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                    ctypes.c_int64(len(upos_c)),
                    ctypes.c_int32(k),
                    out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
                    ctypes.c_int32(0),
                )
                return out
        w0 = upos >> 5
        b = ((upos & 31).astype(np.uint64)) * np.uint64(2)
        lo = self.words[w0] >> b
        hi_idx = np.minimum(w0 + 1, len(self.words) - 1)
        hi = np.where(
            b == 0,
            np.uint64(0),
            self.words[hi_idx] << ((np.uint64(64) - b) & np.uint64(63)),
        )
        val = lo | hi  # 32 bases LSB-first starting at upos
        # MSB-first conversion in O(1) passes: reverse the 32 2-bit
        # groups (byteswap + in-byte group swap), then drop the unused
        # low groups — replaces the k-iteration shift-accumulate loop
        # (k x 4 ops over the whole query array)
        return _reverse_2bit_groups(val) >> np.uint64(2 * (32 - k))

    def head_kmers(self, k: int) -> np.ndarray:
        """First k-mer of each unitig (requires all lengths >= k)."""
        return self.kmers_at(self.off_w[:-1] * 32, k)

    def tail_kmers(self, k: int) -> np.ndarray:
        return self.kmers_at(self.off_w[:-1] * 32 + self.lengths - k, k)

    # -- reordering ----------------------------------------------------------

    def reorder(self, perm: np.ndarray) -> "SeqStore":
        """New store with unitigs permuted (gathers whole words)."""
        perm = np.asarray(perm, dtype=np.int64)
        nwords = (self.lengths[perm] + 31) // 32
        off_w = np.zeros(len(perm) + 1, dtype=np.int64)
        np.cumsum(nwords, out=off_w[1:])
        total_w = int(off_w[-1])
        # source word index for each destination word
        seg = np.repeat(np.arange(len(perm)), nwords)
        pos_in = np.arange(total_w, dtype=np.int64) - off_w[seg]
        src = self.off_w[perm[seg]] + pos_in
        return SeqStore(self.words[src], off_w, self.lengths[perm])


class SeqView:
    """List-of-strings facade over a SeqStore with a small decode cache —
    keeps the host analysis code (which only touches bubble unitigs)
    reading ``g.seqs[i]`` as before without materializing the corpus."""

    __slots__ = ("store", "_cache", "_cap")

    def __init__(self, store: SeqStore, cache_size: int = 8192):
        self.store = store
        self._cache: dict[int, str] = {}
        self._cap = cache_size

    def __len__(self) -> int:
        return len(self.store)

    def __getitem__(self, i: int) -> str:
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(len(self)))]
        i = int(i)
        s = self._cache.get(i)
        if s is None:
            s = self.store.decode(i)
            if len(self._cache) >= self._cap:
                self._cache.clear()
            self._cache[i] = s
        return s

    def __iter__(self):
        # bulk path: iteration = output writing; decode once, vectorized
        return iter(self.store.decode_all())

    def materialize(self) -> None:
        """Decode the whole corpus into the cache in one vectorized
        pass. Callers that will touch most unitigs (the analysis walk
        reads entrance/exit/branch strings of ~every bubble) pay one
        bulk decode instead of 100k+ per-unitig decode calls."""
        if len(self._cache) >= len(self.store):
            return
        self._cap = max(self._cap, len(self.store) + 1)
        self._cache = dict(enumerate(self.store.decode_all()))

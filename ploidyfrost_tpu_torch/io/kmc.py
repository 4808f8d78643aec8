# Copied from ploidyfrost_tpu/io/kmc.py; imports point at this package.
"""KMC1 + KMC2 database format reader/writer (.kmc_pre / .kmc_suf).

Interop layer with the reference stack: PloidyFrost opens a KMC database
for random access (CKMCFile::OpenForRA, KMC/kmc_api/kmc_file.cpp:27-66)
and probes it per k-mer. Our counter is a device-resident sorted table;
this module serializes that table into the KMC on-disk layouts so that
(a) the reference binary can run on OUR counts (golden parity tests),
and (b) we can ingest databases produced by a real KMC run — including
the KMC2/KMC3 layout (kmc_version 0x200: signature map + per-bin prefix
LUTs, kmc_file.cpp:136-302) that actual `kmc -k25` invocations emit.

KMC1 .kmc_pre layout (decoded from kmc_file.cpp:140-302):

    [4B marker "KMCP"]
    [LUT: uint64 * 4^lut_prefix_length]     # record index of first k-mer
                                            # with each prefix (cumsum)
    [header, 5 x uint64]:
        kmer_length | mode << 32            # mode 0 = integer counters
        counter_size | lut_prefix_length << 32
        min_count | max_count << 32
        total_kmers
        both_strands_flag                   # low nibble: 0 => canonical
    [4B pad]                                # keeps (body-4) % 8 == 0
    [uint32 kmc_version = 0]                # 0 = KMC1 (kmc_file.cpp:192)
    [uint32 header_offset = 48]
    [4B marker "KMCP"]

.kmc_suf layout:

    [4B marker "KMCS"]
    [records: total_kmers x (sufix_size + counter_size) bytes]
        suffix: (k - lut)/4 bytes, 4 bases each, first base in the two
                MOST significant bits (BinarySearch compares MSB-first,
                kmc_file.cpp:1383-1438)
        counter: little-endian uint32
    [4B marker "KMCS"]

K-mers are sorted ascending as 2-bit MSB-first integers — identical to
our device table order, so serialization is a pure reshape.
"""

from __future__ import annotations

import numpy as np

PRE_MARKER = b"KMCP"
SUF_MARKER = b"KMCS"


def _pick_lut(k: int) -> int:
    """lut prefix length: (k - lut) must be divisible by 4
    (kmc_file.cpp:274); prefer ~9 like kmc for k=25."""
    best = None
    for lut in range(1, k):
        if (k - lut) % 4 == 0:
            if best is None or abs(lut - 9) < abs(best - 9):
                best = lut
    if best is None:
        raise ValueError(f"no valid lut prefix length for k={k}")
    return best


def write_kmc_db(
    prefix: str,
    kmers: np.ndarray,
    counts: np.ndarray,
    k: int,
    min_count: int = 1,
    max_count: int = 10000,
):
    """Serialize a sorted canonical k-mer count table to KMC1 files."""
    km = np.asarray(kmers, dtype=np.uint64)
    ct = np.asarray(counts, dtype=np.uint32)
    assert km.ndim == 1 and km.shape == ct.shape
    n = len(km)
    lut_len = _pick_lut(k)
    suffix_bases = k - lut_len
    sufix_size = suffix_bases // 4
    counter_size = 4

    pre = np.asarray(km >> np.uint64(2 * suffix_bases), dtype=np.int64)
    lut_entries = 1 << (2 * lut_len)
    counts_per_prefix = np.bincount(pre, minlength=lut_entries)
    lut = np.zeros(lut_entries, dtype=np.uint64)
    lut[1:] = np.cumsum(counts_per_prefix[:-1]).astype(np.uint64)

    with open(prefix + ".kmc_pre", "wb") as f:
        f.write(PRE_MARKER)
        f.write(lut.tobytes())
        header = np.zeros(5, dtype=np.uint64)
        header[0] = np.uint64(k)  # mode 0 in high bits
        header[1] = np.uint64(counter_size) | (np.uint64(lut_len) << np.uint64(32))
        header[2] = np.uint64(min_count) | (np.uint64(max_count) << np.uint64(32))
        header[3] = np.uint64(n)
        header[4] = np.uint64(0)  # low nibble 0 => both_strands (canonical)
        f.write(header.tobytes())
        f.write(b"\x00\x00\x00\x00")  # pad
        f.write(np.uint32(0).tobytes())  # kmc_version = KMC1
        f.write(np.uint32(48).tobytes())  # header_offset
        f.write(PRE_MARKER)

    suf = np.asarray(km & np.uint64((1 << (2 * suffix_bases)) - 1), dtype=np.uint64)
    rec = np.empty((n, sufix_size + counter_size), dtype=np.uint8)
    S = 2 * suffix_bases
    for j in range(sufix_size):
        rec[:, j] = ((suf >> np.uint64(S - 8 * (j + 1))) & np.uint64(0xFF)).astype(
            np.uint8
        )
    rec[:, sufix_size:] = ct.view(np.uint8).reshape(n, 4)  # little-endian
    with open(prefix + ".kmc_suf", "wb") as f:
        f.write(SUF_MARKER)
        f.write(rec.tobytes())
        f.write(SUF_MARKER)


# ---------------------------------------------------------------------------
# KMC2 signature (m-mer) computation — exact mirror of KMC/kmc_api/mmer.h
# ---------------------------------------------------------------------------

_NORM_CACHE: dict[int, np.ndarray] = {}


def _mmer_norm_table(sig_len: int) -> np.ndarray:
    """norm[m] for every 2-bit-packed m-mer: min(m, revcomp(m)) with
    disallowed m-mers mapped to the `special` sentinel 4^sig_len
    (CMmer::_si::init_norm + is_allowed, KMC/kmc_api/mmer.h:33-90)."""
    if sig_len in _NORM_CACHE:
        return _NORM_CACHE[sig_len]
    special = np.uint32(1 << (2 * sig_len))
    m = np.arange(1 << (2 * sig_len), dtype=np.uint32)

    def allowed(x: np.ndarray) -> np.ndarray:
        ok = np.ones(x.shape, dtype=bool)
        ok &= (x & 0x3F) != 0x3F  # TTT suffix
        ok &= (x & 0x3F) != 0x3B  # TGT suffix
        ok &= (x & 0x3C) != 0x3C  # TG* suffix
        for j in range(sig_len - 3):  # AA inside
            ok &= ((x >> np.uint32(2 * j)) & 0xF) != 0
        top = x >> np.uint32(2 * (sig_len - 3))  # top 3 symbols
        ok &= top != 0  # AAA prefix
        ok &= top != 0x04  # ACA prefix
        ok &= (top & 0xF) != 0  # *AA prefix
        return ok

    # reverse complement of the packed m-mer
    rev = np.zeros_like(m)
    x = m.copy()
    for i in range(sig_len):
        rev |= (3 - (x & 3)) << np.uint32(2 * (sig_len - 1 - i))
        x >>= np.uint32(2)
    sval = np.where(allowed(m), m, special)
    rval = np.where(allowed(rev), rev, special)
    norm = np.minimum(sval, rval).astype(np.uint32)
    _NORM_CACHE[sig_len] = norm
    return norm


def kmer_signatures(kmers: np.ndarray, k: int, sig_len: int) -> np.ndarray:
    """CKmerAPI::get_signature for every packed k-mer, vectorized
    (KMC/kmc_api/kmer_api.h:653-673): min over all m-mer windows of
    norm[m-mer]."""
    norm = _mmer_norm_table(sig_len)
    km = np.asarray(kmers, dtype=np.uint64)
    mask = np.uint64((1 << (2 * sig_len)) - 1)
    sig = np.full(km.shape, 1 << (2 * sig_len), dtype=np.uint32)
    for i in range(k - sig_len + 1):
        w = ((km >> np.uint64(2 * (k - sig_len - i))) & mask).astype(np.int64)
        sig = np.minimum(sig, norm[w])
    return sig


def write_kmc2_db(
    prefix: str,
    kmers: np.ndarray,
    counts: np.ndarray,
    k: int,
    min_count: int = 1,
    max_count: int = 10000,
    sig_len: int = 7,
    lut_prefix_length: int | None = None,
    n_bins: int = 64,
):
    """Serialize a sorted canonical k-mer table in the KMC2 layout
    (kmc_version 0x200): records grouped by signature bin, per-bin prefix
    LUTs, signature->bin map (KMC/kmc_api/kmc_file.cpp:193-247).

    .kmc_pre layout (decoded from kmc_file.cpp:196-247):
        [4B "KMCP"]
        [per-bin LUTs: n_bins * 4^lut uint64 record-start indices]
        [8B sentinel slot (overwritten in memory with total+1)]
        [signature map: (4^sig_len + 1) uint32 -> bin index]
        [header: k, mode, counter_size, lut_prefix_length, signature_len,
         min_count, max_count (7 x uint32), total_kmers (uint64),
         both_strands (1 byte, stored NEGATED: 0 = canonical)]
        [uint32 kmc_version = 0x200]
        [uint32 header_offset = 41]   # header is 37 bytes + 4
        [4B "KMCP"]
    """
    km = np.asarray(kmers, dtype=np.uint64)
    ct = np.asarray(counts, dtype=np.uint32)
    n = len(km)
    if lut_prefix_length is None:
        lut_prefix_length = _pick_lut_small(k)
    suffix_bases = k - lut_prefix_length
    if suffix_bases % 4:
        raise ValueError("(k - lut_prefix_length) must be divisible by 4")
    sufix_size = suffix_bases // 4
    counter_size = 4
    S = 1 << (2 * lut_prefix_length)

    # signature -> bin map: any consistent assignment is a valid database
    # (the real kmc balances bins by frequency; readers only require that
    # the map agrees with where records were stored)
    sig_entries = (1 << (2 * sig_len)) + 1
    sig_map = (np.arange(sig_entries, dtype=np.uint32) % np.uint32(n_bins)).astype(
        np.uint32
    )

    sigs = kmer_signatures(km, k, sig_len)
    bins = sig_map[sigs]
    order = np.lexsort((km, bins))  # by bin, then k-mer
    km_o = km[order]
    ct_o = ct[order]
    bins_o = bins[order].astype(np.int64)

    pre_o = (km_o >> np.uint64(2 * suffix_bases)).astype(np.int64)
    slot = bins_o * S + pre_o
    counts_per_slot = np.bincount(slot, minlength=n_bins * S)
    lut = np.zeros(n_bins * S, dtype=np.uint64)
    lut[1:] = np.cumsum(counts_per_slot[:-1]).astype(np.uint64)

    with open(prefix + ".kmc_pre", "wb") as f:
        f.write(PRE_MARKER)
        f.write(lut.tobytes())
        f.write(np.uint64(n).tobytes())  # sentinel slot (ignored by readers)
        f.write(sig_map.tobytes())
        header32 = np.array(
            [k, 0, counter_size, lut_prefix_length, sig_len, min_count, max_count],
            dtype=np.uint32,
        )
        f.write(header32.tobytes())
        f.write(np.uint64(n).tobytes())
        f.write(b"\x00")  # both_strands stored negated: 0 => canonical
        f.write(np.uint32(0x200).tobytes())  # kmc_version = KMC2
        f.write(np.uint32(41).tobytes())  # header_offset
        f.write(PRE_MARKER)

    suf = (km_o & np.uint64((1 << (2 * suffix_bases)) - 1)).astype(np.uint64)
    rec = np.empty((n, sufix_size + counter_size), dtype=np.uint8)
    SB = 2 * suffix_bases
    for j in range(sufix_size):
        rec[:, j] = ((suf >> np.uint64(SB - 8 * (j + 1))) & np.uint64(0xFF)).astype(
            np.uint8
        )
    rec[:, sufix_size:] = ct_o.view(np.uint8).reshape(n, 4)
    with open(prefix + ".kmc_suf", "wb") as f:
        f.write(SUF_MARKER)
        f.write(rec.tobytes())
        f.write(SUF_MARKER)


def _pick_lut_small(k: int) -> int:
    """Smallest lut prefix length with (k - lut) % 4 == 0 and lut >= 4
    (keeps n_bins * 4^lut LUTs compact)."""
    for lut in range(4, k):
        if (k - lut) % 4 == 0:
            return lut
    for lut in range(1, k):
        if (k - lut) % 4 == 0:
            return lut
    raise ValueError(f"no valid lut prefix length for k={k}")


def _read_kmc2(prefix: str, pre: bytes):
    """KMC2/KMC3 path of read_kmc_db (kmc_file.cpp:193-247 + CheckKmer's
    bin-start arithmetic :346-355). Records are grouped by signature bin
    on disk; the result is re-sorted globally."""
    filesize = len(pre)
    header_offset = int(np.frombuffer(pre[-8:-4], dtype=np.uint32)[0])
    hstart = filesize - header_offset - 8  # my_fseek(-(header_offset+8), END)
    h32 = np.frombuffer(pre[hstart : hstart + 28], dtype=np.uint32)
    k = int(h32[0])
    mode = int(h32[1])
    counter_size = int(h32[2])
    lut_prefix_length = int(h32[3])
    sig_len = int(h32[4])
    total = int(np.frombuffer(pre[hstart + 28 : hstart + 36], dtype=np.uint64)[0])
    if mode != 0:
        raise ValueError(f"{prefix}: only integer-counter (mode 0) supported")
    sig_map_bytes = ((1 << (2 * sig_len)) + 1) * 4
    size = filesize - 12  # minus markers and header_offset field
    lut_area = size - (sig_map_bytes + header_offset + 8)
    lut = np.frombuffer(pre[4 : 4 + lut_area], dtype=np.uint64)
    suffix_bases = k - lut_prefix_length
    sufix_size = suffix_bases // 4
    S = 1 << (2 * lut_prefix_length)
    if len(lut) % S:
        raise ValueError(f"{prefix}: LUT area not a multiple of 4^lut")

    suffix, cnt = _read_suf_records(prefix, total, sufix_size, counter_size)

    # expand the concatenated per-bin LUTs: records in [lut[e], lut[e+1])
    # carry prefix e % S (bin boundaries preserve global record order)
    starts = np.minimum(lut.astype(np.int64), total)
    reps = np.diff(np.append(starts, total))
    if (reps < 0).any():
        raise ValueError(f"{prefix}: non-monotonic prefix LUT")
    prefixes = np.repeat(
        (np.arange(len(lut), dtype=np.uint64) % np.uint64(S)), reps
    )
    km = (prefixes << np.uint64(2 * suffix_bases)) | suffix
    order = np.argsort(km, kind="stable")
    return km[order], cnt[order].astype(np.int64), k


def _read_suf_records(prefix: str, total: int, sufix_size: int, counter_size: int):
    with open(prefix + ".kmc_suf", "rb") as f:
        suf = f.read()
    if suf[:4] != SUF_MARKER or suf[-4:] != SUF_MARKER:
        raise ValueError(f"{prefix}.kmc_suf: bad markers")
    rec = np.frombuffer(suf[4:-4], dtype=np.uint8).reshape(
        total, sufix_size + counter_size
    )
    suffix = np.zeros(total, dtype=np.uint64)
    for j in range(sufix_size):
        suffix = (suffix << np.uint64(8)) | rec[:, j].astype(np.uint64)
    cbytes = rec[:, sufix_size:]
    counts = np.zeros(total, dtype=np.uint64)
    for b in range(counter_size):
        counts |= cbytes[:, b].astype(np.uint64) << np.uint64(8 * b)
    return suffix, counts


def read_kmc_db(prefix: str):
    """Read a KMC database (KMC1 or KMC2/KMC3 layout) into
    (sorted kmers uint64, counts int64, k)."""
    with open(prefix + ".kmc_pre", "rb") as f:
        pre = f.read()
    if pre[:4] != PRE_MARKER or pre[-4:] != PRE_MARKER:
        raise ValueError(f"{prefix}.kmc_pre: bad markers")
    kmc_version = int(np.frombuffer(pre[-12:-8], dtype=np.uint32)[0])
    if kmc_version == 0x200:
        return _read_kmc2(prefix, pre)
    if kmc_version != 0:
        raise ValueError(
            f"{prefix}: unsupported KMC database version {kmc_version:#x}"
        )
    header_offset = int(np.frombuffer(pre[-8:-4], dtype=np.uint32)[0])
    body = pre[4:-4]
    size = len(body) - 4  # mirrors kmc_file.cpp:203/259
    header_start = size - header_offset
    header = np.frombuffer(body[header_start : header_start + 40], dtype=np.uint64)
    k = int(header[0] & np.uint64(0xFFFFFFFF))
    counter_size = int(header[1] & np.uint64(0xFFFFFFFF))
    lut_len = int(header[1] >> np.uint64(32))
    total = int(header[3])
    lut = np.frombuffer(body[:header_start], dtype=np.uint64)
    suffix_bases = k - lut_len
    sufix_size = suffix_bases // 4

    suffix, counts = _read_suf_records(prefix, total, sufix_size, counter_size)

    # expand LUT back to per-kmer prefixes
    starts = lut.astype(np.int64)
    reps = np.diff(np.append(starts, total))
    prefixes = np.repeat(np.arange(len(lut), dtype=np.uint64), reps)
    km = (prefixes << np.uint64(2 * suffix_bases)) | suffix
    return km, counts.astype(np.int64), k

# Copied from ploidyfrost_tpu/io/bfg.py; imports point at this package.
"""Bifrost `.bfg_colors` binary format: reader + writer.

Interop layer with the reference stack. PloidyFrost's colored mode reads
a Bifrost colored graph: GFA (S lines carry a DA:Z:<id> DataAccessor
tag) + a `.bfg_colors` color store (ColoredCDBG::read,
bifrost/src/ColoredCDBG.tcc:428-560). This module lets us

  (a) WRITE our ColorMatrix so the reference binary runs on OUR colored
      graphs (the colored golden-parity tests), and
  (b) READ Bifrost-produced color files so reference users can switch.

Format (BFG_COLOREDCDBG_FORMAT_VERSION 2, decoded from
DataStorage::write/read, bifrost/src/DataStorage.tcc:532-659/790-1000):

    u64 format_version | nb_seeds | nb_colors | nb_cs | sz_cs |
        sz_shared_cs | overflow_sz
    u64 seeds[nb_seeds]
    u64 block_sz (1024)
    streampos block_positions[ceil(sz_shared_cs/bsz) + ceil(sz_cs/bsz)]
        (16 bytes each on linux libstdc++: i64 offset + 8 zero bytes)
    color names, '\n'-terminated
    u64 unitig_cs_link[ceil(sz_cs/64)]   (bit = slot occupied)
    sz_shared_cs x (UnitigColors + u64 refcount)
    sz_cs x UnitigColors
    overflow_sz x (Kmer bytes[8] + u64 unitig_size + u64 slot)

A unitig's color set lives at slot wyhash(head_kmer_bytes, seeds[da-1])
% nb_cs where `da` is the GFA DA:Z tag (DataStorage::getUnitigColors,
DataStorage.tcc:366-384); da == 0 routes through the overflow map
keyed by (head k-mer, unitig length).

UnitigColors wire format (UnitigColors::write/read,
bifrost/src/ColorSet.cpp:1174-1276): a u64 `setBits` whose low 3 bits
select the representation (ColorSet.cpp:1601-1613):

    0 localTinyBitmap  -> TinyBitmap payload follows
    1 localBitVector   -> bits 3..63 are a presence bitvector
    2 localSingleInt   -> bits 3..63 are the single ck id
    3 ptrBitmap        -> bits 3..34 = byte size; portable Roaring follows
    4 ptrUnitigColors  -> two nested UnitigColors follow
                          (uc[0] = full colors in color-id space,
                           uc[1] = remaining pairs; ColorSet.cpp:780-785)
    5 ptrSharedUnitigColors -> index into the shared sets array

ck id = color * num_kmers + position (UnitigColors iterator,
ColorSet.hpp:70-77).
"""

from __future__ import annotations

import struct

import numpy as np

U64 = np.uint64
_MASK = (1 << 64) - 1

# wyhash final v3 default secret (bifrost/src/wyhash.h _wyp)
_WYP = (
    0xA0761D6478BD642F,
    0xE7037ED1A0B428DB,
    0x8EBC6AF09C88C6E3,
    0x589965CC75374CC3,
)


def _wymum(a: int, b: int) -> tuple[int, int]:
    r = (a & _MASK) * (b & _MASK)
    return r & _MASK, (r >> 64) & _MASK


def _wymix(a: int, b: int) -> int:
    a, b = _wymum(a, b)
    return a ^ b


def wyhash8(data: bytes, seed: int) -> int:
    """wyhash final v3 of an 8-byte key (bifrost/src/wyhash.h:117-140,
    Kmer::hash path for MAX_K=32, Kmer.hpp:120-123)."""
    assert len(data) == 8
    seed ^= _WYP[0]
    r4 = struct.unpack("<II", data)
    a = ((r4[0] << 32) | r4[1]) & _MASK
    b = ((r4[1] << 32) | r4[0]) & _MASK
    return _wymix(_WYP[1] ^ 8, _wymix(a ^ _WYP[1], b ^ (seed & _MASK)))


def kmer_head_bytes(seq: str, k: int) -> bytes:
    """Bifrost Kmer byte image of the first k bases: 2-bit codes packed
    MSB-first into a u64 (Kmer::set_kmer, bifrost/src/Kmer.cpp:92-107),
    little-endian bytes (the `bytes` union member, Kmer.hpp:209-213)."""
    v = 0
    code = {"A": 0, "C": 1, "G": 2, "T": 3}
    for c in seq[:k]:
        v = (v << 2) | code[c]
    v <<= 64 - 2 * k
    return struct.pack("<Q", v)


# -- portable Roaring codec ---------------------------------------------------

_SERIAL_COOKIE_NO_RUN = 12346
_SERIAL_COOKIE = 12347
_NO_OFFSET_THRESHOLD = 4


def roaring_serialize(values: np.ndarray) -> bytes:
    """Portable-format serialization of a sorted uint32 set
    (CRoaring roaring_bitmap_portable_serialize; array/bitset
    containers only)."""
    values = np.asarray(values, dtype=np.uint32)
    keys = (values >> np.uint32(16)).astype(np.uint16)
    lows = (values & np.uint32(0xFFFF)).astype(np.uint16)
    uk, starts = np.unique(keys, return_index=True)
    starts = np.append(starts, len(values))
    n = len(uk)
    out = bytearray()
    out += struct.pack("<II", _SERIAL_COOKIE_NO_RUN, n)
    containers = []
    for i in range(n):
        vals = lows[starts[i] : starts[i + 1]]
        card = len(vals)
        out += struct.pack("<HH", int(uk[i]), card - 1)
        if card <= 4096:
            containers.append(vals.tobytes())
        else:
            bits = np.zeros(1024, dtype=np.uint64)
            v = vals.astype(np.uint64)
            np.bitwise_or.at(bits, (v >> U64(6)).astype(int), U64(1) << (v & U64(63)))
            containers.append(bits.tobytes())
    # offsets (always present in the no-run format)
    pos = len(out) + 4 * n
    for c in containers:
        out += struct.pack("<I", pos)
        pos += len(c)
    for c in containers:
        out += c
    return bytes(out)


def roaring_deserialize(buf: bytes) -> np.ndarray:
    """Portable-format Roaring -> sorted uint32 array (array, bitset and
    run containers)."""
    cookie = struct.unpack_from("<I", buf, 0)[0]
    off = 4
    run_flags = None
    if (cookie & 0xFFFF) == _SERIAL_COOKIE:
        n = (cookie >> 16) + 1
        nb = (n + 7) // 8
        run_flags = np.unpackbits(
            np.frombuffer(buf, dtype=np.uint8, count=nb, offset=off),
            bitorder="little",
        )[:n].astype(bool)
    elif cookie == _SERIAL_COOKIE_NO_RUN:
        n = struct.unpack_from("<I", buf, off)[0]
        off += 4
        run_flags = np.zeros(n, dtype=bool)
    else:
        raise ValueError(f"bad roaring cookie {cookie}")
    keys = np.zeros(n, dtype=np.uint32)
    cards = np.zeros(n, dtype=np.int64)
    for i in range(n):
        k_, c_ = struct.unpack_from("<HH", buf, off)
        keys[i] = k_
        cards[i] = c_ + 1
        off += 4
    if cookie == _SERIAL_COOKIE_NO_RUN or n >= _NO_OFFSET_THRESHOLD:
        off += 4 * n  # skip offsets
    parts = []
    for i in range(n):
        hi = np.uint32(keys[i]) << np.uint32(16)
        if run_flags[i]:
            n_runs = struct.unpack_from("<H", buf, off)[0]
            off += 2
            runs = np.frombuffer(buf, dtype=np.uint16, count=2 * n_runs, offset=off)
            off += 4 * n_runs
            vals = np.concatenate(
                [
                    np.arange(runs[2 * j], int(runs[2 * j]) + int(runs[2 * j + 1]) + 1)
                    for j in range(n_runs)
                ]
            ).astype(np.uint32)
        elif cards[i] <= 4096:
            vals = np.frombuffer(
                buf, dtype=np.uint16, count=int(cards[i]), offset=off
            ).astype(np.uint32)
            off += 2 * int(cards[i])
        else:
            bits = np.frombuffer(buf, dtype=np.uint64, count=1024, offset=off)
            off += 8192
            vals = np.nonzero(
                np.unpackbits(
                    bits.view(np.uint8), bitorder="little"
                )
            )[0].astype(np.uint32)
        parts.append(hi | vals)
    if not parts:
        return np.zeros(0, dtype=np.uint32)
    return np.concatenate(parts)


# -- UnitigColors codec --------------------------------------------------------

_FLAG_TINY = 0
_FLAG_BITVEC = 1
_FLAG_SINGLE = 2
_FLAG_BITMAP = 3
_FLAG_NESTED = 4
_FLAG_SHARED = 5


def encode_unitig_colors(ck_ids: np.ndarray) -> bytes:
    """Serialize a set of ck ids as a UnitigColors, choosing among the
    pointer-free representations (bitvector / single int / Roaring)."""
    ck_ids = np.asarray(ck_ids, dtype=np.uint64)
    if len(ck_ids) == 0:
        return struct.pack("<Q", _FLAG_BITVEC)
    if len(ck_ids) == 1 and int(ck_ids[0]) < (1 << 61):
        return struct.pack("<Q", (int(ck_ids[0]) << 3) | _FLAG_SINGLE)
    if int(ck_ids.max()) < 61:
        bits = 0
        for v in ck_ids:
            bits |= 1 << (int(v) + 3)
        return struct.pack("<Q", bits | _FLAG_BITVEC)
    assert int(ck_ids.max()) < (1 << 32), "ck id exceeds Roaring range"
    ser = roaring_serialize(ck_ids.astype(np.uint32))
    return struct.pack("<Q", (len(ser) << 3) | _FLAG_BITMAP) + ser


def _decode_tinybitmap(stream) -> np.ndarray:
    """TinyBitmap payload -> sorted uint32 values (TinyBitmap::write/
    read + contains, bifrost/src/TinyBitmap.cpp:282-334, 825-880)."""
    header = struct.unpack("<H", stream.read(2))[0]
    sz = header >> 3
    if sz == 0:
        return np.zeros(0, dtype=np.uint32)
    words = np.frombuffer(stream.read(2 * (sz - 1)), dtype=np.uint16)
    mode = header & 0x0006
    cardinality = int(words[0])
    offset = np.uint32(words[1]) << np.uint32(16)
    if cardinality == 0:
        return np.zeros(0, dtype=np.uint32)
    if mode == 0x0000:  # bmp_mode
        bits = words[2:]
        vals = np.nonzero(
            np.unpackbits(bits.view(np.uint8), bitorder="little")
        )[0].astype(np.uint32)
    elif mode == 0x0002:  # list_mode
        vals = words[2 : 2 + cardinality].astype(np.uint32)
    else:  # rle_list_mode: inclusive (start, end) pairs
        runs = words[2 : 2 + cardinality]
        vals = np.concatenate(
            [
                np.arange(runs[2 * j], int(runs[2 * j + 1]) + 1)
                for j in range(cardinality // 2)
            ]
        ).astype(np.uint32)
    return offset | vals


def decode_unitig_colors(stream, shared=None) -> np.ndarray:
    """Deserialize one UnitigColors -> sorted uint64 ck ids.

    For the nested (flag 4) representation, full colors (color-id space)
    are returned as-is in ck space via a sentinel-free convention: the
    caller expands them (see read_bfg_colors); here they are returned as
    a pair encoded in a structured way.
    """
    ck, full = _decode_uc(stream, shared)
    if len(full):
        raise ValueError("nested full colors must be expanded by caller")
    return ck


def _decode_uc(stream, shared=None):
    """-> (ck ids array, full-color ids array)."""
    setbits = struct.unpack("<Q", stream.read(8))[0]
    flag = setbits & 0x7
    if flag == _FLAG_BITVEC:
        vals = np.nonzero(
            [(setbits >> (3 + i)) & 1 for i in range(61)]
        )[0].astype(np.uint64)
        return vals, np.zeros(0, dtype=np.uint64)
    if flag == _FLAG_SINGLE:
        return np.array([setbits >> 3], dtype=np.uint64), np.zeros(0, np.uint64)
    if flag == _FLAG_BITMAP:
        sz = (setbits >> 3) & 0xFFFFFFFF
        ser = stream.read(sz)
        return roaring_deserialize(ser).astype(np.uint64), np.zeros(0, np.uint64)
    if flag == _FLAG_TINY:
        return _decode_tinybitmap(stream).astype(np.uint64), np.zeros(0, np.uint64)
    if flag == _FLAG_NESTED:
        full, f0 = _decode_uc(stream, shared)
        part, f1 = _decode_uc(stream, shared)
        if len(f0) or len(f1):
            raise ValueError("doubly-nested UnitigColors")
        return part, full
    if flag == _FLAG_SHARED:
        raise ValueError(
            "shared UnitigColors reference outside shared table"
        )
    raise ValueError(f"unknown UnitigColors flag {flag}")


# -- file-level writer ---------------------------------------------------------


def write_bfg_colors(
    path: str, g, colors, nb_seeds: int = 16, seed0: int = 0x9E3779B97F4A7C15
):
    """Write {path} (.bfg_colors) for CDBGraph `g` + ColorMatrix
    `colors`. Returns the per-unitig DA ids to embed as GFA DA:Z tags
    (0 = overflow)."""
    n = len(g.seqs)
    k = g.k
    # deterministic seeds (the reference generates them randomly at
    # construction and persists them; any values work for readers)
    seeds = [(seed0 * (i + 1)) & _MASK for i in range(nb_seeds)]
    nb_cs = max(64, 1 << int(np.ceil(np.log2(max(2 * n, 1)))))
    sz_cs = nb_cs
    heads = [kmer_head_bytes(s, k) for s in g.seqs]
    slot_of = np.full(n, -1, dtype=np.int64)
    da_ids = np.zeros(n, dtype=np.int64)
    used = np.zeros(sz_cs, dtype=bool)
    overflow: list[tuple[bytes, int, int]] = []
    free_scan = 0
    for i in range(n):
        placed = False
        for d in range(1, nb_seeds + 1):
            slot = wyhash8(heads[i], seeds[d - 1]) % nb_cs
            if not used[slot]:
                used[slot] = True
                slot_of[i] = slot
                da_ids[i] = d
                placed = True
                break
        if not placed:
            while used[free_scan]:
                free_scan += 1
            used[free_scan] = True
            slot_of[i] = free_scan
            da_ids[i] = 0
            overflow.append((heads[i], len(g.seqs[i]), free_scan))
    # per-unitig ck id sets
    num_km = np.diff(colors.offsets)
    payloads = {}
    for i in range(n):
        ub = colors.unitig_bits(i)  # [len, C]
        pos, col = np.nonzero(ub)
        ck = col.astype(np.uint64) * U64(num_km[i]) + pos.astype(np.uint64)
        payloads[int(slot_of[i])] = encode_unitig_colors(np.sort(ck))
    empty = encode_unitig_colors(np.zeros(0, dtype=np.uint64))

    block_sz = 1024
    nb_pos_cs = (sz_cs + block_sz - 1) // block_sz
    link = np.zeros((sz_cs + 63) // 64, dtype=np.uint64)
    w = np.nonzero(used)[0]
    np.bitwise_or.at(link, w // 64, U64(1) << (w % 64).astype(np.uint64))

    with open(path, "wb") as f:
        f.write(
            struct.pack(
                "<7Q", 2, nb_seeds, colors.n_colors, nb_cs, sz_cs, 0, len(overflow)
            )
        )
        f.write(struct.pack(f"<{nb_seeds}Q", *seeds))
        f.write(struct.pack("<Q", block_sz))
        pos_f_cs = f.tell()
        f.write(b"\x00" * (16 * nb_pos_cs))  # placeholder streampos array
        for name in colors.names:
            f.write(name.encode() + b"\n")
        f.write(link.tobytes())
        block_positions = []
        for i in range(sz_cs):
            if i % block_sz == 0:
                block_positions.append(f.tell())
            f.write(payloads.get(i, empty))
        for head, usz, slot in overflow:
            f.write(head)
            f.write(struct.pack("<QQ", usz, slot))
        f.seek(pos_f_cs)
        for bp in block_positions:
            f.write(struct.pack("<qQ", bp, 0))  # streampos: offset + mbstate
    return [int(d) for d in da_ids]


def read_bfg_colors(path: str, g):
    """Read a .bfg_colors + the DA tags already parsed into g.da_ids
    (CDBGraph.from_gfa) -> ColorMatrix."""
    from ..graph.colors import ColorMatrix

    da_ids = getattr(g, "da_ids", None)
    if da_ids is None or any(d is None for d in da_ids):
        raise SystemExit(
            "ColoredCDBG::read(): One sequence line in GFA file has no "
            "DataAccessor tag. Operation aborted."
        )
    with open(path, "rb") as f:
        (version, nb_seeds, nb_colors, nb_cs, sz_cs, sz_shared_cs, overflow_sz) = (
            struct.unpack("<7Q", f.read(56))
        )
        if nb_seeds >= 256:
            raise SystemExit(
                "DataStorage::read(): Does not support more than 255 hash seeds"
            )
        seeds = struct.unpack(f"<{nb_seeds}Q", f.read(8 * nb_seeds))
        if version >= 2:
            block_sz = struct.unpack("<Q", f.read(8))[0]
            nb_pos = (sz_shared_cs + block_sz - 1) // block_sz + (
                sz_cs + block_sz - 1
            ) // block_sz
            f.read(16 * nb_pos)
        names = [
            f.readline().rstrip(b"\n").decode() for _ in range(nb_colors)
        ]
        f.read(8 * ((sz_cs + 63) // 64))  # unitig_cs_link
        shared: list[tuple[np.ndarray, np.ndarray]] = []
        for _ in range(sz_shared_cs):
            ck, full = _decode_uc(f)
            f.read(8)  # refcount
            shared.append((ck, full))
        sets: list[tuple[np.ndarray, np.ndarray] | int] = []
        for _ in range(sz_cs):
            pos0 = f.tell()
            setbits = struct.unpack("<Q", f.read(8))[0]
            f.seek(pos0)
            if (setbits & 0x7) == _FLAG_SHARED:
                f.read(8)
                sets.append(int(setbits >> 3))  # shared index
            else:
                sets.append(_decode_uc(f))
        overflow: dict[tuple[bytes, int], int] = {}
        for _ in range(overflow_sz):
            head = f.read(8)
            usz, slot = struct.unpack("<QQ", f.read(16))
            overflow[(head, usz)] = slot
    # join color sets to unitigs
    k = g.k
    lens = np.array([len(s) - k + 1 for s in g.seqs], dtype=np.int64)
    offs = np.zeros(len(lens) + 1, dtype=np.int64)
    np.cumsum(lens, out=offs[1:])
    bits = np.zeros((int(offs[-1]), nb_colors), dtype=bool)
    full_counts = np.zeros(len(g.seqs), dtype=np.int64)
    for i, s in enumerate(g.seqs):
        head = kmer_head_bytes(s, k)
        da = int(da_ids[i])
        if da == 0:
            slot = overflow.get((head, len(s)))
            if slot is None:
                continue
        else:
            slot = wyhash8(head, seeds[da - 1]) % nb_cs
        cs = sets[slot]
        if isinstance(cs, int):
            cs = shared[cs]
        ck, full = cs
        L = int(lens[i])
        full_counts[i] = len(full)
        if len(full):
            for c in full:
                bits[offs[i] : offs[i + 1], int(c)] = True
        if len(ck):
            pos = (ck % U64(L)).astype(np.int64)
            col = (ck // U64(L)).astype(np.int64)
            bits[offs[i] + pos, col] = True
    return ColorMatrix(offs, bits, names, full_counts)

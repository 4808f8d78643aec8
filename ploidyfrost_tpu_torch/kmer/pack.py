# numpy helpers copied from ploidyfrost_tpu/kmer/pack.py; the device ops are torch ports.
"""2-bit k-mer packing, reverse complement, canonicalization.

Replaces the roles of bifrost/src/Kmer.hpp:4-120 (2-bit packed k-mer,
twin/rep canonicalization) and KMC/kmc_api/kmer_api.h:433-486
(from_string / reverse / to_string).

Encoding: A=0, C=1, G=2, T=3 (the shared KMC/Bifrost base encoding,
bifrost/src/Common.hpp:34). A k-mer is one 64-bit word with the FIRST
base in the most-significant occupied bits, so integer order ==
lexicographic string order — which makes `min(fwd, revcomp)`
canonicalization agree with KMC's canonical k-mer choice.

k <= 31 is supported in one word (the reference pipeline uses k=25,
script/pipeline/2.kmc_db:12), so a packed k-mer fits in 62 bits. The
host helpers keep numpy uint64 (the public key type); the torch ops use
int64, the widest integer type torch supports fully. Invalid windows
carry SENTINEL = INT64_MAX, which sorts after every real key.
"""

from __future__ import annotations

import numpy as np
import torch

# base codes: 0..3 = ACGT, INVALID_BASE marks N/other and padding
INVALID_BASE = np.uint8(4)

_CODE_TABLE = np.full(256, INVALID_BASE, dtype=np.uint8)
for _i, _c in enumerate("ACGT"):
    _CODE_TABLE[ord(_c)] = _i
    _CODE_TABLE[ord(_c.lower())] = _i

_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def encode_bases(seq: bytes | str | np.ndarray) -> np.ndarray:
    """ASCII sequence -> uint8 base codes (host-side, vectorized)."""
    if isinstance(seq, str):
        seq = seq.encode()
    arr = np.frombuffer(seq, dtype=np.uint8) if isinstance(seq, bytes) else seq
    return _CODE_TABLE[arr]


def decode_bases(codes: np.ndarray) -> str:
    return _BASES[np.asarray(codes)].tobytes().decode()


def encode_kmer_string(s: str) -> int:
    """Pack one k-mer string into a python int (for tests / tiny paths)."""
    v = 0
    for c in s:
        v = (v << 2) | int(_CODE_TABLE[ord(c)])
    return v


def decode_kmers(kmers, k: int) -> list[str]:
    """uint64 array -> k-mer strings (host-side)."""
    kmers = np.asarray(kmers, dtype=np.uint64)
    out = []
    for v in kmers:
        v = int(v)
        out.append("".join("ACGT"[(v >> (2 * (k - 1 - i))) & 3] for i in range(k)))
    return out


def revcomp_np(kmers: np.ndarray, k: int) -> np.ndarray:
    """Host (numpy) reverse complement of packed k-mers."""
    x = (~np.asarray(kmers, dtype=np.uint64)).astype(np.uint64)
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


def canonical_np(kmers: np.ndarray, k: int) -> np.ndarray:
    km = np.asarray(kmers, dtype=np.uint64)
    return np.minimum(km, revcomp_np(km, k))


def sequence_kmers_np(codes: np.ndarray, k: int):
    """Host (numpy) variant of sequence_kmers for a single [L] code
    array: returns (kmers [L-k+1] uint64, valid bool). Used by the
    host-side string paths (window/unitig coverage) where per-length jit
    compiles would dominate."""
    codes = np.asarray(codes)
    L = codes.shape[-1]
    n = L - k + 1
    acc = np.zeros(n, dtype=np.uint64)
    for j in range(k):
        acc = (acc << np.uint64(2)) | (
            codes[j : j + n].astype(np.uint64) & np.uint64(3)
        )
    bad = (codes >= INVALID_BASE).astype(np.int32)
    cum = np.cumsum(bad)
    hi = cum[k - 1 :]
    lo = np.concatenate([[0], cum[: n - 1]])
    return acc, (hi - lo) == 0


def string_kmers_np(s: str, k: int) -> np.ndarray:
    """All (forward-strand) k-mers of an ACGT string, host-side."""
    km, valid = sequence_kmers_np(encode_bases(s), k)
    if not valid.all():
        raise ValueError(f"invalid base in sequence {s[:50]!r}")
    return km


SENTINEL = torch.iinfo(torch.int64).max


def revcomp_kmers(kmers: torch.Tensor, k: int) -> torch.Tensor:
    """Reverse complement of int64 packed k-mers, vectorized bit-twiddling.

    Complement = ~x (2-bit codes are complement-symmetric: A<->T 0<->3,
    C<->G 1<->2), then reverse the 2-bit groups within the 64-bit word,
    then shift down so the k-mer occupies the low 2k bits. Right shifts
    of int64 are arithmetic, so every shift is followed by a mask that
    clears the sign-extended bits.
    """
    x = ~kmers.to(torch.int64)
    for shift, mask in (
        (2, 0x3333333333333333),
        (4, 0x0F0F0F0F0F0F0F0F),
        (8, 0x00FF00FF00FF00FF),
        (16, 0x0000FFFF0000FFFF),
    ):
        x = ((x >> shift) & mask) | ((x & mask) << shift)
    x = ((x >> 32) & 0xFFFFFFFF) | (x << 32)
    return (x >> (64 - 2 * k)) & ((1 << (2 * k)) - 1)


def canonical_kmers(kmers: torch.Tensor, k: int) -> torch.Tensor:
    """min(k-mer, revcomp) — matches KMC canonical-form counting."""
    km = kmers.to(torch.int64)
    return torch.minimum(km, revcomp_kmers(km, k))


def sequence_kmers(codes: torch.Tensor, k: int):
    """All k-mers of a code sequence.

    codes: [..., L] uint8 (0..3 valid, INVALID_BASE for N/padding)
    returns (kmers [..., L-k+1] int64, valid [..., L-k+1] bool)
    """
    L = codes.shape[-1]
    n = L - k + 1
    acc = torch.zeros(codes.shape[:-1] + (n,), dtype=torch.int64, device=codes.device)
    for j in range(k):
        acc = (acc << 2) | (codes[..., j : j + n].to(torch.int64) & 3)
    cum = torch.cumsum((codes >= int(INVALID_BASE)).to(torch.int32), dim=-1)
    # window [i, i+k) contains an invalid base iff cum[i+k-1] - cum[i-1] > 0
    hi = cum[..., k - 1 :]
    lo = torch.nn.functional.pad(cum[..., : n - 1], (1, 0))
    return acc, (hi - lo) == 0


def batch_kmers(codes: torch.Tensor, k: int):
    """Canonical k-mers of a batch of padded reads.

    codes: [B, L] uint8. Returns (canon [B, L-k+1] int64, valid bool).
    """
    kmers, valid = sequence_kmers(codes, k)
    return canonical_kmers(kmers, k), valid

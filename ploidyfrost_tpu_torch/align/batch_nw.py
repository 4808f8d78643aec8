# Ported from ploidyfrost_tpu/align/batch_nw.py: _build_kernel as a CUDA kernel
# (csrc/nw_wavefront.cu) with a torch loop as its plain version.
"""Batched Needleman-Wunsch for the analysis phase.

The reference computes one DP matrix per branch pair, inside the
per-bubble loop (src/SeqAlign.cpp:480-549). Here every first-pair DP of
an analysis phase is computed in one call, by the first engine that can:

  1. the native flag kernel (native/nw_flags.cpp, host C++);
  2. the device wavefront below, on the device the caller holds;
  3. the per-pair numpy wavefront of align/nw.py (any scoring).

`ENGINE_CALLS` counts which engine produced the matrices of each
`needleman_wunsch_batch` call. The host co-optimal traceback per pair
follows in every case.

The lanes are not split over the ranks of a --devices run
(parallel/mesh.py): every rank keeps this engine order on its own
device. The JAX package shards them over its mesh only inside one
process and drops the mesh as soon as it runs in several
(ploidyfrost_tpu/align/batch_nw.py:267-275); every run of this package
on more than one device is several processes.

The device wavefront runs all pairs of a size tier at once, a chunk a
call (`nw_wavefront`): over the 2T+1 anti-diagonals of a [lanes, T+1]
skewed layout, each step computing one anti-diagonal of every pair, so
the sequential DP dependency runs once while the batch fills the device.
On a card a chunk is one launch of the hand-written kernel
csrc/nw_wavefront.cu (one warp a pair, the diagonals' scores and flag
words in shared memory, each flag row packed by ballot; `NW_LAUNCHES`
counts the launches); on the CPU the plain version `_wavefront` runs, a
torch loop of about 30 small ops a step. Both reproduce nw._nw_matrix's
integer semantics bit for bit (the same flag matrices the co-optimal
traceback consumes):
  * +1 continuation bonus per direction (src/SeqAlign.cpp:512-525);
  * forbidden Left move into a next-char-of-A '-' (:528-532);
  * integer score cells (the C++ int truncation is exact when the
    match/mismatch/gap parameters are integers, the only case the
    wavefront accepts).

Output layout: one bit-packed flag row per diagonal d, with
ys[lane, f, d, i] = flag f (0 Up, 1 LeftUp, 2 Left) of DP cell
(i, d - i). The host de-skews each pair's (m+1, n+1) window with one
fancy gather. Cells outside a pair's valid region are garbage and never
read (the DP recurrence only flows from lower (i, j), so in-region
values are unaffected by padding); the kernel and the plain version
compute the same garbage.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

DASH = 4  # '-' code; base codes 0..3; pad code 7 (never equals DASH)
_PAD = 7
_MIN_TIER = 16
_MAX_TIER = 2048
_CELL_BUDGET = 96 << 20  # device bytes for one chunk's stacked flags

_ENC = np.full(256, 5, dtype=np.uint8)
_ENC[ord("A")] = 0
_ENC[ord("C")] = 1
_ENC[ord("G")] = 2
_ENC[ord("T")] = 3
_ENC[ord("-")] = DASH

# needleman_wunsch_batch calls by the engine that produced the matrices
ENGINE_CALLS = {"native": 0, "device": 0, "numpy": 0}

# launches of csrc/nw_wavefront.cu made by `nw_wavefront` (plain int; a
# run sets it to 0 and reads it back to show the wavefront went through
# the kernel)
NW_LAUNCHES = 0
_INT32_MIN, _INT32_MAX = -(1 << 31), (1 << 31) - 1

_lock = threading.Lock()
_fn = None  # the kernel's entry point, bound at first launch


def _tier_of(m: int, n: int) -> int:
    t = _MIN_TIER
    need = max(m, n)
    while t < need:
        t <<= 1
    return t


def _chunk_of(tier: int) -> int:
    lane_bytes = 3 * (2 * tier + 1) * ((tier + 2 + 7) // 8)
    ch = _CELL_BUDGET // lane_bytes
    ch = 1 << max(int(ch).bit_length() - 1, 0)
    return int(min(4096, max(8, ch)))


def _wavefront(a, b, a_len, match: int, dis: int, gap: int):
    """The anti-diagonal wavefront of one chunk, plain version (a torch
    loop over the diagonals): the arguments and result of
    `nw_wavefront`. Nothing is read back inside the loop."""
    import torch

    dev = a.device
    CH, T = a.shape
    W8 = (T + 2 + 7) // 8  # bytes per bit-packed flag row
    i32 = torch.int32
    m_ = torch.tensor(match, dtype=i32, device=dev)
    d_ = torch.tensor(dis, dtype=i32, device=dev)
    g_ = torch.tensor(gap, dtype=i32, device=dev)
    i32min = torch.tensor(-(2**31), dtype=i32, device=dev)

    iota = torch.arange(T + 1, dtype=i32, device=dev)
    pad_col = torch.full((CH, 1), _PAD, dtype=torch.uint8, device=dev)
    a_at = torch.cat([pad_col, a], dim=1)  # a_at[:, i] = A[i-1]
    a_next = torch.cat([a, pad_col], dim=1)  # a_next[:, i] = A[i]
    a_dash = a_at == DASH
    # the forbidden-Left rule can fire at row i when i != m and A[i] == '-'
    may_forbid = (iota[None, :] != a_len) & (a_next == DASH)
    # B along diagonal d is b[:, clip(d - 1 - i, 0, T - 1)] for i in
    # 0..T: a window of the reversed B, padded with its end values, that
    # slides one column a step (a view, no gather)
    rb = b.flip(1)
    b_win = torch.cat(
        [rb[:, :1].expand(CH, T), rb, rb[:, -1:].expand(CH, T + 1)], dim=1
    )
    b_win_dash = b_win == DASH
    bitw = torch.tensor([1, 2, 4, 8, 16, 32, 64, 128], dtype=torch.uint8, device=dev)
    zero_col = torch.zeros((CH, 1), dtype=i32, device=dev)

    def shift(x):
        # x[:, i-1] at column i, 0 at column 0
        return torch.cat([zero_col, x[:, :-1]], dim=1)

    sc1 = sc2 = torch.zeros((CH, T + 1), dtype=i32, device=dev)
    ys = torch.empty((2 * T + 1, 3, CH, W8), dtype=torch.uint8, device=dev)
    # flag rows of this step and the two before it, in turns; the
    # columns past T stay 0 and pad each row to whole bytes
    rows = [torch.zeros((3, CH, W8 * 8), dtype=torch.bool, device=dev) for _ in range(3)]
    for d in range(2 * T + 1):
        flags, prev, prev2 = rows[d % 3], rows[(d - 1) % 3], rows[(d - 2) % 3]
        up1, lu2, lf1 = prev[0, :, : T + 1], prev2[1, :, : T + 1], prev[2, :, : T + 1]
        lo = 2 * T - d
        sub = torch.where(
            a_at == b_win[:, lo : lo + T + 1],
            m_,
            torch.where(a_dash | b_win_dash[:, lo : lo + T + 1], g_, d_),
        )
        # a set flag of the cell a move comes from is the +1 bonus
        up = shift(sc1 + up1) + gap
        left = sc1 + lf1 + gap
        lu = shift(sc2 + lu2) + sub
        up_lu = torch.maximum(up, lu)
        mx = torch.maximum(up_lu, left)
        forbid = (mx == left) & may_forbid
        left = torch.where(forbid, i32min, left)
        mx = torch.where(forbid, up_lu, mx)
        upf, luf, lff = (flags[f, :, : T + 1] for f in range(3))
        torch.eq(up, mx, out=upf)
        torch.eq(lu, mx, out=luf)
        torch.eq(left, mx, out=lff)
        # boundary cells: column 0 is cell (0, d), column d is cell (d, 0)
        sc = mx
        sc[:, 0] = gap * d
        upf[:, 0] = False
        luf[:, 0] = False
        lff[:, 0] = d > 0
        if 0 < d <= T:
            sc[:, d] = gap * d
            upf[:, d] = True
            luf[:, d] = False
            lff[:, d] = False
        # [3, CH, W8 * 8] bool -> [3, CH, W8] uint8, little-endian bits
        torch.sum(
            flags.view(3, CH, W8, 8).to(torch.uint8) * bitw,
            dim=3,
            dtype=torch.uint8,
            out=ys[d],
        )
        sc2, sc1 = sc1, sc
    # [2T+1, 3, CH, W8] -> [CH, 3, 2T+1, W8]: one contiguous block a lane
    return ys.permute(2, 1, 0, 3).contiguous()


def _check_wavefront(a, b, a_len, match: int, dis: int, gap: int):
    """Raise on what the kernel does not take."""
    import torch

    if a.dtype != torch.uint8 or a.dim() != 2:
        raise TypeError(f"a must be a [CH, T] uint8 tensor, got {a.dtype} {tuple(a.shape)}")
    if b.dtype != a.dtype or tuple(b.shape) != tuple(a.shape):
        raise TypeError(f"b must be a uint8 tensor shaped like a {tuple(a.shape)}, got "
                        f"{b.dtype} {tuple(b.shape)}")
    CH, T = a.shape
    if a_len.dtype != torch.int32 or tuple(a_len.shape) != (CH, 1):
        raise TypeError(f"a_len must be a [{CH}, 1] int32 tensor, got {a_len.dtype} "
                        f"{tuple(a_len.shape)}")
    if b.device != a.device or a_len.device != a.device:
        raise TypeError(f"a on {a.device}, b on {b.device}, a_len on {a_len.device}")
    if a.device.type not in ("cpu", "cuda"):
        raise TypeError(f"unsupported device {a.device}")
    if not (a.is_contiguous() and b.is_contiguous() and a_len.is_contiguous()):
        raise TypeError("a, b and a_len must be contiguous")
    if not _MIN_TIER <= T <= _MAX_TIER:
        raise ValueError(f"tier {T} outside {_MIN_TIER}..{_MAX_TIER}")
    if not batched_scoring(match, dis, gap):
        raise ValueError(f"scoring {(match, dis, gap)} is not integral or does not fit int32")


def batched_scoring(match, dis, gap) -> bool:
    """Whether the wavefront takes this scoring: integers (the reference
    parses them with atoi, src/Main.cpp:155-168) that fit int32."""
    return all(float(v).is_integer() and _INT32_MIN <= v <= _INT32_MAX
               for v in (match, dis, gap))


def _load():
    global _fn
    with _lock:
        if _fn is None:
            from ..kmer.extract import build

            fn = ctypes.CDLL(build("nw_wavefront")).pf_nw_wavefront
            p, i = ctypes.c_void_p, ctypes.c_int
            fn.argtypes = [p, p, p, i, i, i, i, i, p, p]
            fn.restype = ctypes.c_int
            _fn = fn
        return _fn


def launch_wavefront(a, b, a_len, match: int, dis: int, gap: int, out):
    """One launch of the kernel on CUDA tensors already checked: the
    flags of the chunk into out [CH, 3, 2T+1, W8] uint8."""
    import torch

    global NW_LAUNCHES
    CH, T = a.shape
    with torch.cuda.device(a.device):
        rc = _load()(a.data_ptr(), b.data_ptr(), a_len.data_ptr(), CH, T, int(match), int(dis),
                     int(gap), out.data_ptr(), torch.cuda.current_stream(a.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"nw_wavefront launch failed: CUDA error {rc}")
    NW_LAUNCHES += 1


def nw_wavefront(a, b, a_len, match: int, dis: int, gap: int):
    """The anti-diagonal wavefront of one chunk: a, b [CH, T] uint8 codes
    (pad=_PAD), a_len [CH, 1] int32, all on one device -> the bit-packed
    (little-endian) flags [CH, 3, 2T+1, W8] uint8 on that device. CUDA
    tensors launch the kernel once or raise; CPU tensors take the plain
    version `_wavefront`."""
    import torch

    _check_wavefront(a, b, a_len, match, dis, gap)
    if a.device.type == "cpu":
        return _wavefront(a, b, a_len, match, dis, gap)
    CH, T = a.shape
    out = torch.empty((CH, 3, 2 * T + 1, (T + 9) // 8), dtype=torch.uint8, device=a.device)
    launch_wavefront(a, b, a_len, match, dis, gap, out)
    return out


def _encode(seqs: list[str], width: int) -> np.ndarray:
    out = np.full((len(seqs), width), _PAD, dtype=np.uint8)
    for i, s in enumerate(seqs):
        out[i, : len(s)] = _ENC[np.frombuffer(s.encode(), dtype=np.uint8)]
    return out


def wavefront_packed(a_seqs, b_seqs, tier: int, match: int, dis: int, gap: int, device):
    """The packed flags [len(a_seqs), 3, 2*tier+1, W8] (numpy uint8) of
    one chunk of pairs that fit `tier`, computed on `device`."""
    import torch

    dev = torch.device(device)
    a = torch.from_numpy(_encode(a_seqs, tier)).to(dev)
    b = torch.from_numpy(_encode(b_seqs, tier)).to(dev)
    a_len = torch.tensor([[len(s)] for s in a_seqs], dtype=torch.int32, device=dev)
    return nw_wavefront(a, b, a_len, match, dis, gap).cpu().numpy()


def nw_matrices_batched(
    pairs: list[tuple[str, str]],
    match: float,
    dis_match: float,
    gap: float,
    device="cuda",
):
    """Device-batched version of nw._nw_matrix over many pairs.

    Returns a list of (Up, LeftUp, Left) uint8 matrices, identical to
    running nw._nw_matrix(A, B, ...) per pair. Requires integer-valued
    scoring parameters that fit int32 (`batched_scoring`); raises
    ValueError otherwise, before anything is encoded or copied. Pairs
    longer than the largest tier go to nw._nw_matrix on the host. A
    tier's pairs run in chunks of at most `_chunk_of(tier)` lanes; a
    short chunk is not padded."""
    if not batched_scoring(match, dis_match, gap):
        raise ValueError("batched NW requires integer scoring parameters that fit int32")
    from .. import resolve_device
    from .nw import _nw_matrix

    dev = resolve_device(device)
    results: list = [None] * len(pairs)
    by_tier: dict[int, list[int]] = {}
    for idx, (A, B) in enumerate(pairs):
        t = _tier_of(len(A), len(B))
        if t > _MAX_TIER:
            results[idx] = _nw_matrix(A, B, match, dis_match, gap)
        else:
            by_tier.setdefault(t, []).append(idx)

    for tier, idxs in sorted(by_tier.items()):
        CH = _chunk_of(tier)
        # de-skew gather grid for this tier: cell (i, j) lives at
        # ys[lane, f, i + j, i]
        ii = np.arange(tier + 1, dtype=np.int64)[:, None]
        jj = np.arange(tier + 1, dtype=np.int64)[None, :]
        dgrid = ii + jj
        for off in range(0, len(idxs), CH):
            batch = idxs[off : off + CH]
            ys = wavefront_packed(
                [pairs[i][0] for i in batch],
                [pairs[i][1] for i in batch],
                tier, int(match), int(dis_match), int(gap), dev,
            )
            for lane, idx in enumerate(batch):
                m = len(pairs[idx][0])
                n = len(pairs[idx][1])
                bits = np.unpackbits(
                    ys[lane], axis=-1, bitorder="little"
                )  # [3, 2T+1, W8*8]
                dg = dgrid[: m + 1, : n + 1]
                iw = ii[: m + 1]
                results[idx] = (
                    bits[0][dg, iw],
                    bits[1][dg, iw],
                    bits[2][dg, iw],
                )
    return results


def needleman_wunsch_batch(
    pairs: list[tuple[str, str]],
    match: float = 2.0,
    dis_match: float = -1.0,
    gap: float = -3.0,
    device=None,
):
    """Batch counterpart of nw.needleman_wunsch: DP flag matrices in
    batch + host co-optimal traceback per pair.

    Matrix engine order: the native kernel always goes first; without it
    (no C++ toolchain), when the caller holds a `device` and the scoring
    is integral and fits int32, the device wavefront (`nw_wavefront`:
    the CUDA kernel on a card; whatever it raises propagates); the
    per-pair numpy wavefront (any scoring) is the last resort. Each call
    adds one to its engine's `ENGINE_CALLS` entry."""
    from .nw import _nw_matrix, _traceback, nw_matrices_native

    engine = "native"
    mats = nw_matrices_native(pairs, match, dis_match, gap)
    if mats is None and device is not None and batched_scoring(match, dis_match, gap):
        mats = nw_matrices_batched(pairs, match, dis_match, gap, device)
        engine = "device"
    if mats is None:
        mats = [_nw_matrix(A, B, match, dis_match, gap) for A, B in pairs]
        engine = "numpy"
    ENGINE_CALLS[engine] += 1
    return [
        _traceback(U, L2, L3, A, B, match, dis_match, gap)
        for (U, L2, L3), (A, B) in zip(mats, pairs)
    ]

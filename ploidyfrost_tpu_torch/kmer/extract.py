"""Canonical k-mer extraction: the CUDA kernel K1 and its plain version.

Counterpart of ploidyfrost_tpu/kmer/pallas_extract.py. The kernel
(csrc/extract_canonical.cu) writes the int64 canonical key of every
k-window of a [B, L] uint8 code batch straight into a caller-given
buffer at a caller-given offset, INT64_MAX (pack.SENTINEL) on windows
that hold a non-ACGT code — the fused extract + append of the JAX
counter (`count._extract_append_pallas`). In the same launch it adds the
number of valid windows into a 0-d int64 device tensor (`count=`): the
counter's whole per-batch device work is this one launch.

Dispatch is by the tensors' device and nothing else: CPU tensors take
the plain torch version (pack.batch_kmers, then the count of keys that
are not SENTINEL); CUDA tensors launch the kernel or raise. The shared
library is compiled with nvcc for sm_90a at first use, from this
package's own sources, into ploidyfrost_tpu_torch/_build/ and loaded
with ctypes (plain C ABI). The kernel picks its own tiles from (B, L,
k); its tile constants are compiled in (see the source note).
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading

import torch

from .pack import SENTINEL, batch_kmers

# kernel launches made by `launch` (plain int; a run sets it to 0 and
# reads it back to show the main path went through K1)
LAUNCHES = 0

# the longest read the wrapper takes on the card; a read longer than one
# tile is split into segments of windows, so this bounds no buffer
MAX_READ_LEN = 48 * 1024

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
]

_lock = threading.Lock()
_fn = None  # K1's entry point, bound at first launch


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build(name: str, defines: dict[str, int] | None = None) -> str:
    """Compile csrc/<name>.cu into _build/lib<name>.so unless an
    up-to-date library exists; return its path. `defines` (-D macros)
    build a variant into a library of its own, named after them. Raises
    on failure."""
    defines = defines or {}
    src = os.path.join(CSRC, name + ".cu")
    tag = "".join(f"_{key}{val}" for key, val in sorted(defines.items()))
    lib = os.path.join(BUILD_DIR, f"lib{name}{tag}.so")
    if os.path.exists(lib) and os.path.getmtime(lib) >= os.path.getmtime(src):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    flags = [f"-D{key}={val}" for key, val in sorted(defines.items())]
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, *flags, "-o", tmp, src],
        capture_output=True, text=True, timeout=600,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def bind(path: str):
    """K1's entry point pf_extract_canonical(codes, B, L, k, out, count,
    stream) in the library at `path`."""
    fn = ctypes.CDLL(path).pf_extract_canonical
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def _load():
    global _fn
    with _lock:
        if _fn is None:
            _fn = bind(build("extract_canonical"))
        return _fn


def extract_canonical_plain(codes: torch.Tensor, k: int) -> torch.Tensor:
    """Plain torch version of K1: [B, L] uint8 -> [B*n] int64 canonical
    keys with SENTINEL on invalid windows."""
    canon, valid = batch_kmers(codes, k)
    return torch.where(valid, canon, SENTINEL).reshape(-1)


def extract_canonical_into(
    codes: torch.Tensor,
    k: int,
    out: torch.Tensor,
    offset: int = 0,
    count: torch.Tensor | None = None,
) -> torch.Tensor:
    """Write the canonical keys of every k-window of `codes` ([B, L]
    uint8) into out[offset : offset + B*(L-k+1)] (int64) and add the
    number of valid windows into `count` (a 0-d int64 tensor on out's
    device), in the same launch on the card. Returns `count`, or, when
    none is given, a new 0-d tensor holding the number (no host sync)."""
    dst = _slice(codes, k, out, offset)
    if count is None:
        count = torch.zeros((), dtype=torch.int64, device=out.device)
    elif count.dtype != torch.int64 or count.dim() != 0:
        raise TypeError(f"count must be a 0-d int64 tensor, got {count.dtype} {tuple(count.shape)}")
    elif count.device != out.device:
        raise ValueError(f"count on {count.device} but out on {out.device}")
    if codes.device.type == "cpu":
        dst.copy_(extract_canonical_plain(codes, k))
        count += (dst != SENTINEL).sum()
    elif dst.numel():
        launch(codes, k, dst, count)
    return count


def _slice(codes: torch.Tensor, k: int, out: torch.Tensor, offset: int) -> torch.Tensor:
    """Check the wrapper's arguments; return the slice of `out` that
    receives the keys."""
    if codes.dtype != torch.uint8 or codes.dim() != 2:
        raise TypeError(f"codes must be a [B, L] uint8 tensor, got {codes.dtype} {tuple(codes.shape)}")
    if out.dtype != torch.int64 or out.dim() != 1:
        raise TypeError(f"out must be a 1-d int64 tensor, got {out.dtype} {tuple(out.shape)}")
    if codes.device != out.device:
        raise ValueError(f"codes on {codes.device} but out on {out.device}")
    if not codes.is_contiguous() or not out.is_contiguous():
        raise ValueError("codes and out must be contiguous")
    if codes.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {codes.device}")
    B, L = codes.shape
    if not 0 < k <= 31 or L < k:
        raise ValueError(f"need 0 < k <= 31 and L >= k, got k={k} L={L}")
    if codes.device.type == "cuda" and L > MAX_READ_LEN:
        raise ValueError(f"read length {L} exceeds the kernel's {MAX_READ_LEN}")
    total = B * (L - k + 1)
    if offset < 0 or offset + total > out.numel():
        raise ValueError(
            f"{total} keys at offset {offset} overflow a buffer of {out.numel()}"
        )
    return out[offset : offset + total]


def launch(codes: torch.Tensor, k: int, dst: torch.Tensor, count: torch.Tensor):
    """K1 on CUDA tensors already checked by the wrapper: keys of
    `codes` into `dst` (B*n int64), valid count added into `count`."""
    global LAUNCHES
    call(_load(), codes, k, dst, count)
    LAUNCHES += 1


def call(fn, codes: torch.Tensor, k: int, dst: torch.Tensor, count: torch.Tensor):
    """One launch of the entry point `fn` (from `bind`) on the current
    stream; raises on a CUDA error. Counts nothing: `launch` is the
    package's path."""
    B, L = codes.shape
    stream = torch.cuda.current_stream(codes.device).cuda_stream
    with torch.cuda.device(codes.device):
        rc = fn(codes.data_ptr(), B, L, k, dst.data_ptr(), count.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"extract_canonical launch failed: CUDA error {rc}")

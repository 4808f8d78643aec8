"""Canonical k-mer extraction: the CUDA kernel K1 and its plain version.

Counterpart of ploidyfrost_tpu/kmer/pallas_extract.py. The kernel
(csrc/extract_canonical.cu) writes the int64 canonical key of every
k-window of a [B, L] uint8 code batch straight into a caller-given
buffer at a caller-given offset, INT64_MAX (pack.SENTINEL) on windows
that hold a non-ACGT code — the fused extract + append of the JAX
counter (`count._extract_append_pallas`).

Dispatch is by the tensors' device and nothing else: CPU tensors take
the plain torch version (pack.batch_kmers); CUDA tensors launch the
kernel or raise. The shared library is compiled with nvcc for sm_90a
at first use, from this package's own sources, into
ploidyfrost_tpu_torch/_build/ and loaded with ctypes (plain C ABI).
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading

import torch

from .pack import SENTINEL, batch_kmers

# kernel launches made by extract_canonical_into (plain int; a run sets
# it to 0 and reads it back to show the main path went through K1)
LAUNCHES = 0

# one read's codes are staged in shared memory (48 KB without opt-in)
MAX_READ_LEN = 48 * 1024

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build(name: str) -> str:
    """Compile csrc/<name>.cu into _build/lib<name>.so unless an
    up-to-date library exists; return its path. Raises on failure."""
    src = os.path.join(CSRC, name + ".cu")
    lib = os.path.join(BUILD_DIR, f"lib{name}.so")
    if os.path.exists(lib) and os.path.getmtime(lib) >= os.path.getmtime(src):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
        capture_output=True, text=True, timeout=600,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def _load() -> ctypes.CDLL:
    with _lock:
        lib = _libs.get("extract_canonical")
        if lib is None:
            lib = ctypes.CDLL(build("extract_canonical"))
            fn = lib.pf_extract_canonical
            fn.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ]
            fn.restype = ctypes.c_int
            _libs["extract_canonical"] = lib
        return lib


def extract_canonical_plain(codes: torch.Tensor, k: int) -> torch.Tensor:
    """Plain torch version of K1: [B, L] uint8 -> [B*n] int64 canonical
    keys with SENTINEL on invalid windows."""
    canon, valid = batch_kmers(codes, k)
    return torch.where(valid, canon, SENTINEL).reshape(-1)


def extract_canonical_into(
    codes: torch.Tensor, k: int, out: torch.Tensor, offset: int = 0
) -> torch.Tensor:
    """Write the canonical keys of every k-window of `codes` ([B, L]
    uint8) into out[offset : offset + B*(L-k+1)] (int64) and return the
    number of valid windows as a 0-d int64 tensor on out's device (no
    host sync)."""
    dst = _extract_keys(codes, k, out, offset)
    return (dst != SENTINEL).sum()


def _extract_keys(codes: torch.Tensor, k: int, out: torch.Tensor, offset: int) -> torch.Tensor:
    """The keys alone: K1 for CUDA tensors, the plain version for CPU
    tensors. Returns the written slice of `out`."""
    global LAUNCHES
    if codes.dtype != torch.uint8 or codes.dim() != 2:
        raise TypeError(f"codes must be a [B, L] uint8 tensor, got {codes.dtype} {tuple(codes.shape)}")
    if out.dtype != torch.int64 or out.dim() != 1:
        raise TypeError(f"out must be a 1-d int64 tensor, got {out.dtype} {tuple(out.shape)}")
    if codes.device != out.device:
        raise ValueError(f"codes on {codes.device} but out on {out.device}")
    if not codes.is_contiguous() or not out.is_contiguous():
        raise ValueError("codes and out must be contiguous")
    B, L = codes.shape
    if not 0 < k <= 31 or L < k:
        raise ValueError(f"need 0 < k <= 31 and L >= k, got k={k} L={L}")
    total = B * (L - k + 1)
    if offset < 0 or offset + total > out.numel():
        raise ValueError(
            f"{total} keys at offset {offset} overflow a buffer of {out.numel()}"
        )
    dst = out[offset : offset + total]
    if codes.device.type == "cpu":
        dst.copy_(extract_canonical_plain(codes, k))
    elif codes.device.type == "cuda":
        if L > MAX_READ_LEN:
            raise ValueError(f"read length {L} exceeds the kernel's {MAX_READ_LEN}")
        fn = _load().pf_extract_canonical
        stream = torch.cuda.current_stream(codes.device).cuda_stream
        with torch.cuda.device(codes.device):
            rc = fn(codes.data_ptr(), B, L, k, dst.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"extract_canonical launch failed: CUDA error {rc}")
        LAUNCHES += 1
    else:
        raise ValueError(f"unsupported device {codes.device}")
    return dst

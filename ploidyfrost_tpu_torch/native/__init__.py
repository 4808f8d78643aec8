# Copied from ploidyfrost_tpu/native/__init__.py.
"""Build + load the native FASTX batch loader (ctypes C ABI).

The shared library is compiled on first use with the system toolchain
(g++ -O2 -shared -fPIC, linked against zlib) into this package's
``_build`` directory and cached across runs (rebuilt when the source is
newer than the binary). Loading is best-effort: any build or load
failure degrades to the pure-Python reader in io/fastx.py — the native
path is a throughput optimization, never a correctness dependency.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

_SRC = os.path.join(os.path.dirname(__file__), "fastx_reader.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(__file__), "_build")
_LIB = os.path.join(_BUILD_DIR, "libpfxreader.so")

_lock = threading.Lock()
_lib = None
_tried = False


def _build() -> bool:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    cmd = [
        os.environ.get("CXX", "g++"),
        "-O2",
        "-shared",
        "-fPIC",
        "-o",
        _LIB + ".tmp",
        _SRC,
        "-lz",
    ]
    try:
        subprocess.run(
            cmd, check=True, capture_output=True, timeout=120
        )
    except (OSError, subprocess.SubprocessError):
        return False
    os.replace(_LIB + ".tmp", _LIB)
    return True


def load_library():
    """Return the loaded ctypes library, or None if unavailable."""
    global _lib, _tried
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("PLOIDYFROST_NO_NATIVE"):
            return None
        try:
            need_build = not os.path.exists(_LIB) or (
                os.path.getmtime(_SRC) > os.path.getmtime(_LIB)
            )
            if need_build and not _build():
                return None
            lib = ctypes.CDLL(_LIB)
        except OSError:
            return None
        lib.pfx_open.argtypes = [ctypes.c_char_p]
        lib.pfx_open.restype = ctypes.c_void_p
        lib.pfx_set_trim.argtypes = [
            ctypes.c_void_p,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
        ]
        lib.pfx_set_trim.restype = None
        lib.pfx_next_batch.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_long,
            ctypes.c_long,
            ctypes.c_long,
            ctypes.c_long,
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.pfx_next_batch.restype = ctypes.c_long
        lib.pfx_error.argtypes = [ctypes.c_void_p]
        lib.pfx_error.restype = ctypes.c_char_p
        lib.pfx_close.argtypes = [ctypes.c_void_p]
        lib.pfx_close.restype = None
        _lib = lib
        return _lib


def _load_simple(src_name: str, lib_name: str, state: dict, sig):
    """Build-and-load helper for single-file C ABI kernels (same
    best-effort contract as the FASTX loader above)."""
    if state.get("lib") is not None:
        return state["lib"]
    with _lock:
        if state.get("lib") is not None or state.get("tried"):
            return state.get("lib")
        state["tried"] = True
        if os.environ.get("PLOIDYFROST_NO_NATIVE"):
            return None
        src = os.path.join(os.path.dirname(__file__), src_name)
        lib_path = os.path.join(_BUILD_DIR, lib_name)
        os.makedirs(_BUILD_DIR, exist_ok=True)
        try:
            need_build = not os.path.exists(lib_path) or (
                os.path.getmtime(src) > os.path.getmtime(lib_path)
            )
            if need_build:
                subprocess.run(
                    [
                        os.environ.get("CXX", "g++"),
                        "-O2",
                        "-shared",
                        "-fPIC",
                        "-pthread",
                        "-o",
                        lib_path + ".tmp",
                        src,
                    ],
                    check=True,
                    capture_output=True,
                    timeout=120,
                )
                os.replace(lib_path + ".tmp", lib_path)
            lib = ctypes.CDLL(lib_path)
            sig(lib)  # AttributeError on a stale/corrupt .so -> fallback
        except (OSError, subprocess.SubprocessError, AttributeError):
            return None
        state["lib"] = lib
        return lib


_nw_state: dict = {}
_lookup_state: dict = {}
_chain_state: dict = {}


_construct_state: dict = {}


def load_construct_library():
    """Return the loaded construction-kernels library, or None
    (fallback to the numpy paths in graph/construct.py)."""

    def sig(lib):
        i64p = ctypes.POINTER(ctypes.c_int64)
        u64p = ctypes.POINTER(ctypes.c_uint64)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.pf_link_junctions.argtypes = [
            u64p, u64p, ctypes.c_int64, ctypes.c_int32, i64p, u8p,
        ]
        lib.pf_link_junctions.restype = None
        lib.pf_assemble_unitigs.argtypes = [
            i64p, i64p, i64p, ctypes.c_int64,
            u64p, u64p, ctypes.c_int32, u64p, i64p,
        ]
        lib.pf_assemble_unitigs.restype = None
        lib.pf_revcomp.argtypes = [u64p, ctypes.c_int64, ctypes.c_int32, u64p]
        lib.pf_revcomp.restype = None

    return _load_simple(
        "construct_kernels.cpp", "libpfconstruct.so", _construct_state, sig
    )


def load_chain_library():
    """Return the loaded chain-rank library, or None (fallback to the
    numpy pointer-doubling path in graph/construct.py)."""

    def sig(lib):
        i64p = ctypes.POINTER(ctypes.c_int64)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.pf_chain_rank.argtypes = [i64p, ctypes.c_int64, i64p, u8p]
        lib.pf_chain_rank.restype = None

    return _load_simple("chain_rank.cpp", "libpfchain.so", _chain_state, sig)


def load_nw_library():
    """Return the loaded NW flag-kernel library, or None (fallback to
    the numpy wavefront in align/nw.py)."""

    def sig(lib):
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.pf_nw_flags_batch.argtypes = [
            u8p, i64p, u8p, i64p,
            ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            u8p, i64p,
        ]
        lib.pf_nw_flags_batch.restype = None

    return _load_simple("nw_flags.cpp", "libpfnw.so", _nw_state, sig)


def load_lookup_library():
    """Return the loaded bucketed-lookup library, or None (fallback to
    np.searchsorted in kmer/countdb.py)."""

    def sig(lib):
        u64p = ctypes.POINTER(ctypes.c_uint64)
        i64p = ctypes.POINTER(ctypes.c_int64)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.pf_lookup_u64_b.argtypes = [
            u64p, ctypes.c_int64, i64p, ctypes.c_int32, ctypes.c_int64,
            u64p, ctypes.c_int64, i64p,
        ]
        lib.pf_lookup_u64_b.restype = None
        lib.pf_lookup_canon_multi_t.argtypes = [
            u64p, ctypes.c_int64, i64p, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int64,
            u64p, ctypes.c_int64, i64p, ctypes.c_int32, i64p, u8p,
            ctypes.c_int32, ctypes.c_int32,
        ]
        lib.pf_lookup_canon_multi_t.restype = None
        lib.pf_extract_kmers.argtypes = [
            u64p, ctypes.c_int64, i64p, ctypes.c_int64, ctypes.c_int32,
            u64p, ctypes.c_int32,
        ]
        lib.pf_extract_kmers.restype = None
        lib.pf_pack_codes.argtypes = [
            u8p, i64p, i64p, ctypes.c_int64, u64p, ctypes.c_int32,
        ]
        lib.pf_pack_codes.restype = None

    return _load_simple("lookup.cpp", "libpflookup.so", _lookup_state, sig)

# Copied from ploidyfrost_tpu/native/__init__.py; builds made race-free.
"""Build + load the native host libraries (ctypes C ABI).

Each shared library (the FASTX reader, linked against zlib, and the
single-file C ABI kernels below) is compiled on first use with the
system toolchain (g++ -O2 -shared -fPIC) into this package's ``_build``
directory and cached across runs (rebuilt when the source is newer than
the binary). A build writes to a temporary name unique to the process
and is moved into place, so processes that build the same library at
once each load a complete one. Loading is best-effort: any build or
load failure degrades to the pure-Python or numpy path of the caller
(io/fastx.py for the reader) — the native path is a throughput
optimization, never a correctness dependency.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

_DIR = os.path.dirname(__file__)
_BUILD_DIR = os.path.join(_DIR, "_build")

_lock = threading.Lock()
_fastx_state: dict = {}


def _build(src: str, lib_path: str, libs: tuple = ()):
    """Compile `src` into `lib_path` unless the library there is newer
    than its source. Each process compiles to a name of its own and
    moves the result into place, so processes that build at once never
    share a file and each ends with a complete library at `lib_path`.
    Raises OSError or SubprocessError on failure."""
    if os.path.exists(lib_path) and os.path.getmtime(src) <= os.path.getmtime(lib_path):
        return
    os.makedirs(os.path.dirname(lib_path), exist_ok=True)
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    try:
        subprocess.run(
            [os.environ.get("CXX", "g++"), "-O2", "-shared", "-fPIC", "-pthread",
             "-o", tmp, src, *libs],
            check=True,
            capture_output=True,
            timeout=120,
        )
        os.replace(tmp, lib_path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load_simple(src_name: str, lib_name: str, state: dict, sig, libs: tuple = ()):
    """Build and load one single-file C ABI library: the library, or
    None when it cannot be built or loaded (the callers then take their
    pure-Python or numpy paths)."""
    if state.get("lib") is not None:
        return state["lib"]
    with _lock:
        if state.get("lib") is not None or state.get("tried"):
            return state.get("lib")
        state["tried"] = True
        if os.environ.get("PLOIDYFROST_NO_NATIVE"):
            return None
        try:
            lib_path = os.path.join(_BUILD_DIR, lib_name)
            _build(os.path.join(_DIR, src_name), lib_path, libs)
            lib = ctypes.CDLL(lib_path)
            sig(lib)  # AttributeError on a stale/corrupt .so -> fallback
        except (OSError, subprocess.SubprocessError, AttributeError):
            return None
        state["lib"] = lib
        return lib


def load_library():
    """Return the loaded FASTX reader library, or None if unavailable."""

    def sig(lib):
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

    return _load_simple("fastx_reader.cpp", "libpfxreader.so", _fastx_state, sig, ("-lz",))


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

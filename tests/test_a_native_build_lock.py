"""Build the JAX package's native host libraries once, under a file lock.

Why this file exists, and why its name breaks the test_torch_* rule: the
loaders in ploidyfrost_tpu/native compile every library to one fixed
`<lib>.tmp` and remember a failed attempt for the rest of the process.
When several pytest-xdist workers start from an empty
ploidyfrost_tpu/native/_build/, two of them can compile into the same
temporary file, one loses the race, and that worker skips the tests that
need the library (at collection in tests/test_native.py and
tests/test_native_nw.py, at run time in tests/test_construct.py and
tests/test_trim.py). Every worker collects the test files in name order,
and "test_a_" sorts before "test_align.py" and every file that loads a
native library, so this module is imported first in every worker: it
takes an exclusive lock on a file in that (gitignored) build directory
and, holding it, loads the five libraries. The first worker builds them;
the others wait, then find them built and load them. The JAX package
itself is not changed.
"""

import fcntl
import os
import shutil

import pytest

from ploidyfrost_tpu import native

LOADERS = ("load_library", "load_construct_library", "load_chain_library",
           "load_nw_library", "load_lookup_library")

_BUILD_DIR = os.path.join(os.path.dirname(native.__file__), "_build")


def _load_all_under_lock() -> dict:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    with open(os.path.join(_BUILD_DIR, "build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            return {name: getattr(native, name)() is not None for name in LOADERS}
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


LOADED = _load_all_under_lock()


def test_all_five_native_libraries_load():
    if os.environ.get("PLOIDYFROST_NO_NATIVE"):
        pytest.skip("PLOIDYFROST_NO_NATIVE is set: the native libraries are off")
    if shutil.which(os.environ.get("CXX", "g++")) is None:
        pytest.skip("no C++ compiler on this host")
    assert LOADED == dict.fromkeys(LOADERS, True)

"""The torch port's native loaders under concurrent builds.

Several processes build the same native library into one empty build
directory at once, as pytest-xdist workers do on a fresh checkout. Each
compiles to a temporary name of its own and moves it into place, so
every one must end with the library loaded, and no temporary file may
be left behind. The build directory is the test's own temporary one,
never the package's.
"""

import os
import subprocess
import sys
import time

import pytest

WORKERS = 4
# the children import the package from the repository root, wherever an
# earlier test of this worker left the working directory
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = r"""
import os, sys, time
import ploidyfrost_tpu_torch.native as native
native._BUILD_DIR = sys.argv[1]
while not os.path.exists(sys.argv[2]):
    time.sleep(0.005)
print("loaded" if getattr(native, sys.argv[3])() is not None else "unavailable")
"""


@pytest.mark.parametrize(
    "loader, lib_name",
    [("load_chain_library", "libpfchain.so"), ("load_library", "libpfxreader.so")],
)
def test_concurrent_builds_all_load(tmp_path, loader, lib_name):
    build = tmp_path / "build"
    go = tmp_path / "go"
    cmd = [sys.executable, "-c", CHILD, str(build), str(go), loader]
    procs = [
        subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for _ in range(WORKERS)
    ]
    time.sleep(0.5)
    go.touch()  # every child starts its build at once
    results = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, results):
        assert p.returncode == 0, err
        assert out.strip() == "loaded", err
    assert sorted(f.name for f in build.iterdir()) == [lib_name]

"""Canonical k-mer extraction in the torch port against the JAX package.

The port's plain version (ploidyfrost_tpu_torch.kmer.extract, what the
wrapper runs on CPU tensors) is held bit-exact against the JAX XLA path
(`count._extract`) and the Pallas kernel in interpret mode
(`pallas_extract.extract_canonical(interpret=True)`), on codes made by
numpy from a seed. The JAX side returns (hi, lo) u32 halves with an
all-ones sentinel; the port returns int64 keys with INT64_MAX. Keys are
compared exactly once the sentinels are mapped, and the valid count the
wrapper adds into its `count` tensor against the JAX side's `n`. The
CUDA kernel itself is held against this plain version on the card by
chip_smoke.py; how its library is built (nvcc stood in for) is checked
here.
"""

import os
import subprocess

import numpy as np
import pytest
import torch

from ploidyfrost_tpu.kmer.count import _extract
from ploidyfrost_tpu.kmer.pallas_extract import extract_canonical as pallas_extract
from ploidyfrost_tpu_torch.kmer import extract as T
from ploidyfrost_tpu_torch.kmer.pack import SENTINEL
from test_torch_helpers import few_torch_threads  # noqa: F401  (autouse fixture)


def _jax_keys(hi, lo):
    hi = np.asarray(hi).astype(np.int64)
    lo = np.asarray(lo).astype(np.int64)
    sent = (hi == 0xFFFFFFFF) & (lo == 0xFFFFFFFF)
    return np.where(sent, SENTINEL, (hi << 32) | lo)


def _codes(seed, B, L, n_rate=0.02):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=(B, L)).astype(np.uint8)
    codes[rng.random((B, L)) < n_rate] = 4
    return codes


def _port(codes, k, offset=0):
    """Keys and valid count from the wrapper, written at `offset` of a
    larger buffer whose other entries must stay untouched."""
    B, L = codes.shape
    total = B * (L - k + 1)
    buf = torch.full((offset + total + 3,), -9, dtype=torch.int64)
    count = torch.zeros((), dtype=torch.int64)
    got = T.extract_canonical_into(torch.from_numpy(codes), k, buf, offset, count=count)
    assert got is count
    assert (buf[:offset] == -9).all() and (buf[offset + total :] == -9).all()
    return buf[offset : offset + total].numpy(), int(count)


@pytest.mark.parametrize("offset", [0, 1, 7])
@pytest.mark.parametrize("k", [1, 2, 5, 16, 17, 25, 31])
def test_matches_xla_extract(k, offset):
    codes = _codes(k, 16, 64)
    hi, lo, n = _extract(codes, k)
    keys, nv = _port(codes, k, offset)
    np.testing.assert_array_equal(keys, _jax_keys(hi, lo))
    assert nv == int(n)


@pytest.mark.parametrize("offset", [0, 7])
@pytest.mark.parametrize("k", [1, 2, 5, 16, 17, 25, 31])
def test_matches_pallas_interpret(k, offset):
    codes = _codes(100 + k, 16, 64, n_rate=0.05)
    hi, lo, n = pallas_extract(codes, k, interpret=True)
    keys, nv = _port(codes, k, offset)
    np.testing.assert_array_equal(keys, _jax_keys(hi, lo))
    assert nv == int(n)


def test_count_accumulates_across_calls():
    """The counter's use: one count tensor over several batches, each
    written at the buffer's fill; the sum equals the JAX path's."""
    k = 21
    batches = [_codes(40 + i, 9, 50 + 13 * i) for i in range(3)]
    buf = torch.empty(sum(b.shape[0] * (b.shape[1] - k + 1) for b in batches), dtype=torch.int64)
    count = torch.zeros((), dtype=torch.int64)
    fill, want = 0, 0
    for codes in batches:
        T.extract_canonical_into(torch.from_numpy(codes), k, buf, fill, count=count)
        fill += codes.shape[0] * (codes.shape[1] - k + 1)
        want += int(_extract(codes, k)[2])
        assert int(count) == want
    assert int((buf != SENTINEL).sum()) == want


def test_count_default_is_fresh():
    codes = _codes(5, 4, 30)
    out = torch.empty(4 * 26, dtype=torch.int64)
    a = T.extract_canonical_into(torch.from_numpy(codes), 5, out)
    b = T.extract_canonical_into(torch.from_numpy(codes), 5, out)
    assert a is not b and int(a) == int(b) == int((out != SENTINEL).sum())


@pytest.mark.parametrize("k", [5, 25, 31])
def test_all_invalid_rows(k):
    codes = _codes(7, 8, 40)
    codes[[1, 4]] = 4
    hi, lo, n = _extract(codes, k)
    keys, nv = _port(codes, k)
    np.testing.assert_array_equal(keys, _jax_keys(hi, lo))
    assert nv == int(n)
    n_row = 40 - k + 1
    assert (keys.reshape(8, n_row)[[1, 4]] == SENTINEL).all()


@pytest.mark.parametrize("shape", [(24, 51), (7, 33), (1, 25), (3, 160)])
def test_odd_batch_shapes(shape):
    codes = _codes(shape[0] * 1000 + shape[1], *shape)
    hi, lo, n = pallas_extract(codes, 25, interpret=True)
    keys, nv = _port(codes, 25)
    np.testing.assert_array_equal(keys, _jax_keys(hi, lo))
    assert nv == int(n)


def test_writes_only_its_slice():
    codes = _codes(3, 5, 30)
    k = 17
    n = 5 * (30 - k + 1)
    out = torch.full((n + 10,), -7, dtype=torch.int64)
    before = T.LAUNCHES
    nv = T.extract_canonical_into(torch.from_numpy(codes), k, out, offset=4)
    assert T.LAUNCHES == before  # CPU tensors take the plain version
    assert (out[:4] == -7).all() and (out[4 + n :] == -7).all()
    ref = T.extract_canonical_plain(torch.from_numpy(codes), k)
    assert torch.equal(out[4 : 4 + n], ref)
    assert int(nv) == int((ref != SENTINEL).sum())


@pytest.mark.parametrize(
    "codes, out, k, offset",
    [
        (torch.zeros(2, 30, dtype=torch.int32), torch.empty(100, dtype=torch.int64), 5, 0),
        (torch.zeros(2, 30, dtype=torch.uint8), torch.empty(100, dtype=torch.int32), 5, 0),
        (torch.zeros(2, 30, dtype=torch.uint8), torch.empty(100, dtype=torch.int64), 32, 0),
        (torch.zeros(2, 30, dtype=torch.uint8), torch.empty(100, dtype=torch.int64), 5, 60),
        (torch.zeros(30, 2, dtype=torch.uint8).t(), torch.empty(100, dtype=torch.int64), 1, 0),
        (torch.zeros(2, 4, dtype=torch.uint8), torch.empty(100, dtype=torch.int64), 5, 0),
    ],
    ids=["codes-dtype", "out-dtype", "k-too-large", "overflow", "non-contiguous", "L-below-k"],
)
def test_wrapper_rejects(codes, out, k, offset):
    with pytest.raises((TypeError, ValueError)):
        T.extract_canonical_into(codes, k, out, offset)


@pytest.mark.parametrize(
    "count, err",
    [
        (torch.zeros((), dtype=torch.int32), TypeError),
        (torch.zeros((), dtype=torch.float64), TypeError),
        (torch.zeros(1, dtype=torch.int64), TypeError),
        (torch.zeros((), dtype=torch.int64, device="meta"), ValueError),
    ],
    ids=["int32", "float64", "not-0d", "other-device"],
)
def test_wrapper_rejects_count(count, err):
    codes = torch.from_numpy(_codes(2, 2, 30))
    out = torch.full((60,), -3, dtype=torch.int64)
    with pytest.raises(err):
        T.extract_canonical_into(codes, 5, out, 0, count=count)
    assert (out == -3).all()  # rejected before anything is written


def _fake_nvcc(monkeypatch, tmp_path, rc=0):
    """Point build() at tmp_path with a stand-in for nvcc that records
    its command lines and writes an empty library."""
    monkeypatch.setattr(T, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(T, "_nvcc", lambda: "nvcc")
    calls = []

    def run(cmd, **kw):
        calls.append(cmd)
        if rc == 0:
            open(cmd[cmd.index("-o") + 1], "wb").close()
        return subprocess.CompletedProcess(cmd, rc, "", "refused")

    monkeypatch.setattr(T.subprocess, "run", run)
    return calls


@pytest.mark.parametrize(
    "defines, name",
    [
        (None, "libextract_canonical.so"),
        ({"PF_THREADS": 64, "PF_RUN": 9, "PF_STAGES": 1},
         "libextract_canonical_PF_RUN9_PF_STAGES1_PF_THREADS64.so"),
    ],
    ids=["default", "variant"],
)
def test_build_variant_library(monkeypatch, tmp_path, defines, name):
    """A variant's -D macros reach nvcc and name a library of its own;
    the output goes to a per-process temporary name first; an up-to-date
    library is not rebuilt."""
    calls = _fake_nvcc(monkeypatch, tmp_path)
    path = T.build("extract_canonical", defines)
    assert path == str(tmp_path / name) and os.path.exists(path)
    (cmd,) = calls
    assert cmd[cmd.index("-o") + 1] == f"{path}.{os.getpid()}.tmp"
    assert [c for c in cmd if c.startswith("-D")] == [
        f"-D{key}={val}" for key, val in sorted((defines or {}).items())]
    assert T.build("extract_canonical", defines) == path and len(calls) == 1
    assert os.listdir(tmp_path) == [name]


def test_build_failure_raises(monkeypatch, tmp_path):
    """A failed nvcc raises with its message and leaves no library: the
    wrapper never falls back to the plain version on the card."""
    _fake_nvcc(monkeypatch, tmp_path, rc=1)
    with pytest.raises(RuntimeError, match="refused"):
        T.build("extract_canonical")
    assert os.listdir(tmp_path) == []

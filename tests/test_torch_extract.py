"""Canonical k-mer extraction in the torch port against the JAX package.

The port's plain version (ploidyfrost_tpu_torch.kmer.extract, what the
wrapper runs on CPU tensors) is held bit-exact against the JAX XLA path
(`count._extract`) and the Pallas kernel in interpret mode
(`pallas_extract.extract_canonical(interpret=True)`), on codes made by
numpy from a seed. The JAX side returns (hi, lo) u32 halves with an
all-ones sentinel; the port returns int64 keys with INT64_MAX. Keys are
compared exactly once the sentinels are mapped. The CUDA kernel itself
is held against this plain version on the card by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from ploidyfrost_tpu.kmer.count import _extract
from ploidyfrost_tpu.kmer.pallas_extract import extract_canonical as pallas_extract
from ploidyfrost_tpu_torch.kmer import extract as T
from ploidyfrost_tpu_torch.kmer.pack import SENTINEL


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


def _port(codes, k):
    B, L = codes.shape
    keys = torch.empty(B * (L - k + 1), dtype=torch.int64)
    nv = T.extract_canonical_into(torch.from_numpy(codes), k, keys)
    return keys.numpy(), int(nv)


@pytest.mark.parametrize("k", [5, 16, 17, 25, 31])
def test_matches_xla_extract(k):
    codes = _codes(k, 16, 64)
    hi, lo, n = _extract(codes, k)
    keys, nv = _port(codes, k)
    np.testing.assert_array_equal(keys, _jax_keys(hi, lo))
    assert nv == int(n)


@pytest.mark.parametrize("k", [5, 16, 17, 25, 31])
def test_matches_pallas_interpret(k):
    codes = _codes(100 + k, 16, 64, n_rate=0.05)
    hi, lo, n = pallas_extract(codes, k, interpret=True)
    keys, nv = _port(codes, k)
    np.testing.assert_array_equal(keys, _jax_keys(hi, lo))
    assert nv == int(n)


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

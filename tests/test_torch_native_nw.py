"""The port's native C NW flag kernel (native/nw_flags.cpp, through
align/nw.nw_matrices_native) against its scalar oracle, and the port's
native bucketed lookup against np.searchsorted: the cases of
tests/test_native_nw.py, run against ploidyfrost_tpu_torch.

The scalar oracle (align/nw._nw_matrix_scalar) is the literal port of
the reference DP (src/SeqAlign.cpp:480-548). The native batch kernel is
checked against it on random pairs, including dash-bearing strings
(progressive-MSA inputs) and the forbidden-Left rule cases.
"""

import numpy as np
import pytest

from ploidyfrost_tpu_torch.align.nw import _nw_matrix_scalar, nw_matrices_native

ALPHA = "ACGT-"


@pytest.fixture
def native_nw():
    if nw_matrices_native([("A", "A")], 2, -1, -3) is None:
        pytest.skip("native toolchain unavailable")


def _rand(rng, L, dash_p=0.0):
    probs = np.array([1, 1, 1, 1, 0], float)
    if dash_p:
        probs = np.array([1, 1, 1, 1, 4 * dash_p / (1 - dash_p)], float)
    probs /= probs.sum()
    return "".join(rng.choice(list(ALPHA), L, p=probs))


@pytest.mark.parametrize("dash_p", [0.0, 0.15])
def test_native_matches_scalar_oracle(native_nw, dash_p):
    rng = np.random.default_rng(11)
    pairs = []
    for _ in range(60):
        m = int(rng.integers(1, 40))
        n = int(rng.integers(1, 40))
        pairs.append((_rand(rng, m, dash_p), _rand(rng, n, dash_p)))
    nat = nw_matrices_native(pairs, 2, -1, -3)
    assert nat is not None
    for (A, B), (u, lu, lf) in zip(pairs, nat):
        su, slu, slf = _nw_matrix_scalar(A, B, 2.0, -1.0, -3.0)
        np.testing.assert_array_equal(u, su)
        np.testing.assert_array_equal(lu, slu)
        np.testing.assert_array_equal(lf, slf)


def test_native_rejects_float_scoring(native_nw):
    assert nw_matrices_native([("AC", "AG")], 2.5, -1, -3) is None


def test_native_empty_inputs(native_nw):
    nat = nw_matrices_native([("", "ACG"), ("ACG", "")], 2, -1, -3)
    assert nat is not None
    for (A, B), (u, lu, lf) in zip([("", "ACG"), ("ACG", "")], nat):
        su, slu, slf = _nw_matrix_scalar(A, B, 2.0, -1.0, -3.0)
        np.testing.assert_array_equal(u, su)
        np.testing.assert_array_equal(lf, slf)


def test_native_lookup_matches_searchsorted():
    from ploidyfrost_tpu_torch.kmer.countdb import KmerCountDB
    from ploidyfrost_tpu_torch.native import load_lookup_library

    if load_lookup_library() is None:
        pytest.skip("native toolchain unavailable")
    rng = np.random.default_rng(5)
    for k in (5, 15, 25, 31):
        bits = 2 * k
        table = np.unique(
            rng.integers(0, 1 << min(bits, 63), 20000).astype(np.uint64)
        )
        db = KmerCountDB(table, np.ones(len(table), np.int64), k)
        q = rng.integers(0, 1 << min(bits, 63), 50000).astype(np.uint64)
        # mix in exact hits
        q[:5000] = rng.choice(table, 5000)
        idx_native = db._search(q)
        idx_np = np.searchsorted(db._km_np, q)
        np.testing.assert_array_equal(idx_native, idx_np)

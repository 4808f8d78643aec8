"""The torch port's k-mer counter and count table against the JAX package.

Reads are made by numpy from a seed and fed to both counters. Keys,
counts, histograms and instance totals must be exactly equal. The JAX
counter gets a small `initial_capacity` (forcing its grow-and-replay)
and both get a small `counter_max` (forcing saturation across merges);
the port gets a small instance buffer, forcing several collapses.
"""

import numpy as np
import pytest
import torch

from ploidyfrost_tpu.kmer.count import KmerCounter as JaxCounter
from ploidyfrost_tpu.kmer.countdb import KmerCountDB as JaxDB
from ploidyfrost_tpu.kmer.cutoffs import cutoff_lower_from_counts, cutoff_upper_from_counts
from ploidyfrost_tpu_torch.kmer.count import KmerCounter, counter_from_arrays
from ploidyfrost_tpu_torch.kmer.countdb import KmerCountDB
from test_torch_helpers import few_torch_threads  # noqa: F401  (autouse fixture)


def _read_batches(seed, n_batches=3, B=64, L=80, G=3000, n_rate=0.002):
    """Reads sampled from a small genome (so k-mers repeat), with Ns
    and short rows padded by the invalid code, as read_batches yields."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, G).astype(np.uint8)
    out = []
    for _ in range(n_batches):
        starts = rng.integers(0, G - L, B)
        codes = genome[starts[:, None] + np.arange(L)[None, :]].copy()
        codes[rng.random((B, L)) < n_rate] = 4
        lens = rng.integers(L // 2, L + 1, B)
        codes[np.arange(L)[None, :] >= lens[:, None]] = 4
        out.append(codes)
    return out


def _counters(k, counter_max, **port_kw):
    j = JaxCounter(k, counter_max=counter_max, initial_capacity=64)
    t = KmerCounter(k, counter_max=counter_max, device="cpu", **port_kw)
    return j, t


def _assert_same(j, t):
    jk, jc = j.arrays()
    tk, tc = t.arrays()
    assert tk.dtype == np.uint64 and tc.dtype == np.int64
    np.testing.assert_array_equal(tk, np.asarray(jk, dtype=np.uint64))
    np.testing.assert_array_equal(tc, np.asarray(jc, dtype=np.int64))
    np.testing.assert_array_equal(t.histogram(100), np.asarray(j.histogram(100)))
    assert t.total_kmers == j.total_kmers
    assert t.num_unique == j.num_unique


@pytest.mark.parametrize("k,counter_max", [(15, 10000), (21, 7), (25, 3), (31, 10000)])
def test_counter_matches_jax(k, counter_max):
    j, t = _counters(k, counter_max, buffer_capacity=3000)
    for codes in _read_batches(k):
        j.add_reads(codes)
        t.add_reads(codes)
    _assert_same(j, t)
    assert j.capacity > 64  # the JAX counter grew and replayed


def test_saturation_is_reached():
    j, t = _counters(11, 2, buffer_capacity=2500)
    for codes in _read_batches(5, n_batches=4):
        j.add_reads(codes)
        t.add_reads(codes)
    _, tc = t.arrays()
    assert tc.max() == 2 and (tc == 2).sum() > 100
    _assert_same(j, t)


def test_batch_larger_than_buffer():
    j, t = _counters(17, 10000, buffer_capacity=700)
    for codes in _read_batches(9, n_batches=2):
        j.add_reads(codes)
        t.add_reads(codes)
    _assert_same(j, t)


@pytest.mark.parametrize("max_cov", [5, 50, 10000])
def test_histogram_and_cutoffs(max_cov):
    j, t = _counters(19, 10000)
    for codes in _read_batches(3, n_batches=4, B=128):
        j.add_reads(codes)
        t.add_reads(codes)
    th, jh = t.histogram(max_cov), np.asarray(j.histogram(max_cov))
    np.testing.assert_array_equal(th, jh)
    assert th[0] == 0
    full_t, full_j = list(t.histogram(10000)[1:]), list(np.asarray(j.histogram(10000))[1:])
    assert cutoff_lower_from_counts(full_t) == cutoff_lower_from_counts(full_j)
    assert cutoff_upper_from_counts(full_t, 0.998) == cutoff_upper_from_counts(full_j, 0.998)


def test_write_histogram_matches(tmp_path):
    j, t = _counters(15, 10000)
    for codes in _read_batches(4):
        j.add_reads(codes)
        t.add_reads(codes)
    j.write_histogram(str(tmp_path / "j.txt"), 300)
    t.write_histogram(str(tmp_path / "t.txt"), 300)
    assert (tmp_path / "j.txt").read_bytes() == (tmp_path / "t.txt").read_bytes()


@pytest.mark.parametrize("counter_max", [4, 10000])
def test_state_carried_from_jax_counter(counter_max):
    """Seed the port's table with the JAX counter's arrays, then both
    take the same further batches: the merges must agree."""
    k = 21
    batches = _read_batches(11, n_batches=5)
    j = JaxCounter(k, counter_max=counter_max, initial_capacity=64)
    for codes in batches[:3]:
        j.add_reads(codes)
    km, ct = j.arrays()
    t = counter_from_arrays(np.asarray(km), np.asarray(ct), k, device="cpu",
                            counter_max=counter_max, buffer_capacity=4000)
    for codes in batches[3:]:
        j.add_reads(codes)
        t.add_reads(codes)
    jk, jc = j.arrays()
    tk, tc = t.arrays()
    np.testing.assert_array_equal(tk, np.asarray(jk, dtype=np.uint64))
    np.testing.assert_array_equal(tc, np.asarray(jc))
    np.testing.assert_array_equal(t.histogram(10000), np.asarray(j.histogram(10000)))


def test_from_arrays_rejects_unsorted():
    with pytest.raises(ValueError):
        counter_from_arrays(np.array([5, 3], np.uint64), np.array([1, 1]), 5, device="cpu")


@pytest.mark.parametrize("n_queries", [100, 20000])
def test_countdb_lookup_matches_jax(n_queries):
    """Lookups on a table carried over from the JAX counter: counts and
    hits for queries on either strand, present and absent. 20000
    queries take the native bucketed probe, 100 the numpy one."""
    k = 25
    j = JaxCounter(k, initial_capacity=64)
    for codes in _read_batches(13, n_batches=3, B=128):
        j.add_reads(codes)
    km, ct = j.arrays()
    km = np.asarray(km, dtype=np.uint64)
    ct = np.asarray(ct)
    jdb = JaxDB(km, ct, k)
    tdb = KmerCountDB(km, ct, k)
    rng = np.random.default_rng(n_queries)
    from ploidyfrost_tpu_torch.kmer.pack import revcomp_np

    present = km[rng.integers(0, len(km), n_queries // 2)]
    present[::2] = revcomp_np(present[::2], k)
    absent = rng.integers(0, 1 << (2 * k), n_queries - len(present), dtype=np.uint64)
    q = np.concatenate([present, absent])
    jc, jh = jdb.lookup(q)
    tc, th = tdb.lookup(q)
    np.testing.assert_array_equal(tc, np.asarray(jc))
    np.testing.assert_array_equal(th, np.asarray(jh))
    assert th[: len(present)].all()


def test_counter_requires_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        KmerCounter(25)

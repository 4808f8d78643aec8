"""The port's k-mer packing, counter, count table and cutoffs against the
JAX package (the counterpart of tests/test_kmer.py).

Every case feeds the same inputs, made from a seed with numpy, to the
JAX function and to the port's, and holds the results exactly equal,
besides the brute-force and hand-computed expectations of
tests/test_kmer.py. Three public methods are held here first:
`KmerCounter.add_kmers`, `KmerCountDB.from_counter` and
`KmerCountDB.lookup_strings`.

Not ported: tests/test_kmer.py's nibble and 2-bit packed extraction
cases and `_delta_compress` (test_kmer.py:185-306). They test the JAX
counter's host-to-TPU transfer encodings and its compressed table
download; the port copies code batches and tables as they are, and K1
(kmer/extract.py) is held against its plain version in
tests/test_torch_extract.py.
"""

from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ploidyfrost_tpu.kmer import pack as jpack
from ploidyfrost_tpu.kmer.count import KmerCounter as JaxCounter
from ploidyfrost_tpu.kmer.countdb import KmerCountDB as JaxDB
from ploidyfrost_tpu_torch.kmer import cutoffs, pack
from ploidyfrost_tpu_torch.kmer.count import KmerCounter
from ploidyfrost_tpu_torch.kmer.countdb import KmerCountDB
from test_torch_helpers import few_torch_threads  # noqa: F401  (autouse fixture)


def revcomp_str(s):
    return s[::-1].translate(str.maketrans("ACGT", "TGCA"))


def brute_force_counts(reads, k):
    c = Counter()
    for r in reads:
        for i in range(len(r) - k + 1):
            w = r[i : i + k]
            if set(w) <= set("ACGT"):
                c[min(w, revcomp_str(w))] += 1
    return c


def _batch(reads):
    L = max(len(r) for r in reads)
    batch = np.full((len(reads), L), pack.INVALID_BASE, dtype=np.uint8)
    for i, r in enumerate(reads):
        batch[i, : len(r)] = pack.encode_bases(r)
    return batch


def _table(counter, k):
    km, ct = counter.arrays()
    return dict(zip(pack.decode_kmers(np.asarray(km), k), np.asarray(ct).tolist()))


def _assert_counters_equal(j, t, max_cov=100):
    jk, jc = j.arrays()
    tk, tc = t.arrays()
    assert tk.dtype == np.uint64 and tc.dtype == np.int64
    np.testing.assert_array_equal(tk, np.asarray(jk, dtype=np.uint64))
    np.testing.assert_array_equal(tc, np.asarray(jc, dtype=np.int64))
    np.testing.assert_array_equal(t.histogram(max_cov), np.asarray(j.histogram(max_cov)))
    assert t.total_kmers == j.total_kmers
    assert t.num_unique == j.num_unique


# -- packing ------------------------------------------------------------------


def test_encode_decode_roundtrip():
    s = "ACGTTGCAAACCGGT"
    v = pack.encode_kmer_string(s)
    assert v == jpack.encode_kmer_string(s)
    assert pack.decode_kmers(np.array([v], dtype=np.uint64), len(s)) == [s]


def test_encode_lexicographic_order():
    kmers = ["AAAC", "AACA", "ACGT", "CAAA", "TTTT"]
    vals = [pack.encode_kmer_string(s) for s in kmers]
    assert vals == sorted(vals) == [jpack.encode_kmer_string(s) for s in kmers]


@pytest.mark.parametrize("k", [3, 11, 25, 31])
def test_revcomp_and_canonical_match_strings_and_jax(k):
    rng = np.random.default_rng(k)
    strs = ["".join(rng.choice(list("ACGT"), size=k)) for _ in range(20)]
    v = np.array([pack.encode_kmer_string(s) for s in strs], dtype=np.uint64)
    rc = pack.revcomp_kmers(torch.from_numpy(v.view(np.int64)), k).numpy().view(np.uint64)
    assert pack.decode_kmers(rc, k) == [revcomp_str(s) for s in strs]
    np.testing.assert_array_equal(rc, np.asarray(jpack.revcomp_kmers(jnp.asarray(v), k)))
    np.testing.assert_array_equal(pack.revcomp_np(v, k), rc)
    canon = pack.canonical_kmers(torch.from_numpy(v.view(np.int64)), k).numpy().view(np.uint64)
    want = [min(pack.encode_kmer_string(s), pack.encode_kmer_string(revcomp_str(s)))
            for s in strs]
    assert canon.tolist() == want
    np.testing.assert_array_equal(canon, np.asarray(jpack.canonical_kmers(jnp.asarray(v), k)))


def test_canonical_is_min():
    k, s = 7, "GATTACA"
    v = torch.tensor([pack.encode_kmer_string(s)])
    assert int(pack.canonical_kmers(v, k)[0]) == min(
        pack.encode_kmer_string(s), pack.encode_kmer_string(revcomp_str(s)))


def test_sequence_kmers_with_invalid():
    codes = pack.encode_bases("ACGTNACGT")[None, :]
    k = 3
    kmers, valid = pack.sequence_kmers(torch.from_numpy(codes), k)
    assert tuple(kmers.shape) == (1, 7)
    assert valid[0].tolist() == [True, True, False, False, False, True, True]
    assert pack.decode_kmers(kmers[0][valid[0]].numpy().view(np.uint64), k) == [
        "ACG", "CGT", "ACG", "CGT"]
    jk, jv = jpack.sequence_kmers(jnp.asarray(codes), k)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(kmers[valid].numpy(), np.asarray(jk)[np.asarray(jv)])


@pytest.mark.parametrize("k", [5, 25, 31])
def test_batch_kmers_match_jax(k):
    rng = np.random.default_rng(100 + k)
    codes = rng.integers(0, 4, (16, 64)).astype(np.uint8)
    codes[rng.random(codes.shape) < 0.02] = pack.INVALID_BASE
    tk, tv = pack.batch_kmers(torch.from_numpy(codes), k)
    jk, jv = jpack.batch_kmers(jnp.asarray(codes), k)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tk.numpy()[tv.numpy()].view(np.uint64),
                                  np.asarray(jk)[np.asarray(jv)])
    for row in range(len(codes)):
        hk, hv = pack.sequence_kmers_np(codes[row], k)
        np.testing.assert_array_equal(hv, tv[row].numpy())
        np.testing.assert_array_equal(pack.canonical_np(hk, k)[hv],
                                      tk[row].numpy()[hv].view(np.uint64))


# -- the counter ----------------------------------------------------------------


def test_counter_matches_bruteforce_and_jax():
    rng = np.random.default_rng(42)
    k = 5
    reads = ["".join(rng.choice(list("ACGTN"), p=[0.24, 0.24, 0.24, 0.24, 0.04], size=40))
             for _ in range(50)]
    batch = _batch(reads)
    t = KmerCounter(k, device="cpu")
    j = JaxCounter(k)
    t.add_reads(batch)
    j.add_reads(batch)
    assert _table(t, k) == dict(brute_force_counts(reads, k))
    _assert_counters_equal(j, t)


def test_counter_streaming_merge():
    k = 4
    t = KmerCounter(k, device="cpu", buffer_capacity=600)
    j = JaxCounter(k, initial_capacity=64)
    rng = np.random.default_rng(1)
    reads_all = []
    for _ in range(5):
        reads = ["".join(rng.choice(list("ACGT"), size=30)) for _ in range(20)]
        reads_all += reads
        batch = np.stack([pack.encode_bases(r) for r in reads])
        t.add_reads(batch)
        j.add_reads(batch)
    expect = {s: min(c, t.counter_max) for s, c in brute_force_counts(reads_all, k).items()}
    assert _table(t, k) == expect
    _assert_counters_equal(j, t)


def test_histogram():
    k = 3
    t = KmerCounter(k, device="cpu")
    j = JaxCounter(k)
    batch = pack.encode_bases("AAAAA")[None, :]  # AAA x3 canonical
    t.add_reads(batch)
    j.add_reads(batch)
    hist = t.histogram(10)
    assert hist[3] == 1 and hist.sum() == 1
    np.testing.assert_array_equal(hist, np.asarray(j.histogram(10)))


def _seeded_keys(seed, k, n, n_distinct):
    """n canonical keys drawn from n_distinct of them, as uint64, so
    that they repeat; and a valid mask with about a tenth False."""
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 1 << (2 * k), n_distinct, dtype=np.uint64)
    pool = pack.canonical_np(raw, k)
    keys = pool[rng.integers(0, n_distinct, n)]
    return keys, rng.random(n) > 0.1


@pytest.mark.parametrize("with_valid", [False, True], ids=["all-valid", "valid-mask"])
@pytest.mark.parametrize("k,n,buffer,counter_max", [
    (25, 5000, 1 << 20, 10000),  # one push, one collapse
    (31, 5000, 1200, 10000),     # an input longer than the buffer: chunks and flushes
    (21, 3000, 700, 3),          # saturation at counter_max across merges
], ids=["in-buffer", "longer-than-buffer", "saturating"])
def test_add_kmers_matches_jax(k, n, buffer, counter_max, with_valid):
    keys, valid = _seeded_keys(k + n, k, n, 400)
    mask = valid if with_valid else None
    t = KmerCounter(k, counter_max=counter_max, buffer_capacity=buffer, device="cpu")
    j = JaxCounter(k, counter_max=counter_max, initial_capacity=64,
                   buffer_capacity=max(buffer, 1024))
    half = n // 2
    for part in (slice(0, half), slice(half, n)):  # two calls: merges across them
        t.add_kmers(keys[part], None if mask is None else mask[part])
        j.add_kmers(keys[part], None if mask is None else mask[part])
    _assert_counters_equal(j, t)
    counted = keys[valid] if with_valid else keys
    assert t.total_kmers == len(counted)
    want = Counter(counted.tolist())
    km, ct = t.arrays()
    assert dict(zip(km.tolist(), ct.tolist())) == {
        key: min(c, counter_max) for key, c in want.items()}
    if counter_max < 10000:
        assert ct.max() == counter_max


def test_add_kmers_takes_tensors_and_mixes_with_reads():
    """A tensor of keys (and of flags) counts as the numpy array does,
    and add_kmers and add_reads feed one table."""
    k = 11
    keys, valid = _seeded_keys(3, k, 2000, 300)
    rng = np.random.default_rng(4)
    batch = rng.integers(0, 4, (8, 40)).astype(np.uint8)
    t = KmerCounter(k, buffer_capacity=500, device="cpu")
    j = JaxCounter(k, initial_capacity=64)
    t.add_reads(batch)
    j.add_reads(batch)
    t.add_kmers(torch.from_numpy(keys.view(np.int64)), torch.from_numpy(valid))
    j.add_kmers(keys, valid)
    _assert_counters_equal(j, t)


def test_add_kmers_rejects_keys_past_62_bits():
    t = KmerCounter(31, device="cpu")
    with pytest.raises(ValueError, match="2\\^62"):
        t.add_kmers(np.array([1, 1 << 62], dtype=np.uint64))
    with pytest.raises(ValueError, match="2\\^62"):
        t.add_kmers(np.array([np.iinfo(np.uint64).max], dtype=np.uint64))


# -- the count table --------------------------------------------------------------


def _counted_reads(seed=9, k=21, B=64, L=90, G=2000):
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, G).astype(np.uint8)
    starts = rng.integers(0, G - L, B)
    codes = genome[starts[:, None] + np.arange(L)[None, :]]
    t, j = KmerCounter(k, device="cpu"), JaxCounter(k)
    t.add_reads(codes)
    j.add_reads(codes)
    return t, j, pack.decode_bases(genome)


@pytest.mark.parametrize("min_count", [1, 3])
def test_from_counter_matches_jax(min_count):
    t, j, genome = _counted_reads()
    tdb = KmerCountDB.from_counter(t, min_count=min_count)
    jdb = JaxDB.from_counter(j, min_count=min_count)
    km, ct = t.arrays()
    assert len(tdb) == len(jdb) == int((ct >= min_count).sum())
    if min_count > 1:
        assert len(tdb) < len(km)
    rng = np.random.default_rng(min_count)
    q = np.concatenate([km, pack.revcomp_np(km, t.k),
                        rng.integers(0, 1 << 42, 500, dtype=np.uint64)])
    tc, th = tdb.lookup(q)
    jc, jh = jdb.lookup(q)
    np.testing.assert_array_equal(th, np.asarray(jh))
    np.testing.assert_array_equal(tc, np.asarray(jc))
    np.testing.assert_array_equal(th[: len(km)], ct >= min_count)


def test_countdb_lookup_strings():
    k = 4
    reads = ["ACGTACGTAC", "TTTTACGTAA"]
    t = KmerCounter(k, device="cpu")
    t.add_reads(_batch(reads))
    db = KmerCountDB.from_counter(t)
    bf = brute_force_counts(reads, k)
    res = db.lookup_strings(["ACGTA", "TTTT"])
    assert list(res[0]) == [bf[min("ACGT", revcomp_str("ACGT"))],
                            bf[min("CGTA", revcomp_str("CGTA"))]]
    assert list(res[1]) == [bf[min("TTTT", revcomp_str("TTTT"))]]
    assert db.lookup_strings([]) == []
    with pytest.raises(KeyError):
        db.lookup_strings(["GGGG"])


def test_lookup_strings_matches_jax():
    """Window strings of the genome the reads came from, some longer
    than others, one of length k: per-string counts equal to the JAX
    table's; a string with an uncounted window raises the JAX package's
    KeyError."""
    t, j, genome = _counted_reads()
    tdb, jdb = KmerCountDB.from_counter(t), JaxDB.from_counter(j)
    km, _ = t.arrays()
    rng = np.random.default_rng(11)
    present = set(pack.decode_kmers(km, t.k))
    strings = []
    while len(strings) < 40:
        n = int(rng.integers(t.k, 3 * t.k))
        s0 = int(rng.integers(0, len(genome) - n))
        s = genome[s0 : s0 + n]
        if all(min(s[i : i + t.k], revcomp_str(s[i : i + t.k])) in present
               for i in range(n - t.k + 1)):
            strings.append(revcomp_str(s) if len(strings) % 3 == 0 else s)
    strings.append(strings[0][: t.k])
    got, want = tdb.lookup_strings(strings), jdb.lookup_strings(strings)
    assert len(got) == len(want) == len(strings)
    for s, g, w in zip(strings, got, want):
        assert len(g) == len(s) - t.k + 1
        np.testing.assert_array_equal(g, np.asarray(w))
    absent = strings[1][:-1] + ("A" if strings[1][-1] != "A" else "C")
    absent = next(a for a in (absent, "A" * t.k, "C" * t.k, "ACGT" * 8)
                  if min(a[-t.k:], revcomp_str(a[-t.k:])) not in present)
    bad = [strings[2], absent]
    with pytest.raises(KeyError) as te:
        tdb.lookup_strings(bad)
    with pytest.raises(KeyError) as je:
        jdb.lookup_strings(bad)
    assert str(te.value) == str(je.value)


# -- cutoffs: exact ports of src/Main.cpp:200-277 ---------------------------------


@pytest.mark.parametrize("counts,want", [
    ([100, 50, 20, 10, 15, 30, 10], 4),  # valley: first rise at i=4 -> round(1.25*3)
    ([5, 4, 3, 2, 1], 5),                # never rises: round(1.25*4)
])
def test_cutoff_lower(counts, want):
    from ploidyfrost_tpu.kmer.cutoffs import cutoff_lower_from_counts as jax_lower

    assert cutoffs.cutoff_lower_from_counts(counts) == jax_lower(counts) == want


def test_cutoff_upper_quantile():
    from ploidyfrost_tpu.kmer.cutoffs import cutoff_upper_from_counts as jax_upper

    counts = [1000, 10, 10, 10, 10, 10, 10, 10, 10, 10]
    assert cutoffs.cutoff_upper_from_counts(counts, 0.5) == jax_upper(counts, 0.5) == 6


def test_cutoff_roundtrip_files(tmp_path):
    from ploidyfrost_tpu.kmer import cutoffs as jcut

    p = tmp_path / "hist.txt"
    counts = [100, 50, 20, 10, 15, 30, 10]
    p.write_text("".join(f"{i + 1}\t{c}\n" for i, c in enumerate(counts)))
    assert cutoffs.cutoff_lower(str(p)) == jcut.cutoff_lower(str(p)) == 4
    assert cutoffs.cutoff_upper(str(p), 0.998) == jcut.cutoff_upper(str(p), 0.998) == 7


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cutoffs_of_seeded_histograms_match_jax(seed):
    from ploidyfrost_tpu.kmer.cutoffs import (cutoff_lower_from_counts as jax_lower,
                                              cutoff_upper_from_counts as jax_upper)

    rng = np.random.default_rng(seed)
    cov = np.arange(1, 200)
    hist = (1e5 * np.exp(-cov / 3.0) + 4e3 * np.exp(-0.5 * ((cov - 30) / 6.0) ** 2)
            + rng.integers(0, 50, len(cov))).astype(int).tolist()
    for q in (0.5, 0.9, 0.998):
        assert cutoffs.cutoff_upper_from_counts(hist, q) == jax_upper(hist, q)
    assert cutoffs.cutoff_lower_from_counts(hist) == jax_lower(hist)

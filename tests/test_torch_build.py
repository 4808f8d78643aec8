"""The two torch programs of the port that replace jitted XLA programs.

  * graph/construct.device_link_step and _links_junctions_device (the
    `--device-build` link path: junction keys, stable sort, pair
    detection) against the JAX package's _links_junctions_device and the
    host _links_junctions of both packages, on the seeds of
    tests/test_construct.py, palindromic junctions included;
  * kmer/countdb.lookup_device against the JAX package's jitted _lookup
    and the port's host KmerCountDB.lookup.

All comparisons are exact. The device is the CPU here.
"""

import os

import numpy as np
import pytest
import torch

import ploidyfrost_tpu.graph.construct as jax_construct
import ploidyfrost_tpu_torch.graph.construct as port_construct
from ploidyfrost_tpu_torch.kmer.countdb import KmerCountDB, lookup_device
from ploidyfrost_tpu_torch.kmer.pack import canonical_np, revcomp_np, sequence_kmers_np
from test_torch_helpers import few_torch_threads  # noqa: F401  (autouse fixture)

CPU = torch.device("cpu")


def _random_kmers(rng, k, n):
    km = rng.integers(0, 1 << (2 * k), size=n, dtype=np.uint64)
    km = np.unique(canonical_np(km, k))
    return km, revcomp_np(km, k)


@pytest.mark.parametrize("n", [50, 700, 4000])
@pytest.mark.parametrize("k", [5, 7, 25, 31])
def test_device_links_match_jax_and_host(k, n):
    # one generator per case; the JAX test's own loop is the next test
    rng = np.random.default_rng(5 + 1000 * k + n)
    km, rc = _random_kmers(rng, k, n)
    got = port_construct._links_junctions_device(km, rc, k, CPU)
    assert got.dtype == np.int64 and got.shape == (2 * len(km),)
    np.testing.assert_array_equal(got, port_construct._links_junctions(km, rc, k))
    np.testing.assert_array_equal(got, jax_construct._links_junctions(km, rc, k))
    if k < 31:  # the JAX device path pads with all-ones u64 and is tested to k = 25
        np.testing.assert_array_equal(got, jax_construct._links_junctions_device(km, rc, k))


def test_device_links_same_generator_as_jax_test():
    """The exact loop of tests/test_construct.py::test_device_links_match_host_links."""
    rng = np.random.default_rng(5)
    for k in (5, 7, 25):
        for n in (50, 700, 4000):
            km, rc = _random_kmers(rng, k, n)
            np.testing.assert_array_equal(
                port_construct._links_junctions_device(km, rc, k, CPU),
                jax_construct._links_junctions_device(km, rc, k),
                err_msg=f"k={k} n={n}",
            )


def test_device_links_hit_palindromic_junctions():
    """k = 5 and 7 make (k-1)-mer palindromes frequent: the fallback
    must really run in the cases above."""
    rng = np.random.default_rng(5)
    km, rc = _random_kmers(rng, 5, 700)
    mask = np.uint64((1 << 8) - 1)
    suf = np.concatenate([km & mask, rc & mask])
    assert (suf == revcomp_np(suf, 4)).any()
    np.testing.assert_array_equal(
        port_construct._links_junctions_device(km, rc, 5, CPU),
        port_construct._links_probes(km, rc, 5),
    )


@pytest.mark.parametrize("n", [0, 1])
def test_device_links_empty_and_single(n):
    k = 25
    km = np.array([0x1B2E4D5A7C3][:n], dtype=np.uint64)
    km = canonical_np(km, k)
    rc = revcomp_np(km, k)
    got = port_construct._links_junctions_device(km, rc, k, CPU)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, np.full(2 * n, -1, dtype=np.int64))
    np.testing.assert_array_equal(got, jax_construct._links_junctions_device(km, rc, k))
    if n:  # the host path is never given an empty set
        np.testing.assert_array_equal(got, port_construct._links_junctions(km, rc, k))


def test_device_link_step_on_tensors():
    """The tensor core alone: two stubs of opposite polarity on one
    junction pair up, three on one junction do not, equal polarity does
    not, a palindrome does not, twins of one k-mer do not."""
    # nodes 0, 2: a pair; 1, 3, 4: a triple; 5, 6: equal polarity;
    # 7, 8: a palindrome; 9: alone; 10, 11: the twins of one k-mer
    jc = torch.tensor([7, 9, 7, 9, 9, 11, 11, 5, 5, 3, 2, 2], dtype=torch.int64)
    pol = torch.tensor([1, 1, 0, 0, 0, 1, 1, 1, 0, 1, 1, 0], dtype=torch.bool)
    pal = torch.tensor([0, 0, 0, 0, 0, 0, 0, 1, 1, 0, 0, 0], dtype=torch.bool)
    nxt = port_construct.device_link_step(jc, pol, pal)
    assert nxt.dtype == torch.int64
    assert nxt.tolist() == [3, -1, 1, -1, -1, -1, -1, -1, -1, -1, -1, -1]
    # a pair split across the ends of the sorted order never wraps around
    jc = torch.tensor([4, 1, 2, 4], dtype=torch.int64)
    pol = torch.tensor([1, 1, 0, 0], dtype=torch.bool)
    nxt = port_construct.device_link_step(jc, pol, torch.zeros(4, dtype=torch.bool))
    assert nxt.tolist() == [2, -1, -1, 1]


def _two_haplotype_kmers(seed=9, G=30_000, k=25):
    rng = np.random.default_rng(seed)
    g1 = rng.integers(0, 4, G).astype(np.uint8)
    g2 = g1.copy()
    snp = rng.random(G) < 0.01
    g2[snp] = (g2[snp] + rng.integers(1, 4, snp.sum())) % 4
    k1, _ = sequence_kmers_np(g1, k)
    k2, _ = sequence_kmers_np(g2, k)
    return np.unique(canonical_np(np.concatenate([k1, k2]), k)), (g1, g2)


def test_link_device_graph_identical(tmp_path):
    """build_graph_from_kmers(link_device=...) writes a byte-identical
    GFA, which is also the JAX package's."""
    km, _ = _two_haplotype_kmers()
    port_construct.build_graph_from_kmers(km, 25).write_gfa(str(tmp_path / "host.gfa"))
    port_construct.build_graph_from_kmers(km, 25, link_device=CPU).write_gfa(
        str(tmp_path / "dev.gfa")
    )
    jax_construct.build_graph_from_kmers(km, 25).write_gfa(str(tmp_path / "jax.gfa"))
    host = (tmp_path / "host.gfa").read_bytes()
    assert host == (tmp_path / "dev.gfa").read_bytes()
    assert host == (tmp_path / "jax.gfa").read_bytes()


def _write_reads(path, haps, rng):
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    with open(path, "w") as f:
        n = 0
        for hap in haps:
            seq = bases[hap].tobytes().decode()
            for _ in range(6):
                for st in rng.integers(0, len(seq) - 150, len(seq) // 150):
                    n += 1
                    f.write(f">r{n}\n{seq[st:st + 150]}\n")


@pytest.mark.parametrize("colored", [False, True], ids=["build", "build-c"])
def test_cli_build_with_and_without_device_build(tmp_path, monkeypatch, colored):
    """`build` and `build -c` with --device-build write byte-identical
    files, and the flag really reaches the torch link step."""
    from ploidyfrost_tpu_torch.cli import main

    _, haps = _two_haplotype_kmers()
    rng = np.random.default_rng(3)
    monkeypatch.chdir(tmp_path)
    _write_reads("a.fa", haps, rng)
    _write_reads("b.fa", haps[:1], rng)
    calls = []
    real = port_construct._links_junctions_device

    def spy(km, rc, k, device):
        calls.append(torch.device(device))
        return real(km, rc, k, device)

    monkeypatch.setattr(port_construct, "_links_junctions_device", spy)
    args = ["build", "-k", "25", *(["-c"] if colored else []), "a.fa", *(["b.fa"] if colored else [])]
    assert main([*args, "-o", "host", "--device=cpu"]) == 0
    assert calls == []
    assert main([*args, "-o", "dev", "--device=cpu", "--device-build"]) == 0
    assert calls == [CPU]
    assert (tmp_path / "host.gfa").read_bytes() == (tmp_path / "dev.gfa").read_bytes()
    assert os.path.getsize("host.gfa") > 30_000
    if colored:
        a, b = np.load("host.colors.npz"), np.load("dev.colors.npz")
        for key in a.files:
            np.testing.assert_array_equal(a[key], b[key])


# -- lookup_device ----------------------------------------------------------


def _jax_lookup(km, ct, q, k):
    import jax.numpy as jnp

    from ploidyfrost_tpu.kmer.countdb import KmerCountDB as JaxDB
    from ploidyfrost_tpu.kmer.countdb import _lookup

    db = JaxDB(km, ct, k)
    counts, hit = _lookup(db._km, db._ct, jnp.asarray(q), k)
    return np.asarray(counts), np.asarray(hit)


def _as_i64(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint64).view(np.int64).copy())


@pytest.mark.parametrize("k,n", [(1, 2), (3, 20), (25, 20000), (31, 6000)])
def test_lookup_device_matches_jax_and_host(k, n):
    rng = np.random.default_rng(100 + k)
    km = np.unique(canonical_np(rng.integers(0, 1 << (2 * k), n, dtype=np.uint64), k))
    ct = rng.integers(1, 10000, len(km)).astype(np.int64)
    present = km[rng.integers(0, len(km), 3 * n)]
    q = np.concatenate([
        present[:n],
        revcomp_np(present[n:], k),  # the other strand
        rng.integers(0, 1 << (2 * k), 2 * n, dtype=np.uint64),  # absent ones among them
    ])
    counts, hit = lookup_device(_as_i64(km), torch.from_numpy(ct), _as_i64(q), k)
    assert counts.dtype == torch.int64 and hit.dtype == torch.bool
    counts, hit = counts.numpy(), hit.numpy()
    h_counts, h_hit = KmerCountDB(km, ct, k).lookup(q)
    np.testing.assert_array_equal(counts, h_counts)
    np.testing.assert_array_equal(hit, h_hit)
    j_counts, j_hit = _jax_lookup(km, ct, q, k)
    np.testing.assert_array_equal(counts, j_counts)
    np.testing.assert_array_equal(hit, j_hit)
    assert hit[: 3 * n].all()
    assert (counts[~hit] == 0).all() and (counts[hit] > 0).all()
    if k >= 25:
        assert not hit[3 * n :].all()


def test_lookup_device_empty_table_and_empty_queries():
    k = 25
    empty = torch.empty(0, dtype=torch.int64)
    q = _as_i64(np.array([0, 5, 1 << 40], dtype=np.uint64))
    counts, hit = lookup_device(empty, empty, q, k)
    assert counts.tolist() == [0, 0, 0] and hit.tolist() == [False] * 3
    h_counts, h_hit = KmerCountDB(np.zeros(0, np.uint64), np.zeros(0, np.int64), k).lookup(q.numpy())
    assert h_counts.tolist() == [0, 0, 0] and not h_hit.any()
    km = _as_i64(np.array([3, 9], dtype=np.uint64))
    counts, hit = lookup_device(km, torch.tensor([4, 6]), empty, k)
    assert counts.shape == (0,) and hit.shape == (0,)


def test_lookup_device_keeps_query_shape_and_top_key():
    """A query above every key clamps to the last row and misses; the
    last key itself hits; a 2-d batch keeps its shape."""
    k = 31
    top = np.uint64((1 << 62) - 1)  # TTT...T, canonical form AAA...A = 0
    km = np.array([0, 77, 1 << 61], dtype=np.uint64)
    q = np.array([[top, 77], [(1 << 61) + 1, 1 << 61]], dtype=np.uint64)
    counts, hit = lookup_device(_as_i64(km), torch.tensor([5, 6, 7]), _as_i64(q), k)
    expect_hit = np.isin(canonical_np(q, k), km)
    assert counts.shape == (2, 2)
    np.testing.assert_array_equal(hit.numpy(), expect_hit)
    h_counts, _ = KmerCountDB(km, np.array([5, 6, 7]), k).lookup(q.ravel())
    np.testing.assert_array_equal(counts.numpy().ravel(), h_counts)

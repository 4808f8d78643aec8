"""The torch port's batched superbubble search against the JAX package.

On the random graph classes of tests/test_batched.py (genome-like graphs
with het SNPs, dense random tangles, a circular genome whose bubble exit
loops back to its entrance) the port's search outputs (status, psec,
nseen, seen, cycle mask) must equal `ploidyfrost_tpu.bubble.batched.
search_seeds` exactly, and the port's graph + search + replay must give
the JAX package's bubble list and state arrays. The search loop runs
every seed in one batch, freezing finished lanes; these graphs mix every
outcome class, so a lane corrupted after it finished would show.
"""

import collections

import numpy as np
import pytest

from ploidyfrost_tpu.bubble import batched as J
from ploidyfrost_tpu.graph.construct import _canon_np
from ploidyfrost_tpu.graph.construct import build_graph_from_kmers as jax_build
from ploidyfrost_tpu.kmer.pack import string_kmers_np
from ploidyfrost_tpu_torch.bubble import batched as T
from ploidyfrost_tpu_torch.graph.construct import build_graph_from_kmers as port_build
from test_torch_helpers import few_torch_threads  # noqa: F401  (autouse fixture)

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def _genome_kmers(seed, G=20000, k=15, snp=0.02, nhap=3):
    rng = np.random.default_rng(seed)
    g1 = rng.integers(0, 4, G)
    haps = [g1]
    for _ in range(nhap - 1):
        g2 = g1.copy()
        m = rng.random(G) < snp
        g2[m] = (g2[m] + rng.integers(1, 4, m.sum())) % 4
        haps.append(g2)
    seqs = [BASES[h].tobytes().decode() for h in haps]
    return np.unique(np.concatenate([_canon_np(string_kmers_np(s, k), k) for s in seqs]))


def _tangle_kmers(seed, frac=0.3):
    rng = np.random.default_rng(seed)
    k = int(rng.integers(5, 8))
    km = np.unique(rng.integers(0, 4**k, int(4**k * frac)).astype(np.uint64))
    return np.unique(_canon_np(km, k)), k


def _circular_kmers():
    rng = np.random.default_rng(7)
    g1 = rng.integers(0, 4, 220)
    g2 = g1.copy()
    g2[110] = (g2[110] + 1) % 4
    seqs = [BASES[h].tobytes().decode() * 2 for h in (g1, g2)]
    return np.unique(np.concatenate([_canon_np(string_kmers_np(s, 25), 25) for s in seqs]))


def _seeds(g):
    deg = np.asarray(g._out_deg)
    return np.array(
        [i * 2 + s for i in range(len(g)) for s in (1, 0) if deg[i, s] > 1], np.int32
    )


def _assert_same(km, k):
    gj = jax_build(km, k)
    gt = port_build(km, k)
    np.testing.assert_array_equal(gt._succ, gj._succ)
    seeds = _seeds(gj)
    got = T.search_seeds(gt, seeds, device="cpu")
    want = J.search_seeds(gj, seeds)
    for name, a, b in zip(("status", "psec", "nseen", "seen", "cyc"), got, want):
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    sj, bj = J.find_superbubbles_device(gj)
    st, bt = T.find_superbubbles_device(gt, device="cpu")
    np.testing.assert_array_equal(st.flags, sj.flags)
    np.testing.assert_array_equal(st.plus, sj.plus)
    np.testing.assert_array_equal(st.minus, sj.minus)
    key = lambda b: (b.bubble_id, b.entrance, b.strand, b.exit, b.strict, b.complex)  # noqa: E731
    assert [key(b) for b in bt] == [key(b) for b in bj]
    return collections.Counter(got[0].tolist()), bt


@pytest.mark.parametrize("seed", range(4))
def test_genome_bubbles(seed):
    k = 11 + seed
    _, bubbles = _assert_same(_genome_kmers(seed, k=k, snp=0.01 + 0.01 * seed), k)
    assert bubbles


@pytest.mark.parametrize("seed", range(4))
def test_dense_tangle(seed):
    km, k = _tangle_kmers(seed)
    _assert_same(km, k)


def test_circular_cycle_exit():
    stats, _ = _assert_same(_circular_kmers(), 25)
    assert stats.get(T.STAT_CYCLE_EXIT, 0) > 0


def test_outcome_classes_exercised():
    """Together the graphs reach every outcome class, the host-fallback
    overflow included, so frozen-lane handling is exercised."""
    total = collections.Counter()
    for seed in range(2):
        stats, _ = _assert_same(_genome_kmers(seed, G=6000, k=11, snp=0.03), 11)
        total += stats
    for seed in range(2):
        km, k = _tangle_kmers(seed + 100, frac=0.25)
        stats, _ = _assert_same(km, k)
        total += stats
    for stat in (T.STAT_BUBBLE, T.STAT_STALL_CYCLE, T.STAT_ABORT, T.STAT_OVERFLOW):
        assert total.get(stat, 0) > 0, f"outcome {stat} never exercised"


def test_small_step_budget_overflows_unfinished_lanes():
    """Lanes still running when the step budget ends report overflow
    (host fallback), as the JAX while_loop's step cap does."""
    import torch

    g = port_build(_genome_kmers(2, G=4000, k=11, snp=0.04), 11)
    seeds = torch.from_numpy(_seeds(g).astype(np.int64))
    succ = torch.from_numpy(np.asarray(g._succ, dtype=np.int64))
    full = T._search_batched(seeds, succ)
    short = T._search_batched(seeds, succ, max_steps=2)
    finished = (short[0] != T.STAT_OVERFLOW).numpy()
    assert (~finished).any()
    # lanes that finished within 2 steps agree with the full search
    for a, b in zip(short, full):
        np.testing.assert_array_equal(a.numpy()[finished], b.numpy()[finished])

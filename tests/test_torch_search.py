"""The torch port's batched superbubble search against the JAX package.

On the random graph classes of tests/test_batched.py (genome-like graphs
with het SNPs, dense random tangles, a circular genome whose bubble exit
loops back to its entrance) the port's search outputs (status, psec,
nseen, seen, cycle mask) must equal `ploidyfrost_tpu.bubble.batched.
search_seeds` exactly, and the port's graph + search + replay must give
the JAX package's bubble list and state arrays. The search loop runs
every seed in one batch, freezing finished lanes; these graphs mix every
outcome class, so a lane corrupted after it finished would show.

On the CPU the dispatcher `search_batched` takes the plain version (the
CUDA kernel csrc/superbubble_search.cu is held against it on the card by
chip_smoke.py): here it must equal the JAX `_build_search(ms, mstk,
max_steps)` program at several caps, overflow lanes included, leave the
launch counter at 0, and refuse what the kernel does not take.
"""

import collections
import functools

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
    full = T.search_batched_plain(seeds, succ)
    short = T.search_batched_plain(seeds, succ, max_steps=2)
    finished = (short[0] != T.STAT_OVERFLOW).numpy()
    assert (~finished).any()
    # lanes that finished within 2 steps agree with the full search
    for a, b in zip(short, full):
        np.testing.assert_array_equal(a.numpy()[finished], b.numpy()[finished])


def _search_inputs(g):
    import torch

    seeds = torch.from_numpy(_seeds(g))
    succ = torch.from_numpy(np.ascontiguousarray(g._succ, dtype=np.int32))
    return seeds, succ


@functools.lru_cache(maxsize=1)
def _small_genome_graph():
    return port_build(_genome_kmers(1, G=4000, k=11, snp=0.03), 11)


# (ms, mstk, max_steps): the defaults, small seen and stack caps, lanes
# cut at one and two steps, and caps between
CAPS = [(32, 48, 192), (8, 8, 16), (32, 48, 1), (32, 48, 2), (16, 12, 64)]


@pytest.mark.parametrize("caps", CAPS, ids=lambda c: "x".join(map(str, c)))
@pytest.mark.parametrize("graph", ["genome", "tangle"])
def test_search_batched_equals_jax_at_caps(graph, caps):
    """All five outputs equal the JAX program built for the same caps,
    lanes that overflow or run out of steps included."""
    import jax.numpy as jnp

    if graph == "genome":
        km, k = _genome_kmers(3, G=4000, k=11, snp=0.03), 11
    else:
        km, k = _tangle_kmers(5, frac=0.25)
    gj = jax_build(km, k)
    gt = port_build(km, k)
    seeds, succ = _search_inputs(gt)
    got = T.search_batched(seeds, succ, *caps)
    want = J._build_search(*caps)(jnp.asarray(_seeds(gj)), jnp.asarray(gj._succ, dtype=jnp.int32))
    for name, a, b in zip(("status", "psec", "nseen", "seen", "cyc"), got, want):
        a = a.numpy()
        b = np.asarray(b)
        if name == "cyc":
            a = a.view(np.uint32)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    if caps[0] < 32 or caps[2] < 3:
        assert (got[0] == T.STAT_OVERFLOW).any()


def test_dispatcher_takes_plain_version_on_cpu():
    import torch

    g = _small_genome_graph()
    seeds, succ = _search_inputs(g)
    T.SEARCH_LAUNCHES = 0
    got = T.search_batched(seeds, succ)
    assert T.SEARCH_LAUNCHES == 0
    want = T.search_batched_plain(seeds, succ)
    dtypes = (torch.uint8, torch.int32, torch.uint8, torch.int32, torch.int32)
    for a, b, dtype in zip(got, want, dtypes):
        assert a.dtype == b.dtype == dtype
        assert a.device.type == "cpu"
        assert (a == b).all()
    assert got[3].shape == (len(seeds), T.MAX_SEEN)


def test_dispatcher_on_an_empty_seed_list():
    import torch

    g = _small_genome_graph()
    _, succ = _search_inputs(g)
    out = T.search_batched(torch.zeros(0, dtype=torch.int32), succ)
    assert [tuple(x.shape) for x in out] == [(0,), (0,), (0,), (0, T.MAX_SEEN), (0,)]


def _bad_args(case):
    """(seed, succ, kwargs) with one thing the kernel does not take."""
    import torch

    g = _small_genome_graph()
    seeds, succ = _search_inputs(g)
    n2 = 2 * succ.shape[0]
    return {
        "seed_int64": (seeds.long(), succ, {}),
        "seed_2d": (seeds[None, :], succ, {}),
        "succ_int64": (seeds, succ.long(), {}),
        "succ_shape": (seeds, succ.reshape(-1, 8), {}),
        "devices": (seeds.to("meta"), succ, {}),
        "seed_strided": (seeds[::2], succ, {}),
        "succ_strided": (seeds, succ.transpose(1, 2).contiguous().transpose(1, 2), {}),
        "ms_33": (seeds, succ, {"ms": 33}),
        "ms_0": (seeds, succ, {"ms": 0}),
        "mstk_0": (seeds, succ, {"mstk": 0}),
        "mstk_cap": (seeds, succ, {"mstk": T.MAX_STACK_CAP + 1}),
        "steps_negative": (seeds, succ, {"max_steps": -1}),
        "seed_past_table": (torch.cat([seeds, torch.tensor([n2], dtype=torch.int32)]), succ, {}),
        "seed_negative": (torch.cat([seeds, torch.tensor([-2], dtype=torch.int32)]), succ, {}),
    }[case]


BAD = {
    "seed_int64": TypeError, "seed_2d": TypeError, "succ_int64": TypeError,
    "succ_shape": TypeError, "devices": ValueError, "seed_strided": ValueError,
    "succ_strided": ValueError, "ms_33": ValueError, "ms_0": ValueError,
    "mstk_0": ValueError, "mstk_cap": ValueError, "steps_negative": ValueError,
    "seed_past_table": ValueError, "seed_negative": ValueError,
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_dispatcher_argument_checks_raise(case):
    seed, succ, kw = _bad_args(case)
    T.SEARCH_LAUNCHES = 0
    with pytest.raises(BAD[case]):
        T.search_batched(seed, succ, **kw)
    assert T.SEARCH_LAUNCHES == 0


def test_search_seeds_refuses_handles_beyond_int32():
    g = _small_genome_graph()
    with pytest.raises(ValueError, match="int32"):
        T.search_seeds(g, np.array([1, (1 << 31) + 3], dtype=np.int64), device="cpu")


def test_search_seeds_refuses_cuda_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a card: the refusal cannot be shown")
    g = _small_genome_graph()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        T.search_seeds(g, _seeds(g), device="cuda")


def test_search_seeds_in_small_chunks_equals_one_chunk(monkeypatch):
    """The plain version runs MAX_CHUNK seeds a call; cutting the seeds
    into many chunks (the last one short) changes no output."""
    g = _small_genome_graph()
    seeds = _seeds(g)
    whole = T.search_seeds(g, seeds, device="cpu")
    monkeypatch.setattr(T, "MAX_CHUNK", 37)
    assert len(seeds) > 3 * 37 and len(seeds) % 37
    chunked = T.search_seeds(g, seeds, device="cpu")
    for a, b in zip(chunked, whole):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_parity_colored():
    """The colored registration gates at replay time (the colored case of
    tests/test_batched.py) on the port: its search + colored replay give
    the JAX package's state arrays and bubble list, and its own host
    search's."""
    from ploidyfrost_tpu.graph.colors import color_graph as jax_color_graph
    from ploidyfrost_tpu_torch.bubble.superbubble import find_superbubbles
    from ploidyfrost_tpu_torch.graph.colors import color_graph

    rng = np.random.default_rng(3)
    G, k = 8000, 15
    g1 = rng.integers(0, 4, G)
    g2 = g1.copy()
    m = rng.random(G) < 0.015
    g2[m] = (g2[m] + rng.integers(1, 4, m.sum())) % 4
    seqs = [BASES[h].tobytes().decode() for h in (g1, g2)]
    per_hap = [np.unique(_canon_np(string_kmers_np(x, k), k)) for x in seqs]
    km = np.unique(np.concatenate(per_hap))
    gj, gt = jax_build(km, k), port_build(km, k)
    cj, ct = jax_color_graph(gj, per_hap), color_graph(gt, per_hap)
    np.testing.assert_array_equal(ct.bits, cj.bits)
    sj, bj = J.find_superbubbles_device(gj, colors=cj)
    st, bt = T.find_superbubbles_device(gt, colors=ct, device="cpu")
    sh, bh = find_superbubbles(gt, colors=ct)
    key = lambda b: (b.bubble_id, b.entrance, b.strand, b.exit, b.strict, b.complex)  # noqa: E731
    for s, b in ((sj, bj), (sh, bh)):
        np.testing.assert_array_equal(st.flags, s.flags)
        np.testing.assert_array_equal(st.plus, s.plus)
        np.testing.assert_array_equal(st.minus, s.minus)
        assert [key(x) for x in bt] == [key(x) for x in b]
    assert bt

"""The port's sharded stages on the CPU with gloo (parallel/sharded.py).

Groups of 1, 2, 3 and 4 ranks, one process each, run the sharded
counter, the sharded EM and the sharded superbubble search on seeded
inputs (at 3 ranks the seeds, rows and frequencies split unevenly);
rank 0 saves what they computed and the tests hold it against the
single-device functions of the port and against the JAX package's mesh
versions on the 8 virtual CPU devices of tests/conftest.py:

  * hash_shard bit-equal to the JAX package's on keys with the top bit
    set, for 1..8 owners;
  * sharded_count (several batches, a batch with fewer rows than ranks
    so that some ranks count nothing, a small buffer so that the ranks
    flush mid-stream) equal to KmerCounter and to the JAX sharded_count
    on make_mesh(4, 2);
  * the EM loop and one EM step within 1e-12 relative of the
    single-device _em_iterate and of the JAX build_sharded_em_step;
  * the search over the ranks equal to search_seeds on a 100 kb graph,
    the graph and the seeds on rank 0 alone;
  * the table reaches rank 0's host alone, shard by shard: a spy on
    torch.distributed sees no gather during the finalization, one
    send of keys and one of counts a non-empty shard, and rank 0
    receiving them rank by rank into one buffer of the largest shard's
    length; arrays() raises on every other rank.

Every rank holds torch to one thread; each group has a process-group
timeout and the parent waits a bounded time for it.
"""

import os

import numpy as np
import pytest
import torch

from test_torch_helpers import few_torch_threads  # noqa: F401  (autouse fixture)

K = 15
EM_GAUSS = (1, 2, 3, 4)
GROUP_TIMEOUT_S = 120
WAIT_S = 240


def _count_batches():
    """Several [B, 80] code batches of a 20 kb diploid genome, one with
    fewer rows than ranks, one with Ns."""
    rng = np.random.default_rng(99)
    G = 20_000
    g1 = rng.integers(0, 4, G).astype(np.uint8)
    g2 = g1.copy()
    snp = rng.random(G) < 0.004
    g2[snp] = (g2[snp] + rng.integers(1, 4, snp.sum())) % 4
    batches = []
    for hap, n in ((g1, 256), (g2, 256), (g1, 1), (g2, 301)):
        starts = rng.integers(0, G - 80, n)
        batches.append(np.stack([hap[s : s + 80] for s in starts]))
    batches[3][::5, 40] = 4  # an N in every fifth read
    return batches


def _frequencies():
    rng = np.random.default_rng(5)
    af = np.concatenate([rng.normal(0.5, 0.08, 2000), rng.normal(1 / 3, 0.05, 500),
                         rng.normal(2 / 3, 0.05, 501)])
    return np.clip(af, 0.02, 0.98)


def _em_init(g):
    return (np.array([i / (g + 1) for i in range(1, g + 1)]), np.full(g, 1.0 / g),
            np.full(g, 0.01))


class _CommSpy:
    """While installed in this rank's torch.distributed: records every
    send and recv (peer, elements, the storage's address and bytes) and
    refuses every gather and non-blocking point-to-point call."""

    REFUSED = ("all_gather", "all_gather_into_tensor", "all_gather_object", "gather",
               "isend", "irecv")

    def __init__(self):
        self.calls = []

    def _record(self, kind, real):
        def call(tensor, *args, **kw):
            peer = args[0] if args else kw.get("dst", kw.get("src"))
            st = tensor.untyped_storage()
            self.calls.append((kind, peer, tensor.numel(), st.data_ptr(), st.nbytes()))
            return real(tensor, *args, **kw)
        return call

    def __enter__(self):
        import torch.distributed as dist

        self._saved = {n: getattr(dist, n) for n in ("send", "recv", *self.REFUSED)}
        dist.send = self._record(0, self._saved["send"])
        dist.recv = self._record(1, self._saved["recv"])
        for name in self.REFUSED:
            def refuse(*args, _name=name, **kw):
                raise AssertionError(f"{_name} called while the table is finalized")
            setattr(dist, name, refuse)
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist

        for name, fn in self._saved.items():
            setattr(dist, name, fn)


def _rank_job(group, work):
    """Runs on every rank of a group. Rank 0 saves the results; every
    rank saves what its finalization sent or received and whether
    arrays() refused it."""
    from ploidyfrost_tpu_torch.bubble.batched import (
        canonical_seeds, find_superbubbles_device, search_seeds)
    from ploidyfrost_tpu_torch.graph.cdbg import CDBGraph
    from ploidyfrost_tpu_torch.model.gmm import GmmModel
    from ploidyfrost_tpu_torch.parallel.sharded import (
        ShardedKmerCounter, build_sharded_em_step, build_sharded_ll_step, rank_rows,
        sharded_count)

    out = {}
    km, ct, hist, n = sharded_count(group, K, _count_batches(), buffer_capacity=20_000)
    out.update(hist=hist, n=n)
    if group.rank == 0:
        out.update(km=km, ct=ct)

    counter = ShardedKmerCounter(group, K, buffer_capacity=20_000)
    for b in _count_batches():
        counter.add_reads(b)
    counter.flush()
    with _CommSpy() as spy:
        counter.finalize()
    mine = {"calls": np.array(spy.calls, dtype=np.int64).reshape(-1, 5),
            "shard": counter._tkm.numel(), "distinct": counter.num_unique, "refused": False}
    if group.rank != 0:
        try:
            counter.arrays()
        except RuntimeError as e:
            mine["refused"] = "rank 0's host alone" in str(e)
    np.savez(os.path.join(work, f"world{group.world}_rank{group.rank}.npz"), **mine)

    af = _frequencies()
    model = GmmModel("cpu", group)
    model.read_data(af)
    for g in EM_GAUSS:
        model.resize(g)
        model.em_iterate()
        out[f"em{g}"] = np.concatenate([model.vars, model.weights, [model.log_likelihood]])
    lo, hi = rank_rows(len(af), group)
    mine = torch.from_numpy(af[lo:hi])
    means, w, v = (torch.from_numpy(x) for x in _em_init(3))
    v1, w1, ll1 = build_sharded_em_step(group)(mine, means, w, v, 5.0, 2.0)
    out["step"] = np.concatenate([v1.numpy(), w1.numpy(), [float(ll1)]])
    out["ll0"] = float(build_sharded_ll_step(group)(mine, means, w, v))

    if group.rank != 0:  # the graph and the seeds are rank 0's
        for _ in range(2):
            assert search_seeds(None, None, "cpu", group) is None
        return 0
    g = CDBGraph.from_gfa(os.path.join(work, "graph.gfa"))
    res = search_seeds(g, canonical_seeds(g), "cpu", group)
    out.update({f"search{i}": a for i, a in enumerate(res)})
    state, bubbles = find_superbubbles_device(g, 8, device="cpu", group=group)
    out.update(flags=state.flags, plus=state.plus, minus=state.minus, bubbles=len(bubbles))
    np.savez(os.path.join(work, f"world{group.world}.npz"), **out)
    return 0


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """A 100 kb graph (the single_diploid reads through the port on the
    CPU) as GFA, for the search."""
    from test_golden import make_reads

    from ploidyfrost_tpu_torch.graph.construct import build_graph_from_kmers, simplify
    from ploidyfrost_tpu_torch.io.fastx import read_batches
    from ploidyfrost_tpu_torch.kmer.count import KmerCounter

    d = str(tmp_path_factory.mktemp("torch_parallel"))
    make_reads(os.path.join(d, "reads.fa"))
    counter = KmerCounter(25, device="cpu")
    for b in read_batches([os.path.join(d, "reads.fa")], 25):
        counter.add_reads(b)
    km, ct = counter.arrays()
    simplify(build_graph_from_kmers(km[ct >= 10], 25), 25).write_gfa(os.path.join(d, "graph.gfa"))
    return d


@pytest.fixture(scope="module", params=[1, 2, 3, 4], ids=lambda w: f"world{w}")
def ranks(request, work):
    """What a gloo group of `world` CPU ranks computed in _rank_job:
    rank 0's results, and under "ranks" every rank's finalization."""
    from ploidyfrost_tpu_torch.parallel.mesh import RankPlan, run_ranks

    world = request.param
    plan = RankPlan(local=world, world=world, offset=0, device_type="cpu", init_method=None,
                    timeout_s=GROUP_TIMEOUT_S, threads=1)
    assert run_ranks(plan, _rank_job, (work,), timeout=WAIT_S) == 0
    out = dict(np.load(os.path.join(work, f"world{world}.npz")))
    out["ranks"] = [dict(np.load(os.path.join(work, f"world{world}_rank{r}.npz")))
                    for r in range(world)]
    return out


@pytest.fixture(scope="module")
def single_count():
    from ploidyfrost_tpu_torch.kmer.count import KmerCounter

    counter = KmerCounter(K, device="cpu")
    for b in _count_batches():
        counter.add_reads(b)
    km, ct = counter.arrays()
    return km, ct, counter.histogram(255), counter.total_kmers


@pytest.mark.parametrize("n_shard", range(1, 9))
def test_hash_shard_matches_jax(n_shard):
    import jax.numpy as jnp

    from ploidyfrost_tpu.parallel.sharded import hash_shard as jax_hash_shard
    from ploidyfrost_tpu_torch.parallel.sharded import hash_shard

    rng = np.random.default_rng(n_shard)
    keys = rng.integers(0, 1 << 63, 10_000, dtype=np.uint64)
    keys[::2] |= np.uint64(1 << 63)  # the top bit set: negative as int64
    keys[:4] = [0, 1, (1 << 64) - 1, 1 << 63]
    want = np.asarray(jax_hash_shard(jnp.asarray(keys), n_shard))
    got = hash_shard(torch.from_numpy(keys.view(np.int64)), n_shard).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.min() >= 0 and got.max() < n_shard


def test_sharded_count_equals_kmer_counter(ranks, single_count):
    km, ct, hist, n = single_count
    np.testing.assert_array_equal(ranks["km"], km)
    np.testing.assert_array_equal(ranks["ct"], ct)
    np.testing.assert_array_equal(ranks["hist"], hist)
    assert int(ranks["n"]) == n
    assert ranks["km"].dtype == np.uint64 and len(km) > 10_000


def test_sharded_count_equals_jax(ranks):
    from ploidyfrost_tpu.parallel.sharded import make_mesh, sharded_count

    km, ct, hist, n = sharded_count(make_mesh(4, 2), K, _count_batches())
    np.testing.assert_array_equal(ranks["km"], np.asarray(km, dtype=np.uint64))
    np.testing.assert_array_equal(ranks["ct"], np.asarray(ct))
    np.testing.assert_array_equal(ranks["hist"], np.asarray(hist))
    assert int(ranks["n"]) == int(n)


def test_sharded_em_iterate_matches_single(ranks):
    from ploidyfrost_tpu_torch.model.gmm import GmmModel

    model = GmmModel("cpu")
    model.read_data(_frequencies())
    for g in EM_GAUSS:
        model.resize(g)
        model.em_iterate()
        want = np.concatenate([model.vars, model.weights, [model.log_likelihood]])
        np.testing.assert_allclose(ranks[f"em{g}"], want, rtol=1e-12, atol=0)


def test_sharded_em_step_matches_jax(ranks):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec

    from ploidyfrost_tpu.parallel.sharded import (
        build_sharded_em_step, build_sharded_ll_step, make_mesh)

    mesh = make_mesh(4, 2)
    af = _frequencies()
    cap = len(af) + (-len(af)) % 8
    pad = np.zeros(cap)
    pad[: len(af)] = af
    mask = np.zeros(cap)
    mask[: len(af)] = 1.0
    s = NamedSharding(mesh, PartitionSpec(("data", "shard")))
    a, m = jax.device_put(pad, s), jax.device_put(mask, s)
    means, w, v = (jnp.asarray(x) for x in _em_init(3))
    v1, w1, ll1 = build_sharded_em_step(mesh)(a, m, means, w, v, 5.0, 2.0)
    want = np.concatenate([np.asarray(v1), np.asarray(w1), [float(ll1)]])
    np.testing.assert_allclose(ranks["step"], want, rtol=1e-12, atol=0)
    ll0 = float(build_sharded_ll_step(mesh)(a, m, means, w, v))
    np.testing.assert_allclose(float(ranks["ll0"]), ll0, rtol=1e-12, atol=0)


def test_sharded_search_matches_search_seeds(ranks, work):
    from ploidyfrost_tpu_torch.bubble.batched import (
        canonical_seeds, find_superbubbles_device, search_seeds)
    from ploidyfrost_tpu_torch.graph.cdbg import CDBGraph

    g = CDBGraph.from_gfa(os.path.join(work, "graph.gfa"))
    seeds = canonical_seeds(g)
    assert len(seeds) > 100
    for i, want in enumerate(search_seeds(g, seeds, "cpu")):
        got = ranks[f"search{i}"]
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    state, bubbles = find_superbubbles_device(g, 8, device="cpu")
    np.testing.assert_array_equal(ranks["flags"], state.flags)
    np.testing.assert_array_equal(ranks["plus"], state.plus)
    np.testing.assert_array_equal(ranks["minus"], state.minus)
    assert int(ranks["bubbles"]) == len(bubbles) > 0


def test_table_reaches_rank0_one_shard_at_a_time(ranks, single_count):
    """No gather during the finalization (the spy refuses them); every
    non-empty shard is sent to rank 0 as its keys and then its counts;
    rank 0 receives them rank by rank, each into one buffer no longer
    than the largest shard, so no device holds more than its shard and
    that buffer; num_unique is the sum of the shards on every rank."""
    rows = ranks["ranks"]
    world = len(rows)
    lens = [int(r["shard"]) for r in rows]
    distinct = len(single_count[0])
    assert sum(lens) == distinct
    assert all(int(r["distinct"]) == distinct for r in rows)
    SEND, RECV = 0, 1
    for r in range(1, world):
        calls = rows[r]["calls"]
        assert calls[:, 0].tolist() == [SEND, SEND] and calls[:, 1].tolist() == [0, 0]
        assert calls[:, 2].tolist() == [lens[r]] * 2
        assert bool(rows[r]["refused"])
    recv = rows[0]["calls"]
    want = [(src, lens[src]) for src in range(1, world) for _ in range(2)]
    assert [(int(c[1]), int(c[2])) for c in recv] == want
    assert (recv[:, 0] == RECV).all()
    if world > 1:
        assert len(set(recv[:, 3].tolist())) == 1  # one buffer for every shard
        assert int(recv[0, 4]) == 8 * max(lens[1:]) < 8 * distinct

# Ported from ploidyfrost_tpu/parallel/sharded.py onto torch.distributed.
"""The count table, the superbubble search and the EM split over a
process group (one rank per device, parallel/mesh.py).

The reference's only parallelism is pthreads and mutexes in one address
space (src/CDBG.cpp:1726-1777). Here, as in the JAX package, the work is
bulk-synchronous with no locks, and the JAX package's single-process
mesh is the model of who holds what: the table stays split over the
devices, and one host (rank 0's) receives it shard by shard, builds,
replays and writes.

  * Counting (`ShardedKmerCounter`). Every rank reads the same batches
    and runs K1 (kmer/extract.py) on its contiguous row slice of each
    one, into a buffer of its own. At each flush it drops the invalid
    windows, routes every key to its owner rank `hash_shard(key, world)`
    with one `all_to_all_single` of the per-destination counts and one of
    the keys (uneven splits), and merges what it receives into its own
    table with the single-device sort-collapse (kmer/count.py:_collapse).
    Each key lives on exactly one rank, so the histogram, the instance
    count and every shard's length are one int64 `all_reduce`. Then each
    rank sends its shard (keys, then counts) to rank 0 with point-to-point
    `send`, in rank order; rank 0 receives each into one buffer sized for
    the largest shard, copies it to its host before the next arrives and
    merges the sorted runs there: the JAX `arrays()` contract
    (ploidyfrost_tpu/parallel/sharded.py:381-413), one shard in flight,
    and no device ever holds the global table. `arrays()` raises on the
    other ranks.
  * EM (`build_sharded_em_step`, `build_sharded_ll_step`, and
    model/gmm._em_iterate_group). Each rank runs one pass over its slice
    of the allele frequencies in float64 (on a card the pass entry of
    the EM kernel), one `all_reduce` of the pass's 2g + 1 sums, then the
    update and its rejection guard on every rank.
  * Superbubble search (`build_sharded_search_step`). Rank 0 broadcasts
    the seeds and the successor table; the seeds split into equal
    slices; each rank searches its own and sends the five outputs to
    rank 0, whose host alone replays.

What the JAX version has and this one drops: the 2-D (data, shard) mesh
(`make_mesh`, `balanced_mesh`), the two all_to_all hops over its axes,
the fixed per-destination quotas and the overflow grow-and-replay. They
exist for the TPU's 2-D interconnect and its static shapes. The port's
tables have dynamic size (kmer/count.py), so one hop over the flat group
with exact split sizes gives the same table with nothing to replay.

Keys are int64 with the INT64_MAX sentinel. `hash_shard` reproduces the
JAX package's uint64 splitmix64 bit for bit: the multiplies wrap alike in
int64, every right shift is masked (torch's are arithmetic), and the
modulo is taken on the unsigned value.
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.distributed as dist

from ..kmer.count import DEFAULT_COUNTER_MAX, _collapse
from ..kmer.extract import extract_canonical_into
from ..kmer.pack import SENTINEL
from ..util.profiling import add_count, span
from .mesh import Group

_MIX1 = 0xBF58476D1CE4E5B9 - (1 << 64)  # the splitmix64 constants as int64
_MIX2 = 0x94D049BB133111EB - (1 << 64)


def _srl(x: torch.Tensor, s: int) -> torch.Tensor:
    """x >> s on the uint64 bits of int64 x (a logical shift)."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def _mix64(x: torch.Tensor) -> torch.Tensor:
    """splitmix64 finalizer: decorrelates the owner rank from the
    k-mer's lexicographic prefix so the ranks stay balanced."""
    x = (x ^ _srl(x, 30)) * _MIX1
    x = (x ^ _srl(x, 27)) * _MIX2
    return x ^ _srl(x, 31)


def hash_shard(kmers: torch.Tensor, n_shard: int) -> torch.Tensor:
    """Owner in [0, n_shard) of each int64 key: the uint64 mix modulo
    n_shard, as hi * 2^32 + lo (n_shard < 2^31 keeps it inside int64)."""
    h = _mix64(kmers)
    hi, lo = _srl(h, 32), h & 0xFFFFFFFF
    return ((hi % n_shard) * ((1 << 32) % n_shard) + lo % n_shard) % n_shard


def rank_rows(n: int, group: Group) -> tuple[int, int]:
    """[lo, hi) of this rank's contiguous slice when n items split into
    ceil(n / world) a rank (the last ranks may get fewer, or none)."""
    per = -(-n // group.world)
    lo = min(group.rank * per, n)
    return lo, min(lo + per, n)


def all_sum(group: Group, x: torch.Tensor) -> torch.Tensor:
    """x summed over the ranks, in place; returns x."""
    dist.all_reduce(x)
    return x


class ShardedKmerCounter:
    """KmerCounter-compatible streaming counter over a process group.

    Same surface as kmer.count.KmerCounter (add_reads / arrays /
    histogram / write_histogram / total_kmers / num_unique), so the
    pipeline entry points take either (mesh.make_counter); `arrays()`
    answers on rank 0 alone. Every rank must make the same calls with
    the same batches, and enter the finalization (`finalize`, or any
    view) at the same point: the flushes and the finalization are
    collectives. The table depends only on the k-mer multiset, not on
    the group's size.
    """

    def __init__(
        self,
        group: Group,
        k: int,
        counter_max: int = DEFAULT_COUNTER_MAX,
        buffer_capacity: int | None = None,
    ):
        if not 1 <= k <= 31:
            raise ValueError("k must be in [1, 31] for single-word packing")
        self.group = group
        self.device = group.device
        if buffer_capacity is None:
            buffer_capacity = (32 << 20) if self.device.type == "cuda" else (8 << 20)
        self.k = k
        self.counter_max = counter_max
        self._tkm = torch.empty(0, dtype=torch.int64, device=self.device)
        self._tct = torch.empty(0, dtype=torch.int64, device=self.device)
        self._buf = torch.empty(buffer_capacity, dtype=torch.int64, device=self.device)
        self._fill = 0  # keys in this rank's buffer
        # buffer slots the batches since the last flush may take on ANY
        # rank (full slices): the flush decision, identical on every rank
        self._slots = 0
        self._n_valid_dev = torch.zeros((), dtype=torch.int64, device=self.device)
        self._total_local = 0
        self._finalized = None  # finalize's result until the next add_reads
        # (key bytes this rank sent, host seconds of route + merge) a flush
        self.flush_log: list[tuple[int, float]] = []
        # host seconds of the last finalize after its flush: the reduction
        # and the shards' way to rank 0's host, merge included
        self.finalize_s = 0.0

    # -- ingestion -------------------------------------------------------

    def add_reads(self, codes):
        """Count the canonical k-mers of this rank's row slice of a
        [B, L] uint8 code batch (numpy array or tensor) that every rank
        passes whole."""
        codes = torch.as_tensor(codes)
        B, L = codes.shape
        n_row = L - self.k + 1
        if n_row <= 0:
            return
        self._finalized = None
        per = -(-B // self.group.world)
        cap = self._buf.numel()
        if per * n_row > cap:
            # a slice larger than the whole buffer: feed the batch in blocks
            step = max(cap // n_row, 1) * self.group.world
            for r in range(0, B, step):
                self.add_reads(codes[r : r + step])
            return
        if self._slots + per * n_row > cap:
            self.flush()
        lo, hi = rank_rows(B, self.group)
        if hi > lo:
            add_count("h2d_bytes", codes[lo:hi].nbytes)
            dev = codes[lo:hi].to(self.device).contiguous()
            extract_canonical_into(dev, self.k, self._buf, self._fill, count=self._n_valid_dev)
            self._fill += (hi - lo) * n_row
        self._slots += per * n_row

    # -- route and merge -------------------------------------------------

    def flush(self):
        """Route the buffered keys to their owners and merge what this
        rank receives into its table (a collective)."""
        if self._slots == 0:
            return
        t0 = time.perf_counter()
        keys = self._buf[: self._fill]
        keys = keys[keys != SENTINEL]
        owner = hash_shard(keys, self.group.world)
        order = torch.argsort(owner)
        send = keys[order]
        send_counts = torch.bincount(owner, minlength=self.group.world)
        recv_counts = torch.empty_like(send_counts)
        dist.all_to_all_single(recv_counts, send_counts)
        recv = torch.empty(int(recv_counts.sum()), dtype=torch.int64, device=self.device)
        dist.all_to_all_single(
            recv, send,
            output_split_sizes=recv_counts.tolist(),
            input_split_sizes=send_counts.tolist(),
        )
        self._tkm, self._tct = _collapse(self._tkm, self._tct, recv, self.counter_max)
        self._fill = self._slots = 0
        self._total_local += int(self._n_valid_dev)  # waits for the merge
        self._n_valid_dev.zero_()
        self.flush_log.append((8 * send.numel(), time.perf_counter() - t0))

    # -- finalization / views ---------------------------------------------

    def finalize(self):
        """Flush, reduce the histogram, the instance count and the shard
        lengths, and bring the shards to rank 0's host (`_shards_to_rank0`),
        once until the next add_reads: every rank must enter the
        collectives equally often, so the pipeline's ranks all call this
        where counting ends, and rank 0 alone may then ask for the table.
        Returns (kmers, counts, hist, total, distinct), the table None on
        every rank but 0."""
        if self._finalized is not None:
            return self._finalized
        self.flush()
        with span("finalize"):
            t0 = time.perf_counter()
            cm, world, rank = self.counter_max, self.group.world, self.group.rank
            hist = torch.bincount(self._tct.clamp(0, cm), minlength=cm + 1)[: cm + 1]
            # the instance count, then one slot a rank for its shard's length
            head = torch.zeros(world + 1, dtype=torch.int64, device=self.device)
            head[0] = self._total_local
            head[1 + rank] = self._tkm.numel()
            red = all_sum(self.group, torch.cat([hist, head])).cpu().numpy()
            hist_np, total, lens = red[: cm + 1], int(red[cm + 1]), red[cm + 2 :]
            hist_np[0] = 0
            table = self._shards_to_rank0(lens)
            self._finalized = (*table, hist_np, total, int(lens.sum()))
            self.finalize_s = time.perf_counter() - t0
        return self._finalized

    def _shards_to_rank0(self, lens: np.ndarray):
        """Every rank's shard to rank 0's host, rank by rank (`lens`: the
        shards' lengths, known on every rank, so an empty shard is never
        sent). Rank 0 receives keys and then counts into one device
        buffer of the largest shard's length and copies each to its host
        before the next arrives; returns the merged (kmers uint64, counts)
        there, (None, None) on the other ranks."""
        if self.group.rank != 0:
            if self._tkm.numel():
                dist.send(self._tkm, 0)
                dist.send(self._tct, 0)
            return None, None
        kms, cts = [self._tkm.cpu().numpy()], [self._tct.cpu().numpy()]
        buf = torch.empty(int(lens[1:].max(initial=0)), dtype=torch.int64, device=self.device)
        for r, n in enumerate(lens.tolist()):
            if r == 0 or n == 0:
                continue
            for host in (kms, cts):
                dist.recv(buf[:n], src=r)
                host.append(buf[:n].to("cpu", copy=True).numpy())
        del buf
        km, ct = np.concatenate(kms), np.concatenate(cts)
        add_count("d2h_bytes", km.nbytes + ct.nbytes)
        # each shard is sorted and the shards are disjoint (keys are owned
        # by hash), so a stable argsort merges the runs (numpy's timsort).
        # Keys are < 2^62 for k <= 31: their int64 and uint64 orders agree.
        order = np.argsort(km, kind="stable")
        return km[order].view(np.uint64), ct[order]

    @property
    def total_kmers(self) -> int:
        """Total (valid) k-mer instances over all ranks."""
        return self.finalize()[3]

    @property
    def num_unique(self) -> int:
        """Distinct k-mers over all ranks: the sum of the shards' lengths,
        on every rank."""
        return self.finalize()[4]

    def arrays(self):
        """(sorted unique canonical k-mers uint64, saturated counts
        int64) of the whole table as host numpy arrays: on rank 0 alone,
        the one host that receives the shards."""
        if self.group.rank != 0:
            raise RuntimeError(
                f"ShardedKmerCounter.arrays() on rank {self.group.rank}: the table is "
                "gathered on rank 0's host alone; this rank holds only its shard")
        km, ct, _, _, _ = self.finalize()
        return km, ct

    def histogram(self, max_cov: int | None = None) -> np.ndarray:
        """hist[c] = number of distinct k-mers with count c clamped to
        max_cov, c in 1..max_cov (KmerCounter.histogram's meaning)."""
        if max_cov is None:
            max_cov = self.counter_max
        full = self.finalize()[2]
        if max_cov >= len(full) - 1:
            return np.concatenate([full, np.zeros(max_cov + 1 - len(full), np.int64)])
        hist = full[: max_cov + 1].copy()
        hist[max_cov] = full[max_cov:].sum()
        return hist

    def write_histogram(self, path: str, max_cov: int = 10000):
        """Text histogram file: "<cov>\\t<count>" per line, cov = 1..max_cov."""
        hist = self.histogram(max_cov)
        with open(path, "w") as f:
            for cov in range(1, max_cov + 1):
                f.write(f"{cov}\t{int(hist[cov]) if cov < len(hist) else 0}\n")


def sharded_count(group: Group, k: int, code_batches, **kw):
    """Count canonical k-mers of `code_batches` over the group (see
    ShardedKmerCounter). Returns (kmers sorted uint64, counts int64,
    hist int64[256] with counts above 255 in the last bin, n_instances),
    the JAX package's sharded_count result; the kmers and counts are
    None on every rank but 0."""
    counter = ShardedKmerCounter(group, k, **kw)
    for b in code_batches:
        counter.add_reads(b)
    counter.finalize()
    km, ct = counter.arrays() if group.rank == 0 else (None, None)
    return km, ct, counter.histogram(255), counter.total_kmers


def build_sharded_em_step(group: Group):
    """EM step over rank-sliced allele frequencies: (af slice, means,
    weights, variances, m_thre, n_thre) -> (variances, weights, ll).
    Each rank runs one pass on its slice (model/gmm.em_pass: on a card
    the pass entry of csrc/gmm_em.cu), one all_reduce of the 2g + 1
    sums, and the update and its rejection guard on every rank
    (src/GmmModel.cpp:275-334); then a second pass and all_reduce for the
    new log-likelihood."""
    from ..model.gmm import em_pass, em_update

    def step(af, means, weights, variances, m_thre, n_thre):
        v, w = em_update(all_sum(group, em_pass(af, means, weights, variances)), weights,
                         variances, m_thre, n_thre)
        return v, w, all_sum(group, em_pass(af, means, w, v))[0]

    return step


def build_sharded_ll_step(group: Group):
    """Log-likelihood of rank-sliced allele frequencies: (af slice,
    means, weights, variances) -> ll, summed over the ranks (one pass a
    rank, one all_reduce)."""
    from ..model.gmm import em_pass

    def step(af, means, weights, variances):
        return all_sum(group, em_pass(af, means, weights, variances))[0]

    return step


def build_sharded_search_step(group: Group):
    """Superbubble search over the group. Rank 0 calls step(seeds [S]
    int32, succ_node [n, 2, 4] int32, both on its device) and gets the
    five outputs of bubble/batched.search_batched for all S seeds; every
    other rank calls step() and gets None.

    Rank 0 broadcasts S and n, then the seeds and the successor table.
    Seeds are independent (the search reads only the adjacency,
    src/CDBG.cpp:2643-2823), so they split into ceil(S / world) a rank,
    the last slice padded with the last seed; every rank searches its
    slice with search_batched (one kernel launch on a card) and sends the
    five outputs to rank 0, which receives them rank by rank into their
    rows. Rank 0's host alone replays."""
    from ..bubble.batched import search_batched

    def step(seeds=None, succ_node=None):
        primary = group.rank == 0
        dims = [seeds.numel(), succ_node.shape[0]] if primary else [0, 0]
        dims = torch.tensor(dims, dtype=torch.int64, device=group.device)
        dist.broadcast(dims, 0)
        S, n = dims.tolist()
        if S == 0:
            return search_batched(seeds, succ_node) if primary else None
        if not primary:
            seeds = torch.empty(S, dtype=torch.int32, device=group.device)
            succ_node = torch.empty((n, 2, 4), dtype=torch.int32, device=group.device)
        dist.broadcast(seeds, 0)
        dist.broadcast(succ_node, 0)
        per = -(-S // group.world)
        pad = seeds[-1:].expand(per * group.world - S)
        mine = torch.cat([seeds, pad])[group.rank * per : (group.rank + 1) * per]
        outs = search_batched(mine, succ_node)
        if not primary:
            for x in outs:
                dist.send(x.contiguous(), 0)
            return None
        full = [x.new_empty((per * group.world, *x.shape[1:])) for x in outs]
        for f, x in zip(full, outs):
            f[:per] = x
        for r in range(1, group.world):
            for f in full:
                dist.recv(f[r * per : (r + 1) * per], src=r)
        return [f[:S] for f in full]

    return step

"""The tile layout of the superbubble search kernel, emulated on the CPU.

The kernel (ploidyfrost_tpu_torch/csrc/superbubble_search.cu) cannot run
here: chip_smoke.py holds it bit-exact against its plain version on the
card. This file keeps a Python emulation of its design, step for step:
a tile of T lanes a seed, seen slot j in lane j % T at register j // T,
st, strand_map and cycle_set as tile-uniform slot masks, every probe one
tile ballot a register assembled into a slot mask, the (handle, row)
stack with its clamped indices, one read round a DFS step (the twin row
of each live successor; a pushed successor's own row shares that
sector) plus the seed's row before the loop, and the popped node's mask
reused for the predecessor that is the popped node. For every T the
kernel is built for, on the genome and tangle graphs of
tests/test_torch_search.py at its CAPS and at cap sets with
MAX_STACK_CAP and with ms = 1, all five outputs must equal
search_batched_plain and the JAX program exactly (integers, no
tolerance), and no seed may take more than steps + 1 read rounds.
"""

import functools

import numpy as np
import pytest
import torch

from ploidyfrost_tpu.bubble import batched as J
from ploidyfrost_tpu.graph.construct import build_graph_from_kmers as jax_build
from ploidyfrost_tpu_torch.bubble import batched as T
from ploidyfrost_tpu_torch.graph.construct import build_graph_from_kmers as port_build
from test_torch_helpers import few_torch_threads  # noqa: F401  (autouse fixture)
from test_torch_search import CAPS, _genome_kmers, _seeds, _tangle_kmers

TILE_CAPS = CAPS + [(32, T.MAX_STACK_CAP, 192), (1, 8, 16)]


def tile_search(seed, rows, tile, ms, mstk, max_steps):
    """One seed through the kernel's tile of `tile` lanes. rows: the
    successor table as 2n rows of 4 packed handles (row h holds handle h's
    successors; rows 2i and 2i + 1 share one 32-byte sector). Returns
    (status, psec, nseen, seen [ms], cyc mask, read rounds, DFS steps)."""
    R = 32 // tile
    lanes = range(tile)
    seen = [[-1] * R for _ in lanes]  # seen[lane][register]: slot register * tile + lane
    seen[0][0] = seed

    def slot_mask(hit):
        """The slots whose handle satisfies `hit`: for each register, the
        tile's ballot (bit t: lane t) placed at slots register * tile + t."""
        m = 0
        for r in range(R):
            m |= sum(1 << t for t in lanes if hit(seen[t][r])) << (r * tile)
        return m

    def slots_of(idx):
        return slot_mask(lambda x: x >> 1 == idx)

    # tile-uniform slot masks: st == 1 (visited), st == 2 (seen),
    # strand_map, cycle_set
    vis = sn = smk = cyc = 0
    stk, srow = [0] * mstk, [None] * mstk
    stk[0], srow[0] = seed, rows[seed]
    reads = 1
    sp, nseen, steps, status, psec = 1, 1, 0, T.STAT_NONE, -1
    fcyc = ftip = ovf = done = False
    while sp > 0 and not done and not ovf and steps < max_steps:
        sp -= 1
        v, su = stk[sp], srow[sp]  # the popped handle and its row, from the stack
        hv = slots_of(v >> 1)
        vis |= hv
        sn &= ~hv
        smk = smk | hv if v & 1 else smk & ~hv
        ftip |= all(x < 0 for x in su)
        # the step's one read round: the twin row of each successor that is
        # neither absent nor the seed
        twin = [rows[u ^ 1] if u >= 0 and u != seed else None for u in su]
        reads += any(x is not None for x in twin)
        for b in range(4):
            u = su[b]
            if u < 0:
                continue
            if u == seed:
                fcyc = True
                cyc |= hv | 1
                continue
            ustr = u & 1
            hu = slots_of(u >> 1)
            if hu & vis:
                fcyc = True
                cyc |= hu | hv
                continue
            app = hu == 0
            if app and nseen >= ms:
                ovf = True
            ws = min(nseen, ms - 1)
            wm = 1 << ws if app else 0
            if not app and bool(smk & hu) != ustr:
                fcyc = True
                cyc |= hu | hv
            if app:
                seen[ws % tile][ws // tile] = u
            smk = smk | wm if ustr else smk & ~wm
            hu2 = hu | wm
            nseen += app
            sn |= hu2
            vis &= ~hu2
            hv &= ~wm
            allv, anypm = True, False
            for pw in twin[b]:
                if pw < 0:
                    continue
                pred = pw ^ 1
                hp = hv if pred >> 1 == v >> 1 else slots_of(pred >> 1)
                pin = bool(hp & (vis | sn))
                allv = allv and pin and bool(hp & vis)
                if pin and bool(smk & hp) != pred & 1:
                    anypm = True
                    cyc |= hp
            if anypm:
                fcyc = True
                cyc |= hu2
            if allv:
                if sp >= mstk:
                    ovf = True
                pos = min(sp, mstk - 1)
                # u's own row shares its sector with the twin row read above
                stk[pos], srow[pos] = u, rows[u]
                sp += 1
        if sp == 1 and not ovf:
            top = stk[0]
            at_top = slot_mask(lambda x: x == top)
            live = (1 << nseen) - 1 if nseen < 32 else 0xFFFFFFFF
            if sn & ~at_top & live == 0:
                status = (T.STAT_CYCLE_EXIT if seed in srow[0] else
                          T.STAT_ABORT if fcyc or ftip else T.STAT_BUBBLE)
                psec, done = top, True
        steps += 1
    ovf = ovf or (not done and sp > 0)
    status = (T.STAT_OVERFLOW if ovf else status if done else
              T.STAT_STALL_CYCLE if fcyc else T.STAT_NONE)
    return (status, psec, nseen, [seen[j % tile][j // tile] for j in range(ms)], cyc,
            reads, steps)


def tile_search_batched(seeds, succ, tile, ms, mstk, max_steps):
    """Every seed through `tile_search`: the kernel's five outputs as
    numpy arrays (status u8, psec i32, nseen u8, seen i32 [S, ms], cyc
    i32), and each seed's read rounds and steps."""
    rows = [tuple(r) for r in np.asarray(succ, dtype=np.int64).reshape(-1, 4).tolist()]
    res = [tile_search(int(s), rows, tile, ms, mstk, max_steps) for s in seeds]
    status, psec, nseen, seen, cyc, reads, steps = zip(*res)
    outs = (np.array(status, np.uint8), np.array(psec, np.int32), np.array(nseen, np.uint8),
            np.array(seen, np.int32).reshape(len(seeds), ms),
            np.array(cyc, np.uint32).view(np.int32))
    return outs, np.array(reads), np.array(steps)


@functools.lru_cache(maxsize=2)
def _graphs(graph):
    if graph == "genome":
        km, k = _genome_kmers(3, G=4000, k=11, snp=0.03), 11
    else:
        km, k = _tangle_kmers(5, frac=0.25)
    return jax_build(km, k), port_build(km, k)


@functools.lru_cache(maxsize=None)
def _references(graph, caps):
    """(plain version's outputs, JAX program's outputs) as numpy, the
    cycle mask as int32 bits in both."""
    import jax.numpy as jnp

    gj, gt = _graphs(graph)
    seeds = torch.from_numpy(_seeds(gt))
    succ = torch.from_numpy(np.ascontiguousarray(gt._succ, dtype=np.int32))
    plain = tuple(x.numpy() for x in T.search_batched_plain(seeds, succ, *caps))
    want = J._build_search(*caps)(jnp.asarray(_seeds(gj)), jnp.asarray(gj._succ, dtype=jnp.int32))
    want = tuple(np.asarray(x) for x in want)
    return plain, want[:4] + (want[4].view(np.int32),)


@pytest.mark.parametrize("caps", TILE_CAPS, ids=lambda c: "x".join(map(str, c)))
@pytest.mark.parametrize("graph", ["genome", "tangle"])
@pytest.mark.parametrize("tile", T.TILES)
def test_tile_layout_equals_plain_and_jax(tile, graph, caps):
    """The emulated kernel's five outputs equal the plain version's and
    the JAX program's exactly, lanes that overflow or run out of steps
    included, and each seed makes at most steps + 1 read rounds."""
    _, gt = _graphs(graph)
    got, reads, steps = tile_search_batched(_seeds(gt), gt._succ, tile, *caps)
    plain, want = _references(graph, caps)
    for name, a, b, c in zip(("status", "psec", "nseen", "seen", "cyc"), got, plain, want):
        assert a.dtype == b.dtype == c.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=f"{name} against the plain version")
        np.testing.assert_array_equal(a, c, err_msg=f"{name} against the JAX program")
    assert (reads <= steps + 1).all()
    assert reads.sum() > len(reads)
    if caps[0] < 32 or caps[2] < 3:
        assert (got[0] == T.STAT_OVERFLOW).any()


@pytest.mark.parametrize("graph", ["genome", "tangle"])
def test_search_seeds_trims_seen_to_the_largest_nseen(graph):
    """search_seeds cuts `seen` to max(1, largest nseen) columns (at most
    MAX_SEEN: nseen counts past it on overflow), as it did with its own
    reduction, and as the JAX package's search_seeds does."""
    gj, gt = _graphs(graph)
    seeds = _seeds(gt)
    got = T.search_seeds(gt, seeds, device="cpu")
    width = min(T.MAX_SEEN, max(1, int(got[2].max())))
    assert got[3].shape == (len(seeds), width)
    full, nseen_max = T._search(torch.from_numpy(seeds),
                                torch.from_numpy(np.ascontiguousarray(gt._succ, dtype=np.int32)))
    assert nseen_max == int(got[2].max())
    np.testing.assert_array_equal(got[3], full[3].numpy()[:, :width])
    want = J.search_seeds(gj, seeds)
    assert want[3].shape == got[3].shape
    np.testing.assert_array_equal(got[3], want[3])


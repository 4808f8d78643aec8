# Ported from ploidyfrost_tpu/bubble/batched.py: search_seeds and
# _search_batched (as a CUDA kernel, csrc/superbubble_search.cu, with a
# batched torch loop as its plain version); _replay_fast and
# find_superbubbles_device copied.
"""Device-batched superbubble search (engine for src/CDBG.cpp:1707-2823).

The reference parallelizes superbubble extraction with N pthreads pulling
unitigs off a shared iterator (findSuperBubble_multithread_ptr,
src/CDBG.cpp:1707-1871) and serializes registration under a global mutex
(setNoBubble_multithread_ptr, src/CDBG.cpp:847-1100). The batched
replacement exploits a structural fact of the algorithm:

    extractSuperBubble's DFS (src/CDBG.cpp:2643-2823) reads ONLY the
    graph adjacency — never the shared MyUnitig state. State is touched
    exclusively at registration time.

So the search phase is embarrassingly parallel over seeds: every
(unitig, strand) with out-degree > 1 runs its bounded DFS at once, on
the device. The host then *replays* the recorded outcomes in canonical
seed order (unitig id asc, plus before minus — the reference's
deterministic single-thread order, src/CDBG.cpp:178-252), skipping seeds
whose entrance pointer was already claimed by an earlier registration.
This is exactly equivalent to the sequential algorithm, because a seed's
search result cannot depend on earlier registrations — only its
*admission* can.

Seeds whose region exceeds the fixed caps (seen-set > MAX_SEEN, stack >
MAX_STACK, or step budget) are flagged and fall back to the exact host
search (bubble/superbubble.py).

Per-seed state (MAX_SEEN slots):
    seen  packed (idx<<1 | strand) handle at FIRST sighting — the
          vec_km_seen entry (src/CDBG.cpp:2680, 2717)
    st    0 = not in state_map, 2 = seen, 1 = visited
    sm    strand_map value (updated on pop and on first sighting,
          src/CDBG.cpp:2698-2699, 2719)
    cyc   member of cycle_set (src/CDBG.cpp:2704-2712, 2722-2736)
    stack explicit vertices_visit stack (may hold duplicates, matching
          the reference's std::stack behavior)

`search_batched` dispatches by the tensors' device alone: CUDA tensors
launch the kernel csrc/superbubble_search.cu (a tile of lanes a seed,
several seeds a warp, the whole bounded DFS of every seed in one launch,
each seed stopping on its own condition as under the JAX package's
vmapped `lax.while_loop`; built with nvcc at first use like K1,
kmer/extract.build) or raise; CPU tensors take the plain version
`search_batched_plain`, one torch loop over all seeds in which every
state update of a step is applied only to the lanes still active, so
that finished lanes stay frozen. On the card the seeds' range check and
the largest `nseen` come from the launch itself (one 8-byte word read
back), so a search is one kernel and one host sync.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from .. import resolve_device
from ..graph.cdbg import CDBGraph, UnitigHandle
from ..util.profiling import add_count, span
from .superbubble import (
    NULL,
    BubbleState,
    extract_superbubble,
    list_bubbles,
)

MAX_SEEN = 32
MAX_STACK = 48
MAX_STEPS = 4 * MAX_STACK
MAX_CHUNK = 1 << 17  # seeds a plain-version call (bounds its [S, 4, MS] temporaries)
# steps between the plain version's early-exit checks (each one host sync)
EXIT_CHECK_EVERY = 8
# the kernel keeps one stack a seed in shared memory, 20 bytes an entry
MAX_STACK_CAP = 1024
# lanes a seed the kernel is built for; 0 asks for the one it defaults to
TILES = (4, 8, 16, 32)

# kernel launches made by `search_batched` (plain int; a run sets it to 0
# and reads it back to show the main path went through the kernel)
SEARCH_LAUNCHES = 0
_INT32_MAX = (1 << 31) - 1

_lock = threading.Lock()
_fn = None  # the kernel's entry point, bound at first launch

# outcome codes recorded per seed
STAT_NONE = 0  # stack drained, no cycle: no state change at all
STAT_STALL_CYCLE = 1  # stack drained with flag_cycle: cycle-set cleanup
STAT_CYCLE_EXIT = 2  # closed but exit loops back to seed: setNoBubble cycle
STAT_ABORT = 3  # closed with tip/cycle flag: setNoBubble all
STAT_BUBBLE = 4  # closed clean: real bubble registration
STAT_OVERFLOW = 5  # caps exceeded: host fallback


def search_batched_plain(seed, succ_node, ms=MAX_SEEN, mstk=MAX_STACK, max_steps=MAX_STEPS,
                         counts=None):
    """Plain torch version of the search kernel: the bounded-DFS
    superbubble search for every seed at once, on any device.

    seed: [S] packed seeds; succ_node: [n, 2, 4] packed successors (-1 =
    none); int32 or int64, both on the same device. Returns the kernel's
    outputs (see `search_batched`). The body is the JAX `search_one` body
    line for line, on a leading seed axis, with one-hot masks instead of
    scatters, in int64. With a dict `counts`, counts["steps"] receives the
    number of DFS steps all seeds took together and counts["max_seed_steps"]
    the most that one seed took (one host sync a step).
    """
    if ms > 32:
        # the cycle-set travels as a uint32 bitmask
        raise ValueError(f"MAX_SEEN caps at 32 (uint32 cyc mask), got {ms}")
    seed = seed.long()
    succ_node = succ_node.long()
    dev = seed.device
    S = seed.shape[0]
    i64 = torch.int64
    iota = torch.arange(ms, dtype=i64, device=dev)[None, :]
    istk = torch.arange(mstk, dtype=i64, device=dev)[None, :]
    seed_c = seed[:, None]
    seen = torch.where(iota == 0, seed_c, -1)
    st = torch.zeros((S, ms), dtype=i64, device=dev)
    sm = torch.zeros((S, ms), dtype=i64, device=dev)
    cyc = torch.zeros((S, ms), dtype=torch.bool, device=dev)
    stack = torch.where(istk == 0, seed_c, 0)
    sp = torch.ones(S, dtype=i64, device=dev)
    nseen = torch.ones(S, dtype=i64, device=dev)
    fcyc = torch.zeros(S, dtype=torch.bool, device=dev)
    ftip = torch.zeros(S, dtype=torch.bool, device=dev)
    ovf = torch.zeros(S, dtype=torch.bool, device=dev)
    done = torch.zeros(S, dtype=torch.bool, device=dev)
    status = torch.full((S,), STAT_NONE, dtype=i64, device=dev)
    psec = torch.full((S,), -1, dtype=i64, device=dev)

    if counts is not None:
        counts["steps"] = 0
        seed_steps = torch.zeros(S, dtype=i64, device=dev)
    for step in range(max_steps):
        act = (sp > 0) & ~done & ~ovf  # the while_loop cond, per lane
        if counts is not None:
            counts["steps"] += int(act.sum())
            seed_steps += act
        if step % EXIT_CHECK_EVERY == 0 and not bool(act.any()):
            break
        a1 = act[:, None]
        # -- pop v, mark visited, refresh strand_map (CDBG.cpp:2697-2699)
        sp_n = sp - 1
        v = torch.where(istk == sp_n[:, None], stack, 0).sum(1)
        vidx = v >> 1
        hit_v = (seen >> 1) == vidx[:, None]
        st_n = torch.where(hit_v, 1, st)
        sm_n = torch.where(hit_v, (v & 1)[:, None], sm)
        succs = succ_node[vidx, v & 1]  # [S, 4]
        ftip_n = ftip | (succs < 0).all(1)  # tip (CDBG.cpp:2701-2703)
        seen_n, cyc_n, stack_n = seen, cyc, stack
        nseen_n, fcyc_n, ovf_n = nseen, fcyc, ovf
        for b in range(4):
            u = succs[:, b]
            valid = u >= 0
            hv = (seen_n >> 1) == vidx[:, None]  # v's slot
            # successor is the seed itself: cycle (CDBG.cpp:2705-2712)
            hit_seed = valid & (u == seed)
            fcyc_n = fcyc_n | hit_seed
            cyc_n = cyc_n | (hit_seed[:, None] & ((iota == 0) | hv))
            go = valid & ~hit_seed
            uidx = u >> 1
            ustr = u & 1
            hit_u = (seen_n >> 1) == uidx[:, None]
            found = hit_u.any(1)
            visited = (hit_u & (st_n == 1)).any(1)
            # already-visited successor: cycle (CDBG.cpp:2730-2736)
            dv = go & visited
            fcyc_n = fcyc_n | dv
            cyc_n = cyc_n | (dv[:, None] & (hit_u | hv))
            # not-yet-visited successor (CDBG.cpp:2714-2729)
            doc = go & ~visited
            app = doc & ~found
            ovf_n = ovf_n | (app & (nseen_n >= ms))
            wmask = app[:, None] & (iota == nseen_n.clamp(max=ms - 1)[:, None])
            # strand mismatch check BEFORE any overwrite (found case)
            sm_u = torch.where(hit_u, sm_n, 0).sum(1)
            mism = doc & found & (sm_u != ustr)
            fcyc_n = fcyc_n | mism
            cyc_n = cyc_n | (mism[:, None] & (hit_u | hv))
            seen_n = torch.where(wmask, u[:, None], seen_n)
            sm_n = torch.where(wmask, ustr[:, None], sm_n)
            hit_u2 = hit_u | wmask  # u's slot after a potential append
            nseen_n = nseen_n + app.to(i64)
            st_n = torch.where(doc[:, None] & hit_u2, 2, st_n)
            # all-predecessors-visited gate (CDBG.cpp:2740-2759),
            # all 4 candidate predecessors probed at once
            preds_w = succ_node[uidx, 1 - ustr]  # [S, 4] twin-successors
            pact = doc[:, None] & (preds_w >= 0)
            pred = preds_w ^ 1  # twin -> predecessor handle
            hits_p = (seen_n[:, None, :] >> 1) == (pred[:, :, None] >> 1)
            pfound = hits_p.any(2)
            st_p = torch.where(hits_p, st_n[:, None, :], 0).sum(2)
            sm_p = torch.where(hits_p, sm_n[:, None, :], 0).sum(2)
            pin = pfound & (st_p != 0)  # "in state_map"
            allv = doc & (~pact | (pin & (st_p == 1))).all(1)
            pmism = pact & pin & (sm_p != (pred & 1))
            any_pm = pmism.any(1)
            fcyc_n = fcyc_n | any_pm
            cyc_n = (
                cyc_n
                | (any_pm[:, None] & hit_u2)
                | (pmism[:, :, None] & hits_p).any(1)
            )
            push = doc & allv
            ovf_n = ovf_n | (push & (sp_n >= mstk))
            stkmask = push[:, None] & (istk == sp_n.clamp(max=mstk - 1)[:, None])
            stack_n = torch.where(stkmask, u[:, None], stack_n)
            sp_n = sp_n + push.to(i64)

        # -- closing check (CDBG.cpp:2763-2778)
        top = stack_n[:, 0]
        others = (st_n == 2) & (seen_n != top[:, None]) & (iota < nseen_n[:, None])
        close = (sp_n == 1) & ~others.any(1) & ~ovf_n
        exit_succs = succ_node[top >> 1, top & 1]
        cyc_exit = (exit_succs == seed_c).any(1)
        stat = torch.where(
            cyc_exit,
            STAT_CYCLE_EXIT,
            torch.where(fcyc_n | ftip_n, STAT_ABORT, STAT_BUBBLE),
        )
        # commit the step on active lanes only: finished lanes stay frozen
        seen = torch.where(a1, seen_n, seen)
        st = torch.where(a1, st_n, st)
        sm = torch.where(a1, sm_n, sm)
        cyc = torch.where(a1, cyc_n, cyc)
        stack = torch.where(a1, stack_n, stack)
        sp = torch.where(act, sp_n, sp)
        nseen = torch.where(act, nseen_n, nseen)
        fcyc = torch.where(act, fcyc_n, fcyc)
        ftip = torch.where(act, ftip_n, ftip)
        ovf = torch.where(act, ovf_n, ovf)
        closed = act & close
        status = torch.where(closed, stat, status)
        psec = torch.where(closed, top, psec)
        done = done | closed

    if counts is not None:
        counts["max_seed_steps"] = int(seed_steps.max()) if S else 0
    # stack drained without closing: STAT_NONE / STAT_STALL_CYCLE
    # (CDBG.cpp:2813-2822); caps exceeded: host fallback
    ovf = ovf | (~done & (sp > 0))
    status = torch.where(
        ovf,
        STAT_OVERFLOW,
        torch.where(done, status, torch.where(fcyc, STAT_STALL_CYCLE, STAT_NONE)),
    )
    cyc_mask = torch.where(cyc, 1 << iota, 0).sum(1)
    # the uint32 bitmask's bits in an int32, the kernel's output type
    cyc_mask = torch.where(cyc_mask > _INT32_MAX, cyc_mask - (1 << 32), cyc_mask)
    return (status.to(torch.uint8), psec.to(torch.int32), nseen.to(torch.uint8),
            seen.to(torch.int32), cyc_mask.to(torch.int32))


def _check_search(seed, succ_node, ms, mstk, max_steps):
    """Raise on what the kernel does not take. The seeds' range is checked
    here on the CPU only: on the card the launch checks it (`_search`)."""
    if seed.dtype != torch.int32 or seed.dim() != 1:
        raise TypeError(f"seed must be a 1-d int32 tensor, got {seed.dtype} {tuple(seed.shape)}")
    if succ_node.dtype != torch.int32 or succ_node.dim() != 3 or tuple(succ_node.shape[1:]) != (2, 4):
        raise TypeError(
            f"succ_node must be an [n, 2, 4] int32 tensor, got {succ_node.dtype} "
            f"{tuple(succ_node.shape)}")
    if seed.device != succ_node.device:
        raise ValueError(f"seed on {seed.device} but succ_node on {succ_node.device}")
    if seed.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {seed.device}")
    if not seed.is_contiguous() or not succ_node.is_contiguous():
        raise ValueError("seed and succ_node must be contiguous")
    if not 1 <= ms <= 32:
        raise ValueError(f"MAX_SEEN must lie in 1..32 (uint32 cyc mask), got {ms}")
    if not 1 <= mstk <= MAX_STACK_CAP:
        raise ValueError(f"MAX_STACK must lie in 1..{MAX_STACK_CAP}, got {mstk}")
    if max_steps < 0:
        raise ValueError(f"max_steps must be >= 0, got {max_steps}")
    n = succ_node.shape[0]
    if 2 * n > _INT32_MAX:
        raise ValueError(f"packed handles of {n} unitigs do not fit int32")
    if seed.device.type == "cpu" and seed.numel():
        lo, hi = (int(x) for x in torch.aminmax(seed))
        if lo < 0 or hi >= 2 * n:
            raise ValueError(f"seed handles in [{lo}, {hi}] outside [0, {2 * n}) of {n} unitigs")


def search_batched(seed, succ_node, ms=MAX_SEEN, mstk=MAX_STACK, max_steps=MAX_STEPS):
    """Bounded-DFS superbubble search of every packed seed.

    seed: [S] int32 packed seeds (idx << 1 | strand); succ_node: [n, 2,
    4] int32 packed successors (-1 = none); both contiguous, on one
    device. Returns (status u8 [S], psec i32 [S], nseen u8 [S], seen i32
    [S, ms], cyc i32 [S]: the uint32 cycle bitmask's bits) on that
    device. CUDA tensors launch the kernel, once for all seeds, and read
    one word back, or raise; CPU tensors take the plain version,
    MAX_CHUNK seeds a call. A seed outside [0, 2n) raises ValueError."""
    return _search(seed, succ_node, ms, mstk, max_steps)[0]


def _search(seed, succ_node, ms=MAX_SEEN, mstk=MAX_STACK, max_steps=MAX_STEPS, tile=0):
    """`search_batched`, and the largest nseen as a host int (0 for no
    seeds). On the card that comes from the launch's word, with the count
    of seeds outside the table; `tile` picks the kernel's lanes a seed
    (one of TILES, 0 for its default)."""
    _check_search(seed, succ_node, ms, mstk, max_steps)
    if seed.device.type == "cpu":
        outs = [
            search_batched_plain(seed[off : off + MAX_CHUNK], succ_node, ms, mstk, max_steps)
            for off in range(0, max(seed.numel(), 1), MAX_CHUNK)
        ]
        outs = tuple(torch.cat(x) for x in zip(*outs))
        return outs, int(outs[2].max()) if seed.numel() else 0
    S = seed.numel()
    dev = seed.device
    outs = (
        torch.empty(S, dtype=torch.uint8, device=dev),
        torch.empty(S, dtype=torch.int32, device=dev),
        torch.empty(S, dtype=torch.uint8, device=dev),
        torch.empty((S, ms), dtype=torch.int32, device=dev),
        torch.empty(S, dtype=torch.int32, device=dev),
    )
    if not S:
        return outs, 0
    word = torch.empty(2, dtype=torch.int32, device=dev)
    _launch(seed, succ_node, ms, mstk, max_steps, outs, word, tile)
    bad, nseen_max = word.tolist()
    if bad:
        n = succ_node.shape[0]
        raise ValueError(f"{bad} seed handles outside [0, {2 * n}) of {n} unitigs")
    return outs, nseen_max


def _load():
    global _fn
    with _lock:
        if _fn is None:
            from ..kmer.extract import build

            fn = ctypes.CDLL(build("superbubble_search")).pf_superbubble_search
            fn.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_int, ctypes.c_int, ctypes.c_int,
                *[ctypes.c_void_p] * 6, ctypes.c_int, ctypes.c_void_p,
            ]
            fn.restype = ctypes.c_int
            _fn = fn
        return _fn


def _launch(seed, succ_node, ms, mstk, max_steps, outs, word, tile=0):
    """One launch of the kernel on the current stream over CUDA tensors
    already checked; `word` (2 int32) receives the count of seeds outside
    the table and the largest nseen. Raises on a CUDA error."""
    global SEARCH_LAUNCHES
    fn = _load()
    stream = torch.cuda.current_stream(seed.device).cuda_stream
    with torch.cuda.device(seed.device):
        rc = fn(seed.data_ptr(), seed.numel(), succ_node.data_ptr(), succ_node.shape[0],
                ms, mstk, max_steps, *(t.data_ptr() for t in outs), word.data_ptr(), tile,
                stream)
    if rc != 0:
        raise RuntimeError(f"superbubble_search launch failed: CUDA error {rc}")
    SEARCH_LAUNCHES += 1


def kernel_attributes(tile=0, mstk=MAX_STACK):
    """The compiled kernel of `tile` lanes a seed (0: its default) at stack
    cap `mstk`: a dict of tile, registers (a thread), local_bytes (a
    thread), shared_bytes (a block), blocks_per_sm (resident), threads and
    seeds (a block). Needs a card."""
    from ..kmer.extract import build

    fn = ctypes.CDLL(build("superbubble_search")).pf_superbubble_search_attrs
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 7)()
    rc = fn(tile, mstk, out)
    if rc != 0:
        raise RuntimeError(f"superbubble_search attributes failed: CUDA error {rc}")
    keys = ("tile", "registers", "local_bytes", "shared_bytes", "blocks_per_sm", "threads", "seeds")
    return dict(zip(keys, out))


def search_seeds(g: CDBGraph, seeds: np.ndarray, device="cuda", group=None):
    """Run the batched search for every packed seed. Returns host numpy
    (status u8, psec i32, nseen u8, seen[<=MS] i32, cyc-bitmask u32)
    arrays in seed order; `seen` is column-trimmed to the batch's max
    live slot count (on one device from the launch's own word, with no
    reduction). The successor table goes to the device once, as int32.
    With `group` (parallel/mesh.Group) the seeds split over the ranks
    (parallel/sharded.build_sharded_search_step): rank 0 passes the
    graph and the seeds and gets every output; every other rank passes
    None for both, joins the search with its slice and gets None."""
    dev = resolve_device(group.device if group is not None else device)
    if group is not None:
        from ..parallel.sharded import build_sharded_search_step

        step = build_sharded_search_step(group)
        if group.rank != 0:
            return step()
    seeds = np.asarray(seeds)
    if seeds.size and (seeds.min() < 0 or seeds.max() > _INT32_MAX):
        raise ValueError(f"packed seed handles in [{seeds.min()}, {seeds.max()}] do not fit int32")
    succ_node = torch.from_numpy(np.ascontiguousarray(g._succ, dtype=np.int32)).to(dev)
    seeds_t = torch.from_numpy(seeds.astype(np.int32)).to(dev)
    if group is not None:
        outs, width = step(seeds_t, succ_node), None
    else:
        outs, width = _search(seeds_t, succ_node)
    status, psec, nseen, seen, cyc = outs
    nseen = nseen.cpu().numpy()
    if width is None:  # the ranks' gathered outputs: from the host copy
        width = int(nseen.max()) if nseen.size else 0
    return [
        status.cpu().numpy(),
        psec.cpu().numpy(),
        nseen,
        seen[:, : max(1, width)].cpu().numpy(),
        cyc.cpu().numpy().view(np.uint32),
    ]


def _replay_fast(
    g: CDBGraph,
    state: BubbleState,
    seed_list,
    status,
    psec,
    nseen,
    seen,
    cyc,
    complex_size: int,
    colors=None,
):
    """Replay of the recorded search outcomes, in flat-int form:
    identical state transitions to the UnitigHandle-based loop
    (see _register_bubble / _set_no_bubble_* in superbubble.py, which
    mirror src/CDBG.cpp:552-846) but ~100x faster — plain Python ints
    over list-backed state, no handle objects, no method dispatch.
    tests/test_batched.py cross-validates both paths on random graphs.

    With `colors`, the colored registration gates
    (src/CCDBG.cpp:1450-1812 via superbubble._register_bubble) run on
    three precomputed arrays (ColorMatrix.gate_arrays) — per-unitig
    color-pair counts, full-unitig membership masks, and k-mer counts —
    instead of per-bubble ColorMatrix row slicing."""
    n = len(state.flags)
    if colors is not None:
        csizes, ccontains, cnkm = colors.gate_arrays()
        csizes_l = csizes.tolist()
        cnkm_l = cnkm.tolist()
        C = colors.n_colors
    flags = state.flags.tolist()
    plus = state.plus.tolist()
    minus = state.minus.tolist()
    # flat lists (index arithmetic) — building [n][2][4] nested lists
    # costs more than the whole replay loop at 100k+ unitigs
    succ = np.asarray(g._succ).reshape(-1).tolist()  # [n*8] (idx*2+strand)
    out_deg = np.asarray(g._out_deg).reshape(-1).tolist()  # [n*2]
    seeds_l = seed_list.tolist()
    status_l = status.tolist()
    psec_l = psec.tolist()
    nseen_l = nseen.tolist()
    seen_l = seen.tolist()
    cyc_l = cyc.tolist()
    NULLV = NULL

    def set_plus_self(x):
        plus[x] = x
        flags[x] &= 0xFE

    def set_minus_self(x):
        minus[x] = x
        flags[x] &= 0xFD

    def detach_and_self(x):
        ex = plus[x]
        if ex != NULLV and ex != x:
            if plus[ex] == x:
                set_plus_self(ex)
            else:
                set_minus_self(ex)
        set_plus_self(x)
        ex = minus[x]
        if ex != NULLV and ex != x:
            if plus[ex] == x:
                set_plus_self(ex)
            else:
                set_minus_self(ex)
        set_minus_self(x)

    def detach_endpoint(x, use_plus):
        # the endpoint detach block of _set_no_bubble_all
        # (src/CDBG.cpp:603-650): no ex != x guard, matching the ref
        ex = plus[x] if use_plus else minus[x]
        if ex != NULLV:
            if plus[ex] == x:
                set_plus_self(ex)
            else:
                set_minus_self(ex)
        if use_plus:
            set_plus_self(x)
        else:
            set_minus_self(x)

    for si in range(len(seeds_l)):
        sp = seeds_l[si]
        i = sp >> 1
        strand = sp & 1
        if (plus[i] if strand else minus[i]) != NULLV:
            continue  # claimed by an earlier registration
        stt = status_l[si]
        if stt == STAT_NONE:
            continue
        if stt == STAT_OVERFLOW:
            # host fallback: run the exact search on a VIEW over the
            # replay's own flat lists — BubbleState's ops are all
            # per-element, so plain lists satisfy the same API and the
            # former per-seed whole-array sync (O(n) both ways PER
            # overflow seed: quadratic at 1M+ unitigs, the round-4
            # 50 Mbp wall) disappears
            lview = BubbleState.__new__(BubbleState)
            lview.flags = flags
            lview.plus = plus
            lview.minus = minus
            extract_superbubble(
                g, lview, UnitigHandle(g, i, bool(strand)), complex_size,
                colors,
            )
            continue
        ns = nseen_l[si]
        row = seen_l[si]
        if stt == STAT_STALL_CYCLE:
            cmask = cyc_l[si]
            for slot in range(ns):
                if (cmask >> slot) & 1:
                    x = row[slot] >> 1
                    detach_and_self(x)
                    flags[x] |= 0x04
            if strand:
                set_plus_self(i)
            else:
                set_minus_self(i)
            continue
        pj = psec_l[si]
        j = pj >> 1
        jstrand = pj & 1
        if stt == STAT_CYCLE_EXIT:
            # _set_no_bubble_cycle (src/CDBG.cpp:552-602)
            for slot in range(ns):
                x = row[slot] >> 1
                detach_and_self(x)
                flags[x] |= 0x04
            if strand:
                set_plus_self(i)
            else:
                set_minus_self(i)
            if not jstrand:
                set_plus_self(j)
            else:
                set_minus_self(j)
        elif stt == STAT_ABORT:
            # _set_no_bubble_all (src/CDBG.cpp:603-699)
            detach_endpoint(i, bool(strand))
            detach_endpoint(j, not jstrand)
            for slot in range(ns):
                p = row[slot]
                if p == sp or p == pj:
                    continue
                x = p >> 1
                detach_and_self(x)
                flags[x] |= 0x04
        else:  # STAT_BUBBLE: _register_bubble (src/CDBG.cpp:700-846)
            if ns < 4:
                continue
            if (flags[j] | flags[i]) & 0x04:
                for slot in range(ns):
                    p = row[slot]
                    if p == sp:
                        if strand:
                            set_plus_self(i)
                        else:
                            set_minus_self(i)
                        continue
                    if p == pj:
                        # inverted strand handling vs the cycle variant
                        if jstrand:
                            set_minus_self(j)
                        else:
                            set_plus_self(j)
                        continue
                    x = p >> 1
                    detach_and_self(x)
                    flags[x] |= 0x04
                continue
            if ns <= 6:
                strict = True
                for slot in range(ns):
                    p = row[slot]
                    if p == sp or p == pj:
                        continue
                    x = p >> 1
                    xs = p & 1
                    # exactly one predecessor == entrance unitig and one
                    # successor == exit unitig (src/CDBG.cpp:1019-1041);
                    # in-degree(x, s) == out-degree(x, !s), pred idx =
                    # the single twin-successor's idx
                    if (
                        out_deg[x * 2 + 1 - xs] != 1
                        or out_deg[x * 2 + xs] != 1
                    ):
                        strict = False
                        break
                    base = x * 8 + (1 - xs) * 4
                    pk = succ[base]
                    if pk < 0:
                        pk = succ[base + 1]
                        if pk < 0:
                            pk = succ[base + 2]
                            if pk < 0:
                                pk = succ[base + 3]
                    if pk >> 1 != i:
                        strict = False
                        break
                    base = x * 8 + xs * 4
                    sk = succ[base]
                    if sk < 0:
                        sk = succ[base + 1]
                        if sk < 0:
                            sk = succ[base + 2]
                            if sk < 0:
                                sk = succ[base + 3]
                    if sk >> 1 != j:
                        strict = False
                        break
                if strict:
                    flags[i] |= 0x10 if strand else 0x08
                    flags[j] |= 0x08 if jstrand else 0x10
            if ns > complex_size:
                flags[i] |= 0x40 if strand else 0x20
                flags[j] |= 0x20 if jstrand else 0x40
            for slot in range(ns):
                p = row[slot]
                if p == sp or p == pj:
                    continue
                x = p >> 1
                detach_and_self(x)
                flags[x] |= 0x04
            if colors is not None:
                # colored registration gates (the flat form of
                # superbubble._register_bubble's colors block, matching
                # src/CCDBG.cpp uniform-color + successor-coverage rules)
                def endpoints_self():
                    if strand:
                        set_plus_self(i)
                    else:
                        set_minus_self(i)
                    if not jstrand:
                        set_plus_self(j)
                    else:
                        set_minus_self(j)

                f = True
                if csizes_l[i] != cnkm_l[i] * C:
                    f = False
                    flags[i] |= 0x04
                    endpoints_self()
                if colors.size_as_flat(j, cnkm_l[i]) != cnkm_l[j] * C:
                    f = False
                    flags[j] |= 0x04
                    endpoints_self()
                if f:
                    all_mask = np.ones(C, dtype=bool)
                    required = {i: all_mask, j: all_mask}
                    for slot in range(ns):
                        p = row[slot]
                        if p == pj:
                            continue
                        x = p >> 1
                        xs = p & 1
                        req = required.get(x)
                        if req is None:
                            req = ccontains[x]
                            required[x] = req
                        suc_any = np.zeros(C, dtype=bool)
                        base = x * 8 + xs * 4
                        for b in range(4):
                            sk = succ[base + b]
                            if sk >= 0:
                                suc_any |= ccontains[sk >> 1]
                        if (req & ~suc_any).any():
                            f = False
                            break
                    if not f:
                        endpoints_self()
                if not f:
                    continue
            if strand:
                plus[i] = j
                flags[i] |= 0x01
            else:
                minus[i] = j
                flags[i] |= 0x02
            if jstrand:
                minus[j] = i
                flags[j] |= 0x02
            else:
                plus[j] = i
                flags[j] |= 0x01

    state.flags = np.array(flags, dtype=np.uint8)
    state.plus = np.array(plus, dtype=np.int64)
    state.minus = np.array(minus, dtype=np.int64)


def canonical_seeds(g: CDBGraph) -> np.ndarray:
    """Packed handles (idx << 1 | plus) with out-degree > 1 in canonical
    order: unitig id asc, plus before minus (src/CDBG.cpp:178-252)."""
    n = len(g)
    deg = np.asarray(g._out_deg)  # [n, 2], columns (minus, plus)
    plus_b = deg[:, 1] > 1
    minus_b = deg[:, 0] > 1
    idx = np.arange(n, dtype=np.int32)
    # interleave in (i, plus), (i, minus) order
    order = np.lexsort((1 - np.concatenate([np.ones(plus_b.sum(), np.int8),
                                            np.zeros(minus_b.sum(), np.int8)]),
                        np.concatenate([idx[plus_b], idx[minus_b]])))
    packed = np.concatenate([idx[plus_b] * 2 + 1, idx[minus_b] * 2])
    return packed[order].astype(np.int32)


def find_superbubbles_device(
    g: CDBGraph, complex_size: int = 8, colors=None, device="cuda", group=None
) -> tuple[BubbleState, list]:
    """Drop-in replacement for superbubble.find_superbubbles: batched
    search on `device` (or split over `group`'s ranks, called on rank 0:
    the other ranks join with search_seeds(None, None, group=group)) +
    host replay. Byte-identical outputs. Spans: `search` (the seeds,
    upload, launch and readback) and `replay`."""
    n = len(g)
    state = BubbleState(n)
    with span("search"):
        seed_list = canonical_seeds(g)
        add_count("seeds", len(seed_list))
        if len(seed_list) == 0:
            if group is not None:  # the other ranks wait in the search's broadcast
                search_seeds(g, seed_list, device, group)
            return state, []
        status, psec, nseen, seen, cyc = search_seeds(g, seed_list, device, group)

    with span("replay"):
        # flat-int replay: same transitions, no handle objects; the colored
        # registration gates run on precomputed ColorMatrix arrays
        _replay_fast(
            g, state, seed_list, status, psec, nseen, seen, cyc, complex_size,
            colors,
        )
        return state, list_bubbles(state, n, colors)

// Superbubble search: the bounded extractSuperBubble DFS of every seed
// (src/CDBG.cpp:2643-2823), one warp a seed, the whole loop in one launch.
//
// Replaces: ploidyfrost_tpu/bubble/batched.py:105 `search_one`, the body
// of the vmapped lax.while_loop that the JAX package jits (`_build_search`)
// and runs on the TPU as one device program. In the port it took the place
// of a host-driven torch loop (bubble/batched.py::search_batched_plain,
// about 56 small launches a step and a host sync every 8 steps).
//
// What it computes, for each packed seed (idx << 1 | strand) over the
// successor table succ [n, 2, 4] (packed handles, -1 = none): the outcome
// status, the exit handle psec, the number of seen handles nseen (it may
// count past ms on overflow), the seen set [ms] (first-sighting handles,
// -1 in unused slots) and the cycle set as a bitmask, all bit-equal to the
// JAX body: every `where` over the slot axis of `search_one` is a lane
// predicate here, every `jnp.any` a ballot, every masked `jnp.sum` (at
// most one hit: the idx values in `seen` are unique) a shuffle from the
// lane that the ballot names. The caps ms (<= 32), mstk and max_steps are
// runtime arguments; each seed stops on its own condition, as under vmap.
//
// Layout: lane i of a warp owns seen slot i (seen, st, sm and cyc in its
// registers); lanes >= ms hold seen = -1 and are never selected, because
// every probe that reaches the slots is of an idx >= 0. The explicit stack
// (mstk ints) lives in shared memory, one stack a warp. The successor rows
// are 16 bytes (one int4, one sector): a step reads the popped handle's row
// and, at once, the four twin rows of its successors (the predecessor
// probes), so the chain of dependent reads is two rows a step, plus the
// exit row when a seed closes.
//
// What bounds it: latency, not bytes. A seed's DFS is a chain of dependent
// reads of rows (up to max_steps steps) interleaved with warp shuffles; the
// rows of a graph of a few 100k unitigs stay in the 50 MB L2. The design
// keeps many warps resident (4 warps a block, a little shared memory, no
// block-wide barrier) so that the card overlaps the seeds' chains.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 4;  // warps (seeds in flight) a block

// outcome codes, as ploidyfrost_tpu_torch/bubble/batched.py STAT_*
constexpr int STAT_NONE = 0;
constexpr int STAT_STALL_CYCLE = 1;
constexpr int STAT_CYCLE_EXIT = 2;
constexpr int STAT_ABORT = 3;
constexpr int STAT_BUBBLE = 4;
constexpr int STAT_OVERFLOW = 5;

__device__ __forceinline__ int4 row(const int4* __restrict__ succ, int handle) {
  // row (idx, strand) of succ [n, 2, 4] is int4 number idx * 2 + strand
  return __ldg(succ + handle);
}

__device__ __forceinline__ int4 twin_row(const int4* __restrict__ succ, int u) {
  // succ[u >> 1, 1 - (u & 1)]: the twin's successors, whose twins are u's
  // predecessors
  return __ldg(succ + (u ^ 1));
}

__device__ __forceinline__ int comp(const int4& r, int b) {
  return b == 0 ? r.x : b == 1 ? r.y : b == 2 ? r.z : r.w;
}

// x on the lane whose bit is set in `hits` (at most one), 0 when none:
// the masked jnp.sum of the JAX body
__device__ __forceinline__ int pick(unsigned hits, int x) {
  const int src = __ffs(hits) - 1;
  const int y = __shfl_sync(FULL, x, src < 0 ? 0 : src);
  return src < 0 ? 0 : y;
}

__global__ void __launch_bounds__(WARPS * 32)
superbubble_search(const int* __restrict__ seeds, long long S, const int4* __restrict__ succ,
                   int ms, int mstk, int max_steps, uint8_t* __restrict__ status_out,
                   int* __restrict__ psec_out, uint8_t* __restrict__ nseen_out,
                   int* __restrict__ seen_out, unsigned* __restrict__ cyc_out) {
  extern __shared__ int stacks[];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const long long s = (long long)blockIdx.x * WARPS + w;
  if (s >= S) return;  // warp-uniform: the whole warp leaves
  int* stk = stacks + w * mstk;

  const int seed = seeds[s];
  int seen = lane == 0 ? seed : -1;
  int st = 0;  // 0 = not in state_map, 2 = seen, 1 = visited
  int sm = 0;  // strand_map
  bool cyc = false;
  if (lane == 0) stk[0] = seed;
  __syncwarp();
  int sp = 1, nseen = 1, steps = 0, status = STAT_NONE, psec = -1;
  bool fcyc = false, ftip = false, ovf = false, done = false;

  while (sp > 0 && !done && !ovf && steps < max_steps) {
    // -- pop v, mark visited, refresh strand_map (CDBG.cpp:2697-2699)
    sp -= 1;
    const int v = stk[sp];
    __syncwarp();  // every lane has read v before a push may overwrite it
    const int vidx = v >> 1;
    if ((seen >> 1) == vidx) {
      st = 1;
      sm = v & 1;
    }
    const int4 su = row(succ, v);
    ftip |= su.x < 0 && su.y < 0 && su.z < 0 && su.w < 0;  // tip (CDBG.cpp:2701-2703)
    // the four predecessor probes' rows, read together (only a successor
    // that is neither absent nor the seed can need its row)
    int4 tw[4];
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int u = comp(su, b);
      tw[b] = u >= 0 && u != seed ? twin_row(succ, u) : make_int4(-1, -1, -1, -1);
    }

#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int u = comp(su, b);  // warp-uniform, as is every branch below
      if (u < 0) continue;
      const bool hv = (seen >> 1) == vidx;  // v's slot, from the current seen
      if (u == seed) {  // successor is the seed itself: cycle (CDBG.cpp:2705-2712)
        fcyc = true;
        cyc |= lane == 0 || hv;
        continue;
      }
      const int uidx = u >> 1, ustr = u & 1;
      const bool hit_u = (seen >> 1) == uidx;
      const unsigned hits_u = __ballot_sync(FULL, hit_u);
      const bool found = hits_u != 0;
      if (pick(hits_u, st) == 1) {  // already visited: cycle (CDBG.cpp:2730-2736)
        fcyc = true;
        cyc |= hit_u || hv;
        continue;
      }
      // not yet visited (CDBG.cpp:2714-2729); strand check before any write
      const bool app = !found;
      if (app && nseen >= ms) ovf = true;
      const bool wm = app && lane == min(nseen, ms - 1);
      if (found && pick(hits_u, sm) != ustr) {
        fcyc = true;
        cyc |= hit_u || hv;
      }
      if (wm) {
        seen = u;
        sm = ustr;
      }
      const bool hit_u2 = hit_u || wm;  // u's slot after a possible append
      nseen += app;
      if (hit_u2) st = 2;
      // all-predecessors-visited gate (CDBG.cpp:2740-2759) on the seen,
      // st and sm after the append
      bool allv = true, anypm = false;
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const int pw = comp(tw[b], p);
        if (pw < 0) continue;
        const int pred = pw ^ 1;  // twin -> predecessor handle
        const bool hp = (seen >> 1) == (pred >> 1);
        const unsigned hits_p = __ballot_sync(FULL, hp);
        const int st_p = pick(hits_p, st);
        const bool pin = hits_p != 0 && st_p != 0;  // "in state_map"
        allv = allv && pin && st_p == 1;
        if (pin && pick(hits_p, sm) != (pred & 1)) {
          anypm = true;
          cyc |= hp;
        }
      }
      if (anypm) {
        fcyc = true;
        cyc |= hit_u2;
      }
      if (allv) {
        if (sp >= mstk) ovf = true;
        if (lane == 0) stk[min(sp, mstk - 1)] = u;
        sp += 1;
      }
    }
    __syncwarp();  // the pushes are visible to every lane

    // -- closing check (CDBG.cpp:2763-2778)
    const int top = stk[0];
    const bool others = __any_sync(FULL, st == 2 && seen != top && lane < nseen);
    if (sp == 1 && !others && !ovf) {
      const int4 ex = row(succ, top);
      const bool cyc_exit = ex.x == seed || ex.y == seed || ex.z == seed || ex.w == seed;
      status = cyc_exit ? STAT_CYCLE_EXIT : (fcyc || ftip) ? STAT_ABORT : STAT_BUBBLE;
      psec = top;
      done = true;
    }
    steps += 1;
  }

  // stack drained without closing: STAT_NONE / STAT_STALL_CYCLE
  // (CDBG.cpp:2813-2822); caps exceeded or steps spent: host fallback
  ovf = ovf || (!done && sp > 0);
  status = ovf ? STAT_OVERFLOW : done ? status : fcyc ? STAT_STALL_CYCLE : STAT_NONE;
  const unsigned cyc_mask = __ballot_sync(FULL, cyc);
  if (lane < ms) seen_out[s * ms + lane] = seen;
  if (lane == 0) {
    status_out[s] = (uint8_t)status;
    psec_out[s] = psec;
    nseen_out[s] = (uint8_t)nseen;
    cyc_out[s] = cyc_mask;
  }
}

}  // namespace

// One launch over all S seeds on `stream`; allocates nothing, does not
// synchronise. seeds [S] int32, succ [n, 2, 4] int32, outputs status [S]
// u8, psec [S] i32, nseen [S] u8, seen [S, ms] i32, cyc [S] u32. Returns
// the CUDA error code of the launch (0 on success).
extern "C" int pf_superbubble_search(const int* seeds, long long S, const int* succ, long long n,
                                     int ms, int mstk, int max_steps, uint8_t* status, int* psec,
                                     uint8_t* nseen, int* seen, unsigned* cyc, void* stream) {
  if (ms < 1 || ms > 32 || mstk < 1 || max_steps < 0 || n < 0 || 2 * n > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (S <= 0) return 0;
  const long long blocks = (S + WARPS - 1) / WARPS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)WARPS * mstk * sizeof(int);
  superbubble_search<<<(unsigned)blocks, WARPS * 32, smem, (cudaStream_t)stream>>>(
      seeds, S, reinterpret_cast<const int4*>(succ), ms, mstk, max_steps, status, psec, nseen,
      seen, reinterpret_cast<unsigned*>(cyc));
  return (int)cudaGetLastError();
}

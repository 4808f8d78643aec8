// Superbubble search: the bounded extractSuperBubble DFS of every seed
// (src/CDBG.cpp:2643-2823), a tile of T lanes a seed, 32 / T seeds a warp,
// the whole loop of every seed in one launch.
//
// Replaces: ploidyfrost_tpu/bubble/batched.py:105 `search_one`, the body
// of the vmapped lax.while_loop that the JAX package jits (`_build_search`)
// and runs on the TPU as one device program. Its plain version is the
// torch loop bubble/batched.py::search_batched_plain.
//
// What it computes, for each packed seed (idx << 1 | strand) over the
// successor table succ [n, 2, 4] (packed handles, -1 = none): the outcome
// status, the exit handle psec, the number of seen handles nseen (it may
// count past ms on overflow), the seen set [ms] (first-sighting handles,
// -1 in unused slots) and the cycle set as a bitmask, all bit-equal to the
// JAX body. The caps ms (<= 32), mstk (<= 1024) and max_steps are runtime
// arguments; each seed stops on its own condition, as under vmap. In the
// same launch every tile checks its seed against [0, 2n) (a seed outside
// reads and writes nothing and adds 1 to word[0]) and atomicMaxes its
// nseen into word[1], so the caller reads one 8-byte word back and runs no
// reduction.
//
// Layout: a tile of T lanes (cooperative_groups::tiled_partition<T>) runs
// one seed. Seen slot j lives in lane j % T, register j / T (32 / T
// registers a lane); lanes of slots >= ms hold -1 and never match, since
// every probe is of an idx >= 0. Everything else of a slot (st == 1,
// st == 2, strand_map, cycle_set) is a tile-uniform 32-bit mask, bit j
// for slot j. A probe of the JAX body (`seen >> 1 == idx` over the slot
// axis) is one tile ballot a register, assembled into the mask of the
// slots that hit (at most one: the idx values in `seen` are unique), and
// every `where`, `jnp.any` and masked `jnp.sum` over the slots becomes a
// mask operation that every lane of the tile computes alike. So a probe
// costs one ballot at T = 32, and the cycle mask needs no reduction.
//
// What bounds it: latency and issue, not bytes. A seed's DFS is a chain of
// dependent steps; the table of a genome's graph fits the 50 MB L2, but
// its rows are cold at first touch, and the steps' ballots and mask
// arithmetic fill the schedulers while thousands of seeds run at once. So
// each step makes ONE round of reads: the twin row of each live successor
// (its predecessor probes); when the successor is pushed, its own row,
// the other half of the same 32-byte sector, is taken from L1 onto the
// stack beside its handle, so a pop and the closing check read shared
// memory only. The chain is steps + 1 read rounds (the seed's row before
// the loop). A predecessor that is the popped node itself (the usual one)
// takes the popped node's known mask and no ballot. Tiles of one warp
// diverge freely: every collective names its own tile's lanes, there is
// no block-wide barrier, and a tile whose seed is past S leaves at once.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int WARPS = 4;          // warps a block at most
constexpr int DEFAULT_TILE = 16;  // lanes a seed on the package's path, as measured (PERF.md)

// outcome codes, as ploidyfrost_tpu_torch/bubble/batched.py STAT_*
constexpr int STAT_NONE = 0;
constexpr int STAT_STALL_CYCLE = 1;
constexpr int STAT_CYCLE_EXIT = 2;
constexpr int STAT_ABORT = 3;
constexpr int STAT_BUBBLE = 4;
constexpr int STAT_OVERFLOW = 5;

__device__ __forceinline__ int comp(const int4& r, int b) {
  return b == 0 ? r.x : b == 1 ? r.y : b == 2 ? r.z : r.w;
}

// the slots (bit j: slot j) whose handle satisfies `hit`: one tile ballot
// a register
template <int T, int R, typename Tile, typename Hit>
__device__ __forceinline__ unsigned slot_mask(const Tile& tile, const int (&seen)[R], Hit hit) {
  unsigned m = 0;
#pragma unroll
  for (int r = 0; r < R; ++r) m |= tile.ballot(hit(seen[r])) << (r * T);
  return m;
}

// the slots holding a handle of unitig idx
template <int T, int R, typename Tile>
__device__ __forceinline__ unsigned slots_of(const Tile& tile, const int (&seen)[R], int idx) {
  return slot_mask<T>(tile, seen, [idx](int x) { return (x >> 1) == idx; });
}

template <int T>
__global__ void __launch_bounds__(WARPS * 32)
superbubble_search(const int* __restrict__ seeds, long long S, const int4* __restrict__ succ,
                   int n2, int ms, int mstk, int max_steps, uint8_t* __restrict__ status_out,
                   int* __restrict__ psec_out, uint8_t* __restrict__ nseen_out,
                   int* __restrict__ seen_out, unsigned* __restrict__ cyc_out,
                   unsigned* __restrict__ word) {
  constexpr int R = 32 / T;  // slots a lane
  extern __shared__ int4 smem[];
  const auto tile = cg::tiled_partition<T>(cg::this_thread_block());
  const int t = tile.thread_rank();
  const int k = tile.meta_group_rank();  // the seed's place in the block
  const int per_block = tile.meta_group_size();
  const long long s = (long long)blockIdx.x * per_block + k;
  if (s >= S) return;  // tile-uniform: the tile leaves, no other tile waits on it

  // the seed's stack: rows [mstk] int4 and handles [mstk] int, the row at
  // an index always that of the handle at it. Every lane writes the same
  // entries, so a lane's own reads of the stack need no barrier.
  int4* rows = smem + k * mstk;
  int* stk = reinterpret_cast<int*>(smem + per_block * mstk) + k * mstk;

  const int seed = seeds[s];
  if (seed < 0 || seed >= n2) {  // outside the table: read nothing, write nothing
    if (t == 0) atomicAdd(word, 1u);
    return;
  }
  int seen[R];
#pragma unroll
  for (int r = 0; r < R; ++r) seen[r] = -1;
  if (t == 0) seen[0] = seed;
  // slot masks: st == 1 (visited), st == 2 (seen), strand_map, cycle_set
  unsigned vis = 0, sn = 0, smk = 0, cyc = 0;
  stk[0] = seed;
  rows[0] = __ldg(succ + seed);
  int sp = 1, nseen = 1, steps = 0, status = STAT_NONE, psec = -1;
  bool fcyc = false, ftip = false, ovf = false, done = false;

  while (sp > 0 && !done && !ovf && steps < max_steps) {  // tile-uniform, as is every branch below
    // -- pop v, mark visited, refresh strand_map (CDBG.cpp:2697-2699)
    sp -= 1;
    const int v = stk[sp];
    const int4 su = rows[sp];
    unsigned hv = slots_of<T>(tile, seen, v >> 1);  // v's slot, kept current below
    vis |= hv;
    sn &= ~hv;
    smk = v & 1 ? smk | hv : smk & ~hv;
    ftip |= su.x < 0 && su.y < 0 && su.z < 0 && su.w < 0;  // tip (CDBG.cpp:2701-2703)

    // -- the step's one read round: the twin row of each successor that is
    // neither absent nor the seed
    int4 twin[4];
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int u = comp(su, b);
      twin[b] = u >= 0 && u != seed ? __ldg(succ + (u ^ 1)) : make_int4(-1, -1, -1, -1);
    }

#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int u = comp(su, b);
      if (u < 0) continue;
      if (u == seed) {  // successor is the seed itself: cycle (CDBG.cpp:2705-2712)
        fcyc = true;
        cyc |= hv | 1u;
        continue;
      }
      const int ustr = u & 1;
      const unsigned hu = slots_of<T>(tile, seen, u >> 1);
      if (hu & vis) {  // already visited: cycle (CDBG.cpp:2730-2736)
        fcyc = true;
        cyc |= hu | hv;
        continue;
      }
      // not yet visited (CDBG.cpp:2714-2729); strand check before any write
      const bool app = hu == 0;
      if (app && nseen >= ms) ovf = true;
      const int ws = min(nseen, ms - 1);  // the append's slot
      const unsigned wm = app ? 1u << ws : 0u;
      if (!app && (int)((smk & hu) != 0) != ustr) {
        fcyc = true;
        cyc |= hu | hv;
      }
      if (app && ws % T == t) {
#pragma unroll
        for (int r = 0; r < R; ++r)
          if (r == ws / T) seen[r] = u;
      }
      smk = ustr ? smk | wm : smk & ~wm;
      const unsigned hu2 = hu | wm;  // u's slot after a possible append
      nseen += app;
      sn |= hu2;
      vis &= ~hu2;
      hv &= ~wm;  // an append at ms - 1 may overwrite v's slot
      // all-predecessors-visited gate (CDBG.cpp:2740-2759) on the seen,
      // st and strand_map after the append; the twin row's successors are
      // the twins of u's predecessors
      bool allv = true, anypm = false;
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const int pw = comp(twin[b], p);
        if (pw < 0) continue;
        const int pred = pw ^ 1;
        const unsigned hp = (pred >> 1) == (v >> 1) ? hv : slots_of<T>(tile, seen, pred >> 1);
        const bool pin = hp & (vis | sn);  // "in state_map"
        allv = allv && pin && (hp & vis);
        if (pin && (int)((smk & hp) != 0) != (pred & 1)) {
          anypm = true;
          cyc |= hp;
        }
      }
      if (anypm) {
        fcyc = true;
        cyc |= hu2;
      }
      if (allv) {
        if (sp >= mstk) ovf = true;
        const int pos = min(sp, mstk - 1);
        stk[pos] = u;
        rows[pos] = __ldg(succ + u);  // the twin row's sector, in L1
        sp += 1;
      }
    }

    // -- closing check (CDBG.cpp:2763-2778) on the stack's bottom and its row
    if (sp == 1 && !ovf) {
      const int top = stk[0];
      const unsigned at_top = slot_mask<T>(tile, seen, [top](int x) { return x == top; });
      const unsigned live = nseen >= 32 ? 0xffffffffu : (1u << nseen) - 1u;
      if ((sn & ~at_top & live) == 0) {
        const int4 ex = rows[0];
        const bool cyc_exit = ex.x == seed || ex.y == seed || ex.z == seed || ex.w == seed;
        status = cyc_exit ? STAT_CYCLE_EXIT : (fcyc || ftip) ? STAT_ABORT : STAT_BUBBLE;
        psec = top;
        done = true;
      }
    }
    steps += 1;
  }

  // stack drained without closing: STAT_NONE / STAT_STALL_CYCLE
  // (CDBG.cpp:2813-2822); caps exceeded or steps spent: host fallback
  ovf = ovf || (!done && sp > 0);
  status = ovf ? STAT_OVERFLOW : done ? status : fcyc ? STAT_STALL_CYCLE : STAT_NONE;
#pragma unroll
  for (int r = 0; r < R; ++r)
    if (r * T + t < ms) seen_out[s * ms + r * T + t] = seen[r];
  if (t == 0) {
    status_out[s] = (uint8_t)status;
    psec_out[s] = psec;
    nseen_out[s] = (uint8_t)nseen;
    cyc_out[s] = cyc;
    atomicMax(word + 1, (unsigned)(uint8_t)nseen);
  }
}

// The launch shape: threads and seeds a block, at most WARPS warps, fewer
// where the block's stacks (mstk x 20 bytes a seed) would not fit the
// card's shared memory; its dynamic shared bytes. Sets the kernel's
// dynamic shared memory limit where that is above 48 KB.
struct Shape {
  int threads;
  int seeds;
  size_t smem;
};

template <int T>
cudaError_t shape(int mstk, Shape* out) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  const size_t per_seed = (size_t)mstk * (sizeof(int4) + sizeof(int));
  int warps = WARPS;
  while (warps > 1 && warps * (32 / T) * per_seed > (size_t)optin) --warps;
  const size_t smem = warps * (32 / T) * per_seed;
  if (smem > (size_t)optin) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(superbubble_search<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
  }
  *out = {warps * 32, warps * (32 / T), smem};
  return cudaSuccess;
}

template <int T>
cudaError_t launch(const int* seeds, long long S, const int* succ, long long n, int ms, int mstk,
                   int max_steps, uint8_t* status, int* psec, uint8_t* nseen, int* seen,
                   unsigned* cyc, unsigned* word, cudaStream_t stream) {
  Shape sh;
  cudaError_t err = shape<T>(mstk, &sh);
  if (err != cudaSuccess) return err;
  const long long blocks = (S + sh.seeds - 1) / sh.seeds;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  err = cudaMemsetAsync(word, 0, 2 * sizeof(unsigned), stream);
  if (err != cudaSuccess) return err;
  superbubble_search<T><<<(unsigned)blocks, sh.threads, sh.smem, stream>>>(
      seeds, S, reinterpret_cast<const int4*>(succ), (int)(2 * n), ms, mstk, max_steps, status,
      psec, nseen, seen, cyc, word);
  return cudaGetLastError();
}

template <int T>
cudaError_t attrs(int mstk, int* out) {
  Shape sh;
  cudaFuncAttributes fa;
  int blocks = 0;
  cudaError_t err = shape<T>(mstk, &sh);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, superbubble_search<T>);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, superbubble_search<T>,
                                                        sh.threads, sh.smem);
  if (err != cudaSuccess) return err;
  const int vals[7] = {T, fa.numRegs, (int)fa.localSizeBytes,
                       (int)(sh.smem + fa.sharedSizeBytes), blocks, sh.threads, sh.seeds};
  for (int i = 0; i < 7; ++i) out[i] = vals[i];
  return cudaSuccess;
}

}  // namespace

// One launch over all S seeds on `stream` with tiles of `tile` lanes (4,
// 8, 16 or 32; 0 takes DEFAULT_TILE); allocates nothing, does not
// synchronise. seeds [S] int32, succ [n, 2, 4] int32, outputs status [S]
// u8, psec [S] i32, nseen [S] u8, seen [S, ms] i32, cyc [S] u32, word [2]
// u32 (set here to 0, then the count of seeds outside [0, 2n) and the
// largest nseen). A seed outside the table writes no output. Returns the
// CUDA error code of the launch (0 on success).
extern "C" int pf_superbubble_search(const int* seeds, long long S, const int* succ, long long n,
                                     int ms, int mstk, int max_steps, uint8_t* status, int* psec,
                                     uint8_t* nseen, int* seen, unsigned* cyc, unsigned* word,
                                     int tile, void* stream) {
  if (ms < 1 || ms > 32 || mstk < 1 || mstk > 1024 || max_steps < 0 || n < 0 ||
      2 * n > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (S <= 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (tile ? tile : DEFAULT_TILE) {
    case 4: return (int)launch<4>(seeds, S, succ, n, ms, mstk, max_steps, status, psec, nseen, seen, cyc, word, st);
    case 8: return (int)launch<8>(seeds, S, succ, n, ms, mstk, max_steps, status, psec, nseen, seen, cyc, word, st);
    case 16: return (int)launch<16>(seeds, S, succ, n, ms, mstk, max_steps, status, psec, nseen, seen, cyc, word, st);
    case 32: return (int)launch<32>(seeds, S, succ, n, ms, mstk, max_steps, status, psec, nseen, seen, cyc, word, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The compiled kernel of `tile` lanes a seed (0: DEFAULT_TILE) at stack
// cap `mstk`, into out[7]: tile, registers a thread, local memory bytes a
// thread, shared memory bytes a block, resident blocks a multiprocessor
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), threads a block, seeds
// a block. Returns a CUDA error code.
extern "C" int pf_superbubble_search_attrs(int tile, int mstk, int* out) {
  if (mstk < 1 || mstk > 1024) return (int)cudaErrorInvalidValue;
  switch (tile ? tile : DEFAULT_TILE) {
    case 4: return (int)attrs<4>(mstk, out);
    case 8: return (int)attrs<8>(mstk, out);
    case 16: return (int)attrs<16>(mstk, out);
    case 32: return (int)attrs<32>(mstk, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K1: canonical k-mer extraction for NVIDIA Hopper (sm_90a), plain C ABI.
//
// Replaces ploidyfrost_tpu/kmer/pallas_extract.py::_build.kernel, the
// Pallas TPU kernel behind the counter's fused extract + append step.
// For every k-window of every read it builds the forward 2-bit word and
// the reverse-complement word and writes canonical = min(fwd, rc) as an
// int64 key; a window holding any code >= 4 gets INT64_MAX, which sorts
// after every real key in the counter's sort-collapse. The number of
// valid windows is added into a device int64 in the same launch.
//
// Input  codes [B, L] uint8 (row-major, contiguous), 0 < k <= 31, L >= k.
// Output out[b * n + i] int64 for n = L - k + 1, written at the pointer
//        the caller passes (the counter's instance buffer at its fill,
//        8-byte aligned only); no other address is written.
//        *count += the number of keys that are not INT64_MAX.
//
// Bound: memory traffic. The function reads B*L bytes and writes B*n*8
// bytes: at B=16384, L=160, k=25 that is 2.6 MB in and 17.8 MB out,
// 20.4 MB a launch, 6.1 us at 3.35 TB/s. Its arithmetic is about ten
// integer operations a base once windows roll.
//
// Design, against that bound (times: H100 80GB HBM3 at 700 W, B=16384,
// L=160, k=25, median a launch with L2 scrubbed before each launch, from
// kmer/extract_bench.py and chip_smoke.py):
// - Tiles. A tile is a contiguous slab of input and a contiguous slab of
//   output: `rows` whole reads (rows*L bytes in, rows*n keys out), or,
//   for a read with more windows than one CTA covers, `seg` windows of
//   one read with its (k-1)-base overlap (seg+k-1 bytes in, seg keys
//   out). pf_extract_canonical fits a tile to one pass of the CTA's
//   kThreads threads; a second, mostly idle pass cost 10-20% in a sweep
//   of this kernel's first version. kThreads and kRun are compile-time
//   constants (PF_THREADS, PF_RUN; kmer/extract_bench.py builds variants
//   with -D), and at any k and L they keep a CTA's shared memory under
//   the default 48 KB (static_assert below), so no launch needs the
//   opt-in attribute.
// - Persistent grid. The grid is the SM count times the CTAs that fit on
//   an SM, and each CTA walks over tiles with a
//   stride of the grid size. While it computes tile t it has the input
//   of its next tile in flight: 16-byte cp.async copies into the other
//   half of a double buffer in shared memory. The unaligned head and
//   tail of a slab (at most 15 bytes each; rows start at r0*L, which is
//   16-byte aligned only when L is a multiple of 16) are read by single
//   lanes into registers one tile ahead, so no copy reads a byte outside
//   `codes`. At B=16384 the batch fits the card's resident CTAs in one
//   wave (the output staging bounds them), so a CTA has one tile; larger
//   batches walk several. PF_STAGES=1 builds the alternative, one tile a
//   CTA and grid = tiles, for kmer/extract_bench.py to time against: it
//   took 0.0157 ms against 0.0123 ms at B=16384, L=160 and 0.0409 ms
//   against 0.0344 ms at B=65536, L=160, and was faster only at L=250
//   (0.0191 ms against 0.0204 ms). At B=16384 both give each CTA one
//   tile, so that gain is the grid's shape, not the overlap.
// - Rolling windows. Each thread owns a run of kRun consecutive windows
//   of one row: it warms up over k-1 bases, then does O(1) work a
//   window: fwd = (fwd << 2) | b, and rc kept left-aligned,
//   rc = (rc >> 2) | ((b ^ 3) << 62), so every per-base shift is by a
//   constant (funnel shifts on the 64-bit pair); the mask and the
//   alignment shift of rc (64 - 2k) are applied once a window. Validity
//   is the position of the last code >= 4 seen: no k-long OR chain. A
//   thread reads its bases as a stream of 32-bit shared words, funnel-
//   shifted to its byte phase and fetched four bases ahead, so no load
//   sits on a step's dependency chain. The run length trades the warm-up
//   against the threads a tile keeps busy; kmer/extract_bench.py times
//   the variants (PERF.md): 128 threads and runs of 17 (8 threads a
//   160-base read, 16 reads a tile) are the defaults.
// - Full-width stores. The keys of a tile go to shared memory first, at
//   an index shifted by the parity of the tile's first output address,
//   so that 16-byte aligned global pairs sit at 16-byte aligned shared
//   pairs; one thread then hands the aligned middle to the copy engine
//   as one bulk copy (cp.async.bulk, shared to global), plus one 8-byte
//   store at an unaligned head or an odd tail.
// - The valid count. Each thread counts its valid windows; a warp sums
//   with __reduce_add_sync, the CTA in shared memory, and one 64-bit
//   atomicAdd per CTA adds into *count. The separate (keys != SENTINEL)
//   pass and the add that followed it are gone from the counter's path.
// Result: 0.0123 ms a launch, 49% of the bound; the previous kernel
// (byte-wise staging, a k-long loop a window) took 0.0485 ms in the
// same call. Under the same timing a one-element kernel takes 0.0050 ms
// and torch's fill of the same 17.8 MB output 0.0103 ms: a single cold
// launch pays about 5 us beside the bytes. Back to back in one CUDA
// graph, K1 takes 0.0086 ms a launch (71% of the bound).
// The TPU kernel's transposed [L, B] layout and (hi, lo) u32 split
// existed for Mosaic and the TPU's missing 64-bit integers; this card
// has native 64-bit integer ops, so neither is carried over.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

#ifndef PF_THREADS
#define PF_THREADS 128
#endif
#ifndef PF_RUN
#define PF_RUN 17
#endif
#ifndef PF_STAGES
#define PF_STAGES 2
#endif

constexpr int64_t kSentinel = INT64_MAX;
constexpr int kThreads = PF_THREADS;  // a CTA, a multiple of 32
constexpr int kRun = PF_RUN;          // windows a thread rolls over
constexpr int kTileWindows = kThreads * kRun;
// 2: a persistent grid, each CTA staging its next tile while it computes
// one; 1: one tile a CTA, grid = tiles, one input buffer (a measured
// alternative, kmer/extract_bench.py)
constexpr int kStages = PF_STAGES;
constexpr int kSlack = 16;  // bytes before and after a staged slab

constexpr int64_t in_cap_of(int64_t in_bytes) {
  return (kSlack + 15 + in_bytes + kSlack + 15) / 16 * 16;  // slack, 16-byte phase, slab, slack
}
// A tile's input is at most kThreads * (kRun + 30) bytes: rows * L for
// whole rows (rows <= kThreads / ceil(n / kRun), L <= n + 30), or
// seg + k - 1 for a segment. Its keys are at most kTileWindows, plus a
// parity slot.
constexpr int64_t kMaxSmem =
    kStages * in_cap_of(int64_t{kThreads} * (kRun + 30)) + (kTileWindows + 1) * 8 + 8;
static_assert(kThreads % 32 == 0 && kThreads <= 1024 && kRun >= 1 && (kStages == 1 || kStages == 2),
              "tile geometry");
static_assert(kMaxSmem + 32 * 8 <= 48 * 1024,
              "a CTA's shared memory must fit the default 48 KB at every k and L");

struct Tile {
  const uint8_t* src;  // first input byte
  int64_t len;         // input bytes: (rows - 1) * L + cnt + k - 1
  int64_t out0;        // index of the first output key
  int rows;            // rows in this tile (the last row tile is ragged)
  int cnt;             // windows of each row in this tile
};

__device__ __forceinline__ Tile tile_at(int64_t t, const uint8_t* codes, int64_t B, int L,
                                        int n, int k, int rows, int seg, int64_t segs) {
  const int64_t rt = segs == 1 ? t : t / segs;
  const int w0 = static_cast<int>(t - rt * segs) * seg;
  const int64_t r0 = rt * rows;
  Tile x;
  x.rows = static_cast<int>(min(static_cast<int64_t>(rows), B - r0));
  x.cnt = min(seg, n - w0);
  x.src = codes + r0 * L + w0;
  x.len = static_cast<int64_t>(x.rows - 1) * L + x.cnt + k - 1;
  x.out0 = r0 * n + w0;
  return x;
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Byte x of the slab goes to buf[kSlack + (src & 15) + x]: global 16-byte
// chunks land on 16-byte aligned shared addresses. The aligned middle is
// copied with cp.async; the edge bytes (at most 30) are loaded by warp 0,
// one per lane, into *edge_val, to be written at buf[*edge_off] later.
__device__ __forceinline__ void stage(const Tile& x, uint8_t* buf, uint32_t* edge_val,
                                      int* edge_off) {
  const uintptr_t g = reinterpret_cast<uintptr_t>(x.src);
  const uintptr_t e = g + static_cast<uintptr_t>(x.len);
  const int a = kSlack + static_cast<int>(g & 15);
  uintptr_t a0 = (g + 15) & ~static_cast<uintptr_t>(15);
  uintptr_t a1 = e & ~static_cast<uintptr_t>(15);
  if (a1 <= a0) a0 = a1 = e;  // no whole chunk: every byte is an edge byte
  const int64_t chunks = static_cast<int64_t>((a1 - a0) >> 4);
  const uint32_t s0 =
      static_cast<uint32_t>(__cvta_generic_to_shared(buf)) + a + static_cast<uint32_t>(a0 - g);
  const uint8_t* g0 = reinterpret_cast<const uint8_t*>(a0);
  for (int64_t c = threadIdx.x; c < chunks; c += kThreads)
    cp_async16(s0 + static_cast<uint32_t>(c * 16), g0 + c * 16);
  *edge_off = -1;
  if (threadIdx.x < 32) {
    const int head = static_cast<int>(a0 - g);
    const int tail = static_cast<int>(e - a1);
    const int j = threadIdx.x;
    uintptr_t p = 0;
    if (j < head)
      p = g + j;
    else if (j - head < tail)
      p = a1 + (j - head);
    if (p) {
      *edge_val = __ldg(reinterpret_cast<const uint8_t*>(p));
      *edge_off = a + static_cast<int>(p - g);
    }
  }
}

// One base (the low byte of c) into the rolling state at position p.
__device__ __forceinline__ void roll(uint32_t c, int p, uint64_t& fwd, uint64_t& rc, int& bad) {
  bad = (c & 0xfcu) ? p : bad;
  fwd = (fwd << 2) | (c & 3u);
  rc = (rc >> 2) | (static_cast<uint64_t>(~c & 3u) << 62);
}

// The key of the window starting at i, into o[i]; returns 1 if valid.
__device__ __forceinline__ unsigned emit(int64_t* o, int i, uint64_t fwd, uint64_t rc, int bad,
                                         uint64_t mask, int rshift) {
  const uint64_t f = fwd & mask;
  const uint64_t r = rc >> rshift;
  const bool ok = bad < i;
  o[i] = ok ? static_cast<int64_t>(f < r ? f : r) : kSentinel;
  return ok;
}

// The next four bytes of a thread's stream: the two words it holds,
// funnel-shifted by the stream's byte phase; the word after them is
// fetched now, four bases before it is needed.
__device__ __forceinline__ uint32_t next4(uint32_t& lo, uint32_t& hi, const uint32_t*& w,
                                          int sh) {
  const uint32_t v = __funnelshift_r(lo, hi, sh);
  lo = hi;
  hi = *w++;
  return v;
}

// Windows [g*kRun, g*kRun + kRun) of row r of tile x, from its staged codes
// s (row r at s + r*L), into sout[par + r*cnt + i]; returns this
// thread's number of valid windows. The warm-up starts up to 3 bases
// early so that it is whole words; those bases (the previous row's, or
// the slack before the slab) only shift out of the state.
__device__ __forceinline__ unsigned compute(const Tile& x, const uint8_t* s, int64_t* sout,
                                            int par, int L, int k, int r, int g, uint64_t mask,
                                            int rshift) {
  if (r >= x.rows) return 0;
  int i = g * kRun;
  const int i1 = min(x.cnt, i + kRun);
  if (i >= i1) return 0;
  const int pre = (4 - ((k - 1) & 3)) & 3;
  const uint8_t* q = s + r * L + i - pre;
  const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(q) & 3);
  const uint32_t* w = reinterpret_cast<const uint32_t*>(q - mis);
  uint32_t lo = w[0], hi = w[1];
  w += 2;
  const int sh = 8 * mis;
  uint64_t fwd = 0, rc = 0;
  int bad = -1;  // position of the last code >= 4 seen
#pragma unroll 1
  for (int p = i - pre; p < i + k - 1; p += 4) {
    const uint32_t v = next4(lo, hi, w, sh);
#pragma unroll
    for (int j = 0; j < 4; ++j) roll(v >> (8 * j), p + j, fwd, rc, bad);
  }
  int64_t* o = sout + par + r * x.cnt;
  unsigned valid = 0;
#pragma unroll 1
  for (; i + 4 <= i1; i += 4) {
    const uint32_t v = next4(lo, hi, w, sh);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      roll(v >> (8 * j), i + j + k - 1, fwd, rc, bad);
      valid += emit(o, i + j, fwd, rc, bad, mask, rshift);
    }
  }
  if (i < i1) {
    const uint32_t v = next4(lo, hi, w, sh);
    for (int j = 0; i < i1; ++i, ++j) {
      roll(v >> (8 * j), i + k - 1, fwd, rc, bad);
      valid += emit(o, i, fwd, rc, bad, mask, rshift);
    }
  }
  return valid;
}

// sout[par + j] -> dst[j] for j < nk, issued by thread 0: one bulk copy
// (TMA, shared to global) of the 16-byte aligned middle, one 8-byte
// store at an unaligned head or odd tail. The caller makes the shared
// writes visible to the copy engine first (fence_async_shared, barrier)
// and waits for the copy to have read sout before it writes sout again.
__device__ __forceinline__ void store(const int64_t* sout, int64_t* dst, int64_t nk, int par) {
  if (threadIdx.x != 0) return;
  if (par) dst[0] = sout[1];
  const int64_t pairs = (nk - par) >> 1;
  if (pairs) {
    const uint32_t src = static_cast<uint32_t>(__cvta_generic_to_shared(sout + 2 * par));
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst + par),
                 "r"(src), "r"(static_cast<uint32_t>(pairs * 16))
                 : "memory");
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  }
  if ((nk - par) & 1) dst[nk - 1] = sout[nk - 1 + par];
}

__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Thread 0 waits until every bulk copy it issued has read shared memory.
__device__ __forceinline__ void wait_store_read() {
  if (threadIdx.x == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

__global__ void __launch_bounds__(kThreads)
    extract_canonical_kernel(const uint8_t* __restrict__ codes, int64_t B, int L, int k, int rows,
                             int seg, int lanes, int64_t segs, int64_t tiles, int in_cap,
                             int64_t* __restrict__ out, unsigned long long* __restrict__ count) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ unsigned long long warp_sums[kThreads / 32];
  int64_t* sout = reinterpret_cast<int64_t*>(smem + kStages * in_cap);
  const int n = L - k + 1;
  const uint64_t mask = (1ull << (2 * k)) - 1;
  const int rshift = 64 - 2 * k;
  const int r = static_cast<int>(threadIdx.x) / lanes;  // this thread's row of a tile
  const int g = static_cast<int>(threadIdx.x) - r * lanes;  // and its run in that row
  int64_t t = blockIdx.x;
  if (t >= tiles) return;

  unsigned valid = 0;
  Tile cur = tile_at(t, codes, B, L, n, k, rows, seg, segs);
  uint32_t edge_cur = 0;
  int off_cur = -1;
  stage(cur, smem, &edge_cur, &off_cur);
  cp_async_commit();
  int b = 0;
  for (; t < tiles; t += gridDim.x) {
    const int64_t tn = t + gridDim.x;
    Tile nxt = cur;
    uint32_t edge_nxt = 0;
    int off_nxt = -1;
    if (kStages == 2 && tn < tiles) {
      nxt = tile_at(tn, codes, B, L, n, k, rows, seg, segs);
      stage(nxt, smem + (b ^ 1) * in_cap, &edge_nxt, &off_nxt);
    }
    cp_async_commit();  // one group per iteration, empty or not
    uint8_t* buf = smem + b * in_cap;
    if (off_cur >= 0) buf[off_cur] = static_cast<uint8_t>(edge_cur);
    cp_async_wait_prev();  // this tile's copies have landed
    wait_store_read();     // the last tile's keys have left sout
    __syncthreads();
    int64_t* dst = out + cur.out0;
    const int par = static_cast<int>((reinterpret_cast<uintptr_t>(dst) >> 3) & 1);
    valid += compute(cur, buf + kSlack + (reinterpret_cast<uintptr_t>(cur.src) & 15), sout, par,
                     L, k, r, g, mask, rshift);
    fence_async_shared();
    __syncthreads();
    store(sout, dst, static_cast<int64_t>(cur.rows) * cur.cnt, par);
    cur = nxt;
    edge_cur = edge_nxt;
    off_cur = off_nxt;
    b ^= 1;
  }

  wait_store_read();  // sout must outlive the copies that read it
  valid = __reduce_add_sync(0xffffffffu, valid);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = valid;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long sum = 0;
    for (int w = 0; w < kThreads / 32; ++w) sum += warp_sums[w];
    if (sum) atomicAdd(count, sum);
  }
}

}  // namespace

// Launch K1 on `stream`. Returns a cudaError_t, 0 on success.
extern "C" int pf_extract_canonical(const void* codes, int64_t B, int64_t L, int k, void* out,
                                    void* count, void* stream) {
  if (B <= 0) return 0;
  const int64_t n = L - k + 1;
  if (k < 1 || k > 31 || n < 1 || count == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  // A tile: as many whole rows as one pass of the CTA's threads covers, a
  // row taking ceil(n / kRun) threads; a longer row is cut into segments
  // of kTileWindows windows.
  const bool whole = n <= kTileWindows;
  const int64_t row_lanes = (n + kRun - 1) / kRun;
  const int seg = static_cast<int>(whole ? n : kTileWindows);
  const int rows = static_cast<int>(whole ? (B < kThreads / row_lanes ? B : kThreads / row_lanes) : 1);
  const int lanes = static_cast<int>(whole ? row_lanes : kThreads);
  const int64_t segs = (n + seg - 1) / seg;
  const int64_t tiles = (B + rows - 1) / rows * segs;
  const int64_t in_cap = in_cap_of(whole ? rows * L : seg + k - 1);
  const int64_t smem = kStages * in_cap + (static_cast<int64_t>(rows) * seg + 1) * 8 + 8;

  int64_t grid = tiles;
  if (kStages == 2) {
    // The resident CTAs of the last (device, shared memory) seen by this
    // thread, so a run of equal launches queries them once.
    thread_local int last_dev = -1;
    thread_local int64_t last_smem = 0, last_resident = 0;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev != last_dev || smem != last_smem) {
      int sms = 0, fit = 0;
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit, extract_canonical_kernel, kThreads,
                                                            static_cast<size_t>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
      if (fit < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
      last_dev = dev, last_smem = smem, last_resident = static_cast<int64_t>(sms) * fit;
    }
    if (grid > last_resident) grid = last_resident;
  }
  extract_canonical_kernel<<<static_cast<unsigned>(grid), kThreads, static_cast<size_t>(smem),
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(codes), B, static_cast<int>(L), k, rows, seg, lanes, segs, tiles,
      static_cast<int>(in_cap), static_cast<int64_t*>(out),
      static_cast<unsigned long long*>(count));
  return static_cast<int>(cudaGetLastError());
}

// Needleman-Wunsch flag wavefront: the three bit-packed direction flags of
// every cell of every pair of one chunk, one warp a pair, the whole
// anti-diagonal loop in one launch.
//
// Replaces: ploidyfrost_tpu/align/batch_nw.py:62-147 `_build_kernel` (its
// `kernel`, :78-145), the jitted lax.scan over the 2T + 1 anti-diagonals
// that the JAX package runs on the TPU as one device program. Its plain
// version is the torch loop align/batch_nw.py::_wavefront.
//
// What it computes, for a chunk of CH pairs in tier T (a, b: [CH, T]
// uint8 codes, pad 7, '-' 4; a_len: [CH] int32): out [CH, 3, 2T + 1, W8]
// uint8, W8 = (T + 9) / 8, where row (f, d) holds, little-endian
// bit-packed, flag f (0 Up, 1 LeftUp, 2 Left) of cell (i, d - i) for i in
// 0..T, and zero bits past T. This is exactly the plain version's result,
// every cell of the buffer included: the semantics of nw._nw_matrix
// (src/SeqAlign.cpp:480-549): the +1 continuation bonus from the flag of
// the cell each move comes from, the forbidden Left into a next-of-A '-'
// (I32MIN, except at i == a_len), the boundary row i = 0 and column
// j = 0, b read at clip(d - 1 - i, 0, T - 1), and integer arithmetic that
// wraps as torch's int32 does.
//
// Layout: lane l of a pair's warp computes the cells i = l, l + 32, ... of
// each diagonal. The scores of the diagonal being written and of the two
// before it, their flag rows as 32-bit words (one ballot a word: 32 cells,
// bit i % 32 for cell i), and the pair's codes sit in shared memory, about
// 12 (T + 1) + 2 T bytes a warp (31 KB at T = 2048): few warps a block at
// large tiers, and the kernel's dynamic shared-memory limit raised above
// 48 KB where a block needs it. __syncwarp between diagonals. The lanes
// then write the diagonal's three rows as bytes straight into the final
// layout (W8 is no multiple of 4 in general), so no permute follows.
//
// What bounds it: the chain of 2T + 1 dependent diagonals of each pair,
// each a few shared-memory round trips and three ballots a 32-cell chunk.
// The output, 3 (2T + 1) W8 bytes a pair, is written once; the pairs of a
// chunk run side by side, one warp each.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int DASH = 4;
constexpr int PAD = 7;
constexpr int MAX_TIER = 2048;
constexpr int MAX_WARPS = 8;          // warps a block at most
constexpr int BLOCK_SHARED = 96 << 10;  // bytes of shared memory a block aims under
constexpr unsigned FULL = 0xffffffffu;

__host__ __device__ __forceinline__ int words_of(int T) { return (T + 9 + 31) / 32; }

__host__ __device__ __forceinline__ int round4(int x) { return (x + 3) & ~3; }

// bytes of shared memory a warp: three score rows, three diagonals' three
// flag rows of words, a with a pad at each end, b
__host__ __device__ __forceinline__ int warp_bytes(int T) {
  const int nc = words_of(T);
  return 3 * 32 * nc * 4 + 9 * nc * 4 + round4(T + 2) + round4(T);
}

// a + b with int32 wrap-around
__device__ __forceinline__ int wadd(int a, int b) { return (int)((unsigned)a + (unsigned)b); }

__device__ __forceinline__ int bit(const unsigned* words, int i) {
  return (words[i >> 5] >> (i & 31)) & 1;
}

__global__ void nw_kernel(const uint8_t* __restrict__ a, const uint8_t* __restrict__ b,
                          const int* __restrict__ a_len, int CH, int T, int match, int dis,
                          int gap, int wpb, uint8_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int pair = blockIdx.x * wpb + warp;
  if (pair >= CH) return;  // the whole warp: no block-wide barrier follows
  const int nc = words_of(T), cells = 32 * nc, W8 = (T + 9) / 8, D = 2 * T + 1;
  unsigned char* base = smem + (size_t)warp * warp_bytes(T);
  int* sc = (int*)base;                        // [3][cells] scores
  unsigned* fl = (unsigned*)(sc + 3 * cells);  // [3 diagonals][3 flags][nc] words
  uint8_t* ax = (uint8_t*)(fl + 9 * nc);       // [T + 2]: ax[i] = A[i - 1], pads at 0 and T + 1
  uint8_t* bx = ax + round4(T + 2);            // [T]
  const uint8_t* ap = a + (size_t)pair * T;
  const uint8_t* bp = b + (size_t)pair * T;
  for (int k = lane; k < T + 2; k += 32) ax[k] = (k == 0 || k == T + 1) ? PAD : ap[k - 1];
  for (int k = lane; k < T; k += 32) bx[k] = bp[k];
  for (int k = lane; k < 3 * cells; k += 32) sc[k] = 0;
  for (int k = lane; k < 9 * nc; k += 32) fl[k] = 0;
  __syncwarp();
  const int alen = a_len[pair];
  uint8_t* o = out + (size_t)pair * 3 * D * W8;
  for (int d = 0; d < D; ++d) {
    const int cur = d % 3, p1 = (d + 2) % 3, p2 = (d + 1) % 3;
    int* s0 = sc + cur * cells;
    const int* s1 = sc + p1 * cells;
    const int* s2 = sc + p2 * cells;
    unsigned* f0 = fl + cur * 3 * nc;
    const unsigned* f1 = fl + p1 * 3 * nc;
    const unsigned* f2 = fl + p2 * 3 * nc;
    for (int c = 0; c < nc; ++c) {
      const int i = c * 32 + lane;
      bool u = false, l = false, f = false;
      if (i <= T) {
        const int ach = ax[i];
        const int bch = bx[min(max(d - 1 - i, 0), T - 1)];
        const int sub = ach == bch ? match : (ach == DASH || bch == DASH) ? gap : dis;
        // a set flag of the cell a move comes from is the +1 bonus; at
        // i = 0 the shifted rows read 0
        const int up = i ? wadd(wadd(s1[i - 1], bit(f1, i - 1)), gap) : gap;
        const int lu = i ? wadd(wadd(s2[i - 1], bit(f2 + nc, i - 1)), sub) : sub;
        int left = wadd(wadd(s1[i], bit(f1 + 2 * nc, i)), gap);
        const int up_lu = max(up, lu);
        int mx = max(up_lu, left);
        if (mx == left && i != alen && ax[i + 1] == DASH) {
          left = INT_MIN;
          mx = up_lu;
        }
        u = up == mx;
        l = lu == mx;
        f = left == mx;
        int s = mx;
        if (i == 0) {  // cell (0, d)
          s = (int)((unsigned)gap * (unsigned)d);
          u = l = false;
          f = d > 0;
        } else if (i == d) {  // cell (d, 0), 0 < d <= T
          s = (int)((unsigned)gap * (unsigned)d);
          u = true;
          l = f = false;
        }
        s0[i] = s;
      }
      const unsigned wu = __ballot_sync(FULL, u), wl = __ballot_sync(FULL, l),
                     wf = __ballot_sync(FULL, f);
      if (lane == 0) {
        f0[c] = wu;
        f0[nc + c] = wl;
        f0[2 * nc + c] = wf;
      }
    }
    __syncwarp();
    for (int k = lane; k < 3 * W8; k += 32) {
      const int fi = k / W8, byte = k - fi * W8;
      o[((size_t)fi * D + d) * W8 + byte] = (uint8_t)(f0[fi * nc + (byte >> 2)] >> (8 * (byte & 3)));
    }
  }
}

int warps_per_block(int T) {
  int w = BLOCK_SHARED / warp_bytes(T);
  return w < 1 ? 1 : w > MAX_WARPS ? MAX_WARPS : w;
}

}  // namespace

// The flags of one chunk: a, b [CH, T] uint8, a_len [CH] int32, out
// [CH, 3, 2T + 1, (T + 9) / 8] uint8, on the current device, on `stream`.
// Returns a CUDA error code.
extern "C" int pf_nw_wavefront(const uint8_t* a, const uint8_t* b, const int* a_len, int CH, int T,
                               int match, int dis, int gap, uint8_t* out, void* stream) {
  if (CH < 0 || T < 1 || T > MAX_TIER) return (int)cudaErrorInvalidValue;
  if (CH == 0) return 0;
  const int wpb = warps_per_block(T);
  const size_t smem = (size_t)wpb * warp_bytes(T);
  if (smem > (48 << 10)) {
    const cudaError_t e =
        cudaFuncSetAttribute(nw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  nw_kernel<<<(CH + wpb - 1) / wpb, 32 * wpb, smem, (cudaStream_t)stream>>>(
      a, b, a_len, CH, T, match, dis, gap, wpb, out);
  return (int)cudaGetLastError();
}

// The compiled kernel at tier T, into out[5]: registers a thread, local
// memory bytes a thread, shared memory bytes a block, warps (pairs) a
// block, resident blocks a multiprocessor. Returns a CUDA error code.
extern "C" int pf_nw_wavefront_attrs(int T, int* out) {
  if (T < 1 || T > MAX_TIER) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, nw_kernel);
  if (e != cudaSuccess) return (int)e;
  const int wpb = warps_per_block(T);
  const size_t smem = (size_t)wpb * warp_bytes(T);
  if (smem > (48 << 10)) {
    e = cudaFuncSetAttribute(nw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, nw_kernel, 32 * wpb, smem);
  if (e != cudaSuccess) return (int)e;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)smem;
  out[3] = wpb;
  out[4] = per_sm;
  return 0;
}

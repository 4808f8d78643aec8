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
// What bounds it: the chain of 2T + 1 dependent diagonals of each pair.
// The output, 3 (2T + 1) W8 bytes a pair, is written once; the pairs of a
// chunk run side by side, one warp each.
//
// Register path (T + 1 <= 32 * 17, tiers 16..512). Lane l owns the
// contiguous cells i = l k .. l k + k - 1, k = ceil((T + 1) / 32) (a
// template parameter: 1, 2, 3, 5, 9, 17 for the tiers, the next of them
// for any other T). It keeps in registers, for each of its cells, the
// score of diagonal d - 1 plus each of its three flag bits (the +1 bonus
// a move out of the cell adds, folded in once when the cell is written)
// and the score of d - 2 plus its LeftUp bit, its a codes, the masks of
// cells whose A code is '-' and whose Left move may be forbidden, and the
// b codes of its cells: b's index d - 1 - i moves one cell down the run a
// diagonal, so the codes shift through the registers and one new code
// enters at i = 0 (lane 0 reads it a diagonal ahead). The only values a
// diagonal takes from another lane are cell i - 1's Up value on d - 1,
// its LeftUp value on d - 2 and its b code: three __shfl_up_sync from lane
// l - 1. Each cell's three flags go as one byte into a shared staging
// buffer of STAGE diagonals (8 W8 cells a row, so the rows run on without
// a gap), off the dependent chain; every STAGE diagonals the warp packs
// the bits (8 cells into a byte by a multiply) and writes each flag's
// STAGE contiguous rows with 4-byte stores, neighbouring lanes on
// neighbouring words.
//
// Shared-memory path (tiers 1024 and 2048): lane l computes the cells
// i = l, l + 32, ... of each diagonal; the scores of three diagonals, their
// flag rows as 32-bit words (a ballot a 32-cell chunk) and the pair's
// codes sit in shared memory, about 12 (T + 1) + 2 T bytes a warp (31 KB
// at T = 2048), the kernel's dynamic shared-memory limit raised above 48 KB
// where a block needs it; the lanes write a diagonal's three rows as bytes.
//
// Both paths run as many warps a block as keep the blocks of a chunk
// within what the card holds at once, one where they fit, so that a
// chunk's pairs spread over every multiprocessor.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int DASH = 4;
constexpr int PAD = 7;
constexpr int MAX_TIER = 2048;
constexpr int MAX_WARPS = 8;  // warps a block at most
constexpr int STAGE = 16;     // diagonals staged in shared memory before a store
constexpr unsigned FULL = 0xffffffffu;

__host__ __device__ __forceinline__ int words_of(int T) { return (T + 9 + 31) / 32; }

__host__ __device__ __forceinline__ int round4(int x) { return (x + 3) & ~3; }

// cells of a lane on the register path at tier T: the template's k, or 0
// for the shared-memory path
__host__ __device__ __forceinline__ int k_of(int T) {
  const int need = (T + 1 + 31) / 32;
  const int ks[] = {1, 2, 3, 5, 9, 17};
  for (int k : ks)
    if (need <= k) return k;
  return 0;
}

// bytes of shared memory a warp on the shared-memory path: three score
// rows, three diagonals' three flag rows of words, a with a pad at each
// end, b
__host__ __device__ __forceinline__ int warp_bytes(int T) {
  const int nc = words_of(T);
  return 3 * 32 * nc * 4 + 9 * nc * 4 + round4(T + 2) + round4(T);
}

// bytes of shared memory a warp at tier T, either path
__host__ __device__ __forceinline__ int warp_shared(int T) {
  const int k = k_of(T);
  return k ? STAGE * 8 * ((T + 9) / 8) : warp_bytes(T);
}

// a + b with int32 wrap-around
__device__ __forceinline__ int wadd(int a, int b) { return (int)((unsigned)a + (unsigned)b); }

__device__ __forceinline__ int bit(const unsigned* words, int i) {
  return (words[i >> 5] >> (i & 31)) & 1;
}

// byte e of flag f's staged rows: bit f of the staged bytes of cells
// 8e .. 8e + 7 (a row is 8 W8 cells, so the rows run on without a gap),
// gathered 4 at a time by a multiply that moves bit 8t to bit 28 + t
__device__ __forceinline__ unsigned flag_byte(const uint8_t* st, int e, int f) {
  const uint2 c = *(const uint2*)(st + 8 * e);
  const unsigned lo = (c.x >> f) & 0x01010101u, hi = (c.y >> f) & 0x01010101u;
  return ((lo * 0x10204080u) >> 28) | (((hi * 0x10204080u) >> 28) << 4);
}

// The nd staged diagonals d0 .. d0 + nd - 1 of one pair into its output
// o [3, D, W8]: for each flag the nd rows are nd W8 contiguous bytes; the
// lanes write them as 4-byte words, bytes at an unaligned head and tail.
__device__ void flush(const uint8_t* st, int nd, int W8, int D, int d0, uint8_t* o, int lane) {
  const int N = nd * W8;
  for (int f = 0; f < 3; ++f) {
    uint8_t* g = o + ((size_t)f * D + d0) * W8;
    int head = (int)((4 - ((uintptr_t)g & 3)) & 3);
    if (head > N) head = N;
    const int words = (N - head) >> 2, tail = head + 4 * words;
    if (lane < head) g[lane] = (uint8_t)flag_byte(st, lane, f);
    for (int w = lane; w < words; w += 32) {
      const int e = head + 4 * w;
      *(unsigned*)(g + e) = flag_byte(st, e, f) | flag_byte(st, e + 1, f) << 8 |
                            flag_byte(st, e + 2, f) << 16 | flag_byte(st, e + 3, f) << 24;
    }
    if (tail + lane < N) g[tail + lane] = (uint8_t)flag_byte(st, tail + lane, f);
  }
}

template <int K>
__global__ void __launch_bounds__(32 * MAX_WARPS)
    nw_regs(const uint8_t* __restrict__ a, const uint8_t* __restrict__ b,
            const int* __restrict__ a_len, int CH, int T, int match, int dis, int gap, int wpb,
            uint8_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int pair = blockIdx.x * wpb + warp;
  if (pair >= CH) return;  // the whole warp: no block-wide barrier follows
  const int W8 = (T + 9) / 8, D = 2 * T + 1, C = 8 * W8;
  uint8_t* st = smem + (size_t)warp * STAGE * C;  // [STAGE][C] a cell's flags, bit f for flag f
  const uint8_t* ap = a + (size_t)pair * T;
  const uint8_t* bp = b + (size_t)pair * T;
  const int alen = a_len[pair], i0 = lane * K;
  // a cell's score plus the flag bit a move out of it adds: pU, pL, pF of
  // diagonal d - 1 (Up, LeftUp, Left), qL the LeftUp one of d - 2
  int ac[K], bc[K], pU[K], pL[K], pF[K], qL[K];
  // bit t of forbid: cell i0 + t is not a_len and A[i0 + t] is '-'; of
  // adash: A[i0 + t - 1] is '-'
  unsigned forbid = 0, adash = 0;
  const int b0 = bp[0];
#pragma unroll
  for (int t = 0; t < K; ++t) {
    const int i = i0 + t;
    ac[t] = i >= 1 && i <= T ? ap[i - 1] : PAD;
    if (ac[t] == DASH) adash |= 1u << t;
    if (i < T && i != alen && ap[i] == DASH) forbid |= 1u << t;
    bc[t] = b0;  // clip(d - 1 - i, 0, T - 1) is 0 for d <= 0
    pU[t] = pL[t] = pF[t] = qL[t] = 0;
  }
  for (int q = lane; q < STAGE * C; q += 32) st[q] = 0;  // cells past T stay 0
  __syncwarp();
  int b_next = b0;  // lane 0: b[clip(d - 1, 0, T - 1)] for the next diagonal d
  uint8_t* o = out + (size_t)pair * 3 * D * W8;
  for (int d0 = 0; d0 < D; d0 += STAGE) {
    const int nd = min(STAGE, D - d0);
    for (int dd = 0; dd < nd; ++dd) {
      const int d = d0 + dd;
      // cell i0 - 1 of lane l - 1 on d - 1 and d - 2, and its b code of d - 1
      const int up_in = __shfl_up_sync(FULL, pU[K - 1], 1);
      const int lu_in = __shfl_up_sync(FULL, qL[K - 1], 1);
      int b_in = __shfl_up_sync(FULL, bc[K - 1], 1);
      if (lane == 0) {
        b_in = b_next;
        b_next = bp[min(d, T - 1)];  // the code cell 0 reads on d + 1, fetched a diagonal ahead
      }
#pragma unroll
      for (int t = K - 1; t > 0; --t) bc[t] = bc[t - 1];
      bc[0] = b_in;
      const int bound = (int)((unsigned)gap * (unsigned)d), td = d - i0;
      uint8_t* row = st + dd * C;
      int nU[K], nL[K], nF[K];
#pragma unroll
      for (int t = 0; t < K; ++t) {
        const int i = i0 + t;
        const int bch = bc[t];
        const int sub = ac[t] == bch ? match
                        : (((adash >> t) & 1) || bch == DASH) ? gap
                                                              : dis;
        // a set flag of the cell a move comes from is the +1 bonus; cell
        // i = 0 (lane 0, t = 0) has no cell above it
        const int up = wadd(t ? pU[t - 1] : up_in, gap);
        const int lu = wadd(t ? qL[t - 1] : lu_in, sub);
        int left = wadd(pF[t], gap);
        const int up_lu = max(up, lu);
        int mx = max(up_lu, left);
        if (mx == left && ((forbid >> t) & 1)) {
          left = INT_MIN;
          mx = up_lu;
        }
        const bool j0 = t == td;  // cell (d, 0), 0 < d
        int s = j0 ? bound : mx;
        unsigned u = j0 || up == mx, l = !j0 && lu == mx, f = !j0 && left == mx;
        if (t == 0 && lane == 0) {  // cell (0, d)
          s = bound;
          u = l = 0;
          f = d > 0;
        }
        nU[t] = wadd(s, u);
        nL[t] = wadd(s, l);
        nF[t] = wadd(s, f);
        if (i <= T) row[i] = (uint8_t)(u | l << 1 | f << 2);
      }
#pragma unroll
      for (int t = 0; t < K; ++t) {
        qL[t] = pL[t];
        pU[t] = nU[t];
        pL[t] = nL[t];
        pF[t] = nF[t];
      }
    }
    __syncwarp();
    flush(st, nd, W8, D, d0, o, lane);
    __syncwarp();
  }
}

__global__ void __launch_bounds__(32 * MAX_WARPS)
    nw_shared(const uint8_t* __restrict__ a, const uint8_t* __restrict__ b,
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

using Kernel = void (*)(const uint8_t*, const uint8_t*, const int*, int, int, int, int, int, int,
                        uint8_t*);

Kernel kernel_of(int T) {
  switch (k_of(T)) {
    case 1: return nw_regs<1>;
    case 2: return nw_regs<2>;
    case 3: return nw_regs<3>;
    case 5: return nw_regs<5>;
    case 9: return nw_regs<9>;
    case 17: return nw_regs<17>;
    default: return nw_shared;
  }
}

struct Launch {
  Kernel kernel;
  int wpb, blocks, per_sm, sms;
  size_t smem;
};

// The launch of a chunk of CH pairs at tier T: one warp a block while the
// blocks fit on the card at once, else as few more warps a block as make
// them fit (at most MAX_WARPS), so that the pairs spread over every
// multiprocessor; the kernel's shared-memory limit raised where a block
// needs more than 48 KB.
cudaError_t plan(int CH, int T, Launch* L) {
  static int sms = 0;
  cudaError_t e;
  if (!sms) {
    int dev;
    e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
  }
  L->kernel = kernel_of(T);
  L->sms = sms;
  for (L->wpb = 1;; L->wpb *= 2) {
    L->smem = (size_t)L->wpb * warp_shared(T);
    if (L->smem > (48 << 10)) {
      e = cudaFuncSetAttribute(L->kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)L->smem);
      if (e != cudaSuccess) return e;
    }
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&L->per_sm, L->kernel, 32 * L->wpb,
                                                      L->smem);
    if (e != cudaSuccess) return e;
    if (L->per_sm < 1) return cudaErrorInvalidConfiguration;
    L->blocks = (CH + L->wpb - 1) / L->wpb;
    if (L->blocks <= L->per_sm * sms || L->wpb == MAX_WARPS) return cudaSuccess;
  }
}

}  // namespace

// The flags of one chunk: a, b [CH, T] uint8, a_len [CH] int32, out
// [CH, 3, 2T + 1, (T + 9) / 8] uint8, on the current device, on `stream`.
// Returns a CUDA error code.
extern "C" int pf_nw_wavefront(const uint8_t* a, const uint8_t* b, const int* a_len, int CH, int T,
                               int match, int dis, int gap, uint8_t* out, void* stream) {
  if (CH < 0 || T < 1 || T > MAX_TIER) return (int)cudaErrorInvalidValue;
  if (CH == 0) return 0;
  Launch L;
  const cudaError_t e = plan(CH, T, &L);
  if (e != cudaSuccess) return (int)e;
  L.kernel<<<L.blocks, 32 * L.wpb, L.smem, (cudaStream_t)stream>>>(a, b, a_len, CH, T, match, dis,
                                                                   gap, L.wpb, out);
  return (int)cudaGetLastError();
}

// The compiled kernel of tier T for a chunk of CH pairs, into out[8]:
// registers a thread, local memory bytes a thread, shared memory bytes a
// block, warps (pairs) a block, resident blocks a multiprocessor, blocks
// of the launch, multiprocessors the launch uses, cells a lane (0 on the
// shared-memory path). Returns a CUDA error code.
extern "C" int pf_nw_wavefront_attrs(int T, int CH, int* out) {
  if (CH < 1 || T < 1 || T > MAX_TIER) return (int)cudaErrorInvalidValue;
  Launch L;
  cudaError_t e = plan(CH, T, &L);
  if (e != cudaSuccess) return (int)e;
  cudaFuncAttributes a;
  e = cudaFuncGetAttributes(&a, L.kernel);
  if (e != cudaSuccess) return (int)e;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)L.smem;
  out[3] = L.wpb;
  out[4] = L.per_sm;
  out[5] = L.blocks;
  out[6] = L.blocks < L.sms ? L.blocks : L.sms;
  out[7] = k_of(T);
  return 0;
}

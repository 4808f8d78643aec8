// GMM-EM: the whole emIterate loop of one fit (src/GmmModel.cpp:379-394)
// in one cooperative launch.
//
// Replaces: ploidyfrost_tpu/model/gmm.py:61-85 `_em_iterate`, the jitted
// lax.while_loop around `_em_body` (:99-125) and `_ll_body` (:88-96) that
// the JAX package runs on the TPU as one device program. Its plain version
// is the torch loop model/gmm.py::em_iterate_plain.
//
// What it computes, for the [n] float64 allele frequencies af and g
// components with frozen means: ll0 = ll(v, w), then while (delta >
// max_delta && count < max_iter) { (v, w) = em_body(v, w); ll2 = ll(v, w);
// delta = ll2 - ll; ll = ll2; ++count }, with the reference's quirks: zero
// densities, zero row sums and zero new variances clamped to DBL_MIN, the
// interior-max rejection guard with exact compares, the signed delta test.
// Result: variances, weights, ll and count in one [2g + 2] buffer, so a fit
// costs one launch and one readback.
//
// One pass an iteration. The densities of ll(v_k, w_k) are those of the
// next em_body(v_k, w_k), so one pass over af at (v_k, w_k) gives the ll
// sum (from the unclamped row sums) and the 2g sums of the update (from
// the parts clamped to DBL_MIN). Pass p decides: ll_p is known, delta =
// ll_p - ll_{p-1} and count = p; on stop the result is (v_p, w_p, ll_p, p),
// else the update of pass p's sums gives (v_{p+1}, w_{p+1}). count + 1
// passes where the plain version makes 2 count + 1.
//
// What bounds it: latency. A fit at bench5m's size moves about 80 KB and
// does about a million fp64 operations a pass, well under a microsecond of
// the card's rates; a pass costs the chain of one (point, component): an
// L2 read, one exp, a few shuffles, one divide and a log, then a block
// reduction, a grid barrier and the read of every block's row.
// pf_gmm_floor_probe measures the chain and the reductions apart from this
// kernel, pf_gmm_barrier_probe the barrier: together a latency floor.
//
// Layout. A lane holds one (point, component) pair: components sit in a
// segment of W lanes, W = g rounded up to a power of two (at most 32), and
// a warp holds 32 / W points side by side. A lane computes its own density
// (one exp), gets its point's row sum s and clamped row sum rs by a
// butterfly of xor shuffles over its segment (every lane of the segment
// gets the same bits), forms its responsibility with one divide and keeps
// three running sums: its component's gauss and var sums and, on the
// segment's first lane, the point's log row sum. Lanes past g add 0. For
// g > 32 (W = 32) the components run in chunks of 32; a lane sums the
// densities of components lane, lane + 32, ... in order before the
// butterfly, and keeps the sums of its chunk's component, so each chunk
// recomputes the densities.
//
// The grid: THREADS threads a block, one block a multiprocessor at most
// (every block reads every other block's row after the barrier, so more
// blocks cost more L2 reads than they save), fewer where n W lanes need
// fewer; co-resident by the cooperative launch. One grid barrier an
// iteration: each block writes its row of 2g + 1 sums into scratch rows
// double-buffered by the pass's parity (a block a pass ahead cannot
// overwrite a row that a slow block still reads), the barrier, then every
// block sums all rows in the same fixed order and runs the same update, so
// every block holds bit-identical parameters and decides stop or continue
// on its own. The update is spread over the block: warp 0 reduces the
// total and the NaN-propagating max and min by a butterfly, then a thread
// a component writes its weight, variance, 1 / sqrt(2 pi v) and 2 v. The
// parameters and sums live in shared memory (6g + 1 doubles, up to what a
// block may opt in to); past that, in a region of the workspace of the
// block's own. No floating-point atomics: the same inputs on the same card
// give the same bits.
//
// The barrier is a counter and a generation word at the head of the
// workspace, zeroed once when the workspace is made: a block reads the
// generation when it starts, the last block to arrive at a barrier sets
// the counter back to 0 before it advances the generation, so the words
// are ready for the next launch and a fit is one kernel on the stream.
//
// Rounding: every product, quotient and sum is an explicit _rn intrinsic,
// so nvcc contracts nothing into an FMA, and the density is formed in the
// plain version's order, 1 / sqrt((2 pi) v) * exp(-(d d) / (2 v)). The
// max and min of the guard propagate NaN, as torch.max and jnp.max do.
//
// pf_gmm_em_pass (one pass, the summed sums out) and pf_gmm_em_update
// (the update of summed sums, one block) are the same device code for the
// sharded fit, whose sums are all_reduced between them.

#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int RED = 2 * 32 + 1;  // a warp's sums of one chunk: ll, 32 gauss, 32 var
constexpr unsigned FULL = 0xffffffffu;
constexpr double TWO_PI = 2.0 * 3.14159265358979323846;
constexpr int HEAD = 2;  // workspace doubles before the scratch rows: the barrier words
constexpr int ILP = 2;   // points a lane works on at once
constexpr int GROUP = 16;  // lanes that sum one of the rows' columns

enum Mode { LOOP = 0, PASS = 1 };
enum Probe { CHAIN = 0, REDUCE = 1 };

struct Fit {
  const double* af;
  long long n;
  const double* means;
  const double* w0;  // the fit's first weights and variances (not written)
  const double* v0;
  int g;
  int max_iter;
  double m_thre, n_thre, max_delta;
  // barrier [HEAD], scratch [2][blocks][2g + 1], then, if not in shared
  // memory, the blocks' own state [blocks][6g + 1]
  double* work;
  double* out;   // LOOP: v [g], w [g], ll, count; PASS: sums [2g + 1]
  int mode;
};

// lanes a point: g rounded up to a power of two, at most 32
__host__ __device__ __forceinline__ int width_of(int g) {
  int w = 1;
  while (w < g && w < 32) w <<= 1;
  return w;
}

// doubles of a block's state: w, v, 1 / sqrt(2 pi v), 2 v [g each], sums [2g + 1]
__host__ __device__ __forceinline__ size_t state_doubles(int g) { return 6 * (size_t)g + 1; }

__host__ __device__ __forceinline__ size_t scratch_doubles(int blocks, int g) {
  return 2 * (size_t)blocks * (2 * g + 1);
}

__device__ __forceinline__ double nan_max(double a, double b) {
  return a != a ? a : (b != b || b > a) ? b : a;
}

__device__ __forceinline__ double nan_min(double a, double b) {
  return a != a ? a : (b != b || b < a) ? b : a;
}

__device__ __forceinline__ double coef_of(double v) {
  return __ddiv_rn(1.0, __dsqrt_rn(__dmul_rn(TWO_PI, v)));
}

// w * N(x; mean, v) with coef = 1 / sqrt(2 pi v) and den = 2 v
__device__ __forceinline__ double weighted(double x, double mean, double w, double coef,
                                          double den) {
  const double d = __dsub_rn(x, mean);
  return __dmul_rn(w, __dmul_rn(coef, exp(__ddiv_rn(-__dmul_rn(d, d), den))));
}

// the sum over the W-lane segment, the same bits in every lane of it
__device__ __forceinline__ double segment_sum(double v, int W) {
  for (int off = 1; off < W; off <<= 1) v = __dadd_rn(v, __shfl_xor_sync(FULL, v, off));
  return v;
}

// lane l < W: the sum of lanes l, l + W, l + 2W, ... as a shuffle-down tree
__device__ __forceinline__ double slots_sum(double v, int W) {
  for (int off = 16; off >= W; off >>= 1) v = __dadd_rn(v, __shfl_down_sync(FULL, v, off));
  return v;
}

// A block's parameters and summed sums: in shared memory, or in the
// block's own region of the workspace for a g too large for it.
struct State {
  double *w, *v, *coef, *den, *sums;
  __device__ explicit State(double* base, int g)
      : w(base), v(base + g), coef(base + 2 * g), den(base + 3 * g), sums(base + 4 * g) {}
};

// One chunk's sums of a block into row [2g + 1] (ll only for chunk 0):
// each warp's lanes l, l + W, ... summed by slots_sum into lane l < W,
// then the warps in turn. red: shared [WARPS * RED].
__device__ void block_row(double ll, double gs, double vs, int k, int W, int g, double* row,
                          double* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  ll = slots_sum(ll, W);
  gs = slots_sum(gs, W);
  vs = slots_sum(vs, W);
  double* r = red + warp * RED;
  if (lane == 0) r[0] = ll;
  if (lane < W) {
    r[1 + lane] = gs;
    r[1 + 32 + lane] = vs;
  }
  __syncthreads();
  const int t = threadIdx.x;
  if (t < 2 * W + 1) {
    const int slot = t == 0 ? 0 : t <= W ? t : 32 + t - W;
    double s = 0.0;
    for (int w = 0; w < WARPS; ++w) s = __dadd_rn(s, red[w * RED + slot]);
    if (t == 0) {
      if (k == 0) row[0] = s;
    } else if (t <= W) {
      if (k * W + t - 1 < g) row[1 + k * W + t - 1] = s;
    } else if (k * W + t - 1 - W < g) {
      row[1 + g + k * W + t - 1 - W] = s;
    }
  }
  __syncthreads();
}

// One block's sums over its points into row [2g + 1]. Warp q of block b
// takes the points (b WARPS + q) P + slot, then a grid's stride further,
// P = 32 / W points a warp, one a W-lane segment. WIDE (g > 32): the
// components in chunks of 32, every density of a point recomputed a chunk.
template <bool WIDE>
__device__ void block_pass(const Fit& F, const State& S, double* row, double* red) {
  const int g = F.g, W = width_of(g), lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int j = lane & (W - 1), slot = lane / W, per_warp = 32 / W;
  const int chunks = (g + W - 1) / W;
  const long long stride = (long long)gridDim.x * WARPS * per_warp;
  for (int k = 0; k < chunks; ++k) {
    const int c = k * W + j;
    const bool mine = c < g;
    double mc = 0.0, wc = 0.0, cc = 0.0, dc = 1.0;
    if (mine) {
      mc = __ldg(F.means + c);
      if (!WIDE) {
        wc = S.w[c];
        cc = S.coef[c];
        dc = S.den[c];
      }
    }
    double ll = 0.0, gs = 0.0, vs = 0.0;
    // ILP points of a lane at a time, a grid's stride apart: their chains
    // overlap, their sums are added in the lane's order of points
    for (long long base = ((long long)blockIdx.x * WARPS + warp) * per_warp; base < F.n;
         base += ILP * stride) {
      double x[ILP], s[ILP], rs[ILP], part[ILP];
      bool has[ILP], live[ILP];  // live: the warp has a point there (the same in every lane)
#pragma unroll
      for (int u = 0; u < ILP; ++u) {
        const long long i = base + u * stride + slot;
        live[u] = base + u * stride < F.n;
        has[u] = i < F.n;
        x[u] = has[u] ? __ldg(F.af + i) : 0.0;
      }
#pragma unroll
      for (int u = 0; u < ILP; ++u) {
        s[u] = rs[u] = part[u] = 0.0;
        if (!live[u]) continue;
        if (WIDE) {
          for (int m = 0; m < chunks; ++m) {
            const int cm = m * W + j;
            if (cm < g) {
              const double wp =
                  weighted(x[u], __ldg(F.means + cm), S.w[cm], S.coef[cm], S.den[cm]);
              const double p = wp == 0.0 ? DBL_MIN : wp;
              s[u] = __dadd_rn(s[u], wp);
              rs[u] = __dadd_rn(rs[u], p);
              if (m == k) part[u] = p;
            }
          }
        } else if (mine) {
          s[u] = weighted(x[u], mc, wc, cc, dc);
          part[u] = rs[u] = s[u] == 0.0 ? DBL_MIN : s[u];
        }
      }
#pragma unroll
      for (int u = 0; u < ILP; ++u) {
        if (!live[u]) continue;
        s[u] = segment_sum(s[u], W);
        rs[u] = segment_sum(rs[u], W);
      }
#pragma unroll
      for (int u = 0; u < ILP; ++u) {
        if (has[u] && mine) {
          const double d = __dsub_rn(x[u], mc);
          const double r = __ddiv_rn(part[u], rs[u]);
          gs = __dadd_rn(gs, r);
          vs = __dadd_rn(vs, __dmul_rn(__dmul_rn(r, d), d));
        }
        if (k == 0 && has[u] && j == 0) ll = __dadd_rn(ll, log(s[u] == 0.0 ? DBL_MIN : s[u]));
      }
    }
    block_row(ll, gs, vs, k, W, g, row, red);
  }
}

// The rows of `blocks` blocks summed in block order into dst [ns]: the
// block's groups of GROUP lanes take the columns k = group, group +
// THREADS / GROUP, ..., lane l of a group the rows l, l + GROUP, ... (L2
// reads), then a shuffle-down tree over the group.
__device__ void rows_sum(const double* rows, int blocks, int ns, double* dst) {
  const int lane = threadIdx.x & (GROUP - 1), group = threadIdx.x / GROUP;
  for (int k0 = 0; k0 < ns; k0 += THREADS / GROUP) {  // the same rounds in every warp
    const int k = k0 + group;
    double s = 0.0;
    if (k < ns)
      for (int b = lane; b < blocks; b += GROUP)
        s = __dadd_rn(s, __ldcg(rows + (size_t)b * ns + k));
    for (int off = GROUP / 2; off > 0; off >>= 1)
      s = __dadd_rn(s, __shfl_down_sync(FULL, s, off, GROUP));
    if (k < ns && lane == 0) dst[k] = s;
  }
}

// The EM update of src_gmm_em_step (src/GmmModel.cpp:275-334) from the
// summed sums [ll, gauss_sum[g], var_sum[g]], by one block: warp 0 reduces
// the total and the NaN-propagating max and min of the new weights by
// butterflies (lane 0's results count), then a thread a component writes
// (wdst, vdst) and, where given, 1 / sqrt(2 pi v) and 2 v; a rejected
// step keeps (wsrc, vsrc) (either may alias its destination; coef and den
// then stay). scal: shared [2].
__device__ void em_update(const double* sums, int g, const double* wsrc, const double* vsrc,
                          double* wdst, double* vdst, double* coef, double* den, double m_thre,
                          double n_thre, double* scal) {
  const double* gsum = sums + 1;
  const double* vsum = sums + 1 + g;
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    double total = 0.0;
    for (int j = lane; j < g; j += 32) total = __dadd_rn(total, gsum[j]);
    total = segment_sum(total, 32);
    double mx = __ddiv_rn(gsum[lane < g ? lane : 0], total), mn = mx;
    for (int j = lane + 32; j < g; j += 32) {
      const double nw = __ddiv_rn(gsum[j], total);
      mx = nan_max(mx, nw);
      mn = nan_min(mn, nw);
    }
    for (int off = 1; off < 32; off <<= 1) {
      mx = nan_max(mx, __shfl_xor_sync(FULL, mx, off));
      mn = nan_min(mn, __shfl_xor_sync(FULL, mn, off));
    }
    if (lane == 0) {
      const double first = __ddiv_rn(gsum[0], total), last = __ddiv_rn(gsum[g - 1], total);
      const bool interior = mx != first && mx != last;
      const bool reject = interior && (mn < __ddiv_rn(__ddiv_rn(1.0, (double)g), m_thre) ||
                                       mn < __ddiv_rn(__ddiv_rn(mx, (double)g), n_thre));
      scal[0] = total;
      scal[1] = reject ? 1.0 : 0.0;
    }
  }
  __syncthreads();
  const double total = scal[0];
  const bool reject = scal[1] != 0.0;
  for (int j = threadIdx.x; j < g; j += blockDim.x) {
    const double w_old = wsrc[j], v_old = vsrc[j];
    double nv = __ddiv_rn(vsum[j], gsum[j]);
    if (nv == 0.0) nv = DBL_MIN;
    wdst[j] = reject ? w_old : __ddiv_rn(gsum[j], total);
    vdst[j] = reject ? v_old : nv;
    if (coef && !reject) {
      coef[j] = coef_of(nv);
      den[j] = __dmul_rn(2.0, nv);
    }
  }
  __syncthreads();
}

// Grid barrier on bar[0] (arrivals) and bar[1] (generation); `gen` is
// the generation this block last saw. The last block to arrive sets the
// arrivals back to 0 before it advances the generation, so both words
// stay ready for the next barrier and the next launch.
__device__ __forceinline__ void grid_sync(unsigned* bar, unsigned& gen) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    if (atomicAdd(bar, 1u) + 1 == gridDim.x) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      while (*(volatile unsigned*)(bar + 1) == gen) __nanosleep(32);
    }
    __threadfence();
  }
  ++gen;
  __syncthreads();
}

__device__ __forceinline__ unsigned generation(const unsigned* bar) {
  return *(volatile const unsigned*)(bar + 1);
}

// shared memory of em_kernel: the warps' sums, two scalars, and, if
// `state`, a block's parameters and summed sums
__host__ __device__ __forceinline__ size_t shared_doubles(int g, bool state) {
  return (size_t)WARPS * RED + 2 + (state ? state_doubles(g) : 0);
}

__global__ void __launch_bounds__(THREADS, 1) em_kernel(Fit F, int state_in_shared) {
  extern __shared__ double sh[];
  double* red = sh;                  // [WARPS * RED]
  double* scal = red + WARPS * RED;  // [2]
  const int g = F.g, ns = 2 * g + 1;
  unsigned* bar = (unsigned*)F.work;
  unsigned gen = generation(bar);
  double* scratch = F.work + HEAD;
  State S(state_in_shared ? scal + 2
                          : scratch + scratch_doubles(gridDim.x, g) +
                                (size_t)blockIdx.x * state_doubles(g),
          g);
  for (int j = threadIdx.x; j < g; j += THREADS) {
    const double vj = F.v0[j];
    S.w[j] = F.w0[j];
    S.v[j] = vj;
    S.coef[j] = coef_of(vj);
    S.den[j] = __dmul_rn(2.0, vj);
  }
  __syncthreads();
  double ll_prev = 0.0;
  for (int p = 0;; ++p) {
    double* rows = scratch + (size_t)(p & 1) * gridDim.x * ns;
    if (g > 32)
      block_pass<true>(F, S, rows + (size_t)blockIdx.x * ns, red);
    else
      block_pass<false>(F, S, rows + (size_t)blockIdx.x * ns, red);
    grid_sync(bar, gen);
    if (F.mode == PASS) {
      if (blockIdx.x == 0) rows_sum(rows, gridDim.x, ns, F.out);
      return;
    }
    rows_sum(rows, gridDim.x, ns, S.sums);
    __syncthreads();
    const double ll = S.sums[0];
    const double delta = p ? __dsub_rn(ll, ll_prev) : DBL_MAX;
    if (!(delta > F.max_delta && p < F.max_iter)) {
      if (blockIdx.x == 0) {
        for (int j = threadIdx.x; j < g; j += THREADS) {
          F.out[j] = S.v[j];
          F.out[g + j] = S.w[j];
        }
        if (threadIdx.x == 0) {
          F.out[2 * g] = ll;
          F.out[2 * g + 1] = (double)p;
        }
      }
      return;
    }
    em_update(S.sums, g, S.w, S.v, S.w, S.v, S.coef, S.den, F.m_thre, F.n_thre, scal);
    ll_prev = ll;
  }
}

__global__ void __launch_bounds__(THREADS) update_kernel(const double* sums, int g,
                                                         const double* w, const double* v,
                                                         double m_thre, double n_thre,
                                                         double* w_out, double* v_out) {
  __shared__ double scal[2];
  em_update(sums, g, w, v, w_out, v_out, nullptr, nullptr, m_thre, n_thre, scal);
}

// rounds of grid barriers and nothing else: the barrier's cost
__global__ void __launch_bounds__(THREADS, 1) barrier_kernel(unsigned* bar, int rounds) {
  unsigned gen = generation(bar);
  for (int r = 0; r < rounds; ++r) grid_sync(bar, gen);
}

// The parts of a pass's latency floor, measured apart from em_kernel, each
// `rounds` times in a chain (one round waits on the one before, so the
// slope over rounds is one round's latency), at g <= 32. CHAIN, one warp:
// one point a W-lane segment, its L2 read, one density a lane, the
// segment sums of s and rs, one divide, the log on the segment's first
// lane and the lane's sums. REDUCE, one block of THREADS threads: the
// three sums a thread reduced into a row as block_row does, then `blocks`
// rows of scratch summed into out as every block sums them (rows_sum, L2
// reads). out: [2g + 1].
__global__ void __launch_bounds__(THREADS) floor_kernel(int mode, int g, int blocks, int rounds,
                                                       double* scratch, double* out) {
  extern __shared__ double sh[];
  const int ns = 2 * g + 1, W = width_of(g), j = threadIdx.x & (W - 1);
  double acc = 0.0;
  if (mode == CHAIN) {
    const bool mine = j < g;
    const double mean = (j + 1.0) / (g + 1.0), wt = 1.0 / g, coef = coef_of(0.01), den = 0.02;
    if (threadIdx.x == 0) out[0] = 0.37;
    __syncwarp();
    for (int r = 0; r < rounds; ++r) {
      // the read's address waits on the round before (acc != acc is 0)
      const double x = __dadd_rn(__ldcg(out + (acc != acc)), __dmul_rn(1e-300, acc));
      double s = mine ? weighted(x, mean, wt, coef, den) : 0.0;
      double part = mine ? (s == 0.0 ? DBL_MIN : s) : 0.0;
      const double rs = segment_sum(part, W);
      s = segment_sum(s, W);
      const double d = __dsub_rn(x, mean);
      const double q = mine ? __ddiv_rn(part, rs) : 0.0;
      const double ll = j == 0 ? log(s == 0.0 ? DBL_MIN : s) : 0.0;
      acc = __dadd_rn(ll, __dadd_rn(q, __dmul_rn(__dmul_rn(q, d), d)));
    }
    if (threadIdx.x == 0) out[1] = acc;
    return;
  }
  for (int r = 0; r < rounds; ++r) {
    const double base = __dadd_rn((double)threadIdx.x, __dmul_rn(1e-300, acc));
    block_row(base, base, base, 0, W, g, scratch, sh);
    rows_sum(scratch, blocks, ns, out);
    __syncthreads();
    acc = __ldcg(out);
    __syncthreads();
  }
}

// components a launch takes; up to about 4,600 their parameters and sums
// sit in shared memory, past that in the workspace
constexpr int MAX_G = 7168;

struct Card {
  int sms = 0, optin = 0;
};

cudaError_t card(Card* c) {
  static Card cached;
  if (!cached.sms) {
    int dev;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    e = cudaDeviceGetAttribute(&cached.sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    e = cudaDeviceGetAttribute(&cached.optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e != cudaSuccess) return e;
  }
  *c = cached;
  return cudaSuccess;
}

struct Plan {
  int blocks = 1, per_sm = 0;
  bool state_in_shared = true;
  size_t smem = 0;
  long long work_doubles = 0;
};

// The launch over n points at g components: the state in shared memory if
// it fits; a block a multiprocessor at most, fewer where n W lanes fill
// fewer blocks of THREADS, at least one (also for n = 0).
cudaError_t plan(long long n, int g, Plan* P) {
  Card c;
  cudaError_t e = card(&c);
  if (e != cudaSuccess) return e;
  P->state_in_shared = sizeof(double) * shared_doubles(g, true) <= (size_t)c.optin;
  P->smem = sizeof(double) * shared_doubles(g, P->state_in_shared);
  if (P->smem > (48 << 10)) {
    e = cudaFuncSetAttribute(em_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)P->smem);
    if (e != cudaSuccess) return e;
  }
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&P->per_sm, em_kernel, THREADS, P->smem);
  if (e != cudaSuccess) return e;
  if (P->per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long need = (n * width_of(g) + THREADS - 1) / THREADS;
  long long b = c.sms;
  if (need < b) b = need;
  if (b < 1) b = 1;
  P->blocks = (int)b;
  P->work_doubles = HEAD + (long long)scratch_doubles(P->blocks, g) +
                    (P->state_in_shared ? 0 : b * (long long)state_doubles(g));
  return cudaSuccess;
}

cudaError_t launch(Fit F, const Plan& P, cudaStream_t st) {
  int in_shared = P.state_in_shared;
  void* args[] = {&F, &in_shared};
  cudaError_t e = cudaLaunchCooperativeKernel((const void*)em_kernel, dim3(P.blocks),
                                              dim3(THREADS), args, P.smem, st);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

bool bad_args(long long n, int g) { return n < 0 || g < 1 || g > MAX_G; }

}  // namespace

// Blocks and workspace doubles of a fit or a pass over n points at g
// components. The workspace's first HEAD doubles are the barrier words:
// zero them once when the workspace is made, and keep them with it.
// Returns a CUDA error code.
extern "C" int pf_gmm_em_plan(long long n, int g, int* blocks, long long* work_doubles) {
  if (bad_args(n, g)) return (int)cudaErrorInvalidValue;
  Plan P;
  const cudaError_t e = plan(n, g, &P);
  if (e != cudaSuccess) return (int)e;
  *blocks = P.blocks;
  *work_doubles = P.work_doubles;
  return 0;
}

// The whole fit: out [2g + 2] = variances, weights, ll, count. work holds
// the doubles pf_gmm_em_plan asks for, its barrier words as the last
// launch on it left them (zero at first).
extern "C" int pf_gmm_em(const double* af, long long n, const double* means, const double* w,
                         const double* v, int g, int max_iter, double m_thre, double n_thre,
                         double max_delta, double* work, double* out, void* stream) {
  if (bad_args(n, g)) return (int)cudaErrorInvalidValue;
  Plan P;
  const cudaError_t e = plan(n, g, &P);
  if (e != cudaSuccess) return (int)e;
  Fit F{af, n, means, w, v, g, max_iter, m_thre, n_thre, max_delta, work, out, LOOP};
  return (int)launch(F, P, (cudaStream_t)stream);
}

// One pass at (w, v): sums [2g + 1] = ll, gauss sums, var sums of af's n
// points (n may be 0).
extern "C" int pf_gmm_em_pass(const double* af, long long n, const double* means, const double* w,
                              const double* v, int g, double* work, double* sums, void* stream) {
  if (bad_args(n, g)) return (int)cudaErrorInvalidValue;
  Plan P;
  const cudaError_t e = plan(n, g, &P);
  if (e != cudaSuccess) return (int)e;
  Fit F{af, n, means, w, v, g, 0, 0.0, 0.0, 0.0, work, sums, PASS};
  return (int)launch(F, P, (cudaStream_t)stream);
}

// The update of summed sums [2g + 1] from (w, v) into (w_out, v_out): one
// block of THREADS threads.
extern "C" int pf_gmm_em_update(const double* sums, const double* w, const double* v, int g,
                                double m_thre, double n_thre, double* w_out, double* v_out,
                                void* stream) {
  if (bad_args(0, g)) return (int)cudaErrorInvalidValue;
  update_kernel<<<1, THREADS, 0, (cudaStream_t)stream>>>(sums, g, w, v, m_thre, n_thre, w_out,
                                                        v_out);
  return (int)cudaGetLastError();
}

// `rounds` grid barriers over `blocks` co-resident blocks of THREADS
// threads; bar: two unsigned of device memory, zeroed once before the
// first probe (each probe leaves them ready for the next). Returns a CUDA
// error code.
extern "C" int pf_gmm_barrier_probe(int blocks, int rounds, unsigned* bar, void* stream) {
  void* args[] = {&bar, &rounds};
  const cudaError_t e = cudaLaunchCooperativeKernel((const void*)barrier_kernel, dim3(blocks),
                                                    dim3(THREADS), args, 0, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// `rounds` rounds of one part of a pass's latency floor at g <= 32
// components (floor_kernel): mode 0 one point's chain, one warp; mode 1
// the block reduction and the sum of `blocks` rows, one block. scratch:
// blocks * (2g + 1) doubles; out: 2g + 1. Returns a CUDA error code.
extern "C" int pf_gmm_floor_probe(int mode, int g, int blocks, int rounds, double* scratch,
                                  double* out, void* stream) {
  if ((mode != CHAIN && mode != REDUCE) || g < 1 || g > 32 || blocks < 1 || rounds < 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (mode == CHAIN)
    floor_kernel<<<1, 32, 0, st>>>(mode, g, blocks, rounds, scratch, out);
  else
    floor_kernel<<<1, THREADS, WARPS * RED * sizeof(double), st>>>(mode, g, blocks, rounds,
                                                                    scratch, out);
  return (int)cudaGetLastError();
}

// The compiled fit kernel at n points and g components, into out[6]:
// registers a thread, local memory bytes a thread, shared memory bytes a
// block, resident blocks a multiprocessor, threads a block, blocks of the
// launch (one a multiprocessor at most). Returns a CUDA error code.
extern "C" int pf_gmm_em_attrs(long long n, int g, int* out) {
  if (bad_args(n, g)) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, em_kernel);
  if (e != cudaSuccess) return (int)e;
  Plan P;
  e = plan(n, g, &P);
  if (e != cudaSuccess) return (int)e;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)P.smem;
  out[3] = P.per_sm;
  out[4] = THREADS;
  out[5] = P.blocks;
  return 0;
}

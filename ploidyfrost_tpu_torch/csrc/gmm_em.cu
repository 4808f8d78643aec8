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
// Layout: each block owns a fixed contiguous range of af, its threads
// stride over it, and each thread keeps the ll sum and the gauss and var
// sums of up to CHUNK components in registers (a larger g runs CHUNK
// components at a time, recomputing the densities for each chunk). Each
// pass stages the components' mean, weight, 1 / sqrt(2 pi v) and 2 v in
// shared memory (4g doubles: up to MAX_G components, the limit raised
// above 48 KB as the card allows). A block
// reduces its sums in a fixed order (warp shuffle tree, then the warps in
// turn) into its scratch row; a grid barrier; block 0 reduces the rows in
// block order, thread 0 decides and updates and writes the parameters and
// a stop flag; a second grid barrier, after which every block reads them
// from L2. No floating-point atomics: the same inputs on the same card
// give the same bits. The barrier is written by hand on a global counter;
// the cooperative launch guarantees that every block is resident.
//
// Rounding: every product, quotient and sum is an explicit _rn intrinsic,
// so nvcc contracts nothing into an FMA, and the density is formed in the
// plain version's order, 1 / sqrt((2 pi) v) * exp(-(d d) / (2 v)). The
// max and min of the guard propagate NaN, as torch.max and jnp.max do.
//
// What bounds it: latency. A fit at bench5m's size moves about 0.2 MB
// and does a few million fp64 operations a pass, far below a microsecond
// of the card's rates; a pass is one point a thread, so its time is the
// chain of one point's exp, divide and log, the block and grid
// reductions and two barriers. The design keeps that chain to one pass an
// iteration and the host out of the loop. pf_gmm_floor_probe measures the
// chain and the reductions apart from this kernel, and
// pf_gmm_barrier_probe the barrier: together a latency floor for a fit.
//
// pf_gmm_em_pass (one pass, the reduced sums out) and pf_gmm_em_update
// (the update of summed sums, one thread) are the same device code for the
// sharded fit, whose sums are all_reduced between them.

#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CHUNK = 16;              // components a thread keeps sums of in registers
constexpr int NSUM = 2 * CHUNK + 1;    // ll, CHUNK gauss sums, CHUNK var sums
constexpr unsigned FULL = 0xffffffffu;
constexpr double TWO_PI = 2.0 * 3.14159265358979323846;

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
  double* work;  // scratch [blocks, 2g + 1], then wpar [g], vpar [g], sums [2g + 1], flag, barrier
  double* out;   // LOOP: v [g], w [g], ll, count; PASS: sums [2g + 1]
  int mode;
};

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

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = __dadd_rn(v, __shfl_down_sync(FULL, v, off));
  return v;
}

// One block's sums of components c0 .. c0 + m - 1 into row [2g + 1]
// (ll only for c0 = 0), each thread holding ll, gs [m] and vs [m]: a
// shuffle tree in each warp, then the warps in turn. red: shared
// [WARPS * NSUM].
__device__ void block_reduce(double ll, double* gs, double* vs, int c0, int m, int g, double* row,
                             double* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (c0 == 0) ll = warp_sum(ll);
#pragma unroll
  for (int k = 0; k < CHUNK; ++k) {
    if (k < m) {
      gs[k] = warp_sum(gs[k]);
      vs[k] = warp_sum(vs[k]);
    }
  }
  if (lane == 0) {
    double* r = red + warp * NSUM;
    r[0] = ll;
#pragma unroll
    for (int k = 0; k < CHUNK; ++k) {
      r[1 + k] = gs[k];
      r[1 + CHUNK + k] = vs[k];
    }
  }
  __syncthreads();
  const int k = threadIdx.x;
  if (k < NSUM) {
    double s = 0.0;
    for (int w = 0; w < WARPS; ++w) s = __dadd_rn(s, red[w * NSUM + k]);
    if (k == 0) {
      if (c0 == 0) row[0] = s;
    } else if (k <= CHUNK) {
      if (k - 1 < m) row[1 + c0 + k - 1] = s;
    } else if (k - 1 - CHUNK < m) {
      row[1 + g + c0 + k - 1 - CHUNK] = s;
    }
  }
  __syncthreads();
}

// One block's sums over af[lo, hi) into row [2g + 1]: ll, gauss sums, var
// sums. comp: shared [4g], the components' mean, weight, 1 / sqrt(2 pi v)
// and 2 v; red: shared [WARPS * NSUM].
__device__ void block_pass(const Fit& F, const double* comp, long long lo, long long hi,
                           double* row, double* red) {
  const int g = F.g;
  const double *mean = comp, *wt = comp + g, *coef = comp + 2 * g, *den = comp + 3 * g;
  for (int c0 = 0; c0 < g; c0 += CHUNK) {
    const int m = min(CHUNK, g - c0);
    double ll = 0.0, gs[CHUNK], vs[CHUNK];
#pragma unroll
    for (int k = 0; k < CHUNK; ++k) gs[k] = vs[k] = 0.0;
    for (long long i = lo + threadIdx.x; i < hi; i += THREADS) {
      const double x = F.af[i];
      double s = 0.0, rs = 0.0, part[CHUNK];
      if (g <= CHUNK) {
#pragma unroll
        for (int j = 0; j < CHUNK; ++j) {
          if (j < g) {
            const double wp = weighted(x, mean[j], wt[j], coef[j], den[j]);
            s = __dadd_rn(s, wp);
            part[j] = wp == 0.0 ? DBL_MIN : wp;
            rs = __dadd_rn(rs, part[j]);
          }
        }
      } else {
        for (int j = 0; j < g; ++j) {
          const double wp = weighted(x, mean[j], wt[j], coef[j], den[j]);
          s = __dadd_rn(s, wp);
          rs = __dadd_rn(rs, wp == 0.0 ? DBL_MIN : wp);
        }
      }
      if (c0 == 0) ll = __dadd_rn(ll, log(s == 0.0 ? DBL_MIN : s));
#pragma unroll
      for (int k = 0; k < CHUNK; ++k) {
        if (k < m) {
          const int j = c0 + k;
          double pj;
          if (g <= CHUNK) {
            pj = part[k];
          } else {
            const double wp = weighted(x, mean[j], wt[j], coef[j], den[j]);
            pj = wp == 0.0 ? DBL_MIN : wp;
          }
          const double d = __dsub_rn(x, mean[j]);
          const double r = __ddiv_rn(pj, rs);
          gs[k] = __dadd_rn(gs[k], r);
          vs[k] = __dadd_rn(vs[k], __dmul_rn(__dmul_rn(r, d), d));
        }
      }
    }
    block_reduce(ll, gs, vs, c0, m, g, row, red);
  }
}

// Block 0: the scratch rows of `blocks` blocks summed in block order into
// dst [ns]; warp w takes the sums k = w, w + WARPS, ..., lane l the rows
// l, l + 32, ..., then a shuffle tree.
__device__ void rows_sum(const double* scratch, int blocks, int ns, double* dst) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int k = warp; k < ns; k += WARPS) {
    double s = 0.0;
    for (int b = lane; b < blocks; b += 32) s = __dadd_rn(s, __ldcg(scratch + (size_t)b * ns + k));
    s = warp_sum(s);
    if (lane == 0) dst[k] = s;
  }
}

// The EM update of src_gmm_em_step (src/GmmModel.cpp:275-334) from the
// summed sums [ll, gauss_sum[g], var_sum[g]]: the old (w, v) at wsrc, vsrc,
// the new at wdst, vdst (either may alias its source). One thread.
__device__ void em_update(const double* sums, int g, const double* wsrc, const double* vsrc,
                          double* wdst, double* vdst, double m_thre, double n_thre) {
  const double* gsum = sums + 1;
  const double* vsum = sums + 1 + g;
  double total = 0.0;
  for (int j = 0; j < g; ++j) total = __dadd_rn(total, gsum[j]);
  double max_w = 0.0, min_w = 0.0, first = 0.0, last = 0.0;
  for (int j = 0; j < g; ++j) {
    const double nw = __ddiv_rn(gsum[j], total);
    max_w = j ? nan_max(max_w, nw) : nw;
    min_w = j ? nan_min(min_w, nw) : nw;
    if (j == 0) first = nw;
    if (j == g - 1) last = nw;
  }
  const bool interior = max_w != first && max_w != last;
  const bool reject =
      interior && (min_w < __ddiv_rn(__ddiv_rn(1.0, (double)g), m_thre) ||
                   min_w < __ddiv_rn(__ddiv_rn(max_w, (double)g), n_thre));
  for (int j = 0; j < g; ++j) {
    const double w_old = __ldcg(wsrc + j), v_old = __ldcg(vsrc + j);
    double nv = __ddiv_rn(vsum[j], gsum[j]);
    if (nv == 0.0) nv = DBL_MIN;
    wdst[j] = reject ? w_old : __ddiv_rn(gsum[j], total);
    vdst[j] = reject ? v_old : nv;
  }
}

// Grid barrier on bar[0] (arrivals) and bar[1] (generation), both zeroed
// before the launch; `gen` counts this block's barriers.
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

__device__ __forceinline__ size_t scratch_doubles(int blocks, int g) {
  return (size_t)blocks * (2 * g + 1);
}

__global__ void __launch_bounds__(THREADS) em_kernel(Fit F) {
  extern __shared__ double sh[];
  double* red = sh;                  // [WARPS * NSUM]
  double* comp = sh + WARPS * NSUM;  // [4g]
  const int g = F.g, ns = 2 * g + 1;
  const long long per = (F.n + gridDim.x - 1) / gridDim.x;
  const long long lo = min(F.n, (long long)blockIdx.x * per), hi = min(F.n, lo + per);
  double* scratch = F.work;
  double* wpar = scratch + scratch_doubles(gridDim.x, g);
  double* vpar = wpar + g;
  double* sums = vpar + g;
  double* flag = sums + ns;
  unsigned* bar = (unsigned*)(flag + 1);
  unsigned gen = 0;
  double ll_prev = 0.0;  // block 0, thread 0
  for (int p = 0;; ++p) {
    const double* wsrc = p ? wpar : F.w0;
    const double* vsrc = p ? vpar : F.v0;
    for (int j = threadIdx.x; j < g; j += THREADS) {
      const double vj = __ldcg(vsrc + j);
      comp[j] = __ldg(F.means + j);
      comp[g + j] = __ldcg(wsrc + j);
      comp[2 * g + j] = coef_of(vj);
      comp[3 * g + j] = __dmul_rn(2.0, vj);
    }
    __syncthreads();
    block_pass(F, comp, lo, hi, scratch + (size_t)blockIdx.x * ns, red);
    grid_sync(bar, gen);
    if (blockIdx.x == 0) {
      double* dst = F.mode == PASS ? F.out : sums;
      rows_sum(scratch, gridDim.x, ns, dst);
      __syncthreads();
      if (threadIdx.x == 0 && F.mode == LOOP) {
        const double ll = sums[0];
        const double delta = p ? __dsub_rn(ll, ll_prev) : DBL_MAX;
        if (delta > F.max_delta && p < F.max_iter) {
          em_update(sums, g, wsrc, vsrc, wpar, vpar, F.m_thre, F.n_thre);
          ll_prev = ll;
          *flag = 0.0;
        } else {
          for (int j = 0; j < g; ++j) {
            F.out[j] = __ldcg(vsrc + j);
            F.out[g + j] = __ldcg(wsrc + j);
          }
          F.out[2 * g] = ll;
          F.out[2 * g + 1] = (double)p;
          *flag = 1.0;
        }
      }
    }
    if (F.mode == PASS) return;
    grid_sync(bar, gen);
    if (__ldcg(flag) != 0.0) return;
  }
}

__global__ void update_kernel(const double* sums, int g, const double* w, const double* v,
                              double m_thre, double n_thre, double* w_out, double* v_out) {
  em_update(sums, g, w, v, w_out, v_out, m_thre, n_thre);
}

// rounds of grid barriers and nothing else: the barrier's cost
__global__ void __launch_bounds__(THREADS) barrier_kernel(unsigned* bar, int rounds) {
  unsigned gen = 0;
  for (int r = 0; r < rounds; ++r) grid_sync(bar, gen);
}

// The parts of a pass's latency floor, measured apart from em_kernel, each
// `rounds` times in a chain (one round waits on the one before, so the
// slope over rounds is one round's latency). CHAIN, one thread: one
// point's work at g <= CHUNK components with the components in shared
// memory, the L2 read of the point, g densities (each a difference, a
// square, a quotient, an exp and two products), the row sum and its log,
// g responsibilities (each a quotient and two products) into the sums.
// REDUCE, one block of THREADS threads: 2g + 1 sums a thread reduced into
// a row as block_reduce does, then `blocks` rows of scratch summed into
// out as block 0 sums them (rows_sum, L2 reads). out: [2g + 1].
__global__ void __launch_bounds__(THREADS) floor_kernel(int mode, int g, int blocks, int rounds,
                                                       double* scratch, double* out) {
  extern __shared__ double sh[];
  const int ns = 2 * g + 1;
  double acc = 0.0;
  if (mode == CHAIN) {
    double *mean = sh, *wt = sh + g, *coef = sh + 2 * g, *den = sh + 3 * g;
    for (int j = 0; j < g; ++j) {
      mean[j] = (j + 1.0) / (g + 1.0);
      wt[j] = 1.0 / g;
      coef[j] = coef_of(0.01);
      den[j] = 0.02;
    }
    out[0] = 0.37;
    for (int r = 0; r < rounds; ++r) {
      // the read's address waits on the round before (acc != acc is 0)
      const double x = __dadd_rn(__ldcg(out + (acc != acc)), __dmul_rn(1e-300, acc));
      double s = 0.0, rs = 0.0, part[CHUNK];
#pragma unroll
      for (int j = 0; j < CHUNK; ++j) {
        if (j < g) {
          const double wp = weighted(x, mean[j], wt[j], coef[j], den[j]);
          s = __dadd_rn(s, wp);
          part[j] = wp == 0.0 ? DBL_MIN : wp;
          rs = __dadd_rn(rs, part[j]);
        }
      }
      double ll = log(s == 0.0 ? DBL_MIN : s), gsum = 0.0, vsum = 0.0;
#pragma unroll
      for (int j = 0; j < CHUNK; ++j) {
        if (j < g) {
          const double d = __dsub_rn(x, mean[j]);
          const double q = __ddiv_rn(part[j], rs);
          gsum = __dadd_rn(gsum, q);
          vsum = __dadd_rn(vsum, __dmul_rn(__dmul_rn(q, d), d));
        }
      }
      acc = __dadd_rn(ll, __dadd_rn(gsum, vsum));
    }
    out[1] = acc;
    return;
  }
  double* red = sh;
  for (int r = 0; r < rounds; ++r) {
    const double base = __dadd_rn((double)threadIdx.x, __dmul_rn(1e-300, acc));
    double gs[CHUNK], vs[CHUNK];
#pragma unroll
    for (int k = 0; k < CHUNK; ++k) gs[k] = vs[k] = base;
    block_reduce(base, gs, vs, 0, g, g, scratch, red);
    rows_sum(scratch, blocks, ns, out);
    __syncthreads();
    acc = __ldcg(out);
    __syncthreads();
  }
}

// components a launch takes: 4g doubles of them in shared memory beside
// the reduction's, within the 227 KB a Hopper block may opt in to
constexpr int MAX_G = 7168;

size_t shared_bytes(int g) { return sizeof(double) * (WARPS * NSUM + 4 * (size_t)g); }

// Raise em_kernel's dynamic shared memory limit for g components above
// the default 48 KB, or fail if the card cannot give it.
cudaError_t allow_shared(int g) {
  const size_t smem = shared_bytes(g);
  if (smem <= (48 << 10)) return cudaSuccess;
  int dev, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return e;
  if (smem > (size_t)optin) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(em_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// Blocks of a launch over n points at g components: one a THREADS points,
// at most as many as the card holds at once, at least one (also for n = 0).
cudaError_t plan(long long n, int g, int* blocks, long long* work_doubles) {
  static int sms = 0;
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (!sms) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
  }
  e = allow_shared(g);
  if (e != cudaSuccess) return e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, em_kernel, THREADS, shared_bytes(g));
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long need = (n + THREADS - 1) / THREADS;
  long long b = (long long)per_sm * sms;
  if (need < b) b = need;
  if (b < 1) b = 1;
  *blocks = (int)b;
  // scratch, wpar, vpar, sums, flag, barrier (two unsigned in one double)
  *work_doubles = b * (2LL * g + 1) + 2LL * g + (2LL * g + 1) + 2;
  return cudaSuccess;
}

cudaError_t launch(Fit F, long long work_doubles, int blocks, cudaStream_t st) {
  unsigned* bar = (unsigned*)(F.work + work_doubles - 1);
  cudaError_t e = cudaMemsetAsync(bar, 0, 2 * sizeof(unsigned), st);
  if (e != cudaSuccess) return e;
  void* args[] = {&F};
  e = cudaLaunchCooperativeKernel((const void*)em_kernel, dim3(blocks), dim3(THREADS), args,
                                  shared_bytes(F.g), st);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

// Blocks and workspace doubles of a fit or a pass over n points at g
// components. Returns a CUDA error code.
extern "C" int pf_gmm_em_plan(long long n, int g, int* blocks, long long* work_doubles) {
  if (n < 0 || g < 1 || g > MAX_G) return (int)cudaErrorInvalidValue;
  return (int)plan(n, g, blocks, work_doubles);
}

// The whole fit: out [2g + 2] = variances, weights, ll, count. work holds
// the doubles pf_gmm_em_plan asks for.
extern "C" int pf_gmm_em(const double* af, long long n, const double* means, const double* w,
                         const double* v, int g, int max_iter, double m_thre, double n_thre,
                         double max_delta, double* work, double* out, void* stream) {
  int blocks;
  long long wd;
  if (n < 0 || g < 1 || g > MAX_G) return (int)cudaErrorInvalidValue;
  cudaError_t e = plan(n, g, &blocks, &wd);
  if (e != cudaSuccess) return (int)e;
  Fit F{af, n, means, w, v, g, max_iter, m_thre, n_thre, max_delta, work, out, LOOP};
  return (int)launch(F, wd, blocks, (cudaStream_t)stream);
}

// One pass at (w, v): sums [2g + 1] = ll, gauss sums, var sums of af's n
// points (n may be 0).
extern "C" int pf_gmm_em_pass(const double* af, long long n, const double* means, const double* w,
                              const double* v, int g, double* work, double* sums, void* stream) {
  int blocks;
  long long wd;
  if (n < 0 || g < 1 || g > MAX_G) return (int)cudaErrorInvalidValue;
  cudaError_t e = plan(n, g, &blocks, &wd);
  if (e != cudaSuccess) return (int)e;
  Fit F{af, n, means, w, v, g, 0, 0.0, 0.0, 0.0, work, sums, PASS};
  return (int)launch(F, wd, blocks, (cudaStream_t)stream);
}

// The update of summed sums [2g + 1] from (w, v) into (w_out, v_out): one
// block of one thread.
extern "C" int pf_gmm_em_update(const double* sums, const double* w, const double* v, int g,
                                double m_thre, double n_thre, double* w_out, double* v_out,
                                void* stream) {
  if (g < 1 || g > MAX_G) return (int)cudaErrorInvalidValue;
  update_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(sums, g, w, v, m_thre, n_thre, w_out, v_out);
  return (int)cudaGetLastError();
}

// `rounds` grid barriers over `blocks` co-resident blocks of THREADS
// threads; bar: two unsigned of device memory. Returns a CUDA error code.
extern "C" int pf_gmm_barrier_probe(int blocks, int rounds, unsigned* bar, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(bar, 0, 2 * sizeof(unsigned), st);
  if (e != cudaSuccess) return (int)e;
  void* args[] = {&bar, &rounds};
  e = cudaLaunchCooperativeKernel((const void*)barrier_kernel, dim3(blocks), dim3(THREADS), args,
                                  0, st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// `rounds` rounds of one part of a pass's latency floor at g <= 16
// components (floor_kernel): mode 0 one point's chain, one thread; mode 1
// the block reduction and the sum of `blocks` rows, one block. scratch:
// blocks * (2g + 1) doubles; out: 2g + 1. Returns a CUDA error code.
extern "C" int pf_gmm_floor_probe(int mode, int g, int blocks, int rounds, double* scratch,
                                  double* out, void* stream) {
  if ((mode != CHAIN && mode != REDUCE) || g < 1 || g > CHUNK || blocks < 1 || rounds < 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (mode == CHAIN)
    floor_kernel<<<1, 1, 4 * g * sizeof(double), st>>>(mode, g, blocks, rounds, scratch, out);
  else
    floor_kernel<<<1, THREADS, WARPS * NSUM * sizeof(double), st>>>(mode, g, blocks, rounds,
                                                                     scratch, out);
  return (int)cudaGetLastError();
}

// The compiled fit kernel at n points and g components, into out[6]:
// registers a thread, local memory bytes a thread, shared memory bytes a
// block, resident blocks a multiprocessor, threads a block, blocks of the
// launch. Returns a CUDA error code.
extern "C" int pf_gmm_em_attrs(long long n, int g, int* out) {
  if (n < 0 || g < 1 || g > MAX_G) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, em_kernel);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0, blocks;
  long long wd;
  e = plan(n, g, &blocks, &wd);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, em_kernel, THREADS, shared_bytes(g));
  if (e != cudaSuccess) return (int)e;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)shared_bytes(g);
  out[3] = per_sm;
  out[4] = THREADS;
  out[5] = blocks;
  return 0;
}

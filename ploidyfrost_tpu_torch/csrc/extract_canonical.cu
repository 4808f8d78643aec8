// Canonical k-mer extraction for NVIDIA Hopper (sm_90a), plain C ABI.
//
// Replaces ploidyfrost_tpu/kmer/pallas_extract.py::_build.kernel, the
// Pallas TPU kernel behind the counter's fused extract + append step.
// For every k-window of every read it builds the forward 2-bit word and
// the reverse-complement word and writes canonical = min(fwd, rc) as an
// int64 key; a window holding any code >= 4 gets INT64_MAX, which sorts
// after every real key in the counter's sort-collapse.
//
// Input  codes [B, L] uint8 (row-major, contiguous), 0 < k <= 31, L >= k.
// Output out[b * n + i] int64 for n = L - k + 1, written at the pointer
//        the caller passes (the counter's instance buffer at its fill).
//
// Bound: memory traffic. The function reads B*L bytes and writes B*n*8
// bytes (B=16384, L=160, k=25: 2.6 MB in, 17.8 MB out, about 6 us at
// 3.35 TB/s); its arithmetic is a few integer operations per base.
// Design: one block stages the codes of RPB consecutive reads in shared
// memory with one coalesced pass, then each thread builds one window's
// two words in registers from shared memory (k shared loads a window)
// and the block's threads write consecutive output keys, so the 8-byte
// stores coalesce. The TPU kernel's transposed layout and (hi, lo) u32
// split existed for Mosaic and the TPU's missing 64-bit integers; this
// card has native 64-bit integer ops, so neither is carried over.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kSentinel = INT64_MAX;

__global__ void extract_canonical_kernel(const uint8_t* __restrict__ codes,
                                         int64_t B, int L, int k, int rpb,
                                         int64_t* __restrict__ out) {
  extern __shared__ uint8_t s_codes[];
  const int n = L - k + 1;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * rpb;
  const int rows = static_cast<int>(min(static_cast<int64_t>(rpb), B - r0));
  const int nbytes = rows * L;
  const uint8_t* src = codes + r0 * L;
  for (int t = threadIdx.x; t < nbytes; t += blockDim.x) s_codes[t] = src[t];
  __syncthreads();

  const int nwin = rows * n;
  int64_t* dst = out + r0 * n;
  for (int w = threadIdx.x; w < nwin; w += blockDim.x) {
    const int row = w / n;
    const int i = w - row * n;
    const uint8_t* s = s_codes + row * L + i;
    uint64_t fwd = 0, rc = 0;
    bool bad = false;
    for (int j = 0; j < k; ++j) {
      const uint32_t c = s[j];
      bad |= c >= 4u;
      const uint64_t b = c & 3u;
      fwd = (fwd << 2) | b;           // base j at bit 2*(k-1-j)
      rc |= (b ^ 3u) << (2 * j);      // its complement at bit 2*j
    }
    const uint64_t canon = fwd < rc ? fwd : rc;
    dst[w] = bad ? kSentinel : static_cast<int64_t>(canon);
  }
}

}  // namespace

extern "C" int pf_extract_canonical(const void* codes, int64_t B, int64_t L,
                                    int k, void* out, void* stream) {
  if (B <= 0) return 0;
  const int rpb = static_cast<int>(L >= 4096 ? 1 : 4096 / L);
  const int64_t grid = (B + rpb - 1) / rpb;
  const size_t smem = static_cast<size_t>(rpb) * static_cast<size_t>(L);
  extract_canonical_kernel<<<static_cast<unsigned>(grid), kThreads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(codes), B, static_cast<int>(L), k, rpb,
      static_cast<int64_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

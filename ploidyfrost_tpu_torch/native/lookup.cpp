// Copied from ploidyfrost_tpu/native/lookup.cpp.
// Bucketed binary-search lookup over a sorted uint64 k-mer table.
//
// Replaces np.searchsorted for the coverage-resolution probes
// (KmerCountDB.lookup — the batched replacement of the reference's
// CKMCFile::CheckKmer prefix-LUT + binary search,
// KMC/kmc_api/kmc_file.cpp). Same two-level structure as KMC's own
// format: a 2^16-entry prefix LUT narrows each probe to a ~100-entry
// bucket (L2-resident), then std::lower_bound finishes — ~6x faster
// than numpy's full-range binary search at 6M-entry tables.
//
// pf_lookup_canon_multi fuses the WHOLE probe pipeline that the
// colored coverage passes used to run as four numpy stages
// (revcomp + min canonicalization, searchsorted, hit compare,
// [n, C] count gather) into one threaded scan: the reference's
// equivalent per-k-mer dance is CKmerAPI::from_string + IsKmer +
// reverse + CheckKmer per color DB (src/CCDBG.cpp:89-156).

#include <algorithm>
#include <cstdint>
#include <thread>
#include <vector>

namespace {

inline uint64_t revcomp64(uint64_t x, int32_t k) {
  x = ~x;
  x = ((x >> 2) & 0x3333333333333333ULL) | ((x & 0x3333333333333333ULL) << 2);
  x = ((x >> 4) & 0x0F0F0F0F0F0F0F0FULL) | ((x & 0x0F0F0F0F0F0F0F0FULL) << 4);
  x = ((x >> 8) & 0x00FF00FF00FF00FFULL) | ((x & 0x00FF00FF00FF00FFULL) << 8);
  x = ((x >> 16) & 0x0000FFFF0000FFFFULL) |
      ((x & 0x0000FFFF0000FFFFULL) << 16);
  x = (x >> 32) | (x << 32);
  return x >> (64 - 2 * k);
}

}  // namespace

extern "C" {

// lut: bmax+2 bucket start offsets (lut[b] = first index with
// key >> shift >= b); out[i] = lower_bound(table, q[i]) as an index.
// The LUT size adapts to the table (kmer/countdb._make_lut): bigger
// tables get up to 2^22 buckets, which nearly halves the probe cost
// by shrinking the per-bucket binary search (measured 349 -> 197
// ns/query at 6M keys).
void pf_lookup_u64_b(const uint64_t* table, int64_t n, const int64_t* lut,
                     int32_t shift, int64_t bmax, const uint64_t* q,
                     int64_t nq, int64_t* out) {
  // block-pipelined: each pass issues a burst of independent
  // prefetches so the LUT->bucket dependent loads overlap across
  // queries instead of serializing at DRAM latency (the probe is
  // memory-latency-bound: the adaptive LUT keeps buckets to ~1-4
  // entries, so nearly all time is the two pointer chases)
  constexpr int64_t BL = 128;
  uint64_t bb[BL];
  for (int64_t base = 0; base < nq; base += BL) {
    const int64_t cnt = nq - base < BL ? nq - base : BL;
    for (int64_t j = 0; j < cnt; ++j) {
      uint64_t b = q[base + j] >> shift;
      if ((int64_t)b > bmax) b = bmax;
      bb[j] = b;
      __builtin_prefetch(&lut[b], 0, 1);
    }
    for (int64_t j = 0; j < cnt; ++j)
      __builtin_prefetch(&table[lut[bb[j]]], 0, 1);
    for (int64_t j = 0; j < cnt; ++j) {
      const uint64_t* lo = table + lut[bb[j]];
      const uint64_t* hi = table + lut[bb[j] + 1];
      out[base + j] = std::lower_bound(lo, hi, q[base + j]) - table;
    }
  }
}

void pf_lookup_u64(const uint64_t* table, int64_t n, const int64_t* lut,
                   int32_t shift, const uint64_t* q, int64_t nq,
                   int64_t* out) {
  pf_lookup_u64_b(table, n, lut, shift, 65535, q, nq, out);
}

// Fused canonicalize + bucketed probe + per-color count gather,
// threaded over query chunks (read-only shared state, disjoint output
// ranges — no synchronization needed).
//
//   table/lut/shift : sorted canonical key table + prefix LUT as above
//   k               : k-mer length (<= 31; canonical = min(v, revcomp))
//   q[nq]           : raw (either-strand) packed k-mers
//   counts[n*C]     : row-major per-key count rows (NULL -> skip gather)
//   counts_out      : gathered counts, 0 where miss (NULL -> skip);
//                     [nq, C] row-major, or [C, nq] when transpose_out
//                     (contiguous per-color vectors for the reduceat
//                     passes in sites/emit_colored.py)
//   hit_out[nq]     : 1 if the canonical query is in the table
//   n_threads       : worker count (<=0 -> hardware_concurrency)
void pf_lookup_canon_multi_t(const uint64_t* table, int64_t n,
                             const int64_t* lut, int32_t shift, int32_t k,
                             int64_t bmax,
                             const uint64_t* q, int64_t nq,
                             const int64_t* counts, int32_t C,
                             int64_t* counts_out, uint8_t* hit_out,
                             int32_t n_threads, int32_t transpose_out) {
  if (nq == 0) return;
  int nt = n_threads > 0 ? n_threads
                         : (int)std::thread::hardware_concurrency();
  if (nt < 1) nt = 1;
  if (nq < (1 << 15)) nt = 1;  // thread spawn not worth it below ~32k
  // block-pipelined like pf_lookup_u64_b: bursts of independent
  // prefetches overlap the LUT -> bucket -> count-row pointer chases
  // across queries (measured ~2x at 6M keys on this 2-vCPU host)
  auto work = [&](int64_t lo_i, int64_t hi_i) {
    constexpr int64_t BL = 128;
    uint64_t vv[BL];
    uint64_t bb[BL];
    int64_t ix[BL];
    for (int64_t base = lo_i; base < hi_i; base += BL) {
      const int64_t cnt = hi_i - base < BL ? hi_i - base : BL;
      for (int64_t j = 0; j < cnt; ++j) {
        uint64_t v = q[base + j];
        const uint64_t r = revcomp64(v, k);
        if (r < v) v = r;
        vv[j] = v;
        uint64_t b = v >> shift;
        if ((int64_t)b > bmax) b = bmax;
        bb[j] = b;
        __builtin_prefetch(&lut[b], 0, 1);
      }
      for (int64_t j = 0; j < cnt; ++j)
        __builtin_prefetch(&table[lut[bb[j]]], 0, 1);
      for (int64_t j = 0; j < cnt; ++j) {
        const uint64_t* lo = table + lut[bb[j]];
        const uint64_t* hi = table + lut[bb[j] + 1];
        const int64_t idx = std::lower_bound(lo, hi, vv[j]) - table;
        ix[j] = idx;
        const bool hit = idx < n && table[idx] == vv[j];
        hit_out[base + j] = hit ? 1 : 0;
        if (counts != nullptr && hit)
          __builtin_prefetch(&counts[idx * C], 0, 1);
      }
      if (counts_out != nullptr) {
        for (int64_t j = 0; j < cnt; ++j) {
          const int64_t i = base + j;
          const int64_t* src =
              (hit_out[j + base] && counts != nullptr) ? counts + ix[j] * C
                                                       : nullptr;
          if (transpose_out) {
            for (int32_t c = 0; c < C; ++c)
              counts_out[c * nq + i] = src ? src[c] : 0;
          } else {
            int64_t* dst = counts_out + i * C;
            for (int32_t c = 0; c < C; ++c) dst[c] = src ? src[c] : 0;
          }
        }
      }
    }
  };
  if (nt == 1) {
    work(0, nq);
    return;
  }
  std::vector<std::thread> threads;
  threads.reserve(nt);
  for (int t = 0; t < nt; ++t) {
    const int64_t lo_i = nq * t / nt, hi_i = nq * (t + 1) / nt;
    threads.emplace_back(work, lo_i, hi_i);
  }
  for (auto& th : threads) th.join();
}

// Packed k-mer extraction at arbitrary padded base positions: the
// native counterpart of SeqStore.kmers_at (graph/seqstore.py) — read
// up to two words, reverse the 2-bit groups (LSB-first storage ->
// MSB-first k-mer packing), shift down. One scalar pass per query vs
// ~14 whole-array numpy passes; threaded.
void pf_extract_kmers(const uint64_t* words, int64_t nwords,
                      const int64_t* upos, int64_t nq, int32_t k,
                      uint64_t* out, int32_t n_threads) {
  if (nq == 0) return;
  int nt = n_threads > 0 ? n_threads
                         : (int)std::thread::hardware_concurrency();
  if (nt < 1) nt = 1;
  if (nq < (1 << 15)) nt = 1;
  const uint32_t drop = 2 * (32 - k);
  auto work = [&](int64_t lo_i, int64_t hi_i) {
    for (int64_t i = lo_i; i < hi_i; ++i) {
      const int64_t p = upos[i];
      const int64_t w0 = p >> 5;
      const uint32_t b = 2 * (uint32_t)(p & 31);
      uint64_t v = words[w0] >> b;
      if (b) {
        const int64_t w1 = w0 + 1 < nwords ? w0 + 1 : nwords - 1;
        v |= words[w1] << (64 - b);
      }
      // reverse the 32 2-bit groups: byteswap + in-byte group swap
      v = __builtin_bswap64(v);
      v = ((v & 0x0303030303030303ULL) << 6) |
          ((v & 0x0C0C0C0C0C0C0C0CULL) << 2) |
          ((v & 0x3030303030303030ULL) >> 2) |
          ((v & 0xC0C0C0C0C0C0C0C0ULL) >> 6);
      out[i] = v >> drop;
    }
  };
  if (nt == 1) {
    work(0, nq);
    return;
  }
  std::vector<std::thread> threads;
  threads.reserve(nt);
  for (int t = 0; t < nt; ++t) {
    threads.emplace_back(work, nq * t / nt, nq * (t + 1) / nt);
  }
  for (auto& th : threads) th.join();
}

// Pack flat per-unitig base codes (0..3) into the SeqStore word layout:
// each unitig starts on a fresh uint64, 32 LSB-first 2-bit codes per
// word (base j of a unitig sits at bits [2j, 2j+2) of word j/32). The
// native counterpart of SeqStore.from_codes (graph/seqstore.py): one
// linear pass instead of the numpy per-base scatter, which costs ~40 s
// at 62M bases (the 50 Mbp GFA load's dominant term). words must be
// zero-initialized by the caller. Threaded over unitigs, split at
// base-count-balanced cut points.
void pf_pack_codes(const uint8_t* codes, const int64_t* off_b,
                   const int64_t* off_w, int64_t n, uint64_t* words,
                   int32_t n_threads) {
  if (n == 0) return;
  const int64_t total_b = off_b[n];
  int nt = n_threads > 0 ? n_threads
                         : (int)std::thread::hardware_concurrency();
  if (nt < 1) nt = 1;
  if (total_b < (1 << 18)) nt = 1;
  auto work = [&](int64_t u_lo, int64_t u_hi) {
    for (int64_t u = u_lo; u < u_hi; ++u) {
      const uint8_t* src = codes + off_b[u];
      const int64_t len = off_b[u + 1] - off_b[u];
      uint64_t* dst = words + off_w[u];
      const int64_t full = len >> 5;
      for (int64_t w = 0; w < full; ++w) {
        const uint8_t* s = src + (w << 5);
        uint64_t v = 0;
        for (int b = 0; b < 32; ++b)
          v |= (uint64_t)(s[b] & 3) << (2 * b);
        dst[w] = v;
      }
      const int64_t rem = len - (full << 5);
      if (rem) {
        const uint8_t* s = src + (full << 5);
        uint64_t v = 0;
        for (int64_t b = 0; b < rem; ++b)
          v |= (uint64_t)(s[b] & 3) << (2 * b);
        dst[full] = v;
      }
    }
  };
  if (nt == 1) {
    work(0, n);
    return;
  }
  std::vector<std::thread> threads;
  threads.reserve(nt);
  int64_t prev = 0;
  for (int t = 0; t < nt; ++t) {
    int64_t cut;
    if (t == nt - 1) {
      cut = n;
    } else {
      // balance on bases: first unitig whose start passes the quota
      const int64_t target = total_b * (t + 1) / nt;
      cut = std::lower_bound(off_b, off_b + n + 1, target) - off_b;
      if (cut < prev) cut = prev;
      if (cut > n) cut = n;
    }
    threads.emplace_back(work, prev, cut);
    prev = cut;
  }
  for (auto& th : threads) th.join();
}

// Backwards-compatible row-major entry point.
void pf_lookup_canon_multi(const uint64_t* table, int64_t n,
                           const int64_t* lut, int32_t shift, int32_t k,
                           const uint64_t* q, int64_t nq,
                           const int64_t* counts, int32_t C,
                           int64_t* counts_out, uint8_t* hit_out,
                           int32_t n_threads) {
  pf_lookup_canon_multi_t(table, n, lut, shift, k, 65535, q, nq, counts, C,
                          counts_out, hit_out, n_threads, 0);
}
}

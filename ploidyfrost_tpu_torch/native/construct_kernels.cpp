// Copied from ploidyfrost_tpu/native/construct_kernels.cpp.
// Construction kernels (C ABI): junction linking + unitig assembly.
//
// Native counterparts of graph/construct._links_junctions and the
// chain->packed-unitig assembly in build_graph_from_kmers. The numpy
// versions stay as oracles/fallbacks; tests/test_construct.py asserts
// equivalence on random k-mer sets. Both are memory-bound scans that a
// C loop runs ~6x faster than the vectorized-numpy multi-pass
// formulation at 12M-node scale (the reference's counterpart is
// Bifrost's multithreaded hash-walk construction,
// bifrost/src/CompactedDBG.tcc:2994-3320).

#include <cstdint>
#include <cstring>
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

// Parallel stable LSD radix sort of (u64 key, u32 payload) pairs by the
// low `bits` bits of key. 16-bit digits: 3 passes for 48-bit junction
// keys (k=25). Each pass: per-thread histograms over contiguous input
// ranges, exclusive per-(bucket, thread) offsets, then each thread
// scatters its own range — stability preserved because thread t's range
// precedes t+1's both in input and in the per-bucket layout. The sort
// is memory-bound: the u32 payload (vs the former i64) and 3 passes
// (vs 4 x 12-bit) cut moved bytes ~2.2x, threads overlap the rest.
constexpr int kSortThreads = 2;

void radix_sort_u32p(std::vector<uint64_t>& keys, std::vector<uint32_t>& idx,
                     int bits) {
  constexpr int kDigit = 16;
  constexpr size_t kBuckets = 1u << kDigit;
  constexpr uint64_t kMask = kBuckets - 1;
  const size_t n = keys.size();
  std::vector<uint64_t> kbuf(n);
  std::vector<uint32_t> ibuf(n);
  const int nt = (n > (1u << 20)) ? kSortThreads : 1;
  std::vector<std::vector<uint64_t>> counts(nt,
                                            std::vector<uint64_t>(kBuckets));
  for (int shift = 0; shift < bits; shift += kDigit) {
    auto histo = [&](int t) {
      auto& c = counts[t];
      std::fill(c.begin(), c.end(), 0);
      const size_t lo = n * t / nt, hi = n * (t + 1) / nt;
      for (size_t i = lo; i < hi; ++i) c[(keys[i] >> shift) & kMask]++;
    };
    if (nt == 1) {
      histo(0);
    } else {
      std::thread th(histo, 1);
      histo(0);
      th.join();
    }
    // exclusive offsets laid out bucket-major, thread-minor
    uint64_t pos = 0;
    for (size_t b = 0; b < kBuckets; ++b) {
      for (int t = 0; t < nt; ++t) {
        const uint64_t c = counts[t][b];
        counts[t][b] = pos;
        pos += c;
      }
    }
    auto scatter = [&](int t) {
      auto& c = counts[t];
      const size_t lo = n * t / nt, hi = n * (t + 1) / nt;
      for (size_t i = lo; i < hi; ++i) {
        const size_t d = c[(keys[i] >> shift) & kMask]++;
        kbuf[d] = keys[i];
        ibuf[d] = idx[i];
      }
    };
    if (nt == 1) {
      scatter(0);
    } else {
      std::thread th(scatter, 1);
      scatter(0);
      th.join();
    }
    keys.swap(kbuf);
    idx.swap(ibuf);
  }
}

}  // namespace

extern "C" {

// Bulk reverse-complement of packed canonical k-mers (one pass, two
// threads): the numpy formulation is 10+ memory passes of u64 temps
// (~14 s at 61M keys on this host; this loop ~1.5 s).
void pf_revcomp(const uint64_t* km, int64_t n, int32_t k, uint64_t* out) {
  auto work = [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) out[i] = revcomp64(km[i], k);
  };
  if (n > (1 << 20)) {
    std::thread th(work, n / 2, n);
    work(0, n / 2);
    th.join();
  } else {
    work(0, n);
  }
}

// Junction-sort unitig-interior linking. nxt_node[2n] must arrive
// filled with -1 and pal_mark[2n] zeroed; palindromic-junction stubs
// are marked for the caller's exact probe fallback.
void pf_link_junctions(const uint64_t* km, const uint64_t* rc, int64_t n,
                       int32_t k, int64_t* nxt_node, uint8_t* pal_mark) {
  const int32_t kj = k - 1;
  const uint64_t mask_j = (kj >= 32) ? ~0ULL : ((1ULL << (2 * kj)) - 1);
  const int64_t n2 = 2 * n;
  // payload packs (node | pol<<30 | pal<<31) into a u32 so the
  // post-sort run scan reads flags sequentially from the sorted
  // payloads (no random side-array access) and each sort pass moves
  // 12 B/element instead of 16. Node ids need 2n < 2^30 (a ~500 Mbp
  // genome); beyond that the caller's numpy path takes over.
  constexpr uint32_t kNodeMask = (1u << 30) - 1;
  constexpr uint32_t kPol = 1u << 30;
  constexpr uint32_t kPal = 1u << 31;
  std::vector<uint64_t> keys(n2);
  std::vector<uint32_t> idx(n2);
  auto build = [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      const uint64_t s0 = km[i] & mask_j;
      const uint64_t s1 = rc[i] & mask_j;
      const uint64_t r0 = revcomp64(s0, kj);
      const uint64_t r1 = revcomp64(s1, kj);
      const uint64_t j0 = s0 < r0 ? s0 : r0;
      const uint64_t j1 = s1 < r1 ? s1 : r1;
      keys[2 * i] = j0;
      keys[2 * i + 1] = j1;
      idx[2 * i] = (uint32_t)(2 * i) | (s0 == j0 ? kPol : 0u) |
                   (s0 == r0 ? kPal : 0u);
      idx[2 * i + 1] = (uint32_t)(2 * i + 1) | (s1 == j1 ? kPol : 0u) |
                       (s1 == r1 ? kPal : 0u);
    }
  };
  if (n > (1 << 20)) {
    std::thread th(build, n / 2, n);
    build(0, n / 2);
    th.join();
  } else {
    build(0, n);
  }
  radix_sort_u32p(keys, idx, 2 * kj);
  int64_t i = 0;
  while (i < n2) {
    int64_t j = i + 1;
    while (j < n2 && keys[j] == keys[i]) ++j;
    int nf = 0, nr = 0;
    bool has_pal = false;
    for (int64_t t = i; t < j; ++t) {
      const uint32_t v = idx[t];
      if (v & kPal) has_pal = true;
      if (v & kPol)
        ++nf;
      else
        ++nr;
    }
    if (has_pal) {
      for (int64_t t = i; t < j; ++t) pal_mark[idx[t] & kNodeMask] = 1;
    } else if (nf == 1 && nr == 1) {
      int64_t a = -1, b = -1;
      for (int64_t t = i; t < j; ++t) {
        if (idx[t] & kPol)
          a = (int64_t)(idx[t] & kNodeMask);
        else
          b = (int64_t)(idx[t] & kNodeMask);
      }
      if ((a >> 1) != (b >> 1)) {
        nxt_node[a] = b ^ 1;
        nxt_node[b] = a ^ 1;
      }
    }
    i = j;
  }
}

// Assemble kept chains into canonical packed unitig words.
// order/starts/ends: chain layout from pf_chain_rank (kept chains
// only); words: zero-filled off_w[nc] words; per-unitig layout is
// 32 LSB-first bases per word (SeqStore.from_codes).
void pf_assemble_unitigs(const int64_t* order, const int64_t* starts,
                         const int64_t* ends, int64_t nc, const uint64_t* km,
                         const uint64_t* rc, int32_t k, uint64_t* words,
                         const int64_t* off_w) {
  std::vector<uint8_t> buf, rbuf;
  for (int64_t c = 0; c < nc; ++c) {
    const int64_t s = starts[c], e = ends[c];
    const int64_t len = k + (e - s) - 1;
    buf.resize(len);
    const int64_t head = order[s];
    const uint64_t v0 = (head & 1) ? rc[head >> 1] : km[head >> 1];
    for (int32_t t = 0; t < k; ++t)
      buf[t] = (uint8_t)((v0 >> (2 * (k - 1 - t))) & 3);
    for (int64_t p = s + 1; p < e; ++p) {
      const int64_t node = order[p];
      const uint64_t v = (node & 1) ? rc[node >> 1] : km[node >> 1];
      buf[k + (p - s) - 1] = (uint8_t)(v & 3);
    }
    // canonical form: min(seq, revcomp)
    rbuf.resize(len);
    for (int64_t p = 0; p < len; ++p) rbuf[p] = (uint8_t)(3 - buf[len - 1 - p]);
    const uint8_t* src = buf.data();
    for (int64_t p = 0; p < len; ++p) {
      if (rbuf[p] != buf[p]) {
        if (rbuf[p] < buf[p]) src = rbuf.data();
        break;
      }
    }
    uint64_t* w = words + off_w[c];
    for (int64_t p = 0; p < len; ++p)
      w[p >> 5] |= ((uint64_t)src[p]) << (2 * (p & 31));
  }
}
}

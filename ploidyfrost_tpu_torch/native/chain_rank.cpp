// Copied from ploidyfrost_tpu/native/chain_rank.cpp.
// Chain ranking for unitig compaction (C ABI).
//
// Input: nxt[i] = successor node of i in the unitig-interior link graph
// (graph/construct._links_junctions), -1 = none. Nodes are (k-mer,
// orientation) pairs; every maximal chain is one unitig traversal.
//
// Output: `order` lists all nodes grouped by chain in walk order;
// `chain_start[j]` = 1 iff order[j] starts a new chain. Non-cycle
// chains are emitted in ascending head-node order (the same grouping
// the numpy pointer-doubling path produces); pure cycles are emitted
// afterwards, each started at its minimum node id — downstream
// assembly is chain-order-independent (the final unitig order is a
// separate lexicographic sort), only grouping and walk order matter.
//
// A sequential O(n) walk: the host pointer-doubling version
// (graph/construct._rank_chains) moves ~8 rounds x 100 MB of gather
// traffic at 12M nodes (~6 s); this loop touches each node twice.
// The walks are DRAM-latency-bound (~one miss per step), so each pass
// runs W-way interleaved cursors on each of T threads — W*T misses in
// flight; threads own disjoint head ranges, so all writes are disjoint.

#include <cstdint>
#include <thread>
#include <vector>

namespace {
// W-way interleaved chain walks: a single sequential walk is bound by
// one DRAM miss per step (~200 ns/node at 100M+ nodes); round-robin
// cursors over W independent chains keep W misses in flight.
constexpr int kWays = 32;
constexpr int kThreads = 2;

// Walk every chain whose head index lies in [h_lo, h_hi), interleaved
// kWays wide. Emit(ci, node) is called once per node in walk order.
template <typename Emit>
void walk_heads(const int64_t* nxt, const int64_t* heads, int64_t h_lo,
                int64_t h_hi, int64_t budget, Emit emit) {
  int64_t next_head = h_lo;
  int64_t cur[kWays];
  int64_t ci[kWays];
  for (int w = 0; w < kWays; ++w) cur[w] = -2;  // -2 = idle slot
  int live = 0;
  for (int w = 0; w < kWays && next_head < h_hi; ++w) {
    ci[w] = next_head;
    cur[w] = heads[next_head++];
    ++live;
  }
  while (live > 0) {
    for (int w = 0; w < kWays; ++w) {
      if (cur[w] < -1) continue;
      int64_t node = cur[w];
      if (node < 0) {
        if (next_head < h_hi) {
          ci[w] = next_head;
          cur[w] = heads[next_head++];
        } else {
          cur[w] = -2;
          --live;
        }
        continue;
      }
      if (--budget < 0) { live = 0; break; }  // corrupt-input guard
      emit(ci[w], node);
      cur[w] = nxt[node];
    }
  }
}

}  // namespace

extern "C" {

void pf_chain_rank(const int64_t* nxt, int64_t n, int64_t* order,
                   uint8_t* chain_start) {
  std::vector<uint8_t> has_prev(n, 0);
  {
    // split by source range; each thread fills a PRIVATE bitmap and
    // the results are OR-merged after join (concurrent plain stores to
    // the same byte, even of the same value, are UB under the C++
    // memory model — TSan would flag the former shared-array version)
    if (n > (1 << 20)) {
      std::vector<uint8_t> other(n, 0);
      auto mark = [&](uint8_t* dst, int64_t lo, int64_t hi) {
        for (int64_t i = lo; i < hi; ++i) {
          const int64_t j = nxt[i];
          if (j >= 0) dst[j] = 1;
        }
      };
      std::thread th(mark, other.data(), n / 2, n);
      mark(has_prev.data(), 0, n / 2);
      th.join();
      for (int64_t i = 0; i < n; ++i) has_prev[i] |= other[i];
    } else {
      for (int64_t i = 0; i < n; ++i) {
        const int64_t j = nxt[i];
        if (j >= 0) has_prev[j] = 1;
      }
    }
  }
  std::vector<int64_t> heads;
  heads.reserve(n / 4);
  for (int64_t i = 0; i < n; ++i)
    if (!has_prev[i]) heads.push_back(i);
  const int64_t nh = (int64_t)heads.size();
  const int nt = (n > (1 << 20) && nh >= 2 * kWays) ? kThreads : 1;

  // pass 1: chain lengths (threads own disjoint head ranges)
  std::vector<int64_t> lens(nh, 0);
  {
    auto pass1 = [&](int t) {
      walk_heads(nxt, heads.data(), nh * t / nt, nh * (t + 1) / nt, n,
                 [&](int64_t ci, int64_t) { ++lens[ci]; });
    };
    if (nt == 1) {
      pass1(0);
    } else {
      std::thread th(pass1, 1);
      pass1(0);
      th.join();
    }
  }
  // chain offsets in ascending head order
  std::vector<int64_t> offs(nh + 1, 0);
  for (int64_t h = 0; h < nh; ++h) offs[h + 1] = offs[h] + lens[h];

  std::vector<uint8_t> visited(n, 0);
  // pass 2: emit nodes (disjoint output ranges per thread)
  {
    auto pass2 = [&](int t) {
      // offs[ci] doubles as the chain's write cursor (advanced in
      // place; threads touch disjoint ci ranges, offs[nh] stays put)
      walk_heads(nxt, heads.data(), nh * t / nt, nh * (t + 1) / nt, n,
                 [&](int64_t ci, int64_t node) {
                   visited[node] = 1;
                   order[offs[ci]++] = node;
                 });
    };
    // chain starts from the (still-pristine) offsets, before pass2
    // advances them in place
    for (int64_t h = 0; h < nh; ++h) chain_start[offs[h]] = 1;
    if (nt == 1) {
      pass2(0);
    } else {
      std::thread th(pass2, 1);
      pass2(0);
      th.join();
    }
  }
  int64_t idx = offs[nh];
  // remaining unvisited nodes are pure cycles; ascending scan hits each
  // cycle first at its minimum node id
  for (int64_t i = 0; i < n; ++i) {
    if (visited[i]) continue;
    int64_t node = i;
    chain_start[idx] = 1;
    while (!visited[node]) {
      visited[node] = 1;
      order[idx++] = node;
      node = nxt[node];
    }
  }
}
}

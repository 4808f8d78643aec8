"""Smoke test of ploidyfrost_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py [--baseline-cu PATH] [--baseline-search-cu PATH]
                          [--baseline-em-cu PATH] [--baseline-nw-cu PATH] [--profile-multi]
                          [--several-cards-only]

Phases (any failure exits non-zero):
  1. build every CUDA kernel of the package from csrc/ (nvcc, sm_90a,
     one nvcc each, all at once); print, for each tile width T the
     search kernel is built for, its registers, local memory, shared
     memory a block and resident blocks a multiprocessor at the default
     stack cap and at MAX_STACK_CAP; the same of the EM kernel (kernel
     A, csrc/gmm_em.cu) at bench5m's n = 9,987 for g = 1..9 (with the
     launch's blocks and the multiprocessors they use) and at the wide
     fits the checks run, and of the NW kernel (kernel B,
     csrc/nw_wavefront.cu) at every tier 16..2048 (its path, cells a
     lane, warps a block, blocks and multiprocessors of a chunk);
  2. hold kernel K1 (canonical k-mer extraction) bit-exact against its
     plain torch version on the card, over random codes with Ns and
     other invalid codes: k in {1, 2, 5, 16, 17, 25, 31}, L from k to
     4100 and one read near MAX_READ_LEN, B from 1 to 16384 and a B that
     is no multiple of a tile's rows and one that gives each CTA several
     tiles, output offsets {0, 1, 7}; the fused valid count, accumulated
     over two calls, equal to the plain count; nothing written outside
     the slice; then the superbubble search kernel bit-exact against its
     plain version on the card at every tile width T, all five outputs,
     on the graph classes of tests/test_torch_search.py (genome-like,
     dense tangles, the circular cycle-exit graph) at the caps (ms,
     mstk, max_steps) of SEARCH_CAPS (the default, small ones that force
     overflow and unfinished lanes, ms = 1, mstk = MAX_STACK_CAP), every
     outcome class reached, on a seed count that is no multiple of any
     tile shape's seeds a block, and on an empty seed list; a seed
     outside the table raises ValueError on the card, and the kernel
     writes nothing past the ends of output buffers laid in sentinel-
     filled ones; the same check on bench5m's and multi3x5m's real seeds
     runs in phases 4 and 6, once their graphs exist; kernel A equal to
     its plain version (em_iterate_plain) on the card within 1e-12
     relative on variances, weights and ll, with the same iteration
     count, on the three golden frequency sets at g = 1..9, N = 0 and
     N = 1 at g = 1..3, g = 17, 33 and 64, g = 1600 (shared memory past
     48 KB), g = 5000 (the state in the workspace), a NaN weight, and
     two runs bit-identical (bench5m's
     and multi3x5m's frequencies follow in phases 4 and 6); kernel B
     against its plain version (_wavefront) on the card and the native
     kernel, every de-skewed window equal, on synthetic pairs of every
     tier (dashes in A, an empty A, full-length rows), and whether the
     whole buffers agree, then whole buffers equal at widths the tiers
     do not use (17, 40, 100, 300, 511, 513, 700: both sides of the
     register path's limit, odd chunks);
  3. golden: regenerate the single_diploid reads (100 kb diploid, k=25)
     and run the port's `pipeline` on the card: cutoffs (10, 37), the 12
     output tables byte-identical to tests/golden/single_diploid, the
     model result equal to 6 significant digits, ploidy 2;
  4. real size: the bench5m read set (5 Mbp diploid, 1% het, 150 bp
     reads at 25x, seed 7) through `pipeline` on the card, ploidy 2, with
     the native host libraries that loaded (graph construction must),
     per-stage wall times, K1's launches on that run, peak device
     memory, the search kernel's launches on that run; the search
     kernel at bench5m's seeds: median and min-max a launch (bare at the
     default T and at every T, and through search_batched), with
     --baseline-search-cu an earlier search source with the C ABI that
     has no word and no tile arguments (seeds, S, succ, n, ms, mstk,
     max_steps, five outputs, stream) built and timed in turns
     (baseline, kernel, kernel, baseline), the plain version's time,
     search_seeds end to end, the bound, the longest seed's DFS steps,
     the dependent-load latency on the card and the latency floor;
     then K1 at the main path's batch shape: the per-launch
     median and min-max of the bare kernel and of the main-path call
     (with the fused count), against its bound and its plain version's
     time, K1 back to back in a CUDA graph, and, with --baseline-cu, an
     earlier K1 source with the C ABI (codes, B, L, k, out, stream)
     built and timed in the same call, in turns; and a profiler trace
     of one counter batch, which must hold exactly one kernel, K1; kernel
     A on bench5m's frequencies at g = 1..9: equal to the plain version,
     then timed a fit (CUDA events, L2 scrubbed, in turns with the plain
     version and, with --baseline-em-cu, an earlier EM source with the
     same C ABI, its result held to the kernel's: plain, kernel,
     baseline, kernel, baseline, plain) with its bound (passes x the
     larger of 8 bytes a point at 3.35 TB/s and 13 g + 2 fp64 operations
     a point at 34 TFLOP/s), a grid barrier and one pass measured apart,
     and the latency floor (launch + (count + 1) x (one pass + one
     barrier));
  5. colored golden: regenerate the multi_colored reads (3 diploid
     samples of one 60 kb genome, k=25) and run the colored path on the
     card: count, filter, union, color_graph, the .bfg_colors writer and
     reader, `run -f -C`, `model`: cutoffs (10, 39), (10, 41), (10, 37),
     the 12 tables byte-identical to tests/golden/multi_colored, the
     model result equal to 6 significant digits, ploidy 2;
  6. multi-sample at a real size, "multi3x5m": the same generator at
     5 Mbp (3 samples, 0.3% het a sample, 150 bp reads, 14 passes a
     haplotype, seed 7; about 118 M k-mer instances a sample) through
     `pipeline-multi` on the card: ploidy 2, K1 launched, every stage's
     seconds, the wall, cutoffs, unitigs, colors, bubbles, peak memory;
     the search kernel bit-exact and timed at its seeds as in phase 4;
     kernel A equal to its plain version on its frequencies;
  7. the two torch programs on the card: `build` of the bench5m reads
     with and without --device-build (byte-identical GFA; the link step
     timed both ways on that k-mer set, in turns), and
     kmer/countdb.lookup_device against KmerCountDB.lookup on the
     bench5m table with about 10 M queries, half of them reverse
     complements and a tenth absent (counts and hits equal, both timed);
  8. post-processing on the card's outputs: `filter` (defaults, and
     with -l/-u from the cutoffs) then `model` on the filtered
     frequencies for the single_diploid outputs of phase 3 and the
     bench5m outputs of phase 4, `filter-multi` then `model` for the
     multi_colored outputs of phase 5, ploidy 2 each time; the tables
     half of `figures` on bench5m's prefix with the GMM fits on the card
     and on the CPU (_site_stats.tsv byte-equal, _loglikelihood.tsv
     equal to 6 significant digits, `ll_curves` timed on both); the PNG
     files where matplotlib imports, else `drawfreq` must fail with its
     one line and code 1;
  9. the NW wavefront on the card: the indel_dense read set (1 Mbp
     tetraploid, about 900 indels; tests/test_golden_indel.py) through
     `pipeline` on the card (12 tables byte-identical to
     tests/golden/indel_dense, cutoffs (10, 83), ploidy 4) with a hook
     that records the pairs its analysis hands to
     needleman_wunsch_batch (570; bench5m, whose bubbles are SNPs,
     hands it 132 in phase 4, recorded the same way); those pairs (at
     most 2000) and synthetic pairs of every tier
     from 16 to 2048, some with '-' in A, and one pair above the largest
     tier, through nw_matrices_batched on the card, bit-exact against
     the native kernel and against the numpy wavefront (the device
     engine is kernel B); kernel B against its plain version chunk by
     chunk on the real pairs (windows equal, whole buffers reported) and
     timed a chunk in turns with the plain version (and, with
     --baseline-nw-cu, an earlier NW source with the same C ABI, its
     buffers held equal), with its bound (codes in and flags out at 3.35
     TB/s against 20 integer operations a cell); the three engines timed
     on the real pairs; one chunk under the profiler in a fresh process,
     exactly one kernel; then `run` on that
     graph with the native NW library withheld for that call, under
     PLOIDYFROST_TRACE: the same 12 tables, ENGINE_CALLS["device"] > 0
     and ["numpy"] == 0, NW_LAUNCHES > 0, CUDA kernels in both phase
     traces;
 10. tracing: the single_diploid `run` under PLOIDYFROST_TRACE (both
     phase traces written, CUDA kernels in findSuperBubble.json; its
     sites pass is host code while the native NW kernel runs, so
     ploidyEstimation.json holds kernels only in phase 9's run); then
     bench5m's superbubble search under the profiler: its kernels (the
     search kernel must be among them, no reduction kernel may be) and
     the card's busy share of it; then bench5m's nine GMM fits under the
     profiler: exactly nine EM kernels, no other kernel, no memset, and
     at most two copies a fit (parameters in, result out), whatever the
     iterations;
 11. several cards (parallel/): the visible card count; (a) a one-rank
     NCCL group on cuda:0: ShardedKmerCounter over bench5m's reads with
     the table, histogram and instance count of KmerCounter on the same
     batches, in turns (single, sharded, sharded, single), each with its
     count + finalize wall, its finalize alone (the last flush, the
     reduction, the table to the host), its peak device memory above
     what was allocated before (reset before each), its K1 launches and
     the sharded flushes (key bytes, route + merge seconds); the GMM
     fits on bench5m's frequencies (gauss 1..9) through the group equal
     to the single-device fits (difference 0), both sides through kernel
     A (one launch a fit on one device; a pass and an update an
     iteration through the group); the superbubble search through the
     group equal to search_seeds and the bubbles equal, the search
     kernel launched through the group; `pipeline` on bench5m through the
     group (run_pipeline_cli with the group): every file byte-identical
     to phase 4's, K1, the search and the EM kernel launched; (b) with
     two or more cards, `pipeline --devices=N` on bench5m and
     `pipeline-multi --devices=N` on multi3x5m, N = min(4, cards), as a
     user runs them (python -m ploidyfrost_tpu_torch.cli), in turns
     with `--devices=1` in the same call (bench5m 1, N, N, 1; multi3x5m
     1, N): every file byte-identical to the one-card run's, ploidy 2,
     every rank's line printed (K1 and search launches, none 0, EM
     launches at least nine; peak
     device memory; seconds from process start to group join; stage
     seconds, the ranks other than 0 with no graph and no sites pass),
     and the wall that rank 0's start-to-join and stages do not cover;
     with one card, one line that says the run on several cards was not
     possible here; (c) with four or more cards, the multi-host entry
     point as two hosts run it: two `python -m ploidyfrost_tpu_torch.cli
     ... --devices=4` processes, CUDA_VISIBLE_DEVICES 0,1 and 2,3,
     PLOIDYFROST_COORDINATOR on a free local port, one NCCL group of
     four ranks, process 1 started first in an empty directory of its
     own: `pipeline` on bench5m and `pipeline-multi` on multi3x5m, every
     file byte-identical to (b)'s `--devices=1` files, ploidy 2, four
     rank lines with K1, search and EM launches (EM at least nine),
     process 1's directory empty, both walls beside (b)'s, every rank's
     start-to-join and peak device MiB, rank 0's finalize (its `recv`s
     across the process boundary) and the NCCL transports named in
     NCCL's INFO logs; then `pipeline` again with PLOIDYFROST_TIMEOUT=120
     and process 1 in a session of its own, killed whole (SIGKILL to its
     process group) once rank 0 has printed its cutoffs: process 0 must
     exit non-zero within 180 s of the kill, and no process of either
     side may be left (by pid and by nvidia-smi --query-compute-apps);
     with fewer than four cards, one line that says so.
     `--several-cards-only` runs (b) and (c) alone, for a call on four
     cards.

Phases 1-10 run on one card (PLOIDYFROST_DEVICES=1 for the CLI calls),
whatever the machine holds. All five native host libraries must load.
Every check that reads a profiler trace (phases 4, 9 and 10) runs in a
fresh process of its own (in_fresh_process).
Every pipeline path (phases 3-6 and 9) and the one-rank group's search
must launch K1 and the search kernel, and the EM kernel at least once a
fit (nine); every launch counter is set to 0 just before each path.

The line before the last is the kernel table as one JSON object (K1,
the search, kernel A and kernel B); the
last line is {"ok": true, "device": {...}}. Without a CUDA device, or
without the package beside it, the script exits non-zero and prints no
result. It never imports jax or ploidyfrost_tpu.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import shutil
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, ".smoke_work")
GOLD = os.path.join(ROOT, "tests", "golden", "single_diploid")
GOLD_COLORED = os.path.join(ROOT, "tests", "golden", "multi_colored")
GOLD_INDEL = os.path.join(ROOT, "tests", "golden", "indel_dense")
COLORED_CUTOFFS = [(10, 39), (10, 41), (10, 37)]
GOLD_FILES = [
    "Unitig_Id", "super_bubble", "alignseq", "bicov", "bifre", "tricov",
    "trifre", "tetracov", "tetrafre", "pentacov", "pentafre",
    "allele_frequency",
]


def log(msg: str):
    print(msg, flush=True)


def make_golden_reads(path: str):
    """The single_diploid read set (tests/test_golden.py make_reads)."""
    rng = np.random.default_rng(42)
    G = 100_000
    g1 = rng.integers(0, 4, G)
    g2 = g1.copy()
    snp = rng.random(G) < 0.004
    g2[snp] = (g2[snp] + rng.integers(1, 4, snp.sum())) % 4
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    h1 = bases[g1].tobytes().decode()
    h2l = list(bases[g2].tobytes().decode())
    for pos in rng.integers(1000, G - 1000, 20):
        if rng.random() < 0.5:
            h2l[pos:pos] = ["ACGT"[rng.integers(0, 4)] for _ in range(rng.integers(1, 4))]
        else:
            del h2l[pos : pos + int(rng.integers(1, 4))]
    h2 = "".join(h2l)
    with open(path, "w") as f:
        n = 0
        for hap in (h1, h2):
            for _ in range(14):
                for s in rng.integers(0, len(hap) - 150, len(hap) // 150):
                    n += 1
                    f.write(f">r{n}\n{hap[s:s+150]}\n")


def make_bench5m_reads(path: str, genome_bp: int = 5_000_000, het: float = 0.01,
                       depth: int = 25):
    """The bench5m read set (bench.py _write_bench5m_reads): two
    haplotypes, 150 bp reads at `depth` total, seed 7."""
    rng = np.random.default_rng(7)
    g1 = rng.integers(0, 4, genome_bp).astype(np.uint8)
    g2 = g1.copy()
    snp = rng.random(genome_bp) < het
    g2[snp] = (g2[snp] + rng.integers(1, 4, snp.sum())) % 4
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    L = 150
    n_per_hap = depth * genome_bp // (2 * L)
    with open(path, "w") as f:
        n = 0
        for hap in (g1, g2):
            starts = rng.integers(0, genome_bp - L, n_per_hap)
            for s in starts:
                n += 1
                f.write(f">r{n}\n" + bases[hap[s : s + L]].tobytes().decode() + "\n")


def make_sample_reads(d: str, genome_bp: int) -> list[str]:
    """Three diploid samples of one shared genome, 0.3% het SNPs a
    sample, 150 bp reads, 14 passes a haplotype, seed 7: at 60 kb the
    multi_colored read set (tests/test_golden_colored.py
    make_sample_reads), at 5 Mbp the multi3x5m one."""
    rng = np.random.default_rng(7)
    G = genome_bp
    g1 = rng.integers(0, 4, G)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    paths = []
    for s in range(3):
        h1 = g1.copy()
        h2 = g1.copy()
        snp = rng.random(G) < 0.003
        h2[snp] = (h2[snp] + rng.integers(1, 4, snp.sum())) % 4
        path = os.path.join(d, f"s{s}.fa")
        with open(path, "w") as f:
            n = 0
            for hap in (h1, h2):
                seq = bases[hap].tobytes().decode()
                for _ in range(14):
                    for st in rng.integers(0, G - 150, G // 150):
                        n += 1
                        f.write(f">r{n}\n{seq[st:st+150]}\n")
        paths.append(path)
    return paths


def make_indel_reads(path: str):
    """The indel_dense read set (tests/test_golden_indel.py
    make_indel_reads): 1 Mbp tetraploid, shared variant positions, about
    300 scattered 1-6 bp indels a derived haplotype and 8 clustered
    indel runs, 18 passes a haplotype, seed 13."""
    rng = np.random.default_rng(13)
    G = 1_000_000
    g0 = rng.integers(0, 4, G)
    var_pos = np.flatnonzero(rng.random(G) < 0.006)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    haps = [bases[g0].tobytes().decode()]
    for _ in range(3):
        g = g0.copy()
        hit = var_pos[rng.random(len(var_pos)) < 0.6]
        g[hit] = (g[hit] + rng.integers(1, 4, len(hit))) % 4
        hl = list(bases[g].tobytes().decode())
        for pos in sorted(rng.integers(1000, G - 1000, 300), reverse=True):
            ln = int(rng.integers(1, 7))
            if rng.random() < 0.5:
                hl[pos:pos] = ["ACGT"[rng.integers(0, 4)] for _ in range(ln)]
            else:
                del hl[pos : pos + ln]
        for base_pos in sorted(rng.integers(5000, G - 5000, 8), reverse=True):
            for _ in range(int(rng.integers(3, 6))):
                pos = base_pos + int(rng.integers(0, 60))
                if rng.random() < 0.5:
                    hl[pos:pos] = ["ACGT"[rng.integers(0, 4)]]
                else:
                    del hl[pos : pos + 1]
        haps.append("".join(hl))
    with open(path, "w") as f:
        n = 0
        for hap in haps:
            for _ in range(18):
                for s in rng.integers(0, len(hap) - 150, len(hap) // 150):
                    n += 1
                    f.write(f">r{n}\n{hap[s:s+150]}\n")


# the earlier sources a call may time in turns with a kernel: flag, library
BASELINES = {"k1": "libk1_baseline.so", "search": "libsearch_baseline.so",
             "em": "libgmm_em_baseline.so", "nw": "libnw_baseline.so"}


def build_kernels(baselines: dict):
    """Build every csrc/*.cu at once (one nvcc each), the earlier sources
    in `baselines` ({key of BASELINES: path}), and the dependent-load
    probe, into WORK; return (seconds, {key: baseline lib}, probe lib)."""
    from concurrent.futures import ThreadPoolExecutor

    from ploidyfrost_tpu_torch.kmer import extract

    def nvcc(src, name):
        lib = os.path.join(WORK, name)
        subprocess.run([extract._nvcc(), *extract.NVCC_FLAGS, "-o", lib, src],
                       check=True, capture_output=True, text=True, timeout=600)
        return lib

    probe_src = os.path.join(WORK, "load_latency.cu")
    with open(probe_src, "w") as f:
        f.write(LOAD_LATENCY_CU)
    names = sorted(f[:-3] for f in os.listdir(extract.CSRC) if f.endswith(".cu"))
    t0 = time.time()
    with ThreadPoolExecutor(max_workers=len(names) + len(baselines) + 1) as pool:
        base = {key: pool.submit(nvcc, src, BASELINES[key]) for key, src in baselines.items()}
        probe = pool.submit(nvcc, probe_src, "libload_latency.so")
        libs = list(pool.map(extract.build, names))
        base_libs = {key: f.result() for key, f in base.items()}
        probe_lib = probe.result()
    for name, lib in zip(names, libs):
        log(f"built {name} -> {os.path.relpath(lib, ROOT)}")
    for key, src in baselines.items():
        log(f"built the baseline {key} kernel from {src}")
    return time.time() - t0, base_libs, probe_lib


# One thread follows a chain of dependent 4-byte loads, each into a
# 32-byte sector of its own: the latency of one dependent global read, as
# a DFS step of the search kernel waits for it.
LOAD_LATENCY_CU = r"""
#include <cuda_runtime.h>
__global__ void chase(const int* __restrict__ next, int steps, int* __restrict__ out) {
  int i = 0;
  for (int s = 0; s < steps; ++s) i = __ldg(next + i);
  *out = i;
}
extern "C" int pf_chase(const int* next, int steps, int* out, void* stream) {
  chase<<<1, 1, 0, (cudaStream_t)stream>>>(next, steps, out);
  return (int)cudaGetLastError();
}
"""


def load_latency_us(probe_lib: str, sectors: int = 1 << 17, steps: int = 20000) -> dict:
    """Microseconds a dependent load: the chase kernel over a random cycle
    through `sectors` 32-byte sectors (4 MB, the size of a real graph's
    successor table), cold (L2 scrubbed before each run: every load a
    first touch) and warm (the same chain again, from L2)."""
    import torch

    from ploidyfrost_tpu_torch.kmer.extract_bench import event_times, scrub_buffer

    rng = np.random.default_rng(3)
    order = rng.permutation(sectors) * 8  # int index of each sector's first word
    nxt = np.zeros(sectors * 8, np.int32)
    nxt[order] = np.roll(order, -1)  # one cycle through every sector; index 0 is on it
    nxt_t = torch.from_numpy(nxt).cuda()
    out = torch.zeros(1, dtype=torch.int32, device="cuda")
    fn = ctypes.CDLL(probe_lib).pf_chase
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        if fn(nxt_t.data_ptr(), steps, out.data_ptr(), stream):
            raise RuntimeError("chase launch failed")

    cold = min(event_times(run, 5, scrub_buffer()))
    run()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    run()
    b.record()
    b.synchronize()
    return {"cold_us": cold * 1e3 / steps, "warm_us": a.elapsed_time(b) * 1e3 / steps}


def check_extract() -> tuple[int, int]:
    """K1 against its plain version on the card; returns (max |diff|,
    cases)."""
    import torch

    from ploidyfrost_tpu_torch.kmer import extract
    from ploidyfrost_tpu_torch.kmer.extract_bench import random_codes
    from ploidyfrost_tpu_torch.kmer.pack import SENTINEL

    Bs = (1, 3, 257, 1000, 16384, 16381)  # 16381: no multiple of a tile's rows
    cases = []  # (k, B, L, offset)
    for i, k in enumerate((1, 2, 5, 16, 17, 25, 31)):
        for j, L in enumerate(sorted({k, k + 1, 40, 64, 151, 160, 4100})):
            if L >= k:
                B = min(Bs[(i + j) % len(Bs)], max(1, 4_000_000 // L))
                cases.append((k, B, L, (0, 1, 7)[(i + j) % 3]))
        cases.append((k, 2, extract.MAX_READ_LEN - 3 * k, (1, 7)[i % 2]))
    for k in (1, 25, 31):
        for j, B in enumerate(Bs):
            cases.append((k, B, 160, (0, 1, 7)[j % 3]))
    cases.append((25, 65536, 160, 1))  # several tiles a CTA: the double buffer
    worst = 0
    for c, (k, B, L, off) in enumerate(cases):
        dev = random_codes(B, L, seed=c)
        dev[::7, : L // 2] = 4
        dev[B // 2] = 4  # an all-invalid row
        n = L - k + 1
        out = torch.full((off + B * n + 11,), -5, dtype=torch.int64, device="cuda")
        count = torch.zeros((), dtype=torch.int64, device="cuda")
        extract.extract_canonical_into(dev, k, out, off, count=count)
        fresh = extract.extract_canonical_into(dev, k, out, off)
        extract.extract_canonical_into(dev, k, out, off, count=count)
        torch.cuda.synchronize()
        ref = extract.extract_canonical_plain(dev, k)
        got = out[off : off + B * n]
        where = f"k={k} B={B} L={L} offset={off}"
        if not torch.equal(got, ref):
            raise AssertionError(f"K1 differs from plain at {where}: {int((got != ref).sum())} keys")
        if int((out[:off] != -5).sum()) or int((out[off + B * n :] != -5).sum()):
            raise AssertionError(f"K1 wrote outside its slice at {where}")
        want = int((ref != SENTINEL).sum())
        if int(count) != 2 * want or int(fresh) != want:
            raise AssertionError(f"K1 valid count {int(count)}/{int(fresh)} != plain {want} at {where}")
        if not bool((got[n * (B // 2) : n * (B // 2 + 1)] == SENTINEL).all()):
            raise AssertionError(f"all-invalid row produced keys at {where}")
        worst = max(worst, int((got - ref).abs().max()) if got.numel() else 0)
    return worst, len(cases)


def time_extract(baseline_lib: str | None, B=16384, L=160, k=25, reps=200) -> dict:
    """K1 at the main path's batch shape, timed per launch with CUDA
    events and L2 scrubbed: the bare kernel, the main-path call (the
    wrapper with the fused count), the plain version, and the baseline
    K1 if built, in turns with K1 (baseline, K1, K1, baseline); the
    host time of the main-path call; K1 back to back in a CUDA graph;
    and two yardsticks timed the same way."""
    import torch

    from ploidyfrost_tpu_torch.kmer import extract
    from ploidyfrost_tpu_torch.kmer.extract_bench import (
        bound_ms, event_times, graph_ms, host_us, random_codes, scrub_buffer, spread)
    from ploidyfrost_tpu_torch.kmer.pack import SENTINEL

    codes = random_codes(B, L, seed=1)
    n = L - k + 1
    out = torch.empty(B * n, dtype=torch.int64, device="cuda")
    count = torch.zeros((), dtype=torch.int64, device="cuda")
    scrub = scrub_buffer()
    stream = torch.cuda.current_stream().cuda_stream

    def bare():
        extract.launch(codes, k, out, count)

    def main_path():
        extract.extract_canonical_into(codes, k, out, 0, count=count)

    def plain():
        out.copy_(extract.extract_canonical_plain(codes, k))
        count.add_((out != SENTINEL).sum())

    runs = {"ms": [], "main_ms": [], "baseline_ms": []}
    base = None
    if baseline_lib:
        fn = ctypes.CDLL(baseline_lib).pf_extract_canonical
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int

        def base():
            if fn(codes.data_ptr(), B, L, k, out.data_ptr(), stream):
                raise RuntimeError("baseline K1 launch failed")

    def rotating():
        # four (codes, out) sets, 82 MB together: more than L2 holds
        sets = [(random_codes(B, L, seed=10 + i), torch.empty_like(out)) for i in range(4)]
        return [lambda c=c, o=o: extract.launch(c, k, o, count) for c, o in sets]

    before = extract.LAUNCHES
    half = reps // 2
    for name, f in (("baseline_ms", base), ("ms", bare), ("main_ms", main_path),
                    ("ms", bare), ("main_ms", main_path), ("baseline_ms", base)):
        if f is not None:
            runs[name] += event_times(f, half, scrub)
    plain_ms = spread(event_times(plain, max(reps // 10, 5), scrub))[0]
    res = {"plain_ms": plain_ms, "main_host_us": host_us(main_path),
           "graph_ms": graph_ms(rotating(), reps),
           # yardsticks under the same timing: torch writing the same
           # output bytes (no input, no arithmetic), and a one-element
           # kernel (the cost of a launch between two events)
           "fill_ms": spread(event_times(lambda: out.fill_(0), reps, scrub))[0],
           "launch_ms": spread(event_times(lambda: count.fill_(0), reps, scrub))[0]}
    extract.LAUNCHES = before  # timing launches are not the main path's
    res["bound_ms"], res["bound_by"] = bound_ms(B, L, k)
    for name, times in runs.items():
        if times:
            res[name] = spread(times)
    return res


# (ms, mstk, max_steps) of the search kernel's checks: the default caps,
# then small ones that force seen and stack overflow and lanes that run
# out of steps, one seen slot, and the largest stack the kernel takes
SEARCH_CAPS = [(32, 48, 192), (8, 8, 1), (8, 8, 2), (8, 8, 16), (16, 12, 64), (32, 48, 1),
               (32, 48, 2), (1, 8, 16), (1, 48, 192), (32, 1024, 192)]
SEARCH_OUTPUTS = ("status", "psec", "nseen", "seen", "cyc")


def search_attributes():
    """Phase 1: the compiled search kernel of every tile width at the
    default stack cap and at MAX_STACK_CAP."""
    from ploidyfrost_tpu_torch.bubble import batched

    default = batched.kernel_attributes()["tile"]
    for tile in batched.TILES:
        for mstk in (batched.MAX_STACK, batched.MAX_STACK_CAP):
            a = batched.kernel_attributes(tile, mstk)
            log(f"search kernel T={tile}{' (default)' if tile == default else ''} mstk={mstk}: "
                f"{a['registers']} registers and {a['local_bytes']} bytes of local memory a "
                f"thread, {a['shared_bytes']} bytes of shared memory a block of {a['threads']} "
                f"threads ({a['seeds']} seeds), {a['blocks_per_sm']} blocks resident a "
                "multiprocessor")
    return default


def _search_graphs():
    """The random graph classes of tests/test_torch_search.py, built by
    the port: genome-like graphs with het SNPs, dense random tangles,
    and a circular genome whose bubble exit loops back to its entrance."""
    from ploidyfrost_tpu_torch.graph.construct import _canon_np, build_graph_from_kmers
    from ploidyfrost_tpu_torch.kmer.pack import string_kmers_np

    bases = np.frombuffer(b"ACGT", dtype=np.uint8)

    def kmers_of(seqs, k):
        return np.unique(np.concatenate([_canon_np(string_kmers_np(x, k), k) for x in seqs]))

    def genome(seed, k, snp, G=20000, nhap=3):
        rng = np.random.default_rng(seed)
        g1 = rng.integers(0, 4, G)
        haps = [g1]
        for _ in range(nhap - 1):
            g2 = g1.copy()
            m = rng.random(G) < snp
            g2[m] = (g2[m] + rng.integers(1, 4, m.sum())) % 4
            haps.append(g2)
        return kmers_of([bases[h].tobytes().decode() for h in haps], k)

    graphs = []
    for seed in range(4):
        k = 11 + seed
        graphs.append((f"genome{seed}", build_graph_from_kmers(genome(seed, k, 0.01 + 0.01 * seed), k)))
    for seed in range(4):
        rng = np.random.default_rng(seed)
        k = int(rng.integers(5, 8))
        km = np.unique(rng.integers(0, 4**k, int(4**k * 0.3)).astype(np.uint64))
        graphs.append((f"tangle{seed}", build_graph_from_kmers(np.unique(_canon_np(km, k)), k)))
    rng = np.random.default_rng(7)
    g1 = rng.integers(0, 4, 220)
    g2 = g1.copy()
    g2[110] = (g2[110] + 1) % 4
    graphs.append(("circular", build_graph_from_kmers(
        kmers_of([bases[h].tobytes().decode() * 2 for h in (g1, g2)], 25), 25)))
    return graphs


def _same_outputs(got, want, seeds: int, where: str) -> int:
    """All five search outputs equal in dtype, shape and every value;
    returns the largest |difference| (0)."""
    import torch

    worst = 0
    for name, a, b in zip(SEARCH_OUTPUTS, got, want):
        if a.numel() and a.shape == b.shape:
            worst = max(worst, int((a.long() - b.long()).abs().max()))
        if a.dtype != b.dtype or a.shape != b.shape or not torch.equal(a, b):
            bad = int((a != b).reshape(seeds, -1).any(1).sum()) if a.shape == b.shape else -1
            raise AssertionError(f"search kernel {name} differs from plain at {where}: "
                                 f"{a.dtype} {tuple(a.shape)} vs {b.dtype} {tuple(b.shape)}, "
                                 f"{bad} seeds differ")
    return worst


def _search_same(seeds: np.ndarray, succ: np.ndarray, caps, where: str):
    """The search kernel at every tile width, and the dispatcher at its
    default, against the plain version on the card, on the same inputs;
    the largest nseen from the launch's word equal to the plain one.
    Returns the outcome counts and the largest |difference| (0)."""
    import collections

    import torch

    from ploidyfrost_tpu_torch.bubble import batched

    seeds_t = torch.from_numpy(np.asarray(seeds, dtype=np.int32)).cuda()
    succ_t = torch.from_numpy(np.ascontiguousarray(succ, dtype=np.int32)).cuda()
    want = batched.search_batched_plain(seeds_t, succ_t, *caps)
    want_max = int(want[2].max()) if len(seeds) else 0
    worst = _same_outputs(batched.search_batched(seeds_t, succ_t, *caps), want, len(seeds),
                          f"{where}, default tile")
    for tile in batched.TILES:
        got, nseen_max = batched._search(seeds_t, succ_t, *caps, tile=tile)
        torch.cuda.synchronize()
        worst = max(worst, _same_outputs(got, want, len(seeds), f"{where}, T={tile}"))
        if nseen_max != want_max:
            raise AssertionError(f"search kernel's largest nseen {nseen_max} != {want_max} at "
                                 f"{where}, T={tile}")
    return collections.Counter(want[0].cpu().tolist()), worst


def _search_bad_seed(g):
    """A seed outside the table: the dispatcher raises ValueError on the
    card; at every tile width the launch counts it in its word, writes
    nothing for it, writes the other seeds' outputs as the plain version
    does, and nothing past the ends of outputs laid at offset 8 inside
    sentinel-filled buffers."""
    import torch

    from ploidyfrost_tpu_torch.bubble import batched

    good = batched.canonical_seeds(g)[:60]
    S, n2, ms = len(good) + 2, 2 * len(g), batched.MAX_SEEN
    seeds = np.concatenate([good[:20], [n2], good[20:], [-2]]).astype(np.int32)
    seeds_t = torch.from_numpy(seeds).cuda()
    succ_t = torch.from_numpy(np.ascontiguousarray(g._succ, dtype=np.int32)).cuda()
    for bad in (seeds_t, seeds_t[20:21]):
        try:
            batched.search_batched(bad, succ_t)
        except ValueError:
            pass
        else:
            raise AssertionError(f"search_batched took seeds outside [0, {n2}) on the card")
    keep = torch.from_numpy((seeds >= 0) & (seeds < n2)).cuda()
    want = batched.search_batched_plain(seeds_t[keep], succ_t)
    before = batched.SEARCH_LAUNCHES
    for tile in batched.TILES:
        widths = (1, 1, 1, ms, 1)
        fill = (0xA5, -7, 0xA5, -7, -7)
        bufs = [torch.full(((S + 16) * w,), f, dtype=d, device="cuda") for d, w, f in zip(
            (torch.uint8, torch.int32, torch.uint8, torch.int32, torch.int32), widths, fill)]
        outs = [b[8 * w : (8 + S) * w].view(S, w) if w > 1 else b[8 : 8 + S]
                for b, w in zip(bufs, widths)]
        word = torch.full((2,), -1, dtype=torch.int32, device="cuda")
        batched._launch(seeds_t, succ_t, ms, batched.MAX_STACK, batched.MAX_STEPS, outs, word,
                        tile)
        torch.cuda.synchronize()
        if word[0].item() != 2:
            raise AssertionError(f"T={tile}: the word counts {word[0].item()} seeds outside "
                                 "the table, not 2")
        for b, o, w, f in zip(bufs, outs, widths, fill):
            if not (bool((b[: 8 * w] == f).all()) and bool((b[(8 + S) * w :] == f).all())):
                raise AssertionError(f"T={tile}: the search kernel wrote past an output's ends")
            if not bool((o[~keep] == f).all()):
                raise AssertionError(f"T={tile}: the search kernel wrote a bad seed's output")
        _same_outputs([o[keep] for o in outs], want, S - 2, f"the good seeds beside bad ones, T={tile}")
    batched.SEARCH_LAUNCHES = before


def check_search() -> tuple[int, int]:
    """The search kernel against its plain version on the card over the
    graph classes at every cap set of SEARCH_CAPS, on 97 and 1 seeds
    (97 is no multiple of any tile shape's seeds a block), on an empty
    seed list, and with seeds outside the table; returns (cases, largest
    |difference|)."""
    import collections

    from ploidyfrost_tpu_torch.bubble import batched

    outcomes = collections.Counter()
    cases = worst = 0
    graphs = _search_graphs()
    for name, g in graphs:
        seeds = batched.canonical_seeds(g)
        for caps in SEARCH_CAPS:
            stats, err = _search_same(seeds, g._succ, caps, f"{name} caps {caps}")
            outcomes += stats
            worst = max(worst, err)
            cases += 1
    name, g = graphs[0]
    seeds = batched.canonical_seeds(g)
    for S in (97, 1):
        stats, err = _search_same(seeds[:S], g._succ, SEARCH_CAPS[0], f"{name}'s first {S} seeds")
        worst = max(worst, err)
        cases += 1
    _search_same(np.zeros(0, np.int32), g._succ, SEARCH_CAPS[0], "an empty seed list")
    _search_bad_seed(g)
    missing = {batched.STAT_NONE, batched.STAT_STALL_CYCLE, batched.STAT_CYCLE_EXIT,
               batched.STAT_ABORT, batched.STAT_BUBBLE, batched.STAT_OVERFLOW} - set(outcomes)
    if missing:
        raise AssertionError(f"the search cases never reached outcomes {sorted(missing)}")
    log(f"phase 2: search kernel bit-exact against its plain version at T in {batched.TILES} "
        f"and through the dispatcher on {cases + 1} cases each ({len(graphs)} graphs x "
        f"{len(SEARCH_CAPS)} cap sets, 97 and 1 seeds, an empty seed list); outcomes "
        f"{dict(sorted(outcomes.items()))}; seeds outside the table raise ValueError, are "
        "counted in the launch's word, and no output is written for them or past its ends")
    return cases + 1, worst


def check_search_real(gfa: str, name: str) -> tuple[int, int]:
    """The search kernel at every tile width against its plain version on
    a real graph's seeds, at the default caps and at small ones; returns
    (cases, largest |difference|)."""
    from ploidyfrost_tpu_torch.bubble import batched
    from ploidyfrost_tpu_torch.graph.cdbg import CDBGraph

    g = CDBGraph.from_gfa(gfa)
    seeds = batched.canonical_seeds(g)
    caps = [SEARCH_CAPS[0], (8, 8, 16)]
    res = [_search_same(seeds, g._succ, c, f"{name} caps {c}") for c in caps]
    log(f"search kernel bit-exact against its plain version at T in {batched.TILES} on {name}'s "
        f"{len(seeds)} seeds ({len(g)} unitigs) at caps {caps}: outcomes "
        f"{[dict(sorted(x.items())) for x, _ in res]}")
    return len(caps), max(err for _, err in res)


def time_search(gfa: str, name: str, baseline_lib: str | None, reps: int = 60) -> dict:
    """The search kernel at a real graph's seeds, per launch with CUDA
    events and L2 scrubbed: the bare launch at the default tile width and
    the baseline kernel (the C ABI without word and tile) if built, in
    turns (baseline, kernel, kernel, baseline), the main-path call
    (search_batched, its word read back), then every tile width in
    turns; the plain version
    once, with the DFS steps and the longest seed's; search_seeds end to
    end (its copies in and out included, no replay); a one-element
    kernel under the same timing (the launch floor); the bound from this
    run's bytes and DFS steps."""
    import torch

    from ploidyfrost_tpu_torch.bubble import batched
    from ploidyfrost_tpu_torch.graph.cdbg import CDBGraph
    from ploidyfrost_tpu_torch.kmer.extract_bench import (
        ALU_OPS_PER_S, HBM_BYTES_PER_S, event_times, scrub_buffer, spread)

    g = CDBGraph.from_gfa(gfa)
    seeds = batched.canonical_seeds(g)
    seeds_t = torch.from_numpy(seeds.astype(np.int32)).cuda()
    succ_t = torch.from_numpy(np.ascontiguousarray(g._succ, dtype=np.int32)).cuda()
    caps = (batched.MAX_SEEN, batched.MAX_STACK, batched.MAX_STEPS)
    counts = {}
    want = batched.search_batched_plain(seeds_t, succ_t, *caps, counts=counts)
    outs = batched.search_batched(seeds_t, succ_t, *caps)
    word = torch.empty(2, dtype=torch.int32, device="cuda")
    scrub = scrub_buffer()
    before = batched.SEARCH_LAUNCHES

    def kernel(tile=0):
        return lambda: batched._launch(seeds_t, succ_t, *caps, outs, word, tile)

    base = None
    if baseline_lib:
        fn = ctypes.CDLL(baseline_lib).pf_superbubble_search
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, *[ctypes.c_void_p] * 6]
        fn.restype = ctypes.c_int
        stream = torch.cuda.current_stream().cuda_stream
        base_outs = [torch.empty_like(x) for x in outs]

        def base():
            if fn(seeds_t.data_ptr(), len(seeds), succ_t.data_ptr(), len(g), *caps,
                  *(x.data_ptr() for x in base_outs), stream):
                raise RuntimeError("baseline search launch failed")

        base()
        torch.cuda.synchronize()
        _same_outputs(base_outs, want, len(seeds), f"{name}, the baseline kernel")

    runs = {"ms": [], "baseline_ms": [], "main_ms": []}
    for key, f in (("baseline_ms", base), ("ms", kernel()), ("main_ms", lambda: batched.search_batched(
            seeds_t, succ_t, *caps)), ("ms", kernel()), ("baseline_ms", base)):
        if f is not None:
            runs[key] += event_times(f, reps // 2, scrub)
    tiles = {tile: [] for tile in batched.TILES}
    for order in (batched.TILES, batched.TILES[::-1]):
        for tile in order:
            tiles[tile] += event_times(kernel(tile), reps // 2, scrub)
    batched.SEARCH_LAUNCHES = before  # timing launches are not the main path's
    torch.cuda.synchronize()
    _same_outputs(outs, want, len(seeds), f"{name}, after the timing launches")
    plain_ms = spread(event_times(
        lambda: batched.search_batched_plain(seeds_t, succ_t, *caps), 1, scrub))[0]
    walls = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batched.search_seeds(g, seeds, "cuda")
        walls.append(time.perf_counter() - t0)
    batched.SEARCH_LAUNCHES = before
    launch_ms = spread(event_times(lambda: word[:1].fill_(0), reps, scrub))[0]
    S, n, ms = len(seeds), len(g), caps[0]
    nbytes = n * 32 + S * 4 + S * (1 + 4 + 1 + 4 * ms + 4)
    # a floor on the integer work: each DFS step probes its (up to) 4
    # successors against the ms slots, 8 operations a slot (u's idx
    # compare, four predecessor compares, the st, sm and cyc selects)
    ops = counts["steps"] * 4 * ms * 8
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ALU_OPS_PER_S * 1e3
    res = {"seeds": S, "unitigs": n, "steps": counts["steps"],
           "max_seed_steps": counts["max_seed_steps"], "bytes": nbytes, "ops": ops,
           "plain_ms": plain_ms, "search_seeds_s": spread(walls), "launch_ms": launch_ms,
           "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "tiles": {tile: spread(times) for tile, times in tiles.items()}}
    for key, times in runs.items():
        if times:
            res[key] = spread(times)
    return res


def log_search_times(name: str, ts: dict, latency: dict, default_tile: int):
    """One line of time_search's numbers, with the latency floor: the
    launch floor plus the longest seed's read rounds (steps + 1) times
    one cold dependent load."""
    ts["floor_ms"] = ts["launch_ms"] + (ts["max_seed_steps"] + 1) * latency["cold_us"] / 1e3
    ts["share"] = ts["bound_ms"] / ts["ms"][0]
    tiles = ", ".join(f"T={t} {v[0]:.4f} [{v[1]:.4f}, {v[2]:.4f}]" for t, v in ts["tiles"].items())
    base = (f"; baseline kernel in turns {ts['baseline_ms'][0]:.4f} ms [{ts['baseline_ms'][1]:.4f}, "
            f"{ts['baseline_ms'][2]:.4f}]" if "baseline_ms" in ts else "")
    log(f"search kernel at {name}'s {ts['seeds']} seeds ({ts['unitigs']} unitigs, {ts['steps']} "
        f"DFS steps in all, {ts['max_seed_steps']} the longest seed's), per launch (median [min, "
        f"max]): kernel (T={default_tile}) {ts['ms'][0]:.4f} ms [{ts['ms'][1]:.4f}, "
        f"{ts['ms'][2]:.4f}]{base}; main-path call (search_batched, its word read back) "
        f"{ts['main_ms'][0]:.4f} ms [{ts['main_ms'][1]:.4f}, {ts['main_ms'][2]:.4f}]; every tile "
        f"width: {tiles}; plain {ts['plain_ms']:.2f} ms; bound {ts['bound_ms']:.4f} ms "
        f"({ts['bound_by']}: {ts['bytes']} bytes, {ts['ops']} operations), {100 * ts['share']:.1f}% "
        f"of bound; latency floor {ts['floor_ms']:.4f} ms (one-element kernel "
        f"{ts['launch_ms']:.4f} ms + {ts['max_seed_steps'] + 1} read rounds x "
        f"{latency['cold_us']:.3f} us); search_seeds end to end (succ and seeds in, outputs out) "
        f"{ts['search_seeds_s'][0]:.4f} s [{ts['search_seeds_s'][1]:.4f}, "
        f"{ts['search_seeds_s'][2]:.4f}]")


def profile_batch(B=16384, L=160, k=25) -> list[str]:
    """Names of the CUDA kernels that one counter batch (already on the
    card) runs, from a torch.profiler trace."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    from ploidyfrost_tpu_torch.kmer.count import KmerCounter
    from ploidyfrost_tpu_torch.kmer.extract_bench import random_codes
    from ploidyfrost_tpu_torch.util.profiling import profiled

    counter = KmerCounter(k, device="cuda")
    codes = random_codes(B, L, seed=2)
    counter.add_reads(codes)  # warm
    torch.cuda.synchronize()
    with profiled([ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        counter.add_reads(codes)
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == DeviceType.CUDA
            and not e.name.startswith(("Memcpy", "Memset"))]


# ---------------------------------------------------------------------------
# Kernel A, the GMM-EM loop (csrc/gmm_em.cu), and kernel B, the NW
# wavefront (csrc/nw_wavefront.cu)

EM_RTOL = 1e-12
EM_ARGS = (1000, 5.0, 2.0, 0.01)  # max_iter, m_thre, n_thre, max_delta: the CLI's defaults
FP64_OPS_PER_S = 34e12  # H100 SXM fp64 outside the tensor cores (NVIDIA data sheet)


def read_frequencies(path: str) -> np.ndarray:
    """An allele frequency file as `model` reads it (frequency 0)."""
    from ploidyfrost_tpu_torch.model.gmm import GmmModel

    model = GmmModel("cpu")
    model.read_fre_file(path, 0.0)
    return model.allele_fre


def _em_init(g: int):
    import torch

    means = [i / (g + 1) for i in range(1, g + 1)]
    return tuple(torch.tensor(x, dtype=torch.float64, device="cuda")
                 for x in (means, [1.0 / g] * g, [0.01] * g))


def em_fit_same(af_np: np.ndarray, g: int, where: str, em_args=EM_ARGS, init=None) -> dict:
    """Kernel A's fit of af at g against the plain version on the card:
    variances, weights and ll within EM_RTOL relative, the same count.
    `init`: (means, weights, variances) lists instead of _em_init(g).
    Returns {count, rel, abs, delta}: delta is the plain loop's last
    delta-ll, the one that stopped it (how far the count was from
    flipping: it stops at delta <= max_delta), None if no iteration ran."""
    import torch

    from ploidyfrost_tpu_torch.model import gmm

    af = torch.from_numpy(np.ascontiguousarray(af_np, dtype=np.float64)).cuda()
    start = _em_init(g) if init is None else tuple(
        torch.tensor(x, dtype=torch.float64, device="cuda") for x in init)
    args = (af, *start, *em_args)
    kv, kw, kll, kcount = gmm._em_iterate(*args)
    pv, pw, pll, pcount, delta = gmm.em_loop_plain(*args)
    delta = delta if pcount else None
    got = np.concatenate([kv.numpy(), kw.numpy(), [float(kll)]])
    want = np.concatenate([pv.cpu().numpy(), pw.cpu().numpy(), [float(pll)]])
    if kcount != pcount:
        raise AssertionError(f"EM kernel count {kcount} != plain {pcount} at {where}, g={g}; "
                             f"the plain loop's last delta {delta}, max_delta {em_args[3]}")
    both_nan = np.isnan(got) & np.isnan(want)
    diff = np.where(both_nan, 0.0, np.abs(got - want))
    bad = ~both_nan & ~(diff <= EM_RTOL * np.abs(want))
    if bad.any():
        raise AssertionError(f"EM kernel differs from plain at {where}, g={g}: {got} vs {want}")
    rel = diff / np.where(both_nan | (want == 0), 1.0, np.abs(want))
    return {"count": kcount, "rel": float(rel.max()), "abs": float(diff.max()), "delta": delta}


def check_em_fits(sets: dict, gauss=range(1, 10), em_args=EM_ARGS) -> dict:
    """em_fit_same at every g of `gauss` for each named frequency set;
    returns {fits, worst_rel, worst_abs, counts: {name: [count a g]},
    deltas: {name: [last delta a g]}}, and logs each set's fits."""
    from ploidyfrost_tpu_torch.model import gmm

    before = gmm.EM_LAUNCHES
    res = {"fits": 0, "worst_rel": 0.0, "worst_abs": 0.0, "counts": {}, "deltas": {}}
    for name, af in sets.items():
        counts, deltas = [], []
        for g in gauss:
            r = em_fit_same(af, g, name, em_args)
            res["fits"] += 1
            res["worst_rel"] = max(res["worst_rel"], r["rel"])
            res["worst_abs"] = max(res["worst_abs"], r["abs"])
            counts.append(r["count"])
            deltas.append(r["delta"])
        res["counts"][name] = counts
        res["deltas"][name] = deltas
        log(f"EM kernel on {name}'s {len(af)} frequencies at g = {list(gauss)}: iterations "
            f"{counts}, equal to the plain version's; the last delta-ll of each fit "
            f"{[None if d is None else float(f'{d:.3g}') for d in deltas]} (max_iter "
            f"{em_args[0]}, max_delta {em_args[3]})")
    gmm.EM_LAUNCHES = before  # the checks' launches are not a main path's
    return res


def check_em() -> dict:
    """Phase 2, kernel A: the golden frequency sets at g = 1..9, N = 0
    and N = 1, g = 17, 33 and 64 (two lanes a point and more: the
    components in chunks of 32), g = 1600 (its state past 48 KB of shared
    memory; 300 points, three iterations at most) and g = 5000 (its state
    in the workspace; 100 points, two iterations at most), a NaN weight,
    and two runs giving the same bits."""
    import torch

    from ploidyfrost_tpu_torch.model import gmm

    sets = {name: read_frequencies(os.path.join(d, "gold_allele_frequency.txt"))
            for name, d in (("single_diploid", GOLD), ("multi_colored", GOLD_COLORED),
                            ("indel_dense", GOLD_INDEL))}
    res = check_em_fits(sets)
    edge = check_em_fits({"N=0": np.zeros(0), "N=1": np.array([0.37])}, gauss=(1, 2, 3))
    big = check_em_fits({"indel_dense": sets["indel_dense"]}, gauss=(17, 33, 64))
    wide = check_em_fits({"indel_dense[:300]": sets["indel_dense"][:300]}, gauss=(1600,),
                         em_args=(3, *EM_ARGS[1:]))
    wider = check_em_fits({"indel_dense[:100]": sets["indel_dense"][:100]}, gauss=(5000,),
                          em_args=(2, *EM_ARGS[1:]))
    before = gmm.EM_LAUNCHES
    means = [i / 4 for i in range(1, 4)]
    nan = em_fit_same(sets["single_diploid"], 3, "a NaN weight",
                      init=(means, [1 / 3, float("nan"), 1 / 3], [0.01] * 3))
    gmm.EM_LAUNCHES = before
    if nan["count"] != 1:
        raise AssertionError(f"a NaN weight ran {nan['count']} iterations, not 1")
    nan["fits"], nan["worst_rel"], nan["worst_abs"] = 1, nan["rel"], nan["abs"]
    for r in (edge, big, wide, wider, nan):
        res["fits"] += r["fits"]
        res["worst_rel"] = max(res["worst_rel"], r["worst_rel"])
        res["worst_abs"] = max(res["worst_abs"], r["worst_abs"])
    before = gmm.EM_LAUNCHES
    af = torch.from_numpy(sets["indel_dense"]).cuda()
    runs = [gmm._em_iterate(af, *_em_init(5), *EM_ARGS) for _ in range(2)]
    gmm.EM_LAUNCHES = before
    same = all(x.numpy().tobytes() == y.numpy().tobytes()
               for x, y in zip(runs[0][:3], runs[1][:3])) and runs[0][3] == runs[1][3]
    if not same:
        raise AssertionError("two runs of the EM kernel gave different bits")
    log(f"phase 2: EM kernel equal to its plain version on the card on {res['fits']} fits (the "
        f"three golden frequency sets at g = 1..9, N = 0 and N = 1 at g = 1..3, g = 17, 33, "
        f"64, g = 1600 past 48 KB of shared memory, g = 5000 with its state in the workspace, "
        f"a NaN weight): "
        f"identical iteration counts {res['counts']}, largest relative difference "
        f"{res['worst_rel']:.3g} (tolerance {EM_RTOL:g}); two runs bit-identical")
    return res


def em_attributes(n: int, g: int) -> dict:
    """Kernel A compiled: registers, local bytes, shared bytes, blocks a
    multiprocessor, threads, the launch's blocks at n points, g, and the
    multiprocessors they use (one block a multiprocessor at most)."""
    import ctypes as ct

    import torch

    from ploidyfrost_tpu_torch.model import gmm

    out = (ct.c_int * 6)()
    gmm._rc(gmm._load()["pf_gmm_em_attrs"](n, g, out), "attrs")
    keys = ("registers", "local_bytes", "shared_bytes", "blocks_per_sm", "threads", "blocks")
    res = dict(zip(keys, out))
    res["sms_used"] = min(res["blocks"], torch.cuda.get_device_properties(0).multi_processor_count)
    return res


def nw_attributes(tier: int, pairs: int) -> dict:
    """Kernel B compiled at `tier` for a chunk of `pairs`: registers, local
    bytes, shared bytes a block, warps (pairs) a block, blocks a
    multiprocessor, blocks of the launch, multiprocessors used, cells a
    lane (0: the shared-memory path)."""
    import ctypes as ct

    from ploidyfrost_tpu_torch.kmer.extract import build

    fn = ct.CDLL(build("nw_wavefront")).pf_nw_wavefront_attrs
    fn.argtypes = [ct.c_int, ct.c_int, ct.c_void_p]
    fn.restype = ct.c_int
    out = (ct.c_int * 8)()
    if fn(tier, pairs, out):
        raise RuntimeError(f"nw_wavefront attributes failed at tier {tier}")
    return dict(zip(("registers", "local_bytes", "shared_bytes", "warps", "blocks_per_sm",
                     "blocks", "sms_used", "cells_a_lane"), out))


def em_nw_attributes():
    """Phase 1: kernel A at bench5m's size (n = 9,987) for g = 1..9 and
    at the wide fits the checks run, kernel B at every tier for a chunk
    of _chunk_of(tier) pairs and for phase 9's chunks (512 pairs at tier
    64, 190 at 128)."""
    from ploidyfrost_tpu_torch.align.batch_nw import _MAX_TIER, _MIN_TIER, _chunk_of

    for n, g in [(9987, g) for g in range(1, 10)] + [(20000, 17), (300, 1600), (100, 5000),
                                                      (1, 1)]:
        a = em_attributes(n, g)
        log(f"EM kernel at n={n}, g={g}: {a['registers']} registers and {a['local_bytes']} bytes "
            f"of local memory a thread, {a['shared_bytes']} bytes of shared memory a block of "
            f"{a['threads']} threads, {a['blocks_per_sm']} blocks resident a multiprocessor, "
            f"{a['blocks']} blocks in the launch on {a['sms_used']} multiprocessors")
    tier = _MIN_TIER
    while tier <= _MAX_TIER:
        for pairs in sorted({_chunk_of(tier), {64: 512, 128: 190}.get(tier, _chunk_of(tier))}):
            a = nw_attributes(tier, pairs)
            path = (f"register path, {a['cells_a_lane']} cells a lane" if a["cells_a_lane"]
                    else "shared-memory path")
            log(f"NW kernel at tier {tier}, {pairs} pairs ({path}): {a['registers']} registers "
                f"and {a['local_bytes']} bytes of local memory a thread, {a['shared_bytes']} bytes "
                f"of shared memory a block of {a['warps']} warp(s), {a['blocks_per_sm']} blocks "
                f"resident a multiprocessor, {a['blocks']} blocks on {a['sms_used']} "
                "multiprocessors")
        tier *= 2


def _nw_chunks(pairs: list):
    """(tier, a_seqs, b_seqs) of each chunk nw_matrices_batched makes of
    `pairs` (pairs above the largest tier left out)."""
    from ploidyfrost_tpu_torch.align import batch_nw

    by_tier = {}
    for a, b in pairs:
        t = batch_nw._tier_of(len(a), len(b))
        if t <= batch_nw._MAX_TIER:
            by_tier.setdefault(t, []).append((a, b))
    for tier, ps in sorted(by_tier.items()):
        ch = batch_nw._chunk_of(tier)
        for off in range(0, len(ps), ch):
            part = ps[off : off + ch]
            yield tier, [a for a, _ in part], [b for _, b in part]


def _nw_tensors(a_seqs, b_seqs, tier):
    import torch

    from ploidyfrost_tpu_torch.align import batch_nw

    return (torch.from_numpy(batch_nw._encode(a_seqs, tier)).cuda(),
            torch.from_numpy(batch_nw._encode(b_seqs, tier)).cuda(),
            torch.tensor([[len(s)] for s in a_seqs], dtype=torch.int32, device="cuda"))


def nw_buffers_same(pairs: list, where: str) -> dict:
    """Kernel B against the plain `_wavefront` on the card, chunk by
    chunk as nw_matrices_batched makes them: every pair's de-skewed
    window must be equal (the native kernel's matrices, bit for bit);
    whether the whole buffers agree is reported. Returns {chunks,
    whole_equal, cells, max_abs_err (the largest difference of a flag
    in the windows, kernel against the plain version and the native
    kernel), whole_max_abs_err (the same over every flag of the whole
    buffers, kernel against the plain version)}."""
    import torch

    from ploidyfrost_tpu_torch.align import batch_nw
    from ploidyfrost_tpu_torch.align.nw import nw_matrices_native

    before = batch_nw.NW_LAUNCHES
    res = {"chunks": 0, "whole_equal": True, "cells": 0, "max_abs_err": 0,
           "whole_max_abs_err": 0}
    for tier, a_seqs, b_seqs in _nw_chunks(pairs):
        a, b, a_len = _nw_tensors(a_seqs, b_seqs, tier)
        got = batch_nw.nw_wavefront(a, b, a_len, 2, -1, -3)
        want = batch_nw._wavefront(a, b, a_len, 2, -1, -3)
        torch.cuda.synchronize()
        res["chunks"] += 1
        res["whole_equal"] &= bool(torch.equal(got, want))
        got, want = got.cpu().numpy(), want.cpu().numpy()
        # flags are 0 or 1: any differing bit is a difference of 1
        res["whole_max_abs_err"] = max(res["whole_max_abs_err"], int((got != want).any()))
        native = nw_matrices_native(list(zip(a_seqs, b_seqs)), 2.0, -1.0, -3.0)
        for lane, (A, B) in enumerate(zip(a_seqs, b_seqs)):
            ii = np.arange(len(A) + 1)[:, None]
            dg = ii + np.arange(len(B) + 1)[None, :]
            bits_k = np.unpackbits(got[lane], axis=-1, bitorder="little").astype(np.int16)
            bits_p = np.unpackbits(want[lane], axis=-1, bitorder="little").astype(np.int16)
            for f in range(3):
                k, p = bits_k[f][dg, ii], bits_p[f][dg, ii]
                err = max(int(np.abs(k - p).max()),
                          int(np.abs(k - native[lane][f].astype(np.int16)).max()))
                res["max_abs_err"] = max(res["max_abs_err"], err)
                if err:
                    raise AssertionError(f"NW kernel window of pair {lane} (tier {tier}, flag "
                                         f"{f}) differs at {where}")
            res["cells"] += (len(A) + 1) * (len(B) + 1)
    batch_nw.NW_LAUNCHES = before  # the checks' launches are not a main path's
    return res


def check_nw_kernel() -> dict:
    """Phase 2, kernel B: the synthetic pairs of every tier (dashes in A),
    with an empty A and full-length rows, against `_wavefront` and the
    native kernel."""
    import random

    pairs = _synthetic_nw_pairs()
    rng = random.Random(11)
    tier = 16
    from ploidyfrost_tpu_torch.align.batch_nw import _MAX_TIER

    while tier <= _MAX_TIER:
        pairs += [("", "".join(rng.choice("ACGT") for _ in range(tier))),
                  ("A" * tier, "C" * tier),
                  ("".join(rng.choice("ACGT-") for _ in range(tier)),
                   "".join(rng.choice("ACGT") for _ in range(tier - 1)))]
        tier *= 2
    res = nw_buffers_same(pairs, "the synthetic pairs")
    # widths the tiers do not use: the register path at a k above the
    # need and next to the shared-memory switch (511, 513), an odd chunk
    import torch

    from ploidyfrost_tpu_torch.align import batch_nw

    before = batch_nw.NW_LAUNCHES
    odd = (17, 40, 100, 300, 511, 513, 700)
    for T in odd:
        a_s = ["".join(rng.choice("ACGT-") for _ in range(rng.randint(0, T))) for _ in range(37)]
        b_s = ["".join(rng.choice("ACGT-") for _ in range(rng.randint(1, T))) for _ in range(37)]
        a, b, a_len = _nw_tensors(a_s, b_s, T)
        if not torch.equal(batch_nw.nw_wavefront(a, b, a_len, 1, -2, -1),
                           batch_nw._wavefront(a, b, a_len, 1, -2, -1)):
            raise AssertionError(f"NW kernel differs from its plain version at T = {T}")
        res["chunks"] += 1
    batch_nw.NW_LAUNCHES = before
    log(f"phase 2: NW kernel on the card equal to its plain version and the native kernel on "
        f"every de-skewed window of {len(pairs)} synthetic pairs ({res['chunks'] - len(odd)} "
        f"chunks, tiers 16..2048, {res['cells']} cells); whole buffers "
        f"{'equal' if res['whole_equal'] else 'NOT equal outside the windows'}; whole buffers "
        f"equal at T = {list(odd)} (37 pairs each)")
    return res


def _baseline_em(lib: str):
    """fit(af, means, w, v, out) launching the earlier EM kernel in `lib`
    (the C ABI of pf_gmm_em_plan and pf_gmm_em) at EM_ARGS, on a
    workspace of its own."""
    import ctypes as ct

    import torch

    so = ct.CDLL(lib)
    p, i, ll, d = ct.c_void_p, ct.c_int, ct.c_longlong, ct.c_double
    so.pf_gmm_em_plan.argtypes = [ll, i, p, p]
    so.pf_gmm_em.argtypes = [p, ll, p, p, p, i, i, d, d, d, p, p, p]
    so.pf_gmm_em_plan.restype = so.pf_gmm_em.restype = ct.c_int
    works = {}

    def fit(af, means, w, v, out):
        g, n = means.numel(), af.numel()
        if (n, g) not in works:
            blocks, doubles = ct.c_int(), ct.c_longlong()
            if so.pf_gmm_em_plan(n, g, ct.byref(blocks), ct.byref(doubles)):
                raise RuntimeError("baseline EM plan failed")
            works[n, g] = torch.empty(doubles.value, dtype=torch.float64, device="cuda")
        if so.pf_gmm_em(af.data_ptr(), n, means.data_ptr(), w.data_ptr(), v.data_ptr(), g,
                        EM_ARGS[0], *EM_ARGS[1:], works[n, g].data_ptr(), out.data_ptr(),
                        torch.cuda.current_stream().cuda_stream):
            raise RuntimeError("baseline EM launch failed")

    return fit


def time_em(af_np: np.ndarray, name: str, baseline_lib: str | None = None, reps: int = 30) -> dict:
    """Kernel A at `af` (a real run's frequencies) for g = 1..9, per fit
    with CUDA events and L2 scrubbed: the bare launch, the plain version
    and, with `baseline_lib`, the earlier kernel (its result held to this
    one's), in turns (plain, kernel, baseline, kernel, baseline, plain);
    the bound from this run's passes; and a latency floor from parts
    measured apart from the fit kernel, at each fit's blocks: the launch
    (a cooperative launch of the fit's blocks that do nothing), a grid
    barrier (the slope of launches of 0 and 1000 barriers), and a pass
    floor, the slope over rounds of one warp's chain for one point a
    segment (its L2 read, one density a lane, the segment sums, one
    divide, the log) plus that of one block's reduction of its sums and
    its sum of every block's row (pf_gmm_floor_probe). The floor is the
    launch + (count + 1) x (pass floor + one barrier). A pass inside the
    fit kernel (a fit with max_iter = 0, less the launch and a barrier) is
    reported beside the pass floor. Everything in ms."""
    import torch

    from ploidyfrost_tpu_torch.kmer.extract_bench import (
        HBM_BYTES_PER_S, event_times, scrub_buffer, spread)
    from ploidyfrost_tpu_torch.model import gmm

    af = torch.from_numpy(np.ascontiguousarray(af_np, dtype=np.float64)).cuda()
    n = af.numel()
    scrub = scrub_buffer()
    before = gmm.EM_LAUNCHES
    fits = []
    fns = gmm._load()
    stream = torch.cuda.current_stream().cuda_stream
    bar = torch.zeros(1, dtype=torch.int64, device="cuda")  # zeroed once: each probe leaves it so
    attrs = {g: em_attributes(n, g) for g in range(1, 10)}
    rows = {g: a["blocks"] for g, a in attrs.items()}
    scratch = torch.zeros(max(rows.values()) * 19, dtype=torch.float64, device="cuda")
    probe_out = torch.zeros(19, dtype=torch.float64, device="cuda")
    base = _baseline_em(baseline_lib) if baseline_lib else None

    def probe(blocks):
        return lambda rounds: lambda: gmm._rc(fns["pf_gmm_barrier_probe"](
            blocks, rounds, bar.data_ptr(), stream), "barrier probe")

    def slope(make, rounds, r=10):
        """ms a round of make(rounds): launches of 0 and `rounds` rounds."""
        t0 = spread(event_times(make(0), r, scrub))[0]
        return (spread(event_times(make(rounds), r, scrub))[0] - t0) / rounds

    def floor_part(mode, g, rows):
        return lambda rounds: lambda: gmm._rc(fns["pf_gmm_floor_probe"](
            mode, g, rows, rounds, scratch.data_ptr(), probe_out.data_ptr(), stream),
            "floor probe")

    rounds = 1000
    launch_ms = {b: spread(event_times(probe(b)(0), reps, scrub))[0] for b in set(rows.values())}
    barrier_ms = {b: slope(probe(b), rounds) for b in set(rows.values())}
    for g in range(1, 10):
        init = _em_init(g)
        out = torch.empty(2 * g + 2, dtype=torch.float64, device="cuda")
        kernel = lambda: gmm.launch_em(af, *init, *EM_ARGS, out)  # noqa: E731
        plain = lambda: gmm.em_iterate_plain(af, *init, *EM_ARGS)  # noqa: E731
        one_pass = lambda: gmm.launch_em(af, *init, 0, *EM_ARGS[1:], out)  # noqa: E731
        times = {"ms": [], "plain_ms": [], "baseline_ms": []}
        order = [("plain_ms", plain, 2), ("ms", kernel, reps // 2)]
        if base:
            base_out = torch.empty_like(out)
            older = lambda: base(af, *init, base_out)  # noqa: E731
            order += [("baseline_ms", older, reps // 2), ("ms", kernel, reps // 2),
                      ("baseline_ms", older, reps // 2)]
        else:
            order += [("ms", kernel, reps // 2)]
        order += [("plain_ms", plain, 2)]
        for key, f, r in order:
            times[key] += event_times(f, r, scrub)
        got = out.cpu().numpy()
        count = int(got[2 * g + 1])
        if base:
            old = base_out.cpu().numpy()
            if int(old[2 * g + 1]) != count or not np.allclose(old, got, rtol=EM_RTOL, atol=0):
                raise AssertionError(f"the baseline EM kernel at g={g}: {old} against {got}")
        b = rows[g]
        pass_ms = spread(event_times(one_pass, reps, scrub))[0]
        chain_ms = slope(floor_part(0, g, b), rounds)
        reduce_ms = slope(floor_part(1, g, b), rounds)
        passes = count + 1
        t_bytes = passes * n * 8 / HBM_BYTES_PER_S * 1e3
        # a floor on a pass's fp64 work a point: per component the
        # difference, square, quotient, exp, two products, the weight, two
        # row sums, the responsibility, its sum, two products and the var
        # sum (13); the log and its sum (2)
        ops = passes * n * (13 * g + 2)
        t_ops = ops / FP64_OPS_PER_S * 1e3
        pass_floor = chain_ms + reduce_ms
        fits.append({"g": g, "count": count, "ms": spread(times["ms"]),
                     "plain_ms": spread(times["plain_ms"]),
                     "baseline_ms": spread(times["baseline_ms"]) if base else None,
                     "pass_ms": pass_ms, "blocks": b, "sms_used": attrs[g]["sms_used"],
                     "pass_body_ms": max(pass_ms - launch_ms[b] - barrier_ms[b], 0.0),
                     "chain_ms": chain_ms, "reduce_ms": reduce_ms, "pass_floor_ms": pass_floor,
                     "launch_ms": launch_ms[b], "barrier_ms": barrier_ms[b],
                     "bound_ms": max(t_bytes, t_ops),
                     "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                     "floor_ms": launch_ms[b] + passes * (pass_floor + barrier_ms[b])})
    gmm.EM_LAUNCHES = before  # timing launches are not the main path's
    total = {key: sum(f[key][0] if isinstance(f[key], tuple) else f[key] for f in fits)
             for key in ("ms", "plain_ms", "bound_ms", "floor_ms")}
    total["baseline_ms"] = sum(f["baseline_ms"][0] for f in fits) if base else None
    res = {"n": n, "fits": fits, "launch_ms": launch_ms[rows[9]],
           "barrier_ms": barrier_ms[rows[9]], "blocks": rows[9],
           "registers": attrs[9]["registers"], **total,
           "bound_by": "bytes" if all(f["bound_by"] == "bytes" for f in fits) else "operations"}
    per = "; ".join(
        f"g={f['g']} {f['count']} it. {f['ms'][0]:.4f} [{f['ms'][1]:.4f}, {f['ms'][2]:.4f}] ms"
        + (f", baseline {f['baseline_ms'][0]:.4f} [{f['baseline_ms'][1]:.4f}, "
           f"{f['baseline_ms'][2]:.4f}]" if base else "")
        + f", plain {f['plain_ms'][0]:.3f} ms, {f['blocks']} blocks on {f['sms_used']} SMs, a "
        f"pass in the kernel {f['pass_body_ms'] * 1e3:.2f} us against a pass floor "
        f"{f['pass_floor_ms'] * 1e3:.2f} us (chain {f['chain_ms'] * 1e3:.2f}, reductions "
        f"{f['reduce_ms'] * 1e3:.2f}), launch {f['launch_ms'] * 1e3:.2f} us, barrier "
        f"{f['barrier_ms'] * 1e3:.2f} us, bound {f['bound_ms'] * 1e3:.3f} us, floor "
        f"{f['floor_ms']:.4f} ms" for f in fits)
    log(f"EM kernel at {name}'s {n} frequencies, per fit (median [min, max]): {per}")
    log(f"EM kernel at {name}, the model stage's nine fits: kernel {res['ms']:.4f} ms"
        + (f", baseline in turns {res['baseline_ms']:.4f} ms" if base else "")
        + f", plain {res['plain_ms']:.3f} ms, bound {res['bound_ms'] * 1e3:.3f} us "
        f"({res['bound_by']}; {n * 8} bytes a pass at 3.35 TB/s against 13 g + 2 fp64 "
        f"operations a point at {FP64_OPS_PER_S / 1e12:g} TFLOP/s), "
        f"{100 * res['bound_ms'] / res['ms']:.2f}% of bound; latency floor "
        f"{res['floor_ms']:.4f} ms (a launch, an empty cooperative grid; a grid barrier; "
        f"+ (count + 1) x (the pass floor + one barrier), each part measured apart from the fit "
        f"kernel at the fit's blocks), {100 * res['floor_ms'] / res['ms']:.1f}% of the kernel's "
        "time")
    return res


def time_nw(pairs: list, name: str, baseline_lib: str | None = None, reps: int = 20) -> dict:
    """Kernel B at `pairs`, chunk by chunk as nw_matrices_batched makes
    them: the bare launch (CUDA events, L2 scrubbed), the plain
    `_wavefront` on the card and, with `baseline_lib`, the earlier kernel
    (its buffer held equal to this one's) in turns (plain, kernel,
    baseline, kernel, baseline, plain), per tier, with the launch's
    registers, blocks and multiprocessors; the bound from each chunk's
    bytes (codes and lengths in, flags out at 3.35 TB/s) against its
    integer operations (about 20 a cell at the card's 32-bit rate).
    Everything in ms."""
    from ploidyfrost_tpu_torch.align import batch_nw
    from ploidyfrost_tpu_torch.kmer.extract_bench import (
        ALU_OPS_PER_S, HBM_BYTES_PER_S, event_times, scrub_buffer, spread)

    import torch

    scrub = scrub_buffer()
    before = batch_nw.NW_LAUNCHES
    tiers = {}
    older = None
    if baseline_lib:
        import ctypes as ct

        older = ct.CDLL(baseline_lib).pf_nw_wavefront
        older.argtypes = [ct.c_void_p] * 3 + [ct.c_int] * 5 + [ct.c_void_p] * 2
        older.restype = ct.c_int
    for tier, a_seqs, b_seqs in _nw_chunks(pairs):
        a, b, a_len = _nw_tensors(a_seqs, b_seqs, tier)
        CH = len(a_seqs)
        out = torch.empty((CH, 3, 2 * tier + 1, (tier + 9) // 8), dtype=torch.uint8, device="cuda")
        kernel = lambda: batch_nw.launch_wavefront(a, b, a_len, 2, -1, -3, out)  # noqa: E731
        plain = lambda: batch_nw._wavefront(a, b, a_len, 2, -1, -3)  # noqa: E731
        times = {"ms": [], "plain_ms": [], "baseline_ms": []}
        order = [("plain_ms", plain, 1), ("ms", kernel, reps // 2)]
        if older:
            base_out = torch.empty_like(out)

            def base():
                if older(a.data_ptr(), b.data_ptr(), a_len.data_ptr(), CH, tier, 2, -1, -3,
                         base_out.data_ptr(), torch.cuda.current_stream().cuda_stream):
                    raise RuntimeError("baseline NW launch failed")

            order += [("baseline_ms", base, reps // 2), ("ms", kernel, reps // 2),
                      ("baseline_ms", base, reps // 2)]
        else:
            order += [("ms", kernel, reps // 2)]
        order += [("plain_ms", plain, 1)]
        for key, f, r in order:
            times[key] += event_times(f, r, scrub)
        if older and not torch.equal(base_out, out):
            raise AssertionError(f"the baseline NW kernel differs at tier {tier}")
        nbytes = 2 * CH * tier + 4 * CH + out.numel()
        ops = 20 * CH * (2 * tier + 1) * (tier + 1)
        t = tiers.setdefault(tier, {"chunks": 0, "pairs": 0, "ms": 0.0, "min_ms": 0.0,
                                    "max_ms": 0.0, "plain_ms": 0.0, "bytes": 0, "ops": 0,
                                    "baseline_ms": 0.0 if older else None,
                                    "baseline_min_ms": 0.0, "baseline_max_ms": 0.0,
                                    "attrs": nw_attributes(tier, CH)})
        k = spread(times["ms"])
        t["chunks"] += 1
        t["pairs"] += CH
        t["ms"] += k[0]
        t["min_ms"] += k[1]
        t["max_ms"] += k[2]
        t["plain_ms"] += spread(times["plain_ms"])[0]
        if older:
            bs = spread(times["baseline_ms"])
            t["baseline_ms"] += bs[0]
            t["baseline_min_ms"] += bs[1]
            t["baseline_max_ms"] += bs[2]
        t["bytes"] += nbytes
        t["ops"] += ops
    batch_nw.NW_LAUNCHES = before  # timing launches are not the main path's
    for t in tiers.values():
        t_bytes = t["bytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = t["ops"] / ALU_OPS_PER_S * 1e3
        t["bound_ms"] = max(t_bytes, t_ops)
        t["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    res = {key: sum(t[key] for t in tiers.values())
           for key in ("chunks", "pairs", "ms", "plain_ms", "bound_ms", "bytes", "ops")}
    res["bound_by"] = ("bytes" if res["bytes"] / HBM_BYTES_PER_S >= res["ops"] / ALU_OPS_PER_S
                       else "operations")
    res["tiers"] = tiers
    res["baseline_ms"] = sum(t["baseline_ms"] for t in tiers.values()) if older else None
    per = "; ".join(
        f"tier {tier}: {t['pairs']} pairs in {t['chunks']} chunk(s), kernel {t['ms']:.4f} "
        f"[{t['min_ms']:.4f}, {t['max_ms']:.4f}] ms"
        + (f", baseline in turns {t['baseline_ms']:.4f} [{t['baseline_min_ms']:.4f}, "
           f"{t['baseline_max_ms']:.4f}] ms" if older else "")
        + f", plain {t['plain_ms']:.2f} ms, bound {t['bound_ms']:.4f} ms ({t['bound_by']}); "
        f"{t['attrs']['registers']} registers, {t['attrs']['warps']} warp(s) a block, "
        f"{t['attrs']['blocks']} blocks on {t['attrs']['sms_used']} SMs"
        for tier, t in sorted(tiers.items()))
    log(f"NW kernel at {name}'s {res['pairs']} pairs, a launch a chunk (median [min, max], "
        f"summed over a tier's chunks): {per}")
    log(f"NW kernel at {name}, all {res['chunks']} chunks: kernel {res['ms']:.4f} ms, "
        + (f"baseline in turns {res['baseline_ms']:.4f} ms, " if older else "") + f"plain "
        f"{res['plain_ms']:.2f} ms, bound {res['bound_ms']:.4f} ms ({res['bound_by']}: "
        f"{res['bytes']} bytes, {res['ops']} integer operations), "
        f"{100 * res['bound_ms'] / res['ms']:.1f}% of bound")
    return res


def profile_em(fre: str) -> dict:
    """bench5m's model stage (GmmModel.em_iterate at g = 1..9) once
    unprofiled, then under the profiler: the EM kernels and the copies the
    card ran, and each fit's iteration count."""
    import torch
    from torch.autograd import DeviceType

    from ploidyfrost_tpu_torch.model import gmm
    from ploidyfrost_tpu_torch.util.profiling import profiled

    model = gmm.GmmModel("cuda")
    model.read_fre_file(fre, 0.0)
    counts = []
    for g in range(1, 10):  # warm: the library loads, the frequencies reach the card
        model.resize(g)
        args = (model._af(), *model._params(), *EM_ARGS)
        counts.append(gmm._em_iterate(*args)[3])
    torch.cuda.synchronize()
    launches = gmm.EM_LAUNCHES
    with profiled(_activities("cuda")) as prof:
        for g in range(1, 10):
            model.resize(g)
            model.em_iterate()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    return {"counts": counts, "launches": gmm.EM_LAUNCHES - launches,
            "em_kernels": sum("em_kernel" in e.name for e in events),
            "copies": sum(e.name.startswith("Memcpy") for e in events),
            "memsets": sum(e.name.startswith("Memset") for e in events),
            "others": sorted({e.name for e in events if "em_kernel" not in e.name
                              and not e.name.startswith(("Memcpy", "Memset"))}),
            "em_us": sum(e.time_range.elapsed_us() for e in events if "em_kernel" in e.name)}


def native_libraries() -> dict:
    """Which of the port's native host libraries loaded."""
    from ploidyfrost_tpu_torch import native

    return {
        "reader": native.load_library() is not None,
        "construct": native.load_construct_library() is not None,
        "chain": native.load_chain_library() is not None,
        "nw": native.load_nw_library() is not None,
        "lookup": native.load_lookup_library() is not None,
    }


def run_pipeline(reads: str, prefix: str, device: str):
    from ploidyfrost_tpu_torch.cli import Options, parse_options
    from ploidyfrost_tpu_torch.pipeline import run_pipeline_cli

    opt = parse_options(["-o", prefix, reads], Options(), extras="c")
    t0 = time.time()
    rc = run_pipeline_cli(opt, device)
    wall = time.time() - t0
    if rc != 0:
        raise RuntimeError(f"pipeline returned {rc}")
    return opt, _model_ploidy(prefix), wall


def _model_ploidy(prefix: str) -> int:
    with open(prefix + "_model_result.txt") as f:
        last = f.read().strip().splitlines()[-1]
    return int(float(last.rsplit(":", 1)[1]))


def _same_to_6_digits(a: str, b: str) -> bool:
    ta, tb = a.split(), b.split()
    if len(ta) != len(tb):
        return False
    for x, y in zip(ta, tb):
        if x == y:
            continue
        try:
            fx, fy = float(x), float(y)
        except ValueError:
            return False
        scale = 10 ** (math.floor(math.log10(abs(fy))) - 5) if fy else 1e-300
        if abs(fx - fy) > 1.01 * scale:
            return False
    return True


def check_golden_tables(gold_dir: str, prefix: str = "gold"):
    """The 12 tables ./PloidyFrost_output/<prefix>_* byte-identical to
    `gold_dir`'s."""
    for name in GOLD_FILES:
        with open(os.path.join("PloidyFrost_output", f"{prefix}_{name}.txt"), "rb") as f1, \
                open(os.path.join(gold_dir, f"gold_{name}.txt"), "rb") as f2:
            if f1.read() != f2.read():
                raise AssertionError(f"golden table {name} differs ({gold_dir})")


def check_golden_outputs(gold_dir: str, ploidy: int, want_ploidy: int = 2) -> str:
    """The 12 tables under ./PloidyFrost_output byte-identical to
    `gold_dir`, the model result equal to 6 significant digits, the
    ploidy as wanted; returns how the model result compared."""
    check_golden_tables(gold_dir)
    with open("gold_model_result.txt") as f1, \
            open(os.path.join(gold_dir, "gold_model_result.txt")) as f2:
        mine, gold = f1.read(), f2.read()
    if not _same_to_6_digits(mine, gold):
        raise AssertionError("gold_model_result.txt differs beyond 6 significant digits")
    if ploidy != want_ploidy:
        raise AssertionError(f"golden ploidy {ploidy} != {want_ploidy}")
    return "byte-identical" if mine == gold else "equal to 6 significant digits"


def golden(device: str, work: str):
    os.makedirs(work, exist_ok=True)
    os.chdir(work)
    make_golden_reads("reads.fa")
    opt, ploidy, wall = run_pipeline("reads.fa", "gold", device)
    if (opt.coverage_lower, opt.coverage_upper) != (10, 37):
        raise AssertionError(f"cutoffs {(opt.coverage_lower, opt.coverage_upper)} != (10, 37)")
    model = check_golden_outputs(GOLD, ploidy)
    log(f"golden on {device}: 12 tables byte-identical, model {model}, "
        f"ploidy {ploidy}, cutoffs (10, 37), {wall:.2f} s")
    return opt


def golden_colored(device: str, work: str):
    """Phase 5: the multi_colored golden by the functions and `run -f`."""
    from ploidyfrost_tpu_torch.cli import main as cli_main
    from ploidyfrost_tpu_torch.graph.cdbg import CDBGraph
    from ploidyfrost_tpu_torch.graph.colors import color_graph
    from ploidyfrost_tpu_torch.graph.construct import build_graph_from_kmers, simplify
    from ploidyfrost_tpu_torch.io.bfg import read_bfg_colors, write_bfg_colors
    from ploidyfrost_tpu_torch.io.fastx import read_batches
    from ploidyfrost_tpu_torch.kmer.count import KmerCounter
    from ploidyfrost_tpu_torch.kmer.cutoffs import (
        cutoff_lower_from_counts, cutoff_upper_from_counts)

    os.makedirs(work, exist_ok=True)
    os.chdir(work)
    paths = make_sample_reads(".", 60_000)
    t0 = time.time()
    filtered, cutoffs = [], []
    for i, p in enumerate(paths):
        counter = KmerCounter(25, device=device)
        for batch in read_batches([p], 25):
            counter.add_reads(batch)
        hist = counter.histogram(10000)
        lower = max(10, cutoff_lower_from_counts(list(hist[1:])))
        cutoffs.append((lower, cutoff_upper_from_counts(list(hist[1:]), 0.998)))
        km, ct = counter.arrays()
        np.savez(f"s{i}.kmers.npz", kmers=km, counts=ct, k=25)
        filtered.append(km[ct >= lower])
    if cutoffs != COLORED_CUTOFFS:
        raise AssertionError(f"colored cutoffs {cutoffs} != {COLORED_CUTOFFS}")
    g = simplify(build_graph_from_kmers(np.unique(np.concatenate(filtered)), 25), 25)
    colors = color_graph(g, filtered, [f"s{i}.fa" for i in range(3)])
    da = write_bfg_colors("ref.bfg_colors", g, colors)
    g.write_gfa("ref.gfa", da_ids=da)
    back = read_bfg_colors("ref.bfg_colors", CDBGraph.from_gfa("ref.gfa"))
    if not (np.array_equal(back.bits, colors.bits) and np.array_equal(back.offsets, colors.offsets)):
        raise AssertionError("the .bfg_colors round trip changed the color matrix")
    with open("list.txt", "w") as f:
        f.writelines(f"s{i}.kmers.npz\n" for i in range(3))
    with open("cov.txt", "w") as f:
        f.writelines(f"{lo}\t{up}\n" for lo, up in cutoffs)
    dev_flag = f"--device={device}"
    rc = cli_main(["-g", "ref.gfa", "-f", "ref.bfg_colors", "-d", "list.txt", "-C", "cov.txt",
                   "-o", "gold", dev_flag])
    if rc != 0:
        raise RuntimeError(f"run -f returned {rc}")
    fre = os.path.join("PloidyFrost_output", "gold_allele_frequency.txt")
    if cli_main(["model", "-g", fre, "-o", "gold", dev_flag]) != 0:
        raise RuntimeError("model failed on the colored golden")
    ploidy = _model_ploidy("gold")
    model = check_golden_outputs(GOLD_COLORED, ploidy)
    log(f"colored golden on {device}: 12 tables byte-identical, model {model}, ploidy {ploidy}, "
        f"cutoffs {cutoffs}, .bfg_colors round trip bit-equal, {time.time() - t0:.2f} s")


def multi3x5m(device: str, work: str, genome_bp: int = 5_000_000, profile: bool = False) -> dict:
    """Phase 6: `pipeline-multi` on three 5 Mbp samples. With `profile`
    the run goes under cProfile (main thread; it slows the run) and the
    40 entries with the largest cumulative time are printed."""
    import cProfile
    import pstats

    import torch

    from ploidyfrost_tpu_torch.bubble import batched
    from ploidyfrost_tpu_torch.cli import Options
    from ploidyfrost_tpu_torch.kmer import extract
    from ploidyfrost_tpu_torch.model import gmm
    from ploidyfrost_tpu_torch.pipeline import run_multisample_pipeline_cli

    os.makedirs(work, exist_ok=True)
    os.chdir(work)
    t0 = time.time()
    reads = make_sample_reads(".", genome_bp)
    log(f"multi3x5m reads generated in {time.time() - t0:.1f} s")
    opt = Options()
    opt.outprefix = "multi"
    opt.inputs = reads
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    prof = cProfile.Profile() if profile else None
    t0 = time.time()
    rc = prof.runcall(run_multisample_pipeline_cli, opt, device) if prof else \
        run_multisample_pipeline_cli(opt, device)
    wall = time.time() - t0
    if prof:
        pstats.Stats(prof).sort_stats("cumulative").print_stats(40)
    launches = extract.LAUNCHES
    search_launches = batched.SEARCH_LAUNCHES
    em_launches = gmm.EM_LAUNCHES
    peak = torch.cuda.max_memory_allocated()
    if rc != 0:
        raise RuntimeError(f"pipeline-multi returned {rc}")
    check_counts("multi3x5m")
    ploidy = _model_ploidy("multi")
    if ploidy != 2:
        raise AssertionError(f"multi3x5m ploidy {ploidy} != 2")
    with open("multi_graph_info.txt") as f:
        info = dict(kv.split(":") for kv in f.readline().split())
    with open(os.path.join("PloidyFrost_output", "multi_super_bubble.txt")) as f:
        bubbles = sum(1 for _ in f) - 1  # one header line
    for stage, sec in opt.stage_seconds.items():
        log(f"multi3x5m stage {stage}: {sec:.3f} s")
    log(f"multi3x5m: pipeline-multi wall {wall:.3f} s, cutoffs {opt.coverage_vec}, "
        f"ploidy {ploidy}, unitigs {info['nbUnitig']}, k-mers {info['nbKmer']}, "
        f"colors {info['NbColors']}, bubbles {bubbles}, K1 launches {launches}, "
        f"search launches {search_launches}, EM launches {em_launches}, peak device memory "
        f"{peak / 2**30:.3f} GiB")
    return {"launches": launches, "search_launches": search_launches, "em_launches": em_launches,
            "wall": wall, "gfa": os.path.join(work, "multi.gfa")}


def torch_programs(device: str, work: str, reads: str, table: str, lower: int):
    """Phase 7: the device link sort and the device lookup on the card,
    each against its host counterpart, on the bench5m k-mer table."""
    import torch

    from ploidyfrost_tpu_torch.cli import main as cli_main
    from ploidyfrost_tpu_torch.graph import construct
    from ploidyfrost_tpu_torch.kmer.countdb import KmerCountDB, lookup_device
    from ploidyfrost_tpu_torch.kmer.extract_bench import spread
    from ploidyfrost_tpu_torch.kmer.pack import revcomp_np

    os.makedirs(work, exist_ok=True)
    os.chdir(work)
    dev = torch.device(device)
    walls = {}
    for name, flags in (("host", []), ("dev", ["--device-build"])):
        t0 = time.time()
        if cli_main(["build", "-k", "25", "-o", name, reads, f"--device={device}", *flags]) != 0:
            raise RuntimeError(f"build {flags} failed")
        walls[name] = time.time() - t0
    with open("host.gfa", "rb") as f1, open("dev.gfa", "rb") as f2:
        if f1.read() != f2.read():
            raise AssertionError("build --device-build wrote a different GFA")
    z = np.load(table)
    km_all, ct_all = z["kmers"], z["counts"]
    km = km_all[ct_all >= lower]
    rc = construct._revcomp_np(km, 25)
    link = {"host": [], "dev": []}
    ref = None
    for side in ("host", "dev", "dev", "host", "host", "dev"):
        t0 = time.time()
        if side == "host":
            nxt = construct._links_junctions_fast(km, rc, 25)
        else:
            nxt = construct._links_junctions_device(km, rc, 25, dev)
        link[side].append(time.time() - t0)
        if ref is None:
            ref = nxt
        elif not np.array_equal(ref, nxt):
            raise AssertionError("the device link step differs from the host link step")
    log(f"phase 7a: build of the bench5m reads with and without --device-build: GFA "
        f"byte-identical ({os.path.getsize('host.gfa')} bytes), build wall host "
        f"{walls['host']:.3f} s, device {walls['dev']:.3f} s; link step alone on "
        f"{len(km)} k-mers ({2 * len(km)} stubs), links equal, median [min, max] of 3: "
        "host radix {:.3f} s [{:.3f}, {:.3f}], ".format(*spread(link["host"]))
        + "torch on the card with both copies {:.3f} s [{:.3f}, {:.3f}]".format(
            *spread(link["dev"])))

    rng = np.random.default_rng(3)
    nq = 10_000_000
    q = km_all[rng.integers(0, len(km_all), nq)]
    q[nq // 2:] = revcomp_np(q[nq // 2:], 25)
    absent = rng.random(nq) < 0.1
    q[absent] = rng.integers(0, 1 << 50, int(absent.sum()), dtype=np.uint64)
    db = KmerCountDB(km_all, ct_all, 25)
    host_s, dev_s, dev_ms = [], [], []
    t_km = torch.from_numpy(km_all.view(np.int64)).to(dev)
    t_ct = torch.from_numpy(ct_all).to(dev)
    for _ in range(3):
        t0 = time.time()
        h_counts, h_hit = db.lookup(q)
        host_s.append(time.time() - t0)
        torch.cuda.synchronize()
        t0 = time.time()
        t_q = torch.from_numpy(q.view(np.int64)).to(dev)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        d_counts, d_hit = lookup_device(t_km, t_ct, t_q, 25)
        end.record()
        d_counts, d_hit = d_counts.cpu().numpy(), d_hit.cpu().numpy()
        dev_s.append(time.time() - t0)
        dev_ms.append(start.elapsed_time(end))
        if not (np.array_equal(h_counts, d_counts) and np.array_equal(h_hit, d_hit)):
            raise AssertionError("lookup_device differs from KmerCountDB.lookup")
    log(f"phase 7b: lookup_device equal to KmerCountDB.lookup on {nq} queries against "
        f"{len(km_all)} keys ({int(h_hit.sum())} hits), medians of 3: host native lookup "
        f"{spread(host_s)[0]:.3f} s, on the card {spread(dev_ms)[0]:.2f} ms, "
        f"{spread(dev_s)[0]:.3f} s with the queries' and the results' copies")


def _sync(device: str):
    """Wait for the card's queued work (nothing to wait for on the CPU)."""
    if device == "cuda":
        import torch

        torch.cuda.synchronize()


def _activities(device: str):
    from torch.profiler import ProfilerActivity

    return [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device == "cuda" else [])


class record_nw_pairs:
    """While active, every needleman_wunsch_batch call of the analysis
    is recorded: `calls` holds each call's list of pairs."""

    def __enter__(self):
        from ploidyfrost_tpu_torch.align import batch_nw

        self.calls = []
        self._orig = batch_nw.needleman_wunsch_batch

        def recording(pairs, *args, **kwargs):
            self.calls.append(list(pairs))
            return self._orig(pairs, *args, **kwargs)

        batch_nw.needleman_wunsch_batch = recording
        return self

    def __exit__(self, *exc):
        from ploidyfrost_tpu_torch.align import batch_nw

        batch_nw.needleman_wunsch_batch = self._orig


class without_native_nw:
    """While active, the native NW flag library counts as unavailable
    (as on a host without a C++ toolchain); the other native libraries
    stay."""

    def __enter__(self):
        from ploidyfrost_tpu_torch import native

        self._orig = native.load_nw_library
        native.load_nw_library = lambda: None

    def __exit__(self, *exc):
        from ploidyfrost_tpu_torch import native

        native.load_nw_library = self._orig


def _filter_then_model(sub: str, inprefix: str, out: str, extra: list[str],
                       device: str) -> tuple[int, int]:
    """`filter` or `filter-multi`, then `model` on `device` on the
    filtered frequencies; returns (ploidy, frequencies kept)."""
    from ploidyfrost_tpu_torch.cli import main as cli_main

    if cli_main([sub, "-i", inprefix, "-o", out, *extra]) != 0:
        raise RuntimeError(f"{sub} {extra} failed on {inprefix}")
    fre = out + "_allele_frequency.txt"
    with open(fre) as f:
        n = sum(1 for _ in f)
    if n == 0:
        raise AssertionError(f"{sub} {extra} kept no frequency of {inprefix}")
    if cli_main(["model", "-g", fre, "-o", out, f"--device={device}"]) != 0:
        raise RuntimeError(f"model failed on {fre}")
    return _model_ploidy(out), n


def post_processing(device: str, work: str, golden_dir: str, colored_dir: str,
                    bench_dir: str, cutoffs: dict):
    """Phase 8: filter / filter-multi -> model on the outputs of phases
    3-5, and `figures` on bench5m's with the GMM on the card and on the
    CPU."""
    import contextlib
    import importlib.util
    import io

    from ploidyfrost_tpu_torch import figures
    from ploidyfrost_tpu_torch.cli import main as cli_main

    os.makedirs(work, exist_ok=True)
    os.chdir(work)
    runs = [
        ("single_diploid", "filter", os.path.join(golden_dir, "PloidyFrost_output", "gold"),
         cutoffs["golden"]),
        ("multi_colored", "filter-multi", os.path.join(colored_dir, "PloidyFrost_output", "gold"),
         cutoffs["colored"]),
        ("bench5m", "filter", os.path.join(bench_dir, "PloidyFrost_output", "bench5m"),
         cutoffs["bench5m"]),
    ]
    for name, sub, inprefix, (lo, up) in runs:
        for tag, extra in (("defaults", []), (f"-l {lo} -u {up}", ["-l", str(lo), "-u", str(up)])):
            ploidy, n = _filter_then_model(sub, inprefix, f"{name}_{len(extra)}", extra,
                                           device)
            log(f"phase 8: {name}: {sub} ({tag}) kept {n} frequencies, model on the card "
                f"gives ploidy {ploidy}")
            if ploidy != 2:
                raise AssertionError(f"{name}: {sub} ({tag}) then model gave ploidy {ploidy}, not 2")

    prefix = runs[2][2]
    cov = 25 * (150 - 25 + 1) / 150 / 2  # bench5m's k-mer coverage a haplotype
    walls, tables = {}, {}
    for side, dev in (("card", device), ("cpu", "cpu")):
        t0 = time.time()
        tables[side] = figures.figure_tables(prefix, f"fig_{side}", [cov], 2, device=dev)
        walls[side] = time.time() - t0
    with open("fig_card_site_stats.tsv", "rb") as f1, open("fig_cpu_site_stats.tsv", "rb") as f2:
        if f1.read() != f2.read():
            raise AssertionError("figures: _site_stats.tsv differs between cuda and cpu")
    with open("fig_card_loglikelihood.tsv") as f1, open("fig_cpu_loglikelihood.tsv") as f2:
        ll_card, ll_cpu = f1.read(), f2.read()
    if not _same_to_6_digits(ll_card, ll_cpu):
        raise AssertionError("figures: _loglikelihood.tsv differs beyond 6 significant digits "
                             "between cuda and cpu")
    t = tables["card"]
    ll_s = {}
    for side, dev in (("card", device), ("cpu", "cpu"), ("cpu", "cpu"), ("card", device)):
        t0 = time.time()
        figures.ll_curves(t["frequency"], t["fre_tiers"], 1, 9, device=dev)
        ll_s.setdefault(side, []).append(time.time() - t0)
    log(f"phase 8: figures tables on bench5m ({len(t['frequency']['fre'])} frequencies, "
        f"{len(t['fre_tiers'])} tiers, 9 gauss counts): _site_stats.tsv byte-equal, "
        f"_loglikelihood.tsv {'byte-equal' if ll_card == ll_cpu else 'equal to 6 significant digits'} "
        f"between the card and the CPU; figure_tables wall {walls['card']:.3f} s on the card "
        f"(first use), {walls['cpu']:.3f} s on the CPU; ll_curves alone "
        + ", ".join(f"{d} {min(v):.3f} s and {max(v):.3f} s" for d, v in ll_s.items()))

    fre = "bench5m_0_allele_frequency.txt"
    if importlib.util.find_spec("matplotlib") is not None:
        if figures.draw_figures(t, "fig_card", [cov], 2) != 0:
            raise RuntimeError("figures: drawing failed")
        if cli_main(["drawfreq", "-f", fre, "-o", "bench5m", "-p", "2"]) != 0:
            raise RuntimeError("drawfreq failed")
        for png in ("fig_card_frequency_density.png", "fig_card_coverage_density.png",
                    "fig_card_loglikelihood.png", "bench5m_allele_frequency.png"):
            if os.path.getsize(png) == 0:
                raise AssertionError(f"{png} is empty")
        log("phase 8: matplotlib present: 4 PNG files drawn")
    else:
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            rc_draw = cli_main(["drawfreq", "-f", fre, "-o", "bench5m", "-p", "2"])
            rc_fig = figures.draw_figures(t, "fig_card", [cov], 2)
        lines = err.getvalue().strip().splitlines()
        if (rc_draw, rc_fig) != (1, 1) or len(lines) != 2 or not all("matplotlib" in x for x in lines):
            raise AssertionError(f"without matplotlib: drawfreq {rc_draw}, figures {rc_fig}, {lines}")
        if any(f.endswith(".png") for f in os.listdir(".")):
            raise AssertionError("a PNG file was written without matplotlib")
        log(f"phase 8: matplotlib absent: PNGs not drawn; drawfreq exits 1 with {lines[0]!r}")


def _synthetic_nw_pairs():
    """A few pairs in every tier from 16 to 2048 (one with '-' in A, so
    the forbidden-Left rule fires) and one pair above the largest tier."""
    import random

    from ploidyfrost_tpu_torch.align.batch_nw import _MAX_TIER

    rng = random.Random(5)

    def seq(n, alphabet="ACGT"):
        return "".join(rng.choice(alphabet) for _ in range(n))

    pairs = []
    tier = 16
    while tier <= _MAX_TIER:
        lo = tier // 2 + 1
        pairs.append((seq(tier), seq(rng.randint(lo, tier))))
        pairs.append((seq(rng.randint(lo, tier)), seq(tier)))
        pairs.append((seq(rng.randint(lo, tier), "ACGT-"), seq(rng.randint(1, tier))))
        tier *= 2
    pairs.append((seq(_MAX_TIER + 52), seq(40)))
    return pairs


def _same_matrices(got, want, what: str):
    for i, (g, w) in enumerate(zip(got, want)):
        for name, a, b in zip(("Up", "LeftUp", "Left"), g, w):
            if a.shape != b.shape or not np.array_equal(a, b):
                raise AssertionError(f"NW {name} matrix of pair {i} differs from {what}")


def nw_wavefront(device: str, work: str, bench_pairs: list,
                 baseline_lib: str | None = None) -> dict:
    """Phase 9: the indel_dense golden on the card, the device wavefront
    (the NW kernel) against the native kernel and the numpy wavefront on
    its real pairs, on bench5m's (`bench_pairs`) and on every tier, the
    kernel against its plain version chunk by chunk and timed, the three
    engines timed, and a traced `run` with the native NW library
    withheld. Returns {launches (that run's NW kernel launches), chunks,
    whole_equal, timing}."""
    import collections

    from ploidyfrost_tpu_torch.align import batch_nw
    from ploidyfrost_tpu_torch.align.nw import _nw_matrix, nw_matrices_native
    from ploidyfrost_tpu_torch.kmer import extract
    from ploidyfrost_tpu_torch.kmer.extract_bench import spread

    os.makedirs(work, exist_ok=True)
    os.chdir(work)
    t0 = time.time()
    make_indel_reads("reads.fa")
    log(f"indel_dense reads generated in {time.time() - t0:.1f} s")
    calls0 = dict(batch_nw.ENGINE_CALLS)
    zero_counts()
    with record_nw_pairs() as rec:
        opt, ploidy, wall = run_pipeline("reads.fa", "gold", device)
    launches = extract.LAUNCHES
    check_counts("the indel_dense pipeline")
    if (opt.coverage_lower, opt.coverage_upper) != (10, 83):
        raise AssertionError(f"indel_dense cutoffs {(opt.coverage_lower, opt.coverage_upper)}")
    model = check_golden_outputs(GOLD_INDEL, ploidy, want_ploidy=4)
    if batch_nw.ENGINE_CALLS["native"] - calls0["native"] != len(rec.calls) or not rec.calls:
        raise AssertionError(f"indel_dense: {len(rec.calls)} batch calls, engines "
                             f"{batch_nw.ENGINE_CALLS} after {calls0}")
    log(f"phase 9: indel_dense golden on the card: 12 tables byte-identical, model {model}, "
        f"ploidy 4, cutoffs (10, 83), pipeline wall {wall:.2f} s, K1 launches {launches}, "
        f"{sum(map(len, rec.calls))} pairs handed to needleman_wunsch_batch (native engine)")

    real = ([p for call in rec.calls for p in call] + bench_pairs)[:2000]
    synth = _synthetic_nw_pairs()
    scoring = (2.0, -1.0, -3.0)
    hist = collections.Counter(batch_nw._tier_of(len(a), len(b)) for a, b in real)
    times = {"native": [], "device": [], "numpy": []}
    t0 = time.time()
    want_np = [_nw_matrix(a, b, *scoring) for a, b in real]
    times["numpy"].append(time.time() - t0)
    for _ in range(3):
        t0 = time.time()
        want_native = nw_matrices_native(real, *scoring)
        times["native"].append(time.time() - t0)
        _sync(device)
        t0 = time.time()
        got = batch_nw.nw_matrices_batched(real, *scoring, device=device)
        _sync(device)
        times["device"].append(time.time() - t0)
        _same_matrices(got, want_native, "the native kernel's")
        _same_matrices(got, want_np, "the numpy wavefront's")
    t0 = time.time()
    got = batch_nw.nw_matrices_batched(synth, *scoring, device=device)
    _sync(device)
    synth_s = time.time() - t0
    _same_matrices(got, nw_matrices_native(synth, *scoring), "the native kernel's (synthetic)")
    _same_matrices(got, [_nw_matrix(a, b, *scoring) for a, b in synth],
                   "the numpy wavefront's (synthetic)")
    steps = sum(2 * t + 1 for t in hist)
    nat, dev = spread(times["native"]), spread(times["device"])
    log(f"phase 9: NW kernel (the device engine) bit-exact against the native kernel and the numpy "
        f"wavefront on {len(real)} real pairs ({len(real) - len(bench_pairs)} of indel_dense, "
        f"{len(bench_pairs)} of bench5m; tiers {dict(sorted(hist.items()))}) and "
        f"{len(synth)} synthetic pairs (tiers 16..2048, dashes in A, one pair above the largest "
        f"tier on the host; {synth_s:.3f} s); engines on the real pairs, copies and de-skew "
        f"included, median [min, max] of 3: native C {nat[0]:.4f} s [{nat[1]:.4f}, {nat[2]:.4f}], "
        f"the NW kernel on the card {dev[0]:.4f} s [{dev[1]:.4f}, {dev[2]:.4f}] over {steps} "
        f"wavefront steps, numpy {times['numpy'][0]:.3f} s (one run)")
    same = nw_buffers_same(real, "phase 9's real pairs")
    log(f"phase 9: NW kernel equal to its plain version on the card and to the native kernel on "
        f"every de-skewed window of the {len(real)} real pairs ({same['chunks']} chunks, "
        f"{same['cells']} cells); whole buffers "
        f"{'equal' if same['whole_equal'] else 'NOT equal outside the windows'}")
    timing = time_nw(real, "phase 9", baseline_lib)

    # one chunk of the commonest tier under the profiler: one kernel
    tier = hist.most_common(1)[0][0]
    lanes = [p for p in real if batch_nw._tier_of(len(p[0]), len(p[1])) == tier][
        : batch_nw._chunk_of(tier)]
    with open("nw_chunk.json", "w") as f:
        json.dump(lanes, f)
    busy, wall = in_fresh_process("profile_nw_chunk", os.path.abspath("nw_chunk.json"), tier,
                                  device)
    if device == "cuda" and busy["kernels"] != 1:
        raise AssertionError(f"a tier-{tier} chunk ran {busy['kernels']} kernels, not one")
    log(f"phase 9: one tier-{tier} chunk of {len(lanes)} lanes under the profiler: "
        f"{busy['kernels']} kernel(s) for its {2 * tier + 1} wavefront steps, kernel time "
        f"{busy['kernel_s']:.6f} s, copies {busy['copy_s']:.6f} s, wall {wall:.4f} s, the card "
        f"busy {100 * busy['busy_share']:.1f}% of it")

    n = in_fresh_process("traced_run_without_native_nw", device, "gold", "nonative",
                         ["-l", "10", "-u", "83"])
    check_golden_tables(GOLD_INDEL, "nonative")
    delta = n.pop("engines")
    launches = n.pop("nw_launches")
    if delta["device"] < 1 or delta["numpy"] or delta["native"]:
        raise AssertionError(f"run without the native NW library used engines {delta}")
    if device == "cuda" and launches < 1:
        raise AssertionError("the run without the native NW library never launched the NW kernel")
    if device == "cuda" and min(n.values()) < 1:
        raise AssertionError(f"the traces of that run hold CUDA kernels {n}")
    log(f"phase 9: `run` on the indel_dense graph with the native NW library withheld, "
        f"--device={device}, under PLOIDYFROST_TRACE: 12 tables byte-identical, engines {delta}, "
        f"NW kernel launches {launches}, findSuperBubble.json holds {n['findSuperBubble']} CUDA "
        f"kernels, ploidyEstimation.json {n['ploidyEstimation']} (the wavefront's)")
    return {"launches": launches, "chunks": same["chunks"], "whole_equal": same["whole_equal"],
            "max_abs_err": same["max_abs_err"], "whole_max_abs_err": same["whole_max_abs_err"],
            "timing": timing}


def profile_nw_chunk(path: str, tier: int, device: str):
    """One chunk (the pairs in the JSON file at `path`) through
    wavefront_packed under the profiler, after one unprofiled run: (the
    card's busy share of it, its wall)."""
    from ploidyfrost_tpu_torch.align import batch_nw
    from ploidyfrost_tpu_torch.util.profiling import device_busy, profiled

    with open(path) as f:
        pairs = json.load(f)
    a_seqs, b_seqs = [a for a, _ in pairs], [b for _, b in pairs]

    batch_nw.wavefront_packed(a_seqs, b_seqs, tier, 2, -1, -3, device)
    _sync(device)
    with profiled(_activities(device)) as prof:
        t0 = time.time()
        batch_nw.wavefront_packed(a_seqs, b_seqs, tier, 2, -1, -3, device)
        _sync(device)
        wall = time.time() - t0
    return device_busy(prof, wall), wall


def _trace_kernels(path: str) -> int:
    """CUDA kernel events in a chrome trace file."""
    with open(path) as f:
        return sum(1 for e in json.load(f)["traceEvents"] if e.get("cat") == "kernel")


def _traced_run(device: str, src_prefix: str, out: str, cutoffs: list[str]) -> dict:
    """`run` on <src_prefix>.gfa and .kmers.npz under PLOIDYFROST_TRACE=
    ./<out>_trace; returns the CUDA kernel events of each phase's trace."""
    from ploidyfrost_tpu_torch.cli import main as cli_main

    trace_dir = os.path.abspath(out + "_trace")
    os.environ["PLOIDYFROST_TRACE"] = trace_dir
    try:
        rc = cli_main(["-g", src_prefix + ".gfa", "-d", src_prefix + ".kmers.npz", "-o", out,
                       *cutoffs, f"--device={device}"])
    finally:
        del os.environ["PLOIDYFROST_TRACE"]
    if rc != 0:
        raise RuntimeError(f"traced run {out} returned {rc}")
    return {name: _trace_kernels(os.path.join(trace_dir, name + ".json"))
            for name in ("findSuperBubble", "ploidyEstimation")}


def traced_run_without_native_nw(device: str, src_prefix: str, out: str,
                                 cutoffs: list[str]) -> dict:
    """`_traced_run` with the native NW library withheld, the NW engines
    it called (under "engines") and its NW kernel launches (under
    "nw_launches")."""
    from ploidyfrost_tpu_torch.align import batch_nw

    calls0 = dict(batch_nw.ENGINE_CALLS)
    batch_nw.NW_LAUNCHES = 0
    with without_native_nw():
        n = _traced_run(device, src_prefix, out, cutoffs)
    n["engines"] = {k: batch_nw.ENGINE_CALLS[k] - calls0[k] for k in calls0}
    n["nw_launches"] = batch_nw.NW_LAUNCHES
    return n


def in_fresh_process(name: str, *args):
    """chip_smoke.<name>(*args) run in a new Python process in this
    directory; its result comes back as JSON. torch.profiler loses the
    device events of whole sessions once a process has run a minute or
    more (on an H100 80GB HBM3, in no pattern that a wait before or after
    the traced block, or a forced CUPTI flush, changed), and none in a
    process that has just started, so every check that reads a trace or
    a profile runs in a process of its own."""
    code = ("import json, sys; import chip_smoke; "
            "print('RESULT ' + json.dumps(getattr(chip_smoke, sys.argv[1])(*json.loads(sys.argv[2]))))")
    proc = subprocess.run([sys.executable, "-c", code, name, json.dumps(args)], cwd=os.getcwd(),
                          env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True, text=True,
                          timeout=900)
    results = [line for line in proc.stdout.splitlines() if line.startswith("RESULT ")]
    if proc.returncode != 0 or not results:
        raise RuntimeError(f"{name} in a fresh process returned {proc.returncode}:\n"
                           f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    return json.loads(results[-1][len("RESULT "):])


def profile_find_superbubbles(gfa: str, device: str) -> dict:
    """bench5m's findSuperBubble twice without the profiler, then once
    under it: the walls, the card's busy share, the kernels it ran and the
    search kernel's among them."""
    from torch.autograd import DeviceType

    from ploidyfrost_tpu_torch.bubble.batched import find_superbubbles_device
    from ploidyfrost_tpu_torch.graph.cdbg import CDBGraph
    from ploidyfrost_tpu_torch.util.profiling import device_busy, profiled

    g = CDBGraph.from_gfa(gfa)
    plain = []
    for _ in range(2):
        _sync(device)
        t0 = time.time()
        _, bubbles = find_superbubbles_device(g, 8, device=device)
        _sync(device)
        plain.append(time.time() - t0)
    with profiled(_activities(device)) as prof:
        t0 = time.time()
        find_superbubbles_device(g, 8, device=device)
        _sync(device)
        wall = time.time() - t0
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA
             and not e.name.startswith(("Memcpy", "Memset"))]
    search_us = sum(e.time_range.elapsed_us() for e in prof.events()
                    if e.device_type == DeviceType.CUDA and "superbubble_search" in e.name)
    return {"unitigs": len(g), "bubbles": len(bubbles), "plain": plain, "wall": wall,
            "busy": device_busy(prof, wall), "names": names, "search_us": search_us}


def tracing(device: str, work: str, golden_dir: str, bench_dir: str) -> dict:
    """Phase 10: the phase traces of the single_diploid `run`, the card's
    busy share of bench5m's superbubble search, and bench5m's nine GMM
    fits under the profiler (one EM kernel a fit, copies that do not grow
    with the iterations), each in a fresh process. Returns the fits'
    profile."""
    os.makedirs(work, exist_ok=True)
    os.chdir(work)
    n = in_fresh_process("_traced_run", device, os.path.join(golden_dir, "gold"), "traced",
                         ["-l", "10", "-u", "37"])
    check_golden_tables(GOLD, "traced")
    if device == "cuda" and n["findSuperBubble"] < 1:
        raise AssertionError(f"the traces of the single_diploid run hold CUDA kernels {n}")
    log(f"phase 10: `run` under PLOIDYFROST_TRACE (single_diploid): tables byte-identical, "
        f"findSuperBubble.json holds {n['findSuperBubble']} CUDA kernels, ploidyEstimation.json "
        f"{n['ploidyEstimation']} (its sites pass is host code while the native NW kernel runs)")

    r = in_fresh_process("profile_find_superbubbles", os.path.join(bench_dir, "bench5m.gfa"),
                         device)
    plain, wall, busy, names, search_us = (r[key] for key in ("plain", "wall", "busy", "names",
                                                             "search_us"))
    n_search = sum("superbubble_search" in x for x in names)
    if device == "cuda" and n_search < 1:
        raise AssertionError(f"the profiler saw no search kernel in findSuperBubble: {names[:20]}")
    # the seeds' range check and the seen width come from the search's own word
    reductions = [x for x in names if "reduce" in x.lower()]
    if reductions:
        raise AssertionError(f"findSuperBubble ran reduction kernels: {reductions[:5]}")
    log(f"phase 10: bench5m findSuperBubble ({r['unitigs']} unitigs, {r['bubbles']} bubbles): "
        f"{plain[0]:.3f} s and {plain[1]:.3f} s without the profiler; under it {wall:.3f} s, "
        f"{busy['kernels']} kernels ({n_search} of them the search kernel, none a reduction, "
        f"{search_us / 1e3:.3f} ms), kernel time {busy['kernel_s']:.4f} s, copies "
        f"{busy['copy_s']:.4f} s: the card busy {100 * busy['busy_share']:.1f}% of the profiled "
        f"phase (idle {100 * (1 - busy['busy_share']):.1f}%), "
        f"{100 * (busy['kernel_s'] + busy['copy_s']) / min(plain):.1f}% of the faster unprofiled "
        "run's wall")

    em = in_fresh_process("profile_em", os.path.join(bench_dir, "PloidyFrost_output",
                                                     "bench5m_allele_frequency.txt"))
    if device == "cuda" and (em["em_kernels"] != 9 or em["launches"] != 9 or em["others"]
                             or em["copies"] > 2 * 9 or em["memsets"]):
        raise AssertionError(f"bench5m's nine fits under the profiler: {em}")
    log(f"phase 10: bench5m's nine GMM fits (iterations {em['counts']}, "
        f"{sum(em['counts'])} in all) under the profiler: {em['em_kernels']} EM kernels "
        f"({em['em_us'] / 1e3:.4f} ms), no other kernel, {em['copies']} copies and "
        f"{em['memsets']} memsets: one launch and one readback a fit, none an iteration, and no "
        "memset (the grid barrier's words reset themselves)")
    return em


def _file_set(d: str) -> set[str]:
    return {os.path.relpath(os.path.join(r, f), d) for r, _, fs in os.walk(d) for f in fs}


def multi_card(work: str, bench: str, reads: str) -> dict:
    """Phase 11a: the sharded counter, EM and search on a one-rank NCCL
    group against the single-device ones, and `pipeline` through that
    group against phase 4's files."""
    import torch
    import torch.distributed as dist

    from ploidyfrost_tpu_torch.bubble import batched
    from ploidyfrost_tpu_torch.bubble.batched import (
        canonical_seeds, find_superbubbles_device, search_seeds)
    from ploidyfrost_tpu_torch.cli import Options, parse_options
    from ploidyfrost_tpu_torch.graph.cdbg import CDBGraph
    from ploidyfrost_tpu_torch.io.fastx import read_batches
    from ploidyfrost_tpu_torch.kmer import extract
    from ploidyfrost_tpu_torch.kmer.count import KmerCounter
    from ploidyfrost_tpu_torch.model import gmm
    from ploidyfrost_tpu_torch.model.gmm import GmmModel
    from ploidyfrost_tpu_torch.parallel.mesh import RankPlan, init_group
    from ploidyfrost_tpu_torch.parallel.sharded import ShardedKmerCounter
    from ploidyfrost_tpu_torch.pipeline import run_pipeline_cli

    os.makedirs(work, exist_ok=True)
    os.chdir(work)
    n_cards = torch.cuda.device_count()
    log(f"phase 11: {n_cards} visible card(s): "
        + ", ".join(torch.cuda.get_device_name(i) for i in range(n_cards)))
    res = {"cards": n_cards}
    plan = RankPlan(local=1, world=1, offset=0, device_type="cuda",
                    init_method="file://" + os.path.join(work, "rendezvous"), timeout_s=600)
    group = init_group(plan, 0)
    log(f"phase 11a: one-rank NCCL group on cuda:0 joined in {group.init_s:.3f} s "
        "(communicator set-up included)")
    try:
        batches = list(read_batches([reads], 25))
        times = {"single": [], "sharded": []}
        finals = {"single": [], "sharded": []}
        peaks = {"single": [], "sharded": []}
        final_peaks = {"single": [], "sharded": []}
        launches, tables = {}, {}
        for side in ("single", "sharded", "sharded", "single"):
            torch.cuda.synchronize()
            extract.LAUNCHES = 0
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.time()
            c = KmerCounter(25, device="cuda") if side == "single" else \
                ShardedKmerCounter(group, 25)
            for b in batches:
                c.add_reads(b)
            c.flush()
            torch.cuda.synchronize()
            t1 = time.time()
            count_peak = torch.cuda.max_memory_allocated()
            final_base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            if side == "sharded":
                c.finalize()
            km, ct = c.arrays()
            t2 = time.time()
            final_peak = torch.cuda.max_memory_allocated()
            peaks[side].append(max(count_peak, final_peak) - base)
            final_peaks[side].append(final_peak - final_base)
            times[side].append(t2 - t0)
            finals[side].append(t2 - t1)
            launches[side] = extract.LAUNCHES
            tables[side] = (km, ct, c.histogram(10000), c.total_kmers)
            if side == "sharded":
                flushes = c.flush_log
            del c
        a, b = tables["single"], tables["sharded"]
        if not (np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
                and np.array_equal(a[2], b[2]) and a[3] == b[3]):
            raise AssertionError("the one-rank sharded counter differs from KmerCounter")
        if launches["sharded"] != launches["single"] or launches["sharded"] == 0:
            raise AssertionError(f"K1 launches: single {launches['single']}, "
                                 f"sharded {launches['sharded']}")
        res["launches"] = launches["sharded"]
        mib = {side: [round(x / 2**20, 1) for x in v] for side, v in peaks.items()}
        final_mib = {side: [round(x / 2**20, 1) for x in v] for side, v in final_peaks.items()}
        log(f"phase 11a: one-rank NCCL group on cuda:0, bench5m ({len(batches)} batches, "
            f"{a[3]} k-mer instances, {len(a[0])} distinct): ShardedKmerCounter table, "
            f"histogram and instance count equal to KmerCounter's; in turns (single, sharded, "
            f"sharded, single): count + finalize wall KmerCounter "
            f"{[round(x, 4) for x in times['single']]} s, ShardedKmerCounter "
            f"{[round(x, 4) for x in times['sharded']]} s; of it the finalize after the last "
            f"flush (the reduction, the table to the host) KmerCounter "
            f"{[round(x, 4) for x in finals['single']]} s, ShardedKmerCounter "
            f"{[round(x, 4) for x in finals['sharded']]} s; peak device memory above what was "
            f"allocated before, count + finalize: KmerCounter {mib['single']} MiB, "
            f"ShardedKmerCounter {mib['sharded']} MiB; of the finalize alone, above what the "
            f"counter held: KmerCounter {final_mib['single']} MiB, ShardedKmerCounter "
            f"{final_mib['sharded']} MiB; K1 launches {launches['single']} and "
            f"{launches['sharded']}; {len(flushes)} flushes, all_to_all key bytes "
            f"{[nb for nb, _ in flushes]}, route + merge s {[round(t, 4) for _, t in flushes]}")
        res["count_peak_mib"], res["finalize_peak_mib"] = mib, final_mib
        res["count_s"], res["finalize_s"] = times, finals

        fre = os.path.join(bench, "PloidyFrost_output", "bench5m_allele_frequency.txt")
        em_s = {"single": 0.0, "sharded": 0.0}
        em_launches = {"single": 0, "sharded": 0}
        worst = 0.0
        for gauss in range(1, 10):
            fits = {}
            for side in ("single", "sharded"):
                model = GmmModel("cuda", group if side == "sharded" else None)
                model.read_fre_file(fre, 0.0)
                model.resize(gauss)
                t0 = time.time()
                before = gmm.EM_LAUNCHES
                model.em_iterate()
                em_s[side] += time.time() - t0
                em_launches[side] += gmm.EM_LAUNCHES - before
                fits[side] = np.concatenate([model.vars, model.weights, [model.log_likelihood]])
            rel = np.abs(fits["sharded"] - fits["single"]) / np.abs(fits["single"])
            worst = max(worst, float(rel.max()))
        if worst != 0.0:
            raise AssertionError(f"sharded EM differs from the single-device EM by {worst:.3g}")
        if min(em_launches.values()) < 9:
            raise AssertionError(f"EM kernel launches single and sharded: {em_launches}")
        res["em_launches"] = em_launches["sharded"]
        log(f"phase 11a: GMM fits on bench5m's {len(model.allele_fre)} frequencies, gauss 1..9, "
            f"through the group: largest relative difference {worst:.3g} (must be 0); "
            f"em_iterate seconds single {em_s['single']:.3f}, sharded {em_s['sharded']:.3f}; EM "
            f"kernel launches single {em_launches['single']} (one a fit), sharded "
            f"{em_launches['sharded']} (a pass and an update an iteration)")

        g = CDBGraph.from_gfa(os.path.join(bench, "bench5m.gfa"))
        seeds = canonical_seeds(g)
        search_s = {}
        outs = {}
        search_launches = {}
        for side in ("single", "sharded"):
            torch.cuda.synchronize()
            batched.SEARCH_LAUNCHES = 0
            t0 = time.time()
            outs[side] = search_seeds(g, seeds, "cuda", group if side == "sharded" else None)
            search_s[side] = time.time() - t0
            search_launches[side] = batched.SEARCH_LAUNCHES
        if not all(np.array_equal(x, y) for x, y in zip(outs["single"], outs["sharded"])):
            raise AssertionError("the sharded search differs from search_seeds")
        if search_launches["sharded"] < 1:
            raise AssertionError("the search through the group never launched the search kernel")
        res["search_launches"] = search_launches["sharded"]
        s1, b1 = find_superbubbles_device(g, 8, device="cuda")
        s2, b2 = find_superbubbles_device(g, 8, device="cuda", group=group)
        if not (np.array_equal(s1.flags, s2.flags) and len(b1) == len(b2)):
            raise AssertionError("the sharded superbubble search found other bubbles")
        log(f"phase 11a: superbubble search on bench5m ({len(seeds)} seeds, {len(b1)} bubbles) "
            f"through the group equal to search_seeds; search seconds single "
            f"{search_s['single']:.3f}, sharded {search_s['sharded']:.3f}; search kernel "
            f"launches {search_launches['single']} and {search_launches['sharded']}")

        d = os.path.join(work, "group_pipeline")
        os.makedirs(d)
        os.chdir(d)
        opt = parse_options(["-o", "bench5m", reads], Options(), extras="c")
        zero_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        if run_pipeline_cli(opt, "cuda", group) != 0:
            raise RuntimeError("pipeline on the one-rank group failed")
        wall = time.time() - t0
        check_counts("the pipeline on the one-rank group")
        same = _same_files(d, bench, "pipeline on the one-rank group")
        log(f"phase 11a: `pipeline` on the one-rank NCCL group: {same} files byte-identical to "
            f"phase 4's one-card run, wall {wall:.3f} s, peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB, stages "
            + ", ".join(f"{k} {v:.3f} s" for k, v in opt.stage_seconds.items()))
    finally:
        os.chdir(work)
        dist.destroy_process_group()
    return res


def _same_files(mine: str, want: str, what: str) -> int:
    """Every file under `mine` byte-identical to the one of that name
    under `want`; returns how many."""
    names = _file_set(mine)
    if not names or not names <= _file_set(want):
        raise AssertionError(f"{what} wrote {sorted(names)}")
    for name in sorted(names):
        with open(os.path.join(mine, name), "rb") as f1, open(os.path.join(want, name), "rb") as f2:
            if f1.read() != f2.read():
                raise AssertionError(f"{what}: {name} differs")
    return len(names)


def _rank_fields(line: str) -> dict:
    """The fields of a `rank r: key value, ...` line, values as floats."""
    pairs = (kv.rsplit(" ", 1) for kv in line.split(": ", 1)[1].split(", "))
    return {k: float(v) for k, v in pairs}


def several_cards(work: str) -> dict:
    """Phase 11b, with two or more cards: `pipeline --devices=N` on
    bench5m and `pipeline-multi --devices=N` on multi3x5m as a user runs
    them (python -m ploidyfrost_tpu_torch.cli, N = min(4, cards)), in
    turns with `--devices=1` in the same call (bench5m 1, N, N, 1;
    multi3x5m 1, N): every file byte-identical to the one-card run's,
    ploidy 2; every rank's line (K1 and search launches, none 0, and EM
    launches, at least nine; peak
    device memory; seconds from its process's start to its group join;
    its stages: only count, the search, the model and the waits on the
    ranks other than 0); and the wall that rank 0's start-to-join and
    stages do not cover. With one card, a line that says so."""
    import torch

    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        log("phase 11b: one card visible: the run on several cards was not possible on this "
            "machine (NCCL takes one rank a card); not measured")
        log("phase 11c: one card visible: the run in two processes of two cards each was not "
            "possible on this machine; not measured")
        return {}
    n = min(4, n_cards)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=30).stdout.strip().splitlines()
    log(f"phase 11b: {n_cards} cards: " + "; ".join(smi))
    os.makedirs(work, exist_ok=True)
    os.chdir(work)
    t0 = time.time()
    make_bench5m_reads("bench5m_reads.fa")
    samples = [os.path.basename(p) for p in make_sample_reads(".", 5_000_000)]
    log(f"phase 11b: bench5m and multi3x5m reads generated in {time.time() - t0:.1f} s")
    env = dict(os.environ, PYTHONPATH=ROOT)
    starts = []
    for _ in range(2):  # what a command pays before it can spawn ranks
        t0 = time.time()
        subprocess.run([sys.executable, "-c", "import torch, ploidyfrost_tpu_torch.cli; "
                        "torch.cuda.device_count()"], env=env, check=True, timeout=300)
        starts.append(time.time() - t0)
    log(f"phase 11b: a Python process that imports torch and the CLI and counts the cards: "
        f"{starts[0]:.3f} s and {starts[1]:.3f} s")
    runs = [("pipeline", "bench5m", ["bench5m_reads.fa"], dev) for dev in (1, n, n, 1)]
    runs += [("pipeline-multi", "multi", samples, dev) for dev in (1, n)]
    res = {"devices": n, "runs": [], "command_start_s": starts}
    first = {}
    for i, (cmd, prefix, inputs, dev) in enumerate(runs):
        d = os.path.join(work, f"run{i}")
        os.makedirs(d)
        t0 = time.time()
        proc = subprocess.run(
            [sys.executable, "-m", "ploidyfrost_tpu_torch.cli", cmd, "-o", prefix,
             *(os.path.join("..", x) for x in inputs), f"--devices={dev}"],
            cwd=d, env=env, capture_output=True, text=True, timeout=900)
        wall = time.time() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"{cmd} --devices={dev} returned {proc.returncode}:\n"
                               f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        if _model_ploidy(os.path.join(d, prefix)) != 2:
            raise AssertionError(f"{cmd} --devices={dev}: ploidy is not 2")
        if cmd not in first:
            first[cmd] = d
            same = len(_file_set(d))
        elif _same_files(d, first[cmd], f"{cmd} --devices={dev}") != len(_file_set(first[cmd])):
            raise AssertionError(f"{cmd} --devices={dev} wrote fewer files than --devices=1")
        ranks = [line for line in proc.stdout.splitlines() if line.startswith("rank ")]
        row = {"cmd": cmd, "devices": dev, "wall": wall, "ranks": ranks}
        res["runs"].append(row)
        if dev == 1:
            log(f"phase 11b: `{cmd} --devices=1` on {prefix}: wall {wall:.3f} s (process start "
                f"included), {same} files")
            continue
        fields = [_rank_fields(line) for line in ranks]
        if len(ranks) != n or any(f["K1 launches"] == 0 or f["search launches"] == 0
                                  or f["EM launches"] < 9 for f in fields):
            raise AssertionError(f"rank lines {ranks}")
        if any("build_graph s" in f or "sites s" in f for f in fields[1:]):
            raise AssertionError(f"a rank other than 0 built or ran the sites pass: {ranks}")
        stages = {k: v for k, v in fields[0].items() if k.endswith(" s") and k not in (
            "start to join s", "group init s", "route+merge s", "color_graph s", "finalize s")}
        rest = wall - fields[0]["start to join s"] - sum(stages.values())
        row["outside_stages_s"] = rest
        log(f"phase 11b: `{cmd} --devices={n}` on {prefix}: {same} files byte-identical to "
            f"`--devices=1`'s, wall {wall:.3f} s: rank 0's process start to group join "
            f"{fields[0]['start to join s']:.3f} s, its stages {sum(stages.values()):.3f} s "
            f"({', '.join(f'{k} {v:.3f}' for k, v in stages.items())}), the rest {rest:.3f} s "
            "(the command's own start before it spawns the ranks, the steps no stage times, "
            "the ranks' exit)")
        for line in ranks:
            log(f"phase 11b: {line}")
    res["multi_host"] = multi_host(work, first, res["runs"], samples)
    return res


def _descendants(pid: int) -> set[int]:
    """Every live process below `pid` (from /proc; zombies left out)."""
    parent = {}
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if fields[0] != "Z":
            parent[int(d)] = int(fields[1])
    out, todo = set(), [pid]
    while todo:
        p = todo.pop()
        kids = [c for c, pp in parent.items() if pp == p]
        out.update(kids)
        todo += kids
    return out


def _alive(pids) -> set[int]:
    out = set()
    for p in pids:
        try:
            with open(f"/proc/{p}/stat") as f:
                if f.read().rsplit(")", 1)[1].split()[0] != "Z":
                    out.add(p)
        except OSError:
            pass
    return out


def _free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _host_env(pid: int, port: int, **extra) -> dict:
    """The environment of process `pid` of two on this host: its two
    cards through CUDA_VISIBLE_DEVICES, the coordinator, and no
    PLOIDYFROST_LOCAL_DEVICES (each process counts the cards it sees)."""
    env = dict(os.environ, PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES="0,1" if pid == 0 else "2,3",
               PLOIDYFROST_COORDINATOR=f"127.0.0.1:{port}", PLOIDYFROST_NUM_PROCESSES="2",
               PLOIDYFROST_PROCESS_ID=str(pid), **extra)
    for name in ("PLOIDYFROST_LOCAL_DEVICES", "PLOIDYFROST_DEVICES"):
        env.pop(name, None)
    return env


def _nvidia_smi_pids() -> set[int]:
    """The pids nvidia-smi lists as compute processes on the cards (none
    where it cannot list them, which the caller logs)."""
    smi = subprocess.run(["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=30)
    if smi.returncode != 0:
        log(f"phase 11c: nvidia-smi --query-compute-apps failed: {smi.stderr.strip()}")
        return set()
    return {int(x) for x in smi.stdout.split() if x.strip().isdigit()}


def multi_host(work: str, single: dict, runs_11b: list, samples: list) -> dict:
    """Phase 11c, with four or more cards: the multi-host entry point as
    two hosts run it, two processes of two cards each on this machine
    (CUDA_VISIBLE_DEVICES 0,1 and 2,3) joined through
    PLOIDYFROST_COORDINATOR into one NCCL group of four ranks. Process 1
    starts first and runs in an empty directory of its own, its inputs
    given by absolute path. `pipeline` on bench5m and `pipeline-multi` on
    multi3x5m must write the files of 11b's `--devices=1` runs (`single`:
    command -> directory) byte for byte, ploidy 2, four rank lines with
    K1, search and EM launches (EM at least nine), nothing in process
    1's directory, exit code 0 from both. Then a host dies mid-run:
    process 1's whole session is killed once rank 0 has printed its
    cutoffs (past every all_to_all of the count and the shards' way to
    rank 0), and process 0 must exit non-zero within PLOIDYFROST_TIMEOUT
    (120 s) + 60 s, leaving no rank of either process. With fewer than
    four cards, a line that says so."""
    import signal
    import threading

    import torch

    if torch.cuda.device_count() < 4:
        log(f"phase 11c: {torch.cuda.device_count()} cards visible: the run in two processes "
            "of two cards each was not possible on this machine; not measured")
        return {}
    res = {"runs": []}
    jobs = [("pipeline", "bench5m", ["bench5m_reads.fa"]), ("pipeline-multi", "multi", samples)]
    for cmd, prefix, inputs in jobs:
        dirs = [os.path.join(work, f"host_{cmd}_p{pid}") for pid in (0, 1)]
        for d in dirs:
            os.makedirs(d)
        # process 0 names its inputs as 11b's runs did (the sample names
        # land in multi.colors.npz), process 1 by absolute path
        argv = {pid: [sys.executable, "-m", "ploidyfrost_tpu_torch.cli", cmd, "-o", prefix,
                      *(os.path.join(work if pid else "..", x) for x in inputs), "--devices=4"]
                for pid in (0, 1)}
        port = _free_port()
        nccl_logs = os.path.join(work, f"nccl_{cmd}")
        os.makedirs(nccl_logs)
        nccl = {"NCCL_DEBUG": "INFO", "NCCL_DEBUG_FILE": os.path.join(nccl_logs, "%h.%p.log")}
        logs = {pid: [open(os.path.join(work, f"host_{cmd}_p{pid}.{x}"), "w+") for x in
                      ("out", "err")] for pid in (0, 1)}  # outside the processes' directories
        t0 = time.time()
        procs = {}
        try:
            for pid in (1, 0):  # process 1 first: it waits for rank 0's store
                procs[pid] = subprocess.Popen(argv[pid], cwd=dirs[pid],
                                              env=_host_env(pid, port, **nccl),
                                              stdout=logs[pid][0], stderr=logs[pid][1], text=True)
                if pid == 1:
                    time.sleep(1.0)
            for pid in (0, 1):
                procs[pid].wait(timeout=900)
        finally:
            for proc in procs.values():
                proc.kill()
                proc.wait()
        wall = time.time() - t0
        outs = {}
        for pid, files in logs.items():
            outs[pid] = []
            for f in files:
                f.seek(0)
                outs[pid].append(f.read())
                f.close()
        for pid in (0, 1):
            if procs[pid].returncode != 0:
                raise RuntimeError(
                    f"phase 11c: {cmd} process {pid} returned {procs[pid].returncode}:\n"
                    f"{outs[pid][0][-3000:]}\n{outs[pid][1][-3000:]}")
        if os.listdir(dirs[1]):
            raise AssertionError(f"phase 11c: process 1 wrote {os.listdir(dirs[1])}")
        if _model_ploidy(os.path.join(dirs[0], prefix)) != 2:
            raise AssertionError(f"phase 11c: {cmd}: ploidy is not 2")
        same = _same_files(dirs[0], single[cmd], f"phase 11c {cmd}")
        if same != len(_file_set(single[cmd])):
            raise AssertionError(f"phase 11c: {cmd} wrote fewer files than --devices=1")
        ranks = [line for line in outs[0][0].splitlines() if line.startswith("rank ")]
        fields = [_rank_fields(line) for line in ranks]
        if len(ranks) != 4 or any(f["K1 launches"] == 0 or f["search launches"] == 0
                                  or f["EM launches"] < 9 for f in fields):
            raise AssertionError(f"phase 11c: rank lines {ranks}")
        if any(line.startswith("rank ") for line in outs[1][0].splitlines()):
            raise AssertionError("phase 11c: process 1 printed rank lines")
        via = {}  # e.g. "Channel 00/0 : 1[1] -> 2[0] via SHM/direct/direct"
        for name in os.listdir(nccl_logs):
            with open(os.path.join(nccl_logs, name), errors="replace") as f:
                for line in f:
                    if " via " in line:
                        kind = line.split(" via ", 1)[1].split()[0]
                        via[kind] = via.get(kind, 0) + 1
        one = [r["wall"] for r in runs_11b if r["cmd"] == cmd and r["devices"] == 1]
        four = [r["wall"] for r in runs_11b if r["cmd"] == cmd and r["devices"] != 1]
        row = {"cmd": cmd, "wall": wall, "ranks": ranks, "nccl_via": via,
               "walls_11b_one": one, "walls_11b_several": four}
        res["runs"].append(row)
        log(f"phase 11c: `{cmd} --devices=4` on {prefix} in two processes of two cards each: "
            f"{same} files byte-identical to `--devices=1`'s, ploidy 2, process 1's directory "
            f"empty, wall {wall:.3f} s (from process 1's start to both exits; in this call 11b's "
            f"one-process `--devices=4`: {', '.join(f'{w:.3f}' for w in four)} s, "
            f"`--devices=1`: {', '.join(f'{w:.3f}' for w in one)} s)")
        log(f"phase 11c: {cmd}: rank 0's finalize (the shards of ranks 1-3 received, ranks 2-3 "
            f"from process 1) {fields[0]['finalize s']:.4f} s; start to join "
            + ", ".join(f"rank {r} {f['start to join s']:.3f} s" for r, f in enumerate(fields))
            + "; peak device MiB "
            + ", ".join(f"rank {r} {f.get('peak device MiB', float('nan')):.1f}"
                        for r, f in enumerate(fields)))
        log(f"phase 11c: {cmd}: NCCL transports named in its INFO lines: "
            + (", ".join(f"{k} x{v}" for k, v in sorted(via.items())) or "none logged"))
        for line in ranks:
            log(f"phase 11c: {line}")

    # a host dies mid-run
    dirs = [os.path.join(work, f"host_dead_p{pid}") for pid in (0, 1)]
    for d in dirs:
        os.makedirs(d)
    timeout = 120
    argv = [sys.executable, "-m", "ploidyfrost_tpu_torch.cli", "pipeline", "-o", "dead",
            os.path.join(work, "bench5m_reads.fa"), "--devices=4"]
    port = _free_port()
    smi_before = _nvidia_smi_pids()
    errs = [open(os.path.join(work, f"host_dead_p{pid}.err"), "w+") for pid in (0, 1)]
    procs = {}
    seen: set[int] = set()
    lines: list[str] = []
    past = threading.Event()
    try:
        for pid in (1, 0):
            procs[pid] = subprocess.Popen(argv, cwd=dirs[pid],
                                          env=_host_env(pid, port, PLOIDYFROST_TIMEOUT=str(timeout)),
                                          stdout=subprocess.PIPE, stderr=errs[pid], text=True,
                                          start_new_session=(pid == 1))
            if pid == 1:
                time.sleep(1.0)

        def read_rank0():
            for line in procs[0].stdout:
                lines.append(line)
                if line.startswith("pipeline: cutoffs"):
                    past.set()
            past.set()

        reader = threading.Thread(target=read_rank0, daemon=True)
        reader.start()
        while not past.wait(0.5):
            for proc in procs.values():
                seen |= _descendants(proc.pid)
        if procs[0].poll() is not None or procs[1].poll() is not None:
            raise RuntimeError("phase 11c: a process ended before rank 0 printed its cutoffs:\n"
                               + "".join(lines[-40:]))
        for proc in procs.values():
            seen |= _descendants(proc.pid)
        ranks_pids = set(seen)
        smi_during = _nvidia_smi_pids()
        t_kill = time.time()
        os.killpg(procs[1].pid, signal.SIGKILL)
        try:
            rc0 = procs[0].wait(timeout=timeout + 120)
        except subprocess.TimeoutExpired:
            rc0 = None
        ended_s = time.time() - t_kill
        procs[1].wait(timeout=30)
        deadline = time.time() + 20
        while _alive(ranks_pids) and time.time() < deadline:
            time.sleep(0.5)
        left = _alive(ranks_pids)
        smi_after = _nvidia_smi_pids()
        reader.join(10)
    finally:
        for pid, proc in procs.items():
            if proc.poll() is None:
                if pid == 1:
                    os.killpg(proc.pid, signal.SIGKILL)
                proc.kill()
            proc.wait()
        for f in errs:
            f.flush()
    errs[0].seek(0)
    err0 = errs[0].read()
    for f in errs:
        f.close()
    cause = [ln.strip() for ln in err0.splitlines()
             if "Watchdog" in ln or "timed out" in ln.lower() or "timeout" in ln.lower()][:3]
    res["dead_host"] = {"rc": rc0, "seconds": ended_s, "ranks_left": sorted(left),
                        "rank_pids": sorted(ranks_pids), "smi_during": sorted(smi_during),
                        "smi_after": sorted(smi_after)}
    log(f"phase 11c: a host dies mid-run: process 1's session (its CLI process, its two ranks "
        f"and their helpers, pids {sorted(ranks_pids)} with process 0's) killed once rank 0 "
        f"printed its cutoffs; process 0 exited with {rc0} {ended_s:.3f} s later "
        f"(PLOIDYFROST_TIMEOUT={timeout} s, limit {timeout + 60} s); processes of either "
        f"session left: {sorted(left) or 'none'}; nvidia-smi compute pids before "
        f"{sorted(smi_before)}, during {sorted(smi_during)}, after {sorted(smi_after)}")
    log("phase 11c: what process 0 reported: "
        + " | ".join(cause or [ln.strip() for ln in err0.splitlines()[-6:]]))
    if rc0 in (None, 0) or ended_s > timeout + 60:
        raise AssertionError(f"phase 11c: process 0 returned {rc0} after {ended_s:.1f} s")
    # nvidia-smi may name the processes by another pid namespace's pids:
    # no compute process may hold a card after that did not before
    if left or (smi_after - smi_before):
        raise AssertionError(f"phase 11c: processes left: {sorted(left)}, "
                             f"nvidia-smi {sorted(smi_after - smi_before)}")
    if os.listdir(dirs[1]):
        raise AssertionError(f"phase 11c: process 1 wrote {os.listdir(dirs[1])}")
    log("phase 11c: passed")
    return res


def zero_counts():
    """Every kernel's launch count to 0, just before a main path runs."""
    from ploidyfrost_tpu_torch.align import batch_nw
    from ploidyfrost_tpu_torch.bubble import batched
    from ploidyfrost_tpu_torch.kmer import extract
    from ploidyfrost_tpu_torch.model import gmm

    extract.LAUNCHES = batched.SEARCH_LAUNCHES = gmm.EM_LAUNCHES = batch_nw.NW_LAUNCHES = 0


def check_counts(what: str, fits: int = 9):
    """A pipeline path launched K1 and the search kernel, and the EM
    kernel once a fit (`fits`: gauss 1..9)."""
    from ploidyfrost_tpu_torch.bubble import batched
    from ploidyfrost_tpu_torch.kmer import extract
    from ploidyfrost_tpu_torch.model import gmm

    if extract.LAUNCHES == 0 or batched.SEARCH_LAUNCHES == 0 or gmm.EM_LAUNCHES < fits:
        raise AssertionError(f"{what} launches: K1 {extract.LAUNCHES}, search "
                             f"{batched.SEARCH_LAUNCHES}, EM {gmm.EM_LAUNCHES} (want >= {fits})")


def card_name_and_power() -> str:
    """The first card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30,
    )
    if smi.returncode != 0 or not smi.stdout.strip():
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr.strip()}")
    return smi.stdout.strip().splitlines()[0]


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description="Smoke test of ploidyfrost_tpu_torch on one GPU.")
    ap.add_argument("--baseline-cu", help="an earlier K1 source, C ABI pf_extract_canonical"
                    "(codes, B, L, k, out, stream), to build and time beside K1 in this call")
    ap.add_argument("--baseline-search-cu",
                    help="an earlier search kernel source, C ABI pf_superbubble_search(seeds, S, "
                    "succ, n, ms, mstk, max_steps, status, psec, nseen, seen, cyc, stream), to "
                    "build and time beside the search kernel in this call")
    ap.add_argument("--baseline-em-cu",
                    help="an earlier EM kernel source, C ABI pf_gmm_em_plan(n, g, blocks, "
                    "work_doubles) and pf_gmm_em(af, n, means, w, v, g, max_iter, m_thre, n_thre, "
                    "max_delta, work, out, stream), to build and time beside the EM kernel")
    ap.add_argument("--baseline-nw-cu",
                    help="an earlier NW kernel source, C ABI pf_nw_wavefront(a, b, a_len, CH, T, "
                    "match, dis, gap, out, stream), to build and time beside the NW kernel")
    ap.add_argument("--profile-multi", action="store_true",
                    help="run multi3x5m under cProfile and print its 40 largest entries")
    ap.add_argument("--several-cards-only", action="store_true",
                    help="run phases 11b and 11c alone: several cards against one, and two "
                    "processes of two cards each, on a machine with four")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from ploidyfrost_tpu_torch.bubble import batched
    from ploidyfrost_tpu_torch.kmer import extract
    from ploidyfrost_tpu_torch.model import gmm

    if "jax" in sys.modules or "ploidyfrost_tpu" in sys.modules:
        raise AssertionError("the port pulled in jax or ploidyfrost_tpu")
    sources = {key: os.path.abspath(path) for key, path in (
        ("k1", args.baseline_cu), ("search", args.baseline_search_cu),
        ("em", args.baseline_em_cu), ("nw", args.baseline_nw_cu)) if path}
    # phases 1-10 on one card, however many the machine holds; phase 11
    # asks for more with --devices=N
    os.environ["PLOIDYFROST_DEVICES"] = "1"
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)

    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}, {card_name_and_power()}")
    if args.several_cards_only:
        if not several_cards(os.path.join(WORK, "several_cards")):
            return 1
        return finish(torch)
    build_s, base_libs, probe_lib = build_kernels(sources)
    baseline_lib, baseline_search_lib = base_libs.get("k1"), base_libs.get("search")
    log(f"phase 1: kernels built in {build_s:.2f} s")
    default_tile = search_attributes()
    em_nw_attributes()

    err, n_cases = check_extract()
    log(f"phase 2: K1 bit-exact against its plain version on {n_cases} cases, "
        f"fused count equal to the plain count")
    search_cases, search_err = check_search()
    em_check = check_em()
    nw_check = check_nw_kernel()

    zero_counts()
    golden("cuda", os.path.join(WORK, "golden"))
    check_counts("the golden pipeline")
    log(f"phase 3: golden passed, K1 launches {extract.LAUNCHES}, "
        f"search launches {batched.SEARCH_LAUNCHES}, EM launches {gmm.EM_LAUNCHES}")

    libs = native_libraries()
    log("native host libraries: " + ", ".join(
        f"{name} {'loaded' if ok else 'NOT loaded'}" for name, ok in libs.items()))
    if not all(libs.values()):
        raise AssertionError("a native host library did not load: "
                             + ", ".join(name for name, ok in libs.items() if not ok))
    bench = os.path.join(WORK, "bench5m")
    os.makedirs(bench)
    os.chdir(bench)
    t0 = time.time()
    make_bench5m_reads("bench5m_reads.fa")
    log(f"bench5m reads generated in {time.time() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    with record_nw_pairs() as bench_nw:
        opt, ploidy, wall = run_pipeline("bench5m_reads.fa", "bench5m", "cuda")
    launches = extract.LAUNCHES
    search_launches = batched.SEARCH_LAUNCHES
    em_launches = gmm.EM_LAUNCHES
    peak = torch.cuda.max_memory_allocated()
    check_counts("the bench5m pipeline")
    if ploidy != 2:
        raise AssertionError(f"bench5m ploidy {ploidy} != 2")
    for stage, sec in opt.stage_seconds.items():
        log(f"bench5m stage {stage}: {sec:.3f} s")
    log(f"bench5m: pipeline wall {wall:.3f} s, cutoffs ({opt.coverage_lower}, "
        f"{opt.coverage_upper}), ploidy {ploidy}, K1 launches {launches}, "
        f"search launches {search_launches}, EM launches {em_launches}, peak device memory "
        f"{peak / 2**30:.3f} GiB, {sum(map(len, bench_nw.calls))} pairs handed to "
        "needleman_wunsch_batch")
    bench_fre = read_frequencies(os.path.join(bench, "PloidyFrost_output",
                                              "bench5m_allele_frequency.txt"))
    em_real = check_em_fits({"bench5m": bench_fre})
    log(f"EM kernel on bench5m's frequencies: largest relative difference from the plain "
        f"version {em_real['worst_rel']:.3g} (tolerance {EM_RTOL:g})")
    tem = time_em(bench_fre, "bench5m", base_libs.get("em"))
    bench_gfa = os.path.join(bench, "bench5m.gfa")
    cases, err = check_search_real(bench_gfa, "bench5m")
    search_cases, search_err = search_cases + cases, max(search_err, err)
    latency = load_latency_us(probe_lib)
    log(f"dependent global load (one thread, a chain through 4 MB of 32-byte sectors): "
        f"{latency['cold_us']:.3f} us cold (L2 scrubbed), {latency['warm_us']:.3f} us from L2")
    ts = time_search(bench_gfa, "bench5m", baseline_search_lib)
    log_search_times("bench5m", ts, latency, default_tile)

    t = time_extract(baseline_lib)
    ms = t["ms"][0]
    share = t["bound_ms"] / ms
    log("K1 at B=16384 L=160 k=25, per launch (median [min, max]): "
        f"kernel {ms:.4f} ms [{t['ms'][1]:.4f}, {t['ms'][2]:.4f}], "
        f"main-path call {t['main_ms'][0]:.4f} ms [{t['main_ms'][1]:.4f}, {t['main_ms'][2]:.4f}], "
        f"plain {t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms ({t['bound_by']}), "
        f"{100 * share:.1f}% of bound; main-path call {t['main_host_us']:.1f} us of host time; "
        f"back to back in a CUDA graph on rotating buffers {t['graph_ms']:.4f} ms a launch; "
        f"same timing, torch fill of the same output {t['fill_ms']:.4f} ms, "
        f"one-element kernel {t['launch_ms']:.4f} ms")
    if "baseline_ms" in t:
        b = t["baseline_ms"]
        log(f"baseline K1 ({args.baseline_cu}) in the same call: {b[0]:.4f} ms "
            f"[{b[1]:.4f}, {b[2]:.4f}]")
    kernels_seen = in_fresh_process("profile_batch")
    log(f"profiler, one add_reads of a [16384, 160] batch on the card: {kernels_seen}")
    if len(kernels_seen) != 1 or "extract_canonical" not in kernels_seen[0]:
        raise AssertionError(f"a counter batch ran {kernels_seen}, not K1 alone")
    log("phase 4: bench5m passed")

    zero_counts()
    golden_colored("cuda", os.path.join(WORK, "golden_colored"))
    check_counts("the colored golden")
    log(f"phase 5: colored golden passed, K1 launches {extract.LAUNCHES}, "
        f"search launches {batched.SEARCH_LAUNCHES}, EM launches {gmm.EM_LAUNCHES}")

    multi = multi3x5m("cuda", os.path.join(WORK, "multi3x5m"), profile=args.profile_multi)
    multi_fre = read_frequencies(os.path.join(WORK, "multi3x5m", "PloidyFrost_output",
                                              "multi_allele_frequency.txt"))
    em_multi = check_em_fits({"multi3x5m": multi_fre})
    log(f"EM kernel on multi3x5m's frequencies: largest relative difference from the plain "
        f"version {em_multi['worst_rel']:.3g} (tolerance {EM_RTOL:g})")
    cases, err = check_search_real(multi["gfa"], "multi3x5m")
    search_cases, search_err = search_cases + cases, max(search_err, err)
    ts_multi = time_search(multi["gfa"], "multi3x5m", baseline_search_lib)
    log_search_times("multi3x5m", ts_multi, latency, default_tile)
    log(f"phase 6: multi3x5m passed; search kernel bit-exact on {search_cases} cases in all")

    torch_programs("cuda", os.path.join(WORK, "programs"),
                   os.path.join(bench, "bench5m_reads.fa"),
                   os.path.join(bench, "bench5m.kmers.npz"), opt.coverage_lower)
    log("phase 7: device link sort and device lookup passed")

    post_processing(
        "cuda", os.path.join(WORK, "post"), os.path.join(WORK, "golden"),
        os.path.join(WORK, "golden_colored"), bench,
        {"golden": (10, 37), "bench5m": (opt.coverage_lower, opt.coverage_upper),
         "colored": (min(lo for lo, _ in COLORED_CUTOFFS), max(up for _, up in COLORED_CUTOFFS))})
    log("phase 8: post-processing passed")

    nw = nw_wavefront("cuda", os.path.join(WORK, "indel_dense"),
                      [p for call in bench_nw.calls for p in call], base_libs.get("nw"))
    log("phase 9: NW wavefront passed")

    em_profile = tracing("cuda", os.path.join(WORK, "tracing"), os.path.join(WORK, "golden"),
                         bench)
    log("phase 10: tracing passed")

    cards = multi_card(os.path.join(WORK, "multi_card"), bench,
                       os.path.join(bench, "bench5m_reads.fa"))
    several_cards(os.path.join(WORK, "several_cards"))
    log("phase 11: several cards passed")
    if "jax" in sys.modules or "ploidyfrost_tpu" in sys.modules:
        raise AssertionError("the port pulled in jax or ploidyfrost_tpu")

    smi = card_name_and_power()
    os.chdir(ROOT)
    shutil.rmtree(WORK, ignore_errors=True)
    kernels = {"kernels": [{
        "name": "extract_canonical",
        "route": "cuda",
        "source": "ploidyfrost_tpu_torch/csrc/extract_canonical.cu",
        "replaces": "ploidyfrost_tpu/kmer/pallas_extract.py:88",
        "launches": launches,
        "launches_multi3x5m": multi["launches"],
        "launches_sharded_one_rank": cards["launches"],
        "max_abs_err": float(err),
        "ms": ms,
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"],
        "library_ms": None,
        "share_of_bound": share,
    }, {
        "name": "superbubble_search",
        "route": "cuda",
        "source": "ploidyfrost_tpu_torch/csrc/superbubble_search.cu",
        "replaces": "ploidyfrost_tpu/bubble/batched.py:105",
        "launches": search_launches,
        "launches_multi3x5m": multi["search_launches"],
        "launches_sharded_one_rank": cards["search_launches"],
        "cases": search_cases,
        "tiles_checked": list(batched.TILES),
        "max_abs_err": float(search_err),
        "tile": default_tile,
        "ms": ts["ms"][0],
        "plain_ms": ts["plain_ms"],
        "bound_ms": ts["bound_ms"],
        "bound_by": ts["bound_by"],
        "library_ms": None,
        "share_of_bound": ts["share"],
        "main_ms": ts["main_ms"][0],
        "latency_floor_ms": ts["floor_ms"],
        "max_seed_steps": ts["max_seed_steps"],
        "baseline_ms": ts["baseline_ms"][0] if "baseline_ms" in ts else None,
        "ms_by_tile": {str(k): v[0] for k, v in ts["tiles"].items()},
        "multi3x5m": {"seeds": ts_multi["seeds"], "ms": ts_multi["ms"][0],
                      "main_ms": ts_multi["main_ms"][0], "bound_ms": ts_multi["bound_ms"],
                      "share_of_bound": ts_multi["share"],
                      "latency_floor_ms": ts_multi["floor_ms"],
                      "max_seed_steps": ts_multi["max_seed_steps"],
                      "baseline_ms": (ts_multi["baseline_ms"][0] if "baseline_ms" in ts_multi
                                      else None),
                      "ms_by_tile": {str(k): v[0] for k, v in ts_multi["tiles"].items()}},
    }, {
        "name": "gmm_em",
        "route": "cuda",
        "source": "ploidyfrost_tpu_torch/csrc/gmm_em.cu",
        "replaces": "ploidyfrost_tpu/model/gmm.py:61",
        "launches": em_launches,
        "launches_multi3x5m": multi["em_launches"],
        "launches_sharded_one_rank": cards["em_launches"],
        "fits_checked": em_check["fits"] + em_real["fits"] + em_multi["fits"],
        "max_abs_err": max(em_check["worst_abs"], em_real["worst_abs"], em_multi["worst_abs"]),
        "max_rel_err": max(em_check["worst_rel"], em_real["worst_rel"], em_multi["worst_rel"]),
        "ms": tem["ms"],
        "plain_ms": tem["plain_ms"],
        "bound_ms": tem["bound_ms"],
        "bound_by": tem["bound_by"],
        "library_ms": None,
        "share_of_bound": tem["bound_ms"] / tem["ms"],
        "latency_floor_ms": tem["floor_ms"],
        "barrier_us": tem["barrier_ms"] * 1e3,
        "launch_us": tem["launch_ms"] * 1e3,
        "baseline_ms": tem["baseline_ms"],
        "registers": tem["registers"],
        "blocks": tem["blocks"],
        "sms_used": max(f["sms_used"] for f in tem["fits"]),
        "what": "the nine fits (g = 1..9) of bench5m's model stage, one launch each",
        "by_gauss": [{"g": f["g"], "iterations": f["count"], "ms": f["ms"][0],
                      "baseline_ms": f["baseline_ms"][0] if f["baseline_ms"] else None,
                      "blocks": f["blocks"], "sms_used": f["sms_used"],
                      "plain_ms": f["plain_ms"][0], "bound_ms": f["bound_ms"],
                      "latency_floor_ms": f["floor_ms"], "pass_us": f["pass_body_ms"] * 1e3,
                      "pass_floor_us": f["pass_floor_ms"] * 1e3,
                      "chain_us": f["chain_ms"] * 1e3, "reduce_us": f["reduce_ms"] * 1e3}
                     for f in tem["fits"]],
        "profiled_fits": em_profile,
    }, {
        "name": "nw_wavefront",
        "route": "cuda",
        "source": "ploidyfrost_tpu_torch/csrc/nw_wavefront.cu",
        "replaces": "ploidyfrost_tpu/align/batch_nw.py:78",
        "launches": nw["launches"],
        "chunks_checked": nw_check["chunks"] + nw["chunks"],
        "whole_buffers_equal": nw_check["whole_equal"] and nw["whole_equal"],
        "max_abs_err": float(max(nw_check["max_abs_err"], nw["max_abs_err"])),
        "whole_buffers_max_abs_err": float(max(nw_check["whole_max_abs_err"],
                                               nw["whole_max_abs_err"])),
        "ms": nw["timing"]["ms"],
        "plain_ms": nw["timing"]["plain_ms"],
        "bound_ms": nw["timing"]["bound_ms"],
        "bound_by": nw["timing"]["bound_by"],
        "library_ms": None,
        "share_of_bound": nw["timing"]["bound_ms"] / nw["timing"]["ms"],
        "baseline_ms": nw["timing"]["baseline_ms"],
        "registers": max(v["attrs"]["registers"] for v in nw["timing"]["tiers"].values()),
        "sms_used": max(v["attrs"]["sms_used"] for v in nw["timing"]["tiers"].values()),
        "what": "every chunk of phase 9's real pairs, one launch each",
        "by_tier": {str(t): {**{k: v[k] for k in ("pairs", "chunks", "ms", "plain_ms", "bound_ms",
                                                  "baseline_ms")},
                             **{k: v["attrs"][k] for k in ("registers", "warps", "blocks",
                                                          "sms_used", "cells_a_lane")}}
                    for t, v in nw["timing"]["tiers"].items()},
    }]}
    print(smi)
    print(json.dumps(kernels))
    return finish(torch)


def finish(torch) -> int:
    """The last line: the device the run took place on."""
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

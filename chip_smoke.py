"""Smoke test of ploidyfrost_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. build every CUDA kernel of the package from csrc/ (nvcc, sm_90a);
  2. hold kernel K1 (canonical k-mer extraction) bit-exact against its
     plain torch version on the card, over random codes with Ns,
     k in {5, 16, 17, 25, 31}, several batch shapes, all-invalid rows;
  3. golden: regenerate the single_diploid reads (100 kb diploid, k=25)
     and run the port's `pipeline` on the card: cutoffs (10, 37), the 12
     output tables byte-identical to tests/golden/single_diploid, the
     model result equal to 6 significant digits, ploidy 2;
  4. real size: the bench5m read set (5 Mbp diploid, 1% het, 150 bp
     reads at 25x, seed 7) through `pipeline` on the card, ploidy 2, with
     per-stage wall times, K1's launches on that run, K1's time against
     its bound and its plain version's time, and peak device memory.

The line before the last is the kernel table as one JSON object; the
last line is {"ok": true, "device": {...}}. Without a CUDA device, or
without the package beside it, the script exits non-zero and prints no
result. It never imports jax or ploidyfrost_tpu.
"""

from __future__ import annotations

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
GOLD_FILES = [
    "Unitig_Id", "super_bubble", "alignseq", "bicov", "bifre", "tricov",
    "trifre", "tetracov", "tetrafre", "pentacov", "pentafre",
    "allele_frequency",
]
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
ALU_OPS_PER_S = 67e12  # H100 SXM non-tensor 32-bit rate (data sheet)


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


def build_kernels() -> float:
    """Build every csrc/*.cu at once (one nvcc each); return seconds."""
    from concurrent.futures import ThreadPoolExecutor

    from ploidyfrost_tpu_torch.kmer import extract

    names = sorted(f[:-3] for f in os.listdir(extract.CSRC) if f.endswith(".cu"))
    t0 = time.time()
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        libs = list(pool.map(extract.build, names))
    for name, lib in zip(names, libs):
        log(f"built {name} -> {os.path.relpath(lib, ROOT)}")
    return time.time() - t0


def check_extract(device) -> int:
    """K1 against its plain version on `device`; returns the max |diff|."""
    import torch

    from ploidyfrost_tpu_torch.kmer.extract import (
        extract_canonical_into,
        extract_canonical_plain,
    )
    from ploidyfrost_tpu_torch.kmer.pack import SENTINEL

    rng = np.random.default_rng(0)
    worst = 0
    cases = 0
    for k in (5, 16, 17, 25, 31):
        for B, L in ((1, k), (3, 40), (257, 64), (1000, 151), (16384, 160), (5, 4100)):
            if L < k:
                continue
            codes = rng.integers(0, 4, size=(B, L)).astype(np.uint8)
            codes[rng.random((B, L)) < 0.01] = 4  # N
            codes[:: 7] = np.where(rng.random((len(codes[::7]), L)) < 0.5, 4, codes[::7])
            codes[B // 2] = 4  # an all-invalid row
            dev = torch.from_numpy(codes).to(device)
            n = L - k + 1
            out = torch.full((B * n + 11,), -5, dtype=torch.int64, device=device)
            nv = extract_canonical_into(dev, k, out, offset=7)
            if out.is_cuda:
                torch.cuda.synchronize()
            ref = extract_canonical_plain(dev, k)
            got = out[7 : 7 + B * n]
            if not torch.equal(got, ref):
                bad = int((got != ref).sum())
                raise AssertionError(f"K1 differs from plain at k={k} B={B} L={L}: {bad} keys")
            if int((out[:7] != -5).sum()) or int((out[7 + B * n :] != -5).sum()):
                raise AssertionError(f"K1 wrote outside its slice at k={k} B={B} L={L}")
            if int(nv) != int((ref != SENTINEL).sum()):
                raise AssertionError("K1 valid count differs")
            if not bool((got[n * (B // 2) : n * (B // 2 + 1)] == SENTINEL).all()):
                raise AssertionError("all-invalid row produced keys")
            worst = max(worst, int((got - ref).abs().max()) if got.numel() else 0)
            cases += 1
    log(f"K1 vs plain on {device}: {cases} cases bit-exact")
    return worst


def time_extract(B=16384, L=160, k=25, reps=200):
    """K1 and its plain version at the main path's batch shape, timed
    with CUDA events; returns (kernel ms, plain ms, bound ms, bound_by)."""
    import torch

    from ploidyfrost_tpu_torch.kmer import extract

    rng = np.random.default_rng(1)
    codes = torch.from_numpy(rng.integers(0, 4, size=(B, L)).astype(np.uint8)).cuda()
    n = L - k + 1
    out = torch.empty(B * n, dtype=torch.int64, device="cuda")
    # flush L2 (50 MB) between launches as the counter finds it cold
    scrub = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

    def timed(fn, reps):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        total = 0.0
        for _ in range(reps):
            scrub.zero_()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            total += a.elapsed_time(b)
        return total / reps

    before = extract.LAUNCHES
    ms = timed(lambda: extract._extract_keys(codes, k, out, 0), reps)
    plain_ms = timed(lambda: extract.extract_canonical_plain(codes, k), max(reps // 10, 5))
    extract.LAUNCHES = before  # timing launches are not the main path's
    nbytes = B * L + B * n * 8
    ops = B * n * 8  # roll fwd, roll rc, validity, min, select per window
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ALU_OPS_PER_S * 1e3
    return ms, plain_ms, max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def run_pipeline(reads: str, prefix: str, device: str):
    from ploidyfrost_tpu_torch.cli import Options, parse_options
    from ploidyfrost_tpu_torch.pipeline import run_pipeline_cli

    opt = parse_options(["-o", prefix, reads], Options(), extras="c")
    t0 = time.time()
    rc = run_pipeline_cli(opt, device)
    wall = time.time() - t0
    if rc != 0:
        raise RuntimeError(f"pipeline returned {rc}")
    with open(prefix + "_model_result.txt") as f:
        last = f.read().strip().splitlines()[-1]
    ploidy = int(float(last.rsplit(":", 1)[1]))
    return opt, ploidy, wall


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


def golden(device: str, work: str):
    os.makedirs(work, exist_ok=True)
    os.chdir(work)
    make_golden_reads("reads.fa")
    opt, ploidy, wall = run_pipeline("reads.fa", "gold", device)
    if (opt.coverage_lower, opt.coverage_upper) != (10, 37):
        raise AssertionError(f"cutoffs {(opt.coverage_lower, opt.coverage_upper)} != (10, 37)")
    for name in GOLD_FILES:
        with open(os.path.join("PloidyFrost_output", f"gold_{name}.txt"), "rb") as f1, \
                open(os.path.join(GOLD, f"gold_{name}.txt"), "rb") as f2:
            if f1.read() != f2.read():
                raise AssertionError(f"golden table {name} differs")
    with open("gold_model_result.txt") as f1, open(os.path.join(GOLD, "gold_model_result.txt")) as f2:
        mine, gold = f1.read(), f2.read()
    exact = mine == gold
    if not _same_to_6_digits(mine, gold):
        raise AssertionError("gold_model_result.txt differs beyond 6 significant digits")
    if ploidy != 2:
        raise AssertionError(f"golden ploidy {ploidy} != 2")
    log(f"golden on {device}: 12 tables byte-identical, model "
        f"{'byte-identical' if exact else 'equal to 6 significant digits'}, "
        f"ploidy {ploidy}, cutoffs (10, 37), {wall:.2f} s")
    return opt


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from ploidyfrost_tpu_torch.kmer import extract

    if "jax" in sys.modules or "ploidyfrost_tpu" in sys.modules:
        raise AssertionError("the port pulled in jax or ploidyfrost_tpu")
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)

    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")
    build_s = build_kernels()
    log(f"phase 1: kernels built in {build_s:.2f} s")

    err = check_extract("cuda")
    log("phase 2: K1 bit-exact against its plain version")

    extract.LAUNCHES = 0
    golden("cuda", os.path.join(WORK, "golden"))
    if extract.LAUNCHES == 0:
        raise AssertionError("golden pipeline never launched K1")
    log(f"phase 3: golden passed, K1 launches {extract.LAUNCHES}")

    bench = os.path.join(WORK, "bench5m")
    os.makedirs(bench)
    os.chdir(bench)
    t0 = time.time()
    make_bench5m_reads("bench5m_reads.fa")
    log(f"bench5m reads generated in {time.time() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    extract.LAUNCHES = 0
    opt, ploidy, wall = run_pipeline("bench5m_reads.fa", "bench5m", "cuda")
    launches = extract.LAUNCHES
    peak = torch.cuda.max_memory_allocated()
    if launches == 0:
        raise AssertionError("bench5m pipeline never launched K1")
    if ploidy != 2:
        raise AssertionError(f"bench5m ploidy {ploidy} != 2")
    for stage, sec in opt.stage_seconds.items():
        log(f"bench5m stage {stage}: {sec:.3f} s")
    log(f"bench5m: pipeline wall {wall:.3f} s, cutoffs ({opt.coverage_lower}, "
        f"{opt.coverage_upper}), ploidy {ploidy}, K1 launches {launches}, "
        f"peak device memory {peak / 2**30:.3f} GiB")

    ms, plain_ms, bound_ms, bound_by = time_extract()
    log(f"K1 at B=16384 L=160 k=25: {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"bound {bound_ms:.4f} ms ({bound_by})")
    log("phase 4: bench5m passed")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30,
    )
    os.chdir(ROOT)
    shutil.rmtree(WORK, ignore_errors=True)
    kernels = {"kernels": [{
        "name": "extract_canonical",
        "route": "cuda",
        "source": "ploidyfrost_tpu_torch/csrc/extract_canonical.cu",
        "replaces": "ploidyfrost_tpu/kmer/pallas_extract.py:88",
        "launches": launches,
        "max_abs_err": float(err),
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }]}
    if smi.returncode != 0 or not smi.stdout.strip():
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr.strip()}")
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

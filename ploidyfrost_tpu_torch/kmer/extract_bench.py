"""Time kernel K1 (canonical k-mer extraction) on the card.

    python -m ploidyfrost_tpu_torch.kmer.extract_bench \
        [--shapes 16384x160,65536x160,16384x250] [--k 25] \
        [--variants 128x17x2,128x17x1,64x17x2,128x9x2,128x29x2,256x9x2]

A variant is THREADSxRUNxSTAGES: K1's source built with -DPF_THREADS,
-DPF_RUN and -DPF_STAGES into a library of its own (threads a CTA,
windows a thread rolls over, 2 for the persistent grid with its double
buffer or 1 for one tile a CTA). Each variant is held bit-exact, keys and
valid count, against the plain version at each [B, L] shape, then timed
there in turns (the variants forward, then backward); the table gives
the median and min-max of the per-launch time and the share of the
memory bound. The package's defaults (128x17x2) come from this table.
Needs a CUDA device; chip_smoke.py uses `event_times` and `bound_ms` for
its own timing of K1.
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import torch

from . import extract
from .pack import SENTINEL

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
ALU_OPS_PER_S = 67e12  # H100 SXM non-tensor 32-bit rate (data sheet)


def scrub_buffer() -> torch.Tensor:
    """A 1 GiB device buffer: zeroing it flushes the 50 MB L2 and keeps
    the card busy (about 0.3 ms) while the host enqueues the launch that
    follows, so the events time the kernel and not the host."""
    return torch.empty(1 << 30, dtype=torch.uint8, device="cuda")


def event_times(fn, reps: int, scrub: torch.Tensor) -> list[float]:
    """Per-launch device times (ms) of fn() from CUDA events, with the
    L2 cache flushed before each launch, as the counter finds it cold."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        scrub.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return times


def graph_ms(fns, reps: int) -> float:
    """Device time (ms) a launch when `reps` launches, cycling through
    `fns` (each on buffers of its own, together larger than L2), run
    back to back from one CUDA graph: no host time between launches."""
    for f in fns:
        f()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(reps):
            fns[i % len(fns)]()
    graph.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    graph.replay()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def host_us(fn, reps: int = 200) -> float:
    """Host time (us) of one call of fn(), over `reps` calls enqueued
    back to back: what the wrapper costs the CPU a batch."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / reps * 1e6


def spread(times: list[float]) -> tuple[float, float, float]:
    """(median, min, max)."""
    return statistics.median(times), min(times), max(times)


def bound_ms(B: int, L: int, k: int) -> tuple[float, str]:
    """The least time the card could take for K1 at [B, L], k: each code
    byte read once, each key written once, the count read and written
    once, against a few integer operations a window."""
    n = L - k + 1
    nbytes = B * L + B * n * 8 + 16
    ops = B * n * 8  # roll fwd, roll rc, validity, min, select per window
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ALU_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def random_codes(B: int, L: int, seed: int, n_rate: float = 0.01) -> torch.Tensor:
    """[B, L] uint8 codes on the card: ACGT with Ns (4) and other
    invalid codes (255) at n_rate."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    codes = torch.randint(0, 4, (B, L), generator=g, device="cuda", dtype=torch.uint8)
    u = torch.rand((B, L), generator=g, device="cuda")
    codes[u < n_rate] = 4
    codes[u < n_rate / 4] = 255
    return codes


def parse_variant(text: str) -> dict[str, int]:
    threads, run, stages = (int(v) for v in text.split("x"))
    return {"PF_THREADS": threads, "PF_RUN": run, "PF_STAGES": stages}


def sweep(shapes, k: int, reps: int, variants: list[str]) -> list[dict]:
    """Rows of {shape, variant, ms, min_ms, max_ms, share_of_bound}."""
    with ThreadPoolExecutor(max_workers=len(variants)) as pool:
        paths = list(pool.map(lambda v: extract.build("extract_canonical", parse_variant(v)),
                              variants))
    fns = {v: extract.bind(p) for v, p in zip(variants, paths)}
    scrub = scrub_buffer()
    rows = []
    for B, L in shapes:
        codes = random_codes(B, L, seed=1)
        out = torch.empty(B * (L - k + 1), dtype=torch.int64, device="cuda")
        count = torch.zeros((), dtype=torch.int64, device="cuda")
        ref = extract.extract_canonical_plain(codes, k)
        want = int((ref != SENTINEL).sum())
        times = {v: [] for v in variants}
        for v, fn in fns.items():
            count.zero_()
            extract.call(fn, codes, k, out, count)
            torch.cuda.synchronize()
            if not torch.equal(out, ref) or int(count) != want:
                raise AssertionError(f"K1 {v} differs from plain at B={B} L={L} k={k}")
        for order in (variants, variants[::-1]):
            for v in order:
                times[v] += event_times(
                    lambda fn=fns[v]: extract.call(fn, codes, k, out, count), reps // 2, scrub)
        bound, _ = bound_ms(B, L, k)
        for v in variants:
            med, lo, hi = spread(times[v])
            rows.append({"B": B, "L": L, "variant": v, "ms": med, "min_ms": lo, "max_ms": hi,
                         "share_of_bound": bound / med})
        del codes, out, ref
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shapes", default="16384x160,65536x160,16384x250",
                    help="comma-separated BxL")
    ap.add_argument("--k", type=int, default=25)
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--variants", default="128x17x2,128x17x1,64x17x2,128x9x2,128x29x2,256x9x2",
                    help="comma-separated THREADSxRUNxSTAGES")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("extract_bench: no CUDA device", file=sys.stderr)
        return 1
    shapes = [tuple(int(v) for v in text.split("x")) for text in args.shapes.split(",")]
    print(f"K1 variants at k={args.k} on {torch.cuda.get_device_name(0)}")
    for r in sweep(shapes, args.k, args.reps, args.variants.split(",")):
        print(f"B={r['B']} L={r['L']} (bound {bound_ms(r['B'], r['L'], args.k)[0]:.4f} ms) "
              f"{r['variant']:>9}: median {r['ms']:.4f} ms [{r['min_ms']:.4f}, {r['max_ms']:.4f}], "
              f"{100 * r['share_of_bound']:.1f}% of bound")
    return 0


if __name__ == "__main__":
    sys.exit(main())

# Ported from ploidyfrost_tpu/util/profiling.py.
"""Phase timing + optional torch.profiler traces.

The reference prints wall+CPU seconds around each phase
(src/CDBG.cpp:129-142, 193-220, 1682-1686, 2615-2619); `phase()` is
that, plus an opt-in trace: set PLOIDYFROST_TRACE=<dir> and every phase
wrapped here also lands in a chrome trace <dir>/<phase-name>.json
(chrome://tracing, Perfetto), with the CUDA kernels of the phase when a
card is present. Without the variable the wrappers cost nothing and
never touch torch.profiler.

`device_busy` reads a finished profile: the summed time of the card's
kernels and copies against the wall of the profiled block.

Used by the analysis entry points (pipeline.py) and the scale profiler
(`python -m ploidyfrost_tpu_torch.util.profiling [genome_bp] [--device=cpu]`)."""

from __future__ import annotations

import contextlib
import os
import time


# torch.profiler drops the device events of the first milliseconds of a
# session once the process has run a while (on an H100 80GB HBM3: 4 of 12
# kernels lost 130 s into a process, none after a 50 ms pause), so a
# session on a card waits this long after it starts before its block runs
PROFILE_SETTLE_S = 0.1


@contextlib.contextmanager
def profiled(activities):
    """A torch.profiler profile over `activities`, started and, when it
    traces the card, settled (PROFILE_SETTLE_S) before the block runs."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=activities) as prof:
        if ProfilerActivity.CUDA in activities:
            torch.cuda.synchronize()
            time.sleep(PROFILE_SETTLE_S)
        yield prof


def _trace(trace_dir: str, name: str):
    """A torch.profiler context that writes <trace_dir>/<name>.json when
    the block ends."""
    import torch
    from torch.profiler import ProfilerActivity

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, name.replace("/", "_") + ".json")

    @contextlib.contextmanager
    def ctx():
        with profiled(activities) as prof:
            yield
            if torch.cuda.is_available():
                torch.cuda.synchronize()  # the block's kernels end inside the trace
        prof.export_chrome_trace(path)

    return ctx()


@contextlib.contextmanager
def maybe_trace(name: str):
    """torch.profiler trace for one pipeline phase when
    PLOIDYFROST_TRACE=<dir> is set; free otherwise. The analysis entry
    points wrap their phases with this — the reference-parity log lines
    stay untouched. On a group only rank 0 runs those phases, and so
    writes the file."""
    trace_dir = os.environ.get("PLOIDYFROST_TRACE")
    if not trace_dir:
        yield
        return
    with _trace(trace_dir, name):
        yield


@contextlib.contextmanager
def phase(name: str, log=print):
    """Context manager: timed phase with reference-style log line and
    optional profiler trace (PLOIDYFROST_TRACE=dir)."""
    t0w = time.time()
    t0c = time.process_time()
    with maybe_trace(name):
        yield
    log(
        f"{name}: CPU time : {time.process_time() - t0c:.2f}s "
        f"Real time : {time.time() - t0w:.2f}s"
    )


def device_busy(prof, wall_s: float) -> dict:
    """The card's share of a profiled block of `wall_s` seconds:
    {kernel_s, copy_s, kernels, busy_share}, from the device events of a
    finished torch.profiler profile (kernels; Memcpy and Memset apart).
    A profile without device events gives zeros."""
    from torch.autograd import DeviceType

    kernel_us = copy_us = 0.0
    kernels = 0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        us = e.time_range.elapsed_us()
        if e.name.startswith(("Memcpy", "Memset")):
            copy_us += us
        else:
            kernel_us += us
            kernels += 1
    return {
        "kernel_s": kernel_us / 1e6,
        "copy_s": copy_us / 1e6,
        "kernels": kernels,
        "busy_share": (kernel_us + copy_us) / 1e6 / wall_s if wall_s > 0 else 0.0,
    }


def profile_analysis(
    genome_bp: int = 5_000_000, het: float = 0.01, device="cuda"
) -> dict:
    """Scale profiler for the analysis phase: synthetic diploid genome
    -> count table -> graph -> search -> sites, timing every stage.
    The superbubble search runs on `device`. Returns {stage: seconds}."""
    import tempfile

    import numpy as np

    from .. import resolve_device
    from ..bubble.batched import find_superbubbles_device
    from ..graph.construct import build_graph_from_kmers
    from ..kmer.countdb import KmerCountDB
    from ..kmer.pack import canonical_np, sequence_kmers_np
    from ..pipeline import unitig_coverage, window_coverage
    from ..sites.emit import analyze_bubbles, write_outputs

    dev = resolve_device(device)
    times: dict[str, float] = {}

    def t(label, fn):
        t0 = time.perf_counter()
        out = fn()
        times[label] = time.perf_counter() - t0
        print(f"{label:28s} {times[label]:8.2f}s", flush=True)
        return out

    rng = np.random.default_rng(7)
    g1 = rng.integers(0, 4, genome_bp).astype(np.uint8)
    g2 = g1.copy()
    snp = rng.random(genome_bp) < het
    g2[snp] = (g2[snp] + rng.integers(1, 4, snp.sum())) % 4

    def make_kmers():
        k1, _ = sequence_kmers_np(g1, 25)
        k2, _ = sequence_kmers_np(g2, 25)
        # distinct keys and their multiplicities by sort and run length:
        # np.unique on a large integer array may hash it, many times slower
        allk = np.sort(canonical_np(np.concatenate([k1, k2]), 25))
        first = np.ones(len(allk), dtype=bool)
        first[1:] = allk[1:] != allk[:-1]
        starts = np.flatnonzero(first)
        km = allk[starts]
        mult = np.diff(np.append(starts, len(allk)))
        ct = mult * 25 // 2 + rng.integers(0, 5, len(km))
        return km, ct.astype(np.int64)

    km, ct = t("kmer tables (host)", make_kmers)
    g = t("build_graph_from_kmers", lambda: build_graph_from_kmers(km, 25))
    db = t("CountDB", lambda: KmerCountDB(km, ct, 25))
    res = {}

    def search():
        res["state"], res["bubbles"] = find_superbubbles_device(g, 8, device=dev)
        return res["bubbles"]

    bubbles = t("find_superbubbles_device", search)
    ucov, umin = t("unitig_coverage", lambda: unitig_coverage(db, g))
    em_ws = t(
        "analyze_bubbles",
        lambda: analyze_bubbles(g, res["state"], ucov, umin, 10, 1000, device=dev),
    )
    emissions, windows = em_ws
    wcov = t(
        "window_coverage", lambda: window_coverage(db, windows, 10, 1000)
    )
    with tempfile.TemporaryDirectory() as outdir:
        t(
            "write_outputs",
            lambda: write_outputs(emissions, wcov, "prof", outdir=outdir),
        )
    n_sites = sum(len(e.sites) for e in emissions)
    total = sum(
        times[x]
        for x in (
            "find_superbubbles_device",
            "unitig_coverage",
            "analyze_bubbles",
            "window_coverage",
            "write_outputs",
        )
    )
    print(
        f"analysis total: {total:.2f}s -> "
        f"{(len(bubbles) + n_sites) / total:.0f} bubbles+sites/s"
    )
    times["analysis_total"] = total
    return times


if __name__ == "__main__":
    import sys

    args = [a for a in sys.argv[1:] if not a.startswith("--device=")]
    devs = [a[len("--device="):] for a in sys.argv[1:] if a.startswith("--device=")]
    profile_analysis(
        int(args[0]) if args else 5_000_000, device=devs[-1] if devs else "cuda"
    )

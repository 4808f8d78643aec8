"""Reduction of one profiled call to the device's busy time, K1's
share of its roofline and the breakdown.

Busy time is the union of the intervals in which a kernel, a copy or a
memset ran on the card (the arithmetic of the port's
util/profiling.device_busy, with overlaps counted once). A profile is
complete when it holds as many events of each hand-written kernel as
the program's launch counters rose by in the call; the profiler has been
seen to drop device events late in a long process, so an incomplete
profile gives no busy share and no roofline.

K1's bound (chip_smoke.py's time_extract and kmer/extract_bench.bound_ms,
copied): each launch reads its [B, L] uint8 code batch once and writes
an int64 key a window, B * (L - k + 1) of them, plus the 16 bytes of the
valid count, at the H100's 3.35 TB/s of HBM.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12  # NVIDIA H100 SXM5 80 GB data sheet
KERNELS = {"K1": ("extract_canonical_kernel",), "search": ("superbubble_search",),
           "EM": ("em_kernel", "update_kernel"), "NW": ("nw_regs", "nw_shared")}
STAGE_ORDER = ("read+count", "build_graph", "load_graph", "superbubbles", "sites", "model")


def k1_bytes(shapes: list[tuple[int, int, int]]) -> int:
    """Bytes K1 must move for launches of (B, L, k)."""
    return sum(B * L + B * (L - k + 1) * 8 + 16 for B, L, k in shapes)


def union_seconds(intervals: list[tuple[float, float]]) -> tuple[float, list[tuple[float, float]]]:
    """(total covered seconds, merged intervals sorted by start)."""
    merged: list[list[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return sum(b - a for a, b in merged), [(a, b) for a, b in merged]


def timeline(stages: dict) -> list[tuple[str, float, float]]:
    """(stage, start, end) seconds from the call's start, in the order
    the pipeline runs its stages (read and count interleave)."""
    t = 0.0
    out = []
    for name in STAGE_ORDER:
        dur = stages.get("read", 0.0) + stages.get("count", 0.0) if name == "read+count" \
            else stages.get(name, 0.0)
        if dur > 0:
            out.append((name, t, t + dur))
            t += dur
    return out


def stage_at(tl, t: float) -> str:
    for name, a, b in tl:
        if a <= t < b:
            return name
    return "between stages"


def reduce_events(events: list[tuple[str, float, float]], wall: float, stages: dict,
                  shapes: list, launched: dict, rc: int = 0) -> dict:
    """events: (name, start s, end s) of device activity, the profile's
    start as 0."""
    counts = {key: sum(1 for n, _, _ in events if any(p in n for p in pats))
              for key, pats in KERNELS.items()}
    complete = bool(events) and all(counts[k] == launched.get(k, 0) for k in KERNELS)
    busy, merged = union_seconds([(a, b) for _, a, b in events])
    k1_s = sum(b - a for n, a, b in events if any(p in n for p in KERNELS["K1"]))
    by_name: dict[str, float] = {}
    for n, a, b in events:
        by_name[n] = by_name.get(n, 0.0) + (b - a)
    tl = timeline(stages)
    gaps = []
    prev = 0.0
    for a, b in merged + [(wall, wall)]:
        if a > prev:
            gaps.append((stage_at(tl, (prev + a) / 2), a - prev))
        prev = max(prev, b)
    gaps.sort(key=lambda x: -x[1])
    ops = sorted(by_name.items(), key=lambda x: -x[1])[:10]
    out = {"rc": rc, "wall_s": wall, "busy_s": busy, "events": len(events),
           "kernel_events": counts, "launched": launched, "complete": complete,
           "k1_s": k1_s, "k1_bytes": k1_bytes(shapes), "stages": stages,
           "breakdown": {"device_ops": [[n[:120], s] for n, s in ops],
                         "idle_gaps": [[n, s] for n, s in gaps[:10]]}}
    out["k1_roofline_pct"] = (100.0 * out["k1_bytes"] / HBM_BYTES_PER_S / k1_s
                              if complete and k1_s > 0 and shapes else None)
    out["idle_pct"] = 100.0 * (1.0 - busy / wall) if complete and wall > 0 else None
    return out


def summarize(prof, wall: float, stages: dict, shapes: list, launched: dict, rc: int) -> dict:
    """reduce_events over a finished torch.profiler profile."""
    from torch.autograd import DeviceType

    events = []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        events.append((e.name, e.time_range.start / 1e6, e.time_range.end / 1e6))
    if events:
        t0 = min(a for _, a, _ in events)
        # the profile's clock starts with the profiler; its first event
        # comes after the call's start, which is close enough to name gaps
        base = min(t0, 0.0)
        events = [(n, a - base, b - base) for n, a, b in events]
    return reduce_events(events, wall, stages, shapes, launched, rc)

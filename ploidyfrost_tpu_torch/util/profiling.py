# Ported from ploidyfrost_tpu/util/profiling.py.
"""Spans of the port's commands, and their optional torch.profiler trace.

A span is one timed piece of a command's work: its name, its parent,
its start and end as `time.time_ns()`, its thread and a few integer
counts. Each command that times its stages (`pipeline`,
`pipeline-multi`, `run`) keeps one record, `Options.spans` (cli.py),
and opens a root span named after itself (`Spans.command`). Spans nest
under it through a contextvars stack: `span(name)` opens a child of the
innermost open span, wherever the work happens, and is a no-op outside a
command. A worker thread names its parent (`Spans.span(name, parent)`),
because a ThreadPoolExecutor does not copy contextvars: `coverage`
(pipeline.py) and each file's `inflate` (io/fastx.ReadAhead) do so.

`Options.stage_seconds` is a view of the record (`Spans.stage_seconds`):
the seconds of each span name summed over its spans, except `count`,
which is its span less its `read` children, and `unstaged`, the root's
time outside its children on its own thread.

`time.time_ns()` is the clock torch.profiler (Kineto) stamps its events
with, nanoseconds since the epoch, so a span and a device event compare
directly. With PLOIDYFROST_TRACE=<dir> set, a command runs in one
profiler session (`maybe_trace`), settled once; each span also enters
`torch.profiler.record_function(name)`; and the command writes (rank 0
of a group) <dir>/<outprefix>.<command>.json, the chrome trace
(chrome://tracing, Perfetto) with the spans above the kernels, and
<dir>/<outprefix>.<command>.spans.json: every span's name, parent
(index), start_ns, end_ns, thread (native id) and counts, and when the
session traced a card, `device_busy_s`, the card's busy seconds inside
the span (the union of kernel, copy and memset intervals), and
`device_idle_s`, the idle seconds it holds: those while it is the
innermost open span of the root's thread (`attribute_device`).

Without the variable a span costs two clock reads and an append, and
nothing touches torch.profiler or record_function.

Counts (`add_count`, onto the innermost open span), for the rates the
stage seconds cannot give:
  h2d_bytes      on `count`: code batches handed to the counter's device
  read_files     on `count`: the files inflating at once, at most, until
                 the sample's batches were taken (io/fastx.ReadAhead)
  batches        on `count`: the reader's batches
  batches_ready  on `count`: the batches already queued when asked for;
                 over `batches`, the reader's hit share
  d2h_bytes      on `table_d2h` (`finalize` on a group's rank 0): the
                 count table brought to the host
  seeds          on `search`: superbubble seeds searched
  nw_pairs       on `align`: bubbles whose first branch pair takes the
                 gapped NW DP (batched when 16 or more)
  windows        on `window_coverage`: distinct window strings probed
  em_iterations  on `model`: EM iterations, summed over the fits
On --device=cpu the byte counts are the same bytes, handed over without
a copy.

`device_busy` reads a finished profile: the card's kernels and copies
against the wall of the profiled block, overlaps counted once.
"""

from __future__ import annotations

import bisect
import contextlib
import contextvars
import json
import os
import threading
import time

# torch.profiler drops the device events of the first milliseconds of a
# session once the process has run a while (on an H100 80GB HBM3: 4 of 12
# kernels lost 130 s into a process, none after a 50 ms pause), so a
# session on a card waits this long after it starts before its block runs
PROFILE_SETTLE_S = 0.1

# the open spans of this context, innermost last
_OPEN: contextvars.ContextVar[tuple] = contextvars.ContextVar("ploidyfrost_spans", default=())
_NO_SPAN = contextlib.nullcontext()


class Span:
    """One timed piece of work; entering it appends it to its record."""

    __slots__ = ("record", "name", "parent", "index", "thread", "start_ns", "end_ns", "attrs",
                 "_token", "_rf")

    def __init__(self, record: Spans, name: str, parent: Span | None):
        self.record, self.name, self.parent, self.attrs = record, name, parent, {}
        self.start_ns = self.end_ns = self._rf = None

    def __enter__(self) -> Span:
        rec = self.record
        opened = _OPEN.get()
        if self.parent is None:
            self.parent = next((s for s in reversed(opened) if s.record is rec), None)
        # the Thread object's copy: get_native_id() is a system call, 5.7 us
        # on an H100 host against 0.2 us for this
        self.thread = threading.current_thread().native_id
        with rec.lock:  # spans open on several threads at once
            self.index = len(rec.spans)
            rec.spans.append(self)
        self._token = _OPEN.set(opened + (self,))
        self.start_ns = time.time_ns()
        if rec.traced:
            from torch.profiler import record_function

            self._rf = record_function(self.name)
            self._rf.__enter__()
        return self

    def __exit__(self, *exc) -> bool:
        if self._rf is not None:
            self._rf.__exit__(*exc)
            self._rf = None
        self.end_ns = time.time_ns()
        _OPEN.reset(self._token)
        return False

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


class Spans:
    """The span record of one command: `spans` in the order they opened."""

    def __init__(self):
        self.spans: list[Span] = []
        self.lock = threading.Lock()
        self.traced = False  # inside a PLOIDYFROST_TRACE session

    def span(self, name: str, parent: Span | None = None) -> Span:
        """A span on this record, child of `parent` (default: the
        innermost span of this record open in this context)."""
        return Span(self, name, parent)

    def current(self) -> Span | None:
        """The innermost span of this record open in this context."""
        return next((s for s in reversed(_OPEN.get()) if s.record is self), None)

    @contextlib.contextmanager
    def command(self, name: str, outprefix: str, primary: bool = True):
        """Run the block in the root span of command `name`, or as it is
        when the command runs inside another (`run` inside `pipeline`).
        Under PLOIDYFROST_TRACE the root runs in one profiler session that
        the primary rank writes to <dir>/<outprefix>.<name>.json and
        .spans.json."""
        if self.current() is not None:
            yield
            return
        tracing = maybe_trace(f"{outprefix}.{name}", self) if primary else _NO_SPAN
        with tracing, self.span(name):
            yield

    def stage_seconds(self) -> dict:
        """{stage: seconds} over the closed spans: each name's spans
        summed, `count` less its `read` children, and `unstaged` for the
        root's self time (less its children on its own thread)."""
        closed = [s for s in self.spans if s.end_ns is not None]
        inner: dict[int, int] = {}
        reads: dict[int, int] = {}
        for s in closed:
            p = s.parent
            if p is None:
                continue
            ns = s.end_ns - s.start_ns
            if s.thread == p.thread:
                inner[p.index] = inner.get(p.index, 0) + ns
            if s.name == "read":
                reads[p.index] = reads.get(p.index, 0) + ns
        out: dict[str, int] = {}
        for s in closed:
            ns = s.end_ns - s.start_ns
            if s.parent is None:
                key, ns = "unstaged", ns - inner.get(s.index, 0)
            elif s.name == "count":
                key, ns = "count", ns - reads.get(s.index, 0)
            else:
                key = s.name
            out[key] = out.get(key, 0) + ns
        return {k: ns / 1e9 for k, ns in out.items()}

    def rows(self, device_intervals: list[tuple[int, int]] | None = None) -> list[dict]:
        """The record as JSON rows; with the card's event intervals (ns),
        each row also holds its device_busy_s and device_idle_s."""
        rows = [{"name": s.name, "parent": None if s.parent is None else s.parent.index,
                 "start_ns": s.start_ns, "end_ns": s.end_ns, "thread": s.thread,
                 "attrs": dict(s.attrs)} for s in self.spans]
        if device_intervals is not None:
            for row, (busy, idle) in zip(rows, attribute_device(self.spans, device_intervals)):
                row["device_busy_s"], row["device_idle_s"] = busy, idle
        return rows


def span(name: str):
    """A child of the innermost open span in this context, on its
    record; a no-op (yielding None) outside any command."""
    opened = _OPEN.get()
    if not opened:
        return _NO_SPAN
    return Span(opened[-1].record, name, opened[-1])


def current() -> Span | None:
    """The innermost open span in this context, of any record, or None."""
    opened = _OPEN.get()
    return opened[-1] if opened else None


def add_count(key: str, n: int) -> None:
    """Add `n` to count `key` of the innermost open span, if any."""
    opened = _OPEN.get()
    if opened:
        attrs = opened[-1].attrs
        attrs[key] = attrs.get(key, 0) + int(n)


def union(intervals) -> tuple[float, list[tuple]]:
    """(covered length, the merged intervals sorted by start)."""
    merged: list[list] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return sum(b - a for a, b in merged), [(a, b) for a, b in merged]


def attribute_device(spans: list[Span], intervals: list[tuple[int, int]]) -> list[tuple]:
    """(busy s, idle s) of each span, for device activity `intervals`
    (start_ns, end_ns): the busy seconds inside the span (overlaps once),
    and the idle seconds it holds, those inside it while it is the
    innermost open span of its root's thread. Spans of other threads
    hold no idle time; an open span gets (None, None)."""
    _, merged = union(intervals)
    starts = [a for a, _ in merged]
    before = [0]
    for a, b in merged:
        before.append(before[-1] + b - a)

    def busy_until(t):
        i = bisect.bisect_right(starts, t) - 1
        return 0 if i < 0 else before[i] + min(t, merged[i][1]) - merged[i][0]

    def root(s):
        while s.parent is not None:
            s = s.parent
        return s

    out: list = [None] * len(spans)
    idle: dict[int, int] = {}
    for s in spans:
        if s.end_ns is None:
            continue
        busy = busy_until(s.end_ns) - busy_until(s.start_ns)
        out[s.index] = busy
        if s.thread == root(s).thread:
            idle[s.index] = s.end_ns - s.start_ns - busy
    held = dict(idle)
    for s in spans:
        if s.index in idle and s.parent is not None and s.parent.index in held:
            held[s.parent.index] -= idle[s.index]
    return [(None, None) if b is None else (b / 1e9, held.get(i, 0) / 1e9)
            for i, b in enumerate(out)]


def device_intervals(prof) -> list[tuple[int, int]]:
    """(start_ns, end_ns) on the span clock of every device event (kernel,
    copy, memset) of a finished torch.profiler profile. The spans' own
    record_function ranges, which the profiler also lays on the device's
    timeline, are left out."""
    from torch.autograd import DeviceType

    return [(e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA and not e.is_user_annotation()]


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


@contextlib.contextmanager
def maybe_trace(name: str, spans: Spans):
    """One torch.profiler session over the block when
    PLOIDYFROST_TRACE=<dir> is set, written to <dir>/<name>.json, and
    the record `spans` to <dir>/<name>.spans.json (its spans enter
    record_function while the session runs). Yields the profile, or
    None when the variable is unset, which costs nothing."""
    trace_dir = os.environ.get("PLOIDYFROST_TRACE")
    if not trace_dir:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity

    card = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if card else [])
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, name.replace("/", "_"))
    with profiled(activities) as prof:
        spans.traced = True
        try:
            yield prof
            if card:
                torch.cuda.synchronize()  # the block's kernels end inside the trace
        finally:
            spans.traced = False
    prof.export_chrome_trace(path + ".json")
    doc = {"clock": "time.time_ns", "stage_seconds": spans.stage_seconds(),
           "spans": spans.rows(device_intervals(prof) if card else None)}
    with open(path + ".spans.json", "w") as f:
        json.dump(doc, f)


def device_busy(prof, wall_s: float) -> dict:
    """The card's share of a profiled block of `wall_s` seconds:
    {kernel_s, copy_s, kernels, busy_share}, from the device events of a
    finished torch.profiler profile, overlaps counted once: `kernel_s`
    the union of the kernels' intervals, `copy_s` the time Memcpy and
    Memset run while no kernel does, `busy_share` their sum over
    `wall_s`. A profile without device events gives zeros."""
    from torch.autograd import DeviceType

    kernels, copies = [], []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        iv = (e.time_range.start, e.time_range.end)
        (copies if e.name.startswith(("Memcpy", "Memset")) else kernels).append(iv)
    kernel_us, _ = union(kernels)
    busy_us, _ = union(kernels + copies)
    return {
        "kernel_s": kernel_us / 1e6,
        "copy_s": (busy_us - kernel_us) / 1e6,
        "kernels": len(kernels),
        "busy_share": busy_us / 1e6 / wall_s if wall_s > 0 else 0.0,
    }

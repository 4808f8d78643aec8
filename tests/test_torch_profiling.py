"""The port's spans and traces (util/profiling.py) on the CPU."""

import json
import os
import types

import pytest
import torch

from ploidyfrost_tpu_torch import cli
from ploidyfrost_tpu_torch.util import profiling
from test_torch_helpers import ahead_stages, few_torch_threads  # noqa: F401  (autouse fixture)

MS = 1_000_000  # ns
# the spans the single-sample path opens on its main thread (read spans
# aside), in order, with their parents
PIPELINE_TREE = [
    ("pipeline", None), ("count", "pipeline"), ("build_graph", "pipeline"),
    ("table_d2h", "build_graph"), ("link", "build_graph"), ("assemble", "build_graph"),
    ("assemble", "build_graph"), ("write_graph", "build_graph"), ("load_graph", "pipeline"),
    ("load_table", "pipeline"), ("coverage", "pipeline"), ("superbubbles", "pipeline"),
    ("search", "superbubbles"), ("replay", "superbubbles"), ("replay", "superbubbles"),
    ("sites", "pipeline"), ("coverage_wait", "sites"), ("align", "sites"),
    ("window_coverage", "sites"), ("write_tables", "sites"), ("model", "pipeline"),
]
_SAMPLE = [("count", "pipeline-multi"), ("build_graph", "pipeline-multi"),
           ("table_d2h", "build_graph"), ("write_graph", "build_graph")]
MULTI_TREE = [("pipeline-multi", None)] + _SAMPLE * 3 + [
    ("build_graph", "pipeline-multi"), ("link", "build_graph"), ("link", "build_graph"),
    ("assemble", "build_graph"), ("assemble", "build_graph"), ("color_graph", "build_graph"),
    ("write_graph", "build_graph"), ("load_graph", "pipeline-multi"),
    ("load_table", "load_graph"), ("coverage", "pipeline-multi"),
    ("superbubbles", "pipeline-multi"), ("search", "superbubbles"), ("replay", "superbubbles"),
    ("replay", "superbubbles"), ("sites", "pipeline-multi"), ("coverage_wait", "sites"),
    ("align", "sites"), ("window_coverage", "sites"), ("write_tables", "sites"),
    ("model", "pipeline-multi"),
]


def _work():
    return int(torch.arange(1000).sort(descending=True).values[0])


def _main(argv, mp):
    """cli.main(argv) with the Options it builds recorded: (rc, options)."""
    made = []

    class Recorded(cli.Options):
        def __init__(self):
            super().__init__()
            made.append(self)

    mp.setattr(cli, "Options", Recorded)
    rc = cli.main(argv)
    return rc, made[-1]


def _refuse(what):
    def refuse(*args, **kwargs):
        raise AssertionError(f"{what} was entered")

    return refuse


@pytest.fixture(scope="module")
def commands(tmp_path_factory):
    """`pipeline` on the single_diploid reads and `pipeline-multi` on the
    multi_colored samples, --device=cpu, without PLOIDYFROST_TRACE and
    with torch.profiler's profile and record_function made to raise: the
    Options of each, and the single-sample run's directory."""
    from test_golden import make_reads
    from test_golden_colored import make_sample_reads

    d = tmp_path_factory.mktemp("spans")
    cwd = os.getcwd()
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        import torch.profiler

        mp.delenv("PLOIDYFROST_TRACE", raising=False)
        mp.setattr(torch.profiler, "profile", _refuse("torch.profiler.profile"))
        mp.setattr(torch.profiler, "record_function", _refuse("record_function"))
        try:
            for name in ("one", "multi"):
                os.makedirs(d / name)
                os.chdir(d / name)
                if name == "one":
                    make_reads("reads.fa")
                    rc, out["pipeline"] = _main(["pipeline", "-o", "p", "reads.fa",
                                                 "--device=cpu"], mp)
                else:
                    reads = make_sample_reads(".")
                    rc, out["pipeline-multi"] = _main(["pipeline-multi", "-o", "m", *reads,
                                                       "--device=cpu"], mp)
                assert rc == 0
        finally:
            os.chdir(cwd)
    out["dir"] = str(d / "one")
    return out


def _tree(opt):
    return [(s.name, s.parent.name if s.parent else None)
            for s in opt.spans.spans if s.name not in ("read", "inflate")]


@pytest.mark.parametrize("command", ["pipeline", "pipeline-multi"])
def test_span_tree(commands, command):
    opt = commands[command]
    assert _tree(opt) == (PIPELINE_TREE if command == "pipeline" else MULTI_TREE)
    reads = [s for s in opt.spans.spans if s.name == "read"]
    assert all(s.parent.name == "count" for s in reads)
    # a read span a batch wait: at least one batch, then the reader's end
    for c in (s for s in opt.spans.spans if s.name == "count"):
        assert sum(1 for s in reads if s.parent is c) >= 2


@pytest.mark.parametrize("command", ["pipeline", "pipeline-multi"])
def test_inflate_spans_on_worker_threads(commands, command):
    """One `inflate` span a file where the native reader loads (the
    test reads one file a sample), each on a thread of its own, none the
    root's: under `count` in `pipeline`, under the root in
    `pipeline-multi`, whose reader runs ahead across samples."""
    spans = commands[command].spans.spans
    root = spans[0]
    inflate = [s for s in spans if s.name == "inflate"]
    if not ahead_stages():
        assert inflate == []
        return
    assert len(inflate) == (1 if command == "pipeline" else 3)
    assert len({s.thread for s in inflate}) == len(inflate)
    assert all(s.thread != root.thread for s in inflate)
    assert all(s.parent.name == ("count" if command == "pipeline" else command)
               for s in inflate)


@pytest.mark.parametrize("command", ["pipeline", "pipeline-multi"])
def test_old_stage_keys_are_span_arithmetic(commands, command):
    """Each key the stages had before spans reads the same work: its
    spans summed, `count` its spans less their `read` children."""
    opt = commands[command]
    spans = [s for s in opt.spans.spans]
    ns = {}
    for s in spans:
        ns[s.name] = ns.get(s.name, 0) + s.end_ns - s.start_ns
    reads_in = {}
    for s in spans:
        if s.name == "read":
            reads_in[s.parent.index] = reads_in.get(s.parent.index, 0) + s.end_ns - s.start_ns
    count = sum(s.end_ns - s.start_ns - reads_in.get(s.index, 0)
                for s in spans if s.name == "count")
    stages = opt.stage_seconds
    old = ["read", "build_graph", "load_graph", "superbubbles", "sites", "model"]
    if command == "pipeline-multi":
        old.append("color_graph")
    for key in old:
        assert stages[key] == pytest.approx(ns[key] / 1e9, abs=1e-9), key
    assert stages["count"] == pytest.approx(count / 1e9, abs=1e-9)
    assert all(v >= 0 for v in stages.values())


@pytest.mark.parametrize("command", ["pipeline", "pipeline-multi"])
def test_children_lie_inside_parents(commands, command):
    for s in commands[command].spans.spans:
        assert s.start_ns <= s.end_ns
        if s.parent is not None:
            assert s.parent.start_ns <= s.start_ns and s.end_ns <= s.parent.end_ns, s.name


@pytest.mark.parametrize("command", ["pipeline", "pipeline-multi"])
def test_top_level_and_unstaged_cover_the_root(commands, command):
    opt = commands[command]
    root = opt.spans.spans[0]
    top = sum(s.end_ns - s.start_ns for s in opt.spans.spans
              if s.parent is root and s.thread == root.thread)
    assert abs(top / 1e9 + opt.stage_seconds["unstaged"] - root.seconds) < 1e-3
    assert opt.stage_seconds["unstaged"] >= 0


@pytest.mark.parametrize("command", ["pipeline", "pipeline-multi"])
def test_coverage_runs_on_a_worker_thread_under_the_root(commands, command):
    spans = commands[command].spans.spans
    root = spans[0]
    (cov,) = [s for s in spans if s.name == "coverage"]
    assert cov.parent is root and cov.thread != root.thread
    assert all(s.thread == root.thread for s in spans if s is not cov and s.name != "inflate")
    assert commands[command].stage_seconds["coverage"] == cov.seconds


def test_counts_sit_on_their_spans(commands):
    """The counts land on the span whose work they count."""
    spans = commands["pipeline"].spans.spans
    attrs = {s.name: s.attrs for s in spans if s.attrs}
    assert set(attrs) == {"count", "table_d2h", "search", "align", "window_coverage", "model"}
    assert attrs["count"]["h2d_bytes"] > 0
    # the reader's counts: one file, so one inflating at once at most
    reader = {key: attrs["count"][key] for key in ("read_files", "batches", "batches_ready")}
    assert reader["read_files"] == 1 and reader["batches"] > 0
    assert 0 <= reader["batches_ready"] <= reader["batches"]
    assert attrs["table_d2h"]["d2h_bytes"] % 16 == 0 and attrs["table_d2h"]["d2h_bytes"] > 0
    assert attrs["search"]["seeds"] > 0
    assert attrs["align"]["nw_pairs"] >= 0 and attrs["window_coverage"]["windows"] >= 0
    # nine fits, at least one iteration each
    assert attrs["model"]["em_iterations"] >= 9


def test_failed_input_check_leaves_a_closed_record(tmp_path, monkeypatch):
    """`run` on a missing graph returns 1 with every span closed and the
    record whole, exported under PLOIDYFROST_TRACE; an exception closes
    the spans it passes through."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("PLOIDYFROST_TRACE", str(tmp_path / "trace"))
    rc, opt = _main(["-g", "missing.gfa", "-d", "missing.kmers.npz", "-o", "f",
                     "--device=cpu"], monkeypatch)
    assert rc == 1
    assert [(s.name, s.parent.name if s.parent else None) for s in opt.spans.spans] == [
        ("run", None), ("load_graph", "run")]
    assert all(s.end_ns is not None for s in opt.spans.spans)
    assert set(opt.stage_seconds) == {"load_graph", "unstaged"}
    assert profiling._OPEN.get() == ()
    with open(tmp_path / "trace" / "f.run.spans.json") as f:
        rows = json.load(f)["spans"]
    assert [r["parent"] for r in rows] == [None, 0] and all(r["end_ns"] for r in rows)

    rec = profiling.Spans()
    with pytest.raises(RuntimeError):
        with rec.command("run", "x", primary=False):
            with profiling.span("load_graph"):
                raise RuntimeError("bad input")
    assert all(s.end_ns is not None for s in rec.spans) and profiling._OPEN.get() == ()


def test_span_clock_brackets_its_profiler_event(tmp_path, monkeypatch):
    """Under a CPU profiler session a span's time.time_ns stamps lie
    within 1 ms of its record_function event's Kineto stamps: one clock."""
    monkeypatch.setenv("PLOIDYFROST_TRACE", str(tmp_path))
    rec = profiling.Spans()
    with profiling.maybe_trace("clock", rec) as prof:
        with rec.span("warm"):
            pass
        with rec.span("outer") as outer:
            with rec.span("inner") as inner:
                _work()
    events = {e.name(): e for e in prof.profiler.kineto_results.events()
              if e.name() in ("outer", "inner")}
    for s in (outer, inner):
        e = events[s.name]
        assert abs(e.start_ns() - s.start_ns) <= MS and abs(s.end_ns - e.end_ns()) <= MS
        assert e.start_ns() >= s.start_ns - MS and e.end_ns() <= s.end_ns + MS


def test_idle_goes_to_the_innermost_span():
    """A device gap is split at child-span edges and each part goes to
    the innermost span of the root's thread open then; busy time inside
    a span counts overlapping events once; a worker span holds no idle."""
    rec = profiling.Spans()
    with rec.span("root") as root:
        with rec.span("a") as a:
            with rec.span("b") as b:
                pass
        with rec.span("c") as c:
            pass
        with rec.span("w", parent=root) as w:
            pass
    times = {root: (0, 100), a: (10, 60), b: (20, 40), c: (70, 90), w: (0, 50)}
    for s, (t0, t1) in times.items():
        s.start_ns, s.end_ns = t0 * 10**6, t1 * 10**6
    w.thread = root.thread + 1
    ms = [(5, 15), (30, 35), (32, 50), (95, 200)]
    got = profiling.attribute_device(rec.spans, [(a0 * 10**6, b0 * 10**6) for a0, b0 in ms])
    want = {root: (35, 20), a: (25, 15), b: (10, 10), c: (0, 20), w: (30, 0)}
    for s, (busy, idle) in want.items():
        assert got[s.index] == pytest.approx((busy / 1e3, idle / 1e3)), s.name
    # the idle parts add up to the root's idle time
    assert sum(got[s.index][1] for s in (root, a, b, c)) == pytest.approx(0.065)


def test_device_busy_counts_overlapping_events_once():
    from torch.autograd import DeviceType

    def ev(name, a, b, dev=DeviceType.CUDA):
        return types.SimpleNamespace(name=name, device_type=dev,
                                     time_range=types.SimpleNamespace(start=a, end=b))

    prof = types.SimpleNamespace(events=lambda: [
        ev("kernel_a", 0, 100), ev("kernel_b", 50, 150), ev("Memcpy HtoD", 120, 200),
        ev("Memset (Device)", 300, 310), ev("aten::sort", 0, 1000, DeviceType.CPU)])
    busy = profiling.device_busy(prof, 1e-3)
    assert busy["kernels"] == 2
    assert busy["kernel_s"] == pytest.approx(150e-6)
    assert busy["copy_s"] == pytest.approx(60e-6)
    assert busy["busy_share"] == pytest.approx(0.21)


def test_device_intervals_leave_out_the_spans_own_ranges():
    """The profiler lays each record_function range on the device's
    timeline too; the busy time counts kernels, copies and memsets only."""
    from torch.autograd import DeviceType

    def ev(a, b, dev=DeviceType.CUDA, annotation=False):
        return types.SimpleNamespace(start_ns=lambda: a, end_ns=lambda: b,
                                     device_type=lambda: dev,
                                     is_user_annotation=lambda: annotation)

    events = [ev(0, 10), ev(5, 500, annotation=True), ev(20, 30),
              ev(0, 900, DeviceType.CPU), ev(0, 900, DeviceType.CPU, annotation=True)]
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))
    assert profiling.device_intervals(prof) == [(0, 10), (20, 30)]


def test_span_indices_hold_across_threads():
    """Spans opened on many threads at once, the interpreter switching
    threads often: each span's index is its place in the record."""
    import sys
    import threading

    for _ in range(3):
        rec = profiling.Spans()
        with rec.span("root") as root:
            def opener():
                for _ in range(2000):
                    with rec.span("w", parent=root):
                        pass

            threads = [threading.Thread(target=opener) for _ in range(16)]
            before = sys.getswitchinterval()
            sys.setswitchinterval(1e-6)
            try:
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(60)
            finally:
                sys.setswitchinterval(before)
        assert not any(t.is_alive() for t in threads)
        assert len(rec.spans) == 1 + 16 * 2000
        assert [s.index for s in rec.spans] == list(range(len(rec.spans)))


def test_span_outside_a_command_is_free():
    """Outside any command `span` records nothing and `add_count` is a
    no-op: the library functions run bare in tests and other commands."""
    with profiling.span("link") as s:
        profiling.add_count("seeds", 3)
    assert s is None and profiling._OPEN.get() == ()


def test_exporter_writes_two_files_per_command(commands, tmp_path, monkeypatch):
    """`run` under PLOIDYFROST_TRACE writes <out>.run.json and
    <out>.run.spans.json, nothing else; the spans file holds every span
    with its parent's index, stamps, thread and counts, and no device
    fields on a profile without the card."""
    d = commands["dir"]
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("PLOIDYFROST_TRACE", str(tmp_path / "trace"))
    rc, opt = _main(["-g", os.path.join(d, "p.gfa"), "-d", os.path.join(d, "p.kmers.npz"),
                     "-o", "again", "-l", "10", "-u", "37", "--device=cpu"], monkeypatch)
    assert rc == 0
    assert sorted(os.listdir(tmp_path / "trace")) == ["again.run.json", "again.run.spans.json"]
    with open(tmp_path / "trace" / "again.run.spans.json") as f:
        doc = json.load(f)
    rows = doc["spans"]
    assert [r["name"] for r in rows] == [s.name for s in opt.spans.spans]
    assert rows[0]["name"] == "run" and rows[0]["parent"] is None
    for r, s in zip(rows, opt.spans.spans):
        assert set(r) == {"name", "parent", "start_ns", "end_ns", "thread", "attrs"}
        assert (r["start_ns"], r["end_ns"], r["thread"]) == (s.start_ns, s.end_ns, s.thread)
        assert r["parent"] == (None if s.parent is None else s.parent.index)
    assert doc["stage_seconds"] == pytest.approx(opt.stage_seconds)
    assert rows[[r["name"] for r in rows].index("search")]["attrs"]["seeds"] > 0


def test_maybe_trace_without_the_switch_never_reaches_the_profiler(tmp_path, monkeypatch):
    """`import torch` already loads torch.profiler, so the check is that
    the wrappers do not use it: with the switch unset a profiler that
    raises on construction is never constructed and a record_function
    that raises is never entered, by maybe_trace or by a command's
    spans; with it set, the profiler is."""
    import torch.profiler

    monkeypatch.setattr(torch.profiler, "profile", _refuse("torch.profiler.profile"))
    monkeypatch.setattr(torch.profiler, "record_function", _refuse("record_function"))
    monkeypatch.delenv("PLOIDYFROST_TRACE", raising=False)
    ran = []
    rec = profiling.Spans()
    with profiling.maybe_trace("a", rec):
        ran.append(1)
    with rec.command("run", "x"):
        with profiling.span("a"):
            ran.append(2)
    assert ran == [1, 2] and [s.name for s in rec.spans] == ["run", "a"]
    monkeypatch.setenv("PLOIDYFROST_TRACE", str(tmp_path))
    with pytest.raises(AssertionError, match="torch.profiler.profile was entered"):
        with profiling.maybe_trace("a", profiling.Spans()):
            pass


@pytest.mark.parametrize("wrapper", ["maybe_trace"])
def test_trace_switch_writes_a_chrome_trace(wrapper, tmp_path, monkeypatch):
    trace_dir = tmp_path / "trace"
    monkeypatch.setenv("PLOIDYFROST_TRACE", str(trace_dir))
    with profiling.maybe_trace("run/findSuperBubble", profiling.Spans()):
        _work()
    assert sorted(os.listdir(trace_dir)) == ["run_findSuperBubble.json",
                                             "run_findSuperBubble.spans.json"]
    with open(trace_dir / "run_findSuperBubble.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("sort" in e.get("name", "") for e in events)


def test_device_busy_of_a_cpu_profile():
    """A profile without device events: zero kernels, zero busy share."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _work()
    busy = profiling.device_busy(prof, 0.5)
    if not torch.cuda.is_available():
        assert busy == {"kernel_s": 0.0, "copy_s": 0.0, "kernels": 0, "busy_share": 0.0}
    assert set(busy) == {"kernel_s", "copy_s", "kernels", "busy_share"}
    assert profiling.device_busy(prof, 0.0)["busy_share"] == 0.0


@pytest.mark.parametrize("with_cuda", [False, True], ids=["cpu", "cuda"])
def test_profiled_settles_only_a_session_that_traces_the_card(with_cuda, monkeypatch):
    """`profiled` waits PROFILE_SETTLE_S after the start of a session that
    traces the card (the profiler loses the device events of its first
    milliseconds), and not at all for a CPU-only session."""
    from torch.profiler import ProfilerActivity

    sleeps, syncs = [], []
    monkeypatch.setattr(profiling.time, "sleep", sleeps.append)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: syncs.append(1))
    activities = [ProfilerActivity.CPU]
    if with_cuda:
        activities.append(ProfilerActivity.CUDA)
    with profiling.profiled(activities) as prof:
        _work()
    assert sleeps == ([profiling.PROFILE_SETTLE_S] if with_cuda else [])
    assert len(syncs) == int(with_cuda)
    assert any(e.name.startswith("aten::") for e in prof.events())


def test_pipeline_phases_are_traced(tmp_path, monkeypatch):
    """`pipeline` under PLOIDYFROST_TRACE leaves one chrome trace and one
    spans file, named after the output prefix and the command; the trace
    holds the spans as record_function events."""
    from ploidyfrost_tpu_torch.cli import main
    from test_golden import make_reads

    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("PLOIDYFROST_TRACE", str(tmp_path / "trace"))
    make_reads("reads.fa")
    assert main(["pipeline", "-o", "p", "reads.fa", "--device=cpu"]) == 0
    assert sorted(os.listdir(tmp_path / "trace")) == ["p.pipeline.json",
                                                      "p.pipeline.spans.json"]
    with open(tmp_path / "trace" / "p.pipeline.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"pipeline", "count", "read", "build_graph", "search", "replay", "align",
            "model"} <= names
    with open(tmp_path / "trace" / "p.pipeline.spans.json") as f:
        rows = json.load(f)["spans"]
    assert [(r["name"], None if r["parent"] is None else rows[r["parent"]]["name"])
            for r in rows if r["name"] not in ("read", "inflate")] == PIPELINE_TREE
    with open("p_model_result.txt") as f:
        assert f.read().rstrip().endswith("estimated ploidy level is : 2")

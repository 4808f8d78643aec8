"""The port's phase timing and tracing (util/profiling.py) on the CPU."""

import json
import os
import re

import pytest
import torch

from ploidyfrost_tpu_torch.util import profiling
from test_torch_helpers import few_torch_threads  # noqa: F401  (autouse fixture)

def _work():
    return int(torch.arange(1000).sort(descending=True).values[0])


@pytest.mark.parametrize("name", ["findSuperBubble", "CDBG::ploidyEstimation()"])
def test_phase_prints_reference_style_line(name, monkeypatch):
    monkeypatch.delenv("PLOIDYFROST_TRACE", raising=False)
    lines = []
    with profiling.phase(name, log=lines.append):
        _work()
    assert len(lines) == 1
    assert re.fullmatch(re.escape(name) + r": CPU time : \d+\.\d\ds Real time : \d+\.\d\ds",
                        lines[0])


def test_maybe_trace_without_the_switch_never_reaches_the_profiler(tmp_path, monkeypatch):
    """`import torch` already loads torch.profiler, so the check is that
    the wrappers do not use it: with the switch unset a profiler that
    raises on construction is never constructed; with it set, it is."""
    import torch.profiler

    def refuse(*args, **kwargs):
        raise AssertionError("torch.profiler.profile was constructed")

    monkeypatch.setattr(torch.profiler, "profile", refuse)
    monkeypatch.delenv("PLOIDYFROST_TRACE", raising=False)
    ran = []
    with profiling.maybe_trace("a"):
        ran.append(1)
    with profiling.phase("b", log=ran.append):
        ran.append(2)
    assert ran[:2] == [1, 2] and ran[2].startswith("b: CPU time")
    monkeypatch.setenv("PLOIDYFROST_TRACE", str(tmp_path))
    with pytest.raises(AssertionError, match="was constructed"):
        with profiling.maybe_trace("a"):
            pass


@pytest.mark.parametrize("wrapper", ["maybe_trace", "phase"])
def test_trace_switch_writes_a_chrome_trace(wrapper, tmp_path, monkeypatch):
    trace_dir = tmp_path / "trace"
    monkeypatch.setenv("PLOIDYFROST_TRACE", str(trace_dir))
    lines = []
    ctx = profiling.maybe_trace("run/findSuperBubble") if wrapper == "maybe_trace" \
        else profiling.phase("run/findSuperBubble", log=lines.append)
    with ctx:
        _work()
    assert os.listdir(trace_dir) == ["run_findSuperBubble.json"]
    with open(trace_dir / "run_findSuperBubble.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("sort" in e.get("name", "") for e in events)
    assert len(lines) == (1 if wrapper == "phase" else 0)


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


def test_profile_analysis_returns_every_stage(capsys):
    times = profiling.profile_analysis(200_000, device="cpu")
    assert set(times) == {
        "kmer tables (host)", "build_graph_from_kmers", "CountDB",
        "find_superbubbles_device", "unitig_coverage", "analyze_bubbles",
        "window_coverage", "write_outputs", "analysis_total",
    }
    assert all(v >= 0 for v in times.values())
    out = capsys.readouterr().out
    assert "analysis total:" in out and "bubbles+sites/s" in out


def test_profile_analysis_refuses_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        profiling.profile_analysis(1000)


def test_pipeline_phases_are_traced(tmp_path, monkeypatch):
    """`pipeline` under PLOIDYFROST_TRACE leaves one trace a phase."""
    from ploidyfrost_tpu_torch.cli import main
    from test_golden import make_reads

    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("PLOIDYFROST_TRACE", str(tmp_path / "trace"))
    make_reads("reads.fa")
    assert main(["pipeline", "-o", "p", "reads.fa", "--device=cpu"]) == 0
    assert sorted(os.listdir(tmp_path / "trace")) == ["findSuperBubble.json",
                                                      "ploidyEstimation.json"]
    with open(tmp_path / "trace" / "findSuperBubble.json") as f:
        assert json.load(f)["traceEvents"]
    with open("p_model_result.txt") as f:
        assert f.read().rstrip().endswith("estimated ploidy level is : 2")

"""On several ranks, rank 0 alone receives the count table, builds the
graph, replays the search, runs the sites pass and writes
(parallel/, pipeline.py, cli.py), on the CPU with gloo.

Groups of 1, 2, 3 and 4 ranks (one rank is a group too, not the
single-device path) run `count`, `build`, `build -c`, `pipeline`, `run`,
`pipeline-multi` and `run -f -C` one after the other through the CLI's
rank entry, with spies on the graph, colors and sites functions in every
rank. The tests hold that:

  * every file each command writes is byte-identical to the one a
    single device writes, and the pipelines' tables to the goldens;
  * the other ranks never load or build a graph, color it or run the
    sites pass, and rank 0 does each;
  * rank 0 prints one line a rank, every rank's with its seconds from
    process start to group join, the other ranks' with only the stages
    they run;
  * an error only rank 0 can see (a missing graph, too few count
    databases for the colors) ends every rank with exit code 1 within
    seconds, even a rank in another process, with the reference's
    message from rank 0; so does `run -g missing.gfa --devices=2`.

Every rank holds torch to one thread; every group has a process-group
timeout and every wait here a timeout of its own.
"""

import contextlib
import json
import os
import socket
import subprocess
import sys
import time

import pytest

import test_golden
import test_golden_colored
from test_torch_helpers import ahead_stages, few_torch_threads  # noqa: F401  (autouse fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GROUP_TIMEOUT_S = 120
WAIT_S = 600
SAMPLES = ["../s0.fa", "../s1.fa", "../s2.fa"]
# (name, argv, the prefix of every file it writes)
COMMANDS = [
    ("count", ["count", "-k", "25", "-o", "c", "../reads.fa"], "c"),
    ("build", ["build", "-k", "25", "-o", "b", "../reads.fa"], "b"),
    ("build -c", ["build", "-c", "-o", "bc", *SAMPLES], "bc"),
    ("pipeline", ["pipeline", "-o", "gold", "../reads.fa"], "gold"),
    ("run", ["-g", "gold.gfa", "-d", "gold.kmers.npz", "-h", "gold.hist.txt", "-o", "run"],
     "run"),
    ("pipeline-multi", ["pipeline-multi", "-o", "m", *SAMPLES], "m"),
    ("run -f", ["-g", "m.gfa", "-f", "m.colors.npz", "-d", "m.kmc_list.txt",
                "-C", "m.coverage_cutoff.txt", "-o", "runc"], "runc"),
]
# module, attribute: what the other ranks must never call
SPIED = [
    ("ploidyfrost_tpu_torch.graph.cdbg", "CDBGraph.from_gfa"),
    ("ploidyfrost_tpu_torch.graph.construct", "build_graph_from_kmers"),
    ("ploidyfrost_tpu_torch.graph.colors", "color_graph"),
    ("ploidyfrost_tpu_torch.sites.emit", "analyze_bubbles"),
    ("ploidyfrost_tpu_torch.sites.emit_colored", "analyze_bubbles_colored"),
    ("ploidyfrost_tpu_torch.sites.emit", "window_coverage"),
]


@pytest.fixture(scope="module", autouse=True)
def group_timeout():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PLOIDYFROST_TIMEOUT", str(GROUP_TIMEOUT_S))
        yield


def _install_spies(counts: dict) -> None:
    """Count the calls of every SPIED function in this process."""
    import importlib

    for mod_name, attr in SPIED:
        mod = importlib.import_module(mod_name)
        owner, name = (getattr(mod, attr.split(".")[0]), attr.split(".")[1]) \
            if "." in attr else (mod, attr)
        real = getattr(owner, name)

        def spy(*args, _real=real, _key=attr, **kw):
            counts[_key] = counts.get(_key, 0) + 1
            return _real(*args, **kw)

        setattr(owner, name, staticmethod(spy) if "." in attr else spy)


def _group_job(group, work):
    """Every rank: the COMMANDS in work/world<W>, each through the CLI's
    rank entry, its stdout to a log of its own; then the spies' counts
    of each command to a JSON file a rank."""
    from ploidyfrost_tpu_torch import cli

    counts: dict = {}
    _install_spies(counts)
    os.chdir(os.path.join(work, f"world{group.world}"))
    seen = {}
    for name, argv, _ in COMMANDS:
        counts.clear()
        log = os.path.join(work, f"world{group.world}.{name}.rank{group.rank}.log")
        with open(log, "w") as f, contextlib.redirect_stdout(f):
            rc = cli._main(argv, "cpu", False, group)
        if rc:
            return rc
        seen[name] = dict(counts)
    with open(os.path.join(work, f"world{group.world}.spies.rank{group.rank}.json"), "w") as f:
        json.dump(seen, f)
    return 0


def _in_dir(d, argv):
    from ploidyfrost_tpu_torch.cli import main

    cwd = os.getcwd()
    os.chdir(d)
    try:
        return main(argv)
    finally:
        os.chdir(cwd)


def _files(d: str, prefix: str) -> list[str]:
    """The files under d (and d/PloidyFrost_output) whose names start
    with prefix + "." or prefix + "_"."""
    out = []
    for sub in ("", "PloidyFrost_output"):
        p = os.path.join(d, sub)
        out += [os.path.join(sub, f) for f in sorted(os.listdir(p))
                if f.startswith((prefix + ".", prefix + "_"))] if os.path.isdir(p) else []
    return out


def _same(a, b):
    with open(a, "rb") as f1, open(b, "rb") as f2:
        return f1.read() == f2.read()


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """The reads, and every command's files from one device in
    work/single."""
    d = str(tmp_path_factory.mktemp("torch_rank0"))
    test_golden.make_reads(os.path.join(d, "reads.fa"))
    test_golden_colored.make_sample_reads(d)
    single = os.path.join(d, "single")
    os.makedirs(single)
    for _, argv, _ in COMMANDS:
        assert _in_dir(single, [*argv, "--devices=1", "--device=cpu"]) == 0
    return d


@pytest.fixture(scope="module", params=[1, 2, 3, 4], ids=lambda w: f"world{w}")
def group_run(request, work):
    """work/world<W> after a group of W gloo ranks ran the COMMANDS."""
    from ploidyfrost_tpu_torch.parallel.mesh import RankPlan, run_ranks

    world = request.param
    os.makedirs(os.path.join(work, f"world{world}"))
    plan = RankPlan(local=world, world=world, offset=0, device_type="cpu", init_method=None,
                    timeout_s=GROUP_TIMEOUT_S, threads=1)
    assert run_ranks(plan, _group_job, (work,), timeout=WAIT_S) == 0
    spies = []
    for r in range(world):
        with open(os.path.join(work, f"world{world}.spies.rank{r}.json")) as f:
            spies.append(json.load(f))
    return world, spies


@pytest.mark.parametrize("name,prefix", [(c[0], c[2]) for c in COMMANDS],
                         ids=[c[0] for c in COMMANDS])
def test_outputs_equal_one_device(group_run, work, name, prefix):
    world, _ = group_run
    single, mine = os.path.join(work, "single"), os.path.join(work, f"world{world}")
    want = _files(single, prefix)
    assert want and _files(mine, prefix) == want, name
    for f in want:
        assert _same(os.path.join(mine, f), os.path.join(single, f)), f


@pytest.mark.parametrize("prefix,gold", [("gold", test_golden), ("m", test_golden_colored)],
                         ids=["pipeline", "pipeline-multi"])
def test_pipelines_equal_the_goldens(group_run, work, prefix, gold):
    world, _ = group_run
    out = os.path.join(work, f"world{world}")
    for name in gold.FILES:
        assert _same(os.path.join(out, "PloidyFrost_output", f"{prefix}_{name}.txt"),
                     os.path.join(gold.GOLD, f"gold_{name}.txt")), name
    assert _same(os.path.join(out, f"{prefix}_model_result.txt"),
                 os.path.join(gold.GOLD, "gold_model_result.txt"))


def test_other_ranks_build_and_analyze_nothing(group_run):
    """Rank 0 loads or builds a graph, colors it and runs the sites pass
    where the command needs it; the other ranks call none of them."""
    world, spies = group_run
    for r in range(1, world):
        assert all(not calls for calls in spies[r].values()), (r, spies[r])
    rank0 = spies[0]
    assert rank0["count"] == {}
    assert rank0["build"] == {"build_graph_from_kmers": 1}
    assert rank0["build -c"] == {"build_graph_from_kmers": 1, "color_graph": 1}
    assert rank0["pipeline"] == {"build_graph_from_kmers": 1, "CDBGraph.from_gfa": 1,
                                 "analyze_bubbles": 1, "window_coverage": 1}
    assert rank0["run"] == {"CDBGraph.from_gfa": 1, "analyze_bubbles": 1,
                            "window_coverage": 1}
    assert rank0["pipeline-multi"] == {"build_graph_from_kmers": 1, "color_graph": 1,
                                       "CDBGraph.from_gfa": 1, "analyze_bubbles_colored": 1}
    assert rank0["run -f"] == {"CDBGraph.from_gfa": 1, "analyze_bubbles_colored": 1}


@pytest.mark.parametrize("name", ["pipeline", "pipeline-multi"])
def test_rank_lines(group_run, work, name):
    """Rank 0 prints one line a rank: its start-to-join seconds, and on
    the other ranks only the stages they run (count and its finalize,
    the reader's inflate, the search, the model and the waits), never
    the graph or the sites pass."""
    world, _ = group_run
    with open(os.path.join(work, f"world{world}.{name}.rank0.log")) as f:
        lines = [ln for ln in f.read().splitlines() if ln.startswith("rank ")]
    assert [ln.split(":")[0] for ln in lines] == [f"rank {r}" for r in range(world)]
    for r, line in enumerate(lines):
        fields = dict(kv.rsplit(" ", 1) for kv in line.split(": ", 1)[1].split(", "))
        assert float(fields["start to join s"]) >= float(fields["group init s"]) >= 0
        # the plain versions on the CPU launch no kernel
        assert fields["K1 launches"] == fields["search launches"] == fields["EM launches"] == "0"
        stages = {k[:-2] for k in fields if k.endswith(" s")} - {
            "start to join", "group init", "route+merge"}
        if r == 0:
            assert {"read", "count", "finalize", "build_graph", "load_graph", "superbubbles",
                    "sites", "model"} <= stages
        else:
            assert stages == {"read", "count", "finalize", "wait", "superbubbles",
                              "model"} | ahead_stages()
        assert float(fields["finalize s"]) <= float(fields["count s"])
    for r in range(1, world):  # the other ranks print nothing
        with open(os.path.join(work, f"world{world}.{name}.rank{r}.log")) as f:
            assert f.read() == ""


# -- errors that only rank 0 sees ------------------------------------------------


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.parametrize("argv,message", [
    (["-g", "missing.gfa", "-d", "c.kmers.npz", "-o", "x"],
     "Error: Graph file not found: missing.gfa"),
    (["-g", "m.gfa", "-f", "m.colors.npz", "-d", "two.txt", "-C", "m.coverage_cutoff.txt",
      "-o", "x"], "Error: 2 databases != 3 colors"),
], ids=["missing-graph", "too-few-databases"])
def test_rank0_error_ends_every_rank_at_once(work, argv, message):
    """Two processes of one rank each: the second's rank has no parent
    that could stop it, so without rank 0's verdict it would end only
    when the group breaks (a traceback) or times out. Both exit 1 within
    seconds, far inside the group's timeout, rank 0 alone prints the
    reference's message, and the other rank ends cleanly."""
    single = os.path.join(work, "single")
    with open(os.path.join(single, "two.txt"), "w") as f:
        f.write("m.s0.kmers.npz\nm.s1.kmers.npz\n")
    port = _free_port()
    procs = []
    t0 = time.time()
    for pid in range(2):
        env = dict(os.environ, PYTHONPATH=ROOT, PLOIDYFROST_DEVICES="auto",
                   PLOIDYFROST_TIMEOUT=str(GROUP_TIMEOUT_S),
                   PLOIDYFROST_COORDINATOR=f"127.0.0.1:{port}",
                   PLOIDYFROST_NUM_PROCESSES="2", PLOIDYFROST_PROCESS_ID=str(pid),
                   PLOIDYFROST_LOCAL_DEVICES="1")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "ploidyfrost_tpu_torch.cli", *argv, "--device=cpu"],
            cwd=single, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    try:
        outs = [p.communicate(timeout=WAIT_S) for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    elapsed = time.time() - t0
    assert [p.returncode for p in procs] == [1, 1], outs
    assert elapsed < GROUP_TIMEOUT_S / 2
    assert message in outs[0][1]
    assert message not in outs[1][1] and "Traceback" not in outs[1][1]


def test_missing_graph_with_the_devices_flag(work, capfd):
    """The command as a user types it, `run -g missing.gfa ... --devices=2
    --device=cpu`: exit code 1 within seconds, and the reference's
    message once, from rank 0."""
    t0 = time.time()
    rc = _in_dir(os.path.join(work, "single"), ["-g", "missing.gfa", "-d", "c.kmers.npz",
                                                "-o", "x", "--devices=2", "--device=cpu"])
    assert rc == 1 and time.time() - t0 < GROUP_TIMEOUT_S / 2
    assert capfd.readouterr().err.count("Error: Graph file not found: missing.gfa") == 1

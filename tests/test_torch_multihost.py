"""The port's multi-host entry point (parallel/mesh.py) in two OS
processes on the CPU, with gloo: the counterpart of
tests/test_multihost.py's library-level table (:120) and full-CLI `run`
(:177), extended to `pipeline` and `pipeline-multi`.

Each process is started as a user starts one host, `python -m
ploidyfrost_tpu_torch.cli ... --devices=4` under PLOIDYFROST_COORDINATOR,
PLOIDYFROST_NUM_PROCESSES=2, PLOIDYFROST_PROCESS_ID and
PLOIDYFROST_LOCAL_DEVICES=2, so the two processes form one group of four
gloo ranks. Process 1 starts first (it waits for the rendezvous that
global rank 0 in process 0 hosts) and runs in an empty directory of its
own with its inputs given by absolute path, as on another host:

  * `run` (on the graph and count table that `pipeline --devices=1`
    built), `pipeline` and `pipeline-multi` write in process 0's
    directory every file `--devices=1` writes, byte for byte, and
    nothing in process 1's; both processes exit 0;
  * a four-rank ShardedKmerCounter split over the two processes gives
    the table, histogram and instance count of the JAX package's
    KmerCounter on the same seeded batches;
  * a process whose peer never starts (process 0 alone,
    PLOIDYFROST_TIMEOUT=20) exits non-zero within 50 s and leaves no
    process behind;
  * `model` over the group: rank 0 alone reads its input and hands the
    values to the other ranks; PLOIDYFROST_LOCAL_DEVICES above the cards
    a process sees is refused.

Every subprocess has a timeout of its own, every group a
PLOIDYFROST_TIMEOUT, and each two-process command runs once (module
fixtures).
"""

import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

import test_golden
import test_golden_colored

TESTS = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(TESTS)
GROUP_TIMEOUT_S = 120
WAIT_S = 300
K = 21


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _env(port=None, pid=None, timeout=GROUP_TIMEOUT_S, **extra):
    env = dict(os.environ, PYTHONPATH=ROOT, PLOIDYFROST_TIMEOUT=str(timeout), **extra)
    if port is not None:
        env.update(PLOIDYFROST_COORDINATOR=f"127.0.0.1:{port}",
                   PLOIDYFROST_NUM_PROCESSES="2", PLOIDYFROST_PROCESS_ID=str(pid),
                   PLOIDYFROST_LOCAL_DEVICES="2")
    return env


def _cli(argv):
    return [sys.executable, "-m", "ploidyfrost_tpu_torch.cli", *argv, "--device=cpu"]


def _children(pid: int) -> set[int]:
    """Every live descendant of `pid` (from /proc)."""
    parent = {}
    for d in os.listdir("/proc"):
        if d.isdigit():
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


def _two_processes(argv, dirs, first_delay=1.0):
    """argv in two coordinated processes, process 1 started first and
    process 0 `first_delay` s later, each in its own directory. Returns
    [(returncode, output)] for processes 0 and 1."""
    port = _free_port()
    procs = {}
    try:
        for pid in (1, 0):
            procs[pid] = subprocess.Popen(
                _cli(argv), cwd=dirs[pid], env=_env(port, pid),
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            if pid == 1:
                time.sleep(first_delay)
        outs = {pid: procs[pid].communicate(timeout=WAIT_S)[0] for pid in (0, 1)}
    finally:
        for p in procs.values():
            p.kill()
            p.wait()
    return [(procs[pid].returncode, outs[pid]) for pid in (0, 1)]


def _tree(d: str) -> dict[str, bytes]:
    out = {}
    for r, _, fs in os.walk(d):
        for f in fs:
            with open(os.path.join(r, f), "rb") as fh:
                out[os.path.relpath(os.path.join(r, f), d)] = fh.read()
    return out


# -- the commands ----------------------------------------------------------------


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The single_diploid reads and the multi_colored samples, by
    absolute path, and what `pipeline` and `pipeline-multi` write on
    one device (single/pipeline, single/pipeline-multi)."""
    d = str(tmp_path_factory.mktemp("torch_multihost"))
    reads = os.path.join(d, "reads.fa")
    test_golden.make_reads(reads)
    samples = [os.path.abspath(p) for p in test_golden_colored.make_sample_reads(d)]
    argvs = {"pipeline": ["pipeline", "-o", "gold", reads],
             "pipeline-multi": ["pipeline-multi", "-o", "m", *samples]}
    procs = {}
    for name, argv in argvs.items():
        os.makedirs(os.path.join(d, "single", name))
        procs[name] = subprocess.Popen(
            _cli([*argv, "--devices=1"]), cwd=os.path.join(d, "single", name), env=_env(),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, p in procs.items():
        out = p.communicate(timeout=WAIT_S)[0]
        assert p.returncode == 0, (name, out)
    built = os.path.join(d, "single", "pipeline")
    argvs["run"] = ["-g", os.path.join(built, "gold.gfa"), "-d",
                    os.path.join(built, "gold.kmers.npz"), "-h",
                    os.path.join(built, "gold.hist.txt"), "-o", "run"]
    os.makedirs(os.path.join(d, "single", "run"))
    p = subprocess.run(_cli([*argvs["run"], "--devices=1"]), cwd=os.path.join(d, "single", "run"),
                       env=_env(), capture_output=True, text=True, timeout=WAIT_S)
    assert p.returncode == 0, p.stdout + p.stderr
    return d, argvs


@pytest.fixture(scope="module", params=["pipeline", "pipeline-multi", "run"])
def two_process_run(request, inputs):
    """One command in two processes of two ranks each: (name, process
    0's directory, process 1's directory, [(rc, output)] of both)."""
    d, argvs = inputs
    name = request.param
    dirs = [os.path.join(d, f"p{pid}", name) for pid in (0, 1)]
    for x in dirs:
        os.makedirs(x)
    results = _two_processes([*argvs[name], "--devices=4"], dirs)
    return name, dirs, results, os.path.join(d, "single", name)


def test_every_process_exits_zero(two_process_run):
    name, _, results, _ = two_process_run
    for pid, (rc, out) in enumerate(results):
        assert rc == 0, (name, pid, out[-3000:])


def test_files_byte_identical_to_one_device(two_process_run):
    name, dirs, _, single = two_process_run
    want, got = _tree(single), _tree(dirs[0])
    assert sorted(got) == sorted(want), name
    assert any(f.endswith("_allele_frequency.txt") for f in got)
    for f in sorted(want):
        assert got[f] == want[f], (name, f)


def test_process_one_writes_nothing_and_prints_no_result(two_process_run):
    name, dirs, results, _ = two_process_run
    assert os.listdir(dirs[1]) == [], name
    (_, out0), (_, out1) = results
    if name != "run":
        assert "estimated ploidy level is : 2" in out0
        # rank 0 prints a line a rank, the ranks of process 1 among them
        assert [ln.split(":")[0] for ln in out0.splitlines() if ln.startswith("rank ")] == [
            f"rank {r}" for r in range(4)]
    assert "estimated ploidy level" not in out1 and "rank 0:" not in out1


# -- the library --------------------------------------------------------------------


def _count_ranks(group, batches_npz, out_npz):
    """One rank: count the batches with ShardedKmerCounter; rank 0
    writes the table, histogram and instance count."""
    from ploidyfrost_tpu_torch.parallel.sharded import ShardedKmerCounter

    z = np.load(batches_npz)
    counter = ShardedKmerCounter(group, K, buffer_capacity=6000)
    for name in sorted(n for n in z.files if n.startswith("batch")):
        counter.add_reads(z[name])
    counter.finalize()
    if group.rank == 0:
        km, ct = counter.arrays()
        np.savez(out_npz, kmers=km, counts=ct, hist=counter.histogram(1000),
                 total=counter.total_kmers, flushes=len(counter.flush_log))
    return 0


def _library_worker(batches_npz, out_npz) -> int:
    """One process of the library case: its two ranks of the group that
    PLOIDYFROST_COORDINATOR describes."""
    from ploidyfrost_tpu_torch.parallel.mesh import resolve_mesh, run_ranks

    plan = resolve_mesh("auto", "cpu")
    assert (plan.local, plan.world) == (2, 4)
    return run_ranks(plan, _count_ranks, (batches_npz, out_npz), timeout=WAIT_S)


def _seeded_batches():
    rng = np.random.default_rng(17)
    G = 20_000
    genome = rng.integers(0, 4, G).astype(np.uint8)
    batches = {}
    for i in range(3):
        starts = rng.integers(0, G - 100, 256)
        codes = genome[starts[:, None] + np.arange(100)[None, :]].copy()
        codes[rng.random(codes.shape) < 0.002] = 4
        batches[f"batch{i}"] = codes
    return batches


def test_sharded_counter_over_two_processes_matches_jax(tmp_path):
    from ploidyfrost_tpu.kmer.count import KmerCounter

    batches = _seeded_batches()
    path = str(tmp_path / "batches.npz")
    np.savez(path, **batches)
    out = str(tmp_path / "table.npz")
    code = ("import sys; sys.path.insert(0, sys.argv[1]); import test_torch_multihost as t; "
            "sys.exit(t._library_worker(sys.argv[2], sys.argv[3]))")
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, "-c", code, TESTS, path, out],
                              cwd=str(tmp_path), env=_env(port, pid),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for pid in (0, 1)]
    try:
        outs = [p.communicate(timeout=WAIT_S)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-3000:]
    ref = KmerCounter(K, initial_capacity=1 << 12)
    for name in sorted(batches):
        ref.add_reads(batches[name])
    km, ct = ref.arrays()
    z = np.load(out)
    assert int(z["flushes"]) > 1  # the buffer forced several routed flushes
    np.testing.assert_array_equal(z["kmers"], np.asarray(km, dtype=np.uint64))
    np.testing.assert_array_equal(z["counts"], np.asarray(ct, dtype=np.int64))
    np.testing.assert_array_equal(z["hist"], np.asarray(ref.histogram(1000)))
    assert int(z["total"]) == ref.total_kmers
    assert len(km) > 10_000


# -- a peer that never comes -----------------------------------------------------------


@pytest.fixture(scope="module", autouse=True)
def lonely(tmp_path_factory):
    """Process 0 alone of two, started before the module's other work
    and watched from a thread while that work runs. Yields a function
    that waits for it and returns its exit code, seconds, output, the
    pids of every process it started, and its directory."""
    import threading

    d = tmp_path_factory.mktemp("torch_multihost_lonely")
    reads = str(d / "reads.fa")
    with open(reads, "w") as f:
        f.write(">r\n" + "ACGT" * 30 + "\n")
    work = d / "p0"
    work.mkdir()
    res = {"seen": set(), "dir": str(work)}
    log = open(d / "out.txt", "w+")
    t0 = time.time()
    p = subprocess.Popen(_cli(["pipeline", "-o", "x", reads, "--devices=4"]), cwd=str(work),
                         env=_env(_free_port(), 0, timeout=20), stdout=log,
                         stderr=subprocess.STDOUT, text=True)

    def watch():
        while p.poll() is None and time.time() - t0 < WAIT_S:
            res["seen"] |= _children(p.pid)
            time.sleep(0.2)
        res["elapsed"] = time.time() - t0

    def finish():
        watcher.join(WAIT_S)
        p.wait(timeout=10)
        res["rc"] = p.returncode
        log.seek(0)
        res["out"] = log.read()
        return res

    watcher = threading.Thread(target=watch, daemon=True)
    watcher.start()
    try:
        yield finish
    finally:
        p.kill()
        p.wait()
        log.close()


def test_process_whose_peer_never_starts_ends_within_its_timeout(lonely):
    """Global rank 0 hosts the rendezvous and waits for the two ranks of
    process 1, which never come. It gives up after PLOIDYFROST_TIMEOUT
    (20 s): the command exits non-zero within 50 s, writes nothing and
    leaves no process behind."""
    lonely = lonely()
    out = lonely["out"][-3000:]
    assert lonely["rc"] != 0, out
    assert lonely["elapsed"] < 50, (lonely["elapsed"], out)
    # rank 0 gives up on the store; rank 1 then loses its connection,
    # and its traceback may come last
    assert "Timed out" in lonely["out"] or "timed out" in lonely["out"], out
    assert len(lonely["seen"]) >= 2  # its two ranks were started
    deadline = time.time() + 10
    while _alive(lonely["seen"]) and time.time() < deadline:
        time.sleep(0.2)
    assert not _alive(lonely["seen"])
    assert os.listdir(lonely["dir"]) == []


# -- what a process is told about its cards and its inputs ---------------------------------


def test_local_devices_beyond_the_cards_fail_without_falling_back(monkeypatch):
    """On cards, PLOIDYFROST_LOCAL_DEVICES above the cards this process
    sees is refused as --devices beyond the cards is; nothing runs on
    the CPU instead."""
    import torch

    from ploidyfrost_tpu_torch.parallel.mesh import resolve_mesh

    for name, value in _env(_free_port(), 1).items():
        if name.startswith("PLOIDYFROST_"):
            monkeypatch.setenv(name, value)
    n = torch.cuda.device_count()
    monkeypatch.setenv("PLOIDYFROST_LOCAL_DEVICES", str(n + 1))
    with pytest.raises(SystemExit, match=f"PLOIDYFROST_LOCAL_DEVICES={n + 1} but only {n} "
                                         "devices visible"):
        resolve_mesh("auto", "cuda")
    plan = resolve_mesh("auto", "cpu")  # the CPU drill keeps its meaning
    assert (plan.local, plan.world, plan.offset, plan.backend) == (n + 1, 2 * (n + 1),
                                                                   n + 1, "gloo")


def test_model_input_only_rank0_reads(tmp_path):
    """`model` over a group: rank 0 alone reads the frequency file and
    hands the values to the others, so the result equals one device's
    even where the other ranks' directory lacks the file; a file rank 0
    cannot read ends every rank with a non-zero code within seconds."""
    rng = np.random.default_rng(8)
    fre = tmp_path / "fre.txt"
    fre.write_text("\n".join(f"{x:.6f}" for x in rng.beta(5, 5, 3000)) + "\n")
    one, group, elsewhere = tmp_path / "one", tmp_path / "group", tmp_path / "elsewhere"
    for d in (one, group, elsewhere):
        d.mkdir()
    argv = ["model", "-g", str(fre), "-o", "m"]
    r = subprocess.run(_cli([*argv, "--devices=1"]), cwd=str(one), env=_env(),
                       capture_output=True, text=True, timeout=WAIT_S)
    assert r.returncode == 0, r.stdout + r.stderr
    results = _two_processes([*argv, "--devices=4"], [str(group), str(elsewhere)])
    assert [rc for rc, _ in results] == [0, 0], results
    assert (group / "m_model_result.txt").read_bytes() == (one / "m_model_result.txt").read_bytes()
    assert os.listdir(elsewhere) == []
    t0 = time.time()
    missing = _two_processes(["model", "-g", str(tmp_path / "absent.txt"), "-o", "x",
                                 "--devices=4"], [str(group), str(elsewhere)])
    assert all(rc != 0 for rc, _ in missing), missing
    assert time.time() - t0 < GROUP_TIMEOUT_S / 2

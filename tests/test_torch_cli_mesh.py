"""`--devices[=N]` and the multi-host environment of the port's CLI
(parallel/mesh.py), on the CPU with gloo.

The JAX package's mesh contract (tests/test_cli_mesh.py,
tests/test_mesh_invariance.py, tests/test_multihost.py): a run on
several devices writes the same bytes as a run on one. Here:

  * the flag's validation gives the JAX package's messages, and the
    flag, PLOIDYFROST_DEVICES and auto resolve in that order;
  * `pipeline --devices=4 --device=cpu` gives the 12 single_diploid
    tables and the model result byte for byte;
  * `pipeline-multi --devices=2 --device=cpu` gives the multi_colored
    golden;
  * `count` in two processes of two ranks each, joined through
    PLOIDYFROST_COORDINATOR, writes the single-process .hist.txt and
    .kmers.npz;
  * a rank that raises makes the command fail within its timeout, with
    no rank left running;
  * neither the parallel modules nor the CLI import jax.

Every rank holds torch to one thread; every group has a process-group
timeout and every wait here a timeout of its own.
"""

import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import test_golden
import test_golden_colored
from test_torch_helpers import few_torch_threads  # noqa: F401  (autouse fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GROUP_TIMEOUT_S = 120
WAIT_S = 300


@pytest.fixture(scope="module", autouse=True)
def group_timeout():
    """Every group this module starts gives up on a collective after
    GROUP_TIMEOUT_S: a hung rank makes its peers fail, and the command
    then fails as soon as one rank has."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PLOIDYFROST_TIMEOUT", str(GROUP_TIMEOUT_S))
        yield


def _same(a, b):
    with open(a, "rb") as f1, open(b, "rb") as f2:
        return f1.read() == f2.read()


def _in_dir(d, argv):
    from ploidyfrost_tpu_torch.cli import main

    cwd = os.getcwd()
    os.chdir(d)
    try:
        return main(argv)
    finally:
        os.chdir(cwd)


# -- the flag ----------------------------------------------------------------


@pytest.mark.parametrize("flag,message", [
    ("--devices=x", "Error: --devices expects an integer, got 'x'"),
    ("--devices=0", "Error: --devices must be >= 1"),
    ("--devices=100000", "Error: --devices=100000 but only"),
])
def test_devices_flag_validation(flag, message, tmp_path, monkeypatch):
    from ploidyfrost_tpu_torch.cli import main

    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit, match=message):
        main(["pipeline", "-o", "o", "r.fa", flag, "--device=cpu"])
    assert os.listdir(tmp_path) == []


def test_devices_beyond_the_cards_fail_without_falling_back():
    """--device=cuda (the default) counts cards; with none visible, two
    devices are refused and nothing runs on the CPU instead."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from ploidyfrost_tpu_torch.cli import main

    with pytest.raises(SystemExit, match="--devices=2 but only 0 devices visible"):
        main(["count", "-o", "o", "r.fa", "--devices=2"])


def test_flag_then_environment_then_auto(monkeypatch):
    from ploidyfrost_tpu_torch.parallel.mesh import resolve_mesh, set_mesh_spec

    monkeypatch.setenv("PLOIDYFROST_DEVICES", "3")
    assert set_mesh_spec(2) == 2
    assert set_mesh_spec(None) == 3
    assert resolve_mesh(None, "cpu").world == 3
    monkeypatch.setenv("PLOIDYFROST_DEVICES", "auto")
    assert set_mesh_spec(None) == "auto"
    assert resolve_mesh(None, "cpu") is None  # auto is one device on the CPU
    monkeypatch.delenv("PLOIDYFROST_DEVICES")
    assert set_mesh_spec(None) == "auto"
    assert resolve_mesh(1, "cpu") is None
    plan = resolve_mesh(4, "cpu")
    assert (plan.local, plan.world, plan.offset, plan.backend) == (4, 4, 0, "gloo")
    assert plan.init_method is None  # a file in a fresh directory


def test_multi_host_environment(monkeypatch):
    from ploidyfrost_tpu_torch.parallel.mesh import resolve_mesh

    monkeypatch.setenv("PLOIDYFROST_COORDINATOR", "10.0.0.1:7000")
    monkeypatch.setenv("PLOIDYFROST_NUM_PROCESSES", "2")
    monkeypatch.setenv("PLOIDYFROST_PROCESS_ID", "1")
    monkeypatch.setenv("PLOIDYFROST_LOCAL_DEVICES", "2")
    plan = resolve_mesh("auto", "cpu")
    assert (plan.local, plan.world, plan.offset) == (2, 4, 2)
    assert plan.init_method == "tcp://10.0.0.1:7000"
    with pytest.raises(SystemExit, match="no multiple of PLOIDYFROST_NUM_PROCESSES=2"):
        resolve_mesh(3, "cpu")
    with pytest.raises(SystemExit, match="--devices=5 but only 4 devices visible"):
        resolve_mesh(5, "cpu")


# -- byte parity with one device ---------------------------------------------


@pytest.fixture(scope="module")
def pipeline4(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("torch_mesh_pipeline"))
    test_golden.make_reads(os.path.join(d, "reads.fa"))
    t0 = time.time()
    assert _in_dir(d, ["pipeline", "-o", "gold", "reads.fa", "--devices=4",
                       "--device=cpu"]) == 0
    assert time.time() - t0 < WAIT_S
    return d


@pytest.mark.parametrize("name", test_golden.FILES)
def test_pipeline_devices4_table(pipeline4, name):
    assert _same(os.path.join(pipeline4, "PloidyFrost_output", f"gold_{name}.txt"),
                 os.path.join(test_golden.GOLD, f"gold_{name}.txt")), name


def test_pipeline_devices4_model_and_outputs(pipeline4):
    assert _same(os.path.join(pipeline4, "gold_model_result.txt"),
                 os.path.join(test_golden.GOLD, "gold_model_result.txt"))
    # rank 0 alone wrote: one of each file, no leftovers of the other ranks
    assert sorted(os.listdir(pipeline4)) == [
        "PloidyFrost_output", "gold.gfa", "gold.hist.txt", "gold.kmers.npz",
        "gold_graph_info.txt", "gold_model_result.txt", "reads.fa"]


@pytest.fixture(scope="module")
def multi2(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("torch_mesh_multi"))
    reads = test_golden_colored.make_sample_reads(d)
    assert _in_dir(d, ["pipeline-multi", "-o", "gold", *reads, "--devices=2",
                       "--device=cpu"]) == 0
    return d


@pytest.mark.parametrize("name", test_golden_colored.FILES)
def test_pipeline_multi_devices2_table(multi2, name):
    assert _same(os.path.join(multi2, "PloidyFrost_output", f"gold_{name}.txt"),
                 os.path.join(test_golden_colored.GOLD, f"gold_{name}.txt")), name


def test_pipeline_multi_devices2_model_and_cutoffs(multi2):
    assert _same(os.path.join(multi2, "gold_model_result.txt"),
                 os.path.join(test_golden_colored.GOLD, "gold_model_result.txt"))
    with open(os.path.join(multi2, "gold.coverage_cutoff.txt")) as f:
        assert f.read() == "10\t39\n10\t41\n10\t37\n"


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_count_two_processes_two_ranks_each(tmp_path):
    """`count` in two coordinated processes of two gloo ranks each (one
    group of four) writes the single-process histogram and table."""
    rng = np.random.default_rng(23)
    G = 50_000
    genome = rng.integers(0, 4, G).astype(np.uint8)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    reads = str(tmp_path / "reads.fa")
    with open(reads, "w") as f:
        for i, s in enumerate(rng.integers(0, G - 120, 1500)):
            f.write(f">r{i}\n" + bases[genome[s : s + 120]].tobytes().decode() + "\n")
    assert _in_dir(str(tmp_path), ["count", "-k", "21", "-o", "single", reads,
                                   "--devices=1", "--device=cpu"]) == 0

    port = _free_port()
    procs = []
    for pid in range(2):
        env = dict(os.environ, PYTHONPATH=ROOT, PLOIDYFROST_DEVICES="auto",
                   PLOIDYFROST_COORDINATOR=f"127.0.0.1:{port}",
                   PLOIDYFROST_NUM_PROCESSES="2", PLOIDYFROST_PROCESS_ID=str(pid),
                   PLOIDYFROST_LOCAL_DEVICES="2")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "ploidyfrost_tpu_torch.cli", "count", "-k", "21",
             "-o", "multi", reads, "--device=cpu"],
            cwd=str(tmp_path), env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    try:
        outs = [p.communicate(timeout=WAIT_S)[0].decode(errors="replace") for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
    assert "count: " in outs[0] and "count: " not in outs[1]  # process 0's rank 0 prints
    assert _same(str(tmp_path / "single.hist.txt"), str(tmp_path / "multi.hist.txt"))
    z1, z2 = np.load(str(tmp_path / "single.kmers.npz")), np.load(str(tmp_path / "multi.kmers.npz"))
    np.testing.assert_array_equal(z1["kmers"], z2["kmers"])
    np.testing.assert_array_equal(z1["counts"], z2["counts"])
    assert len(z1["kmers"]) > 10_000


# -- failures ----------------------------------------------------------------


def _fail_on_rank_one(group):
    """Rank 1 raises while rank 0 waits for it in a collective."""
    import torch.distributed as dist

    if group.rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    dist.barrier()
    return 0


def test_failing_rank_stops_the_group(capfd):
    """The parent returns non-zero as soon as a rank fails, well inside
    the group's timeout, and stops the rank still waiting."""
    from ploidyfrost_tpu_torch.parallel.mesh import RankPlan, run_ranks

    plan = RankPlan(local=2, world=2, offset=0, device_type="cpu", init_method=None,
                    timeout_s=GROUP_TIMEOUT_S, threads=1)
    t0 = time.time()
    rc = run_ranks(plan, _fail_on_rank_one, (), timeout=WAIT_S)
    assert rc != 0
    assert time.time() - t0 < plan.timeout_s
    assert "rank 1 fails on purpose" in capfd.readouterr().err
    import multiprocessing

    assert multiprocessing.active_children() == []


def test_cli_exits_nonzero_when_its_ranks_raise(tmp_path):
    reads = tmp_path / "r.fa"
    reads.write_text(">r1\n" + "ACGTTGCAAGGCTTAACCGGTACGTAGCTAGGATCCA" * 3 + "\n")
    t0 = time.time()
    rc = _in_dir(str(tmp_path), ["count", "-k", "40", "-o", "x", str(reads), "--devices=2",
                                 "--device=cpu"])
    assert rc != 0 and time.time() - t0 < WAIT_S
    assert sorted(os.listdir(tmp_path)) == ["r.fa"]


def test_parallel_modules_import_no_jax():
    code = (
        "import sys\n"
        "import ploidyfrost_tpu_torch.parallel as par\n"
        "import ploidyfrost_tpu_torch.parallel.mesh, ploidyfrost_tpu_torch.parallel.sharded\n"
        "import ploidyfrost_tpu_torch.cli\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'ploidyfrost_tpu')]\n"
        "print(bad, par.ShardedKmerCounter.__module__)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "ploidyfrost_tpu_torch.parallel.sharded" in proc.stdout

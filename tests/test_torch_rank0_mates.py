"""`pipeline` and `pipeline-multi` on samples split over two mate files,
on a group of two gloo ranks against one device (parallel/, pipeline.py,
io/fastx.py's ReadAhead).

Every rank reads every batch and counts its slice, so the ranks must
take the same batches; the read-ahead gives each file its own partial
last batch and takes the files round-robin. Here each sample is two
files (the records split alternately), rank 1's reader lags on every
sample's first file, and the tests hold that every file the commands
write is byte-identical to one device's and the tables to the goldens
of the unsplit reads.
"""

import os
import time

import pytest

import test_golden
import test_golden_colored
from test_torch_helpers import few_torch_threads  # noqa: F401  (autouse fixture)

GROUP_TIMEOUT_S = 120
WAIT_S = 600
MULTI = ["../s0_1.fa,../s0_2.fa", "../s1_1.fa,../s1_2.fa", "../s2_1.fa,../s2_2.fa"]
# (name, argv, the prefix of every file it writes, the golden module)
COMMANDS = [
    ("pipeline", ["pipeline", "-o", "p", "../r_1.fa", "../r_2.fa"], "p", test_golden),
    ("pipeline-multi", ["pipeline-multi", "-o", "m", *MULTI], "m", test_golden_colored),
]


@pytest.fixture(scope="module", autouse=True)
def group_timeout():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PLOIDYFROST_TIMEOUT", str(GROUP_TIMEOUT_S))
        yield


def _split(path: str, first: str, second: str) -> None:
    """Two-line FASTA records, alternately to `first` and `second`."""
    with open(path) as f:
        lines = f.read().splitlines(keepends=True)
    with open(first, "w") as a, open(second, "w") as b:
        for i in range(0, len(lines), 2):
            (a if i % 4 == 0 else b).writelines(lines[i : i + 2])


def _lag_first_mates() -> None:
    """Slow every batch of each sample's first file in this process."""
    from ploidyfrost_tpu_torch.io import fastx

    real = fastx.read_batches_native

    def lagging(paths, *args):
        for b in real(paths, *args):
            if paths[0].endswith("_1.fa"):
                time.sleep(0.05)
            yield b

    fastx.read_batches_native = lagging


def _group_job(group, work):
    """Every rank: the COMMANDS in work/group, rank 1 lagging."""
    import contextlib

    from ploidyfrost_tpu_torch import cli

    if group.rank == 1:
        _lag_first_mates()
    os.chdir(os.path.join(work, "group"))
    for name, argv, _, _ in COMMANDS:
        with open(os.path.join(work, f"{name}.rank{group.rank}.log"), "w") as f, \
                contextlib.redirect_stdout(f):
            rc = cli._main(argv, "cpu", False, group)
        if rc:
            return rc
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
    """The split reads, every command's files from one device in
    work/single and from two gloo ranks in work/group."""
    from ploidyfrost_tpu_torch.parallel.mesh import RankPlan, run_ranks

    d = str(tmp_path_factory.mktemp("torch_rank0_mates"))
    test_golden.make_reads(os.path.join(d, "reads.fa"))
    _split(os.path.join(d, "reads.fa"), os.path.join(d, "r_1.fa"), os.path.join(d, "r_2.fa"))
    for path in test_golden_colored.make_sample_reads(d):
        _split(path, path[:-3] + "_1.fa", path[:-3] + "_2.fa")
    for sub in ("single", "group"):
        os.makedirs(os.path.join(d, sub))
    for _, argv, _, _ in COMMANDS:
        assert _in_dir(os.path.join(d, "single"), [*argv, "--devices=1", "--device=cpu"]) == 0
    plan = RankPlan(local=2, world=2, offset=0, device_type="cpu", init_method=None,
                    timeout_s=GROUP_TIMEOUT_S, threads=1)
    assert run_ranks(plan, _group_job, (d,), timeout=WAIT_S) == 0
    return d


@pytest.mark.parametrize("name,prefix", [(c[0], c[2]) for c in COMMANDS],
                         ids=[c[0] for c in COMMANDS])
def test_two_ranks_write_what_one_device_writes(work, name, prefix):
    single, group = os.path.join(work, "single"), os.path.join(work, "group")
    want = _files(single, prefix)
    assert want and _files(group, prefix) == want, name
    for f in want:
        assert _same(os.path.join(group, f), os.path.join(single, f)), f


@pytest.mark.parametrize("name,prefix,gold", [(c[0], c[2], c[3]) for c in COMMANDS],
                         ids=[c[0] for c in COMMANDS])
def test_split_mates_give_the_goldens(work, name, prefix, gold):
    """The k-mer multiset is the unsplit reads', so every table is."""
    for sub in ("single", "group"):
        out = os.path.join(work, sub)
        for table in gold.FILES:
            assert _same(os.path.join(out, "PloidyFrost_output", f"{prefix}_{table}.txt"),
                         os.path.join(gold.GOLD, f"gold_{table}.txt")), (sub, table)
        assert _same(os.path.join(out, f"{prefix}_model_result.txt"),
                     os.path.join(gold.GOLD, "gold_model_result.txt")), sub

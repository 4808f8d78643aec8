"""The indel_dense golden through the torch port on the CPU.

The reads of tests/test_golden_indel.py (1 Mbp tetraploid, ~900
scattered indels and clustered indel runs, 18 passes a haplotype) go
through the port's `pipeline` with device="cpu", which counts, derives
the cutoffs, builds the graph and calls `run_analysis` and the model.
The 12 reference tables of tests/golden/indel_dense/ and
gold_model_result.txt must come out byte for byte, with the pinned
cutoffs (10, 83) and ploidy 4: the multi-branch bubbles, co-optimal
traceback ties and the indel-run cap that the small diploid golden
hardly reaches.
"""

import os

import pytest

from test_golden_indel import CUTOFFS, FILES, GOLD, PLOIDY, make_indel_reads
from test_torch_helpers import few_torch_threads  # noqa: F401  (autouse fixture)


@pytest.fixture(scope="module")
def indel_run(tmp_path_factory):
    from ploidyfrost_tpu_torch.cli import Options, parse_options
    from ploidyfrost_tpu_torch.pipeline import run_pipeline_cli

    d = tmp_path_factory.mktemp("torch_golden_indel")
    cwd = os.getcwd()
    os.chdir(d)
    try:
        make_indel_reads("reads.fa")
        opt = parse_options(["-o", "gold", "reads.fa"], Options(), extras="c")
        assert run_pipeline_cli(opt, device="cpu") == 0
        yield str(d), opt
    finally:
        os.chdir(cwd)


@pytest.mark.parametrize("name", FILES)
def test_indel_table_matches_reference(indel_run, name):
    d, _ = indel_run
    with open(os.path.join(d, "PloidyFrost_output", f"gold_{name}.txt"), "rb") as f1, open(
        os.path.join(GOLD, f"gold_{name}.txt"), "rb"
    ) as f2:
        assert f1.read() == f2.read(), f"{name} differs from reference output"


def test_indel_model_cutoffs_and_ploidy(indel_run):
    d, opt = indel_run
    assert (opt.coverage_lower, opt.coverage_upper) == CUTOFFS
    with open(os.path.join(d, "gold_model_result.txt"), "rb") as f1, open(
        os.path.join(GOLD, "gold_model_result.txt"), "rb"
    ) as f2:
        mine = f1.read()
        assert mine == f2.read()
    assert mine.decode().rstrip().endswith(f"estimated ploidy level is : {PLOIDY}")

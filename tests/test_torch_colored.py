"""The multi-sample (colored) path of the torch port on the CPU.

The inputs of tests/test_golden_colored.py (3 diploid samples, 60 kb,
seed 7) go through the port with device="cpu" by three routes, and each
must reproduce the 12 reference tables of tests/golden/multi_colored/
and gold_model_result.txt byte for byte:

  * the functions, as the JAX package's golden test calls them: count,
    filter, union, color_graph, the .bfg_colors writer and reader,
    run_colored_analysis, run_model;
  * the stage subcommands of the CLI: `count` x3, `cutoffL`/`cutoffU` on
    the written histograms, `build -c` on each sample's masked k-mers
    (the reference pipeline's masking stage, kmc_tools filter, done here
    from the count tables), `run -f -C`, `model`;
  * `pipeline-multi`, whose tables also equal those of the JAX
    package's run_multisample_pipeline_cli on the same reads.

Then ColorMatrix, KmerPosIndex and MultiColorCountDB against the JAX
package's on seeded numpy inputs. Every comparison is exact.
"""

import os

import numpy as np
import pytest

from test_golden_colored import FILES, GOLD, make_sample_reads
from test_torch_helpers import ahead_stages, few_torch_threads  # noqa: F401  (autouse fixture)

CUTOFFS = [(10, 39), (10, 41), (10, 37)]


def _same_file(mine, gold):
    with open(mine, "rb") as f1, open(gold, "rb") as f2:
        return f1.read() == f2.read()


def _table(d, pre, name):
    return os.path.join(d, "PloidyFrost_output", f"{pre}_{name}.txt")


@pytest.fixture(scope="module")
def sample_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_colored_reads")
    make_sample_reads(str(d))
    return str(d)


# -- route 1: the functions ---------------------------------------------


@pytest.fixture(scope="module")
def functions_run(sample_dir, tmp_path_factory):
    from ploidyfrost_tpu_torch.cli import Options
    from ploidyfrost_tpu_torch.graph.cdbg import CDBGraph
    from ploidyfrost_tpu_torch.graph.colors import color_graph
    from ploidyfrost_tpu_torch.graph.construct import build_graph_from_kmers, simplify
    from ploidyfrost_tpu_torch.io.bfg import read_bfg_colors, write_bfg_colors
    from ploidyfrost_tpu_torch.io.fastx import read_batches
    from ploidyfrost_tpu_torch.kmer.count import KmerCounter
    from ploidyfrost_tpu_torch.kmer.cutoffs import (
        cutoff_lower_from_counts,
        cutoff_upper_from_counts,
    )
    from ploidyfrost_tpu_torch.model.gmm import run_model
    from ploidyfrost_tpu_torch.pipeline import run_colored_analysis

    d = tmp_path_factory.mktemp("torch_colored_fn")
    cwd = os.getcwd()
    os.chdir(d)
    try:
        filtered, cutoffs = [], []
        for i in range(3):
            counter = KmerCounter(25, device="cpu")
            for b in read_batches([os.path.join(sample_dir, f"s{i}.fa")], 25):
                counter.add_reads(b)
            hist = counter.histogram(10000)
            lower = max(10, cutoff_lower_from_counts(list(hist[1:])))
            upper = cutoff_upper_from_counts(list(hist[1:]), 0.998)
            cutoffs.append((lower, upper))
            km, ct = counter.arrays()
            np.savez(f"s{i}.kmers.npz", kmers=km, counts=ct, k=25)
            filtered.append(km[ct >= lower])
        union = np.unique(np.concatenate(filtered))
        g = simplify(build_graph_from_kmers(union, 25), 25)
        colors = color_graph(g, filtered, [f"s{i}.fa" for i in range(3)])
        da = write_bfg_colors("ref.bfg_colors", g, colors)
        g.write_gfa("ref.gfa", da_ids=da)
        colors2 = read_bfg_colors("ref.bfg_colors", CDBGraph.from_gfa("ref.gfa"))
        with open("list.txt", "w") as f:
            f.writelines(f"s{i}.kmers.npz\n" for i in range(3))
        opt = Options()
        opt.graphfile = "ref.gfa"
        opt.colorfile = "ref.bfg_colors"
        opt.db = "list.txt"
        opt.outprefix = "gold"
        opt.coverage_vec = cutoffs
        assert run_colored_analysis(opt, device="cpu") == 0
        ploidy = run_model(
            "gold",
            fre_file=os.path.join("PloidyFrost_output", "gold_allele_frequency.txt"),
            device="cpu",
        )
        yield {
            "dir": str(d), "cutoffs": cutoffs, "ploidy": ploidy,
            "colors": colors, "colors2": colors2, "opt": opt,
        }
    finally:
        os.chdir(cwd)


@pytest.mark.parametrize("name", FILES)
def test_functions_table_matches_reference(functions_run, name):
    assert _same_file(
        _table(functions_run["dir"], "gold", name), os.path.join(GOLD, f"gold_{name}.txt")
    ), f"{name} differs from reference output"


def test_functions_model_matches_reference(functions_run):
    assert _same_file(
        os.path.join(functions_run["dir"], "gold_model_result.txt"),
        os.path.join(GOLD, "gold_model_result.txt"),
    )


def test_functions_cutoffs_ploidy_and_stages(functions_run):
    assert functions_run["cutoffs"] == CUTOFFS
    assert functions_run["ploidy"] == 2
    assert set(functions_run["opt"].stage_seconds) == {
        "load_graph", "superbubbles", "sites",
        "load_table", "search", "replay", "coverage", "coverage_wait", "align",
        "window_coverage", "write_tables", "unstaged",
    }


def test_bfg_colors_round_trip_bit_equal(functions_run):
    a, b = functions_run["colors"], functions_run["colors2"]
    np.testing.assert_array_equal(a.offsets, b.offsets)
    np.testing.assert_array_equal(a.bits, b.bits)
    assert a.names == b.names


# -- route 2: the stage subcommands ---------------------------------------


def _write_kmers_as_reads(path, kmers, k):
    """One k-bp FASTA record per packed k-mer."""
    shifts = np.uint64(2) * np.arange(k - 1, -1, -1, dtype=np.uint64)
    codes = ((kmers[:, None] >> shifts[None, :]) & np.uint64(3)).astype(np.intp)
    rows = np.frombuffer(b"ACGT", dtype=np.uint8)[codes]
    with open(path, "w") as f:
        f.writelines(f">m{i}\n{r.tobytes().decode()}\n" for i, r in enumerate(rows))


@pytest.fixture(scope="module")
def cli_run(sample_dir, tmp_path_factory):
    from ploidyfrost_tpu_torch.cli import main

    d = tmp_path_factory.mktemp("torch_colored_cli")
    cwd = os.getcwd()
    os.chdir(d)
    try:
        for i in range(3):
            reads = os.path.join(sample_dir, f"s{i}.fa")
            assert main(["count", "-k", "25", "-o", f"s{i}", reads, "--device=cpu"]) == 0
        yield str(d)
    finally:
        os.chdir(cwd)


def test_cli_cutoff_subcommands_give_pinned_pairs(cli_run, capsys):
    from ploidyfrost_tpu_torch.cli import main

    capsys.readouterr()
    got = []
    for i in range(3):
        hist = os.path.join(cli_run, f"s{i}.hist.txt")
        assert main(["cutoffL", hist]) == 0
        lower = capsys.readouterr().out
        assert lower.endswith("\n")
        assert main(["cutoffU", hist, "0.998"]) == 0
        upper = capsys.readouterr().out
        assert not upper.endswith("\n")  # shell pipelines read this as is
        assert main(["cutoffU", hist]) == 0
        assert capsys.readouterr().out == upper + "\n"
        got.append((int(lower), int(upper)))
    assert got == CUTOFFS


@pytest.fixture(scope="module")
def cli_tables(cli_run):
    from ploidyfrost_tpu_torch.cli import main

    cwd = os.getcwd()
    os.chdir(cli_run)
    try:
        masked = []
        for i, (lower, _) in enumerate(CUTOFFS):
            z = np.load(f"s{i}.kmers.npz")
            masked.append(f"m{i}.fa")
            _write_kmers_as_reads(masked[-1], z["kmers"][z["counts"] >= lower], 25)
        assert main(["build", "-c", "-k", "25", "-o", "cg", *masked, "--device=cpu"]) == 0
        with open("list.txt", "w") as f:
            f.writelines(f"s{i}.kmers.npz\n" for i in range(3))
        with open("cov.txt", "w") as f:
            f.writelines(f"{lo}\t{up}\n" for lo, up in CUTOFFS)
        rc = main([
            "-g", "cg.gfa", "-f", "cg.colors.npz", "-d", "list.txt", "-C", "cov.txt",
            "-o", "gold", "--device=cpu",
        ])
        assert rc == 0
        fre = os.path.join("PloidyFrost_output", "gold_allele_frequency.txt")
        assert main(["model", "-g", fre, "-o", "gold", "--device=cpu"]) == 0
        return cli_run
    finally:
        os.chdir(cwd)


@pytest.mark.parametrize("name", FILES)
def test_cli_table_matches_reference(cli_tables, name):
    assert _same_file(
        _table(cli_tables, "gold", name), os.path.join(GOLD, f"gold_{name}.txt")
    ), f"{name} differs from reference output"


def test_cli_model_matches_reference(cli_tables):
    assert _same_file(
        os.path.join(cli_tables, "gold_model_result.txt"),
        os.path.join(GOLD, "gold_model_result.txt"),
    )


def test_cli_run_takes_histogram_list(cli_tables, tmp_path):
    """`run -f` with -h (a file listing one histogram per color) derives
    the same cutoffs as -C gave, so the same tables."""
    from ploidyfrost_tpu_torch.cli import main

    cwd = os.getcwd()
    os.chdir(cli_tables)
    try:
        with open("hists.txt", "w") as f:
            f.writelines(f"s{i}.hist.txt\n" for i in range(3))
        rc = main([
            "-g", "cg.gfa", "-f", "cg.colors.npz", "-d", "list.txt", "-h", "hists.txt",
            "-o", "byhist", "--device=cpu",
        ])
        assert rc == 0
        for name in FILES:
            if name == "Unitig_Id":
                continue
            assert _same_file(
                _table(cli_tables, "byhist", name), os.path.join(GOLD, f"gold_{name}.txt")
            ), name
    finally:
        os.chdir(cwd)


# -- route 3: pipeline-multi ----------------------------------------------


@pytest.fixture(scope="module")
def multi_run(sample_dir, tmp_path_factory):
    from ploidyfrost_tpu_torch.cli import Options, main

    d = tmp_path_factory.mktemp("torch_colored_multi")
    cwd = os.getcwd()
    os.chdir(d)
    try:
        reads = [os.path.join(sample_dir, f"s{i}.fa") for i in range(3)]
        assert main(["pipeline-multi", "-o", "gold", *reads, "--device=cpu"]) == 0

        # the same reads through the JAX package
        from ploidyfrost_tpu.cli import Options as JaxOptions
        from ploidyfrost_tpu.pipeline import run_multisample_pipeline_cli as jax_multi

        jopt = JaxOptions()
        jopt.outprefix = "jx"
        jopt.inputs = reads
        assert jax_multi(jopt) == 0

        # and through the function, for the stage times
        from ploidyfrost_tpu_torch.pipeline import run_multisample_pipeline_cli

        opt = Options()
        opt.outprefix = "fn"
        opt.inputs = reads
        assert run_multisample_pipeline_cli(opt, device="cpu") == 0
        yield str(d), opt
    finally:
        os.chdir(cwd)


@pytest.mark.parametrize("name", FILES)
def test_multi_table_matches_reference_and_jax(multi_run, name):
    d, _ = multi_run
    gold = os.path.join(GOLD, f"gold_{name}.txt")
    assert _same_file(_table(d, "gold", name), gold), f"{name} differs from reference output"
    assert _same_file(_table(d, "jx", name), _table(d, "gold", name)), (
        f"{name} differs from the JAX package's"
    )


def test_multi_model_cutoffs_and_stages(multi_run):
    d, opt = multi_run
    gold = os.path.join(GOLD, "gold_model_result.txt")
    assert _same_file(os.path.join(d, "gold_model_result.txt"), gold)
    assert _same_file(os.path.join(d, "jx_model_result.txt"), gold)
    assert opt.coverage_vec == CUTOFFS
    with open(os.path.join(d, "gold.coverage_cutoff.txt")) as f:
        assert f.read() == "".join(f"{lo}\t{up}\n" for lo, up in CUTOFFS)
    assert set(opt.stage_seconds) == {
        "read", "count", "build_graph", "color_graph",
        "load_graph", "superbubbles", "sites", "model",
        "table_d2h", "link", "assemble", "write_graph", "load_table", "search", "replay",
        "coverage", "coverage_wait", "align", "window_coverage", "write_tables", "unstaged",
    } | ahead_stages()
    for ext in (".gfa", ".colors.npz", ".s0.kmers.npz", ".s2.hist.txt"):
        a, b = os.path.join(d, "gold" + ext), os.path.join(d, "jx" + ext)
        if ext.endswith(".npz"):
            za, zb = np.load(a), np.load(b)
            assert sorted(za.files) == sorted(zb.files)
            for key in za.files:
                np.testing.assert_array_equal(za[key], zb[key], err_msg=ext + ":" + key)
        else:
            assert _same_file(a, b), ext


# -- the colored data structures against the JAX package's -----------------


def _seeded_graph(seed, mod):
    """A small two-haplotype graph built by package `mod`'s own
    construction, and the k-mer sets of three samples that each drop a
    different random tenth of its k-mers."""
    rng = np.random.default_rng(seed)
    k = 15
    g1 = rng.integers(0, 4, 3000).astype(np.uint8)
    g2 = g1.copy()
    snp = rng.random(3000) < 0.01
    g2[snp] = (g2[snp] + rng.integers(1, 4, snp.sum())) % 4
    k1, _ = mod["pack"].sequence_kmers_np(g1, k)
    k2, _ = mod["pack"].sequence_kmers_np(g2, k)
    km = np.unique(mod["pack"].canonical_np(np.concatenate([k1, k2]), k))
    g = mod["construct"].build_graph_from_kmers(km, k)
    samples = [km[rng.random(len(km)) >= 0.1] for _ in range(3)]
    return g, km, samples, rng


def _packages():
    import ploidyfrost_tpu.graph.colors as jc
    import ploidyfrost_tpu.graph.construct as jco
    import ploidyfrost_tpu.kmer.countdb as jdb
    import ploidyfrost_tpu.kmer.pack as jp
    import ploidyfrost_tpu_torch.graph.colors as tc
    import ploidyfrost_tpu_torch.graph.construct as tco
    import ploidyfrost_tpu_torch.kmer.countdb as tdb
    import ploidyfrost_tpu_torch.kmer.pack as tp

    return (
        {"colors": jc, "construct": jco, "countdb": jdb, "pack": jp},
        {"colors": tc, "construct": tco, "countdb": tdb, "pack": tp},
    )


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_color_matrix_matches_jax(seed):
    jax_mod, port_mod = _packages()
    gj, _, samples, _ = _seeded_graph(seed, jax_mod)
    gt, _, samples_t, _ = _seeded_graph(seed, port_mod)
    assert list(gj.seqs) == list(gt.seqs)
    cj = jax_mod["colors"].color_graph(gj, samples)
    ct = port_mod["colors"].color_graph(gt, samples_t)
    np.testing.assert_array_equal(cj.offsets, ct.offsets)
    np.testing.assert_array_equal(cj.bits, ct.bits)
    assert cj.names == ct.names and cj.n_colors == ct.n_colors == 3
    np.testing.assert_array_equal(cj.full_colors_all(), ct.full_colors_all())
    np.testing.assert_array_equal(cj.size_all(), ct.size_all())
    for a, b in zip(cj.gate_arrays(), ct.gate_arrays()):
        np.testing.assert_array_equal(a, b)
    for ui in range(0, len(gj), max(1, len(gj) // 25)):
        np.testing.assert_array_equal(cj.full_colors(ui), ct.full_colors(ui))
        np.testing.assert_array_equal(cj.color_kmer_counts(ui), ct.color_kmer_counts(ui))
        assert cj.size(ui) == ct.size(ui)
        assert cj.size_as(ui, 7) == ct.size_as(ui, 7) == ct.size_as_flat(ui, 7)
        assert cj.contains_all(ui, 1) == ct.contains_all(ui, 1)
        assert cj.contains_at(ui, 0, 2) == ct.contains_at(ui, 0, 2)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kmer_pos_index_matches_jax(seed):
    jax_mod, port_mod = _packages()
    gj, km, _, rng = _seeded_graph(seed, jax_mod)
    gt, _, _, _ = _seeded_graph(seed, port_mod)
    ij, it = gj.kmer_pos_index(), gt.kmer_pos_index()
    assert it is gt.kmer_pos_index()  # cached on the graph
    absent = rng.integers(0, 1 << 30, 200, dtype=np.uint64)
    q = np.concatenate([km[rng.integers(0, len(km), 500)], absent])
    for a, b in zip(ij.find(q), it.find(q)):
        np.testing.assert_array_equal(a, b)
    assert it.find(q)[2][:500].all()
    for s in list(gt.seqs)[:20]:
        assert ij.find_string_head(s) == it.find_string_head(s)


@pytest.mark.parametrize("same_keys", [True, False], ids=["identical-keys", "union"])
@pytest.mark.parametrize("n", [300, 20000], ids=["numpy-probe", "native-probe"])
def test_multi_color_count_db_matches_jax(same_keys, n):
    """Both construction routes (every database holds the same keys, or
    the keys are unioned and the counts scattered) and both probe paths
    (numpy below 4096 queries, the native fused probe above)."""
    jax_mod, port_mod = _packages()
    rng = np.random.default_rng(11 + n)
    k = 25
    base = np.unique(
        jax_mod["pack"].canonical_np(rng.integers(0, 1 << 50, n, dtype=np.uint64), k)
    )
    tables = []
    for _ in range(3):
        km = base if same_keys else base[rng.random(len(base)) >= 0.2]
        tables.append((km, rng.integers(1, 10000, len(km))))
    mj = jax_mod["countdb"].MultiColorCountDB(
        [jax_mod["countdb"].KmerCountDB(km, ct, k) for km, ct in tables]
    )
    mt = port_mod["countdb"].MultiColorCountDB(
        [port_mod["countdb"].KmerCountDB(km, ct, k) for km, ct in tables]
    )
    present = base[rng.integers(0, len(base), n)]
    q = np.concatenate([
        present[: n // 2],
        port_mod["pack"].revcomp_np(present[n // 2 :], k),  # the other strand
        rng.integers(0, 1 << 50, n // 4, dtype=np.uint64),  # mostly absent
    ])
    cj, hj = mj.lookup(q)
    ct_, ht = mt.lookup(q)
    np.testing.assert_array_equal(cj, ct_)
    np.testing.assert_array_equal(hj, ht)
    assert ct_.shape == (len(q), 3)
    union = np.unique(np.concatenate([km for km, _ in tables]))
    np.testing.assert_array_equal(ht, np.isin(port_mod["pack"].canonical_np(q, k), union))
    assert ht.any() and not ht.all()
    cjt, _ = mj.lookup_t(q)
    ctt, _ = mt.lookup_t(q)
    np.testing.assert_array_equal(cjt, ctt)
    # against each database's own lookup
    for c, (km, cnt) in enumerate(tables):
        one, hit = port_mod["countdb"].KmerCountDB(km, cnt, k).lookup(q)
        np.testing.assert_array_equal(ct_[:, c], one)
        assert not (hit & ~ht).any()
    e_counts, e_hit = mt.lookup(np.zeros(0, np.uint64))
    assert e_counts.shape == (0, 3) and e_hit.shape == (0,)


@pytest.mark.parametrize("sizes", [(0,), (1,), (0, 0), (5000, 4000, 6000), (3, 0, 70000)])
def test_sorted_union_is_np_unique(sizes):
    from ploidyfrost_tpu_torch.kmer.countdb import sorted_union

    rng = np.random.default_rng(sum(sizes))
    arrays = [np.unique(rng.integers(0, 1 << 16, n, dtype=np.uint64)) << np.uint64(40)
              for n in sizes]
    got = sorted_union(arrays)
    assert got.dtype == np.uint64
    np.testing.assert_array_equal(got, np.unique(np.concatenate(arrays)))

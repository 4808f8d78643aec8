"""File interop of the torch port: Bifrost .bfg_colors and KMC databases.

The port keeps its own copies of io/bfg.py and io/kmc.py. Files written
by the port must be byte-equal to the JAX package's writers on the same
seeded inputs, each package's reader must decode the other's files to
the same arrays, and `run -d <kmc prefix>` must give the single_diploid
reference tables from a KMC database in place of the .npz table.
"""

import os

import numpy as np
import pytest

import ploidyfrost_tpu.graph.colors as jax_colors
import ploidyfrost_tpu.graph.construct as jax_construct
import ploidyfrost_tpu.io.bfg as jax_bfg
import ploidyfrost_tpu.io.kmc as jax_kmc
import ploidyfrost_tpu_torch.graph.colors as port_colors
import ploidyfrost_tpu_torch.graph.construct as port_construct
import ploidyfrost_tpu_torch.io.bfg as port_bfg
import ploidyfrost_tpu_torch.io.kmc as port_kmc
from ploidyfrost_tpu_torch.kmer.pack import canonical_np, sequence_kmers_np
from test_golden import FILES, GOLD, make_reads
from test_torch_helpers import few_torch_threads  # noqa: F401  (autouse fixture)


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _random_table(seed, n, k):
    rng = np.random.default_rng(seed)
    km = rng.integers(0, 1 << (2 * k), size=2 * n, dtype=np.uint64)
    km = np.unique(canonical_np(km, k))[:n]
    ct = rng.integers(1, 10000, size=len(km)).astype(np.int64)
    return km, ct


@pytest.mark.parametrize("fmt", ["kmc1", "kmc2"])
@pytest.mark.parametrize("k,n", [(25, 5000), (17, 3000), (31, 2000), (25, 1)])
def test_kmc_files_byte_equal_and_cross_read(tmp_path, fmt, k, n):
    km, ct = _random_table(3 * k + n, n, k)
    name = "write_kmc_db" if fmt == "kmc1" else "write_kmc2_db"
    pj, pt = str(tmp_path / "jax_db"), str(tmp_path / "port_db")
    getattr(jax_kmc, name)(pj, km, ct, k)
    getattr(port_kmc, name)(pt, km, ct, k)
    for ext in (".kmc_pre", ".kmc_suf"):
        assert _read(pj + ext) == _read(pt + ext), ext
    # each reader on the other's files
    for reader, prefix in ((port_kmc.read_kmc_db, pj), (jax_kmc.read_kmc_db, pt)):
        km2, ct2, k2 = reader(prefix)
        assert k2 == k
        np.testing.assert_array_equal(km2, km)
        np.testing.assert_array_equal(ct2, ct)


def test_kmc_signatures_match_jax():
    km, _ = _random_table(5, 4000, 25)
    for sig_len in (5, 7, 9):
        np.testing.assert_array_equal(
            port_kmc.kmer_signatures(km, 25, sig_len),
            jax_kmc.kmer_signatures(km, 25, sig_len),
        )


def _colored_graph(seed, construct, colors_mod, n_colors):
    rng = np.random.default_rng(seed)
    k = 21
    haps = [rng.integers(0, 4, 4000).astype(np.uint8)]
    for _ in range(n_colors - 1):
        h = haps[0].copy()
        snp = rng.random(len(h)) < 0.01
        h[snp] = (h[snp] + rng.integers(1, 4, snp.sum())) % 4
        haps.append(h)
    samples = [
        np.unique(canonical_np(sequence_kmers_np(h, k)[0], k)) for h in haps
    ]
    g = construct.build_graph_from_kmers(np.unique(np.concatenate(samples)), k)
    names = [f"sample_{c}.fa" for c in range(n_colors)]
    return g, colors_mod.color_graph(g, samples, names)


@pytest.mark.parametrize("n_colors", [2, 3, 9])
def test_bfg_colors_byte_equal_and_cross_read(tmp_path, n_colors):
    gj, cj = _colored_graph(n_colors, jax_construct, jax_colors, n_colors)
    gt, ct = _colored_graph(n_colors, port_construct, port_colors, n_colors)
    pj, pt = str(tmp_path / "jax.bfg_colors"), str(tmp_path / "port.bfg_colors")
    da_j = jax_bfg.write_bfg_colors(pj, gj, cj)
    da_t = port_bfg.write_bfg_colors(pt, gt, ct)
    assert _read(pj) == _read(pt)
    np.testing.assert_array_equal(da_j, da_t)
    gj.write_gfa(str(tmp_path / "jax.gfa"), da_ids=da_j)
    gt.write_gfa(str(tmp_path / "port.gfa"), da_ids=da_t)
    assert _read(tmp_path / "jax.gfa") == _read(tmp_path / "port.gfa")
    # each reader on the other's files
    from ploidyfrost_tpu.graph.cdbg import CDBGraph as JaxGraph
    from ploidyfrost_tpu_torch.graph.cdbg import CDBGraph as PortGraph

    back_t = port_bfg.read_bfg_colors(pj, PortGraph.from_gfa(str(tmp_path / "jax.gfa")))
    back_j = jax_bfg.read_bfg_colors(pt, JaxGraph.from_gfa(str(tmp_path / "port.gfa")))
    for back in (back_t, back_j):
        np.testing.assert_array_equal(back.bits, ct.bits)
        np.testing.assert_array_equal(back.offsets, ct.offsets)
        assert back.names == ct.names
    np.testing.assert_array_equal(back_t.full_counts, back_j.full_counts)


def test_bfg_primitives_match_jax():
    rng = np.random.default_rng(2)
    for n in (0, 1, 50, 5000):
        vals = np.unique(rng.integers(0, 1 << 20, n)).astype(np.uint32)
        buf = port_bfg.roaring_serialize(vals)
        assert buf == jax_bfg.roaring_serialize(vals)
        np.testing.assert_array_equal(port_bfg.roaring_deserialize(buf), vals)
        ids = np.unique(rng.integers(0, 3000, n)).astype(np.int64)
        assert port_bfg.encode_unitig_colors(ids) == jax_bfg.encode_unitig_colors(ids)
    for seed in (0, 1, 0x9E3779B97F4A7C15):
        data = bytes(rng.integers(0, 256, 8, dtype=np.uint8))
        assert port_bfg.wyhash8(data, seed) == jax_bfg.wyhash8(data, seed)
    s = "ACGTTGCAAGGCTTAACCGGTACGT"
    assert port_bfg.kmer_head_bytes(s, 21) == jax_bfg.kmer_head_bytes(s, 21)


@pytest.fixture(scope="module")
def kmc_run(tmp_path_factory):
    """`pipeline` on the single_diploid reads, its count table rewritten
    as KMC1 and KMC2 databases by the port's writers."""
    from ploidyfrost_tpu_torch.cli import main

    d = tmp_path_factory.mktemp("torch_interop")
    cwd = os.getcwd()
    os.chdir(d)
    try:
        make_reads("reads.fa")
        assert main(["count", "-k", "25", "-o", "db", "reads.fa", "--device=cpu"]) == 0
        assert main(["build", "-k", "25", "-l", "10", "-h", "db.hist.txt", "-o", "graph",
                     "reads.fa", "--device=cpu"]) == 0
        z = np.load("db.kmers.npz")
        os.makedirs("kmc1")
        os.makedirs("kmc2")
        port_kmc.write_kmc_db("kmc1/db", z["kmers"], z["counts"], 25)
        port_kmc.write_kmc2_db("kmc2/db", z["kmers"], z["counts"], 25)
        yield str(d)
    finally:
        os.chdir(cwd)


@pytest.mark.parametrize("db", ["kmc1/db", "kmc2/db", "kmc1/db.kmc_pre"])
def test_run_on_kmc_database_gives_reference_tables(kmc_run, db):
    from ploidyfrost_tpu_torch.cli import main

    cwd = os.getcwd()
    os.chdir(kmc_run)
    try:
        pre = db.replace("/", "_").replace(".", "_")
        rc = main(["-g", "graph.gfa", "-d", db, "-o", pre, "-h", "db.hist.txt", "--device=cpu"])
        assert rc == 0
        for name in FILES:
            assert _read(os.path.join("PloidyFrost_output", f"{pre}_{name}.txt")) == _read(
                os.path.join(GOLD, f"gold_{name}.txt")
            ), name
    finally:
        os.chdir(cwd)


def test_load_count_db_rejects_wrong_k_and_missing(kmc_run):
    from ploidyfrost_tpu_torch.pipeline import load_count_db

    with pytest.raises(SystemExit, match="KMC database k=25 != graph k=21"):
        load_count_db(os.path.join(kmc_run, "kmc1", "db"), 21)
    with pytest.raises(SystemExit, match="correct kmc database path"):
        load_count_db(os.path.join(kmc_run, "nothing_here"), 25)

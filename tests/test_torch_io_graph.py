"""The port's readers, trimming, packed unitig store, emission fast path
and color codecs against the JAX package: the counterparts of
tests/test_native.py, tests/test_trim.py, tests/test_seqstore.py,
tests/test_fastpath.py and tests/test_colors.py.

Each case keeps the JAX test's own expectation and holds the port's
function to the JAX package's on the same seeded inputs. Every
comparison is exact (bytes, arrays, strings, dataclass fields) except
Cramér's V, a float64 formula, which agrees within 1e-12.
"""

import dataclasses
import gzip
import inspect
import io
import random

import numpy as np
import pytest

from ploidyfrost_tpu.io import fastx as jfastx
from ploidyfrost_tpu.io import trim as jtrim
from ploidyfrost_tpu_torch.io import fastx, trim
from ploidyfrost_tpu_torch.io.trim import PHRED_OFFSET, TrimConfig, trim_read
from ploidyfrost_tpu_torch.native import load_library
from test_torch_helpers import few_torch_threads  # noqa: F401  (autouse fixture)



@pytest.fixture
def native():
    """The port's native FASTX reader, built on first use; decided in
    the test, not when the module is imported."""
    if load_library() is None:
        pytest.skip("the port's native FASTX reader did not build")


# -- the FASTX reader (tests/test_native.py) ------------------------------------------


def _random_seq(rng, n):
    return "".join(rng.choice("ACGTacgtN") for _ in range(n))


def _write_fasta(path, seqs, wrap=None, gz=False):
    op = gzip.open if gz else open
    with op(path, "wt") as f:
        for i, s in enumerate(seqs):
            f.write(f">read{i} extra header\n")
            if wrap:
                for j in range(0, len(s), wrap):
                    f.write(s[j : j + wrap] + "\n")
                if not s:
                    f.write("\n")
            else:
                f.write(s + "\n")


def _write_fastq(path, seqs, gz=False):
    op = gzip.open if gz else open
    with op(path, "wt") as f:
        for i, s in enumerate(seqs):
            f.write(f"@read{i}\n{s}\n+\n{'I' * len(s)}\n")


def _collect(gen):
    return [b.copy() for b in gen]


def _assert_readers_same(paths, k, batch_reads=7, max_len=64, trim=None):
    """The port's native and Python readers and the JAX package's Python
    reader give the same batches; returns them."""
    a = _collect(fastx.read_batches_py(paths, k, batch_reads, max_len, trim=trim))
    b = _collect(fastx.read_batches_native(paths, k, batch_reads, max_len, trim=trim))
    c = _collect(jfastx.read_batches_py(paths, k, batch_reads, max_len,
                                        trim=None if trim is None else _jax_trim(trim)))
    assert len(a) == len(b) == len(c) > 0
    for x, y, z in zip(a, b, c):
        np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(x, z)
    return a


def _jax_trim(cfg):
    return jtrim.TrimConfig(**dataclasses.asdict(cfg))


def _fasta_case(tmp_path, gz):
    rng = random.Random(0)
    p = str(tmp_path / ("a.fa.gz" if gz else "a.fa"))
    _write_fasta(p, [_random_seq(rng, n) for n in (0, 3, 25, 26, 63, 64, 65, 200, 500)],
                 wrap=50, gz=gz)
    return [p], {}


def _fastq_case(tmp_path, gz):
    rng = random.Random(1)
    p = str(tmp_path / ("r.fq.gz" if gz else "r.fq"))
    _write_fastq(p, [_random_seq(rng, n) for n in (0, 10, 25, 64, 150, 151, 400)], gz=gz)
    return [p], {}


def _multifile_case(tmp_path, _):
    rng = random.Random(2)
    p1, p2 = str(tmp_path / "x.fa"), str(tmp_path / "y.fq")
    _write_fasta(p1, [_random_seq(rng, n) for n in (40, 80, 120)])
    _write_fastq(p2, [_random_seq(rng, n) for n in (30, 64, 99, 25)])
    # batch_reads=3 lands file boundaries mid-batch
    return [p1, p2], {"k": 11, "batch_reads": 3, "max_len": 48}


def _stale_rows_case(tmp_path, _):
    # a long read then short ones: row tails must be invalidated
    p = str(tmp_path / "s.fa")
    _write_fasta(p, ["A" * 64, "C" * 30, "G" * 30, "T" * 30, "A" * 30])
    return [p], {"batch_reads": 2}


def _empty_records_case(tmp_path, _):
    # 200k bare headers: the empty-record skip must not recurse
    p = str(tmp_path / "e.fa")
    with open(p, "w") as f:
        for i in range(200_000):
            f.write(f">e{i}\n")
        f.write(">real\nACGTACGTACGTACGTACGTACGTACGT\n")
    return [p], {}


def _multiline_fastq_case(tmp_path, _):
    p = str(tmp_path / "ml.fq")
    with open(p, "wb") as f:
        f.write(b"@r1\nACGTAC\nGTACGTAA\n+\nIIIIII\nIIIIIIII\n")
        f.write(b"@r0\n\n+\n\n")
        f.write(b"@r2\nACGTACGTACGTACGTACGTACGTACGTA\n+r2\nIIIIIIIIIIIIIIIIIIIIIIIIIIIII\n")
    return [p], {"k": 5}


@pytest.mark.parametrize("make,gz", [
    (_fasta_case, False), (_fasta_case, True), (_fastq_case, False), (_fastq_case, True),
    (_multifile_case, None), (_stale_rows_case, None), (_empty_records_case, None),
    (_multiline_fastq_case, None),
], ids=["fasta", "fasta-gz", "fastq", "fastq-gz", "multifile-boundary", "no-stale-rows",
        "many-empty-records", "multiline-fastq"])
def test_reader_parity(native, tmp_path, make, gz):
    paths, kw = make(tmp_path, gz)
    _assert_readers_same(paths, **{"k": 25, **kw})


def test_junk_between_fastq_records(native, tmp_path):
    """Junk lines between records are skipped, never taken as headers,
    by every reader alike; exactly the two real records survive."""
    p = str(tmp_path / "junk.fq")
    with open(p, "wb") as f:
        f.write(b"@r1\nACGTACGTACGT\n+\nIIIIIIIIIIII\n")
        f.write(b"junk line\n# another\n\n")
        f.write(b"@r2\nTTTTACGTACGT\n+\nIIIIIIIIIIII\n")
    (a,) = _assert_readers_same([p], 5, 4, 32)
    from ploidyfrost_tpu_torch.kmer.pack import INVALID_BASE

    assert (a[0] != INVALID_BASE).sum() == (a[1] != INVALID_BASE).sum() == 12
    assert (a[2:] == INVALID_BASE).all()


def test_truncated_gzip_errors(native, tmp_path):
    good = tmp_path / "g.fq.gz"
    _write_fastq(str(good), ["ACGT" * 100] * 50, gz=True)
    bad = tmp_path / "bad.fq.gz"
    bad.write_bytes(good.read_bytes()[: len(good.read_bytes()) // 2])
    with pytest.raises(Exception):
        _collect(fastx.read_batches_native([str(bad)], 25))


def test_missing_file(native):
    with pytest.raises(FileNotFoundError):
        _collect(fastx.read_batches_native(["/nonexistent/file.fa"], 25))


# -- trimming (tests/test_trim.py) --------------------------------------------------------


def q(*vals):
    return bytes(v + PHRED_OFFSET for v in vals)


@pytest.mark.parametrize("cfg,seq,qual,want", [
    (dict(leading=10, trailing=10, window=0, minlen=0), b"ACGTACGT",
     q(2, 5, 30, 30, 30, 30, 9, 3), b"GTAC"),
    (dict(leading=10, trailing=10, window=0, minlen=1), b"ACGT", q(2, 2, 2, 2), b""),
    # window 3, threshold 20: the first bad window starts at index 3 and
    # the cut runs through it
    (dict(leading=0, trailing=0, window=3, window_quality=20, minlen=0), b"AAAACCCC",
     q(30, 30, 30, 30, 2, 2, 2, 2), b"AAAA"),
    (dict(leading=0, trailing=0, window=3, window_quality=20, minlen=0), b"ACGTACGTAC",
     q(*[30] * 10), b"ACGTACGTAC"),
    (dict(leading=10, trailing=10, window=0, minlen=5), b"ACGTACGT",
     q(2, 5, 30, 30, 30, 30, 9, 3), b""),
    ({}, b"ACGT", None, b"ACGT"),  # FASTA passes through
], ids=["leading-trailing", "all-low-dropped", "window-cut", "window-keeps",
        "minlen-drops", "fasta-passthrough"])
def test_trim_read(cfg, seq, qual, want):
    got = trim_read(seq, qual, TrimConfig(**cfg))
    assert got == jtrim.trim_read(seq, qual, jtrim.TrimConfig(**cfg)) == want


@pytest.mark.parametrize("spec", ["LEADING:10,TRAILING:10,SLIDINGWINDOW:3:20,MINLEN:50",
                                  "LEADING:3,MINLEN:36", "SLIDINGWINDOW:5:30,TRAILING:25"])
def test_parse_spec_matches_jax(spec):
    cfg = TrimConfig.parse(spec)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jtrim.TrimConfig.parse(spec))
    if spec.startswith("LEADING:10"):
        assert cfg == TrimConfig()  # the defaults are the reference's arguments


def test_read_batches_trim_integration(tmp_path):
    """A good read survives untouched; a read whose low-quality tail
    leaves fewer than k bases gives an all-padding row."""
    k = 5
    good = bad = b"ACGTACGTACGTACGT"
    fq = tmp_path / "r.fq.gz"
    with gzip.open(fq, "wb") as f:
        f.write(b"@r1\n" + good + b"\n+\n" + q(*[30] * len(good)) + b"\n")
        f.write(b"@r2\n" + bad + b"\n+\n" + q(*([30] * 4 + [2] * 12)) + b"\n")
    cfg = TrimConfig(leading=10, trailing=10, window=0, minlen=k)
    batches = list(fastx.read_batches_py(str(fq), k, batch_reads=4, max_len=32, trim=cfg))
    want = list(jfastx.read_batches_py(str(fq), k, batch_reads=4, max_len=32,
                                       trim=_jax_trim(cfg)))
    assert len(batches) == len(want) == 1
    np.testing.assert_array_equal(batches[0], want[0])
    rows = batches[0]
    assert (rows[0] != 4).sum() == len(good)
    assert (rows[1] != 4).sum() == 0


def test_cli_trim_flag_parses():
    from ploidyfrost_tpu.cli import _extract_trim as jax_extract
    from ploidyfrost_tpu_torch.cli import _extract_trim

    for argv in (["-o", "x", "--trim", "r.fq"], ["--trim=LEADING:3,MINLEN:36"], ["r.fq"]):
        got, cfg = _extract_trim(argv)
        jgot, jcfg = jax_extract(argv)
        assert got == jgot
        assert (cfg is None) == (jcfg is None)
        if cfg is not None:
            assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    argv, cfg = _extract_trim(["-o", "x", "--trim", "r.fq"])
    assert argv == ["-o", "x", "r.fq"] and cfg == TrimConfig()
    _, cfg = _extract_trim(["--trim=LEADING:3,MINLEN:36"])
    assert cfg.leading == 3 and cfg.minlen == 36 and cfg.trailing == 10


@pytest.mark.parametrize("cfg", [TrimConfig(), TrimConfig(leading=20, trailing=25, window=5,
                                                          window_quality=30, minlen=20)],
                         ids=["reference", "strict"])
def test_native_trim_matches_python_and_jax(native, tmp_path, cfg):
    """The native reader's trimming gives the Python readers' batches.
    Qualities are mostly high with dips, so that every operator cuts
    some reads and most reads survive (uniform qualities leave a
    window below 20 in nearly every read, and MINLEN drops them all)."""
    rng = np.random.default_rng(9)
    p = tmp_path / "t.fq"
    with open(p, "w") as f:
        for i in range(400):
            n = int(rng.integers(30, 180))
            seq = "".join("ACGTN"[c] for c in rng.integers(0, 5, n))
            qual = np.where(rng.random(n) < 0.03, rng.integers(2, 12, n), rng.integers(25, 41, n))
            if i % 3 == 0:
                qual[: int(rng.integers(0, 8))] = 3  # bad leading
            if i % 4 == 0:
                qual[-int(rng.integers(1, 9)) :] = 4  # bad trailing
            f.write(f"@r{i}\n{seq}\n+\n" + "".join(chr(33 + int(x)) for x in qual) + "\n")
    untrimmed = _assert_readers_same([str(p)], 25, 16, 96)
    trimmed = _assert_readers_same([str(p)], 25, 16, 96, trim=cfg)
    kept = sum(int((b != 4).sum()) for b in trimmed)
    assert 0 < kept < sum(int((b != 4).sum()) for b in untrimmed)


def test_trim_batch_matches_jax():
    rng = np.random.default_rng(21)
    seqs, quals = [], []
    for _ in range(200):
        n = int(rng.integers(10, 120))
        seqs.append("".join("ACGT"[c] for c in rng.integers(0, 4, n)).encode())
        qual = np.where(rng.random(n) < 0.05, rng.integers(2, 12, n), rng.integers(25, 41, n))
        quals.append(bytes(int(x) + PHRED_OFFSET for x in qual))
    cfg = TrimConfig(leading=15, trailing=15, window=4, window_quality=25, minlen=30)
    got = [trim_read(s, qq, cfg) for s, qq in zip(seqs, quals)]
    want = [jtrim.trim_read(s, qq, _jax_trim(cfg)) for s, qq in zip(seqs, quals)]
    assert got == want
    assert any(g == b"" for g in got) and any(g and len(g) < len(s) for g, s in zip(got, seqs))
    pairs = list(zip(seqs, quals))
    assert trim.trim_batch(pairs, cfg) == jtrim.trim_batch(pairs, _jax_trim(cfg)) == \
        [g for g in got if g]


# -- the packed unitig store (tests/test_seqstore.py) ---------------------------------------


def _rand_seqs(seed, n, lo, hi):
    rng = random.Random(seed)
    return ["".join(rng.choice("ACGT") for _ in range(rng.randint(lo, hi))) for _ in range(n)]


def _stores(seqs):
    from ploidyfrost_tpu.graph.seqstore import SeqStore as JaxStore
    from ploidyfrost_tpu_torch.graph.seqstore import SeqStore

    return SeqStore.from_strings(seqs), JaxStore.from_strings(seqs)


def test_seqstore_roundtrip_decode():
    seqs = _rand_seqs(0, 50, 1, 200) + ["A", "ACGT" * 8, "C" * 32, "G" * 33]
    st, jst = _stores(seqs)
    assert st.decode_all() == seqs == jst.decode_all()
    for i in (0, 3, len(seqs) - 1):
        assert st.decode(i) == seqs[i]
    assert st.total_bases == jst.total_bases == sum(map(len, seqs))
    np.testing.assert_array_equal(st.words, jst.words)


@pytest.mark.parametrize("k", [11, 25, 31])
def test_seqstore_kmers_match_string_path_and_jax(k):
    from ploidyfrost_tpu_torch.kmer.pack import string_kmers_np

    seqs = _rand_seqs(k, 40, k, 300)
    st, jst = _stores(seqs)
    flat, nk = st.all_kmers(k)
    np.testing.assert_array_equal(flat, np.concatenate([string_kmers_np(s, k) for s in seqs]))
    np.testing.assert_array_equal(nk, [len(s) - k + 1 for s in seqs])
    jflat, jnk = jst.all_kmers(k)
    np.testing.assert_array_equal(flat, jflat)
    np.testing.assert_array_equal(nk, jnk)
    heads, tails = st.head_kmers(k), st.tail_kmers(k)
    np.testing.assert_array_equal(heads, [string_kmers_np(s, k)[0] for s in seqs])
    np.testing.assert_array_equal(tails, [string_kmers_np(s, k)[-1] for s in seqs])
    np.testing.assert_array_equal(heads, jst.head_kmers(k))
    np.testing.assert_array_equal(tails, jst.tail_kmers(k))


def test_seqstore_reorder():
    seqs = _rand_seqs(3, 20, 5, 100)
    st, jst = _stores(seqs)
    perm = np.random.default_rng(0).permutation(len(seqs))
    assert st.reorder(perm).decode_all() == [seqs[p] for p in perm] == \
        jst.reorder(perm).decode_all()


def test_adjacency_matches_dict_build_and_jax():
    """The port's vectorized adjacency equals a brute-force dict build
    and the JAX package's, on one graph built by each package."""
    from ploidyfrost_tpu.graph.construct import build_graph_from_kmers as jax_build
    from ploidyfrost_tpu_torch.graph.cdbg import revcomp
    from ploidyfrost_tpu_torch.graph.construct import build_graph_from_kmers
    from ploidyfrost_tpu_torch.kmer.pack import string_kmers_np

    k = 7
    rng = random.Random(4)
    genome = "".join(rng.choice("ACGT") for _ in range(800))
    kms = sorted({min(genome[i : i + k], revcomp(genome[i : i + k]))
                  for i in range(len(genome) - k + 1)})
    packed = np.sort(np.array([string_kmers_np(s, k)[0] for s in kms], dtype=np.uint64))
    g, jg = build_graph_from_kmers(packed, k), jax_build(packed, k)
    seqs = list(g.store.decode_all())
    assert seqs == list(jg.store.decode_all())
    entry = {}
    for i, s in enumerate(seqs):
        entry.setdefault(s[:k], (i, True))
        entry.setdefault(revcomp(s[-k:]), (i, False))
    succ = np.full((len(seqs), 2, 4), -1, dtype=np.int64)
    for i, s in enumerate(seqs):
        for strand, oriented in ((True, s), (False, revcomp(s))):
            for bi, b in enumerate("ACGT"):
                hit = entry.get(oriented[-(k - 1):] + b)
                if hit is not None:
                    succ[i, int(strand), bi] = hit[0] * 2 + int(hit[1])
    np.testing.assert_array_equal(g._succ, succ)
    np.testing.assert_array_equal(g._succ, jg._succ)


def test_native_kmers_at_matches_numpy(monkeypatch):
    """The threaded native extraction equals the numpy word-gather path
    above the batch threshold, and the JAX package's store."""
    import ploidyfrost_tpu_torch.native as N

    rng = np.random.default_rng(12)
    seqs = ["".join(rng.choice(list("ACGT"), int(rng.integers(25, 300)))) for _ in range(400)]
    st, jst = _stores(seqs)
    for k in (25, 31):
        pos = np.flatnonzero(st.kmer_start_mask(k))
        np.testing.assert_array_equal(pos, np.flatnonzero(jst.kmer_start_mask(k)))
        big = np.tile(pos, max(1, (1 << 15) // max(len(pos), 1) + 1))
        fast = st.kmers_at(big, k)
        monkeypatch.setenv("PLOIDYFROST_NO_NATIVE", "1")
        saved = dict(N._lookup_state)
        N._lookup_state.clear()
        try:
            ref = st.kmers_at(big, k)
        finally:
            N._lookup_state.clear()
            N._lookup_state.update(saved)
            monkeypatch.delenv("PLOIDYFROST_NO_NATIVE")
        np.testing.assert_array_equal(fast, ref)
        np.testing.assert_array_equal(fast, jst.kmers_at(big, k))


# -- the emission fast path (tests/test_fastpath.py) ----------------------------------------

BASES = "ACGT"


def _rand_job(rng, strict, job_cls, k=25):
    L = int(rng.integers(k + 4, 4 * k))
    a = "".join(rng.choice(list(BASES), L))
    b = list(a)
    nmut = min(int(rng.integers(0, 3)), L - k)
    if nmut:
        for p in rng.choice(np.arange(k - 1, L - 1), size=nmut, replace=False):
            b[int(p)] = BASES[int(rng.integers(0, 4))]
    covs = [float(rng.integers(10, 60)), float(rng.integers(10, 60))] if strict else None
    return job_cls([a, "".join(b)], int(rng.integers(1, 1000)), strict, 3, 7,
                   int(rng.integers(1, 50)), int(rng.integers(1, 50)),
                   float(rng.integers(10, 60)), covs)


def _plain(x):
    """A dataclass tree as plain Python values (numpy arrays as lists)."""
    if dataclasses.is_dataclass(x):
        return tuple(_plain(getattr(x, f.name)) for f in dataclasses.fields(x))
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, np.ndarray):
        return x.tolist()
    return x


@pytest.mark.parametrize("strict", [True, False])
def test_fast_matches_generic_and_jax(strict):
    """The fast path's rows equal the generic path's, and the JAX
    package's fast path on the same jobs."""
    from ploidyfrost_tpu.sites import emit as jemit
    from ploidyfrost_tpu_torch.align.msa import SeqAlign
    from ploidyfrost_tpu_torch.sites.emit import (_AlignJob, _emit_fast, _emit_generic,
                                                  _fast_snp_positions)

    rng = np.random.default_rng(42 if strict else 43)
    sa = SeqAlign(2.0, -1.0, -3.0)
    n_fast = 0
    for _ in range(300):
        state = rng.bit_generator.state
        job = _rand_job(rng, strict, _AlignJob)
        rng2 = np.random.default_rng()
        rng2.bit_generator.state = state
        jjob = _rand_job(rng2, strict, jemit._AlignJob)
        fsnp = _fast_snp_positions(job)
        jf = jemit._fast_snp_positions(jjob)
        assert (fsnp is None) == (jf is None)
        if fsnp is None:
            continue
        np.testing.assert_array_equal(fsnp, jf)
        n_fast += 1
        wf, wg, wj = [], [], []
        be_f = _emit_fast(job, fsnp, 25, wf)
        be_g = _emit_generic(job, sa, 25, wg, var_id=job.var_id)
        be_j = jemit._emit_fast(jjob, jf, 25, wj)
        assert _plain(be_f) == _plain(be_g) == _plain(be_j)
        assert wf == wg == wj
    assert n_fast > 100  # the gate admits the dominant population


def test_gate_rejects_unequal_and_dense():
    from ploidyfrost_tpu.sites import emit as jemit
    from ploidyfrost_tpu_torch.sites.emit import _AlignJob, _fast_snp_positions

    rng = np.random.default_rng(7)
    a = "".join(rng.choice(list(BASES), 60))
    job = _rand_job(rng, True, _AlignJob)
    dense = list(a)
    for p in range(0, 60, 6):
        dense[p] = BASES[(BASES.index(dense[p]) + 1) % 4]
    for sv in ([a, a[:-1]], [a, "".join(dense)], [a, a, a]):
        job.str_vec = sv
        assert _fast_snp_positions(job) is None
        assert jemit._fast_snp_positions(dataclasses.replace(job)) is None


def test_gate_requires_default_scoring():
    """analyze_bubbles enables the fast path only for (2, -1, -3)."""
    from ploidyfrost_tpu_torch.sites import emit

    assert "(2.0, -1.0, -3.0)" in inspect.getsource(emit.analyze_bubbles)


def test_gapless_msa_matches_generic_and_jax():
    from ploidyfrost_tpu.align.msa import SeqAlign as JaxAlign
    from ploidyfrost_tpu_torch.align.msa import SeqAlign
    from ploidyfrost_tpu_torch.sites.emit import _gapless_eligible

    sa, ja = SeqAlign(2.0, -1.0, -3.0), JaxAlign(2.0, -1.0, -3.0)
    rng = np.random.default_rng(23)
    n_checked = 0
    while n_checked < 120:
        L = int(rng.integers(26, 90))
        base = "".join(rng.choice(list(BASES), L))
        nb = int(rng.integers(3, 6))
        pos, pos2 = int(rng.integers(0, L)), int(rng.integers(0, L))
        strs = []
        for b in range(nb):
            s = list(base)
            s[pos if b % 2 == 0 else pos2] = "ACGT"[int(rng.integers(0, 4))]
            strs.append("".join(s))
        strs = sorted(set(strs), key=lambda x: (-len(x), x))
        if len(strs) < 3 or not _gapless_eligible(strs):
            continue
        n_checked += 1
        a = sa.sequence_alignment_gapless(list(strs))
        b = sa.sequence_alignment(list(strs))
        assert a[0] == b[0] and a[1] == b[1] and a[2] == b[2] and a[3] == b[3] and a[4] == b[4]
        assert _plain(list(a)) == _plain(list(ja.sequence_alignment_gapless(list(strs))))


def test_batch_fast_check_matches_scalar_and_jax():
    from ploidyfrost_tpu.sites import emit as jemit
    from ploidyfrost_tpu_torch.sites.emit import (_AlignJob, _fast_snp_positions,
                                                  _fast_snp_positions_batch)

    rng = np.random.default_rng(4)
    jobs = []
    for _ in range(300):
        L = int(rng.integers(25, 120))
        a = "".join(rng.choice(list(BASES), L))
        kind = rng.integers(0, 5)
        if kind == 0:
            sv = [a, a]
        elif kind == 1:
            b = list(a)
            for p in rng.integers(0, L, int(rng.integers(1, 3))):
                b[p] = BASES[(BASES.index(b[p]) + 1) % 4]
            sv = [a, "".join(b)]
        elif kind == 2:
            sv = [a, "".join(rng.choice(list(BASES), L))]
        elif kind == 3:
            sv = [a, a[:-1]]
        else:
            sv = [a, a, a]
        jobs.append(_AlignJob(sv, 0, True, 1, 2, 10, 10, 1.0, None))
    batch = _fast_snp_positions_batch(jobs)
    jbatch = jemit._fast_snp_positions_batch(
        [jemit._AlignJob(j.str_vec, 0, True, 1, 2, 10, 10, 1.0, None) for j in jobs])
    for j, got, jgot in zip(jobs, batch, jbatch):
        exp = _fast_snp_positions(j)
        assert (exp is None) == (got is None) == (jgot is None)
        if exp is not None:
            np.testing.assert_array_equal(np.asarray(got), exp)
            np.testing.assert_array_equal(np.asarray(got), np.asarray(jgot))


def _colored_dataset(pkg):
    """Three samples of one 60 kb genome, as tests/test_fastpath.py makes
    them, through `pkg`'s graph, colors, search and coverage."""
    import importlib

    def mod(name):
        return importlib.import_module(f"{pkg}.{name}")

    pack = mod("kmer.pack")
    rng = np.random.default_rng(17)
    G = 60_000
    base = rng.integers(0, 4, G).astype(np.uint8)
    filtered, dbs, cutoffs = [], [], []
    for _ in range(3):
        h2 = base.copy()
        snp = rng.random(G) < 0.004
        h2[snp] = (h2[snp] + rng.integers(1, 4, snp.sum())) % 4
        k1, _ = pack.sequence_kmers_np(base, 25)
        k2, _ = pack.sequence_kmers_np(h2, 25)
        km, mult = np.unique(pack.canonical_np(np.concatenate([k1, k2]), 25),
                             return_counts=True)
        ct = (mult * 15 + rng.integers(0, 4, len(km))).astype(np.int64)
        filtered.append(km[ct >= 10])
        dbs.append(mod("kmer.countdb").KmerCountDB(km, ct, 25))
        cutoffs.append((10, 60))
    construct = mod("graph.construct")
    g = construct.simplify(construct.build_graph_from_kmers(
        np.unique(np.concatenate(filtered)), 25), 25)
    colors = mod("graph.colors").color_graph(g, filtered, ["a", "b", "c"])
    umean, uok = mod("sites.emit_colored").unitig_coverage_colored(dbs, g, cutoffs)
    return g, colors, umean, uok


def _colored_run(pkg, g, colors, umean, uok):
    import importlib

    batched = importlib.import_module(f"{pkg}.bubble.batched")
    emit_colored = importlib.import_module(f"{pkg}.sites.emit_colored")
    if pkg == "ploidyfrost_tpu":
        state, _ = batched.find_superbubbles_device(g, 8, colors)
        return emit_colored.analyze_bubbles_colored(g, colors, state, umean, uok)
    state, _ = batched.find_superbubbles_device(g, 8, colors, device="cpu")
    return emit_colored.analyze_bubbles_colored(g, colors, state, umean, uok, device="cpu")


def test_colored_fast_matches_generic_and_jax(monkeypatch):
    """On a 3-sample set where 2-branch SNP bubbles dominate, the
    colored fast path emits what the generic path (alignment and
    partition) emits, and what the JAX package emits."""
    from ploidyfrost_tpu_torch.sites import emit as emit_mod

    data = _colored_dataset("ploidyfrost_tpu_torch")
    fast = _colored_run("ploidyfrost_tpu_torch", *data)
    jax_fast = _colored_run("ploidyfrost_tpu", *_colored_dataset("ploidyfrost_tpu"))
    monkeypatch.setattr(emit_mod, "_fast_snp_positions_batch", lambda jobs: [None] * len(jobs))
    monkeypatch.setattr(emit_mod, "_gapless_eligible", lambda sv: False)
    generic = _colored_run("ploidyfrost_tpu_torch", *data)
    em_f, ws_f, wc_f = fast
    assert len(em_f) > 50
    assert sum(len(e.sites) for e in em_f) > 30
    for other in (generic, jax_fast):
        em_o, ws_o, wc_o = other
        assert ws_f == ws_o
        assert set(wc_f) == set(wc_o)
        for w in wc_f:
            np.testing.assert_array_equal(wc_f[w], wc_o[w])
        assert _plain(em_f) == _plain(em_o)


# -- colors (tests/test_colors.py) --------------------------------------------------------------


def test_wyhash_vectors():
    from ploidyfrost_tpu.io.bfg import wyhash8 as jax_wyhash8
    from ploidyfrost_tpu_torch.io.bfg import wyhash8

    d = bytes([1, 2, 3, 4, 250, 251, 252, 253])
    assert wyhash8(d, 0) == jax_wyhash8(d, 0) == 8647445012313848284
    assert wyhash8(d, 0x123456789ABCDEF) == jax_wyhash8(d, 0x123456789ABCDEF) == \
        5688032836064490754
    rng = np.random.default_rng(3)
    for _ in range(50):
        data = rng.integers(0, 256, 8, dtype=np.uint8).tobytes()
        seed = int(rng.integers(0, 1 << 63))
        assert wyhash8(data, seed) == jax_wyhash8(data, seed)


@pytest.mark.parametrize("case", ["empty", "one", "sparse", "random", "bitset"])
def test_roaring_roundtrip_and_bytes(case):
    from ploidyfrost_tpu.io.bfg import roaring_serialize as jax_serialize
    from ploidyfrost_tpu_torch.io.bfg import roaring_deserialize, roaring_serialize

    rng = np.random.default_rng(0)
    vals = {
        "empty": np.array([], dtype=np.uint32),
        "one": np.array([0], dtype=np.uint32),
        "sparse": np.array([5, 70000, 70001, 1 << 30], dtype=np.uint32),
        "random": rng.integers(0, 1 << 20, 10_000).astype(np.uint32),
        # more than 4096 values in one 16-bit block: a bitset container
        "bitset": np.arange(100, 5000, dtype=np.uint32),
    }[case]
    vals = np.unique(vals)
    blob = roaring_serialize(vals)
    assert blob == jax_serialize(vals)
    np.testing.assert_array_equal(roaring_deserialize(blob), vals)


@pytest.mark.parametrize("ck", [[], [3], [0, 1, 60], [0, 61, 1000], [123456]],
                         ids=["empty", "one", "bitvector", "roaring", "single-int"])
def test_unitig_colors_roundtrip_and_bytes(ck):
    from ploidyfrost_tpu.io.bfg import encode_unitig_colors as jax_encode
    from ploidyfrost_tpu_torch.io.bfg import _decode_uc, encode_unitig_colors

    ck = np.array(ck, dtype=np.uint64)
    blob = encode_unitig_colors(ck)
    assert blob == jax_encode(ck)
    got, full = _decode_uc(io.BytesIO(blob))
    np.testing.assert_array_equal(got, ck)
    assert len(full) == 0


def test_color_matrix_ops():
    from ploidyfrost_tpu.graph.colors import ColorMatrix as JaxMatrix
    from ploidyfrost_tpu_torch.graph.colors import ColorMatrix

    offsets = np.array([0, 3, 5])
    bits = np.array([[1, 0], [1, 1], [1, 0], [0, 1], [0, 1]], dtype=bool)
    cm, jm = ColorMatrix(offsets, bits, ["a", "b"]), JaxMatrix(offsets, bits, ["a", "b"])
    assert cm.n_colors == jm.n_colors == 2
    assert cm.contains_all(0, 0) and not cm.contains_all(0, 1)
    assert cm.size(0) == 4 and cm.size(1) == 2
    assert list(cm.full_colors(1)) == [False, True]
    assert cm.contains_at(0, 1, 1) and not cm.contains_at(0, 0, 1)
    assert cm.size_as(0, 100) == 4  # no full/partial split: the other length is ignored
    for u in (0, 1):
        assert cm.size(u) == jm.size(u) and cm.size_as(u, 7) == jm.size_as(u, 7)
        assert list(cm.full_colors(u)) == list(jm.full_colors(u))
        for c in (0, 1):
            assert cm.contains_all(u, c) == jm.contains_all(u, c)
            for p in range(2):
                assert cm.contains_at(u, c, p) == jm.contains_at(u, c, p)
    full = np.array([1, 0])
    cm2, jm2 = ColorMatrix(offsets, bits, ["a", "b"], full), JaxMatrix(offsets, bits,
                                                                        ["a", "b"], full)
    # one full color over 3 k-mers and one partial pair, other length 5:
    # 1 * 5 + (4 - 1 * 3) = 6
    assert cm2.size_as(0, 5) == jm2.size_as(0, 5) == 6


def test_cramer_v_reference_semantics():
    """The reference's guards (src/CCDBG.cpp:348) and std::max's NaN
    rule, and the JAX package's values within 1e-12 on seeded tables."""
    from ploidyfrost_tpu.sites.emit_colored import cramer_v as jax_v, max_cramer as jax_max
    from ploidyfrost_tpu_torch.sites.emit_colored import cramer_v, max_cramer

    assert cramer_v([1.0, 0.0], [2.0, 0.0]) == 0.0
    assert abs(cramer_v([10.0, 0.0], [0.0, 10.0]) - 1.0) < 1e-12
    assert abs(cramer_v([5.0, 5.0], [5.0, 5.0])) < 1e-12
    assert np.isfinite(max_cramer(np.array([[1.0, 1.0], [0.0, 0.0], [0.0, 10.0]])))
    rng = np.random.default_rng(31)
    for _ in range(200):
        n = int(rng.integers(2, 5))
        a, b = rng.integers(0, 40, n).astype(float), rng.integers(0, 40, n).astype(float)
        assert abs(cramer_v(list(a), list(b)) - jax_v(list(a), list(b))) <= 1e-12
        m = rng.integers(0, 30, (int(rng.integers(2, 5)), n)).astype(float)
        x, y = max_cramer(m), jax_max(m)
        assert (np.isnan(x) and np.isnan(y)) or abs(x - y) <= 1e-12


def test_kmer_head_bytes_layout():
    from ploidyfrost_tpu.io.bfg import kmer_head_bytes as jax_head
    from ploidyfrost_tpu_torch.io.bfg import kmer_head_bytes

    # base 0 in the two most significant bits (Kmer.cpp:92-107)
    b = kmer_head_bytes("T" + "A" * 24, 25)
    assert int.from_bytes(b, "little") >> 62 == 3
    b2 = kmer_head_bytes("A" * 24 + "C", 25)
    assert (int.from_bytes(b2, "little") >> (64 - 50)) & 3 == 1
    rng = np.random.default_rng(5)
    for k in (21, 25, 31):
        for _ in range(20):
            s = "".join(rng.choice(list("ACGT"), k))
            assert kmer_head_bytes(s, k) == jax_head(s, k)

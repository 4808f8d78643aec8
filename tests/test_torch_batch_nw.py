"""The port's torch NW wavefront (device="cpu") against the host
wavefront, the scalar oracle and the JAX package's device wavefront, bit
for bit; and the engine order of needleman_wunsch_batch."""

import random

import numpy as np
import pytest

from ploidyfrost_tpu.align import batch_nw as jax_batch_nw
from ploidyfrost_tpu_torch.align import batch_nw, nw
from ploidyfrost_tpu_torch.align.batch_nw import (
    ENGINE_CALLS,
    needleman_wunsch_batch,
    nw_matrices_batched,
    wavefront_packed,
)
from ploidyfrost_tpu_torch.align.nw import _nw_matrix, _nw_matrix_scalar, needleman_wunsch
from test_torch_helpers import few_torch_threads  # noqa: F401  (autouse fixture)


def _rand_seq(rng, lo, hi, dash=False):
    alpha = "ACGT-" if dash else "ACGT"
    return "".join(rng.choice(alpha) for _ in range(rng.randint(lo, hi)))


def _assert_same(got, exp, ctx):
    for name, gm, em in zip(("Up", "LeftUp", "Left"), got, exp):
        assert gm.dtype == np.uint8 and gm.shape == em.shape, ctx
        np.testing.assert_array_equal(gm, em, err_msg=f"{name} differs: {ctx}")


def _mixed_pairs(seed):
    rng = random.Random(seed)
    pairs = [(_rand_seq(rng, 1, 90), _rand_seq(rng, 1, 90)) for _ in range(40)]
    # mixed sizes force several tiers in one call
    pairs.append((_rand_seq(rng, 300, 400), _rand_seq(rng, 280, 420)))
    return pairs


@pytest.fixture
def no_native_nw(monkeypatch):
    """The native flag kernel made unavailable, as on a host without a
    C++ toolchain."""
    monkeypatch.setattr(nw, "nw_matrices_native", lambda *a, **k: None)


@pytest.fixture
def engine_calls():
    before = dict(ENGINE_CALLS)
    yield lambda: {k: ENGINE_CALLS[k] - before[k] for k in before}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_matrices_match_host_wavefront(seed):
    pairs = _mixed_pairs(seed)
    got = nw_matrices_batched(pairs, 2.0, -1.0, -3.0, device="cpu")
    for i, (A, B) in enumerate(pairs):
        _assert_same(got[i], _nw_matrix(A, B, 2.0, -1.0, -3.0), f"pair {i}: {A} / {B}")


def test_matrices_with_dashes_match_scalar_oracle():
    """The forbidden-Left rule only fires when A contains '-' (the
    progressive MSA path, src/SeqAlign.cpp:528-532)."""
    rng = random.Random(3)
    pairs = [(_rand_seq(rng, 2, 40, dash=True), _rand_seq(rng, 2, 40)) for _ in range(30)]
    got = nw_matrices_batched(pairs, 2.0, -1.0, -3.0, device="cpu")
    for i, (A, B) in enumerate(pairs):
        _assert_same(got[i], _nw_matrix_scalar(A, B, 2.0, -1.0, -3.0), f"pair {i}: {A} / {B}")


@pytest.mark.parametrize("seed,scoring,longest", [(0, (2.0, -1.0, -3.0), 400),
                                                  (5, (1.0, -2.0, -1.0), 100),
                                                  (6, (3.0, 0.0, -2.0), 30)])
def test_matrices_equal_the_jax_package(seed, scoring, longest):
    """The same pairs (with dashes, several tiers, up to 512 in the
    first case) through the JAX package's device wavefront and the
    port's."""
    rng = random.Random(seed)
    pairs = [p for p in _mixed_pairs(seed) if max(map(len, p)) <= longest]
    pairs += [(_rand_seq(rng, 2, 60, dash=True), _rand_seq(rng, 2, 60)) for _ in range(20)]
    pairs += [("A", "A"), ("-", "C"), ("ACGT" * 4, "ACGT" * 4), ("A" * 17, "C")]
    got = nw_matrices_batched(pairs, *scoring, device="cpu")
    ref = jax_batch_nw.nw_matrices_batched(pairs, *scoring)
    assert len(got) == len(ref) == len(pairs)
    for i, (A, B) in enumerate(pairs):
        _assert_same(got[i], ref[i], f"pair {i}: {A} / {B}")


@pytest.mark.parametrize("tier", [16, 32])
def test_packed_flags_equal_the_jax_package(tier):
    """Before the de-skew: the [CH, 3, 2T+1, W8] bit-packed tensor of a
    whole chunk, pad lanes and the cells outside each pair's region
    included."""
    import jax.numpy as jnp

    rng = random.Random(tier)
    CH = jax_batch_nw._chunk_of(tier)
    assert CH == batch_nw._chunk_of(tier)
    n = 37
    a = [_rand_seq(rng, tier // 2 + 1, tier, dash=True) for _ in range(n)] + ["A"] * (CH - n)
    b = [_rand_seq(rng, 1, tier) for _ in range(n)] + ["A"] * (CH - n)
    kern = jax_batch_nw._build_kernel(tier, CH, 2, -1, -3)
    ref = np.asarray(kern(
        jnp.asarray(jax_batch_nw._encode(a, tier)),
        jnp.asarray(jax_batch_nw._encode(b, tier)),
        jnp.asarray(np.array([[len(s)] for s in a], dtype=np.int32)),
    ))
    got = wavefront_packed(a, b, tier, 2, -1, -3, "cpu")
    assert got.dtype == np.uint8 and got.shape == ref.shape == (CH, 3, 2 * tier + 1, (tier + 9) // 8)
    np.testing.assert_array_equal(got, ref)


def test_tiers_and_chunks_equal_the_jax_package():
    for m, n in [(1, 1), (16, 3), (17, 2), (90, 400), (2048, 1), (2049, 5)]:
        assert batch_nw._tier_of(m, n) == jax_batch_nw._tier_of(m, n)
    for tier in (16, 32, 64, 128, 256, 512, 1024, 2048):
        assert batch_nw._chunk_of(tier) == jax_batch_nw._chunk_of(tier)
    assert batch_nw._MAX_TIER == jax_batch_nw._MAX_TIER


def test_pair_above_the_largest_tier_goes_to_the_host(monkeypatch):
    monkeypatch.setattr(batch_nw, "_MAX_TIER", 32)
    rng = random.Random(9)
    pairs = [(_rand_seq(rng, 40, 50), _rand_seq(rng, 40, 50)), ("ACGT", "AGT")]
    got = nw_matrices_batched(pairs, 2.0, -1.0, -3.0, device="cpu")
    for (A, B), g in zip(pairs, got):
        _assert_same(g, _nw_matrix(A, B, 2.0, -1.0, -3.0), f"{A} / {B}")


def _mutated_pairs():
    rng = random.Random(4)
    pairs = []
    for _ in range(25):
        base = _rand_seq(rng, 20, 60)
        mut = list(base)
        for _ in range(rng.randint(0, 4)):
            p = rng.randrange(len(mut))
            op = rng.random()
            if op < 0.5:
                mut[p] = rng.choice("ACGT")
            elif op < 0.75:
                mut.insert(p, rng.choice("ACGT"))
            else:
                del mut[p]
        pairs.append((base, "".join(mut) or "A"))
    return pairs


def _assert_alignments_match_sequential(pairs, batched):
    for i, (A, B) in enumerate(pairs):
        exp = needleman_wunsch(A, B)
        got = batched[i]
        assert len(got) == len(exp), f"pair {i}"
        for g, e in zip(got, exp):
            assert (g.str1, g.str2, g.score, g.pos, g.indel, g.snp) == (
                e.str1, e.str2, e.score, e.pos, e.indel, e.snp), f"pair {i}"


def test_alignments_match_sequential(engine_calls):
    """Native first, also when a device is given."""
    pairs = _mutated_pairs()
    _assert_alignments_match_sequential(pairs, needleman_wunsch_batch(pairs, device="cpu"))
    if nw.nw_matrices_native([("A", "A")], 2.0, -1.0, -3.0) is not None:
        assert engine_calls() == {"native": 1, "device": 0, "numpy": 0}


def test_device_engine_when_native_is_missing(no_native_nw, engine_calls):
    pairs = _mutated_pairs()
    _assert_alignments_match_sequential(pairs, needleman_wunsch_batch(pairs, device="cpu"))
    assert engine_calls() == {"native": 0, "device": 1, "numpy": 0}


def test_numpy_engine_without_native_and_device(no_native_nw, engine_calls):
    pairs = _mutated_pairs()
    _assert_alignments_match_sequential(pairs, needleman_wunsch_batch(pairs))
    assert engine_calls() == {"native": 0, "device": 0, "numpy": 1}


def test_non_integer_params_fall_back(engine_calls):
    pairs = [("ACGT", "AGGT")]
    got = needleman_wunsch_batch(pairs, match=1.5, dis_match=-1.0, gap=-3.0, device="cpu")
    exp = needleman_wunsch("ACGT", "AGGT", 1.5, -1.0, -3.0)
    assert len(got[0]) == len(exp)
    assert got[0][0].str1 == exp[0].str1
    assert engine_calls() == {"native": 0, "device": 0, "numpy": 1}
    with pytest.raises(ValueError, match="integer scoring"):
        nw_matrices_batched(pairs, 1.5, -1.0, -3.0, device="cpu")


def _indel_rich_reads(path):
    """A 40 kb diploid whose second haplotype carries 80 short indels,
    150 bp reads, 14 passes a haplotype: enough gapped bubbles for the
    analysis to align them in one batch."""
    rng = np.random.default_rng(11)
    G = 40_000
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    h1 = bases[rng.integers(0, 4, G)].tobytes().decode()
    h2 = list(h1)
    for pos in sorted(rng.integers(500, G - 500, 80), reverse=True):
        if rng.random() < 0.5:
            h2[pos:pos] = ["ACGT"[rng.integers(0, 4)] for _ in range(rng.integers(1, 5))]
        else:
            del h2[pos : pos + int(rng.integers(1, 5))]
    with open(path, "w") as f:
        n = 0
        for hap in (h1, "".join(h2)):
            for _ in range(14):
                for s in rng.integers(0, len(hap) - 150, len(hap) // 150):
                    n += 1
                    f.write(f">r{n}\n{hap[s:s+150]}\n")


def test_analysis_hands_its_device_to_the_wavefront(engine_calls, tmp_path, monkeypatch):
    """`run` with the native kernel missing: the analysis passes its
    device on, the torch wavefront produces the matrices, and the tables
    are those of the run with the native kernel."""
    from ploidyfrost_tpu_torch.cli import main
    from test_golden import FILES

    monkeypatch.chdir(tmp_path)
    _indel_rich_reads("reads.fa")
    assert main(["pipeline", "-o", "p", "reads.fa", "--device=cpu"]) == 0
    if nw.nw_matrices_native([("A", "A")], 2.0, -1.0, -3.0) is not None:
        assert engine_calls() == {"native": 1, "device": 0, "numpy": 0}
    before = engine_calls()
    monkeypatch.setattr(nw, "nw_matrices_native", lambda *a, **k: None)
    assert main(["-g", "p.gfa", "-d", "p.kmers.npz", "-o", "q", "-h", "p.hist.txt",
                 "--device=cpu"]) == 0
    after = engine_calls()
    assert (after["device"] - before["device"], after["numpy"] - before["numpy"]) == (1, 0)
    for name in FILES:
        if name == "Unitig_Id":
            continue
        with open(f"PloidyFrost_output/p_{name}.txt", "rb") as f1, \
                open(f"PloidyFrost_output/q_{name}.txt", "rb") as f2:
            data = f1.read()
            assert data == f2.read(), name
    assert data  # allele frequencies were written

"""The NW wavefront kernel's two paths (csrc/nw_wavefront.cu), emulated
in numpy on the CPU, against the port's plain version and the JAX package;
and the dispatchers of both new kernels, which send CUDA tensors to the
kernels and never to the plain versions.

The register path (tiers up to 512): one warp a pair, lane l owning the
contiguous cells l k .. l k + k - 1 (k = ceil((T + 1) / 32) rounded up to
1, 2, 3, 5, 9 or 17); a cell's score on diagonals d - 1 and d - 2 kept
plus each of its flag bits, and its a and b codes, in registers; cell
i - 1 of a run's first cell and the b code that enters the run shuffled
up from lane l - 1, lane 0 reading b at clip(d - 1, 0, T - 1); each
cell's three flags staged as one byte, rows of 8 W8 cells end to end,
then packed 8 cells to a byte by a multiply. The shared-memory path
(tiers 1024 and 2048): lane l computing the cells i = 32 c + l of each
anti-diagonal, chunk c after chunk; the scores of three diagonals and
their flag rows as 32-bit words (a ballot: bit l of word c for cell
32 c + l) in rotation; each diagonal's three rows written as the words'
little-endian bytes. Each
must give the whole [CH, 3, 2T+1, W8] buffer of `_wavefront` and of the
JAX package's `_build_kernel`, byte for byte: tiers 16, 32 and 64 (W8 3, 5
and 9: never a multiple of 4; k 1, 2 and 3), 128, 256 and 512 (k 5, 9 and
17, the largest on the register path) and 1024 (the shared-memory path),
with dashes in A, an empty A (a_len 0), rows of full length and odd
chunks.
"""

import random

import numpy as np
import pytest
import torch

from ploidyfrost_tpu.align import batch_nw as jax_batch_nw
from ploidyfrost_tpu_torch.align import batch_nw
from ploidyfrost_tpu_torch.model import gmm
from test_torch_helpers import few_torch_threads  # noqa: F401  (autouse fixture)

DASH, PAD = 4, 7
I32MIN = np.int32(-(2**31))
REGISTER_K = (1, 2, 3, 5, 9, 17)  # the register path's template widths


def k_of(T):
    """Cells a lane on the register path at tier T, or 0 for the
    shared-memory path."""
    need = -(-(T + 1) // 32)
    return next((k for k in REGISTER_K if need <= k), 0)


def emulated_kernel(a, b, a_len, match, dis, gap):
    """The kernel's result for a, b [CH, T] uint8 and a_len [CH, 1]: the
    register path where k_of(T) is not 0, else the shared-memory path."""
    return (emulated_registers if k_of(a.shape[1]) else emulated_shared)(a, b, a_len, match, dis,
                                                                         gap)


def _shfl_up(x):
    """__shfl_up_sync by one over the lanes (axis 1): lane 0 keeps its own."""
    return np.concatenate([x[:, :1], x[:, :-1]], axis=1)


def emulated_registers(a, b, a_len, match, dis, gap):
    """The register path, vectorised over the pairs (the warps) and the 32
    lanes, a lane's K cells in turn."""
    CH, T = a.shape
    K = k_of(T)
    W8, D = (T + 9) // 8, 2 * T + 1
    C = 8 * W8  # staged cells a row: the rows run on without a gap
    i32 = np.int32
    cell = np.arange(32)[:, None] * K + np.arange(K)[None, :]  # [32, K]: lane l's cells
    ax = np.full((CH, 32 * K + 2), PAD, np.uint8)
    ax[:, 1 : T + 1] = a  # ax[:, i] = A[i - 1], PAD past T
    ac = ax[:, cell].astype(i32)
    forbid = (cell[None] != a_len[:, :, None]) & (ax[:, cell + 1] == DASH)
    bc = np.repeat(b[:, :1].astype(i32), 32 * K, 1).reshape(CH, 32, K)
    # a cell's score plus the flag bit a move out of it adds: Up, LeftUp and
    # Left of diagonal d - 1, LeftUp of d - 2
    pU, pL, pF, qL = (np.zeros((CH, 32, K), i32) for _ in range(4))
    stage = np.zeros((CH, D * C), np.uint8)  # a cell's flags, bit f for flag f
    valid = cell <= T
    with np.errstate(over="ignore"):
        for d in range(D):
            up_in = _shfl_up(pU[:, :, K - 1])
            lu_in = _shfl_up(qL[:, :, K - 1])
            b_in = _shfl_up(bc[:, :, K - 1])
            b_in[:, 0] = b[:, min(max(d - 1, 0), T - 1)]
            bc = np.concatenate([b_in[:, :, None], bc[:, :, :-1]], axis=2)
            bound = i32(gap) * i32(d)
            nU, nL, nF = (np.empty_like(pU) for _ in range(3))
            flags = np.empty((CH, 32, K), np.uint8)
            for t in range(K):
                ach, bch = ac[:, :, t], bc[:, :, t]
                sub = np.where(ach == bch, i32(match),
                               np.where((ach == DASH) | (bch == DASH), i32(gap), i32(dis)))
                up = (up_in if t == 0 else pU[:, :, t - 1]) + i32(gap)
                lu = (lu_in if t == 0 else qL[:, :, t - 1]) + sub
                left = pF[:, :, t] + i32(gap)
                up_lu = np.maximum(up, lu)
                mx = np.maximum(up_lu, left)
                off = (mx == left) & forbid[:, :, t]
                left = np.where(off, I32MIN, left)
                mx = np.where(off, up_lu, mx)
                j0 = (cell[:, t] == d)[None, :]  # cell (d, 0)
                s = np.where(j0, bound, mx)
                u, l_, f = j0 | (up == mx), ~j0 & (lu == mx), ~j0 & (left == mx)
                if t == 0:  # lane 0: cell (0, d)
                    s[:, 0], u[:, 0], l_[:, 0], f[:, 0] = bound, False, False, d > 0
                nU[:, :, t], nL[:, :, t], nF[:, :, t] = s + u, s + l_, s + f
                flags[:, :, t] = u | l_.astype(np.uint8) << 1 | f.astype(np.uint8) << 2
            stage[:, d * C + cell[valid]] = flags[:, valid]
            qL, pU, pL, pF = pL, nU, nL, nF
    # the flush: byte e of a flag's rows from cells 8e .. 8e + 7, four cells
    # a multiply
    words = stage.view("<u4")  # [CH, D C / 4]
    lo, hi = words[:, 0::2], words[:, 1::2]
    out = np.zeros((CH, 3, D, W8), np.uint8)
    for f in range(3):
        nib = [(((x >> np.uint32(f)) & np.uint32(0x01010101)) * np.uint32(0x10204080))
               >> np.uint32(28) for x in (lo, hi)]
        out[:, f] = (nib[0] | nib[1] << np.uint32(4)).astype(np.uint8).reshape(CH, D, W8)
    return out


def emulated_shared(a, b, a_len, match, dis, gap):
    """The shared-memory path, vectorised over the pairs (the warps) and
    the 32 lanes."""
    CH, T = a.shape
    nc, W8, D = (T + 9 + 31) // 32, (T + 9) // 8, 2 * T + 1
    i32 = np.int32
    ax = np.full((CH, T + 2), PAD, np.uint8)
    ax[:, 1 : T + 1] = a
    alen = a_len[:, 0]
    sc = np.zeros((3, CH, 32 * nc), i32)
    fl = np.zeros((3, 3, CH, nc), np.uint32)  # [diagonal slot, flag, pair, word]
    out = np.zeros((CH, 3, D, W8), np.uint8)
    lanes = np.arange(32)
    bit_of_lane = (np.uint32(1) << lanes.astype(np.uint32))[None, :]

    def bit(words, i):
        return ((words[:, i >> 5] >> (i & 31).astype(np.uint32)) & 1).astype(i32)

    for d in range(D):
        cur, p1, p2 = d % 3, (d + 2) % 3, (d + 1) % 3
        for c in range(nc):
            i = c * 32 + lanes
            valid = i <= T
            ic = np.minimum(i, T)
            im1 = np.maximum(ic - 1, 0)
            ach = ax[:, ic].astype(i32)
            bch = b[:, np.clip(d - 1 - ic, 0, T - 1)].astype(i32)
            sub = np.where(ach == bch, i32(match),
                           np.where((ach == DASH) | (bch == DASH), i32(gap), i32(dis)))
            with np.errstate(over="ignore"):
                up = np.where(ic > 0, sc[p1][:, im1] + bit(fl[p1, 0], im1) + i32(gap), i32(gap))
                lu = np.where(ic > 0, sc[p2][:, im1] + bit(fl[p2, 1], im1) + sub, sub)
                left = sc[p1][:, ic] + bit(fl[p1, 2], ic) + i32(gap)
                bound = i32(gap) * i32(d)
            up_lu = np.maximum(up, lu)
            mx = np.maximum(up_lu, left)
            forbid = (mx == left) & (ic[None, :] != alen[:, None]) & (ax[:, ic + 1] == DASH)
            left = np.where(forbid, I32MIN, left)
            mx = np.where(forbid, up_lu, mx)
            u, l_, f = up == mx, lu == mx, left == mx
            s = mx.copy()
            i0 = ic[None, :] == 0
            j0 = (ic[None, :] == d) & ~i0
            s = np.where(i0 | j0, bound, s)
            u = np.where(i0, False, np.where(j0, True, u))
            l_ = np.where(i0 | j0, False, l_)
            f = np.where(i0, d > 0, np.where(j0, False, f))
            sc[cur][:, ic[valid]] = s[:, valid]
            for k, flag in enumerate((u, l_, f)):  # __ballot_sync: bit l from lane l
                fl[cur, k, :, c] = np.where(flag & valid[None, :], bit_of_lane, 0).sum(
                    1, dtype=np.uint64).astype(np.uint32)
        for k in range(W8):  # the lanes' byte stores
            out[:, :, d, k] = (fl[cur][:, :, k >> 2] >> np.uint32(8 * (k & 3))).T & 0xFF
    return out


def _rand_seq(rng, lo, hi, dash=False):
    alpha = "ACGT-" if dash else "ACGT"
    return "".join(rng.choice(alpha) for _ in range(rng.randint(lo, hi)))


def _chunk(tier, seed):
    """Pairs of one tier: dashes in A, an empty A, rows of full length."""
    rng = random.Random(seed)
    a = [_rand_seq(rng, tier // 2 + 1, tier, dash=True) for _ in range(20)]
    b = [_rand_seq(rng, 1, tier) for _ in range(20)]
    a += ["", "A" * tier, _rand_seq(rng, tier, tier), "-" * tier, "AC-" + "G" * (tier - 3)]
    b += [_rand_seq(rng, 1, tier), "C" * tier, _rand_seq(rng, tier, tier), "ACGT" * (tier // 4),
          _rand_seq(rng, 1, 5)]
    return a, b


def _encoded(a, b, tier):
    return (batch_nw._encode(a, tier), batch_nw._encode(b, tier),
            np.array([[len(s)] for s in a], dtype=np.int32))


@pytest.mark.parametrize("scoring", [(2, -1, -3), (1, -2, -1)])
@pytest.mark.parametrize("tier", [16, 32, 64])
def test_emulation_equals_plain_and_jax(tier, scoring):
    a, b = _chunk(tier, tier + scoring[0])
    ea, eb, el = _encoded(a, b, tier)
    got = emulated_kernel(ea, eb, el, *scoring)
    W8 = (tier + 9) // 8
    assert W8 % 4 and got.shape == (len(a), 3, 2 * tier + 1, W8)
    plain = batch_nw._wavefront(torch.from_numpy(ea), torch.from_numpy(eb),
                                torch.from_numpy(el), *scoring).numpy()
    np.testing.assert_array_equal(got, plain)
    import jax.numpy as jnp

    ref = np.asarray(jax_batch_nw._build_kernel(tier, len(a), *scoring)(
        jnp.asarray(ea), jnp.asarray(eb), jnp.asarray(el)))
    np.testing.assert_array_equal(got, ref)


def test_register_widths_of_the_tiers():
    """k at each tier: 1, 2, 3, 5, 9 and 17 cells a lane up to 512, then
    the shared-memory path; T + 1 cells always fit 32 lanes of k."""
    assert [k_of(t) for t in (16, 32, 64, 128, 256, 512, 1024, 2048)] == [1, 2, 3, 5, 9, 17, 0, 0]
    assert k_of(511) == 16 + 1 and k_of(100) == 5 and k_of(31) == 1
    assert all(32 * k_of(t) >= t + 1 for t in range(16, 544))


@pytest.mark.parametrize("tier,pairs", [(128, 9), (256, 7), (512, 5), (1024, 3)])
def test_wider_tiers_equal_plain_and_jax(tier, pairs):
    """k = 5, 9 and the largest register k (17), and the shared-memory
    path (1024), on odd chunks."""
    rng = random.Random(tier)
    a = ["", "-" * tier] + [_rand_seq(rng, tier // 2 + 1, tier, dash=True)
                            for _ in range(pairs - 2)]
    b = ["ACGT" * (tier // 4), _rand_seq(rng, 1, tier)] + [_rand_seq(rng, 1, tier)
                                                          for _ in range(pairs - 2)]
    ea, eb, el = _encoded(a, b, tier)
    got = emulated_kernel(ea, eb, el, 2, -1, -3)
    plain = batch_nw._wavefront(torch.from_numpy(ea), torch.from_numpy(eb),
                                torch.from_numpy(el), 2, -1, -3).numpy()
    np.testing.assert_array_equal(got, plain)
    import jax.numpy as jnp

    ref = np.asarray(jax_batch_nw._build_kernel(tier, pairs, 2, -1, -3)(
        jnp.asarray(ea), jnp.asarray(eb), jnp.asarray(el)))
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("T", [17, 40, 100, 511])
def test_widths_off_the_tiers(T):
    """A T the tiers do not use takes the next register k up (lanes past
    T compute cells nobody reads); both paths give the plain buffer."""
    rng = random.Random(T)
    a = [_rand_seq(rng, 0, T, dash=True) for _ in range(5)]
    b = [_rand_seq(rng, 1, T, dash=True) for _ in range(5)]
    ea, eb, el = _encoded(a, b, T)
    plain = batch_nw._wavefront(torch.from_numpy(ea), torch.from_numpy(eb),
                                torch.from_numpy(el), 1, -2, -1).numpy()
    np.testing.assert_array_equal(emulated_registers(ea, eb, el, 1, -2, -1), plain)
    if T <= 100:
        np.testing.assert_array_equal(emulated_shared(ea, eb, el, 1, -2, -1), plain)


@pytest.mark.parametrize("tier", [16, 32, 64])
def test_de_skewed_windows_equal_the_matrices(tier):
    """The windows nw_matrices_batched reads from the emulated buffer are
    the flag matrices of nw._nw_matrix."""
    from ploidyfrost_tpu_torch.align.nw import _nw_matrix

    a, b = _chunk(tier, 100 + tier)
    got = emulated_kernel(*_encoded(a, b, tier), 2, -1, -3)
    for lane, (A, B) in enumerate(zip(a, b)):
        bits = np.unpackbits(got[lane], axis=-1, bitorder="little")
        ii = np.arange(len(A) + 1)[:, None]
        dg = ii + np.arange(len(B) + 1)[None, :]
        for f, want in enumerate(_nw_matrix(A, B, 2.0, -1.0, -3.0)):
            np.testing.assert_array_equal(bits[f][dg, ii], want, err_msg=f"{A} / {B}")


def test_padding_bits_are_zero():
    a, b = _chunk(16, 9)
    got = emulated_kernel(*_encoded(a, b, 16), 2, -1, -3)
    bits = np.unpackbits(got, axis=-1, bitorder="little")
    assert not bits[..., 17:].any()


# -- the dispatchers --------------------------------------------------------------


class _OnCard:
    """A CPU tensor that reports a CUDA device: the dispatchers' checks
    read its dtype, shape and layout; its device routes it."""

    device = torch.device("cuda", 0)

    def __init__(self, t):
        self._t = t

    def __getattr__(self, name):
        return getattr(self._t, name)


def _never(*args, **kwargs):
    raise AssertionError("called with tensors of the other device")


def test_cuda_tensors_never_reach_the_plain_wavefront(monkeypatch):
    launches = []
    monkeypatch.setattr(batch_nw, "_wavefront", _never)
    monkeypatch.setattr(batch_nw, "launch_wavefront", lambda *a: launches.append(a))
    monkeypatch.setattr(torch, "empty", lambda *a, **k: torch.zeros(*a, dtype=k["dtype"]))
    ea, eb, el = _encoded(*_chunk(16, 1), 16)
    out = batch_nw.nw_wavefront(*(_OnCard(torch.from_numpy(x)) for x in (ea, eb, el)), 2, -1, -3)
    assert len(launches) == 1 and tuple(out.shape) == (len(ea), 3, 33, 3)


class _Movable(_OnCard):
    """An _OnCard tensor that stays where it is when moved to the card."""

    def to(self, device):
        return self


_PAIRS = [("ACGTAC-GTACGTAGGA", "ACGTACGTACGAGGA"), ("ACG-TTGCA", "ACGTTTGCAA")] * 8


@pytest.mark.parametrize("scoring", [(2**31, -1, -3), (2, -(2**31) - 1, -3), (2.5, -1, -3)])
def test_scoring_the_kernel_does_not_take_stays_off_the_card(monkeypatch, scoring):
    """Scoring that is not integral or does not fit int32 goes to the numpy
    engine before anything is encoded or copied to the card."""
    from ploidyfrost_tpu_torch.align import nw

    monkeypatch.setattr(nw, "nw_matrices_native", lambda *a: None)
    monkeypatch.setattr(batch_nw, "wavefront_packed", _never)
    with pytest.raises(ValueError, match="fit int32"):
        batch_nw.nw_matrices_batched(_PAIRS, *scoring, device="cuda")
    before = dict(batch_nw.ENGINE_CALLS)
    got = batch_nw.needleman_wunsch_batch(_PAIRS, *scoring, device="cuda")
    assert batch_nw.ENGINE_CALLS["numpy"] == before["numpy"] + 1
    assert batch_nw.ENGINE_CALLS["device"] == before["device"]
    want = [nw.needleman_wunsch(a, b, *scoring) for a, b in _PAIRS]
    key = [[(u.str1, u.str2, u.score, u.pos, u.indel, u.snp) for u in units] for units in got]
    assert key == [[(u.str1, u.str2, u.score, u.pos, u.indel, u.snp) for u in units]
                   for units in want]


@pytest.mark.parametrize("refusal", ["launch", "layout"])
def test_a_refusal_on_the_card_propagates(monkeypatch, refusal):
    """A refusal of the kernel's wrapper on card tensors (here stand-ins)
    leaves needleman_wunsch_batch: the numpy engine is not taken."""
    import ploidyfrost_tpu_torch
    from ploidyfrost_tpu_torch.align import nw

    def refuse(*args):
        raise RuntimeError("nw_wavefront launch failed: CUDA error 700")

    from_numpy, tensor = torch.from_numpy, torch.tensor
    fortran = refusal == "layout"
    monkeypatch.setattr(nw, "nw_matrices_native", lambda *a: None)
    monkeypatch.setattr(ploidyfrost_tpu_torch, "resolve_device", lambda d: torch.device("cuda", 0))
    monkeypatch.setattr(torch, "from_numpy", lambda x: _Movable(
        from_numpy(np.asfortranarray(x) if fortran else x)))
    monkeypatch.setattr(torch, "tensor", lambda data, dtype=None, device=None: _Movable(
        tensor(data, dtype=dtype)))
    monkeypatch.setattr(torch, "empty", lambda *a, **k: torch.zeros(*a, dtype=k["dtype"]))
    monkeypatch.setattr(batch_nw, "launch_wavefront", refuse)
    monkeypatch.setattr(batch_nw, "_wavefront", _never)
    monkeypatch.setattr(nw, "_nw_matrix", _never)
    before = dict(batch_nw.ENGINE_CALLS)
    with pytest.raises(TypeError if fortran else RuntimeError):
        batch_nw.needleman_wunsch_batch(_PAIRS, 2, -1, -3, device="cuda")
    assert batch_nw.ENGINE_CALLS == before


def test_cpu_tensors_never_reach_the_wavefront_kernel(monkeypatch):
    monkeypatch.setattr(batch_nw, "launch_wavefront", _never)
    before = batch_nw.NW_LAUNCHES
    ea, eb, el = _encoded(*_chunk(16, 2), 16)
    got = batch_nw.nw_wavefront(*(torch.from_numpy(x) for x in (ea, eb, el)), 2, -1, -3)
    np.testing.assert_array_equal(got.numpy(), emulated_kernel(ea, eb, el, 2, -1, -3))
    assert batch_nw.NW_LAUNCHES == before


def test_cuda_tensors_never_reach_the_plain_em(monkeypatch):
    launches = []
    monkeypatch.setattr(gmm, "em_iterate_plain", _never)
    monkeypatch.setattr(gmm, "em_loop_plain", _never)
    monkeypatch.setattr(gmm, "em_pass_plain", _never)
    monkeypatch.setattr(gmm, "em_update_plain", _never)
    monkeypatch.setattr(gmm, "launch_em", lambda *a: launches.append(a))
    monkeypatch.setattr(gmm, "_workspace", lambda *a: (1, torch.zeros(1)))
    monkeypatch.setattr(gmm, "_load", lambda: {name: (lambda *a: 0) for name in (
        "pf_gmm_em_pass", "pf_gmm_em_update")})
    monkeypatch.setattr(torch, "empty", lambda *a, **k: torch.zeros(*a, dtype=k["dtype"]))
    monkeypatch.setattr(torch, "empty_like", lambda x: torch.zeros_like(x._t))
    monkeypatch.setattr(torch.cuda, "device", lambda d: _Null())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d: _Null())
    f64 = lambda x: _OnCard(torch.tensor(x, dtype=torch.float64))  # noqa: E731
    af, means, w, v = f64([0.3, 0.5]), f64([0.5]), f64([1.0]), f64([0.01])
    v2, w2, ll, count = gmm._em_iterate(af, means, w, v, 1000, 5.0, 2.0, 0.01)
    assert len(launches) == 1 and v2.shape == (1,) and count == 0
    assert gmm.em_pass(af, means, w, v).shape == (3,)
    assert gmm.em_update(f64([0.0, 1.0, 1.0]), w, v, 5.0, 2.0)[0].shape == (1,)


class _Null:
    cuda_stream = 0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_cpu_tensors_never_reach_the_em_kernel(monkeypatch):
    monkeypatch.setattr(gmm, "launch_em", _never)
    monkeypatch.setattr(gmm, "_load", _never)
    before = gmm.EM_LAUNCHES
    af = torch.tensor([0.3, 0.5, 0.52], dtype=torch.float64)
    one = torch.tensor([0.5], dtype=torch.float64)
    gmm._em_iterate(af, one, torch.ones(1, dtype=torch.float64), one / 50, 1000, 5.0, 2.0, 0.01)
    gmm.em_update(gmm.em_pass(af, one, one * 2, one / 50), one * 2, one / 50, 5.0, 2.0)
    assert gmm.EM_LAUNCHES == before


@pytest.mark.parametrize("bad", ["dtype", "shape", "a_len", "tier", "contiguous"])
def test_wavefront_wrapper_rejects(bad):
    ea, eb, el = (torch.from_numpy(x) for x in _encoded(*_chunk(16, 3), 16))
    if bad == "dtype":
        ea = ea.to(torch.int32)
    elif bad == "shape":
        eb = eb[:, :8].contiguous()
    elif bad == "a_len":
        el = el.to(torch.int64)
    elif bad == "tier":
        ea, eb = (torch.full((len(el), 4096), PAD, dtype=torch.uint8) for _ in range(2))
    else:
        ea = torch.from_numpy(np.asfortranarray(ea.numpy()))
    with pytest.raises((TypeError, ValueError)):
        batch_nw.nw_wavefront(ea, eb, el, 2, -1, -3)


@pytest.mark.parametrize("bad", ["dtype", "length", "contiguous", "empty", "too_many"])
def test_em_wrapper_rejects(bad):
    af = torch.linspace(0.1, 0.9, 50, dtype=torch.float64)
    g = gmm.MAX_G + 1 if bad == "too_many" else 2
    means = torch.linspace(0.3, 0.6, g, dtype=torch.float64)
    w = torch.full((g,), 1 / g, dtype=torch.float64)
    v = torch.full((g,), 0.01, dtype=torch.float64)
    if bad == "dtype":
        af = af.float()
    elif bad == "length":
        w = w[:1]
    elif bad == "contiguous":
        af = torch.linspace(0.1, 0.9, 100, dtype=torch.float64)[::2]
    else:
        means, w, v = (x[:0] for x in (means, w, v))
    with pytest.raises((TypeError, ValueError)):
        gmm._em_iterate(af, means, w, v, 1000, 5.0, 2.0, 0.01)

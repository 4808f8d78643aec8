"""The GMM-EM kernel's algorithm (csrc/gmm_em.cu), emulated in numpy on
the CPU, against the port's plain version and the JAX package.

The emulation follows the kernel step for step: one pass over the
frequencies an iteration, which gives the log-likelihood of (v_k, w_k)
and the sums of the next update at once; a lane a (point, component),
the components of a point in a segment of W lanes (g rounded up to a
power of two, at most 32; for g > 32 a lane sums the densities of
components j, j + 32, ... in order), its row sums by a butterfly over the
segment; warp q of block b taking the points (b WARPS + q) P + slot and a
grid's stride further, each lane's three running sums in that order; a
shuffle-down tree over a warp's P = 32 / W slots, the warps of a block in
turn; every block's row summed by groups of 16 lanes, lane-strided and
by a shuffle tree; the update's total, max and min by butterflies,
NaN-propagating. It must give
what em_iterate_plain (two passes an iteration, torch's sums) and the JAX
package's jitted `_em_iterate` (with a mask of ones) give, to rtol 1e-10
(tests/test_torch_gmm.py: both sides float64, only the order of the sums
differs), with the same iteration count. Data: the three golden allele
frequency files at g = 1..9 and seeded diploid, triploid and tetraploid
mixtures; edge cases N = 0 and 1, equal frequencies, max_iter 0 and 1, a
fit whose rejection guard fires, g from 1 to 33 across the segment widths
(g = 17 and 32 fill a warp, g = 33 takes the chunks of 32), a NaN weight.
Then the sharded fit (model/gmm._em_iterate_group: a pass a rank, one
all_reduce, the update) on 2 and 3 gloo ranks, one of them with an empty
slice, against one device.
"""

import os

import numpy as np
import pytest
import torch

from ploidyfrost_tpu.model import gmm as J
from ploidyfrost_tpu_torch.model import gmm as T
from test_torch_helpers import few_torch_threads  # noqa: F401  (autouse fixture)

RTOL = 1e-10
THREADS, WARPS, SMS = 512, 16, 132  # the kernel's block; an H100's multiprocessors
DBL_MIN, DBL_MAX = T.DBL_MIN, T.DBL_MAX
GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
GOLDEN_SETS = ("single_diploid", "multi_colored", "indel_dense")


def width(g):
    """Lanes a point: g rounded up to a power of two, at most 32."""
    w = 1
    while w < g and w < 32:
        w *= 2
    return w


def blocks_of(n, g, sms=SMS):
    """The kernel's grid: a block a multiprocessor at most, fewer where n W
    lanes fill fewer blocks of THREADS, at least one."""
    return max(1, min(sms, -(-n * width(g) // THREADS)))


def _butterfly(x):
    """The xor-shuffle butterfly over the lanes of axis -1 (a power of two
    long): pairs (0, 1), (2, 3), then pairs of pairs; every lane the same."""
    while x.shape[-1] > 1:
        x = x[..., 0::2] + x[..., 1::2]
    return x[..., 0]


def _tree(x):
    """A shuffle-down tree over axis -2 (a power of two long): element 0's
    sum."""
    x = x.copy()
    off = x.shape[-2] // 2
    while off:
        x[..., :off, :] = x[..., :off, :] + x[..., off : 2 * off, :]
        off //= 2
    return x[..., 0, :]


def _rows_sum(rows):
    """Every block's sum of the blocks' rows [B, ns]: for each column, lane
    l of a group of 16 adds rows l, l + 16, ... in turn, then the group's
    shuffle tree."""
    B, ns = rows.shape
    lanes = np.zeros((16, ns))
    for off in range(0, B, 16):
        chunk = np.zeros((16, ns))
        chunk[: min(16, B - off)] = rows[off : off + 16]
        lanes = lanes + chunk
    return _tree(lanes)


def emulated_pass(af, means, w, v, nblocks):
    """[2g + 1] = ll, gauss sums, var sums at (w, v), as the kernel sums."""
    n, g = len(af), len(means)
    W = width(g)
    P, chunks = 32 // W, -(-g // W)
    coef = 1.0 / np.sqrt((2.0 * np.pi) * v)
    d = af[:, None] - means[None, :]
    wp = w[None, :] * (coef[None, :] * np.exp(-(d * d) / (2.0 * v)[None, :]))
    part = np.where(wp == 0.0, DBL_MIN, wp)
    # a lane's components j, j + W, ... in order (lanes past g add 0), then
    # the butterfly over the segment
    pad = np.zeros((n, chunks * W - g))
    lane_s = np.concatenate([wp, pad], 1).reshape(n, chunks, W)
    lane_rs = np.concatenate([part, pad], 1).reshape(n, chunks, W)
    s, rs = lane_s[:, 0], lane_rs[:, 0]
    for m in range(1, chunks):
        s, rs = s + lane_s[:, m], rs + lane_rs[:, m]
    s, rs = _butterfly(s), _butterfly(rs)
    resp = part / rs[:, None]
    vals = np.concatenate([np.log(np.where(s == 0.0, DBL_MIN, s))[:, None], resp,
                           resp * d * d], axis=1)
    vals = np.concatenate([vals, np.zeros((1, 2 * g + 1))])  # row n: a lane without a point
    # lane (block b, warp q, slot) takes the points (b WARPS + q) P + slot + m stride
    stride = nblocks * WARPS * P
    first = (np.arange(nblocks)[:, None] * WARPS + np.arange(WARPS)[None, :]) * P
    idx = first[:, :, None] + np.arange(P)[None, None, :]
    acc = np.zeros((nblocks, WARPS, P, 2 * g + 1))
    for m in range(max(1, -(-n // stride))):
        i = idx + m * stride
        acc = acc + vals[np.where(i < n, i, n)]
    warps = _tree(acc)  # [B, WARPS, ns]: the slots of a warp
    rows = np.zeros((nblocks, 2 * g + 1))
    for q in range(WARPS):
        rows = rows + warps[:, q]
    return _rows_sum(rows)


def _nan_max(a, b):
    return a if a != a else b if (b != b or b > a) else a


def _nan_min(a, b):
    return a if a != a else b if (b != b or b < a) else a


def emulated_update(sums, w, v, m_thre, n_thre):
    """(w, v, rejected) after the kernel's update: the total by lanes
    l, l + 32, ... and a butterfly, the max and min NaN-propagating."""
    g = len(w)
    gsum, vsum = sums[1 : 1 + g], sums[1 + g :]
    lanes = np.zeros(32)
    for off in range(0, g, 32):
        chunk = np.zeros(32)
        chunk[: min(32, g - off)] = gsum[off : off + 32]
        lanes = lanes + chunk
    total = _butterfly(lanes)
    with np.errstate(divide="ignore", invalid="ignore"):
        nw = gsum / total
        nv = vsum / gsum
    max_w = min_w = nw[0]
    for j in range(1, g):
        max_w, min_w = _nan_max(max_w, nw[j]), _nan_min(min_w, nw[j])
    interior = max_w != nw[0] and max_w != nw[g - 1]
    reject = interior and (min_w < 1.0 / g / m_thre or min_w < max_w / g / n_thre)
    if reject:
        return w, v, True
    return nw, np.where(nv == 0.0, DBL_MIN, nv), False


def emulated_em(af, means, w, v, max_iter=1000, m_thre=5.0, n_thre=2.0, max_delta=0.01,
                nblocks=None):
    """The kernel's loop: (v, w, ll, count, passes, rejections)."""
    if nblocks is None:
        nblocks = blocks_of(len(af), len(means))
    ll_prev, p, rejected = 0.0, 0, 0
    while True:
        with np.errstate(divide="ignore", invalid="ignore"):
            sums = emulated_pass(af, means, w, v, nblocks)
        ll = sums[0]
        delta = ll - ll_prev if p else DBL_MAX
        if not (delta > max_delta and p < max_iter):
            return v, w, ll, p, p + 1, rejected
        w, v, rej = emulated_update(sums, w, v, m_thre, n_thre)
        rejected += rej
        ll_prev = ll
        p += 1


def _init(g):
    return (np.array([i / (g + 1) for i in range(1, g + 1)]), np.full(g, 1.0 / g),
            np.full(g, 0.01))


def _plain(af, means, w, v, max_iter=1000):
    f64 = lambda x: torch.tensor(x, dtype=torch.float64)  # noqa: E731
    tv, tw, tll, count = T.em_iterate_plain(f64(af), f64(means), f64(w), f64(v), max_iter,
                                            5.0, 2.0, 0.01)
    return tv.numpy(), tw.numpy(), float(tll), count


def _jax(af, means, w, v, max_iter=1000):
    jv, jw, jll = J._em_iterate(np.asarray(af), np.ones(len(af)), means, w, v, max_iter,
                                (5.0, 2.0, 0.01))
    return np.asarray(jv), np.asarray(jw), float(jll)


def _golden(name):
    model = T.GmmModel(device="cpu")
    model.read_fre_file(os.path.join(GOLDEN, name, "gold_allele_frequency.txt"), 0.0)
    return model.allele_fre


def _mixture(kind, n=4000, seed=0):
    rng = np.random.default_rng(seed)
    centres = {"diploid": [0.5], "triploid": [1 / 3, 2 / 3],
               "tetraploid": [0.25, 0.5, 0.75]}[kind]
    x = np.concatenate([rng.normal(c, 0.05, n // len(centres)) for c in centres])
    return np.clip(x, 0.01, 0.99)


def _same(af, g=None, max_iter=1000, init=None, nblocks=None, check_jax=True):
    means, w, v = init if init is not None else _init(g)
    ev, ew, ell, ecount, passes, rejected = emulated_em(af, means, w, v, max_iter,
                                                        nblocks=nblocks)
    pv, pw, pll, pcount = _plain(af, means, w, v, max_iter)
    assert ecount == pcount and passes == pcount + 1
    np.testing.assert_allclose(ev, pv, rtol=RTOL)
    np.testing.assert_allclose(ew, pw, rtol=RTOL)
    np.testing.assert_allclose(ell, pll, rtol=RTOL)
    if check_jax:
        jv, jw, jll = _jax(af, means, w, v, max_iter)
        np.testing.assert_allclose(ev, jv, rtol=RTOL)
        np.testing.assert_allclose(ew, jw, rtol=RTOL)
        np.testing.assert_allclose(ell, jll, rtol=RTOL)
    return ecount, rejected


@pytest.mark.parametrize("g", range(1, 10))
@pytest.mark.parametrize("name", GOLDEN_SETS)
def test_golden_frequencies(name, g):
    count, _ = _same(_golden(name), g)
    assert count >= 1


@pytest.mark.parametrize("g", [1, 2, 3, 5, 9])
@pytest.mark.parametrize("kind", ["diploid", "triploid", "tetraploid"])
def test_seeded_mixtures(kind, g):
    _same(_mixture(kind, seed=g), g)


@pytest.mark.parametrize("nblocks", [1, 3, 16, 79, 5000])
def test_block_partition(nblocks):
    """Any fixed partition gives the fit, the last one with more blocks
    than points (most blocks sum nothing)."""
    af = _mixture("triploid", n=1500, seed=7)
    for g in (2, 3, 4):
        _same(af, g, nblocks=nblocks, check_jax=False)


def test_one_point():
    for g in (1, 2, 3):
        _same(np.array([0.37]), g)


def test_no_points_against_plain():
    """N = 0: every sum is 0, the first update divides 0 by 0, ll stays
    0 and the loop stops after one iteration with NaN parameters."""
    count, _ = _same(np.zeros(0), 3, check_jax=False)
    assert count == 1


def test_all_frequencies_equal():
    for g in (1, 2, 3):
        _same(np.full(300, 0.5), g)


@pytest.mark.parametrize("max_iter", [0, 1])
def test_max_iter_zero_and_one(max_iter):
    count, _ = _same(_mixture("diploid", seed=3), 3, max_iter=max_iter)
    assert count == max_iter


def test_rejection_guard_fires():
    """Frequencies around the interior mean of g = 3: the new weights
    peak in the middle with a tiny minimum, so the step is rejected, the
    parameters stay and the loop stops with delta 0."""
    af = np.clip(np.random.default_rng(1).normal(0.5, 0.02, 2000), 0.01, 0.99)
    count, rejected = _same(af, 3)
    assert rejected >= 1 and count == 1
    v, w, _, _ = _plain(af, *_init(3))
    np.testing.assert_array_equal(w, np.full(3, 1 / 3))


def test_g_above_the_register_chunk():
    """g = 17: a point fills a warp of 32 lanes, 15 of them past g, which
    add 0 to the row sums."""
    assert width(17) == 32
    _same(_mixture("tetraploid", n=2500, seed=4), 17)


@pytest.mark.parametrize("g", [1, 2, 3, 4, 5, 8, 9, 16, 17, 32, 33])
def test_segment_widths(g):
    """g across the segment widths: whole segments (1, 2, 4, 8, 16, 32),
    lanes past g (3, 5, 9, 17), and g = 33, whose lanes sum two components
    before the butterfly and keep the sums of one chunk of 32 at a time."""
    count, _ = _same(_mixture("tetraploid", n=1200, seed=g), g)
    assert count >= 1


@pytest.mark.parametrize("n,g,want", [(9987, 1, 20), (9987, 2, 40), (9987, 3, 79),
                                      (9987, 9, 132), (0, 3, 1), (1, 33, 1), (300, 1600, 19)])
def test_block_count_from_the_work(n, g, want):
    """The grid follows n W lanes, capped at one block a multiprocessor;
    bench5m's 9,987 frequencies fill 20 to 132 blocks by g."""
    assert blocks_of(n, g) == want
    af = _mixture("diploid", n=max(n, 1), seed=n)[:n] if n <= 2000 else None
    if af is not None:
        _same(af, g, max_iter=3, check_jax=False)


def test_nan_weight():
    """A NaN weight: NaN ll, the NaN-propagating max and min, one
    iteration (NaN > max_delta is false)."""
    means, w, v = _init(3)
    w = w.copy()
    w[1] = np.nan
    count, _ = _same(_mixture("triploid", n=600, seed=5), init=(means, w, v))
    assert count == 1


def test_one_pass_an_iteration_against_the_plain_pass():
    """em_pass_plain is the pass the kernel makes: the ll of _ll_body and
    the update of _em_body from the same sums."""
    af = torch.from_numpy(_mixture("triploid", n=900, seed=6))
    means, w, v = (torch.from_numpy(x) for x in _init(3))
    sums = T.em_pass_plain(af, means, w, v)
    assert sums.shape == (7,)
    assert float(sums[0]) == float(T._ll_body(af, means, w, v))
    nv, nw = T.em_update_plain(sums, w, v, 5.0, 2.0)
    ev, ew = T._em_body(af, means, w, v, 5.0, 2.0)
    assert torch.equal(nv, ev) and torch.equal(nw, ew)
    np.testing.assert_allclose(emulated_pass(af.numpy(), *_init(3), 4)[0],
                               float(sums[0]), rtol=RTOL)


# -- the sharded fit on gloo ranks ------------------------------------------------

SHARDED_SETS = {"mixture": lambda: _mixture("triploid", n=1001, seed=8),
                "two_points": lambda: np.array([0.31, 0.64])}


def _rank_job(group, work):
    """Every rank fits each set over its slice (a rank of the 3-rank group
    holds none of the two points); rank 0 saves the fits."""
    from ploidyfrost_tpu_torch.model.gmm import GmmModel
    from ploidyfrost_tpu_torch.parallel.sharded import build_sharded_ll_step, rank_rows

    out = {}
    for name, make in SHARDED_SETS.items():
        af = make()
        model = GmmModel("cpu", group)
        model.read_data(af)
        for g in (1, 2, 3):
            model.resize(g)
            model.em_iterate()
            out[f"{name}{g}"] = np.concatenate([model.vars, model.weights,
                                                [model.log_likelihood]])
        lo, hi = rank_rows(len(af), group)
        means, w, v = (torch.from_numpy(x) for x in _init(2))
        out[f"{name}_ll"] = float(build_sharded_ll_step(group)(torch.from_numpy(af[lo:hi]),
                                                               means, w, v))
    if group.rank == 0:
        np.savez(os.path.join(work, f"em_world{group.world}.npz"), **out)
    return 0


@pytest.mark.parametrize("world", [2, 3])
def test_sharded_pass_and_update(world, tmp_path):
    from ploidyfrost_tpu_torch.parallel.mesh import RankPlan, run_ranks

    plan = RankPlan(local=world, world=world, offset=0, device_type="cpu", init_method=None,
                    timeout_s=120, threads=1)
    assert run_ranks(plan, _rank_job, (str(tmp_path),), timeout=240) == 0
    got = dict(np.load(tmp_path / f"em_world{world}.npz"))
    for name, make in SHARDED_SETS.items():
        af = make()
        for g in (1, 2, 3):
            pv, pw, pll, _ = _plain(af, *_init(g))
            want = np.concatenate([pv, pw, [pll]])
            np.testing.assert_allclose(got[f"{name}{g}"], want, rtol=1e-12, atol=0)
        f64 = lambda x: torch.tensor(x, dtype=torch.float64)  # noqa: E731
        ll = float(T._ll_body(f64(af), *(f64(x) for x in _init(2))))
        np.testing.assert_allclose(float(got[f"{name}_ll"]), ll, rtol=1e-12)

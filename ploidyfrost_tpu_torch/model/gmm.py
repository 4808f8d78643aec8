# Ported from ploidyfrost_tpu/model/gmm.py: the EM loop as a CUDA kernel (csrc/gmm_em.cu)
# with a torch float64 plain version; host I/O copied.
"""GMM-EM ploidy model (replaces src/GmmModel.{hpp,cpp}).

For each gauss count g (= candidate ploidy - 1) in [l-1, u-1]:
  init means_i = i/(g+1), weights = 1/g, vars = 0.01
  EM until delta-loglikelihood < delta or max iterations
  report avg loglikelihood and AIC; ploidy = argmin AIC + 1.

Deliberately replicated reference quirks (each cited):
  * means are NEVER updated by an EM step — new_means is copied from the
    old means and the computed update is discarded
    (src/GmmModel.cpp:301-315).
  * step rejection guard: if the max new weight is an INTERIOR component
    and min weight < 1/g/m_thre or < max_w/g/n_thre, the whole step is
    discarded (src/GmmModel.cpp:318-330).
  * zero densities and zero variances are clamped to DBL_MIN
    (src/GmmModel.cpp:270, 289, 311-313).
  * AIC = (2*(2g - 1) - 2*ll) / N  (src/GmmModel.hpp:27-31).
  * emIterate stops when (ll_new - ll_old) <= delta — the raw signed
    difference, not |delta| (src/GmmModel.cpp:385-391).
  * readFreFile's `while (!eof)` loop re-appends the last value when the
    file ends with trailing whitespace (src/GmmModel.cpp:252-257).
  * readCovFile closes the pentacov stream before reading it, so penta
    rows never contribute via the -f path (src/GmmModel.cpp:174-176),
    and its frequency guard uses INTEGER division cov/cov_sum
    (src/GmmModel.cpp:56, 102).

Compute is float64 on the chosen device. On a card each fit is one
launch of the hand-written kernel csrc/gmm_em.cu: the whole emIterate
loop, one pass over the frequencies an iteration and one grid barrier,
with one readback of the result (`_em_iterate`; `EM_LAUNCHES` counts the launches). On the
CPU the plain version runs: the per-point, per-component E-step as one
[N, G] torch broadcast, and the loop on the host (`em_iterate_plain`).
Both sum in another order than the reference's sequential C++ doubles
and agree with it to ~1e-12 relative, far inside the 6-significant-digit
output format (util/format.py). Over a process group each iteration is
one pass on each rank's slice, one all_reduce of its 2g + 1 sums, the
update, and the delta test on the host (`_em_iterate_group`).
"""

from __future__ import annotations

import ctypes
import math
import os
import threading

import numpy as np
import torch

from .. import resolve_device
from ..util.format import cpp_double

DBL_MIN = float(np.finfo(np.float64).tiny)  # 2.2250738585072014e-308
DBL_MAX = float(np.finfo(np.float64).max)
_INT32_MAX = (1 << 31) - 1
# components a fit takes (csrc/gmm_em.cu MAX_G)
MAX_G = 7168

# launches of csrc/gmm_em.cu made by the wrappers below (plain int; a run
# sets it to 0 and reads it back to show the model went through the kernel)
EM_LAUNCHES = 0

_lock = threading.Lock()
_fns = None  # the library's entry points, bound at first launch
_work = {}  # device -> the kernel's float64 workspace, its barrier words zeroed once


def _sum(x, group):
    """x summed over the ranks of `group` (parallel/sharded.py), or x
    itself on one device."""
    if group is None:
        return x
    from ..parallel.sharded import all_sum

    return all_sum(group, x)


def _weighted(af, means, weights, variances):
    """d = af - mean and w * N(af; mean, v), both [N, g]."""
    d = af[:, None] - means[None, :]
    p = (
        1.0 / torch.sqrt(2.0 * math.pi * variances)[None, :]
        * torch.exp(-(d * d) / (2.0 * variances)[None, :])
    )
    return d, weights[None, :] * p


def _ll_of(wp):
    s = wp.sum(1)
    s = torch.where(s == 0.0, DBL_MIN, s)
    return torch.log(s).sum()


def _em_sums(d, wp):
    """(gauss_sum, var_sum) of the E-step from _weighted's output."""
    part = torch.where(wp == 0.0, DBL_MIN, wp)
    resp = part / part.sum(1, keepdim=True)
    return resp.sum(0), (resp * d * d).sum(0)


def _em_update(gauss_sum, var_sum, weights, variances, m_thre, n_thre):
    """The M-step with the reference's frozen means and rejection guard
    (src/GmmModel.cpp:275-334) from the E-step's sums."""
    g = weights.shape[0]
    total = gauss_sum.sum()
    new_vars = var_sum / gauss_sum
    new_vars = torch.where(new_vars == 0.0, DBL_MIN, new_vars)
    new_weights = gauss_sum / total
    max_w = new_weights.max()
    interior = (max_w != new_weights[0]) & (max_w != new_weights[g - 1])
    min_w = new_weights.min()
    reject = interior & ((min_w < 1.0 / g / m_thre) | (min_w < max_w / g / n_thre))
    return (
        torch.where(reject, variances, new_vars),
        torch.where(reject, weights, new_weights),
    )


def _ll_body(af, means, weights, variances):
    """Log-likelihood of `af` (plain version)."""
    return _ll_of(_weighted(af, means, weights, variances)[1])


def _em_body(af, means, weights, variances, m_thre, n_thre):
    """One EM step (plain version): the E-step's sums, then the update."""
    return _em_update(*_em_sums(*_weighted(af, means, weights, variances)), weights, variances,
                      m_thre, n_thre)


def em_loop_plain(af, means, weights, variances, max_iter, m_thre, n_thre, max_delta):
    """emIterate (src/GmmModel.cpp:379-394) as torch ops: init ll, then
    while (delta > max_delta && count < max_iter) { em_step; recompute
    ll }, the loop test read on the host, one scalar sync per iteration.
    Returns (variances, weights, ll, count, delta): delta is the last
    delta-ll, the one that stopped the loop (DBL_MAX if none ran)."""
    v, w = variances, weights
    ll = _ll_body(af, means, w, v)
    delta = DBL_MAX
    count = 0
    while delta > max_delta and count < max_iter:
        v, w = _em_body(af, means, w, v, m_thre, n_thre)
        ll2 = _ll_body(af, means, w, v)
        delta = float(ll2 - ll)
        ll = ll2
        count += 1
    return v, w, ll, count, delta


def em_iterate_plain(af, means, weights, variances, max_iter, m_thre, n_thre, max_delta):
    """em_loop_plain's (variances, weights, ll, count): the plain version
    of `_em_iterate`."""
    return em_loop_plain(af, means, weights, variances, max_iter, m_thre, n_thre, max_delta)[:4]


def em_pass_plain(af, means, weights, variances):
    """One pass at (weights, variances), plain version: [2g + 1] float64 =
    ll, gauss_sum [g], var_sum [g]."""
    d, wp = _weighted(af, means, weights, variances)
    return torch.cat([_ll_of(wp)[None], *_em_sums(d, wp)])


def em_update_plain(sums, weights, variances, m_thre, n_thre):
    """The update of a pass's (summed) sums, plain version: (variances,
    weights)."""
    g = weights.shape[0]
    return _em_update(sums[1 : 1 + g], sums[1 + g :], weights, variances, m_thre, n_thre)


def _check(af, means, weights, variances):
    """Raise on what the kernel does not take."""
    if af.dtype != torch.float64 or af.dim() != 1:
        raise TypeError(f"af must be a 1-d float64 tensor, got {af.dtype} {tuple(af.shape)}")
    g = means.shape[0] if means.dim() == 1 else -1
    for name, x in (("means", means), ("weights", weights), ("variances", variances)):
        if x.dtype != torch.float64 or x.dim() != 1 or x.shape[0] != g:
            raise TypeError(f"{name} must be a [g] float64 tensor like means, got {x.dtype} "
                            f"{tuple(x.shape)}")
        if x.device != af.device:
            raise ValueError(f"{name} on {x.device} but af on {af.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not 1 <= g <= MAX_G:
        raise ValueError(f"need 1..{MAX_G} components, got {g}")
    if not af.is_contiguous():
        raise ValueError("af must be contiguous")
    if af.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {af.device}")


def _load():
    global _fns
    with _lock:
        if _fns is None:
            from ..kmer.extract import build

            lib = ctypes.CDLL(build("gmm_em"))
            p, i, ll, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_double
            spec = {
                "pf_gmm_em_plan": [ll, i, p, p],
                "pf_gmm_em": [p, ll, p, p, p, i, i, d, d, d, p, p, p],
                "pf_gmm_em_pass": [p, ll, p, p, p, i, p, p, p],
                "pf_gmm_em_update": [p, p, p, i, d, d, p, p, p],
                "pf_gmm_barrier_probe": [i, i, p, p],
                "pf_gmm_floor_probe": [i, i, i, i, p, p, p],
                "pf_gmm_em_attrs": [ll, i, p],
            }
            fns = {}
            for name, argtypes in spec.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                fns[name] = fn
            _fns = fns
        return _fns


def _rc(rc, what):
    if rc != 0:
        raise RuntimeError(f"gmm_em {what} failed: CUDA error {rc}")


def _workspace(n, g, device):
    """(blocks, float64 workspace) of a launch over n points at g
    components on `device`. The workspace is kept for the device and grown
    as a launch needs: it starts with the kernel's grid barrier words,
    zeroed when it is made and left ready by every launch, so a launch
    needs no memset."""
    blocks, doubles = ctypes.c_int(), ctypes.c_longlong()
    with torch.cuda.device(device):
        _rc(_load()["pf_gmm_em_plan"](n, g, ctypes.byref(blocks), ctypes.byref(doubles)), "plan")
    with _lock:
        work = _work.get(device)
        if work is None or work.numel() < doubles.value:
            work = _work[device] = torch.zeros(doubles.value, dtype=torch.float64, device=device)
    return blocks.value, work


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def launch_em(af, means, weights, variances, max_iter, m_thre, n_thre, max_delta, out):
    """One launch of the fit kernel on CUDA tensors already checked:
    out [2g + 2] float64 receives variances, weights, ll, count. Nothing
    is read back."""
    global EM_LAUNCHES
    g = means.shape[0]
    _, work = _workspace(af.numel(), g, af.device)
    max_iter = max(-_INT32_MAX - 1, min(int(max_iter), _INT32_MAX))
    with torch.cuda.device(af.device):
        rc = _load()["pf_gmm_em"](
            af.data_ptr(), af.numel(), means.data_ptr(), weights.data_ptr(),
            variances.data_ptr(), g, max_iter, float(m_thre), float(n_thre), float(max_delta),
            work.data_ptr(), out.data_ptr(), _stream(af.device))
    _rc(rc, "launch")
    EM_LAUNCHES += 1


def _em_iterate(af, means, weights, variances, max_iter, m_thre, n_thre, max_delta):
    """emIterate (src/GmmModel.cpp:379-394) of one fit: (variances,
    weights, ll, count). CUDA tensors launch the kernel once and read the
    result back in one copy (so the returned tensors lie on the CPU), or
    raise; CPU tensors take em_iterate_plain."""
    _check(af, means, weights, variances)
    if af.device.type == "cpu":
        return em_iterate_plain(af, means, weights, variances, max_iter, m_thre, n_thre,
                                max_delta)
    g = means.shape[0]
    out = torch.empty(2 * g + 2, dtype=torch.float64, device=af.device)
    launch_em(af, means, weights, variances, max_iter, m_thre, n_thre, max_delta, out)
    host = out.cpu()
    return host[:g], host[g : 2 * g], host[2 * g], int(host[2 * g + 1])


def em_pass(af, means, weights, variances):
    """One pass at (weights, variances): [2g + 1] float64 = ll, gauss_sum,
    var_sum of af's points (af may be empty), on af's device. CUDA
    tensors launch the kernel's pass entry or raise; CPU tensors take
    em_pass_plain."""
    global EM_LAUNCHES
    _check(af, means, weights, variances)
    if af.device.type == "cpu":
        return em_pass_plain(af, means, weights, variances)
    g = means.shape[0]
    sums = torch.empty(2 * g + 1, dtype=torch.float64, device=af.device)
    _, work = _workspace(af.numel(), g, af.device)
    with torch.cuda.device(af.device):
        rc = _load()["pf_gmm_em_pass"](
            af.data_ptr(), af.numel(), means.data_ptr(), weights.data_ptr(),
            variances.data_ptr(), g, work.data_ptr(), sums.data_ptr(), _stream(af.device))
    _rc(rc, "pass")
    EM_LAUNCHES += 1
    return sums


def em_update(sums, weights, variances, m_thre, n_thre):
    """The update of (summed) pass sums [2g + 1]: (variances, weights) on
    their device. CUDA tensors launch the kernel's one-block update or
    raise; CPU tensors take em_update_plain."""
    global EM_LAUNCHES
    _check(sums, weights, weights, variances)
    g = weights.shape[0]
    if sums.shape[0] != 2 * g + 1:
        raise TypeError(f"sums must hold 2g + 1 = {2 * g + 1} values, got {sums.shape[0]}")
    if sums.device.type == "cpu":
        return em_update_plain(sums, weights, variances, m_thre, n_thre)
    w_out, v_out = torch.empty_like(weights), torch.empty_like(variances)
    with torch.cuda.device(sums.device):
        rc = _load()["pf_gmm_em_update"](
            sums.data_ptr(), weights.data_ptr(), variances.data_ptr(), g, float(m_thre),
            float(n_thre), w_out.data_ptr(), v_out.data_ptr(), _stream(sums.device))
    _rc(rc, "update")
    EM_LAUNCHES += 1
    return v_out, w_out


def _em_iterate_group(af, means, weights, variances, max_iter, m_thre, n_thre, max_delta,
                      group):
    """emIterate over `group`'s ranks, af this rank's slice (the JAX
    package's _em_iterate_mesh): each iteration one pass a rank, one
    all_reduce of its 2g + 1 sums, the update, and the delta test on the
    host. Every rank takes the same decisions. Returns (variances,
    weights, ll, count) on af's device (ll a 0-d CPU tensor)."""
    v, w = variances, weights
    sums = _sum(em_pass(af, means, w, v), group)
    ll = float(sums[0])
    delta = DBL_MAX
    count = 0
    while delta > max_delta and count < max_iter:
        v, w = em_update(sums, w, v, m_thre, n_thre)
        sums = _sum(em_pass(af, means, w, v), group)
        ll2 = float(sums[0])
        delta = ll2 - ll
        ll = ll2
        count += 1
    return v, w, torch.tensor(ll, dtype=torch.float64), count


class GmmModel:
    """API mirror of the reference GmmModel (src/GmmModel.hpp:5-50)."""

    def __init__(self, device="cuda", group=None):
        """`group` (parallel/mesh.Group): fit over the ranks, each
        holding its slice of the frequencies on its own device."""
        self.group = group
        self.device = resolve_device(group.device if group is not None else device)
        self.allele_fre = np.zeros((0,), dtype=np.float64)
        self.gauss = 0
        self.means = np.zeros(0)
        self.weights = np.zeros(0)
        self.vars = np.zeros(0)
        self.m_thre = 5.0
        self.n_thre = 2.0
        self.em_max_iter = 1000
        self.em_max_delta = 0.01
        self.log_likelihood = 0.0
        self.aic = 0.0
        self._af_dev = None

    # -- configuration ---------------------------------------------------

    def set_m_threshold(self, m):
        self.m_thre = float(m)

    def set_n_threshold(self, n):
        self.n_thre = float(n)

    def set_max_iter_num(self, i):
        self.em_max_iter = int(i)

    def set_max_delta_num(self, d):
        self.em_max_delta = float(d)

    # -- data ingestion ----------------------------------------------------

    def read_data(self, data):
        self.allele_fre = np.asarray(data, dtype=np.float64)
        self._af_dev = None

    def read_fre_file(self, filename: str, frequency: float):
        """Whitespace-separated frequencies filtered to [freq, 1-freq].

        Replicates operator>> in a `while (!eof)` loop: when the file has
        trailing whitespace after the last token, the final extraction
        fails leaving the previous value in place, which appends the last
        accepted-or-not value once more (src/GmmModel.cpp:252-257).
        """
        with open(filename, "rb") as f:
            text = f.read().decode()
        vals = []
        tokens = text.split()
        # simulate the stream: last extraction fails iff trailing whitespace
        # (or empty file); `a` retains its previous value and is re-tested.
        trailing_ws = len(text) > 0 and text[-1].isspace()
        a = None
        for t in tokens:
            a = float(t)
            if a >= frequency and a <= 1 - frequency:
                vals.append(a)
        if trailing_ws and a is not None:
            if a >= frequency and a <= 1 - frequency:
                vals.append(a)
        self.read_data(np.array(vals, dtype=np.float64))

    def read_cov_file(self, prefix: str, frequency: float):
        """Read {prefix}_{bi,tri,tetra,penta}cov.txt (src/GmmModel.cpp:22-240).

        penta is opened but closed before its read loop
        (src/GmmModel.cpp:174-176), so it never contributes — replicated.
        The per-row guard divides INTEGERS: cov[0]/cov_sum and min/cov_sum
        are C++ int divisions (0 unless numerator == cov_sum).
        """
        vals: list[float] = []

        def atoi(s: str) -> int:
            s = s.strip()
            m = ""
            for ch in s.lstrip():
                if ch in "+-" and not m:
                    m += ch
                elif ch.isdigit():
                    m += ch
                else:
                    break
            try:
                return int(m)
            except ValueError:
                return 0

        def row_vals(line: str, ncov: int):
            parts = line.split("\t")
            # the reference requires `ncov` tab positions to exist, i.e.
            # at least ncov+1 tab-separated fields (src/GmmModel.cpp:44-48)
            if len(parts) < ncov + 1:
                return None
            return [atoi(parts[i]) for i in range(ncov)]

        def ref_min(cov: list[int]) -> int:
            # replicate the buggy chained-min (compares neighbours, not the
            # running minimum) of src/GmmModel.cpp:93-101, 142-154, 202-218
            mn = cov[0]
            for i in range(1, len(cov)):
                if cov[i] < cov[i - 1]:
                    mn = cov[i]
            return mn

        for ncov, suffix in ((2, "_bicov.txt"), (3, "_tricov.txt"), (4, "_tetracov.txt")):
            try:
                f = open(prefix + suffix)
            except OSError:
                raise FileNotFoundError(f"Model::readCovFile() : Open cov file error: {prefix + suffix}")
            with f:
                for line in f:
                    cov = row_vals(line.rstrip("\n"), ncov)
                    if cov is None:
                        continue
                    cov_sum = sum(cov)
                    if cov_sum < 10000 and cov_sum > 0:
                        mn = cov[0] if ncov == 2 else ref_min(cov)
                        q = mn // cov_sum if mn >= 0 else -((-mn) // cov_sum)  # C++ int division truncates
                        if q >= frequency and q <= 1 - frequency:
                            vals.extend(float(c) / cov_sum for c in cov)
        # pentacov: opened + existence-checked but closed before reading
        # (src/GmmModel.cpp:174-176) -> contributes nothing.
        if not _exists(prefix + "_pentacov.txt"):
            raise FileNotFoundError("Model::readCovFile() : Open cov file error")
        self.read_data(np.array(vals, dtype=np.float64))

    # -- model fitting -----------------------------------------------------

    def resize(self, g: int):
        g = int(g)
        self.gauss = g
        self.means = np.array([i / (g + 1) for i in range(1, g + 1)], dtype=np.float64)
        self.weights = np.full(g, 1.0 / g, dtype=np.float64)
        self.vars = np.full(g, 0.01, dtype=np.float64)

    def _t(self, x):
        return torch.as_tensor(x, dtype=torch.float64, device=self.device)

    def _af(self):
        """float64 device copy of the allele frequencies (made once):
        with a group, of this rank's contiguous slice."""
        if self._af_dev is None:
            af = self.allele_fre
            if self.group is not None:
                from ..parallel.sharded import rank_rows

                lo, hi = rank_rows(len(af), self.group)
                af = af[lo:hi]
            self._af_dev = self._t(af)
        return self._af_dev

    def _params(self):
        """(means, weights, variances) on the device, in one copy."""
        g = self.gauss
        p = self._t(np.concatenate([self.means, self.weights, self.vars]))
        return p[:g], p[g : 2 * g], p[2 * g :]

    def compute_log_likelihood(self) -> float:
        return float(_sum(em_pass(self._af(), *self._params()), self.group)[0])

    def em_step(self):
        means, w, v = self._params()
        sums = _sum(em_pass(self._af(), means, w, v), self.group)
        v, w = em_update(sums, w, v, self.m_thre, self.n_thre)
        self.vars = v.cpu().numpy()
        self.weights = w.cpu().numpy()

    def em_iterate(self):
        args = (self._af(), *self._params(), self.em_max_iter, self.m_thre, self.n_thre,
                self.em_max_delta)
        if self.group is None:
            v, w, ll, _ = _em_iterate(*args)
        else:
            v, w, ll, _ = _em_iterate_group(*args, self.group)
        self.vars = v.cpu().numpy()
        self.weights = w.cpu().numpy()
        self.log_likelihood = float(ll)
        self.compute_aic()

    def compute_aic(self) -> float:
        self.aic = (2 * (self.gauss * 2 - 1) - 2 * self.log_likelihood) / len(
            self.allele_fre
        )
        return self.aic

    def get_log_likelihood(self) -> float:
        return self.log_likelihood

    def get_aic(self) -> float:
        return self.aic

    # -- reporting -----------------------------------------------------------

    def output(self, stream):
        """Identical layout to GmmModel::output (src/GmmModel.cpp:357-378)."""
        w = stream.write
        w(f"ploidy : {self.gauss + 1}\tgauss : {self.gauss}\n")
        w(
            "avg loglikelihood : "
            + cpp_double(self.log_likelihood / len(self.allele_fre))
            + "\n"
        )
        w("AIC : " + cpp_double(self.aic) + "\n")
        w("means :\t\n\t")
        w("\t".join(cpp_double(m) for m in self.means) + "\t\n")
        w("weights :\t\n\t")
        w("\t".join(cpp_double(x) for x in self.weights) + "\t\n")
        w("variances :\t\n\t")
        w("\t".join(cpp_double(x) for x in self.vars) + "\t\n")
        w("-----------------------------------\n")


def _exists(path: str) -> bool:
    return os.path.exists(path)


def run_model(
    out_prefix: str,
    fre_file: str | None = None,
    cov_prefix: str | None = None,
    gauss_lower: int = 1,
    gauss_upper: int = 9,
    frequency: float = 0.0,
    max_iter: int = 1000,
    delta: float = 0.01,
    m_threshold: float = 5.0,
    n_threshold: float = 2.0,
    device="cuda",
    group=None,
) -> float:
    """The `PloidyFrost model` subcommand (src/Main.cpp:636-719).

    Returns the estimated ploidy (min-AIC). Writes
    {out_prefix}_model_result.txt with the reference's exact layout,
    including `maxll` initialized to DBL_MIN — a *positive* tiny value,
    so negative loglikelihoods never displace ploidy 0
    (src/Main.cpp:666-689). With `group`, rank 0 alone reads the input
    (a file rank 0 wrote lies in its own working directory, which the
    ranks of another host do not see) and hands the frequencies to the
    others, every rank fits the same model over its slice of them, and
    only rank 0 writes. An input rank 0 cannot read ends every rank.
    """
    from ..parallel.mesh import rank0_array, rank0_checks, rank0_decides

    model = GmmModel(device, group)
    model.set_m_threshold(m_threshold)
    model.set_n_threshold(n_threshold)
    model.set_max_iter_num(max_iter)
    model.set_max_delta_num(delta)
    primary = group is None or group.rank == 0
    if primary:
        with rank0_checks(group):
            if cov_prefix:
                model.read_cov_file(cov_prefix, frequency)
            else:
                model.read_fre_file(fre_file, frequency)
    if group is not None:
        rc = rank0_decides(group)
        if rc:
            raise SystemExit(rc)
        model.read_data(rank0_array(group, model.allele_fre if primary else None))
    maxll = DBL_MIN
    minaic = DBL_MAX
    ll_p = 0.0
    aic_p = 0.0
    with open(out_prefix + "_model_result.txt" if primary else os.devnull, "w") as outfile:
        for g in range(gauss_lower, gauss_upper + 1):
            model.resize(g)
            model.em_iterate()
            model.output(outfile)
            if model.get_log_likelihood() > maxll:
                maxll = model.get_log_likelihood()
                ll_p = g + 1
            if model.get_aic() < minaic:
                minaic = model.get_aic()
                aic_p = g + 1
        outfile.write(
            "max loglikelihood : " + cpp_double(maxll) + "\tploidy : " + cpp_double(ll_p) + "\n"
        )
        outfile.write(
            "min AIC : " + cpp_double(minaic) + "\tploidy : " + cpp_double(aic_p) + "\n"
        )
        outfile.write("estimated ploidy level is : " + cpp_double(aic_p) + "\n")
    return aic_p

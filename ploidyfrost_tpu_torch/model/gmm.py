# Ported from ploidyfrost_tpu/model/gmm.py: the EM loop in torch float64; host I/O copied.
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

Compute is vectorized torch float64 on the chosen device (the per-point,
per-component E-step is one [N, G] broadcast instead of the reference's
nested loops); reductions use torch's blocked sums, which agree with the
reference's sequential C++ double sums to ~1e-12 relative — far inside
the 6-significant-digit output format (util/format.py). The emIterate
loop runs on the host with one scalar sync per iteration for the
delta-ll test.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from .. import resolve_device
from ..util.format import cpp_double

DBL_MIN = float(np.finfo(np.float64).tiny)  # 2.2250738585072014e-308
DBL_MAX = float(np.finfo(np.float64).max)


def _sum(x, group):
    """x summed over the ranks of `group` (parallel/sharded.py), or x
    itself on one device."""
    if group is None:
        return x
    from ..parallel.sharded import all_sum

    return all_sum(group, x)


def _ll_body(af, means, weights, variances, group=None):
    """Log-likelihood of `af`; with `group`, af is this rank's slice and
    the sum is over every rank's."""
    d = af[:, None] - means[None, :]
    p = (
        1.0 / torch.sqrt(2.0 * math.pi * variances)[None, :]
        * torch.exp(-(d * d) / (2.0 * variances)[None, :])
    )
    s = (weights[None, :] * p).sum(1)
    s = torch.where(s == 0.0, DBL_MIN, s)
    return _sum(torch.log(s).sum(), group)


def _em_body(af, means, weights, variances, m_thre, n_thre, group=None):
    """One EM step with the reference's frozen means + rejection guard
    (src/GmmModel.cpp:275-334). With `group`, af is this rank's slice:
    its partial sums are reduced over the ranks and every rank runs the
    same update."""
    g = means.shape[0]
    d = af[:, None] - means[None, :]
    p = (
        1.0 / torch.sqrt(2.0 * math.pi * variances)[None, :]
        * torch.exp(-(d * d) / (2.0 * variances)[None, :])
    )
    part = weights[None, :] * p
    part = torch.where(part == 0.0, DBL_MIN, part)
    resp = part / part.sum(1, keepdim=True)
    gauss_sum, var_sum = _sum(torch.stack([resp.sum(0), (resp * d * d).sum(0)]), group)
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


def _em_iterate(af, means, weights, variances, max_iter, m_thre, n_thre, max_delta,
                group=None):
    """emIterate (src/GmmModel.cpp:379-394): init ll, then while (delta >
    max_delta && count < max_iter) { em_step; recompute ll }. The loop
    test reads delta on the host, one scalar sync per iteration. With
    `group`, af is this rank's slice and every sum spans the ranks, so
    every rank takes the same decisions."""
    v, w = variances, weights
    ll = _ll_body(af, means, w, v, group)
    delta = DBL_MAX
    count = 0
    while delta > max_delta and count < max_iter:
        v, w = _em_body(af, means, w, v, m_thre, n_thre, group)
        ll2 = _ll_body(af, means, w, v, group)
        delta = float(ll2 - ll)
        ll = ll2
        count += 1
    return v, w, ll


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

    def compute_log_likelihood(self) -> float:
        return float(
            _ll_body(self._af(), self._t(self.means), self._t(self.weights), self._t(self.vars),
                     self.group)
        )

    def em_step(self):
        v, w = _em_body(
            self._af(), self._t(self.means), self._t(self.weights), self._t(self.vars),
            self.m_thre, self.n_thre, self.group,
        )
        self.vars = v.cpu().numpy()
        self.weights = w.cpu().numpy()

    def em_iterate(self):
        v, w, ll = _em_iterate(
            self._af(), self._t(self.means), self._t(self.weights), self._t(self.vars),
            self.em_max_iter, self.m_thre, self.n_thre, self.em_max_delta, self.group,
        )
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
    (src/Main.cpp:666-689). With `group`, every rank fits the same
    model over its slice of the frequencies and only rank 0 writes.
    """
    model = GmmModel(device, group)
    model.set_m_threshold(m_threshold)
    model.set_n_threshold(n_threshold)
    model.set_max_iter_num(max_iter)
    model.set_max_delta_num(delta)
    if cov_prefix:
        model.read_cov_file(cov_prefix, frequency)
    else:
        model.read_fre_file(fre_file, frequency)
    maxll = DBL_MIN
    minaic = DBL_MAX
    ll_p = 0.0
    aic_p = 0.0
    primary = group is None or group.rank == 0
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

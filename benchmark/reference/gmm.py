"""Plain reference of the ploidy model: the upstream's GMM-EM over the
allele frequencies, in numpy, in a precision the caller names.

For g = 1..9 components: means i/(g+1) (never updated), weights 1/g,
variances 0.01; EM steps while the log-likelihood rises by more than
`delta` and fewer than `max_iter` steps ran. A step whose largest new
weight is an interior component and whose smallest weight is under
1/g/m or under max/g/n is discarded. Zero densities and variances are
clamped to the type's smallest normal. AIC = (2(2g - 1) - 2 ll) / N and
the ploidy is the g + 1 of the least AIC (the upstream's GmmModel).
The text is the upstream's model_result layout, numbers as C++ prints a
double (six significant digits).
"""

from __future__ import annotations

import math

import numpy as np


def read_frequencies(path: str) -> np.ndarray:
    """The frequency file as the upstream's `while (!eof) f >> a` loop
    reads it: a file that ends in white space repeats its last value."""
    text = open(path, "rb").read().decode()
    vals = [float(t) for t in text.split()]
    if vals and text[-1].isspace():
        vals.append(vals[-1])
    return np.array(vals, dtype=np.float64)


def _fmt(x: float) -> str:
    return f"{float(x):.6g}"


def fit(af: np.ndarray, g: int, dtype, max_iter=1000, delta=0.01, m_thre=5.0, n_thre=2.0):
    """One fit: (weights, variances, ll, steps)."""
    tiny = np.finfo(dtype).tiny
    x = af.astype(dtype)
    means = np.array([i / (g + 1) for i in range(1, g + 1)], dtype=dtype)
    w = np.full(g, 1.0 / g, dtype=dtype)
    v = np.full(g, 0.01, dtype=dtype)
    two_pi = dtype(2.0 * math.pi)
    d = x[:, None] - means[None, :]

    def weighted(w, v):
        return w[None, :] * (dtype(1.0) / np.sqrt(two_pi * v)[None, :]
                             * np.exp(-(d * d) / (dtype(2.0) * v)[None, :]))

    def ll_of(wp):
        s = wp.sum(1)
        return np.log(np.where(s == 0, tiny, s)).sum()

    ll = ll_of(weighted(w, v))
    steps = 0
    change = np.inf
    while change > delta and steps < max_iter:
        wp = weighted(w, v)
        part = np.where(wp == 0, tiny, wp)
        resp = part / part.sum(1, keepdims=True)
        gs = resp.sum(0)
        vs = (resp * d * d).sum(0)
        nv = vs / gs
        nv = np.where(nv == 0, tiny, nv)
        nw = gs / gs.sum()
        mx = nw.max()
        interior = mx != nw[0] and mx != nw[g - 1]
        mn = nw.min()
        if not (interior and (mn < 1.0 / g / m_thre or mn < mx / g / n_thre)):
            w, v = nw.astype(dtype), nv.astype(dtype)
        ll2 = ll_of(weighted(w, v))
        change = float(ll2 - ll)
        ll = ll2
        steps += 1
    return w, v, float(ll), steps


def model_result(af: np.ndarray, dtype=np.float64, gauss=range(1, 10)) -> tuple[str, int]:
    """(the model_result text, the ploidy) of the frequencies."""
    out = []
    maxll, minaic = float(np.finfo(np.float64).tiny), float(np.finfo(np.float64).max)
    ll_p = aic_p = 0
    n = len(af)
    for g in gauss:
        means = [i / (g + 1) for i in range(1, g + 1)]
        w, v, ll, _ = fit(af, g, dtype)
        aic = (2 * (g * 2 - 1) - 2 * ll) / n
        out.append(f"ploidy : {g + 1}\tgauss : {g}\n")
        out.append(f"avg loglikelihood : {_fmt(ll / n)}\n")
        out.append(f"AIC : {_fmt(aic)}\n")
        out.append("means :\t\n\t" + "\t".join(_fmt(m) for m in means) + "\t\n")
        out.append("weights :\t\n\t" + "\t".join(_fmt(x) for x in w) + "\t\n")
        out.append("variances :\t\n\t" + "\t".join(_fmt(x) for x in v) + "\t\n")
        out.append("-----------------------------------\n")
        if ll > maxll:
            maxll, ll_p = ll, g + 1
        if aic < minaic:
            minaic, aic_p = aic, g + 1
    out.append(f"max loglikelihood : {_fmt(maxll)}\tploidy : {_fmt(ll_p)}\n")
    out.append(f"min AIC : {_fmt(minaic)}\tploidy : {_fmt(aic_p)}\n")
    out.append(f"estimated ploidy level is : {_fmt(aic_p)}\n")
    return "".join(out), aic_p


def numbers(text: str) -> list[float]:
    vals = []
    for tok in text.replace(":", " ").split():
        try:
            vals.append(float(tok))
        except ValueError:
            pass
    return vals


def gap(prog_text: str, ref_text: str) -> float:
    """The largest relative gap between the numbers of two model_result
    texts, in order; inf when their layouts differ."""
    a, b = numbers(prog_text), numbers(ref_text)
    if len(a) != len(b):
        return math.inf
    worst = 0.0
    for x, y in zip(a, b):
        if x != y:
            worst = max(worst, abs(x - y) / max(abs(y), 1e-300))
    return worst

"""The torch port's GMM-EM against the JAX package.

Allele frequencies are made by numpy from a seed (a diploid-like and a
triploid-like mixture). `_em_iterate` (variances, weights, final
log-likelihood; it also returns the iteration count) and, per gauss count g, the fitted model's
log-likelihood and AIC must agree to rtol 1e-10: both sides compute in
float64, and only the order of the [N, G] reductions differs (XLA's
tree sums over a padded array against torch's blocked sums), which
moves results by about 1e-15 relative per iteration.
"""

import numpy as np
import pytest
import torch

from ploidyfrost_tpu.model import gmm as J
from ploidyfrost_tpu_torch.model import gmm as T
from test_torch_helpers import few_torch_threads  # noqa: F401  (autouse fixture)

RTOL = 1e-10


def _freqs(kind, n=3000, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "diploid":
        x = rng.normal(0.5, 0.08, n)
    else:
        x = np.concatenate([rng.normal(1 / 3, 0.06, n // 2), rng.normal(2 / 3, 0.06, n - n // 2)])
    return np.clip(x, 0.01, 0.99)


@pytest.mark.parametrize("kind", ["diploid", "triploid"])
@pytest.mark.parametrize("g", [1, 2, 4, 7])
def test_em_iterate_matches(kind, g):
    af = _freqs(kind)
    jm = J.GmmModel()
    jm.read_data(af)
    jm.resize(g)
    jaf, jmask = jm._af()
    jv, jw, jll = J._em_iterate(
        jaf, jmask, np.asarray(jm.means), np.asarray(jm.weights), np.asarray(jm.vars),
        1000, (5.0, 2.0, 0.01),
    )
    f64 = lambda x: torch.tensor(x, dtype=torch.float64)  # noqa: E731
    tv, tw, tll, count = T._em_iterate(
        f64(af), f64(jm.means), f64(jm.weights), f64(jm.vars), 1000, 5.0, 2.0, 0.01
    )
    assert 1 <= count <= 1000
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=RTOL)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=RTOL)
    np.testing.assert_allclose(float(tll), float(jll), rtol=RTOL)


@pytest.mark.parametrize("kind", ["diploid", "triploid"])
def test_aic_per_gauss_count(kind):
    af = _freqs(kind, seed=1)
    jm, tm = J.GmmModel(), T.GmmModel(device="cpu")
    jm.read_data(af)
    tm.read_data(af)
    for g in range(1, 10):
        jm.resize(g)
        tm.resize(g)
        jm.em_iterate()
        tm.em_iterate()
        np.testing.assert_allclose(tm.get_log_likelihood(), jm.get_log_likelihood(), rtol=RTOL)
        np.testing.assert_allclose(tm.get_aic(), jm.get_aic(), rtol=RTOL)
        np.testing.assert_allclose(tm.weights, jm.weights, rtol=RTOL)
        np.testing.assert_allclose(tm.vars, jm.vars, rtol=RTOL)


def test_single_step_and_loglik():
    af = _freqs("triploid", seed=2)
    jm, tm = J.GmmModel(), T.GmmModel(device="cpu")
    for m in (jm, tm):
        m.read_data(af)
        m.resize(3)
    np.testing.assert_allclose(tm.compute_log_likelihood(), jm.compute_log_likelihood(), rtol=RTOL)
    for _ in range(5):
        jm.em_step()
        tm.em_step()
    np.testing.assert_allclose(tm.weights, jm.weights, rtol=RTOL)
    np.testing.assert_allclose(tm.vars, jm.vars, rtol=RTOL)


@pytest.mark.parametrize("kind", ["diploid", "triploid"])
def test_run_model_result_file(tmp_path, kind):
    """run_model on a frequency file: same call and the same result
    file as the JAX package's, byte for byte at its 6-digit format."""
    af = _freqs(kind, n=800, seed=3)
    fre = tmp_path / "af.txt"
    fre.write_text("\n".join(f"{x:.6f}" for x in af) + "\n")
    jp = J.run_model(str(tmp_path / "j"), fre_file=str(fre))
    tp = T.run_model(str(tmp_path / "t"), fre_file=str(fre), device="cpu")
    assert tp == jp == (2 if kind == "diploid" else 3)
    assert (tmp_path / "t_model_result.txt").read_bytes() == (
        tmp_path / "j_model_result.txt"
    ).read_bytes()

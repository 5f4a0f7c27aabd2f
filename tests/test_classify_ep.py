"""EP classification vs a dense sequential-EP oracle.

The oracle is the textbook GPML Algorithm 3.5: SEQUENTIAL site updates
with rank-1 posterior downdates, run to convergence on the dense FITC
prior K = V V' + diag(d).  The structured implementation
(models/classify_ep.py) runs PARALLEL damped sweeps through m-space
Woodbury algebra and never forms an n x n object — both iterate to the
same EP fixed point (the probit sites are log-concave), so converged
sites, marginals, evidence, and predictions must agree.  Fixed-point
self-consistency (posterior marginals == tilted moments) is asserted
independently of either implementation.
"""

import numpy as np
import pytest
from scipy.stats import norm

import jax
import jax.numpy as jnp

from gpr_tpu.kernels import SeIso
from gpr_tpu.models.classify import _fitc_prior
from gpr_tpu.models.classify_ep import (
    ep_log_evidence,
    ep_predict,
    ep_sweeps,
    fit_classify_ep,
)
from gpr_tpu.optim import make_pack


def _setup(rng, n=30, m=5, d_in=2):
    X = jnp.asarray(rng.standard_normal((n, d_in)))
    z = jnp.asarray(rng.standard_normal((m, d_in)))
    y = jnp.asarray(np.sign(rng.standard_normal(n)))
    params = SeIso.Params(log_ell=jnp.asarray(0.3), log_sf2=jnp.asarray(0.4))
    return X, z, y, params


def _dense_prior(params, z, X):
    _, v, d = _fitc_prior(SeIso, params, z, X, None)
    return np.asarray(v @ v.T + jnp.diag(d))


def _moments(y_i, mu_n, s2_n):
    den = np.sqrt(1.0 + s2_n)
    z = y_i * mu_n / den
    lZ = norm.logcdf(z)
    ratio = np.exp(norm.logpdf(z) - lZ)
    dlZ = y_i * ratio / den
    d2lZ = ratio * (z + ratio) / (1.0 + s2_n)
    return lZ, dlZ, d2lZ


def _dense_sequential_ep(K, y, iters=80):
    """GPML Algorithm 3.5 with rank-1 updates, to convergence."""
    n = len(y)
    ttau = np.zeros(n)
    tnu = np.zeros(n)
    Sigma = K.copy()
    mu = np.zeros(n)
    for _ in range(iters):
        for i in range(n):
            tau_n = 1.0 / Sigma[i, i] - ttau[i]
            nu_n = mu[i] / Sigma[i, i] - tnu[i]
            mu_n, s2_n = nu_n / tau_n, 1.0 / tau_n
            _, dlZ, d2lZ = _moments(y[i], mu_n, s2_n)
            den = 1.0 - s2_n * d2lZ
            ttau_new = max(d2lZ / den, 0.0)
            tnu_new = (dlZ + mu_n * d2lZ) / den
            dt = ttau_new - ttau[i]
            ttau[i], tnu[i] = ttau_new, tnu_new
            si = Sigma[:, i].copy()
            Sigma -= (dt / (1.0 + dt * si[i])) * np.outer(si, si)
            mu = Sigma @ tnu
    # clean recompute at the final sites
    Sigma = np.linalg.inv(np.linalg.inv(K) + np.diag(ttau))
    mu = Sigma @ tnu
    return ttau, tnu, Sigma, mu


def _dense_evidence(K, y, ttau, tnu):
    """The module docstring's log Z_EP, computed with dense algebra."""
    n = len(y)
    Sigma = np.linalg.inv(np.linalg.inv(K) + np.diag(ttau))
    mu = Sigma @ tnu
    tau_n = 1.0 / np.diag(Sigma) - ttau
    nu_n = mu / np.diag(Sigma) - tnu
    mu_n, s2_n = nu_n / tau_n, 1.0 / tau_n
    lZ, _, _ = _moments(y, mu_n, s2_n)
    mu_site = tnu / ttau
    s2_site = 1.0 / ttau
    site_terms = (
        lZ + 0.5 * np.log(s2_n + s2_site)
        + 0.5 * (mu_n - mu_site) ** 2 / (s2_n + s2_site)
    )
    KS = K + np.diag(s2_site)
    sign, logdet = np.linalg.slogdet(KS)
    assert sign > 0
    quad = mu_site @ np.linalg.solve(KS, mu_site)
    return float(site_terms.sum() - 0.5 * logdet - 0.5 * quad)


def test_ep_sites_marginals_evidence_match_dense_oracle(rng):
    X, z, y, params = _setup(rng)
    K = _dense_prior(params, z, X)
    yn = np.asarray(y)

    ttau_d, tnu_d, Sigma_d, mu_d = _dense_sequential_ep(K, yn)

    _, v, d = _fitc_prior(SeIso, params, z, X, None)
    mask = jnp.ones_like(y)
    ttau, tnu = ep_sweeps(v, d, y, mask, n_sweeps=80)
    np.testing.assert_allclose(np.asarray(ttau), ttau_d, rtol=1e-6,
                               atol=1e-9)
    np.testing.assert_allclose(np.asarray(tnu), tnu_d, rtol=1e-6,
                               atol=1e-9)

    # fixed-point self-consistency: posterior marginals == tilted moments
    # (independent of either implementation's iteration path)
    tau_n = 1.0 / np.diag(Sigma_d) - ttau_d
    nu_n = mu_d / np.diag(Sigma_d) - tnu_d
    mu_n, s2_n = nu_n / tau_n, 1.0 / tau_n
    _, dlZ, d2lZ = _moments(yn, mu_n, s2_n)
    mu_hat = mu_n + s2_n * dlZ
    s2_hat = s2_n - s2_n**2 * d2lZ
    np.testing.assert_allclose(mu_d, mu_hat, rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(np.diag(Sigma_d), s2_hat, rtol=1e-6)

    ev = float(ep_log_evidence(SeIso, params, z, X, y, n_sweeps=80))
    ev_d = _dense_evidence(K, yn, ttau_d, tnu_d)
    np.testing.assert_allclose(ev, ev_d, rtol=1e-8)


def test_ep_predict_matches_dense_oracle(rng):
    X, z, y, params = _setup(rng, n=24, m=4)
    Xstar = jnp.asarray(rng.standard_normal((5, 2)))
    K = _dense_prior(params, z, X)
    yn = np.asarray(y)
    ttau_d, tnu_d, _, _ = _dense_sequential_ep(K, yn)

    # dense predictive (GPML eq. 3.60-3.61) under the FITC test conditional
    inducing, v, d = _fitc_prior(SeIso, params, z, X, None)
    u_inv_t = np.asarray(jnp.linalg.solve(
        inducing.chol_km.T, SeIso.k_cross(params, Xstar, inducing.z).T))
    vstar = u_inv_t.T
    kxs = vstar @ np.asarray(v).T  # (t, n)
    kss = np.asarray(SeIso.k_diag(params, Xstar))
    KS = K + np.diag(1.0 / ttau_d)
    mu_d = kxs @ np.linalg.solve(KS, tnu_d / ttau_d)
    var_d = kss - np.sum(kxs * np.linalg.solve(KS, kxs.T).T, axis=1)
    p_d = norm.cdf(mu_d / np.sqrt(1.0 + var_d))

    prob, mu, var = ep_predict(SeIso, params, z, X, y, Xstar, n_sweeps=80)
    np.testing.assert_allclose(np.asarray(mu), mu_d, rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(np.asarray(var), var_d, rtol=1e-6)
    np.testing.assert_allclose(np.asarray(prob), p_d, rtol=1e-6)


def test_ep_evidence_gradients(rng):
    """AD through the unrolled damped sweeps vs finite differences."""
    X, z, y, params = _setup(rng, n=18, m=4)

    def f(log_ell, log_sf2, z):
        p = SeIso.Params(log_ell=log_ell, log_sf2=log_sf2)
        return ep_log_evidence(SeIso, p, z, X, y, n_sweeps=40)

    g = jax.grad(f, argnums=(0, 1, 2))(params.log_ell, params.log_sf2, z)
    eps = 1e-6
    for i, val in enumerate([params.log_ell, params.log_sf2]):
        args = [params.log_ell, params.log_sf2, z]
        args[i] = val + eps
        up = f(*args)
        args[i] = val - eps
        dn = f(*args)
        np.testing.assert_allclose(float(g[i]), float((up - dn) / (2 * eps)),
                                   rtol=5e-5)
    dz = np.zeros(z.shape)
    dz[2, 1] = eps
    fd = float((f(params.log_ell, params.log_sf2, z + dz)
                - f(params.log_ell, params.log_sf2, z - dz)) / (2 * eps))
    np.testing.assert_allclose(float(g[2][2, 1]), fd, rtol=5e-5)


@pytest.mark.slow
def test_sharded_ep_evidence_matches_single(rng):
    """EP over the 8-device mesh == single-device (value and grads);
    n non-divisible exercises the masked-row site path."""
    from gpr_tpu.parallel import make_mesh, sharded_ep_log_evidence
    from gpr_tpu.parallel.sharded import shard_batch

    X, z, y, params = _setup(rng, n=91)
    mesh = make_mesh()
    Xs, ys, mask = shard_batch(mesh, X, y)

    single = ep_log_evidence(SeIso, params, z, X, y, n_sweeps=15)
    sharded = sharded_ep_log_evidence(SeIso, mesh, params, z, Xs, ys, mask,
                                      n_sweeps=15)
    np.testing.assert_allclose(float(sharded), float(single), rtol=1e-10)

    gd = jax.grad(
        lambda p, z: ep_log_evidence(SeIso, p, z, X, y, n_sweeps=10),
        argnums=(0, 1),
    )(params, z)
    gs = jax.jit(jax.grad(
        lambda p, z: sharded_ep_log_evidence(
            SeIso, mesh, p, z, Xs, ys, mask, n_sweeps=10),
        argnums=(0, 1),
    ))(params, z)
    for a, b in zip(jax.tree.leaves(gd), jax.tree.leaves(gs)):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a),
                                   rtol=1e-8, atol=1e-12)


def test_ep_posterior_state_matches_predict(rng):
    """The standard-schema collapse: predictions rebuilt from
    (coeffs, Rn U) == ep_predict."""
    from gpr_tpu.models.classify_ep import ep_posterior_state
    from gpr_tpu.numerics.linalg import matmul as _mm

    X, z, y, params = _setup(rng, n=26, m=4)
    Xstar = jnp.asarray(rng.standard_normal((5, 2)))
    prob, mu, var = ep_predict(SeIso, params, z, X, y, Xstar, n_sweeps=30)

    inducing, coeffs, rn = ep_posterior_state(SeIso, params, z, X, y,
                                              n_sweeps=30)
    kstar = SeIso.k_cross(params, Xstar, inducing.z)
    mu2 = kstar @ coeffs
    r_mat = _mm(rn, inducing.chol_km)
    t1 = jnp.linalg.solve(inducing.chol_km.T, kstar.T).T
    t2 = jnp.linalg.solve(r_mat.T, kstar.T).T
    var2 = (SeIso.k_diag(params, Xstar)
            - jnp.sum(t1 * t1, axis=1) + jnp.sum(t2 * t2, axis=1))
    np.testing.assert_allclose(np.asarray(mu2), np.asarray(mu), rtol=1e-8,
                               atol=1e-12)
    np.testing.assert_allclose(np.asarray(var2), np.asarray(var), rtol=1e-7)


def test_ep_training_separates(rng):
    """Two blobs: fit_classify_ep raises the EP evidence and the exact
    probit predictive separates held-out points."""
    n_per = 40
    Xn = np.concatenate([
        [1.6, 1.6] + 0.6 * rng.standard_normal((n_per, 2)),
        [-1.6, -1.6] + 0.6 * rng.standard_normal((n_per, 2)),
    ])
    yn = np.concatenate([np.ones(n_per), -np.ones(n_per)])
    perm = rng.permutation(2 * n_per)
    X, y = jnp.asarray(Xn[perm]), jnp.asarray(yn[perm])

    params = SeIso.Params(log_ell=jnp.asarray(0.0), log_sf2=jnp.asarray(0.5))
    z0 = X[:6]
    pack = make_pack(SeIso, params, z0, 1.0, learn_sigma2=False)
    ev0 = float(ep_log_evidence(SeIso, params, z0, X, y))
    p_f, z_f, st = fit_classify_ep(
        SeIso, X, y, pack, max_iter=20, epsabs=1e-4 / X.shape[0],
    )
    ev1 = float(ep_log_evidence(SeIso, p_f, z_f, X, y))
    assert ev1 > ev0

    Xt = jnp.asarray([[1.6, 1.6], [-1.6, -1.6]])
    prob, _, _ = ep_predict(SeIso, p_f, z_f, X, y, Xt)
    # The EP evidence is a PLATEAU in prediction confidence at this seed:
    # measured round 5, the converged optimum sits at f = 0.048955-0.048958
    # (mean scale) for endpoints ranging from probs (0.9994, 0.0005) to
    # (0.91, 0.155) — a 3e-6 objective spread.  Assert separation at the
    # blob centers, not a particular point on that plateau (the old
    # 0.9/0.1 thresholds encoded one trajectory's early stopping).
    assert float(prob[0]) > 0.85 and float(prob[1]) < 0.2
    assert float(prob[0]) - float(prob[1]) > 0.7


def test_ep_sweep_trace_converges(rng):
    """trace=True returns per-sweep rms site-precision deltas that decay
    geometrically at the damping rate (the convergence diagnostic; at the
    1M bench shape the same trace reached the f32 noise floor by sweep
    ~22 — a probe at commit b587de6)."""
    X, z, y, params = _setup(rng, n=40)
    _, v, d = _fitc_prior(SeIso, params, z, X, None)
    ttau, tnu, deltas = ep_sweeps(v, d, y, jnp.ones_like(y), n_sweeps=30,
                                  trace=True)
    deltas = np.asarray(deltas)
    assert deltas.shape == (30,)
    assert deltas[-1] < 1e-6 * deltas[0]
    # and the traced run returns the same sites as the plain one
    t2, n2 = ep_sweeps(v, d, y, jnp.ones_like(y), n_sweeps=30)
    np.testing.assert_allclose(np.asarray(ttau), np.asarray(t2), rtol=0)
    np.testing.assert_allclose(np.asarray(tnu), np.asarray(n2), rtol=0)

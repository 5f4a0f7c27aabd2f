"""Formula-independent GRADIENT oracles for the newest families.

VERDICT.md r3 item 7 (at commit b587de6): the per-family dense oracles certify the EVIDENCE value,
and the FD-gradient tests certify AD-vs-FD consistency of the repo's own
implementation — but a consistently-wrong evidence formula would pass both.
These tests close the loop: finite-difference an INDEPENDENT numpy/scipy
implementation of the evidence (its own SE kernel, its own FITC prior with
the repo's documented f64 jitter policy, its own Laplace mode solver) and
compare against the repo's AD gradient, coordinate by coordinate, for

  - the ordinal cutpoints (through ``cutpoints_from_raw`` — the transform
    itself is a reparametrization, exercised separately in test_ordinal),
  - the negative-binomial log-dispersion,
  - the warped model's warp parameters (the Jacobian-term path),
  - the Poisson model's kernel hyper AND an inducing-input coordinate,
    with a nonzero per-row log-exposure (the offset path),
  - the binomial model with per-row trial counts, and
  - a kernel hyper (log_ell) in each case, which exercises the prior
    construction end to end.

Oracle references: GPML ch. 3 Laplace evidence (the same formulas the
reference implements for the Gaussian case at lib/fitc_gp.ml:204-207);
Snelson et al. 2004 for the warped likelihood.
"""

import numpy as np
import pytest
from scipy.special import expit, gammaln
from scipy.stats import norm

import jax
import jax.numpy as jnp

from gpr_tpu.kernels import SeIso
from gpr_tpu.models.negbin import negbin_log_evidence
from gpr_tpu.models.ordinal import cutpoints_from_raw, ordinal_log_evidence
from gpr_tpu.models.warped import (
    WarpParams,
    warped_log_evidence,
)

JITTER = 1e-6  # the repo's documented absolute f64 jitter (CLAUDE.md)
D_FLOOR = 1e-8  # classify._fitc_prior's diagonal floor


# ---------------------------------------------------------------- priors

def np_se_iso(log_ell, log_sf2, A, B):
    ell2 = np.exp(2.0 * log_ell)
    sf2 = np.exp(log_sf2)
    d2 = ((A * A).sum(1)[:, None] - 2.0 * A @ B.T + (B * B).sum(1)[None, :])
    return sf2 * np.exp(-0.5 * np.maximum(d2, 0.0) / ell2)


def np_fitc_prior(log_ell, log_sf2, Z, X):
    """Dense FITC prior K = Q + diag(k - q), Q = Knm (Kmm + jit I)^-1 Kmn."""
    m = Z.shape[0]
    kmm = np_se_iso(log_ell, log_sf2, Z, Z)
    np.fill_diagonal(kmm, np.exp(log_sf2))
    knm = np_se_iso(log_ell, log_sf2, X, Z)
    q = knm @ np.linalg.solve(kmm + JITTER * np.eye(m), knm.T)
    d = np.maximum(np.exp(log_sf2) - np.diag(q), D_FLOOR)
    return q + np.diag(d)


# ------------------------------------------------- generic Laplace oracle

def laplace_evidence(K, loglik, grad_w, n, iters=250):
    """log q(y) = -a'f/2 + log p(y|f) - log|I + K W|/2 at the mode (GPML
    3.32); mode by damped Newton with an Armijo halving line search."""
    kinv = np.linalg.inv(K)
    f = np.zeros(n)

    def psi(g):
        return -0.5 * g @ (kinv @ g) + loglik(g)

    for _ in range(iters):
        grad, w = grad_w(f)
        b = w * f + grad
        f_new = np.linalg.solve(kinv + np.diag(w), b)
        step = f_new - f
        t = 1.0
        while t > 1e-9:
            if psi(f + t * step) >= psi(f):
                break
            t *= 0.5
        f = f + t * step
    grad, w = grad_w(f)
    sign, logdet = np.linalg.slogdet(np.eye(n) + K * w[None, :])
    assert sign > 0
    a = kinv @ f
    return -0.5 * float(a @ f) + float(loglik(f)) - 0.5 * logdet


def fd(fun, x0, i, eps):
    e = np.zeros_like(x0)
    e[i] = eps
    return (fun(x0 + e) - fun(x0 - e)) / (2.0 * eps)


# ---------------------------------------------------------------- ordinal

def _ordinal_loglik_parts(y, cuts):
    lo_all = np.concatenate([[-np.inf], cuts])
    hi_all = np.concatenate([cuts, [np.inf]])

    def loglik(f):
        lo, hi = lo_all[y], hi_all[y]
        return np.sum(np.log(norm.cdf(hi - f) - norm.cdf(lo - f)))

    def grad_w(f):
        lo, hi = lo_all[y], hi_all[y]
        p = norm.cdf(hi - f) - norm.cdf(lo - f)
        phi_lo = np.where(np.isfinite(lo), norm.pdf(lo - f), 0.0)
        phi_hi = np.where(np.isfinite(hi), norm.pdf(hi - f), 0.0)
        grad = (phi_lo - phi_hi) / p
        z0 = np.where(np.isfinite(lo), lo - f, 0.0)
        z1 = np.where(np.isfinite(hi), hi - f, 0.0)
        r0, r1 = phi_lo / p, phi_hi / p
        w = (r0 - r1) ** 2 + z1 * r1 - z0 * r0
        return grad, np.maximum(w, 1e-12)

    return loglik, grad_w


def test_ordinal_cutpoint_gradients_match_independent_oracle(rng):
    n, m, d_in = 20, 5, 2
    X = rng.standard_normal((n, d_in))
    Z = rng.standard_normal((m, d_in))
    f_true = np.sin(X.sum(axis=1)) * 2.0
    y = np.digitize(f_true + 0.3 * rng.standard_normal(n),
                    np.array([-1.0, 0.0, 1.2])).astype(np.int32)
    log_ell, log_sf2 = 0.3, 0.4
    cut_raw0 = np.array([-1.0, 0.0, 0.2])

    # repo AD gradient wrt (log_ell, cut_raw) through the unrolled Newton
    def repo_ev(log_ell_j, cut_raw_j):
        p = SeIso.Params(log_ell=log_ell_j, log_sf2=jnp.asarray(log_sf2))
        return ordinal_log_evidence(
            SeIso, p, jnp.asarray(Z), jnp.asarray(X), jnp.asarray(y),
            cut_raw_j, newton_iters=40,
        )

    g_ell, g_cut = jax.grad(repo_ev, argnums=(0, 1))(
        jnp.asarray(log_ell), jnp.asarray(cut_raw0)
    )

    # independent oracle evidence as a function of the same coordinates
    def oracle_ev(log_ell_o, cut_raw_o):
        cuts = np.asarray(cutpoints_from_raw(jnp.asarray(cut_raw_o)))
        K = np_fitc_prior(log_ell_o, log_sf2, Z, X)
        loglik, grad_w = _ordinal_loglik_parts(y, cuts)
        return laplace_evidence(K, loglik, grad_w, n)

    eps = 1e-5
    for i in range(len(cut_raw0)):
        ofd = fd(lambda c: oracle_ev(log_ell, c), cut_raw0, i, eps)
        np.testing.assert_allclose(float(g_cut[i]), ofd, rtol=2e-4,
                                   err_msg=f"cut_raw[{i}]")
    ofd_ell = (oracle_ev(log_ell + eps, cut_raw0)
               - oracle_ev(log_ell - eps, cut_raw0)) / (2 * eps)
    np.testing.assert_allclose(float(g_ell), ofd_ell, rtol=2e-4)


# ----------------------------------------------------------------- negbin

def test_negbin_dispersion_gradient_matches_independent_oracle(rng):
    n, m, d_in, r0 = 18, 4, 2, 2.0
    X = rng.standard_normal((n, d_in))
    Z = rng.standard_normal((m, d_in))
    mu = np.exp(np.sin(X.sum(axis=1)))
    y = rng.poisson(rng.gamma(r0, mu / r0)).astype(np.float64)
    log_ell, log_sf2 = 0.3, 0.2
    log_r0 = 0.7

    def repo_ev(log_ell_j, log_r_j):
        p = SeIso.Params(log_ell=log_ell_j, log_sf2=jnp.asarray(log_sf2))
        return negbin_log_evidence(
            SeIso, p, jnp.asarray(Z), jnp.asarray(X), jnp.asarray(y),
            jnp.exp(log_r_j), newton_iters=40,
        )

    g_ell, g_logr = jax.grad(repo_ev, argnums=(0, 1))(
        jnp.asarray(log_ell), jnp.asarray(log_r0)
    )

    def oracle_ev(log_ell_o, log_r_o):
        r = np.exp(log_r_o)
        K = np_fitc_prior(log_ell_o, log_sf2, Z, X)

        def loglik(f):
            return np.sum(gammaln(y + r) - gammaln(r) - gammaln(y + 1.0)
                          + r * np.log(r) + y * f
                          - (y + r) * np.logaddexp(np.log(r), f))

        def grad_w(f):
            p = expit(f - np.log(r))
            return y - (y + r) * p, (y + r) * p * (1.0 - p)

        return laplace_evidence(K, loglik, grad_w, n)

    eps = 1e-5
    ofd_r = (oracle_ev(log_ell, log_r0 + eps)
             - oracle_ev(log_ell, log_r0 - eps)) / (2 * eps)
    np.testing.assert_allclose(float(g_logr), ofd_r, rtol=2e-4)
    ofd_ell = (oracle_ev(log_ell + eps, log_r0)
               - oracle_ev(log_ell - eps, log_r0)) / (2 * eps)
    np.testing.assert_allclose(float(g_ell), ofd_ell, rtol=2e-4)


# ---------------------------------------------------------------- poisson

def test_poisson_gradients_match_independent_oracle(rng):
    from gpr_tpu.models.poisson import poisson_log_evidence

    n, m, d_in = 18, 4, 2
    X = rng.standard_normal((n, d_in))
    Z = rng.standard_normal((m, d_in))
    le = 0.5 * rng.standard_normal(n)  # nonzero exposure offsets
    mu = np.exp(np.sin(X.sum(axis=1)) + le)
    y = rng.poisson(mu).astype(np.float64)
    log_ell, log_sf2 = 0.3, 0.2

    def repo_ev(log_ell_j, Z_j):
        p = SeIso.Params(log_ell=log_ell_j, log_sf2=jnp.asarray(log_sf2))
        return poisson_log_evidence(
            SeIso, p, Z_j, jnp.asarray(X), jnp.asarray(y),
            log_exposure=jnp.asarray(le), newton_iters=40,
        )

    g_ell, g_z = jax.grad(repo_ev, argnums=(0, 1))(
        jnp.asarray(log_ell), jnp.asarray(Z)
    )

    def oracle_ev(log_ell_o, Z_o):
        K = np_fitc_prior(log_ell_o, log_sf2, Z_o, X)

        def loglik(f):
            lam = f + le
            return np.sum(y * lam - np.exp(lam) - gammaln(y + 1.0))

        def grad_w(f):
            lam = np.exp(f + le)
            return y - lam, lam

        return laplace_evidence(K, loglik, grad_w, n)

    eps = 1e-5
    ofd_ell = (oracle_ev(log_ell + eps, Z)
               - oracle_ev(log_ell - eps, Z)) / (2 * eps)
    np.testing.assert_allclose(float(g_ell), ofd_ell, rtol=2e-4)
    for (i, j) in [(0, 0), (2, 1)]:  # two inducing coordinates
        e = np.zeros_like(Z)
        e[i, j] = eps
        ofd_z = (oracle_ev(log_ell, Z + e)
                 - oracle_ev(log_ell, Z - e)) / (2 * eps)
        np.testing.assert_allclose(float(g_z[i, j]), ofd_z, rtol=5e-4,
                                   err_msg=f"Z[{i},{j}]")


# --------------------------------------------------------------- binomial

def test_binomial_gradients_match_independent_oracle(rng):
    from gpr_tpu.models.binomial import binomial_log_evidence

    n, m, d_in = 20, 4, 2
    X = rng.standard_normal((n, d_in))
    Z = rng.standard_normal((m, d_in))
    trials = rng.integers(1, 9, size=n).astype(np.float64)
    p_true = expit(2.0 * np.sin(X.sum(axis=1)))
    y = rng.binomial(trials.astype(np.int64), p_true).astype(np.float64)
    log_ell, log_sf2 = 0.25, 0.3

    def repo_ev(log_ell_j):
        p = SeIso.Params(log_ell=log_ell_j, log_sf2=jnp.asarray(log_sf2))
        return binomial_log_evidence(
            SeIso, p, jnp.asarray(Z), jnp.asarray(X), jnp.asarray(y),
            jnp.asarray(trials), newton_iters=40,
        )

    g_ell = jax.grad(repo_ev)(jnp.asarray(log_ell))

    def oracle_ev(log_ell_o):
        K = np_fitc_prior(log_ell_o, log_sf2, Z, X)

        def loglik(f):
            return np.sum(gammaln(trials + 1.0) - gammaln(y + 1.0)
                          - gammaln(trials - y + 1.0)
                          + y * f - trials * np.logaddexp(0.0, f))

        def grad_w(f):
            p = expit(f)
            return y - trials * p, trials * p * (1.0 - p)

        return laplace_evidence(K, loglik, grad_w, n)

    eps = 1e-5
    ofd_ell = (oracle_ev(log_ell + eps)
               - oracle_ev(log_ell - eps)) / (2 * eps)
    np.testing.assert_allclose(float(g_ell), ofd_ell, rtol=2e-4)

    # value parity too: same evidence from both implementations
    np.testing.assert_allclose(float(repo_ev(jnp.asarray(log_ell))),
                               oracle_ev(log_ell), rtol=1e-6)


# ----------------------------------------------------------------- warped

def test_warp_param_gradients_match_independent_oracle(rng):
    n, m, d_in, kw = 24, 5, 2, 2
    X = rng.standard_normal((n, d_in))
    Z = rng.standard_normal((m, d_in))
    y = np.cbrt(np.sin(X.sum(axis=1)) + 0.3 * rng.standard_normal(n))
    log_ell, log_sf2, sigma2 = 0.2, 0.1, 0.3
    wp0 = np.concatenate([  # packed (log_a, log_b, c)
        np.full(kw, -1.0), np.full(kw, 0.2), np.array([-0.5, 0.5])
    ])

    def unpack(v):
        return v[:kw], v[kw:2 * kw], v[2 * kw:]

    def repo_ev(log_ell_j, wv):
        la, lb, c = unpack(wv)
        p = SeIso.Params(log_ell=log_ell_j, log_sf2=jnp.asarray(log_sf2))
        return warped_log_evidence(
            SeIso, p, WarpParams(log_a=la, log_b=lb, c=c),
            jnp.asarray(Z), jnp.asarray(sigma2),
            jnp.asarray(X), jnp.asarray(y), block_size=8,
        )

    g_ell, g_w = jax.grad(repo_ev, argnums=(0, 1))(
        jnp.asarray(log_ell), jnp.asarray(wp0)
    )

    def oracle_ev(log_ell_o, wv):
        la, lb, c = unpack(wv)
        a, b = np.exp(la), np.exp(lb)
        t = y + (a * np.tanh(b * (y[:, None] + c))).sum(axis=1)
        gp = 1.0 + (a * b / np.cosh(b * (y[:, None] + c)) ** 2).sum(axis=1)
        K = np_fitc_prior(log_ell_o, log_sf2, Z, X) + sigma2 * np.eye(n)
        sign, logdet = np.linalg.slogdet(K)
        assert sign > 0
        quad = t @ np.linalg.solve(K, t)
        return (-0.5 * (quad + logdet + n * np.log(2 * np.pi))
                + np.log(gp).sum())

    eps = 1e-6
    for i in range(len(wp0)):
        ofd = fd(lambda w: oracle_ev(log_ell, w), wp0, i, eps)
        np.testing.assert_allclose(float(g_w[i]), ofd, rtol=2e-5,
                                   err_msg=f"warp coord {i}")
    ofd_ell = (oracle_ev(log_ell + eps, wp0)
               - oracle_ev(log_ell - eps, wp0)) / (2 * eps)
    np.testing.assert_allclose(float(g_ell), ofd_ell, rtol=2e-5)


# ------------------------------------------------- independent EP oracle

def ep_evidence_oracle(K, y, sweeps=300, tol=1e-13):
    """Sequential EP for the probit likelihood over a DENSE prior K —
    a from-scratch numpy implementation (GPML Algorithm 3.5: sequential
    site updates with rank-1 posterior downdates, own tilted moments via
    scipy.stats.norm, evidence by GPML eq. 3.65).  Shares NOTHING with
    models/classify_ep.py: that module runs damped PARALLEL sweeps with
    low-rank Woodbury marginals and a folded evidence form; probit EP's
    fixed point is unique, so the two must agree at convergence —
    VERDICT.md r4 #6 (at commit b587de6): a consistently-wrong cavity or moment formula in
    either implementation fails this comparison."""
    n = K.shape[0]
    ttau = np.zeros(n)
    tnu = np.zeros(n)
    Sigma = K.copy()
    mu = np.zeros(n)
    for _ in range(sweeps):
        ttau_prev = ttau.copy()
        for i in range(n):
            tau_ni = 1.0 / Sigma[i, i] - ttau[i]
            nu_ni = mu[i] / Sigma[i, i] - tnu[i]
            mu_ni = nu_ni / tau_ni
            s2_ni = 1.0 / tau_ni
            z = y[i] * mu_ni / np.sqrt(1.0 + s2_ni)
            lZ = norm.logcdf(z)
            ratio = np.exp(norm.logpdf(z) - lZ)
            dlZ = y[i] * ratio / np.sqrt(1.0 + s2_ni)
            d2lZ = ratio * (z + ratio) / (1.0 + s2_ni)
            den = 1.0 - s2_ni * d2lZ
            ttau_new = d2lZ / den
            tnu_new = (dlZ + mu_ni * d2lZ) / den
            dtau = ttau_new - ttau[i]
            ttau[i] = ttau_new
            tnu[i] = tnu_new
            si = Sigma[:, i].copy()
            Sigma = Sigma - (dtau / (1.0 + dtau * Sigma[i, i])) * np.outer(
                si, si
            )
            mu = Sigma @ tnu
        # refresh the posterior from scratch (rank-1 drift)
        Sigma = np.linalg.inv(np.linalg.inv(K) + np.diag(ttau))
        mu = Sigma @ tnu
        if np.max(np.abs(ttau - ttau_prev)) < tol:
            break

    sig2 = np.diag(Sigma)
    tau_n = 1.0 / sig2 - ttau
    nu_n = mu / sig2 - tnu
    mu_n = nu_n / tau_n
    s2_n = 1.0 / tau_n
    z = y * mu_n / np.sqrt(1.0 + s2_n)
    mu_t = tnu / ttau
    A = K + np.diag(1.0 / ttau)
    sign, logdetA = np.linalg.slogdet(A)
    assert sign > 0
    return (
        norm.logcdf(z).sum()
        + 0.5 * np.log(s2_n + 1.0 / ttau).sum()
        + 0.5 * ((mu_n - mu_t) ** 2 / (s2_n + 1.0 / ttau)).sum()
        - 0.5 * logdetA
        - 0.5 * mu_t @ np.linalg.solve(A, mu_t)
    )


def test_ep_evidence_matches_independent_oracle(rng):
    from gpr_tpu.models.classify_ep import ep_log_evidence

    n, m = 90, 7
    X = rng.standard_normal((n, 2))
    y = np.sign(rng.standard_normal(n))
    Z = X[:m]

    for log_ell, log_sf2 in [(0.3, 0.1), (-0.2, 0.6)]:
        K = np_fitc_prior(log_ell, log_sf2, Z, X)
        ev_oracle = ep_evidence_oracle(K, y)
        p = SeIso.Params(log_ell=jnp.asarray(log_ell),
                         log_sf2=jnp.asarray(log_sf2))
        ev_repo = float(ep_log_evidence(
            SeIso, p, jnp.asarray(Z), jnp.asarray(X), jnp.asarray(y),
            n_sweeps=100, jitter=JITTER,
        ))
        assert ev_repo == pytest.approx(ev_oracle, rel=1e-7, abs=1e-6), (
            log_ell, log_sf2, ev_repo, ev_oracle,
        )


def test_ep_gradient_matches_independent_oracle_fd(rng):
    """jax.grad of the repo EP evidence (stationary route) vs central FD
    of the INDEPENDENT sequential-EP oracle, for log_ell and one inducing
    coordinate."""
    from gpr_tpu.models.classify_ep import ep_log_evidence

    n, m = 70, 6
    X = rng.standard_normal((n, 2))
    y = np.sign(rng.standard_normal(n))
    Z = X[:m].copy()
    log_ell, log_sf2 = 0.25, 0.2

    p = SeIso.Params(log_ell=jnp.asarray(log_ell),
                     log_sf2=jnp.asarray(log_sf2))
    val, (g_p, g_z) = jax.value_and_grad(
        lambda p_, z_: ep_log_evidence(SeIso, p_, z_, jnp.asarray(X),
                                       jnp.asarray(y), n_sweeps=120,
                                       jitter=JITTER),
        argnums=(0, 1),
    )(p, jnp.asarray(Z))

    eps = 1e-5

    def oracle_at_ell(le):
        return ep_evidence_oracle(np_fitc_prior(le, log_sf2, Z, X), y)

    fd_ell = (oracle_at_ell(log_ell + eps)
              - oracle_at_ell(log_ell - eps)) / (2 * eps)
    assert float(g_p.log_ell) == pytest.approx(fd_ell, rel=2e-4, abs=1e-6)

    def oracle_at_z(v):
        Zp = Z.copy()
        Zp[2, 1] = v
        return ep_evidence_oracle(np_fitc_prior(log_ell, log_sf2, Zp, X), y)

    z0 = Z[2, 1]
    fd_z = (oracle_at_z(z0 + eps) - oracle_at_z(z0 - eps)) / (2 * eps)
    assert float(g_z[2, 1]) == pytest.approx(fd_z, rel=2e-4, abs=1e-6)

"""Robust GP regression: Student-t observation noise via variational EM.

The Student-t likelihood is the classic answer to outliers the reference
cannot give (it is Gaussian-only; gpr_manual.tex:532-559 lists no robust
variant).  It is NOT log-concave in f, so the fixed-step Newton story of
the other likelihood families breaks.  The tractable accelerator-friendly
route is the scale-mixture representation

  y_i | f_i, lam_i ~ N(f_i, sigma2 / lam_i),   lam_i ~ Gamma(nu/2, nu/2)

(marginally y_i - f_i ~ t_nu(0, sigma2)), with a mean-field variational
posterior q(f) q(lam):

  E-step   q(lam_i) = Gamma((nu+1)/2, (nu + E_q(f)[(y_i-f_i)^2]/sigma2)/2),
           lam_hat_i = E[lam_i] = (nu+1) / (nu + ((y_i-mu_i)^2+v_i)/sigma2)
  q(f)     the exact FITC posterior under heteroskedastic noise
           sigma2 / lam_hat  (models/fitc.py takes a per-point noise
           vector: s = r + sigma2 broadcasts)
  M-step   hypers/sigma2 maximize the collapsed bound, whose
           theta-dependent part is EXACTLY the heteroskedastic Gaussian
           log evidence with noise sigma2/lam_hat (the E[log lam] and KL
           terms are constant w.r.t. theta once q(lam) is frozen)

so every step reuses the existing engine: the E-step is one posterior
pass (O(nm) GEMMs), the M-step is the standard packed L-BFGS objective
with (X, y, lam) threaded as data.  Outliers are *identified*, not just
survived: trained lam_hat_i << 1 flags row i.

``t_elbo`` evaluates the full mean-field evidence lower bound (collapsed
Gaussian evidence + 0.5 sum(E[log lam] - log lam_hat) - KL(q(lam)||p(lam)))
— it must increase across E-steps at fixed hypers, which the tests
assert; it is also the model-selection score for nu.

Identifiability caveat (measured): FITC's
per-point diagonal slack r_i = k_ii - q_ii is idiosyncratic PRIOR
variance, i.e. a competing explanation for an outlier.  lam_hat flags a
row only when its deviation exceeds what r_i + sigma2 can absorb —
under-covered inducing sets (r_i ~ sf2) hide moderate outliers.  If
identification matters, check that r is small on the fitted model (it
is a field of ModelState) or raise m.

Validated against a dense oracle for the heteroskedastic posterior, ELBO
monotonicity, and an outlier-recovery comparison where the Gaussian fit
measurably breaks (tests/test_robust.py).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
from jax.scipy.special import digamma, gammaln

from .fitc import calc_model, calc_trained, log_evidence


def _t_moments_blocked(
    family, params, z, sigma2, X, y, lam, block_size, jitter,
):
    """Streaming exact hetero moments: the same closed forms as
    t_posterior_moments, but Knm never materializes — one stream_stats
    pass (per-row noise is now a first-class streaming input) for the
    m-space factors, then one lax.map pass emitting each row's (mu, var).
    Memory O(n + block x m): the robust family at n >> HBM."""
    from ..numerics.linalg import inv_tri_upper
    from .streaming import streaming_coeffs

    noise = sigma2 / lam
    inducing, r_mat, coeffs = streaming_coeffs(
        family, params, z, noise, X, y, block_size=block_size, jitter=jitter
    )
    u_inv = inv_tri_upper(inducing.chol_km)
    r_inv = inv_tri_upper(r_mat)

    n = X.shape[0]
    nb = -(-n // block_size)
    pad = nb * block_size - n
    if pad:
        Xp = jnp.concatenate([X, jnp.zeros((pad, X.shape[1]), X.dtype)])
        yp = jnp.concatenate([y, jnp.zeros((pad,), y.dtype)])
        nzp = jnp.concatenate([noise, jnp.ones((pad,), noise.dtype)])
    else:
        Xp, yp, nzp = X, y, noise
    xb = Xp.reshape(nb, block_size, X.shape[1])
    yb = yp.reshape(nb, block_size)
    nzb = nzp.reshape(nb, block_size)

    from ..numerics.linalg import matmul as _mm
    from ..numerics.linalg import rows_sqr_norm as _rowsq

    def blk(args):
        x_b, y_b, nz_b = args
        knm = family.k_cross(params, x_b, inducing.z)
        kd = family.k_diag(params, x_b)
        v = _mm(knm, u_inv)
        r = kd - _rowsq(v)
        s = r + nz_b
        is_ = 1.0 / s
        mean_pred = _mm(knm, coeffs)
        alpha = is_ * (y_b - mean_pred)
        mu = y_b - nz_b * alpha
        w2 = _rowsq(_mm(knm, r_inv))
        s_inv_diag = is_ * (1.0 - is_ * w2)
        var = jnp.maximum(nz_b * (1.0 - nz_b * s_inv_diag), 1e-12)
        return mu, var

    mu, var = jax.lax.map(blk, (xb, yb, nzb))
    return (
        mu.reshape(-1)[:n],
        var.reshape(-1)[:n],
        (inducing, r_mat, coeffs),
    )


def t_posterior_moments(
    family, params, z, sigma2, X, y, lam, *, variational: bool = False,
    jitter: float | None = None, block_size: int | None = None,
):
    """(mu, var_latent, trained): the EXACT posterior of f_train under the
    model prior K = Q + diag(r) and noise Lam_n = sigma2/lam.

    Not the engine's train-input predictor (fitc_gp.ml:489-496, which by
    the FITC predictive convention drops the diag(r) cross terms — fine
    for serving, wrong for the VB E-step: with it the coordinate updates
    are not ascent steps on the ELBO and the tests catch the decrease).
    Closed forms via S = K + Lam_n and the existing factor R'R = B:

      alpha = S^-1 y        = is (y - Knm coeffs)        [coeffs = B^-1 Kmn is y]
      mu    = K S^-1 y      = y - Lam_n alpha
      cov   = K - K S^-1 K  = K S^-1 Lam_n, so
      var_i = Lam_n_i (1 - Lam_n_i (S^-1)_ii),
      (S^-1)_ii = is_i (1 - is_i w2_i),  w2 = rowsq(Knm R^-1).

    ``block_size`` streams the same formulas (Knm never materializes;
    the third return is then the (inducing, r_mat, coeffs) triple
    instead of a TrainedState) — use it when n outgrows HBM.
    """
    if block_size is not None:
        return _t_moments_blocked(
            family, params, z, sigma2, X, y, lam, block_size, jitter
        )
    from ..numerics.linalg import rows_sqr_norm as _rowsq
    from ..numerics.linalg import solve_tri_right as _str

    noise = sigma2 / lam
    model = calc_model(
        family, params, X, z, noise, variational=variational, jitter=jitter
    )
    trained = calc_trained(model, y)
    from .fitc import calc_means

    mean_pred = calc_means(trained)  # Q S^-1 y
    alpha = model.is_ * (y - mean_pred)
    mu = y - noise * alpha
    w2 = _rowsq(_str(model.knm, model.r_mat))
    s_inv_diag = model.is_ * (1.0 - model.is_ * w2)
    var = jnp.maximum(noise * (1.0 - noise * s_inv_diag), 1e-12)
    return mu, var, trained


def t_lambda_update(y, mu, var, sigma2, nu):
    """E-step: lam_hat = E_q[lam] given the current q(f) moments."""
    e2 = jnp.square(y - mu) + var
    return (nu + 1.0) / (nu + e2 / sigma2)


def t_elbo(
    family, params, z, sigma2, X, y, lam_pair, *, variational: bool = False,
    jitter: float | None = None,
):
    """Mean-field ELBO for q(lam) = Gamma(a, b) given as ``lam_pair =
    (a, b)`` (so lam_hat = a/b).  Collapsed over q(f):

      ELBO = log Z_gauss(noise = sigma2 / lam_hat)
             + 0.5 sum(E[log lam] - log lam_hat)
             - KL(Gamma(a, b) || Gamma(nu/2, nu/2))     [nu from caller]

    Returned as a function of nu so t_fit can score nu choices:
    ``t_elbo(...)(nu)``.
    """
    a, b = lam_pair
    lam_hat = a / b
    lz = log_evidence(
        family, params, z, sigma2 / lam_hat, X, y,
        variational=variational, jitter=jitter,
    )
    e_log_lam = digamma(a) - jnp.log(b)
    corr = 0.5 * jnp.sum(e_log_lam - jnp.log(lam_hat))

    def of_nu(nu):
        a0 = nu / 2.0
        b0 = nu / 2.0
        kl = jnp.sum(
            (a - a0) * digamma(a)
            - gammaln(a)
            + gammaln(a0)
            + a0 * (jnp.log(b) - jnp.log(b0))
            + lam_hat * (b0 - b)
        )
        return lz + corr - kl

    return of_nu


def t_em_sweeps(
    family, params, z, sigma2, X, y, *, nu: float = 4.0, sweeps: int = 10,
    variational: bool = False, jitter: float | None = None,
    block_size: int | None = None,
):
    """Fixed-hyper mean-field EM: alternate exact q(f) and q(lam) updates.
    Jit-compatible (lax.scan).  ``block_size`` streams each E-step so Knm
    never materializes (n >> HBM).  Returns (lam_hat, (a, b))."""

    def step(lam, _):
        mu, var, _tr = t_posterior_moments(
            family, params, z, sigma2, X, y, lam,
            variational=variational, jitter=jitter, block_size=block_size,
        )
        a = jnp.full_like(lam, (nu + 1.0) / 2.0)
        b = (nu + (jnp.square(y - mu) + var) / sigma2) / 2.0
        return a / b, (a, b)

    lam0 = jnp.ones(y.shape, dtype=X.dtype)
    lam, (a_all, b_all) = jax.lax.scan(step, lam0, None, length=sweeps)
    return lam, (a_all[-1], b_all[-1])


def t_select_nu(
    family, params, z, sigma2, X, y, *, nu_grid=(2.5, 3.0, 4.0, 6.0, 10.0,
                                                 20.0, 50.0),
    sweeps: int = 10, variational: bool = False,
    jitter: float | None = None,
):
    """Degrees-of-freedom selection by the mean-field ELBO at fixed
    hypers: run the EM sweeps per candidate nu and score each converged
    q(lam) with its own bound.  Returns (best_nu, {nu: elbo}).

    The ELBO is the variational model-selection score — heavier-tailed
    residuals push it toward small nu, clean Gaussian residuals toward
    large (the tests assert both directions).  Typical use: fit once with
    a moderate nu, select, refit if the choice differs materially.
    """
    scores = {}
    for nu in nu_grid:
        _, pair = t_em_sweeps(
            family, params, z, sigma2, X, y, nu=float(nu), sweeps=sweeps,
            variational=variational, jitter=jitter,
        )
        scores[float(nu)] = float(
            t_elbo(family, params, z, sigma2, X, y, pair,
                   variational=variational, jitter=jitter)(float(nu))
        )
    best = max(scores, key=scores.get)
    return best, scores


def fit_t(
    family,
    X,
    y,
    pack,
    *,
    nu: float = 4.0,
    n_em: int = 6,
    e_sweeps: int = 3,
    m_step_iters: int = 25,
    variational: bool = False,
    jitter: float | None = None,
    normalize: bool = True,
    mesh=None,
    block_size: int | None = None,
    **fit_kwargs,
):
    """Robust training: alternate packed L-BFGS M-steps (hetero Gaussian
    evidence with the current weights) and mean-field E-steps.

    ``pack`` must carry learn_sigma2=True — sigma2 here is the Student-t
    scale.  ``mesh`` runs both steps 1-D data-parallel
    (parallel.classify_sharded.sharded_hetero_log_evidence /
    sharded_t_moments); the returned lam_hat is gathered to host order.
    ``block_size`` streams both single-device steps (per-row noise is a
    first-class streaming input, models/streaming.py) so Knm never
    materializes — the robust family at n >> HBM.
    Returns (params, z, sigma2, lam_hat, state): lam_hat_i << 1 flags
    row i as an outlier (weight of its residual in every statistic).
    """
    if not pack.learn_sigma2:
        raise ValueError(
            "fit_t learns the t scale through the pack's sigma2 slot: "
            "build the pack with learn_sigma2=True"
        )
    if mesh is not None and block_size is not None:
        raise ValueError(
            "fit_t streams per shard via mesh=... alone; block_size "
            "composes with the single-device path only"
        )
    from ..optim.lbfgs_device import fit_packed_objective

    n = X.shape[0]
    scale = 1.0 / n if normalize else 1.0

    if mesh is not None:
        if variational:
            raise ValueError(
                "fit_t(mesh=...) implements the standard FITC objective "
                "only; drop variational=True"
            )
        from ..parallel.classify_sharded import (
            sharded_hetero_log_evidence,
            sharded_t_moments,
        )
        from ..parallel.sharded import shard_batch

        Xd, yd, mask = shard_batch(mesh, X, y)

        def fg(x, Xd, yd, mask, lam):
            def f(x):
                params, z, sigma2 = pack.unpack(x)
                return -scale * sharded_hetero_log_evidence(
                    family, mesh, params, z, sigma2 / lam, Xd, yd, mask,
                    jitter=jitter,
                )

            return jax.value_and_grad(f)(x)

        lam = jnp.ones_like(yd)

        def e_step(params, z, sigma2, lam):
            mu, var = sharded_t_moments(
                family, mesh, params, z, sigma2, Xd, yd, lam, mask,
                jitter=jitter,
            )
            new = t_lambda_update(yd, mu, var, sigma2, nu)
            return jnp.where(mask > 0.0, new, 1.0)

        data = lambda lam: (Xd, yd, mask, lam)  # noqa: E731

        def finish(lam):
            # replicate off the mesh, then drop the pad rows
            from jax.sharding import NamedSharding, PartitionSpec

            rep = NamedSharding(mesh, PartitionSpec())
            return jax.device_put(lam, rep)[:n]
    else:

        def fg(x, X, y, lam):
            def f(x):
                params, z, sigma2 = pack.unpack(x)
                if block_size is not None:
                    from .streaming import streaming_log_evidence

                    return -scale * streaming_log_evidence(
                        family, params, z, sigma2 / lam, X, y,
                        variational=variational, jitter=jitter,
                        block_size=block_size,
                    )
                return -scale * log_evidence(
                    family, params, z, sigma2 / lam, X, y,
                    variational=variational, jitter=jitter,
                )

            return jax.value_and_grad(f)(x)

        lam = jnp.ones(y.shape, dtype=X.dtype)

        def e_step(params, z, sigma2, lam):
            mu, var, _tr = t_posterior_moments(
                family, params, z, sigma2, X, y, lam,
                variational=variational, jitter=jitter,
                block_size=block_size,
            )
            return t_lambda_update(y, mu, var, sigma2, nu)

        data = lambda lam: (X, y, lam)  # noqa: E731
        finish = lambda lam: lam  # noqa: E731

    cur = pack
    st = None
    for _ in range(n_em):
        st = fit_packed_objective(
            fg, cur, data(lam), max_iter=m_step_iters, **fit_kwargs
        )
        params, z, sigma2 = pack.unpack(st.x)
        for _ in range(e_sweeps):
            lam = e_step(params, z, sigma2, lam)
        cur = dataclasses.replace(cur, x0=st.x)  # warm-start next M-step
    params, z, sigma2 = pack.unpack(st.x)
    return params, z, sigma2, finish(lam), st


def t_predict(
    family, params, z, sigma2, X, y, lam, Xstar, *, nu: float = 4.0,
    variational: bool = False, jitter: float | None = None,
):
    """(mean, latent_var, noise_var) at Xstar from the converged robust
    posterior.  noise_var is the Student-t noise variance
    sigma2 * nu/(nu-2) for nu > 2 (inf otherwise) — add it to latent_var
    for a moment-matched predictive variance; the exact predictive is a
    scale-mixture (heavier-tailed than Gaussian)."""
    from .predict import CoVariancePredictor, MeanPredictor, predict_means, predict_variances

    noise = sigma2 / lam
    model = calc_model(
        family, params, X, z, noise, variational=variational, jitter=jitter
    )
    trained = calc_trained(model, y)
    mu = predict_means(
        family, params, MeanPredictor(z=model.inducing.z, coeffs=trained.coeffs), Xstar
    )
    cvp = CoVariancePredictor(
        z=model.inducing.z, chol_km=model.inducing.chol_km, r_mat=model.r_mat
    )
    var = predict_variances(family, params, cvp, Xstar, 0.0, predictive=False)
    noise_var = jnp.where(
        nu > 2.0, sigma2 * nu / jnp.maximum(nu - 2.0, 1e-12), jnp.inf
    )
    return mu, var, noise_var

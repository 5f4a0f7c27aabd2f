"""Multi-class GP classification: softmax Laplace over the FITC prior.

Extends models/classify.py (binary) to C classes along the standard route
(GPML ch. 3.5, Rasmussen & Williams, Algorithm 3.3): C latent functions
over a SHARED sparse FITC prior (one kernel, one inducing set — the
per-class priors are i.i.d., so the prior factor V, d is computed once),
softmax likelihood, and Laplace at the mode.  The reference is
regression-only (doc/manual/gpr_manual.tex:82); this is an extension in
the same family as the binary classifier.

The softmax Hessian couples classes per data point, W = D - Pi Pi' with
D = diag(pi) stacked and Pi the (Cn, n) stack of diag(pi_c) — singular by
construction (rows of pi sum to 1).  The classical route inverts
(K + W^-1) through per-class E_c = (K_c + D_c^-1)^-1 and the coupling
factor sum_c E_c; with the FITC low-rank structure every E_c apply is an
m-space Woodbury:

  E_c x = q_c x - q_c V R_c^-1 R_c^-T V'(q_c x),   q_c = pi_c/(1 + pi_c d),
  R_c'R_c = I_m + V' diag(q_c) V,

and the coupling solve uses sum_c E_c = diag(Qbar) - G G' with
G = [diag(q_c) V R_c^-1]_c of rank Cm, so (sum_c E_c)^-1 is one (Cm, Cm)
Cholesky — never an n x n object.  The determinant identity used for the
evidence (derived from |A - Pi Pi'| = |A||I - Pi' A^-1 Pi| and
sum_c pi_c = 1, and verified against the dense oracle in
tests/test_classify_multi.py):

  log|I + K W| = sum_c log|I + K_c D_c| + log|sum_c E_c|
  log|I + K_c D_c| = sum_i log1p(pi_ci d_i) + log|R_c'R_c|
  log|sum_c E_c|   = sum_i log(Qbar_i) + log|I_Cm - G' Qbar^-1 G|.

Each Newton step takes the exact concave line maximum along the step
segment (the same free bisection as the binary classifier — Psi is
strictly concave for the softmax likelihood).  Hyper gradients use the
implicit-function-theorem route by default (``softmax_fixed_point``
below — the coupled-W analogue of models/ift.py: the backward is ONE
(I + K W)^-1 apply through the same E/coupling machinery plus one kernel
VJP, instead of retraversing newton_iters remat'ed coupled sweeps);
grad_impl="unroll" keeps the differentiable fixed-step scan.

Cost per Newton step: O(C) (n, m) GEMMs for the per-class factors plus
O(C^2) weighted m x m Grams for the coupling block matrix — all GEMM work;
C is small (classes), m is the inducing count.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..numerics.linalg import (
    cholesky_upper,
    log_det_tri,
    matmul,
    rows_sqr_norm,
    solve_tri,
)
from .classify import _fitc_prior


def _per_class_factors(v, q, allsum):
    """R_c and P_c = V' diag(q_c) V for every class.

    ``q``: (n, C) nonnegative per-class weights (masked rows are 0).
    Returns (r_all, p_all): (C, m, m) stacks.  The class loop is a static
    Python unroll (C is small); each iteration is one weighted Gram.
    """
    m = v.shape[1]
    eye = jnp.eye(m, dtype=v.dtype)
    ps, rs = [], []
    for c in range(q.shape[1]):
        p_c = allsum(matmul((v * q[:, c : c + 1]).T, v))
        p_c = 0.5 * (p_c + p_c.T)
        ps.append(p_c)
        rs.append(cholesky_upper(eye + p_c, jitter=0.0))
    return jnp.stack(rs), jnp.stack(ps)


def _apply_e(v, q, r_all, x, allsum):
    """E_c x_c columnwise for the (n, C) matrix x:
    E_c x = q_c x - q_c V R_c^-1 R_c^-T V'(q_c x)."""
    qx = q * x
    t = allsum(matmul(v.T, qx))  # (m, C)
    t = jax.vmap(
        lambda r, tc: solve_tri(r, solve_tri(r, tc, trans=True)),
        in_axes=(0, 1), out_axes=1,
    )(r_all, t)
    return qx - q * matmul(v, t)


def _coupling_chol(v, q, qbar_inv, r_all, allsum):
    """H = I_Cm - G' diag(Qbar^-1) G with G_c = diag(q_c) V R_c^-1;
    returns its upper Cholesky.  Block (c, c') of G'Qbar^-1 G is
    R_c^-T [V' diag(q_c q_c' / Qbar) V] R_c'^-1 — C(C+1)/2 weighted Grams.
    """
    n_c = q.shape[1]
    m = v.shape[1]
    blocks = [[None] * n_c for _ in range(n_c)]
    for c in range(n_c):
        for c2 in range(c, n_c):
            w = q[:, c] * q[:, c2] * qbar_inv
            g = allsum(matmul((v * w[:, None]).T, v))
            g = solve_tri(r_all[c], g, trans=True)  # R_c^-T g
            g = solve_tri(r_all[c2], g.T, trans=True).T  # g R_c2^-1
            blocks[c][c2] = g
            if c2 != c:
                blocks[c2][c] = g.T
    gqg = jnp.block(blocks)
    h = jnp.eye(n_c * m, dtype=v.dtype) - 0.5 * (gqg + gqg.T)
    return cholesky_upper(h, jitter=0.0)


def _apply_coupling_inv(v, q, qbar_inv, r_all, h_chol, x, allsum):
    """(sum_c E_c)^-1 x = Qbar^-1 x + Qbar^-1 G H^-1 G' Qbar^-1 x."""
    n_c = q.shape[1]
    m = v.shape[1]
    qx = qbar_inv * x
    # G' qx: stack of R_c^-T V'(q_c qx)
    gt = allsum(matmul(v.T, q * qx[:, None]))  # (m, C)
    gt = jax.vmap(lambda r, tc: solve_tri(r, tc, trans=True),
                  in_axes=(0, 1), out_axes=1)(r_all, gt)
    w = gt.T.reshape(n_c * m)  # class-major to match _coupling_chol blocks
    w = solve_tri(h_chol, solve_tri(h_chol, w, trans=True))
    w = w.reshape(n_c, m)
    # G w = sum_c q_c * (V R_c^-1 w_c)
    gw = jax.vmap(lambda r, wc: solve_tri(r, wc))(r_all, w)  # (C, m)
    return qx + qbar_inv * jnp.sum(q * matmul(v, gw.T), axis=1)


def softmax_newton_scan(
    v, d, y_onehot, mask, *, newton_iters: int = 15, allsum=lambda x: x,
):
    """Newton mode-finding for the softmax Laplace over local rows.

    ``y_onehot``: (n, C); ``mask`` zeroes padded rows.  ``allsum`` is the
    cross-row reduction hook (identity on one device, psum on a mesh —
    every cross-row object is an m-vector, m x m matrix, or scalar).
    Returns (f_hat, a): both (n, C) with f_hat = K a columnwise.
    """
    n_c = y_onehot.shape[1]

    def kdot(x):
        return matmul(v, allsum(matmul(v.T, x))) + d[:, None] * x

    def step(carry, _):
        f, a = carry
        pi = jax.nn.softmax(f, axis=1) * mask[:, None]
        q = pi / (1.0 + pi * d[:, None])
        qbar = jnp.sum(q, axis=1)
        qbar_inv = jnp.where(mask > 0, 1.0 / jnp.where(qbar > 0, qbar, 1.0),
                             0.0)
        grad = (y_onehot - pi) * mask[:, None]
        # W f per point: diag(pi) f - pi (pi . f)
        wf = pi * f - pi * jnp.sum(pi * f, axis=1, keepdims=True)
        b = (wf + grad) * mask[:, None]

        r_all, _ = _per_class_factors(v, q, allsum)
        h_chol = _coupling_chol(v, q, qbar_inv, r_all, allsum)

        c_vec = _apply_e(v, q, r_all, kdot(b), allsum)
        t = _apply_coupling_inv(
            v, q, qbar_inv, r_all, h_chol, jnp.sum(c_vec, axis=1), allsum
        )
        a_n = b - c_vec + _apply_e(v, q, r_all, t[:, None], allsum)
        f_n = kdot(a_n)

        # Exact concave line maximum along a_s = (1-s) a + s a_n (same
        # free bisection as the binary classifier: Psi strictly concave,
        # every probe is one elementwise pass over the cached f, f_n)
        aff = allsum(jnp.sum(a * f))
        afn = allsum(jnp.sum(a * f_n))
        ann = allsum(jnp.sum(a_n * f_n))
        df = f_n - f

        def dpsi(s):
            pi_s = jax.nn.softmax(f + s * df, axis=1)
            quad_p = (-2.0 * (1.0 - s) * aff + (2.0 - 4.0 * s) * afn
                      + 2.0 * s * ann)
            lik_p = allsum(jnp.sum(
                mask[:, None] * (y_onehot - pi_s) * df
            ))
            return -0.5 * quad_p + lik_p

        def bis(_, lohi):
            lo, hi = lohi
            mid = 0.5 * (lo + hi)
            pos = dpsi(mid) > 0
            return jnp.where(pos, mid, lo), jnp.where(pos, hi, mid)

        one = jnp.ones((), f.dtype)
        lo, hi = jax.lax.fori_loop(0, 25, bis,
                                   (jnp.zeros((), f.dtype), one))
        s = jnp.where(dpsi(one) >= 0, one, lo)
        a = (1.0 - s) * a + s * a_n
        f = (1.0 - s) * f + s * f_n
        return (f, a), None

    f0 = jnp.zeros_like(y_onehot)
    (f_hat, a), _ = jax.lax.scan(
        jax.checkpoint(step), (f0, jnp.zeros_like(y_onehot)), None,
        length=newton_iters,
    )
    return f_hat, a


def _kdot(v, d, x, allsum):
    return matmul(v, allsum(matmul(v.T, x))) + d[:, None] * x


def _mode_weights(v, d, f_hat, mask, allsum):
    """(pi, q, qbar_inv, r_all, h_chol) at a given latent — the shared
    epilogue/backward factor set."""
    pi = jax.nn.softmax(f_hat, axis=1) * mask[:, None]
    q = pi / (1.0 + pi * d[:, None])
    qbar = jnp.sum(q, axis=1)
    qbar_inv = jnp.where(mask > 0, 1.0 / jnp.where(qbar > 0, qbar, 1.0),
                         0.0)
    r_all, _ = _per_class_factors(v, q, allsum)
    h_chol = _coupling_chol(v, q, qbar_inv, r_all, allsum)
    return pi, q, qbar_inv, r_all, h_chol


def _m_apply(v, q, qbar_inv, r_all, h_chol, x, allsum):
    """M x with M = (K + W^-1)^-1 = E - E 1 (sum_c E_c)^-1 1' E — the
    GPML Alg 3.3 inverse through the FITC low-rank machinery.  Also
    M = W (I + K W)^-1, well-defined despite singular W."""
    ex = _apply_e(v, q, r_all, x, allsum)
    t = _apply_coupling_inv(v, q, qbar_inv, r_all, h_chol,
                            jnp.sum(ex, axis=1), allsum)
    return ex - _apply_e(v, q, r_all, t[:, None], allsum)


@functools.lru_cache(maxsize=None)
def _softmax_fixed_point(allsum, newton_iters):
    """The IFT fixed point for the softmax mode: a(v, d, y1h) with the
    implicit backward (see module docstring).  Built per (allsum,
    newton_iters) pair and cached so the custom_vjp identity is stable
    across traces."""

    @jax.custom_vjp
    def fixed_point(v, d, y1h, mask):
        _, a = softmax_newton_scan(
            v, d, y1h, mask, newton_iters=newton_iters, allsum=allsum,
        )
        return a

    def fwd(v, d, y1h, mask):
        a = fixed_point(v, d, y1h, mask)
        return a, (v, d, y1h, mask, a)

    def bwd(res, abar):
        v, d, y1h, mask, a = res
        f_hat = _kdot(v, d, a, allsum)
        pi, q, qbar_inv, r_all, h_chol = _mode_weights(
            v, d, f_hat, mask, allsum
        )

        def wdot(x):
            # W x per row: diag(pi) x - pi (pi . x), masked
            return (pi * x - pi * jnp.sum(pi * x, axis=1, keepdims=True)
                    ) * mask[:, None]

        def solve(x):
            # (I + K W)^-1 x = x - K M x
            return x - _kdot(
                v, d, _m_apply(v, q, qbar_inv, r_all, h_chol, x, allsum),
                allsum,
            )

        u = solve(abar)
        # one round of iterative refinement (same large-n f32 rationale
        # as the binary core, models/ift.py)
        r = abar - (u + _kdot(v, d, wdot(u), allsum))
        u = u + solve(r)

        # theta_bar = (dF/dtheta)' u with F = g(K a; y1h) - a at fixed a,
        # g = mask (y1h - softmax(K a)): one vjp for (v, d), explicit
        # identity block for y1h
        def h(v_, d_):
            f = _kdot(v_, d_, a, allsum)
            return (y1h - jax.nn.softmax(f, axis=1)) * mask[:, None]

        _, pull = jax.vjp(h, v, d)
        vbar, dbar = pull(u)
        return vbar, dbar, mask[:, None] * u, jnp.zeros_like(mask)

    fixed_point.defvjp(fwd, bwd)
    return fixed_point


def softmax_mode(
    v, d, y_onehot, mask, *, newton_iters: int = 15,
    allsum=lambda x: x, grad_impl: str = "ift",
):
    """(f_hat, a) at the softmax-Laplace mode; grad_impl as in
    models/ift.py ("ift" default, "unroll" the remat'ed scan)."""
    if grad_impl == "ift":
        a = _softmax_fixed_point(allsum, newton_iters)(v, d, y_onehot,
                                                       mask)
        return _kdot(v, d, a, allsum), a
    if grad_impl == "unroll":
        return softmax_newton_scan(
            v, d, y_onehot, mask, newton_iters=newton_iters, allsum=allsum,
        )
    raise ValueError(f"grad_impl must be 'ift' or 'unroll', got {grad_impl}")


def multiclass_laplace_mode(
    family, params, z, X, labels, n_classes: int, *,
    newton_iters: int = 15, jitter: float | None = None,
    grad_impl: str = "ift",
):
    """``labels``: (n,) ints in [0, n_classes).  Returns
    (f_hat, a, inducing, v, d, y_onehot)."""
    inducing, v, d = _fitc_prior(family, params, z, X, jitter)
    y_onehot = jax.nn.one_hot(labels, n_classes, dtype=v.dtype)
    f_hat, a = softmax_mode(
        v, d, y_onehot, jnp.ones(X.shape[0], v.dtype),
        newton_iters=newton_iters, grad_impl=grad_impl,
    )
    return f_hat, a, inducing, v, d, y_onehot


def evidence_from_mode(v, d, f_hat, a, y_onehot, mask, allsum=lambda x: x):
    """The Laplace evidence epilogue over local rows given the mode —
    shared by the single-device and mesh-sharded paths (``allsum`` is the
    cross-row reduction; masked rows contribute exactly nothing)."""
    pi = jax.nn.softmax(f_hat, axis=1) * mask[:, None]
    q = pi / (1.0 + pi * d[:, None])
    qbar = jnp.sum(q, axis=1)
    qbar_inv = jnp.where(mask > 0, 1.0 / jnp.where(qbar > 0, qbar, 1.0),
                         0.0)
    r_all, _ = _per_class_factors(v, q, allsum)
    h_chol = _coupling_chol(v, q, qbar_inv, r_all, allsum)

    log_det = allsum(jnp.sum(jnp.log1p(pi * d[:, None])))
    log_det = log_det + jnp.sum(jax.vmap(log_det_tri)(r_all))
    log_det = log_det + allsum(
        jnp.sum(mask * jnp.log(jnp.where(mask > 0, qbar, 1.0)))
    ) + log_det_tri(h_chol)

    log_lik = allsum(jnp.sum(mask[:, None] * y_onehot * f_hat) - jnp.sum(
        mask * jax.nn.logsumexp(f_hat, axis=1)
    ))
    return -0.5 * allsum(jnp.sum(a * f_hat)) + log_lik - 0.5 * log_det


def multiclass_log_evidence(
    family, params, z, X, labels, n_classes: int, *,
    newton_iters: int = 15, jitter: float | None = None,
    grad_impl: str = "ift",
):
    """Laplace marginal likelihood log q(y | X, hypers), differentiable
    w.r.t. (params, z) — implicit (IFT) gradients by default."""
    f_hat, a, inducing, v, d, y1h = multiclass_laplace_mode(
        family, params, z, X, labels, n_classes,
        newton_iters=newton_iters, jitter=jitter, grad_impl=grad_impl,
    )
    return evidence_from_mode(v, d, f_hat, a, y1h,
                              jnp.ones(X.shape[0], v.dtype))


def multiclass_posterior_state(
    family, params, z, X, labels, n_classes: int, *,
    newton_iters: int = 15, jitter: float | None = None,
):
    """The persistable m-space predictor state of the softmax Laplace —
    every n-sized object is reduced away, so a trained classifier can be
    saved/served with O(C^2 m^2) state (the multi-class analogue of the
    regression artifact's (coeffs, chol_km, r_mat)):

      coeffs  (m, C):   U^-1 V'a      — mu* = K*m coeffs
      a_tilde (C,m,m):  U^-1 (V'E_c V) U^-T
      b_tilde (C,C,m,m): U^-1 (V'E_c (sum E)^-1 E_c' V) U^-T

    so Sigma*_cc' = delta k** - delta k*' a_tilde_c k* + k*' b_tilde_cc' k*
    with the RAW cross-covariance row k* = K(x*, Z).
    Returns (inducing, coeffs, a_tilde, b_tilde).
    """
    f_hat, a, inducing, v, d, _ = multiclass_laplace_mode(
        family, params, z, X, labels, n_classes,
        newton_iters=newton_iters, jitter=jitter,
    )
    pi = jax.nn.softmax(f_hat, axis=1)
    q = pi / (1.0 + pi * d[:, None])
    qbar = jnp.sum(q, axis=1)
    qbar_inv = 1.0 / qbar
    r_all, p_all = _per_class_factors(v, q, lambda x: x)
    h_chol = _coupling_chol(v, q, qbar_inv, r_all, lambda x: x)

    n_c = n_classes
    # A_c = P_c - P_c R_c^-1 R_c^-T P_c
    def a_mat(r_c, p_c):
        t = solve_tri(r_c, solve_tri(r_c, p_c, trans=True))
        return p_c - matmul(p_c, t)

    a_all = jax.vmap(a_mat)(r_all, p_all)  # (C, m, m)

    # F_c = E_c V  (n, m) per class; B_cc' = F_c' (sum E)^-1 F_c'
    def f_mat(c):
        qc = q[:, c : c + 1]
        t = solve_tri(r_all[c],
                      solve_tri(r_all[c], p_all[c], trans=True))
        return qc * v - qc * matmul(v, t)

    f_all = [f_mat(c) for c in range(n_c)]
    # (sum E)^-1 F_c columnwise via the Woodbury apply
    sinv_f = [
        jax.vmap(
            lambda col, c=c: _apply_coupling_inv(
                v, q, qbar_inv, r_all, h_chol, col, lambda x: x
            ),
            in_axes=1, out_axes=1,
        )(f_all[c])
        for c in range(n_c)
    ]
    b_all = jnp.stack([
        jnp.stack([matmul(f_all[c].T, sinv_f[c2]) for c2 in range(n_c)])
        for c in range(n_c)
    ])  # (C, C, m, m)

    u = inducing.chol_km

    def conj(mat):  # U^-1 mat U^-T
        t = solve_tri(u, mat)  # U^-1 mat
        return solve_tri(u, t.T).T

    coeffs = solve_tri(u, matmul(v.T, a))  # (m, C)
    a_tilde = jax.vmap(conj)(a_all)
    b_tilde = jax.vmap(jax.vmap(conj))(b_all)
    return inducing, coeffs, a_tilde, b_tilde


def multiclass_predict_from_state(
    family, params, z, coeffs, a_tilde, b_tilde, Xstar, *,
    n_samples: int = 1024, key=None,
):
    """(probs, mu, sigma) at Xstar from the persistable state — all GEMMs
    on the raw cross-covariance K(X*, Z)."""
    n_c = coeffs.shape[1]
    ktm = family.k_cross(params, Xstar, z)  # (t, m)
    mu = matmul(ktm, coeffs)  # (t, C)
    kss = family.k_diag(params, Xstar)

    quad_a = jnp.einsum("tm,cmk,tk->tc", ktm, a_tilde, ktm)
    quad_b = jnp.einsum("tm,cdmk,tk->tcd", ktm, b_tilde, ktm)
    eye_c = jnp.eye(n_c, dtype=ktm.dtype)
    sigma = (
        kss[:, None, None] * eye_c
        - quad_a[:, :, None] * eye_c
        + quad_b
    )
    # jitter for the per-point Cholesky (PSD up to roundoff)
    sigma = sigma + 1e-10 * kss[:, None, None].mean() * eye_c

    if key is None:
        key = jax.random.PRNGKey(0)
    eps = jax.random.normal(key, (n_samples, n_c), dtype=ktm.dtype)

    def point_probs(mu_t, sig_t):
        r = cholesky_upper(sig_t, jitter=0.0)
        draws = mu_t + matmul(eps, r)
        return jnp.mean(jax.nn.softmax(draws, axis=1), axis=0)

    probs = jax.vmap(point_probs)(mu, sigma)
    return probs, mu, sigma


def multiclass_predict(
    family, params, z, X, labels, n_classes: int, Xstar, *,
    newton_iters: int = 15, jitter: float | None = None,
    n_samples: int = 1024, key=None,
):
    """(probs, mu, sigma) at Xstar.

    Latent posterior per test point is a C-variate Gaussian
    mu_c = v* (V'a_c), Sigma_cc' = delta k** - delta v* A_c v*'
    + v* B_cc' v*' with A_c = V'E_c V and B_cc' = V'E_c (sum E)^-1 E_c' V
    (the FITC test conditional shares one v* across classes).  Class
    probabilities are the MC average of the softmax over ``n_samples``
    joint draws — the C-dimensional logistic-Gaussian integral has no
    closed form (GPML section 3.5 uses the same estimator).
    """
    inducing, coeffs, a_tilde, b_tilde = multiclass_posterior_state(
        family, params, z, X, labels, n_classes,
        newton_iters=newton_iters, jitter=jitter,
    )
    return multiclass_predict_from_state(
        family, params, inducing.z, coeffs, a_tilde, b_tilde, Xstar,
        n_samples=n_samples, key=key,
    )


def fit_classify_multi(
    family, X, labels, pack, n_classes: int, *, newton_iters: int = 15,
    jitter: float | None = None, normalize: bool = True, mesh=None,
    block_size: int | None = None, **fit_kwargs,
):
    """Hyper + inducing training of the softmax Laplace classifier with the
    device L-BFGS (optim.fit_packed_objective conventions).  Build ``pack``
    with ``learn_sigma2=False`` (no Gaussian noise in the likelihood).
    With ``mesh``, X/labels shard over the data axis and the objective is
    parallel.sharded_multiclass_log_evidence.  ``block_size`` streams the
    Newton iteration (models/classify_multi_stream.py) so V never
    materializes — n unbounded per device, composes with ``mesh``.

    Returns ``(params, z, state)``.
    """
    if pack.learn_sigma2:
        raise ValueError(
            "classification has no sigma2: build the pack with "
            "make_pack(..., learn_sigma2=False)"
        )
    from ..optim.lbfgs_device import fit_packed_objective

    scale = 1.0 / X.shape[0] if normalize else 1.0
    if mesh is None:
        if block_size is not None:
            from .classify_multi_stream import (
                stream_multiclass_log_evidence,
            )

        def fg(x, X, labels):
            def f(x):
                params, z, _ = pack.unpack(x)
                if block_size is not None:
                    return -scale * stream_multiclass_log_evidence(
                        family, params, z, X, labels, n_classes,
                        block_size=block_size, newton_iters=newton_iters,
                        jitter=jitter,
                    )
                return -scale * multiclass_log_evidence(
                    family, params, z, X, labels, n_classes,
                    newton_iters=newton_iters, jitter=jitter,
                )

            return jax.value_and_grad(f)(x)

        data = (X, labels)
    else:
        from ..parallel import shard_batch
        from ..parallel.classify_sharded import (
            sharded_multiclass_log_evidence,
        )

        Xs, ls, mask = shard_batch(mesh, X, labels)

        def fg(x, Xs, ls, mask):
            def f(x):
                params, z, _ = pack.unpack(x)
                return -scale * sharded_multiclass_log_evidence(
                    family, mesh, params, z, Xs, ls, n_classes, mask,
                    newton_iters=newton_iters, jitter=jitter,
                    block_size=block_size,
                )

            return jax.value_and_grad(f)(x)

        data = (Xs, ls, mask)

    st = fit_packed_objective(fg, pack, data, **fit_kwargs)
    params, z, _ = pack.unpack(st.x)
    return params, z, st

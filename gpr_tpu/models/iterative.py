"""Iterative exact GP: Nyström/FITC-preconditioned conjugate gradients.

``models/exact.py`` ends at the dense-Cholesky ceiling: K is O(n^2) device memory
and ``potrf`` is a serial panel factorization, so n ~ 20k is the practical
single-device limit.  This module extends EXACT inference past that point
with GEMMs:

  * ``A v = (K + sigma2 I) v`` is computed in row blocks by a ``lax.scan``
    that forms each ``K(X_block, X)`` tile with one ``k_cross`` GEMM
    and folds it into the product immediately — K is never materialized, so
    memory is O(n * block) transient and O(n * rhs) persistent, and every
    flop is a GEMM (the op the hardware is built for, unlike potrf's
    serial panel factorization).
  * The solves use batched preconditioned CG.  The preconditioner is the
    FITC approximation itself — P = D + V V' with V = Knm U^-1 (whitened
    cross-covariance against m inducing points) and D = diag(lambda) +
    sigma2 — applied in O(nm) by Woodbury.  The better the sparse model
    already is, the fewer CG iterations exact inference needs: the sparse
    engine IS the preconditioner (Gardner et al. 2018; Wang et al. 2019
    use the same structure with a partial-pivoted-Cholesky P).

No counterpart in the reference (sparse-only, lib/fitc_gp.ml); this is an
extension in the same sense as models/exact.py, with that module as its
small-n correctness oracle (tests/test_iterative.py pins matvec, solve,
means and variances against the dense path for several kernel families).

Scope: posterior inference (mean coefficients, predictions, variances) at
large n, plus UNBIASED stochastic gradients of the exact log evidence
(Hutchinson probes through the same batched solve) for SGD-style
hyperparameter training.  The evidence VALUE at large n is deliberately not
estimated (stochastic Lanczos quadrature is noisy exactly where training
needs it most); train hyperparameters on the sparse objectives or on
``evidence_grads_iter``, then predict exactly here.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from ..kernels.base import cross_inputs
from ..numerics.linalg import (
    cholesky_upper,
    inv_tri_upper,
    matmul,
    rows_sqr_norm,
    solve_tri,
)
from ..tree import pytree_dataclass


def _pad_rows(X, block_size):
    n = X.shape[0]
    nb = -(-n // block_size)
    pad = nb * block_size - n
    if pad:
        X = jnp.concatenate([X, jnp.zeros((pad, X.shape[1]), X.dtype)])
    return X.reshape(nb, block_size, X.shape[1]), pad


def kernel_matvec(
    family, params, X, V, sigma2, *, block_size: int = 4096
) -> jnp.ndarray:
    """(K(X, X) + sigma2 I) @ V without materializing K.

    V may be (n,) or (n, r).  Each scan step forms one (block, n) tile with
    ``k_cross`` and contracts it against V in a GEMM.  The diagonal is
    corrected to ``k_diag`` (the model's prior variances) so the operator
    matches ``exact.calc_exact``'s dense A for every family, including those
    whose pointwise variance differs from the cross form (se_fat
    heteroskedasticity).
    """
    squeeze = V.ndim == 1
    if squeeze:
        V = V[:, None]
    xb, _ = _pad_rows(X, block_size)

    def step(_, x_blk):
        tile = cross_inputs(family, params, x_blk, X)  # (block, n)
        return None, matmul(tile, V)

    # remat: reverse mode otherwise saves every (block, n) tile — at
    # n=100k block=8192 that is a 42.6 GB stacked residual and the
    # evidence_grads_iter jit fails AOT allocation (measured);
    # recomputing the tile in the backward is the same trade the
    # streaming engine makes everywhere
    _, out = lax.scan(jax.checkpoint(step), None, xb)
    out = out.reshape(-1, V.shape[1])[: X.shape[0]]
    # diag correction: the tile rows put the cross form's self-value on the
    # diagonal; the exact model's operator has k_diag(x_i) + sigma2 there
    # (k_upper_inputs forces its diagonal to the prior variances).
    cross_self = jax.vmap(
        lambda x: cross_inputs(family, params, x[None, :], x[None, :])[0, 0]
    )(X)
    out = out + (
        family.k_diag(params, X) - cross_self + sigma2
    )[:, None] * V
    return out[:, 0] if squeeze else out


# ---------------------------------------------------------------------------
# Preconditioner
# ---------------------------------------------------------------------------


@pytree_dataclass
class NystromPrecond:
    """P = diag(d) + v v' applied by Woodbury in O(n m) per rhs.

    d = lambda + sigma2 (the FITC per-row residual variances), v = Knm U^-1
    whitened against an m-row SUBSET of the data (Nystrom on the data-side
    kernel).  P is exactly a FITC prior covariance + noise — i.e. a matrix
    the sparse engine's evidence inverts in closed form; the better the
    low-rank model fits, the tighter P approximates A and the fewer CG
    iterations the exact solve needs.
    """

    v: jnp.ndarray  # (n, m) whitened cross-covariance
    d: jnp.ndarray  # (n,)   lambda + sigma2 > 0
    chol_c: jnp.ndarray  # (m, m) upper, C = I + v' diag(1/d) v

    def apply(self, r):
        """P^-1 r for r of shape (n,) or (n, r)."""
        squeeze = r.ndim == 1
        if squeeze:
            r = r[:, None]
        rd = r / self.d[:, None]
        w = matmul(self.v.T, rd)  # (m, r)
        w = solve_tri(self.chol_c, solve_tri(self.chol_c, w, trans=True))
        out = rd - matmul(self.v, w) / self.d[:, None]
        return out[:, 0] if squeeze else out


def nystrom_precond(family, params, X, sigma2, X_sub) -> NystromPrecond:
    """Build the Nystrom/FITC preconditioner anchored at the data rows
    ``X_sub`` ((m, d), usually a random subset of X).  Everything is the
    DATA-side kernel (``cross_inputs``/``k_upper_inputs``) so P approximates
    the same operator ``kernel_matvec`` applies for every family."""
    km = family.k_upper_inputs(params, X_sub)
    u_inv = inv_tri_upper(cholesky_upper(km, None))
    knm = cross_inputs(family, params, X, X_sub)
    v = matmul(knm, u_inv)  # (n, m)
    lam = jnp.maximum(family.k_diag(params, X) - rows_sqr_norm(v), 0.0)
    d = lam + sigma2
    vd = v / d[:, None]
    c = jnp.eye(v.shape[1], dtype=v.dtype) + matmul(v.T, vd)
    return NystromPrecond(v=v, d=d, chol_c=cholesky_upper(c, 0.0))


# ---------------------------------------------------------------------------
# Batched preconditioned CG
# ---------------------------------------------------------------------------


def pcg(
    matvec,
    b,
    *,
    precond=None,
    tol: float = 1e-6,
    max_iter: int = 200,
    colsum=None,
    replace_every: int | None = 50,
):
    """Batched preconditioned conjugate gradients for SPD systems.

    Solves ``A x = b`` for every column of ``b`` ((n,) or (n, r)) in one
    fused iteration (each step is ONE blocked matvec over all columns — the
    batching is what makes CG GEMM-friendly: rank-r GEMMs instead of r
    matvecs).  Stops when every column's relative residual is below ``tol``
    or at ``max_iter``.  Returns ``(x, info)`` with
    ``info = {"iters": k, "relres": (r,)}``.

    ``precond`` may be an object with ``.apply`` (NystromPrecond) or a
    plain callable r -> P^-1 r.  ``colsum`` is the per-column reduction
    over the row axis — override with a psum'ed sum under shard_map
    (parallel/iter_sharded.py); default is the local sum.

    ``replace_every`` applies Van der Vorst residual replacement: every
    that-many iterations the recursive residual is recomputed as
    ``b - matvec(x)``.  In f32 the recursively-updated r drifts from the
    true residual once the per-matvec rounding noise (~lambda_max * eps)
    reaches the residual scale — measured at n >= 50k as "relres"
    climbing past 1 while the true error stayed bounded.  The
    reported final relres is always recomputed from the TRUE residual
    (one extra matvec), so convergence claims are honest at any precision.
    """
    squeeze = b.ndim == 1
    if squeeze:
        b = b[:, None]
    if precond is None:
        pre = lambda r: r  # noqa: E731
    else:
        pre = precond.apply if hasattr(precond, "apply") else precond
    if colsum is None:
        colsum = lambda t: jnp.sum(t, axis=0)  # noqa: E731
    bnorm = jnp.sqrt(jnp.maximum(colsum(b * b), 1e-60))

    x0 = jnp.zeros_like(b)
    r0 = b
    z0 = pre(r0)
    rz0 = colsum(r0 * z0)

    def cond(state):
        k, _, r, _, _, _ = state
        relres = jnp.sqrt(colsum(r * r)) / bnorm
        return (k < max_iter) & (jnp.max(relres) > tol)

    def body(state):
        k, x, r, z, p, rz = state
        ap = matvec(p)
        pap = colsum(p * ap)
        alpha = jnp.where(pap > 0, rz / jnp.maximum(pap, 1e-30), 0.0)
        x = x + alpha * p
        r = r - alpha * ap
        if replace_every:
            # re-sync the recursive residual with the true one (keeps the
            # search direction: Van der Vorst replacement, not a restart)
            r = lax.cond(
                (k + 1) % replace_every == 0,
                lambda x, r: b - matvec(x),
                lambda x, r: r,
                x, r,
            )
        z = pre(r)
        rz_new = colsum(r * z)
        beta = jnp.where(rz > 0, rz_new / jnp.maximum(rz, 1e-30), 0.0)
        p = z + beta * p
        return k + 1, x, r, z, p, rz_new

    k, x, r, _, _, _ = lax.while_loop(
        cond, body, (jnp.asarray(0), x0, r0, z0, z0, rz0)
    )
    r_true = b - matvec(x)
    relres = jnp.sqrt(colsum(r_true * r_true)) / bnorm
    info = {"iters": k, "relres": relres}
    return (x[:, 0] if squeeze else x), info


# ---------------------------------------------------------------------------
# Model surface (mirrors exact.py)
# ---------------------------------------------------------------------------


@pytree_dataclass
class IterTrained:
    """Posterior coefficients of the exact GP, solved iteratively."""

    z: jnp.ndarray  # (n, dz) training inputs in inducing representation
    sigma2: jnp.ndarray
    alpha: jnp.ndarray  # (n,) (K + sigma2 I)^-1 y
    iters: jnp.ndarray
    relres: jnp.ndarray


def iter_trained(
    family,
    params,
    X,
    y,
    sigma2,
    *,
    n_inducing: int = 256,
    X_sub=None,
    key=None,
    tol: float = 1e-6,
    max_iter: int = 200,
    block_size: int = 4096,
) -> IterTrained:
    """Solve alpha = (K + sigma2 I)^-1 y by Nystrom-preconditioned CG.

    ``X_sub`` ((m, d) anchor rows) overrides ``n_inducing``/``key``; by
    default m = n_inducing rows of X are drawn with the engine's standard
    random-subset rule.
    """
    if X_sub is None:
        if key is None:
            key = jax.random.PRNGKey(0)
        idx = jax.random.choice(
            key, X.shape[0], (min(n_inducing, X.shape[0]),), replace=False
        )
        X_sub = X[idx]
    pre = nystrom_precond(family, params, X, sigma2, X_sub)

    def mv(v):
        return kernel_matvec(
            family, params, X, v, sigma2, block_size=block_size
        )

    alpha, info = pcg(mv, y, precond=pre, tol=tol, max_iter=max_iter)
    return IterTrained(
        z=family.inducing_from_inputs(params, X),
        sigma2=jnp.asarray(sigma2, dtype=alpha.dtype),
        alpha=alpha,
        iters=info["iters"],
        relres=jnp.max(info["relres"]),
    )


def predict_means_iter(
    family, params, trained: IterTrained, Xs, *, block_size: int = 4096
) -> jnp.ndarray:
    """k(X*, X) alpha, blocked over test rows."""
    xb, _ = _pad_rows(Xs, block_size)

    def step(_, xs_blk):
        tile = family.k_cross(params, xs_blk, trained.z)
        return None, matmul(tile, trained.alpha)

    _, mu = lax.scan(step, None, xb)
    return mu.reshape(-1)[: Xs.shape[0]]


def predict_variances_iter(
    family,
    params,
    trained: IterTrained,
    X,
    Xs,
    *,
    predictive: bool = True,
    precond: NystromPrecond | None = None,
    tol: float = 1e-4,
    max_iter: int = 200,
    block_size: int = 4096,
):
    """Pointwise posterior variance: k*(x) - k*' A^-1 k*, each test column
    solved by the same batched PCG.  O(n) per test point — batch Xs
    accordingly (a few hundred to a few thousand columns per call).
    Returns (var, info)."""
    ks = family.k_cross(params, Xs, trained.z).T  # (n, n*)
    if precond is None:
        pre = None
    else:
        pre = precond

    def mv(v):
        return kernel_matvec(
            family, params, X, v, trained.sigma2, block_size=block_size
        )

    w, info = pcg(mv, ks, precond=pre, tol=tol, max_iter=max_iter)
    var = family.k_diag(params, Xs) - jnp.sum(ks * w, axis=0)
    var = jnp.maximum(var, 0.0)
    if predictive:
        var = var + trained.sigma2
    return var, info


# ---------------------------------------------------------------------------
# Stochastic exact-evidence gradients (training at large n)
# ---------------------------------------------------------------------------


def evidence_grads_iter(
    family,
    params,
    X,
    y,
    sigma2,
    key,
    *,
    n_probes: int = 8,
    n_inducing: int = 256,
    tol: float = 1e-4,
    max_iter: int = 200,
    block_size: int = 4096,
):
    """Unbiased stochastic gradient of the NEGATIVE exact log evidence
    w.r.t. (params, sigma2).

    d(-log Z) = 1/2 (trace(A^-1 dA) - alpha' dA alpha),  alpha = A^-1 y.
    The alpha term is exact (one PCG solve).  The trace uses the
    preconditioner as a CONTROL VARIATE:

        trace(A^-1 dA) = trace(M dA) + E_z[((A^-1 - M) z)' dA z],
        M = P^-1 (fixed / stop-gradiented)

    where trace(M dA) is computed deterministically through M's
    diag-plus-low-rank structure (one extra m-column matvec) and only the
    small residual is Hutchinson-estimated with ``n_probes`` Rademacher
    probes — since P ~ A, the residual variance is a tiny fraction of the
    plain estimator's (the Gardner et al. 2018 / Wang et al. 2019 recipe).
    One batched PCG solve against [y, z_1..z_p] produces alpha and all
    whitened probes; the gradient falls out of jax.grad of a linear
    surrogate in A(theta).

    Returns ``((g_params, g_sigma2), info)``.
    """
    n = X.shape[0]
    probes = jax.random.rademacher(key, (n, n_probes), dtype=X.dtype)

    idx = jax.random.choice(
        jax.random.fold_in(key, 1), n,
        (min(n_inducing, n),), replace=False,
    )
    pre = nystrom_precond(family, params, X, sigma2, X[idx])

    def mv(v):
        return kernel_matvec(
            family, params, X, v, sigma2, block_size=block_size
        )

    b = jnp.concatenate([y[:, None], probes], axis=1)
    sol, info = pcg(mv, b, precond=pre, tol=tol, max_iter=max_iter)
    alpha = lax.stop_gradient(sol[:, 0])
    w = lax.stop_gradient(sol[:, 1:])

    # Fixed M = P^-1 = D^-1 - Vd C^-1 Vd' with Vd = D^-1 v (all stop-grad).
    pre_sg = jax.tree.map(lax.stop_gradient, pre)
    vd = pre_sg.v / pre_sg.d[:, None]  # (n, m)
    resid = w - pre_sg.apply(probes)  # (A^-1 - M) z, stop-grad

    def surrogate(params, sigma2):
        a_probes = kernel_matvec(
            family, params, X, probes, sigma2, block_size=block_size
        )
        a_alpha = kernel_matvec(
            family, params, X, alpha, sigma2, block_size=block_size
        )
        # trace(M A): diag part sum_i A_ii / d_i (the operator's diagonal
        # is k_diag + sigma2 by construction) minus the low-rank part
        # trace(C^-1 Vd' A Vd).
        a_vd = kernel_matvec(
            family, params, X, vd, sigma2, block_size=block_size
        )
        tr_diag = jnp.sum(
            (family.k_diag(params, X) + sigma2) / pre_sg.d
        )
        s = matmul(vd.T, a_vd)  # (m, m)
        tr_lowrank = jnp.trace(
            solve_tri(pre_sg.chol_c,
                      solve_tri(pre_sg.chol_c, s, trans=True))
        )
        tr_resid = jnp.mean(jnp.sum(resid * a_probes, axis=0))
        tr_est = tr_diag - tr_lowrank + tr_resid
        return 0.5 * (tr_est - jnp.dot(alpha, a_alpha))

    grads = jax.grad(surrogate, argnums=(0, 1))(
        params, jnp.asarray(sigma2, dtype=X.dtype)
    )
    return grads, info


def fit_iter(
    family,
    params0,
    X,
    y,
    sigma2_0,
    *,
    key,
    n_steps: int = 100,
    eta0: float = 0.1,
    tau: float = 100.0,
    n_probes: int = 8,
    n_inducing: int = 256,
    tol: float = 1e-3,
    max_iter: int = 200,
    block_size: int = 4096,
    clip: float = 1.0,
    callback=None,
):
    """SGD on the exact evidence at large n — stochastic gradients from
    ``evidence_grads_iter`` (fresh probes per step), the reference SGD's
    decaying rate eta_k = eta0 tau/(tau+k) and log-space sigma2 update
    (lib/fitc_gp.ml:1737-1826), gradients normalized by n (mean-NLL
    scale) so eta0 is shape-independent.  Normalized per-coordinate
    gradients are clipped to ``clip`` (log-space hyperparameters diverge
    fast once a step overshoots into a degenerate basin — the clip bounds
    any single move to eta0*clip in log units).  Host loop: each step is
    one batched PCG solve + one differentiated matvec pass on device.

    Returns ``(params, sigma2)``.  ``callback(step, params, sigma2, info)``
    if given (e.g. to log relres or evaluate a validation set).
    """
    n = X.shape[0]
    params = params0
    sigma2 = jnp.asarray(sigma2_0, dtype=X.dtype)

    # One jitted gradient step; X/y are jit OPERANDS (embedded-constant
    # rule, see CLAUDE.md) so the same executable serves every step.
    @jax.jit
    def step_grads(params, sigma2, key, X, y):
        return evidence_grads_iter(
            family, params, X, y, sigma2, key,
            n_probes=n_probes, n_inducing=n_inducing, tol=tol,
            max_iter=max_iter, block_size=block_size,
        )

    for step in range(n_steps):
        (gp, gs), info = step_grads(
            params, sigma2, jax.random.fold_in(key, step), X, y
        )
        eta = eta0 * tau / (tau + step)
        clip_g = lambda g: jnp.clip(g / n, -clip, clip)  # noqa: E731
        params = jax.tree.map(
            lambda p, g: p - eta * clip_g(g), params, gp
        )
        # descent in log space keeps sigma2 positive:
        # d(-logZ)/d log s2 = s2 * d(-logZ)/d s2
        sigma2 = sigma2 * jnp.exp(-eta * clip_g(gs * sigma2))
        if callback is not None:
            callback(step, params, sigma2, info)
    return params, sigma2

"""Implicit-function-theorem gradients for the Laplace fixed point.

Every non-Gaussian likelihood in this package (logit/probit binary,
Poisson, negative binomial, binomial, ordinal, softmax) trains by
maximizing the Laplace evidence at the Newton mode f_hat of

  psi(f) = log p(y | f) - 0.5 f' K^-1 f,       K = V V' + diag(d).

Through round 4 the hyper gradient came from jax.grad THROUGH the
unrolled Newton iteration (8-20 remat'ed sweeps): correct at a converged
mode, but the reverse pass retraverses every sweep, 35-85x the cost of a
regression evidence+gradient at the 1M bench shape (BENCH_r04.json at
commit b587de6).

This module replaces that with the standard implicit gradient
(GPML section 5.5.1, Rasmussen & Williams 2006): the mode satisfies the
stationarity condition

  F(a; theta) = g(K(theta) a; theta) - a = 0,      g = d log p / df,

(a = K^-1 f_hat the natural parameterization — every family's Newton
already iterates on it), so by the implicit function theorem the VJP of
a(theta) with cotangent abar is

  theta_bar = (dF/dtheta)' u,      u = (I + K W)^-1 abar,

with W = -d2 log p / df2 >= 0 diagonal.  (I + K W)^-1 collapses through
the FITC low-rank structure exactly like a Newton step:

  (I + K W)^-1 x = x - K sqrt(W) B^-1 sqrt(W) x,   B = I + sqrt(W) K sqrt(W),

one m x m Cholesky + two (n, m) GEMMs — and (dF/dtheta)' u is ONE
ordinary jax.vjp of theta -> g(K(theta) a_fix; theta) at a held fixed.
Total backward cost: ~one Newton step instead of newton_iters of them,
and no per-sweep residuals are stored.

The forward Newton runs inside jax.custom_vjp, so it needs no remat and
its iterates are never differentiated; evidence VALUES are bit-identical
to the unrolled path (same forward), only the gradient route changes.
Gradient agreement with the unrolled path is at the mode-convergence
tolerance — the per-family FD oracles in tests/ gate both.

Reference: the reference is regression-only (doc/manual/gpr_manual.tex:82);
its hand-derived Gaussian gradients are lib/fitc_gp.ml:853-2278.  This is
the non-Gaussian analogue of that hand-derivation, done once for every
likelihood via AD + IFT instead of per-formula.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..numerics.linalg import (
    cholesky_upper,
    log_det_tri,
    matmul,
    solve_tri,
)


def _identity(x):
    return x


def fitc_kdot(v, d, x, allsum=_identity):
    """K x with K = V V' + diag(d); ``allsum`` reduces the m-vector over
    row shards (identity on one device, lax.psum under shard_map)."""
    return matmul(v, allsum(matmul(v.T, x))) + d * x


def make_binv(v, d, w, mask, allsum=_identity):
    """(binv, sw): apply B^-1 with B = I + sqrt(W) K sqrt(W) via the m x m
    Woodbury factor.  ``w`` must already be floored/masked (>= 0, exactly
    0 on masked rows); the double-where gate keeps sqrt cotangents finite
    on those rows (CLAUDE.md rule)."""
    sw = mask * jnp.sqrt(jnp.where(w > 0.0, w, 1.0))
    e = 1.0 / (1.0 + w * d)
    se = jnp.sqrt(e)
    vw = v * (sw * se)[:, None]
    mm = jnp.eye(v.shape[1], dtype=v.dtype) + allsum(matmul(vw.T, vw))
    rm = cholesky_upper(mm, jitter=0.0)

    def binv(x):
        t = solve_tri(rm, allsum(matmul(vw.T, se * x)), trans=True)
        return e * x - se * matmul(vw, solve_tri(rm, t))

    return binv, sw, rm


def newton_scan_generic(
    parts, v, d, lik, mask, *, newton_iters: int, allsum=_identity,
    remat: bool = True,
):
    """The shared stabilized-Newton scaffold over local rows (GPML alg 3.1
    with the m-space Woodbury solve, one round of iterative refinement,
    and the exact concave line maximum — measured rationale in
    models/classify.py).  ``parts(f, lik, mask) -> (grad, W)`` supplies
    the likelihood; W is floored at 1e-12 and re-masked here.  Returns
    (f_hat, a).  ``remat=False`` skips per-step checkpointing (right when
    the caller never differentiates through the iterates, e.g. under the
    IFT custom_vjp)."""

    def kdot(x):
        return fitc_kdot(v, d, x, allsum)

    def step(carry, _):
        f, a = carry
        grad, w = parts(f, lik, mask)
        w = mask * jnp.maximum(w, 1e-12)
        b = w * f + grad
        kb = kdot(b)
        binv, sw, _ = make_binv(v, d, w, mask, allsum)
        c = sw * kb

        atil = binv(c)
        a_n = b - sw * atil
        f_n = kdot(a_n)
        # One round of iterative refinement on B atil = sw K b: along B's
        # top subspace a_n = b - sw atil cancels ~cond(B) digits, and at
        # n ~ 1e6 in f32 the GEMM-reduction noise (~sqrt(n) ulp) times
        # cond(B) ~ n |v|^2 wrecks the Newton direction outright
        # (measured at the 1M bench shape: |f_n| ~ 78 and not even an
        # ascent direction; fine at 2e5).  The residual is FREE up to
        # elementwise work — B atil - sw K b = -(sw K a_n - atil) and
        # f_n = K a_n is already computed — so one refinement costs one
        # extra m-space solve plus one K-apply.
        atil = atil + binv(sw * f_n - atil)
        a_n = b - sw * atil
        f_n = kdot(a_n)

        # Damped step: the raw Newton point overshoots and oscillates on
        # large-n near-saturated likelihoods (floored W and K row sums of
        # O(n |v|^2) make the first step's magnitude ~1e5 at the 1M bench
        # shape — measured).  Psi(a) = -0.5 a'Ka + loglik(Ka) is strictly
        # concave and along a_s = (1-s) a + s a_n both terms are
        # elementwise in the cached (f, f_n) (three dots for the quadratic
        # — K-symmetry gives a'f_n = a_n'f), so 25 bisections on dPsi/ds
        # find the exact line maximum down to s ~ 3e-8, each probe ONE
        # elementwise pass, no GEMMs; the iteration is monotone.
        aff = allsum(jnp.sum(a * f))
        afn = allsum(jnp.sum(a * f_n))
        ann = allsum(jnp.sum(a_n * f_n))
        df = f_n - f

        def dpsi(s):
            g_s, _ = parts(f + s * df, lik, mask)  # unused W is DCE'd
            quad_p = (-2.0 * (1.0 - s) * aff + (2.0 - 4.0 * s) * afn
                      + 2.0 * s * ann)
            return -0.5 * quad_p + allsum(jnp.sum(g_s * df))

        def bis(_, lohi):
            lo, hi = lohi
            mid = 0.5 * (lo + hi)
            pos = dpsi(mid) > 0
            return jnp.where(pos, mid, lo), jnp.where(pos, hi, mid)

        one = jnp.ones((), f.dtype)
        lo, _ = jax.lax.fori_loop(0, 25, bis,
                                  (jnp.zeros((), f.dtype), one))
        s = jnp.where(dpsi(one) >= 0, one, lo)
        a = (1.0 - s) * a + s * a_n
        f = (1.0 - s) * f + s * f_n
        return (f, a), None

    f0 = jnp.zeros_like(mask)
    body = jax.checkpoint(step) if remat else step
    (f_hat, a), _ = jax.lax.scan(
        body, (f0, jnp.zeros_like(mask)), None, length=newton_iters
    )
    return f_hat, a


def _zero_cotangent(x):
    """A cotangent of the right type for a non-differentiated primal:
    float0 for integer/bool leaves (what JAX expects), zeros otherwise."""
    if jnp.issubdtype(jnp.asarray(x).dtype, jnp.inexact):
        return jnp.zeros_like(x)
    return np.zeros(jnp.shape(x), jax.dtypes.float0)


@partial(jax.custom_vjp, nondiff_argnums=(0, 1, 2))
def laplace_fixed_point(parts, allsum, newton_iters, v, d, lik, mask):
    """a(v, d, lik) at the Laplace mode, with IFT gradients (module
    docstring).  ``parts``/``allsum`` must be hashable statics (module
    functions or stable partials); ``lik`` is the family's likelihood
    pytree — float leaves get implicit gradients, integer leaves (labels)
    get float0."""
    _, a = newton_scan_generic(
        parts, v, d, lik, mask, newton_iters=newton_iters, allsum=allsum,
        remat=False,
    )
    return a


def _fp_fwd(parts, allsum, newton_iters, v, d, lik, mask):
    a = laplace_fixed_point(parts, allsum, newton_iters, v, d, lik, mask)
    return a, (v, d, lik, mask, a)


def _fp_bwd(parts, allsum, newton_iters, res, abar):
    v, d, lik, mask, a = res
    f_hat = fitc_kdot(v, d, a, allsum)
    _, w = parts(f_hat, lik, mask)
    w = mask * jnp.maximum(w, 1e-12)
    binv, sw, _ = make_binv(v, d, w, mask, allsum)

    def solve(x):
        # (I + K W)^-1 x = x - K sw B^-1 sw x
        return x - fitc_kdot(v, d, sw * binv(sw * x), allsum)

    u = solve(abar)
    # one round of iterative refinement, same rationale as the forward:
    # the solve shares B's conditioning and large-n f32 needs the residual
    r = abar - (u + fitc_kdot(v, d, w * u, allsum))
    u = u + solve(r)

    # theta_bar = (dF/dtheta)' u with F = g(K(theta) a; lik) - a at fixed a
    # — one ordinary vjp.  Integer lik leaves (labels) are closed over.
    leaves, treedef = jax.tree.flatten(lik)
    is_diff = [jnp.issubdtype(jnp.asarray(l).dtype, jnp.inexact)
               for l in leaves]
    diff_leaves = [l for l, ok in zip(leaves, is_diff) if ok]

    def h(v_, d_, diff_):
        it = iter(diff_)
        full = [next(it) if ok else l for l, ok in zip(leaves, is_diff)]
        lik_ = jax.tree.unflatten(treedef, full)
        g, _ = parts(fitc_kdot(v_, d_, a, allsum), lik_, mask)
        return g

    _, pull = jax.vjp(h, v, d, diff_leaves)
    vbar, dbar, diff_bars = pull(u)
    it = iter(diff_bars)
    lik_bar = jax.tree.unflatten(
        treedef,
        [next(it) if ok else _zero_cotangent(l)
         for l, ok in zip(leaves, is_diff)],
    )
    return vbar, dbar, lik_bar, jnp.zeros_like(mask)


laplace_fixed_point.defvjp(_fp_fwd, _fp_bwd)


def laplace_mode_generic(
    parts, v, d, lik, mask, *, newton_iters: int, allsum=_identity,
    grad_impl: str = "ift",
):
    """(f_hat, a) at the mode.  ``grad_impl``:

    - "ift" (default): the custom_vjp fixed point above — reverse cost of
      ~one Newton step, exact implicit gradient at the converged mode.
    - "unroll": jax.grad through the remat'ed iteration (the round-1..4
      route) — kept as the comparison/fallback path.
    """
    if grad_impl == "ift":
        a = laplace_fixed_point(parts, allsum, newton_iters, v, d, lik,
                                mask)
        return fitc_kdot(v, d, a, allsum), a
    if grad_impl == "unroll":
        return newton_scan_generic(
            parts, v, d, lik, mask, newton_iters=newton_iters,
            allsum=allsum, remat=True,
        )
    raise ValueError(f"grad_impl must be 'ift' or 'unroll', got {grad_impl}")


def laplace_evidence_core(
    parts, loglik, v, d, lik, mask, *, newton_iters: int, allsum=_identity,
    grad_impl: str = "ift",
):
    """The Laplace marginal likelihood (GPML eq. 3.32) over the FITC prior
    for any log-concave likelihood: -0.5 a'f + sum log p(y|f) - 0.5 log|B|
    with every n x n object eliminated through the low-rank structure.
    ``loglik(f, lik) -> per-row log p`` (masked rows multiplied out here).
    Differentiable w.r.t. (v, d, float lik leaves) by ``grad_impl``."""
    f_hat, a = laplace_mode_generic(
        parts, v, d, lik, mask, newton_iters=newton_iters, allsum=allsum,
        grad_impl=grad_impl,
    )
    _, w = parts(f_hat, lik, mask)
    w = mask * jnp.maximum(w, 1e-12)
    _, _, rm = make_binv(v, d, w, mask, allsum)
    log_det_b = allsum(jnp.sum(jnp.log1p(w * d))) + log_det_tri(rm)
    log_lik = allsum(jnp.sum(mask * loglik(f_hat, lik)))
    return (-0.5 * allsum(jnp.dot(a, f_hat)) + log_lik - 0.5 * log_det_b)

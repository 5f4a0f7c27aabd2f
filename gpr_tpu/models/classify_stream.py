"""Streaming (blockwise) Laplace classification: unbounded n.

The materialized classifier (models/classify.py) holds V = Knm U^-1 at
(n, m) — 1.2 GB f32 at the 1M x 300 bench shape, which bounds n by device
memory (~3e6 rows on a 16 GB card).  Here V never materializes: every V-involving product
in the Newton step runs as a lax.scan over row blocks that recomputes the
Knm tile (the same tile-and-discard structure as the regression
streaming evidence, models/streaming.py), so resident memory is a handful
of (n,) vectors plus one (block, m) tile.

The Newton step's data-dependency order packs into SIX sweeps (each one
kernel tile eval + 1-2 block GEMMs; the materialized step is one eval +
~7 GEMMs, so streaming costs ~3x the passes — the price of unbounding n):

  1. accumulate V'b and the Woodbury Gram (Vw)'(Vw)
  2. rows Kb = V(V'b) + d b; accumulate Vw'(sqrt(e) c),  c = sw Kb
  3. rows atil = e c - sqrt(e) Vw s1 and a_n = b - sw atil; accumulate V'a_n
  4. rows f_n = V(V'a_n) + d a_n; accumulate the refinement residual
     Vw'(sqrt(e)(sw f_n - atil))
  5. rows of the refined atil/a_n; accumulate V'a_n (refined)
  6. rows of the refined f_n

The exact concave line maximum (25 bisections on dPsi/ds) is elementwise
in the cached (f, f_n) — no sweeps.  The math is identical to
classify.newton_scan step for step (including the one round of iterative
refinement that large-n f32 needs); the parity tests assert evidence and
gradients match the materialized path to roundoff.

``allsum`` is the cross-row reduction hook: identity on one device,
lax.psum under shard_map — every accumulator is an m-vector, m x m
matrix, or scalar, so the sharded streaming path composes exactly
(parallel/classify_sharded.py passes block_size through).

Reference contrast: the reference is regression-only and single-process
(doc/manual/gpr_manual.tex:82); both the classifier and its scale-out are
extensions.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..numerics.linalg import (
    cholesky_upper,
    inv_tri_upper,
    log_det_tri,
    matmul,
    rows_sqr_norm,
    solve_tri,
)
from .fitc import calc_inducing
from .streaming import _pad_blocks


def _log_sigmoid(t):
    return -jnp.logaddexp(0.0, -t)


def _make_sweep(family, params, z, u_inv, xb, allsum):
    """sweep(body, acc0, *row_args) -> (summed accumulators, row outputs).

    ``body(v_i, *block_slices) -> (row_out, acc_contrib)`` sees the V tile
    of one row block; the scan accumulates the contributions (then one
    ``allsum`` over the data axis) and stacks the row outputs.  The body is
    rematerialized in reverse mode, so AD never stores tiles.
    """

    def sweep(body, acc0, *row_args):
        def step(acc, blk):
            x_i, rest = blk[0], blk[1:]
            v_i = matmul(family.k_cross(params, x_i, z), u_inv)
            out, contrib = body(v_i, *rest)
            acc = jax.tree.map(lambda a, c: a + c, acc, contrib)
            return acc, out

        acc, outs = jax.lax.scan(
            jax.checkpoint(step), acc0, (xb, *row_args)
        )
        return jax.tree.map(allsum, acc), outs

    return sweep


def stream_prior_diag(family, params, z, u_inv, xb, d_floor=1e-8):
    """The FITC conditional diagonal d = kdiag - rowsq(V) per block —
    one sweep, no accumulators."""

    def step(_, x_i):
        v_i = matmul(family.k_cross(params, x_i, z), u_inv)
        d_i = jnp.maximum(
            family.k_diag(params, x_i) - rows_sqr_norm(v_i), d_floor
        )
        return (), d_i

    _, d = jax.lax.scan(jax.checkpoint(step), (), xb)
    return d


def _binary_parts(f, lik, maskb):
    """(dl/df, W) of the logit likelihood over blocked rows — the default
    hook; other Laplace likelihoods plug in their own (poisson/binomial/
    ordinal streaming, see ``stream_laplace_parts``)."""
    (yb,) = lik
    pi = jax.nn.sigmoid(f)
    w = maskb * jnp.maximum(pi * (1.0 - pi), 1e-12)
    grad = maskb * (0.5 * (yb + 1.0) - pi)
    return grad, w


def newton_scan_stream(
    family, params, z, u_inv, d, xb, lik, maskb, *,
    newton_iters: int = 15, allsum=lambda x: x, parts=None,
):
    """Blockwise Newton mode-finding; (f_hat, a) as (nb, block) arrays.

    Same iteration as classify.newton_scan (stabilized GPML alg 3.1 with
    one round of iterative refinement and the exact concave line maximum)
    with every V product expressed as a sweep.  ``lik`` is the tuple of
    blocked per-row likelihood data (a bare array means binary labels in
    {-1,+1}); ``parts(f, lik, maskb) -> (grad, W)`` supplies any
    log-concave likelihood — masked rows must come back zeroed.
    """
    if not isinstance(lik, tuple):
        lik = (lik,)
    if parts is None:
        parts = _binary_parts
    m = z.shape[0]
    sweep = _make_sweep(family, params, z, u_inv, xb, allsum)
    eye = jnp.eye(m, dtype=xb.dtype)
    zm = jnp.zeros((m,), xb.dtype)

    def msolve(rm, t):
        return solve_tri(rm, solve_tri(rm, t, trans=True))

    def step(carry, _):
        f, a = carry
        grad, w = parts(f, lik, maskb)
        w = maskb * jnp.maximum(w, 1e-12)
        b = w * f + grad
        # double-where gate (masked w = 0; sqrt cotangent at 0 is inf)
        sw = maskb * jnp.sqrt(jnp.where(w > 0.0, w, 1.0))
        e = 1.0 / (1.0 + w * d)
        se = jnp.sqrt(e)
        swe = sw * se  # diag scale of Vw

        # sweep 1: V'b and the Woodbury Gram
        def body1(v_i, b_i, swe_i):
            vw_i = v_i * swe_i[:, None]
            return None, (matmul(v_i.T, b_i), matmul(vw_i.T, vw_i))

        (vtb, mm), _ = sweep(body1, (zm, jnp.zeros((m, m), xb.dtype)),
                             b, swe)
        rm = cholesky_upper(eye + mm, jitter=0.0)

        # sweep 2: rows Kb; accumulate Vw'(sqrt(e) c) with c = sw Kb
        def body2(v_i, b_i, d_i, sw_i, se_i, swe_i):
            kb_i = matmul(v_i, vtb) + d_i * b_i
            c_i = sw_i * kb_i
            return kb_i, matmul((v_i * swe_i[:, None]).T, se_i * c_i)

        t2, kb = sweep(body2, zm, b, d, sw, se, swe)
        s1 = msolve(rm, t2)

        # sweep 3: rows atil / a_n; accumulate V'a_n
        def body3(v_i, kb_i, b_i, sw_i, e_i, se_i, swe_i):
            c_i = sw_i * kb_i
            atil_i = e_i * c_i - se_i * matmul(v_i * swe_i[:, None], s1)
            a_n_i = b_i - sw_i * atil_i
            return (atil_i, a_n_i), matmul(v_i.T, a_n_i)

        vta, (atil, a_n) = sweep(body3, zm, kb, b, sw, e, se, swe)

        # sweep 4: rows f_n; accumulate the refinement residual
        # Vw'(sqrt(e) x) with x = sw f_n - atil
        def body4(v_i, a_n_i, atil_i, d_i, sw_i, se_i, swe_i):
            f_n_i = matmul(v_i, vta) + d_i * a_n_i
            x_i = sw_i * f_n_i - atil_i
            return f_n_i, matmul((v_i * swe_i[:, None]).T, se_i * x_i)

        t3, f_n = sweep(body4, zm, a_n, atil, d, sw, se, swe)
        s2 = msolve(rm, t3)

        # sweep 5: refined atil/a_n rows; accumulate V'a_n (refined)
        def body5(v_i, f_n_i, atil_i, b_i, sw_i, e_i, se_i, swe_i):
            x_i = sw_i * f_n_i - atil_i
            atil2_i = atil_i + e_i * x_i - se_i * matmul(
                v_i * swe_i[:, None], s2
            )
            a_n_i = b_i - sw_i * atil2_i
            return a_n_i, matmul(v_i.T, a_n_i)

        vta2, a_n = sweep(body5, zm, f_n, atil, b, sw, e, se, swe)

        # sweep 6: refined f_n rows
        def body6(v_i, a_n_i, d_i):
            return matmul(v_i, vta2) + d_i * a_n_i, ()

        _, f_n = sweep(body6, (), a_n, d)

        # exact concave line maximum along a_s = (1-s) a + s a_n —
        # elementwise in the cached (f, f_n), no sweeps
        aff = allsum(jnp.sum(a * f))
        afn = allsum(jnp.sum(a * f_n))
        ann = allsum(jnp.sum(a_n * f_n))
        df = f_n - f

        def dpsi(s):
            g_s, _ = parts(f + s * df, lik, maskb)
            quad_p = (-2.0 * (1.0 - s) * aff + (2.0 - 4.0 * s) * afn
                      + 2.0 * s * ann)
            return -0.5 * quad_p + allsum(jnp.sum(g_s * df))

        def bis(_, lohi):
            lo, hi = lohi
            mid = 0.5 * (lo + hi)
            pos = dpsi(mid) > 0
            return jnp.where(pos, mid, lo), jnp.where(pos, hi, mid)

        one = jnp.ones((), f.dtype)
        lo, _ = jax.lax.fori_loop(
            0, 25, bis, (jnp.zeros((), f.dtype), one)
        )
        s = jnp.where(dpsi(one) >= 0, one, lo)
        a = (1.0 - s) * a + s * a_n
        f = (1.0 - s) * f + s * f_n
        return (f, a), None

    f0 = jnp.zeros_like(maskb)  # float, whatever the label dtype
    (f_hat, a), _ = jax.lax.scan(
        jax.checkpoint(step), (f0, jnp.zeros_like(maskb)), None,
        length=newton_iters,
    )
    return f_hat, a


def _stream_kdot(sweep, d, x, m, dtype):
    """K x over blocked rows (K = V V' + diag(d)): two sweeps — accumulate
    V'x, then emit the rows V (V'x) + d x."""
    zm = jnp.zeros((m,), dtype)
    vtx, _ = sweep(lambda v_i, x_i: (None, matmul(v_i.T, x_i)), zm, x)
    _, rows = sweep(
        lambda v_i, x_i, d_i: (matmul(v_i, vtx) + d_i * x_i, ()), (), x, d
    )
    return rows


@functools.lru_cache(maxsize=None)
def _stream_fixed_point(family, parts, newton_iters, allsum, jitter):
    """The streaming Laplace fixed point a(params, z, lik) with IFT
    gradients — the blockwise analogue of models/ift.laplace_fixed_point:
    the backward is one streaming (I + K W)^-1 apply (~8 block passes,
    with one iterative-refinement round) plus one AD vjp through a
    two-sweep K-apply, instead of retraversing newton_iters x 6 remat'ed
    sweeps.  ``parts`` must be a module-level function (all traced
    likelihood data rides in ``lik`` — a closure over a tracer would leak
    into the backward trace).  Cached per static tuple so the custom_vjp
    identity is stable across traces."""

    @jax.custom_vjp
    def fixed_point(params, z, xb, lik, maskb):
        inducing = calc_inducing(family, params, z, jitter)
        u_inv = inv_tri_upper(inducing.chol_km)
        d = stream_prior_diag(family, params, z, u_inv, xb)
        _, a = newton_scan_stream(
            family, params, z, u_inv, d, xb, lik, maskb,
            newton_iters=newton_iters, allsum=allsum, parts=parts,
        )
        return a

    def fwd(params, z, xb, lik, maskb):
        a = fixed_point(params, z, xb, lik, maskb)
        return a, (params, z, xb, lik, maskb, a)

    def bwd(res, abar):
        from .ift import _zero_cotangent

        params, z, xb, lik, maskb, a = res
        m = z.shape[0]
        dtype = xb.dtype
        inducing = calc_inducing(family, params, z, jitter)
        u_inv = inv_tri_upper(inducing.chol_km)
        d = stream_prior_diag(family, params, z, u_inv, xb)
        sweep = _make_sweep(family, params, z, u_inv, xb, allsum)
        zm = jnp.zeros((m,), dtype)

        def kdot(x):
            return _stream_kdot(sweep, d, x, m, dtype)

        f_hat = kdot(a)
        _, w = parts(f_hat, lik, maskb)
        w = maskb * jnp.maximum(w, 1e-12)
        sw = maskb * jnp.sqrt(jnp.where(w > 0.0, w, 1.0))
        e = 1.0 / (1.0 + w * d)
        se = jnp.sqrt(e)
        swe = sw * se

        def body_mm(v_i, swe_i):
            vw_i = v_i * swe_i[:, None]
            return None, matmul(vw_i.T, vw_i)

        mm, _ = sweep(body_mm, jnp.zeros((m, m), dtype), swe)
        rm = cholesky_upper(jnp.eye(m, dtype=dtype) + mm, jitter=0.0)

        def solve(x):
            # (I + K W)^-1 x = x - K sw B^-1 sw x, B^-1 via the m-factor
            c = sw * x

            def b_acc(v_i, c_i, swe_i, se_i):
                return None, matmul((v_i * swe_i[:, None]).T, se_i * c_i)

            t1, _ = sweep(b_acc, zm, c, swe, se)
            s = solve_tri(rm, solve_tri(rm, t1, trans=True))

            def b_rows(v_i, c_i, e_i, se_i, swe_i, sw_i):
                binv_i = e_i * c_i - se_i * matmul(
                    v_i * swe_i[:, None], s
                )
                return sw_i * binv_i, ()

            _, yrows = sweep(b_rows, (), c, e, se, swe, sw)
            return x - kdot(yrows)

        u = solve(abar)
        # one round of iterative refinement (models/ift.py rationale)
        r = abar - (u + kdot(w * u))
        u = u + solve(r)

        # theta_bar = vjp of (params, z, float lik) -> dloglik/df(K a)
        leaves, treedef = jax.tree.flatten(lik)
        is_diff = [jnp.issubdtype(jnp.asarray(l).dtype, jnp.inexact)
                   for l in leaves]
        diff_leaves = [l for l, ok in zip(leaves, is_diff) if ok]

        def h(params_, z_, diff_):
            it = iter(diff_)
            full = [next(it) if ok else l
                    for l, ok in zip(leaves, is_diff)]
            lik_ = jax.tree.unflatten(treedef, full)
            inducing_ = calc_inducing(family, params_, z_, jitter)
            u_inv_ = inv_tri_upper(inducing_.chol_km)
            d_ = stream_prior_diag(family, params_, z_, u_inv_, xb)
            sweep_ = _make_sweep(family, params_, z_, u_inv_, xb, allsum)
            f = _stream_kdot(sweep_, d_, a, m, dtype)
            g, _ = parts(f, lik_, maskb)
            return g

        _, pull = jax.vjp(h, params, z, diff_leaves)
        pbar, zbar, diff_bars = pull(u)
        it = iter(diff_bars)
        lik_bar = jax.tree.unflatten(
            treedef,
            [next(it) if ok else _zero_cotangent(l)
             for l, ok in zip(leaves, is_diff)],
        )
        return (pbar, zbar, jnp.zeros_like(xb), lik_bar,
                jnp.zeros_like(maskb))

    fixed_point.defvjp(fwd, bwd)
    return fixed_point


def stream_laplace_parts(
    family, params, z, X, lik_rows, *, parts, loglik,
    block_size: int = 8192, newton_iters: int = 15,
    jitter: float | None = None, mask=None, allsum=lambda x: x,
    lik_is_row=None, grad_impl: str = "ift",
):
    """Generic streaming Laplace: mode + the m-space posterior epilogue,
    one streaming pass each, for ANY log-concave likelihood.

    ``lik_rows`` is a tuple of likelihood data in the family's canonical
    order; entries flagged True in ``lik_is_row`` (default: all) are (n,)
    per-row arrays that get padded/blocked with the data, the rest
    (scalar dispersions, cutpoint vectors, ...) pass through unchanged —
    so the same module-level ``parts(f, lik, maskb) -> (grad, W)`` and
    ``loglik(f, lik)`` hooks serve the materialized and streaming paths.
    Returns (inducing, f_hat, a, d, vta, rn, log_det_b, log_lik, quad)
    with f_hat/a/d as (nb, block) arrays, vta = V'a, R'R = I + Vw'Vw at
    the mode — everything the evidence and the predictor state need.
    Memory O(n + block x m) at any n.

    ``grad_impl="ift"`` (default) differentiates the mode implicitly
    (``_stream_fixed_point``) — requires ``parts`` to be a module-level
    function; "unroll" differentiates through the remat'ed sweeps.
    """
    inducing = calc_inducing(family, params, z, jitter)
    u_inv = inv_tri_upper(inducing.chol_km)
    if lik_is_row is None:
        lik_is_row = (True,) * len(lik_rows)
    first_idx = next(i for i, r in enumerate(lik_is_row) if r)
    xb, first, maskb = _pad_blocks(X, lik_rows[first_idx], mask,
                                   block_size)
    lik = tuple(
        (first if i == first_idx
         else _pad_blocks(X, arr, mask, block_size)[1]) if is_row else arr
        for i, (arr, is_row) in enumerate(zip(lik_rows, lik_is_row))
    )
    d = stream_prior_diag(family, params, z, u_inv, xb)

    m = z.shape[0]
    if grad_impl == "ift":
        a = _stream_fixed_point(family, parts, newton_iters, allsum,
                                jitter)(params, z, xb, lik, maskb)
        sweep_f = _make_sweep(family, params, z, u_inv, xb, allsum)
        f_hat = _stream_kdot(sweep_f, d, a, m, xb.dtype)
    elif grad_impl == "unroll":
        f_hat, a = newton_scan_stream(
            family, params, z, u_inv, d, xb, lik, maskb,
            newton_iters=newton_iters, allsum=allsum, parts=parts,
        )
    else:
        raise ValueError(
            f"grad_impl must be 'ift' or 'unroll', got {grad_impl}"
        )
    _, w = parts(f_hat, lik, maskb)
    w = maskb * jnp.maximum(w, 1e-12)
    e = 1.0 / (1.0 + w * d)
    swe = maskb * jnp.sqrt(jnp.where(w > 0.0, w, 1.0) * e)

    sweep = _make_sweep(family, params, z, u_inv, xb, allsum)

    # one epilogue sweep: V'a and the mode's Woodbury Gram
    def body(v_i, a_i, swe_i):
        vw_i = v_i * swe_i[:, None]
        return None, (matmul(v_i.T, a_i), matmul(vw_i.T, vw_i))

    (vta, mm), _ = sweep(
        body, (jnp.zeros((m,), xb.dtype), jnp.zeros((m, m), xb.dtype)),
        a, swe,
    )
    rn = cholesky_upper(jnp.eye(m, dtype=xb.dtype) + mm, jitter=0.0)

    log_det_b = allsum(jnp.sum(jnp.log1p(w * d))) + log_det_tri(rn)
    log_lik = allsum(jnp.sum(maskb * loglik(f_hat, lik)))
    quad = allsum(jnp.sum(a * f_hat))
    return inducing, f_hat, a, d, vta, rn, log_det_b, log_lik, quad


def stream_laplace_log_evidence(
    family, params, z, X, lik_rows, *, parts, loglik,
    block_size: int = 8192, newton_iters: int = 15,
    jitter: float | None = None, mask=None, allsum=lambda x: x,
    lik_is_row=None, grad_impl: str = "ift",
):
    """-0.5 a'f + log lik - 0.5 log|B| from the generic streaming parts —
    == the family's materialized Laplace evidence to roundoff at any
    block partition."""
    *_, log_det_b, log_lik, quad = stream_laplace_parts(
        family, params, z, X, lik_rows, parts=parts, loglik=loglik,
        block_size=block_size, newton_iters=newton_iters, jitter=jitter,
        mask=mask, allsum=allsum, lik_is_row=lik_is_row,
        grad_impl=grad_impl,
    )
    return -0.5 * quad + log_lik - 0.5 * log_det_b


def stream_classify_parts(
    family, params, z, X, y, *, block_size: int = 8192,
    newton_iters: int = 15, jitter: float | None = None, mask=None,
    allsum=lambda x: x, grad_impl: str = "ift",
):
    """Binary instance of ``stream_laplace_parts`` (kept as the named
    public surface the CLI artifact writer uses)."""
    return stream_laplace_parts(
        family, params, z, X, (y,),
        parts=_binary_parts,
        loglik=lambda f, lik: _log_sigmoid(lik[0] * f),
        block_size=block_size, newton_iters=newton_iters, jitter=jitter,
        mask=mask, allsum=allsum, grad_impl=grad_impl,
    )


def stream_classify_log_evidence(
    family, params, z, X, y, *, block_size: int = 8192,
    newton_iters: int = 15, jitter: float | None = None, mask=None,
    allsum=lambda x: x, grad_impl: str = "ift",
):
    """Laplace marginal likelihood, streaming — ==
    classify.classify_log_evidence to roundoff at any block partition,
    with memory O(n + block x m) instead of O(n m)."""
    *_, log_det_b, log_lik, quad = stream_classify_parts(
        family, params, z, X, y, block_size=block_size,
        newton_iters=newton_iters, jitter=jitter, mask=mask, allsum=allsum,
        grad_impl=grad_impl,
    )
    return -0.5 * quad + log_lik - 0.5 * log_det_b


def stream_classify_predict(
    family, params, z, X, y, Xstar, *, block_size: int = 8192,
    newton_iters: int = 15, jitter: float | None = None,
):
    """(prob, latent_mean, latent_var) at Xstar — the materialized
    classify_predict served from streaming state.

    The m-space state (V'a, Rn) comes out of the epilogue sweep; only
    (t, m) test objects materialize.  Note the posterior m-factor here is
    I + Vw'Vw at w e-scaling — identical to classify_predict's
    R'R = I + V' diag(1/(d + 1/w)) V since w e = 1/(d + 1/w).
    """
    inducing, _, _, _, vta, rn, *_ = stream_classify_parts(
        family, params, z, X, y, block_size=block_size,
        newton_iters=newton_iters, jitter=jitter,
    )
    u_inv = inv_tri_upper(inducing.chol_km)
    kstar = family.k_cross(params, Xstar, inducing.z)
    vstar = matmul(kstar, u_inv)
    mu = matmul(vstar, vta)
    from ..numerics.linalg import solve_tri_right

    quad = rows_sqr_norm(vstar) - rows_sqr_norm(
        solve_tri_right(vstar, rn)
    )
    var = jnp.maximum(family.k_diag(params, Xstar) - quad, 1e-10)
    prob = jax.nn.sigmoid(mu / jnp.sqrt(1.0 + jnp.pi * var / 8.0))
    return prob, mu, var

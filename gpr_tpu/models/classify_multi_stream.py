"""Streaming (blockwise) softmax-Laplace multi-class: unbounded n.

The materialized multi-class classifier (models/classify_multi.py) holds
V at (n, m) — the same HBM bound the binary classifier had before
models/classify_stream.py.  Here every V-involving product in the softmax
Newton step runs as a lax.scan over row blocks that recomputes the Knm
tile, so resident memory is O(n C + block x m) at any n.

The coupled step packs into SIX sweeps, the same count as the binary
stream (each: one kernel tile eval + O(C) block GEMMs):

  1. V'b, the per-class Grams P_c = V' diag(q_c) V, and the coupling
     Grams W_cc' = V' diag(q_c q_c' / qbar) V  ->  R_c, H on the host side
  2. rows Kb = V(V'b) + d b; accumulate V'(q Kb)       (the E_c applies)
  3. rows c = E_c Kb; accumulate G' Qbar^-1 (sum_c c)  (coupling solve in)
  4. rows t = (sum_c E_c)^-1 (sum_c c); accumulate V'(q t)
  5. rows a_n = b - c + E_c t; accumulate V'a_n
  6. rows f_n = V(V'a_n) + d a_n

The exact concave line maximum is elementwise in the cached (f, f_n) —
no sweeps.  The math is identical to classify_multi.softmax_newton_scan
step for step; parity tests assert evidence, gradients, and the
persistable posterior state match the materialized path to roundoff.

The posterior state streams through an identity the materialized path
does not use: with M_c = I - R_c^-1 R_c^-T P_c, the per-class projection
F_c = E_c V factors as diag(q_c) V M_c, so

  B_cc' = F_c' (sum E)^-1 F_c'
        = M_c' W_cc' M_c' + g_c' H^-1 g_c',   g_c = [R_e^-T W_ec M_c]_e,

i.e. the full (C, C, m, m) covariance state needs ONLY the m-space Grams
already accumulated for the evidence — no (n, m) F matrices ever form
(the materialized ``multiclass_posterior_state`` builds C of them).

``allsum`` is the cross-row reduction hook: identity on one device,
lax.psum under shard_map — every accumulator is an (m, C) panel, a
small stack of m x m matrices, or a scalar, so the sharded streaming
path composes exactly (parallel/classify_sharded.py passes block_size
through).

Reference contrast: the reference is regression-only and single-process
(doc/manual/gpr_manual.tex:82); multi-class, its scale-out, and its
streaming are all extensions.
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
    solve_tri,
)
from .classify_stream import _make_sweep, stream_prior_diag
from .fitc import calc_inducing
from .streaming import _pad_blocks


def _pairs(n_c):
    return [(c, c2) for c in range(n_c) for c2 in range(c, n_c)]


def _row_parts(f, y1h, d, maskb):
    """Elementwise per-row pieces of the softmax Newton step — recomputed
    from the cached f rows inside each sweep body (cheaper than caching
    four more (n, C) arrays).  Works on (block, C) and (nb, block, C)."""
    pi = jax.nn.softmax(f, axis=-1) * maskb[..., None]
    q = pi / (1.0 + pi * d[..., None])
    qbar = jnp.sum(q, axis=-1)
    qbar_inv = jnp.where(
        maskb > 0, 1.0 / jnp.where(qbar > 0, qbar, 1.0), 0.0
    )
    grad = (y1h - pi) * maskb[..., None]
    wf = pi * f - pi * jnp.sum(pi * f, axis=-1, keepdims=True)
    b = (wf + grad) * maskb[..., None]
    return pi, q, qbar_inv, b


def _gram_contrib(v_i, q_i, qbar_inv_i, n_c):
    """One block's contribution to the per-class Grams P_c (C, m, m) and
    the coupling Grams W_cc' (n_pairs, m, m) — a static unroll over the
    (small) class count, each term one weighted Gram GEMM."""
    p = jnp.stack(
        [matmul((v_i * q_i[:, c : c + 1]).T, v_i) for c in range(n_c)]
    )
    w = jnp.stack([
        matmul(
            (v_i * (q_i[:, c] * q_i[:, c2] * qbar_inv_i)[:, None]).T, v_i
        )
        for c, c2 in _pairs(n_c)
    ])
    return p, w


def _factors_from_grams(p_acc, w_acc, n_c, dtype):
    """(r_all, h_chol) from the summed Grams — the post-allsum epilogue
    of classify_multi._per_class_factors + _coupling_chol, restated on
    accumulators instead of V."""
    m = p_acc.shape[1]
    eye = jnp.eye(m, dtype=dtype)
    p_acc = 0.5 * (p_acc + jnp.swapaxes(p_acc, 1, 2))
    r_all = jax.vmap(lambda p: cholesky_upper(eye + p, jitter=0.0))(p_acc)
    blocks = [[None] * n_c for _ in range(n_c)]
    for k, (c, c2) in enumerate(_pairs(n_c)):
        g = solve_tri(r_all[c], w_acc[k], trans=True)  # R_c^-T W
        g = solve_tri(r_all[c2], g.T, trans=True).T  # ... R_c2^-1
        blocks[c][c2] = g
        if c2 != c:
            blocks[c2][c] = g.T
    gqg = jnp.block(blocks)
    h = jnp.eye(n_c * m, dtype=dtype) - 0.5 * (gqg + gqg.T)
    return p_acc, r_all, cholesky_upper(h, jitter=0.0)


def softmax_newton_scan_stream(
    family, params, z, u_inv, d, xb, y1h, maskb, *,
    newton_iters: int = 15, allsum=lambda x: x,
):
    """Blockwise Newton mode-finding; (f_hat, a) as (nb, block, C) arrays.

    Same iteration as classify_multi.softmax_newton_scan (per-class
    Woodbury E_c applies, the rank-Cm coupling solve, the exact concave
    line maximum) with every V product expressed as a sweep.
    """
    n_c = y1h.shape[-1]
    m = z.shape[0]
    n_pairs = n_c * (n_c + 1) // 2
    sweep = _make_sweep(family, params, z, u_inv, xb, allsum)
    zmc = jnp.zeros((m, n_c), xb.dtype)

    def msolve_cols(r_all, t):
        return jax.vmap(
            lambda r, tc: solve_tri(r, solve_tri(r, tc, trans=True)),
            in_axes=(0, 1), out_axes=1,
        )(r_all, t)

    def step(carry, _):
        f, a = carry

        # sweep 1: V'b + the per-class and coupling Grams
        def body1(v_i, f_i, y_i, d_i, m_i):
            _, q_i, qbi_i, b_i = _row_parts(f_i, y_i, d_i, m_i)
            p, w = _gram_contrib(v_i, q_i, qbi_i, n_c)
            return None, (matmul(v_i.T, b_i), p, w)

        (vtb, p_acc, w_acc), _ = sweep(
            body1,
            (zmc, jnp.zeros((n_c, m, m), xb.dtype),
             jnp.zeros((n_pairs, m, m), xb.dtype)),
            f, y1h, d, maskb,
        )
        _, r_all, h_chol = _factors_from_grams(p_acc, w_acc, n_c, xb.dtype)

        # sweep 2: rows Kb = V(V'b) + d b; accumulate V'(q Kb)
        def body2(v_i, f_i, y_i, d_i, m_i):
            _, q_i, _, b_i = _row_parts(f_i, y_i, d_i, m_i)
            kb_i = matmul(v_i, vtb) + d_i[:, None] * b_i
            return kb_i, matmul(v_i.T, q_i * kb_i)

        t1, kb = sweep(body2, zmc, f, y1h, d, maskb)
        t_e = msolve_cols(r_all, t1)

        # sweep 3: rows c = E_c Kb; accumulate G' Qbar^-1 (sum_c c)
        def body3(v_i, kb_i, f_i, y_i, d_i, m_i):
            _, q_i, qbi_i, _ = _row_parts(f_i, y_i, d_i, m_i)
            cvec_i = q_i * kb_i - q_i * matmul(v_i, t_e)
            qx_i = qbi_i * jnp.sum(cvec_i, axis=-1)
            return cvec_i, matmul(v_i.T, q_i * qx_i[:, None])

        gt, cvec = sweep(body3, zmc, kb, f, y1h, d, maskb)
        gt = jax.vmap(
            lambda r, tc: solve_tri(r, tc, trans=True),
            in_axes=(0, 1), out_axes=1,
        )(r_all, gt)
        wv = gt.T.reshape(n_c * m)  # class-major, matching the H blocks
        wv = solve_tri(h_chol, solve_tri(h_chol, wv, trans=True))
        gw = jax.vmap(lambda r, wc: solve_tri(r, wc))(
            r_all, wv.reshape(n_c, m)
        )

        # sweep 4: rows t = (sum_c E_c)^-1 (sum_c c); accumulate V'(q t)
        def body4(v_i, cvec_i, f_i, y_i, d_i, m_i):
            _, q_i, qbi_i, _ = _row_parts(f_i, y_i, d_i, m_i)
            qx_i = qbi_i * jnp.sum(cvec_i, axis=-1)
            tc_i = qx_i + qbi_i * jnp.sum(
                q_i * matmul(v_i, gw.T), axis=-1
            )
            return tc_i, matmul(v_i.T, q_i * tc_i[:, None])

        t2, tcoup = sweep(body4, zmc, cvec, f, y1h, d, maskb)
        t_e2 = msolve_cols(r_all, t2)

        # sweep 5: rows a_n = b - c + E_c t; accumulate V'a_n
        def body5(v_i, cvec_i, tc_i, f_i, y_i, d_i, m_i):
            _, q_i, _, b_i = _row_parts(f_i, y_i, d_i, m_i)
            e_t = q_i * tc_i[:, None] - q_i * matmul(v_i, t_e2)
            a_n_i = b_i - cvec_i + e_t
            return a_n_i, matmul(v_i.T, a_n_i)

        vta_n, a_n = sweep(body5, zmc, cvec, tcoup, f, y1h, d, maskb)

        # sweep 6: rows f_n = V(V'a_n) + d a_n
        def body6(v_i, a_n_i, d_i):
            return matmul(v_i, vta_n) + d_i[:, None] * a_n_i, ()

        _, f_n = sweep(body6, (), a_n, d)

        # exact concave line maximum along a_s = (1-s) a + s a_n —
        # elementwise in the cached (f, f_n), no sweeps
        aff = allsum(jnp.sum(a * f))
        afn = allsum(jnp.sum(a * f_n))
        ann = allsum(jnp.sum(a_n * f_n))
        df = f_n - f

        def dpsi(s):
            pi_s = jax.nn.softmax(f + s * df, axis=-1)
            quad_p = (-2.0 * (1.0 - s) * aff + (2.0 - 4.0 * s) * afn
                      + 2.0 * s * ann)
            lik_p = allsum(jnp.sum(
                maskb[..., None] * (y1h - pi_s) * df
            ))
            return -0.5 * quad_p + lik_p

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

    f0 = jnp.zeros_like(y1h)
    (f_hat, a), _ = jax.lax.scan(
        jax.checkpoint(step), (f0, jnp.zeros_like(y1h)), None,
        length=newton_iters,
    )
    return f_hat, a


def _stream_kdot_mc(sweep, d, x, m, n_c, dtype):
    """K x columnwise over blocked rows for (nb, block, C) x:
    two sweeps — accumulate V'x (m, C), then emit V(V'x) + d x."""
    zmc = jnp.zeros((m, n_c), dtype)
    vtx, _ = sweep(lambda v_i, x_i: (None, matmul(v_i.T, x_i)), zmc, x)
    _, rows = sweep(
        lambda v_i, x_i, d_i: (matmul(v_i, vtx) + d_i[:, None] * x_i, ()),
        (), x, d,
    )
    return rows


@functools.lru_cache(maxsize=None)
def _stream_softmax_fixed_point(family, newton_iters, allsum, jitter):
    """The streaming softmax-Laplace fixed point a(params, z) with IFT
    gradients — the blockwise analogue of
    classify_multi._softmax_fixed_point: the backward is one streaming
    coupled (I + K W)^-1 apply (~12 block passes incl. one
    iterative-refinement round) plus one AD vjp through a two-sweep
    K-apply, instead of retraversing newton_iters x 6 remat'ed sweeps.
    Cached per static tuple so the custom_vjp identity is stable across
    traces (allsum must be a module-level function — the sharded wrapper
    passes parallel.classify_sharded._allsum)."""

    @jax.custom_vjp
    def fixed_point(params, z, xb, y1h, maskb):
        inducing = calc_inducing(family, params, z, jitter)
        u_inv = inv_tri_upper(inducing.chol_km)
        d = stream_prior_diag(family, params, z, u_inv, xb)
        _, a = softmax_newton_scan_stream(
            family, params, z, u_inv, d, xb, y1h, maskb,
            newton_iters=newton_iters, allsum=allsum,
        )
        return a

    def fwd(params, z, xb, y1h, maskb):
        a = fixed_point(params, z, xb, y1h, maskb)
        return a, (params, z, xb, y1h, maskb, a)

    def bwd(res, abar):
        params, z, xb, y1h, maskb, a = res
        n_c = y1h.shape[-1]
        m = z.shape[0]
        dtype = xb.dtype
        n_pairs = n_c * (n_c + 1) // 2
        inducing = calc_inducing(family, params, z, jitter)
        u_inv = inv_tri_upper(inducing.chol_km)
        d = stream_prior_diag(family, params, z, u_inv, xb)
        sweep = _make_sweep(family, params, z, u_inv, xb, allsum)
        zmc = jnp.zeros((m, n_c), dtype)

        def kdot(x):
            return _stream_kdot_mc(sweep, d, x, m, n_c, dtype)

        f_hat = kdot(a)
        pi, q, qbar_inv, _ = _row_parts(f_hat, y1h, d, maskb)

        # the mode's per-class and coupling factors (one Gram sweep)
        def body_g(v_i, q_i, qbi_i):
            return None, _gram_contrib(v_i, q_i, qbi_i, n_c)

        (p_acc, w_acc), _ = sweep(
            body_g,
            (jnp.zeros((n_c, m, m), dtype),
             jnp.zeros((n_pairs, m, m), dtype)),
            q, qbar_inv,
        )
        _, r_all, h_chol = _factors_from_grams(p_acc, w_acc, n_c, dtype)

        def msolve_cols(t):
            return jax.vmap(
                lambda r, tc: solve_tri(r, solve_tri(r, tc, trans=True)),
                in_axes=(0, 1), out_axes=1,
            )(r_all, t)

        def m_apply(x):
            # M x = E x - E 1 (sum_c E_c)^-1 1' E x streamed — the same
            # four-sweep shape as Newton-step sweeps 2-5, with x in the
            # Kb slot (classify_multi._m_apply restated on blocks)
            t1, _ = sweep(
                lambda v_i, q_i, x_i: (None, matmul(v_i.T, q_i * x_i)),
                zmc, q, x,
            )
            t_e = msolve_cols(t1)

            def body_ex(v_i, q_i, qbi_i, x_i):
                ex_i = q_i * x_i - q_i * matmul(v_i, t_e)
                qx_i = qbi_i * jnp.sum(ex_i, axis=-1)
                return ex_i, matmul(v_i.T, q_i * qx_i[:, None])

            gt, ex = sweep(body_ex, zmc, q, qbar_inv, x)
            gt = jax.vmap(lambda r, tc: solve_tri(r, tc, trans=True),
                          in_axes=(0, 1), out_axes=1)(r_all, gt)
            wv = gt.T.reshape(n_c * m)  # class-major, matching H's blocks
            wv = solve_tri(h_chol, solve_tri(h_chol, wv, trans=True))
            gw = jax.vmap(lambda r, wc: solve_tri(r, wc))(
                r_all, wv.reshape(n_c, m)
            )

            def body_tc(v_i, ex_i, q_i, qbi_i):
                tc_i = qbi_i * jnp.sum(ex_i, axis=-1) + qbi_i * jnp.sum(
                    q_i * matmul(v_i, gw.T), axis=-1
                )
                return tc_i, matmul(v_i.T, q_i * tc_i[:, None])

            t2, tc = sweep(body_tc, zmc, ex, q, qbar_inv)
            t_e2 = msolve_cols(t2)

            def body_mx(v_i, ex_i, tc_i, q_i):
                et_i = q_i * tc_i[:, None] - q_i * matmul(v_i, t_e2)
                return ex_i - et_i, ()

            _, mx = sweep(body_mx, (), ex, tc, q)
            return mx

        def solve(x):
            # (I + K W)^-1 x = x - K M x
            return x - kdot(m_apply(x))

        def wdot(x):
            # W x per row: diag(pi) x - pi (pi . x), masked
            return (pi * x - pi * jnp.sum(pi * x, axis=-1, keepdims=True)
                    ) * maskb[..., None]

        u = solve(abar)
        # one round of iterative refinement (models/ift.py rationale)
        r = abar - (u + kdot(wdot(u)))
        u = u + solve(r)

        # theta_bar = (dF/dtheta)' u with F = g(K a; y1h) - a at fixed a,
        # g = mask (y1h - softmax(K a)): one vjp through a two-sweep
        # K-apply with fresh tiles, explicit identity block for y1h
        def h(params_, z_):
            inducing_ = calc_inducing(family, params_, z_, jitter)
            u_inv_ = inv_tri_upper(inducing_.chol_km)
            d_ = stream_prior_diag(family, params_, z_, u_inv_, xb)
            sweep_ = _make_sweep(family, params_, z_, u_inv_, xb, allsum)
            f = _stream_kdot_mc(sweep_, d_, a, m, n_c, dtype)
            return (y1h - jax.nn.softmax(f, axis=-1)) * maskb[..., None]

        _, pull = jax.vjp(h, params, z)
        pbar, zbar = pull(u)
        return (pbar, zbar, jnp.zeros_like(xb), maskb[..., None] * u,
                jnp.zeros_like(maskb))

    fixed_point.defvjp(fwd, bwd)
    return fixed_point


def stream_multiclass_parts(
    family, params, z, X, labels, n_classes: int, *,
    block_size: int = 8192, newton_iters: int = 15,
    jitter: float | None = None, mask=None, allsum=lambda x: x,
    grad_impl: str = "ift",
):
    """Mode + the m-space posterior epilogue, streaming.

    Returns (inducing, f_hat, a, d, y1h, maskb, vta, p_acc, r_all,
    h_chol, w_full, log_det, log_lik, quad) — everything the evidence
    and the persistable predictor state need; w_full is the (C, C, m, m)
    coupling-Gram tensor (symmetric pairs mirrored).

    ``grad_impl="ift"`` (default) differentiates the mode implicitly
    (``_stream_softmax_fixed_point``); "unroll" differentiates through
    the remat'ed sweeps."""
    inducing = calc_inducing(family, params, z, jitter)
    u_inv = inv_tri_upper(inducing.chol_km)
    xb, lb, maskb = _pad_blocks(X, labels, mask, block_size)
    d = stream_prior_diag(family, params, z, u_inv, xb)
    y1h = jax.nn.one_hot(lb, n_classes, dtype=xb.dtype) * maskb[..., None]

    m = z.shape[0]
    if grad_impl == "ift":
        a = _stream_softmax_fixed_point(family, newton_iters, allsum,
                                        jitter)(params, z, xb, y1h, maskb)
        sweep_f = _make_sweep(family, params, z, u_inv, xb, allsum)
        f_hat = _stream_kdot_mc(sweep_f, d, a, m, n_classes, xb.dtype)
    elif grad_impl == "unroll":
        f_hat, a = softmax_newton_scan_stream(
            family, params, z, u_inv, d, xb, y1h, maskb,
            newton_iters=newton_iters, allsum=allsum,
        )
    else:
        raise ValueError(
            f"grad_impl must be 'ift' or 'unroll', got {grad_impl}"
        )
    n_pairs = n_classes * (n_classes + 1) // 2
    sweep = _make_sweep(family, params, z, u_inv, xb, allsum)

    # one epilogue sweep: V'a and the mode's Grams
    def body(v_i, f_i, y_i, a_i, d_i, m_i):
        _, q_i, qbi_i, _ = _row_parts(f_i, y_i, d_i, m_i)
        p, w = _gram_contrib(v_i, q_i, qbi_i, n_classes)
        return None, (matmul(v_i.T, a_i), p, w)

    (vta, p_acc, w_acc), _ = sweep(
        body,
        (jnp.zeros((m, n_classes), xb.dtype),
         jnp.zeros((n_classes, m, m), xb.dtype),
         jnp.zeros((n_pairs, m, m), xb.dtype)),
        f_hat, y1h, a, d, maskb,
    )
    p_acc, r_all, h_chol = _factors_from_grams(
        p_acc, w_acc, n_classes, xb.dtype
    )
    w_full = [[None] * n_classes for _ in range(n_classes)]
    for k, (c, c2) in enumerate(_pairs(n_classes)):
        w_sym = 0.5 * (w_acc[k] + w_acc[k].T)
        w_full[c][c2] = w_sym
        w_full[c2][c] = w_sym  # the diag weight is symmetric in (c, c')
    w_full = jnp.stack([jnp.stack(row) for row in w_full])

    # elementwise log-det / likelihood pieces over the cached mode rows
    pi, q, _, _ = _row_parts(f_hat, y1h, d, maskb)
    qbar = jnp.sum(q, axis=-1)
    log_det = allsum(jnp.sum(jnp.log1p(pi * d[..., None])))
    log_det = log_det + jnp.sum(jax.vmap(log_det_tri)(r_all))
    log_det = log_det + allsum(jnp.sum(
        maskb * jnp.log(jnp.where(maskb > 0, jnp.where(qbar > 0, qbar, 1.0),
                                  1.0))
    )) + log_det_tri(h_chol)
    log_lik = allsum(
        jnp.sum(maskb[..., None] * y1h * f_hat)
        - jnp.sum(maskb * jax.nn.logsumexp(f_hat, axis=-1))
    )
    quad = allsum(jnp.sum(a * f_hat))
    return (inducing, f_hat, a, d, y1h, maskb, vta, p_acc, r_all, h_chol,
            w_full, log_det, log_lik, quad)


def stream_multiclass_log_evidence(
    family, params, z, X, labels, n_classes: int, *,
    block_size: int = 8192, newton_iters: int = 15,
    jitter: float | None = None, mask=None, allsum=lambda x: x,
    grad_impl: str = "ift",
):
    """Softmax-Laplace marginal likelihood, streaming — ==
    classify_multi.multiclass_log_evidence to roundoff at any block
    partition, with memory O(n C + block x m) instead of O(n m)."""
    *_, log_det, log_lik, quad = stream_multiclass_parts(
        family, params, z, X, labels, n_classes, block_size=block_size,
        newton_iters=newton_iters, jitter=jitter, mask=mask, allsum=allsum,
        grad_impl=grad_impl,
    )
    return -0.5 * quad + log_lik - 0.5 * log_det


def stream_multiclass_state(
    family, params, z, X, labels, n_classes: int, *,
    block_size: int = 8192, newton_iters: int = 15,
    jitter: float | None = None, mask=None, allsum=lambda x: x,
):
    """The persistable m-space predictor state (coeffs, a_tilde, b_tilde
    of classify_multi.multiclass_posterior_state), streaming — built
    entirely from the epilogue Grams via F_c = diag(q_c) V M_c (module
    docstring), so no (n, m) object ever forms.

    Returns (inducing, coeffs, a_tilde, b_tilde) — feed to
    classify_multi.multiclass_predict_from_state.
    """
    (inducing, _, _, _, _, _, vta, p_acc, r_all, h_chol, w_full,
     *_) = stream_multiclass_parts(
        family, params, z, X, labels, n_classes, block_size=block_size,
        newton_iters=newton_iters, jitter=jitter, mask=mask, allsum=allsum,
    )
    m = z.shape[0]
    eye = jnp.eye(m, dtype=vta.dtype)

    def msolve(r, t):
        return solve_tri(r, solve_tri(r, t, trans=True))

    # M_c = I - R_c^-1 R_c^-T P_c;  A_c = P_c - P_c (R'R)^-1 P_c
    minv_p = [msolve(r_all[c], p_acc[c]) for c in range(n_classes)]
    m_all = [eye - minv_p[c] for c in range(n_classes)]
    a_all = jnp.stack(
        [p_acc[c] - matmul(p_acc[c], minv_p[c]) for c in range(n_classes)]
    )

    # g_c = [R_e^-T W_ec M_c]_e stacked class-major: (Cm, m) per class
    g_stacks = []
    for c in range(n_classes):
        rows = [
            solve_tri(r_all[e], matmul(w_full[e, c], m_all[c]), trans=True)
            for e in range(n_classes)
        ]
        g_stacks.append(jnp.concatenate(rows, axis=0))
    hinv_g = [
        solve_tri(h_chol, solve_tri(h_chol, g, trans=True))
        for g in g_stacks
    ]
    b_all = jnp.stack([
        jnp.stack([
            matmul(m_all[c].T, matmul(w_full[c, c2], m_all[c2]))
            + matmul(g_stacks[c].T, hinv_g[c2])
            for c2 in range(n_classes)
        ])
        for c in range(n_classes)
    ])  # (C, C, m, m)

    u = inducing.chol_km

    def conj(mat):  # U^-1 mat U^-T
        t = solve_tri(u, mat)
        return solve_tri(u, t.T).T

    coeffs = solve_tri(u, vta)  # (m, C)
    a_tilde = jax.vmap(conj)(a_all)
    b_tilde = jax.vmap(jax.vmap(conj))(b_all)
    return inducing, coeffs, a_tilde, b_tilde


def stream_multiclass_predict(
    family, params, z, X, labels, n_classes: int, Xstar, *,
    block_size: int = 8192, newton_iters: int = 15,
    jitter: float | None = None, n_samples: int = 1024, key=None,
):
    """(probs, mu, sigma) at Xstar — classify_multi.multiclass_predict
    served from streaming state (only (t, m) test objects materialize)."""
    from .classify_multi import multiclass_predict_from_state

    inducing, coeffs, a_tilde, b_tilde = stream_multiclass_state(
        family, params, z, X, labels, n_classes, block_size=block_size,
        newton_iters=newton_iters, jitter=jitter,
    )
    return multiclass_predict_from_state(
        family, params, inducing.z, coeffs, a_tilde, b_tilde, Xstar,
        n_samples=n_samples, key=key,
    )

"""PITC evidence: the partially-independent training conditional.

The reference names PITC as future work and never ships it
(doc/manual/gpr_manual.tex:532-559 "more sophisticated approximation
methods"; Quinonero-Candela & Rasmussen 2005 taxonomy).  This module
delivers it as GEMMs: PITC generalizes FITC's diagonal train-conditional
correction to BLOCK-diagonal — within each block of training points the
exact covariance is kept, so

  cov(y) = Q + S,   Q = Knm Km^-1 Kmn,
  S = blkdiag_b(K_bb - Q_bb) + sigma2 I.

FITC is the block_size=1 special case; one block covering all n rows is
the EXACT GP (S = Knn - Q + sigma2 I makes Q + S = Knn + sigma2 I) —
both identities are CI-tested, and the second makes PITC a tunable
accuracy dial between FITC and exact inference at O(n b^2 + n m^2) cost.

The implementation is the streaming whitened-statistic scan of
models/streaming.py with ONE change: where FITC whitens each row by the
scalar 1/sqrt(s_i), PITC whitens each block by the inverse Cholesky
factor of its (b, b) conditional S_b — a batched-small-Cholesky per scan
step (the Block_diag role, lib/block_diag.ml, done on-chip per tile).
Everything downstream — the I + G factorization, evidence epilogue,
coefficient/variance predictors — is shared with the FITC streaming path
unchanged, because the sufficient statistics have the same shape:

  G     = sum_b (U_b^-T V_b)' (U_b^-T V_b)      (whitened Gram)
  u_vec = sum_b (U_b^-T V_b)' (U_b^-T y_b)
  lds   = sum_b 2 log|diag U_b|,  yiy = sum_b |U_b^-T y_b|^2.

The scan block size IS the PITC block partition: it is a modeling choice
(larger blocks = closer to exact GP), not just a tiling parameter.
Gradients flow by AD through the scan (jax.checkpoint rematerializes
tiles); there is no variational PITC variant (the reference's variational
flavor is Titsias' bound for FITC/FIC only).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..numerics.linalg import (
    cholesky_upper,
    inv_tri_upper,
    log_det_tri,
    matmul,
    solve_tri,
)
from .fitc import calc_inducing
from .streaming import (
    StreamStats,
    _acc_dtype,
    _dewhiten,
    _pad_blocks,
    _whitened_solve,
    evidence_from_stats,
)


def pitc_stream_stats(
    family, params, inducing, sigma2, X, y, *, block_size: int = 256,
    mask=None, remat: bool = True, jitter: float = 0.0,
) -> StreamStats:
    """One scan over row blocks accumulating PITC's StreamStats.

    Each scan step factors its block conditional
    S_b = K_bb - V_b V_b' + sigma2 I (a (b, b) Cholesky per tile) and folds
    the block-whitened tile into the same O(m^2) statistics the FITC scan
    produces.  Padded rows decouple exactly: their S rows/columns are
    zeroed and the diagonal set to 1, so the factor is block-trivial there
    and they contribute nothing to any statistic.
    """
    m = inducing.z.shape[0]
    u_inv = inv_tri_upper(inducing.chol_km)
    xb, yb, maskb = _pad_blocks(X, y, mask, block_size)
    b = xb.shape[1]

    def body(carry, blk):
        x_b, y_b, mask_b = blk
        x_b = x_b.astype(inducing.z.dtype)
        y_b = y_b.astype(inducing.z.dtype) * mask_b
        knm = family.k_cross(params, x_b, inducing.z)
        kd = family.k_diag(params, x_b)
        v = matmul(knm, u_inv) * mask_b[:, None]

        # exact within-block covariance with the family's exact diagonal.
        # k_upper_inputs, NOT k_cross(x_b, x_b): k_cross expects the
        # kernel-specific inducing representation on its second argument
        # (lin_ard pre-scales, se_fat projects and carries per-inducing
        # multiscales) — raw rows there mis-scale lin_ard and shape-crash
        # se_fat multiscales (caught by the CI fuzz, round-3 s5)
        kbb = family.k_upper_inputs(params, x_b)
        eye = jnp.eye(b, dtype=bool)
        kbb = jnp.where(eye, kd[:, None], kbb)
        live2 = mask_b[:, None] * mask_b[None, :]
        s_mat = (kbb - matmul(v, v.T)) * live2
        s_diag = jnp.where(mask_b > 0, sigma2, 1.0)
        s_mat = s_mat + jnp.where(eye, s_diag[:, None], 0.0)

        u_b = cholesky_upper(s_mat, jitter=jitter)  # S_b = U_b' U_b
        a = solve_tri(u_b, v, trans=True)  # U_b^-T V_b
        w = solve_tri(u_b, y_b, trans=True)  # U_b^-T y_b

        gram, u_vec, lds, yiy, cnt = carry
        gram = gram + matmul(a.T, a).astype(_acc_dtype())
        u_vec = u_vec + matmul(a.T, w).astype(_acc_dtype())
        lds = lds + log_det_tri(u_b).astype(_acc_dtype())
        yiy = yiy + jnp.dot(w, w).astype(_acc_dtype())
        cnt = cnt + jnp.sum(mask_b).astype(_acc_dtype())
        return (gram, u_vec, lds, yiy, cnt), None

    if remat:
        body = jax.checkpoint(body)

    init = (
        jnp.zeros((m, m), _acc_dtype()),
        jnp.zeros((m,), _acc_dtype()),
        jnp.zeros((), _acc_dtype()),
        jnp.zeros((), _acc_dtype()),
        jnp.zeros((), _acc_dtype()),
    )
    (gram, u_vec, lds, yiy, cnt), _ = jax.lax.scan(body, init, (xb, yb, maskb))
    return StreamStats(
        gram=gram, u_vec=u_vec, log_det_s=lds, y_is_y=yiy,
        is_r_sum=jnp.zeros((), _acc_dtype()), n=cnt,
    )


def pitc_log_evidence(
    family, params, z, sigma2, X, y, *, block_size: int = 256,
    jitter: float | None = None, block_jitter: float = 0.0,
) -> jnp.ndarray:
    """PITC log marginal likelihood.  Differentiable w.r.t.
    (params, z, sigma2); ``block_size`` is the PITC partition (1 recovers
    the FITC evidence exactly, >= n the exact GP).  ``jitter`` applies to
    Km; ``block_jitter`` to each block conditional — default 0 because
    S_b = (K_bb - Q_bb) + sigma2 I is already regularized by the noise
    (min eigenvalue >= sigma2 in exact arithmetic); raise it only when
    training with sigma2 near 0."""
    inducing = calc_inducing(family, params, z, jitter)
    stats = pitc_stream_stats(
        family, params, inducing, sigma2, X, y, block_size=block_size,
        jitter=block_jitter,
    )
    return evidence_from_stats(inducing, stats, variational=False)


def pitc_coeffs(
    family, params, z, sigma2, X, y, *, block_size: int = 256,
    jitter: float | None = None, block_jitter: float = 0.0,
):
    """(inducing, r_mat, coeffs) for PITC prediction.

    PITC's test conditional is the same independent q(f*|u) as FIC
    (Quinonero-Candela & Rasmussen 2005, eq. 24), so the existing
    streaming predictors consume these directly:
    predict_means_blocked(family, params, z, coeffs, Xstar) and
    predict_variances_blocked(family, params, z, inducing.chol_km, r_mat,
    Xstar, sigma2)."""
    inducing = calc_inducing(family, params, z, jitter)
    stats = pitc_stream_stats(
        family, params, inducing, sigma2, X, y, block_size=block_size,
        jitter=block_jitter,
    )
    r_tilde, t = _whitened_solve(inducing, stats)
    coeffs, r_mat = _dewhiten(inducing, r_tilde, t)
    return inducing, r_mat, coeffs

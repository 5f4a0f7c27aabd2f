"""The "fat" squared-exponential kernel.

Reference: lib/cov_se_fat.ml.  Features (all optional, composable):
  * supervised dimensionality reduction: inputs X (n, D) are projected to
    (n, d) by ``tproj`` before any distance computation (:215-218);
  * per-inducing-point heteroskedastic noise added to diag(Km) only
    (:136-142);
  * per-inducing-point, per-dimension multiscales stored as
    ``log_multiscales_m05`` with u = exp(.) + 0.5 > 0.5 (:66-68).

Math (transliterated from the reference's scalar loops, vectorized to GEMMs):

  cross (x projected to p, inducing column c):            (:241-251)
      k(p, z_c) = exp(log_sf2 - 1/2 sum_i [(p_i - z_ci)^2 / u_ci + log u_ci])
  inducing gram, off-diagonal (r, c), scale = u_ri + u_ci - 1:   (:110-134)
      k(z_r, z_c) = exp(log_sf2 - 1/2 sum_i [(z_ri - z_ci)^2 / s_i + log s_i])
  inducing gram diagonal: the same formula at r = c (scale = 2u - 1, diff = 0),
      plus hetero noise;
  k_diag(X) = sf2 (multiscales do NOT affect input variances, :222);
  k_upper_inputs = *vanilla* SE on projections — the reference ignores
      multiscales and hetero noise there (:221), reproduced deliberately.

The inducing representation is the projected space (m, d); inducing-point
hypers in the reference (`Inducing_hyper) are coordinates of this
representation, so jax.grad w.r.t. Z matches.

Parameter layout differs from the reference's Fortran (dim, ind) matrices:
``log_multiscales_m05`` is (m, d) row-major, ``tproj`` is (D, d).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..numerics.linalg import matmul
from ..tree import pytree_dataclass
from .base import sqdist


@pytree_dataclass(meta_fields=("d",))
class Params:
    d: int  # static: projected dimensionality
    log_sf2: jnp.ndarray  # scalar
    tproj: jnp.ndarray | None  # (D, d) or None
    log_hetero_skedasticity: jnp.ndarray | None  # (m,) or None
    log_multiscales_m05: jnp.ndarray | None  # (m, d) or None


def _multiscales(params):
    return jnp.exp(params.log_multiscales_m05) + 0.5


class SeFat:
    name = "se_fat"
    Params = Params
    learn_inducing_default = True

    @staticmethod
    def default_params(X, n_inducing, key=None) -> Params:
        """Random defaults mirroring lib/cov_se_fat.ml:191-213.

        tproj row r is scaled by (n / D) / sum_samples(X[:, r]); log_sf2 ~
        U(-1, 1); hetero noise starts at exp(-5); log_multiscales_m05 = 0,
        i.e. u = exp(0) + 0.5 = 1.5.
        """
        if key is None:
            key = jax.random.PRNGKey(0)
        n, big_dim = X.shape
        d = min(big_dim, 10)
        k_proj, k_sf2 = jax.random.split(key)
        col_sums = jnp.sum(X, axis=0)  # (D,)
        factor = n / big_dim
        mean_factor = factor / col_sums  # (D,)
        tproj = mean_factor[:, None] * jax.random.uniform(
            k_proj, (big_dim, d), X.dtype, -1.0, 1.0
        )
        return Params(
            d=d,
            log_sf2=jax.random.uniform(k_sf2, (), X.dtype, -1.0, 1.0),
            tproj=tproj,
            log_hetero_skedasticity=jnp.full((n_inducing,), -5.0, X.dtype),
            log_multiscales_m05=jnp.zeros((n_inducing, d), X.dtype),
        )

    @staticmethod
    def project(params, X):
        """(n, D) -> (n, d); identity when tproj is disabled (:215-218)."""
        if params.tproj is None:
            return X
        return matmul(X, params.tproj)

    @staticmethod
    def inducing_from_inputs(params, X):
        return SeFat.project(params, X)

    @staticmethod
    def k_upper(params, Z):
        log_sf2 = params.log_sf2
        m = Z.shape[0]
        if params.log_multiscales_m05 is None:
            d2 = sqdist(Z, Z)
            k = jnp.exp(log_sf2 - 0.5 * d2)
            k = jnp.where(jnp.eye(m, dtype=bool), jnp.exp(log_sf2), k)
        else:
            u = _multiscales(params)  # (m, d)
            # scale[r, c, i] = u[r, i] + u[c, i] - 1  > 0 since u > 1/2
            scale = u[:, None, :] + u[None, :, :] - 1.0
            diff = Z[:, None, :] - Z[None, :, :]
            quad = jnp.sum(jnp.square(diff) / scale + jnp.log(scale), axis=-1)
            k = jnp.exp(log_sf2 - 0.5 * quad)
        if params.log_hetero_skedasticity is not None:
            hetero = jnp.exp(params.log_hetero_skedasticity)
            k = k + jnp.diag(hetero)
        return k

    @staticmethod
    def k_diag(params, X):
        sf2 = jnp.exp(params.log_sf2)
        return jnp.full((X.shape[0],), sf2, dtype=X.dtype)

    @staticmethod
    def k_cross(params, X, Z):
        p = SeFat.project(params, X)  # (n, d)
        return SeFat._cross_from_projections(params, p, Z)

    @staticmethod
    def _cross_from_projections(params, p, Z):
        log_sf2 = params.log_sf2
        if params.log_multiscales_m05 is None:
            return jnp.exp(log_sf2 - 0.5 * sqdist(p, Z))
        # Multiscale cross as ONE augmented GEMM:
        #   quad[n, c] = sum_i (p_ni - z_ci)^2 / u_ci + sum_i log u_ci
        #             = [p^2 | p | 1] @ [iu | -2 z*iu | sum(z^2 iu + log u)]'
        # A d-wide contraction is padded to the matrix unit's tile either
        # way, so two separate d-wide GEMMs cost about twice this single
        # (2d+1)-wide one; this runs in the forward AND the backward's
        # recompute.
        u = _multiscales(params)  # (m, d)
        iu = 1.0 / u
        ones = jnp.ones((p.shape[0], 1), p.dtype)
        aug = jnp.concatenate([jnp.square(p), p, ones], axis=1)
        w = jnp.concatenate(
            [
                iu,
                -2.0 * (Z * iu),
                jnp.sum(jnp.square(Z) * iu + jnp.log(u), axis=-1)[:, None],
            ],
            axis=1,
        )
        quad = matmul(aug, w.T)
        return jnp.exp(log_sf2 - 0.5 * quad)

    @staticmethod
    def k_cross_vjp(params, X, Z, knm, knm_bar, kd_bar):
        """Hand-fused pullback of (k_cross, k_diag) -> (params_bar, z_bar).

        With quad[n,c] = sum_i (p_ni - z_ci)^2 iu_ci + sum_i log u_ci
        (iu = 1/u; u = 1 when multiscales are off) and qbar = -1/2
        knm_bar*knm, every cotangent reduces through TWO small GEMMs:

          qbar'[P | P^2 | 1]    -> B1 = qbar'P, B2 = qbar'P^2, cs (col sums)
          qbar [iu | Z*iu]      -> row-side projection pullback

          z_bar     = -2 iu (B1 - Z cs)
          P_bar     =  2 (P (qbar iu) - qbar (Z iu));  tproj_bar = X' P_bar
          u_bar     = iu cs - iu^2 (B2 - 2 Z B1 + Z^2 cs);
                      log_ms_bar = u_bar (u - 1/2)
          log_sf2_bar = sum(knm_bar knm) + sf2 sum(kd_bar)

        Hetero noise enters k_upper only — its k_cross cotangent is zero.
        Same role as se_iso.k_cross_vjp: replaces the AD pullback's several
        (bs, m) intermediates with one elementwise pass.
        """
        sf2 = jnp.exp(params.log_sf2)
        c = knm_bar * knm
        qbar = -0.5 * c
        p = SeFat.project(params, X)
        d = Z.shape[1]
        ms = params.log_multiscales_m05
        u = None if ms is None else _multiscales(params)
        iu = jnp.ones_like(Z) if u is None else 1.0 / u
        aug = jnp.concatenate(
            [p, jnp.square(p), jnp.ones((p.shape[0], 1), p.dtype)], axis=1
        )
        g = matmul(qbar.T, aug)  # (m, 2d + 1)
        b1, b2, cs = g[:, :d], g[:, d:2 * d], g[:, 2 * d]
        z_bar = -2.0 * iu * (b1 - Z * cs[:, None])
        a2 = matmul(qbar, jnp.concatenate([iu, Z * iu], axis=1))  # (bs, 2d)
        if params.tproj is None:
            tproj_bar = None
        else:
            p_rows_bar = 2.0 * (p * a2[:, :d] - a2[:, d:])
            tproj_bar = matmul(X.T, p_rows_bar)
        if u is None:
            ms_bar = None
        else:
            sq = b2 - 2.0 * Z * b1 + jnp.square(Z) * cs[:, None]
            u_bar = iu * cs[:, None] - jnp.square(iu) * sq
            ms_bar = u_bar * (u - 0.5)
        het = params.log_hetero_skedasticity
        return Params(
            d=params.d,
            log_sf2=-2.0 * jnp.sum(cs) + sf2 * jnp.sum(kd_bar),
            tproj=tproj_bar,
            log_hetero_skedasticity=(
                None if het is None else jnp.zeros_like(het)
            ),
            log_multiscales_m05=ms_bar,
        ), z_bar

    @staticmethod
    def k_upper_inputs(params, X):
        # Vanilla SE on projections; multiscales/hetero deliberately ignored
        # to match lib/cov_se_fat.ml:221.
        p = SeFat.project(params, X)
        n = p.shape[0]
        k = jnp.exp(params.log_sf2 - 0.5 * sqdist(p, p))
        return jnp.where(jnp.eye(n, dtype=bool), jnp.exp(params.log_sf2), k)

    @staticmethod
    def k_cross_inputs(params, X1, X2):
        # Data-side cross block, consistent with k_upper_inputs: vanilla SE
        # on projections (multiscales/hetero are inducing-point properties,
        # lib/cov_se_fat.ml:221).
        p1 = SeFat.project(params, X1)
        p2 = SeFat.project(params, X2)
        return jnp.exp(params.log_sf2 - 0.5 * sqdist(p1, p2))

    @staticmethod
    def k_one(params, x):
        return jnp.exp(params.log_sf2)

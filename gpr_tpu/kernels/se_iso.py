"""Isotropic squared-exponential kernel.

k(x, y) = sf2 * exp(-||x - y||^2 / (2 ell^2)),  sf2 = exp(log_sf2).

Reference: lib/cov_se_iso.ml (params at :24, eval at :41-160).  Hypers are
log_ell, log_sf2, and the inducing-point coordinates themselves
(`Inducing_hyper, lib/cov_se_iso.ml:183-202) — under jax.grad the latter come
for free as the gradient w.r.t. Z.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..tree import pytree_dataclass
from .base import sqdist


@pytree_dataclass
class Params:
    log_ell: jnp.ndarray  # scalar
    log_sf2: jnp.ndarray  # scalar


class SeIso:
    name = "se_iso"
    Params = Params
    learn_inducing_default = True

    @staticmethod
    def default_params(X, n_inducing, key=None) -> Params:
        # Reference defaults: log_ell = 0, log_sf2 = 0 (lib/cov_se_iso.ml:122-123).
        dt = X.dtype
        return Params(log_ell=jnp.zeros((), dt), log_sf2=jnp.zeros((), dt))

    @staticmethod
    def inducing_from_inputs(params, X):
        # Inducing points live in input space (lib/cov_se_iso.ml:120).
        return X

    @staticmethod
    def _k_of_d2(params, d2):
        inv_ell2_05 = -0.5 * jnp.exp(-2.0 * params.log_ell)
        return jnp.exp(params.log_sf2 + inv_ell2_05 * d2)

    @staticmethod
    def k_upper(params, Z):
        d2 = sqdist(Z, Z)
        k = SeIso._k_of_d2(params, d2)
        # Exact sf2 on the diagonal (lib/cov_se_iso.ml:81): the sqdist
        # expansion can leave tiny nonzeros there.
        sf2 = jnp.exp(params.log_sf2)
        m = Z.shape[0]
        return jnp.where(jnp.eye(m, dtype=bool), sf2, k)

    @staticmethod
    def k_diag(params, X):
        sf2 = jnp.exp(params.log_sf2)
        return jnp.full((X.shape[0],), sf2, dtype=X.dtype)

    @staticmethod
    def k_cross(params, X, Z):
        return SeIso._k_of_d2(params, sqdist(X, Z))

    @staticmethod
    def k_cross_vjp(params, X, Z, knm, knm_bar, kd_bar):
        """Hand-fused pullback of (k_cross, k_diag) -> (params_bar, z_bar),
        given the already-computed ``knm`` tile.

        Equivalent to ``jax.vjp`` of the pair but with ONE (bs, m)
        elementwise pass (c = knm_bar * knm, with its row/col sums fused)
        and one (m, bs) x (bs, d) GEMM — the AD pullback materializes
        several (bs, m) intermediates (sqdist, its cotangent, the exp
        recompute), the bulk of the backward's elementwise traffic at 1M x 8,
        m=300 (not measured on the H100).  Derivation: with a = ell^-2, q = -a/2,
        knm = exp(log_sf2 + q d2), d2_ij = |x_i|^2 + |z_j|^2 - 2 x_i.z_j:

            log_sf2_bar = sum(c) + sf2 sum(kd_bar)
            log_ell_bar = a sum(c . d2)
                        = a (rs.xx + cs.zz - 2 sum(cX . Z))
            z_bar       = 2q (cs[:, None] * Z - cX)

        where c = knm_bar*knm, rs/cs its row/col sums, cX = c'X.
        """
        from .base import sqdist_cotangent_reduce

        a = jnp.exp(-2.0 * params.log_ell)
        sf2 = jnp.exp(params.log_sf2)
        c = knm_bar * knm
        z_core, c_dot_d2, c_sum = sqdist_cotangent_reduce(c, X, Z)
        p_bar = Params(
            log_ell=a * c_dot_d2,
            log_sf2=c_sum + sf2 * jnp.sum(kd_bar),
        )
        # d2_bar = q c with scalar q = -a/2, so q factors out of z_core
        z_bar = -0.5 * a * z_core
        return p_bar, z_bar

    @staticmethod
    def k_upper_inputs(params, X):
        return SeIso.k_upper(params, X)

    @staticmethod
    def k_one(params, x):
        return jnp.exp(params.log_sf2)

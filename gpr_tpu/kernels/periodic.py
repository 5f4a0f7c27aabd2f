"""Periodic covariance family (MacKay's exp-sine-squared).

No reference counterpart (mmottl/gpr ships five families, none periodic);
this is the standard kernel for seasonal/cyclic structure:

  k(x, z) = sf2 exp(-(2 / ell^2) sum_d sin^2(pi (x_d - z_d) / p))

with one shared period p and lengthscale ell (hyperparameters log_ell,
log_sf2, log_period — all learnable by evidence ascent like every other
family).

GEMM-first evaluation: the naive form needs per-dimension differences — an
(n, m, d) tensor that scales terribly.  Instead use
sin^2(t/2) = (1 - cos t)/2 and the angle-difference identity, so

  sum_d cos(2 pi (x_d - z_d)/p) = Cx Cz' + Sx Sz',
  Cx = cos(2 pi x / p), Sx = sin(2 pi x / p),

i.e. ONE (n, 2d) x (2d, m) GEMM on the [C | S] feature maps — the same
one-GEMM-per-tile structure as ``sqdist`` for the SE families, so the
kernel runs as a GEMM and composes with every engine path (dense,
streaming, sharded, online, multitask, classification) at any n.
Gradients flow by AD through the feature GEMM (no hand VJP needed: the
pullback of a GEMM is two GEMMs, which is already the fused form).
"""

from __future__ import annotations

import jax.numpy as jnp

from ..tree import pytree_dataclass

_TWO_PI = 6.283185307179586


@pytree_dataclass
class Params:
    log_ell: jnp.ndarray  # scalar
    log_sf2: jnp.ndarray  # scalar
    log_period: jnp.ndarray  # scalar


class Periodic:
    name = "periodic"
    Params = Params
    learn_inducing_default = True

    @classmethod
    def default_params(cls, X, n_inducing, key=None) -> Params:
        dt = X.dtype
        return Params(log_ell=jnp.zeros((), dt), log_sf2=jnp.zeros((), dt),
                      log_period=jnp.zeros((), dt))

    @staticmethod
    def inducing_from_inputs(params, X):
        return X

    @classmethod
    def _cos_sum(cls, params, X, Z):
        """sum_d cos(2 pi (x_d - z_d)/p) via the [C | S] feature GEMM."""
        from ..numerics.linalg import matmul

        w = _TWO_PI * jnp.exp(-params.log_period)
        fx = jnp.concatenate([jnp.cos(w * X), jnp.sin(w * X)], axis=1)
        fz = jnp.concatenate([jnp.cos(w * Z), jnp.sin(w * Z)], axis=1)
        return matmul(fx, fz.T)

    @classmethod
    def _k_of_cos(cls, params, cs, d):
        # 2 sum sin^2(./2) / ell^2 = (d - sum cos) / ell^2
        inv_ell2 = jnp.exp(-2.0 * params.log_ell)
        return jnp.exp(params.log_sf2) * jnp.exp(-(d - cs) * inv_ell2)

    @classmethod
    def k_cross(cls, params, X, Z):
        return cls._k_of_cos(params, cls._cos_sum(params, X, Z), X.shape[1])

    @classmethod
    def k_upper(cls, params, Z):
        k = cls.k_cross(params, Z, Z)
        sf2 = jnp.exp(params.log_sf2)
        m = Z.shape[0]
        # exact diagonal (the GEMM's cos-sum rounds near d)
        return jnp.where(jnp.eye(m, dtype=bool), sf2, k)

    @classmethod
    def k_diag(cls, params, X):
        return jnp.full((X.shape[0],), jnp.exp(params.log_sf2), dtype=X.dtype)

    @classmethod
    def k_upper_inputs(cls, params, X):
        return cls.k_upper(params, X)

    @classmethod
    def k_one(cls, params, x):
        return jnp.exp(params.log_sf2)

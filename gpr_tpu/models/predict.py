"""Posterior prediction: means, variances, covariances.

Rebuild of fitc_gp.ml:377-624.  The persisted predictor state matches the
reference exactly — means need only (Z, coeffs); (co)variances need
(Z, chol_km, r_mat) — so a model trained here can be saved and served with the
same artifact shapes as the reference's Marshal blob (bin/ocaml_gpr.ml:179-228).

Two deliberate corrections of apparent upstream inconsistencies, both
documented against the reference:

1. ``covariances_fitc_model_inputs``: the reference (fitc_gp.ml:569-578)
   adds syrk(Q1) where Q1 = diag(sqrt is) Knm R^-1 — i.e. a diag(is)-scaled
   low-rank term — while its own predictor path (:580-593) and its variance
   path (:489-496) use the unscaled Knm B^-1 Kmn.  We use the unscaled form
   everywhere, making diag(covariances) == variances at the same points.
2. ``covariances_fic`` (new inputs): the reference (:615-623) computes the
   FIC diag correction as kt_diag - rowsq(Ktm), omitting the chol_km solve;
   we use kt_diag - rowsq(Ktm U^-1) to match q_t = diag(Qt) as everywhere
   else.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..numerics.linalg import matmul, rows_sqr_norm, solve_tri_right
from ..tree import pytree_dataclass
from .fitc import ModelState, TrainedState


@pytree_dataclass
class MeanPredictor:
    """(inducing, coeffs) — fitc_gp.ml:377-395."""

    z: jnp.ndarray  # (m, dz)
    coeffs: jnp.ndarray  # (m,)


@pytree_dataclass
class CoVariancePredictor:
    """(inducing, chol_km, r_mat) — fitc_gp.ml:430-448."""

    z: jnp.ndarray
    chol_km: jnp.ndarray  # upper U
    r_mat: jnp.ndarray  # upper R


def mean_predictor(trained: TrainedState) -> MeanPredictor:
    return MeanPredictor(z=trained.model.inducing.z, coeffs=trained.coeffs)


def co_variance_predictor(model: ModelState) -> CoVariancePredictor:
    return CoVariancePredictor(
        z=model.inducing.z, chol_km=model.inducing.chol_km, r_mat=model.r_mat
    )


# -- means ------------------------------------------------------------------


def predict_mean_one(family, params, mp: MeanPredictor, x) -> jnp.ndarray:
    """Single-point mean (fitc_gp.ml:398-411): k_m . coeffs."""
    k_m = family.k_cross(params, x[None, :], mp.z)[0]
    return jnp.dot(k_m, mp.coeffs)


def predict_means(family, params, mp: MeanPredictor, X) -> jnp.ndarray:
    """Batch means = Ktm coeffs (fitc_gp.ml:415-427), one GEMV."""
    return matmul(family.k_cross(params, X, mp.z), mp.coeffs)


# -- variances --------------------------------------------------------------


def predict_variances(
    family, params, cvp: CoVariancePredictor, X, sigma2, *, predictive=True
) -> jnp.ndarray:
    """Marginal posterior variances at new inputs (fitc_gp.ml:498-529).

    kt_diag - rowsq(Ktm U^-1) + rowsq(Ktm R^-1) (+ sigma2 if predictive).
    """
    ktm = family.k_cross(params, X, cvp.z)
    kt_diag = family.k_diag(params, X)
    v = solve_tri_right(ktm, cvp.chol_km)
    w = solve_tri_right(ktm, cvp.r_mat)
    out = kt_diag - rows_sqr_norm(v) + rows_sqr_norm(w)
    return out + sigma2 if predictive else out


def predict_variance_one(
    family, params, cvp: CoVariancePredictor, x, sigma2, *, predictive=True
) -> jnp.ndarray:
    """Single-point variance (fitc_gp.ml:451-483)."""
    return predict_variances(
        family, params, cvp, x[None, :], sigma2, predictive=predictive
    )[0]


def variances_model_inputs(model: ModelState, *, predictive=True) -> jnp.ndarray:
    """Variances at the training inputs, reusing r and Knm
    (fitc_gp.ml:489-496): r + rowsq(Knm R^-1)."""
    w = solve_tri_right(model.knm, model.r_mat)
    out = model.r + rows_sqr_norm(w)
    return out + model.sigma2 if predictive else out


# -- covariances ------------------------------------------------------------


def _finalize_cov(cov, sigma2, predictive):
    if predictive:
        n = cov.shape[0]
        cov = cov + sigma2 * jnp.eye(n, dtype=cov.dtype)
    return cov


def covariances_fitc(
    family, params, cvp: CoVariancePredictor, X, sigma2, *, predictive=True
) -> jnp.ndarray:
    """Full posterior covariance, FITC flavor (fitc_gp.ml:580-593):
    exact prior Kt - Ktm Km^-1 Kmt + Ktm B^-1 Kmt."""
    kt = family.k_upper_inputs(params, X)
    ktm = family.k_cross(params, X, cvp.z)
    v = solve_tri_right(ktm, cvp.chol_km)
    w = solve_tri_right(ktm, cvp.r_mat)
    cov = kt - matmul(v, v.T) + matmul(w, w.T)
    return _finalize_cov(cov, sigma2, predictive)


def covariances_fitc_model_inputs(
    model: ModelState, family, params, X, *, predictive=True
) -> jnp.ndarray:
    """FITC covariances at the training inputs, reusing V and R
    (fitc_gp.ml:569-578, with the documented scaling correction):
    Kt - V V' + (Knm R^-1)(Knm R^-1)'."""
    kt = family.k_upper_inputs(params, X)
    w = solve_tri_right(model.knm, model.r_mat)
    cov = kt - matmul(model.v, model.v.T) + matmul(w, w.T)
    return _finalize_cov(cov, model.sigma2, predictive)


def covariances_fic(
    family, params, cvp: CoVariancePredictor, X, sigma2, *, predictive=True
) -> jnp.ndarray:
    """Full posterior covariance, FIC flavor (fitc_gp.ml:597-623): low-rank
    Ktm B^-1 Kmt plus the diagonal correction diag(kt_diag - diag(Qt))."""
    ktm = family.k_cross(params, X, cvp.z)
    kt_diag = family.k_diag(params, X)
    v = solve_tri_right(ktm, cvp.chol_km)
    r_t = kt_diag - rows_sqr_norm(v)
    w = solve_tri_right(ktm, cvp.r_mat)
    cov = matmul(w, w.T) + jnp.diag(r_t)
    return _finalize_cov(cov, sigma2, predictive)


def covariances_fic_model_inputs(model: ModelState, *, predictive=True) -> jnp.ndarray:
    """FIC covariances at the training inputs (fitc_gp.ml:608-613, with the
    same scaling correction): diag(r) + Knm B^-1 Kmn."""
    w = solve_tri_right(model.knm, model.r_mat)
    cov = matmul(w, w.T) + jnp.diag(model.r)
    return _finalize_cov(cov, model.sigma2, predictive)

"""Sparse GP engine: FITC / FIC, standard and variational (Titsias-style).

JAX rebuild of the evaluation core of lib/fitc_gp.ml (:29-851).  The
reference's functor instantiation ``Make_FITC(Cov)`` becomes plain function
calls parameterized by a kernel *family* (static) and its params PyTree
(traced); every step is jit-compatible and differentiable end to end.

Math (identical to the reference and to the independent oracle test/oct.m):

    U  = chol(Km + jitter I)          (upper, Km = K(Z, Z))
    V  = Knm U^-1                     so V V' = Knm Km^-1 Kmn        [trsm]
    r  = kn_diag - rowsq(V)           FITC diagonal correction
    s  = r + sigma2,  is = 1/s
    B  = Km + jitter I + Knm' diag(is) Knm
    R  = upper factor with R'R = B    (stacked QR or Cholesky, see below)
    l1 = -1/2 (log|B| - log|Km| + sum log s + n log 2pi)
    variational l1 adds -1/2 sum(is * r)                 (fitc_gp.ml:259-270)
    y_ = sqrt(is) * y
    t  = R^-T Knm' (is * y)           (= Q1' y_ in the QR formulation)
    l2 = -1/2 (|y_|^2 - |t|^2)
    coeffs = R^-1 t                   posterior mean weights

Factorization of B: the reference QR-factors the stacked (n+m, m) matrix
[diag(sqrt is) Knm; U] (fitc_gp.ml:168-203, Foster 2009) and never forms B.
With the sign convention diag(R) > 0, that R *is* chol(B), so both paths feed
identical downstream formulas; 'chol' avoids the tall QR (one syrk GEMM +
an m^3 factorization) and is the path that shards over the data axis, 'qr'
is the maximally stable choice for ill-conditioned Km.  See
numerics.linalg.tsqr_r for the sharded stable middle ground.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp

from ..config import config
from ..numerics.linalg import (
    cholesky_upper,
    log_det_tri,
    matmul,
    qr_r_positive,
    rows_sqr_norm,
    solve_tri,
    solve_tri_right,
)
from ..tree import pytree_dataclass

LOG_2PI = math.log(2.0 * math.pi)


@pytree_dataclass
class InducingState:
    """Precomputed inducing-point quantities (fitc_gp.ml:36-57)."""

    z: jnp.ndarray  # (m, dz) inducing representation
    km: jnp.ndarray  # (m, m) K(Z, Z), no jitter
    chol_km: jnp.ndarray  # upper U: Km + jitter I = U'U
    log_det_km: jnp.ndarray  # log|Km + jitter I|


@pytree_dataclass
class ModelState:
    """Everything the evidence and predictors need (fitc_gp.ml:132-256)."""

    inducing: InducingState
    sigma2: jnp.ndarray
    kn_diag: jnp.ndarray  # (n,)
    knm: jnp.ndarray  # (n, m)
    v: jnp.ndarray  # (n, m) = Knm U^-1
    r: jnp.ndarray  # (n,)  FITC diag correction
    is_: jnp.ndarray  # (n,)  1 / (r + sigma2)
    sqrt_is: jnp.ndarray  # (n,)
    r_mat: jnp.ndarray  # (m, m) upper, R'R = B
    l1: jnp.ndarray  # scalar


@pytree_dataclass
class TrainedState:
    """Model conditioned on targets (fitc_gp.ml:273-303)."""

    model: ModelState
    y: jnp.ndarray  # (n,)
    coeffs: jnp.ndarray  # (m,)
    l2: jnp.ndarray
    l: jnp.ndarray  # total log evidence l1 + l2


# ---------------------------------------------------------------------------
# Inducing-point selection (fitc_gp.ml:62-89)
# ---------------------------------------------------------------------------


def choose_n_first_inputs(family, params, X, n_inducing: int) -> jnp.ndarray:
    """First-n selection (fitc_gp.ml:66-72)."""
    return family.inducing_from_inputs(params, X[:n_inducing])


def choose_n_random_inputs(key, family, params, X, n_inducing: int) -> jnp.ndarray:
    """Uniform random subset — the reference's Fisher-Yates draw
    (fitc_gp.ml:74-89) becomes jax.random.choice without replacement."""
    idx = jax.random.choice(key, X.shape[0], (n_inducing,), replace=False)
    return family.inducing_from_inputs(params, X[idx])


def choose_kmeans_inputs(
    key,
    family,
    params,
    X,
    n_inducing: int,
    *,
    iters: int = 10,
    subsample: int | None = 100_000,
) -> jnp.ndarray:
    """k-means inducing initialization — an extension; the reference only
    draws a random subset (fitc_gp.ml:74-89).  Centroids cover the input
    density instead of sampling it, which matters exactly when m << n and
    the data is clustered (tests/test_model_misc.py shows the evidence
    gain on clustered data).

    Lloyd iterations under one jit: assignment is the sqdist
    GEMM + a row argmin; the update contracts one-hot assignments against
    X (two GEMMs — no scatter, same rationale as kernels/task.py).  Empty
    clusters keep their previous centroid.  ``subsample`` bounds the
    per-iteration cost at large n (1e5 rows locate centroids to well
    under inducing-scale resolution).

    Returns the family's inducing representation of the centroids, like
    the other choosers.  For integer-structured columns (the ICM task
    id), prefer random/first selection — k-means averages them.
    """
    from ..kernels.base import sqdist

    n = X.shape[0]
    if subsample is not None and n > subsample:
        key, sub = jax.random.split(key)
        idx = jax.random.choice(sub, n, (subsample,), replace=False)
        X = X[idx]
        n = subsample
    k_init, _ = jax.random.split(key)
    idx0 = jax.random.choice(k_init, n, (n_inducing,), replace=False)

    def lloyd(c, _):
        assign = jnp.argmin(sqdist(X, c), axis=1)  # (n,)
        onehot = jax.nn.one_hot(assign, n_inducing, dtype=X.dtype)  # (n, m)
        counts = jnp.sum(onehot, axis=0)  # (m,)
        sums = matmul(onehot.T, X)  # (m, d)
        c_new = jnp.where(
            counts[:, None] > 0, sums / jnp.maximum(counts, 1.0)[:, None], c
        )
        return c_new, None

    centroids, _ = jax.lax.scan(lloyd, X[idx0], None, length=iters)
    return family.inducing_from_inputs(params, centroids)


# ---------------------------------------------------------------------------
# Core computation
# ---------------------------------------------------------------------------


def calc_inducing(family, params, z, jitter: float | None = None) -> InducingState:
    """K(Z,Z), its jittered Cholesky and log-det (fitc_gp.ml:53-57)."""
    km = family.k_upper(params, z)
    chol_km = cholesky_upper(km, jitter)
    return InducingState(
        z=z, km=km, chol_km=chol_km, log_det_km=log_det_tri(chol_km)
    )


def _resolve_factorization(factorization: str | None, n: int, m: int) -> str:
    f = factorization or config.factorization
    if f == "auto":
        # The tall QR costs ~2x the syrk flops and does not shard; keep it for
        # small problems where stability is free, switch to chol at scale.
        f = "qr" if n * m <= (1 << 24) else "chol"
    return f


def _calc_r_factor(inducing, knm, v, sqrt_is, factorization):
    """Upper R with R'R = B = (Km + jitter I) + Knm' diag(is) Knm.

    The chol path factors the *whitened* matrix I + (V sqrt(is))'(V sqrt(is))
    and de-whitens R = R~ U: mathematically identical to chol(B) but the
    Cholesky target has eigenvalues >= 1, so it neither fails nor loses
    accuracy when Km is ill-conditioned — in f32 this is ~4 orders of
    magnitude more accurate than factoring B directly (an ill-conditioned
    1-D example: 0.19 vs 16 nats of evidence error against f64 truth), the
    same robustness Foster-2009's QR buys the reference.
    """
    if factorization == "qr":
        a1 = knm * sqrt_is[:, None]
        stacked = jnp.concatenate([a1, inducing.chol_km], axis=0)
        return qr_r_positive(stacked)
    a = v * sqrt_is[:, None]
    m = v.shape[1]
    bt = jnp.eye(m, dtype=v.dtype) + matmul(a.T, a)
    r_tilde = cholesky_upper(bt, jitter=0.0)
    return matmul(r_tilde, inducing.chol_km)


def calc_model(
    family,
    params,
    X,
    z,
    sigma2,
    *,
    variational: bool = False,
    factorization: str | None = None,
    jitter: float | None = None,
    inducing: InducingState | None = None,
    kn_diag=None,
    knm=None,
) -> ModelState:
    """Full model precomputation (fitc_gp.ml:151-232).

    ``variational=True`` applies the Titsias correction to l1
    (fitc_gp.ml:259-270; oct.m:162 ``vl1 = l1 - 0.5 is' r``).
    Precomputed pieces can be passed to avoid recomputation.
    """
    if inducing is None:
        inducing = calc_inducing(family, params, z, jitter)
    if kn_diag is None:
        kn_diag = family.k_diag(params, X)
    if knm is None:
        knm = family.k_cross(params, X, inducing.z)
    n = knm.shape[0]
    m = knm.shape[1]

    v = solve_tri_right(knm, inducing.chol_km)  # Knm U^-1   [trsm]
    r = kn_diag - rows_sqr_norm(v)  # fitc_gp.ml:222-223
    s = r + sigma2
    is_ = 1.0 / s
    sqrt_is = jnp.sqrt(is_)

    fact = _resolve_factorization(factorization, n, m)
    r_mat = _calc_r_factor(inducing, knm, v, sqrt_is, fact)

    log_det_b = log_det_tri(r_mat)
    log_det_s = jnp.sum(jnp.log(s))
    l1 = -0.5 * (log_det_b - inducing.log_det_km + log_det_s + n * LOG_2PI)
    if variational:
        l1 = l1 - 0.5 * jnp.dot(is_, r)

    return ModelState(
        inducing=inducing,
        sigma2=jnp.asarray(sigma2, dtype=knm.dtype),
        kn_diag=kn_diag,
        knm=knm,
        v=v,
        r=r,
        is_=is_,
        sqrt_is=sqrt_is,
        r_mat=r_mat,
        l1=l1,
    )


def update_sigma2(
    model: ModelState, sigma2, *, variational: bool = False,
    factorization: str | None = None
) -> ModelState:
    """Re-derive s/is/R/l1 for a new noise level, reusing kn_diag/Knm/V
    (fitc_gp.ml:234-236)."""
    return calc_model(
        None,
        None,
        None,
        None,
        sigma2,
        variational=variational,
        factorization=factorization,
        inducing=model.inducing,
        kn_diag=model.kn_diag,
        knm=model.knm,
    )


def calc_trained(model: ModelState, y) -> TrainedState:
    """Condition on targets (fitc_gp.ml:279-292; oct.m:119-124).

    t = R^-T Knm' (is * y) equals Q1' y_ of the reference's QR formulation
    (A1 = Q1 R  =>  A1' y_ = R' Q1' y_), so no orthogonal factor is needed.
    """
    y_ = y * model.sqrt_is
    u = matmul(model.knm.T, model.is_ * y)  # (m,)
    t = solve_tri(model.r_mat, u, trans=True)  # R^-T u
    # quad >= 0 mathematically; clamp the f32 cancellation overshoot that
    # would otherwise INFLATE the evidence (see streaming._evidence_terms).
    l2 = -0.5 * jnp.maximum(jnp.dot(y_, y_) - jnp.dot(t, t), 0.0)
    coeffs = solve_tri(model.r_mat, t)  # R^-1 t   [trsv]
    return TrainedState(model=model, y=y, coeffs=coeffs, l2=l2, l=model.l1 + l2)


def calc_means(trained) -> jnp.ndarray:
    """Posterior means at the training inputs (fitc_gp.ml:297-298).

    Streaming trained states (models.streaming.StreamingTrained) carry the
    blockwise-precomputed means; the dense state multiplies Knm on demand.
    """
    means = getattr(trained, "means", None)
    if means is not None:
        return means
    return matmul(trained.model.knm, trained.coeffs)


def co_variance_coeffs(model: ModelState):
    """The (chol_km, r_mat) pair the reference persists for later variance
    prediction (fitc_gp.ml:255)."""
    return model.inducing.chol_km, model.r_mat


# ---------------------------------------------------------------------------
# One-call evidence — the pure function optimizers differentiate
# ---------------------------------------------------------------------------


def log_evidence(
    family,
    params,
    z,
    sigma2,
    X,
    y,
    *,
    variational: bool = False,
    factorization: str | None = None,
    jitter: float | None = None,
) -> jnp.ndarray:
    """Scalar log marginal evidence l = l1 + l2.

    jax.value_and_grad of this function w.r.t. (params, z, sigma2) replaces the
    reference's entire hand-derived gradient machinery (fitc_gp.ml:853-2278);
    the reference's formulas survive as the finite-difference oracle in
    tests/.
    """
    model = calc_model(
        family, params, X, z, sigma2,
        variational=variational, factorization=factorization, jitter=jitter,
    )
    return calc_trained(model, y).l

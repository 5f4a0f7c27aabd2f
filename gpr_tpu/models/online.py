"""Online (incremental) posterior updates with fixed hyperparameters.

The reference sketches an ``Online`` module but ships it commented out
(lib/fitc_gp.ml:2022-2053 — "add_samples" over a trained model); this is
the working JAX version.  The key structural fact (same one the
streaming evidence exploits): for fixed (kernel params, inducing Z, sigma2)
the FITC posterior and evidence depend on the data ONLY through the O(m^2)
sufficient statistics

    G  = sum (V sqrt(is))' (V sqrt(is)),   u = V' (is y),
    sum log s,  y' is y,  sum is r,  n            (models/streaming.py)

which are SUMS over rows.  Adding (or removing) a batch of b observations
is therefore an O(b m^2) statistics update plus the O(m^3) whitened
epilogue — no refit, no n-sized state, exact (not approximate): the online
posterior equals the batch posterior on the concatenated data to roundoff
(tests/test_online.py).

Removal (downdate) subtracts the batch's contribution: algebraically exact,
and the state carries Knuth two-sum compensation terms (``stats_lo``) so the
add-then-remove round trip cancels to ~1 ulp of the SURVIVING data even in
f32 — the rounding error of every add/subtract is captured instead of
accumulating.  The irreducible f32 error left is the per-batch GEMM rounding
of the statistics themselves (tests/test_online.py bounds it).

Hyperparameters stay fixed across updates by construction — the statistics
are hyper-dependent, exactly why the reference's sketch also conditions on
a trained model.  To move hypers, retrain (optim.train) from the current
values.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..numerics.linalg import inv_tri_upper, matmul, rows_sqr_norm
from ..tree import pytree_dataclass
from .fitc import calc_inducing
from .stream_grad import _two_sum
from .streaming import (
    StreamStats,
    _acc_dtype,
    _dewhiten,
    _whitened_solve,
    evidence_from_stats,
    stream_stats,
)


@pytree_dataclass
class OnlineState:
    """Inducing quantities + running sufficient statistics.

    ``stats`` is the running (hi) sum; ``stats_lo`` holds the two-sum
    compensation of every update/downdate so the pair represents each
    statistic to roughly double working precision (what makes f32
    downdates usable — see module docstring)."""

    inducing: object  # InducingState
    u_inv: jnp.ndarray  # (m, m) upper, U^-1 (precomputed once)
    sigma2: jnp.ndarray
    stats: StreamStats
    stats_lo: StreamStats


def _zero_stats(m, acc):
    return StreamStats(
        gram=jnp.zeros((m, m), acc),
        u_vec=jnp.zeros((m,), acc),
        log_det_s=jnp.zeros((), acc),
        y_is_y=jnp.zeros((), acc),
        is_r_sum=jnp.zeros((), acc),
        n=jnp.zeros((), acc),
    )


def online_init(family, params, z, sigma2, *, jitter=None) -> OnlineState:
    """Empty posterior (prior) over the given inducing representation."""
    inducing = calc_inducing(family, params, z, jitter)
    m = inducing.z.shape[0]
    acc = _acc_dtype()
    return OnlineState(
        inducing=inducing,
        u_inv=inv_tri_upper(inducing.chol_km),
        sigma2=jnp.asarray(sigma2, inducing.km.dtype),
        stats=_zero_stats(m, acc),
        stats_lo=_zero_stats(m, acc),
    )


def _folded_stats(st: OnlineState) -> StreamStats:
    """hi + lo: one final rounding instead of one per update."""
    return jax.tree.map(lambda h, l: h + l, st.stats, st.stats_lo)


def _batch_stats(family, params, st: OnlineState, X, y) -> StreamStats:
    """Sufficient statistics of one batch (single tile; use stream_stats for
    huge batches)."""
    acc = _acc_dtype()
    knm = family.k_cross(params, X, st.inducing.z)
    kd = family.k_diag(params, X)
    v = matmul(knm, st.u_inv)
    r = kd - rows_sqr_norm(v)
    s = r + st.sigma2
    is_ = 1.0 / s
    a = v * jnp.sqrt(is_)[:, None]
    return StreamStats(
        gram=matmul(a.T, a).astype(acc),
        u_vec=matmul(v.T, is_ * y).astype(acc),
        log_det_s=jnp.sum(jnp.log(s)).astype(acc),
        y_is_y=jnp.sum(is_ * y * y).astype(acc),
        is_r_sum=jnp.sum(is_ * r).astype(acc),
        n=jnp.asarray(X.shape[0], acc),
    )


def _apply_batch(st: OnlineState, batch: StreamStats, sign) -> OnlineState:
    """Compensated (hi, lo) += sign * batch, leafwise over the statistics.
    The two-sum captures the rounding error of every add AND subtract, so
    downdates do not catastrophically cancel in f32 (the subtraction's error
    lands in stats_lo instead of being lost)."""

    def step(hi, lo, b):
        h2, l2 = _two_sum(hi, lo, sign * b)
        return h2, l2

    pairs = jax.tree.map(step, st.stats, st.stats_lo, batch)
    new_hi = jax.tree.map(lambda p: p[0], pairs,
                          is_leaf=lambda x: isinstance(x, tuple))
    new_lo = jax.tree.map(lambda p: p[1], pairs,
                          is_leaf=lambda x: isinstance(x, tuple))
    return OnlineState(inducing=st.inducing, u_inv=st.u_inv,
                       sigma2=st.sigma2, stats=new_hi, stats_lo=new_lo)


def online_update(family, params, st: OnlineState, X, y, *,
                  block_size: int | None = None) -> OnlineState:
    """Fold a batch of observations into the posterior — O(b m^2)."""
    if block_size is not None:
        batch = stream_stats(
            family, params, st.inducing, st.sigma2, X, y,
            block_size=block_size, grad_impl="ad", remat=False,
        )
    else:
        batch = _batch_stats(family, params, st, X, y)
    return _apply_batch(st, batch, 1.0)


def online_downdate(family, params, st: OnlineState, X, y, *,
                    block_size: int | None = None) -> OnlineState:
    """Remove a previously added batch (exact algebra; compensated — see
    module docstring for the f32 error class)."""
    if block_size is not None:
        batch = stream_stats(
            family, params, st.inducing, st.sigma2, X, y,
            block_size=block_size, grad_impl="ad", remat=False,
        )
    else:
        batch = _batch_stats(family, params, st, X, y)
    return _apply_batch(st, batch, -1.0)


def online_log_evidence(st: OnlineState, *, variational=False) -> jnp.ndarray:
    return evidence_from_stats(st.inducing, _folded_stats(st),
                               variational=variational)


def online_predictors(st: OnlineState):
    """(MeanPredictor, CoVariancePredictor) for the current posterior —
    plug into models.predict.* unchanged."""
    from .predict import CoVariancePredictor, MeanPredictor

    r_tilde, t = _whitened_solve(st.inducing, _folded_stats(st))
    coeffs, r_mat = _dewhiten(st.inducing, r_tilde, t)
    return (
        MeanPredictor(z=st.inducing.z, coeffs=coeffs),
        CoVariancePredictor(
            z=st.inducing.z, chol_km=st.inducing.chol_km, r_mat=r_mat
        ),
    )

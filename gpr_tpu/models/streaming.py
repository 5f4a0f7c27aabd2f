"""Streaming (blockwise) evidence: large-n FITC without materializing Knm.

The reference's evidence walks an explicit n x m cross-covariance three times
(build Knm, trsm to V, syrk the Gram — fitc_gp.ml:151-229), which at
n = 10^6, m = 300 means multiple GB of HBM traffic per evaluation.  Here the
whole computation is a reduction over row blocks: for each block of inputs,
compute the Knm tile, immediately fold it into the m x m Gram
statistic, the m-vector Knm' (is * y), and the scalar pieces of l1/l2, and
discard it.  HBM traffic drops to reading X once (n*d elements) plus O(m^2)
carry — the blockwise/ring structure SURVEY.md section 5 calls for, expressed
as lax.scan so XLA pipelines it and jax.checkpoint rematerializes tiles in
the backward pass instead of storing them.

Stability: instead of accumulating the raw Gram Knm' diag(is) Knm (whose
Cholesky target B = Km + Gram inherits Km's near-null directions — in f32
the Gram's rounding asymmetry can push B indefinite and NaN the whole
evidence), the scan accumulates the *whitened* statistic
G = sum (V sqrt(is))' (V sqrt(is)) with V = Knm U^-1.  The factorization
target becomes I + G (eigenvalues >= 1: unconditionally Cholesky-safe), and
log|B| - log|Km| = log|I + G| falls out directly — the streaming analogue of
the reference's Foster-2009 QR stability argument (gpr_manual.tex:221-223).
All reduced statistics are accumulated in f64 when enabled (SURVEY.md hard
part (e)).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.ad_checkpoint import checkpoint_name

from ..numerics.linalg import (
    cholesky_upper,
    inv_tri_upper,
    log_det_tri,
    matmul,
    matmul_acc,
    rows_sqr_norm,
    solve_tri,
)
from ..tree import pytree_dataclass
from .fitc import LOG_2PI, calc_inducing

def _acc_dtype():
    """f64 accumulators when x64 is enabled; plain f32 otherwise (avoids
    per-op truncation warnings under the default f32 config)."""
    return jnp.float64 if jax.config.jax_enable_x64 else jnp.float32


@pytree_dataclass
class StreamStats:
    """Sufficient statistics of one pass over the data.

    Everything the evidence (standard or variational) and its gradient need:
    the n-axis has been reduced away, so memory is O(m^2).
    """

    gram: jnp.ndarray  # (m, m)  whitened: U^-T Knm' diag(is) Knm U^-1
    u_vec: jnp.ndarray  # (m,)    whitened: U^-T Knm' (is * y)
    log_det_s: jnp.ndarray  # sum log s
    y_is_y: jnp.ndarray  # y' diag(is) y
    is_r_sum: jnp.ndarray  # sum(is * r)   (variational correction)
    n: jnp.ndarray  # number of (real) rows


def _pad_blocks(X, y, mask, block_size):
    n = X.shape[0]
    nb = -(-n // block_size)
    pad = nb * block_size - n
    if mask is None:
        mask = jnp.ones((n,), X.dtype)
    if pad:
        X = jnp.concatenate([X, jnp.zeros((pad, X.shape[1]), X.dtype)])
        y = jnp.concatenate([y, jnp.zeros((pad,), y.dtype)])
        mask = jnp.concatenate([mask, jnp.zeros((pad,), mask.dtype)])
    return (
        X.reshape(nb, block_size, X.shape[1]),
        y.reshape(nb, block_size),
        mask.reshape(nb, block_size),
    )


def stream_stats(
    family, params, inducing, sigma2, X, y, *, block_size: int = 8192,
    remat: bool = True, mask=None, unroll: int = 1,
    remat_policy: str = "recompute_all", grad_impl: str = "custom",
    grad_precision=None, grad_variant: str = "base",
) -> StreamStats:
    """One scan over row blocks accumulating StreamStats.

    V tiles are formed as ``knm_tile @ U^-1`` (a GEMM against the
    precomputed inverse Cholesky factor) rather than a per-tile triangular
    solve — a GEMM parallelizes where trsm serializes, and U is m x m, so
    inverting it once is O(m^3) amortized over the whole pass.

    ``mask`` (n,) of 0/1 weights lets callers exclude padding rows (the
    sharded path pads globally before splitting across devices).

    ``grad_impl`` selects the reverse-mode path: ``"custom"`` (default) uses
    the hand-fused VJP of models/stream_grad.py (4 large GEMMs per tile —
    ~1/3 fewer backward flops than checkpointed AD, bitwise-class identical
    gradients); ``"ad"`` keeps plain jax.checkpoint AD through the scan body
    (honors ``remat``/``remat_policy``).
    """
    m = inducing.z.shape[0]
    u_inv = inv_tri_upper(inducing.chol_km)
    xb, yb, maskb = _pad_blocks(X, y, mask, block_size)

    # Per-row noise (sigma2 of shape (n,)): the heteroskedastic evidence —
    # the Student-t M-step at n >> HBM, or user-supplied measurement
    # errors.  Streams on the AD path only (the hand-fused VJP assumes a
    # scalar); differentiable w.r.t. the vector.
    if jnp.ndim(sigma2) == 1:
        nzb = _pad_blocks(X, sigma2, mask, block_size)[1]  # y-slot blocking
        grad_impl = "ad"
    else:
        nzb = None

    if grad_impl == "custom":
        from .stream_grad import make_stream_stats_cv

        core = make_stream_stats_cv(
            family, unroll, grad_precision, bwd_variant=grad_variant
        )
        gram, u_vec, lds, yiy, isr, cnt = core(
            params, inducing.z, u_inv, sigma2, xb, yb, maskb
        )
        return StreamStats(
            gram=gram, u_vec=u_vec, log_det_s=lds, y_is_y=yiy,
            is_r_sum=isr, n=cnt,
        )

    save_kernel = remat_policy == "save_kernel"

    def body(carry, blk):
        if nzb is None:
            x_b, y_b, mask_b = blk
            noise_b = sigma2
        else:
            x_b, y_b, mask_b, noise_b = blk
            noise_b = noise_b.astype(inducing.z.dtype)
        x_b = x_b.astype(inducing.z.dtype)  # bf16 storage mode upcast
        y_b = y_b.astype(inducing.z.dtype)
        mask_b = mask_b.astype(inducing.z.dtype)
        knm = family.k_cross(params, x_b, inducing.z)
        if save_kernel:
            # keep the cross-covariance tiles for the backward pass (costs
            # n*m floats of HBM) instead of re-evaluating the kernel
            knm = checkpoint_name(knm, "knm")
        kd = family.k_diag(params, x_b)
        v = matmul(knm, u_inv)
        r = kd - rows_sqr_norm(v)
        # Padded rows are gated on both sides of every nonlinearity (sqrt,
        # log, reciprocal): a plain mask-multiply leaves inf derivatives that
        # turn into NaN via inf * 0 in the backward pass.
        live = mask_b > 0
        s = jnp.where(live, r + noise_b, 1.0)
        is_ = mask_b / s
        sqrt_is = jnp.where(live, jnp.sqrt(jnp.where(live, is_, 1.0)), 0.0)
        a = v * sqrt_is[:, None]  # whitened rows: (V sqrt(is)) tile
        gram, u_vec, lds, yiy, isr, cnt = carry
        gram = gram + matmul_acc(a.T, a).astype(_acc_dtype())
        u_vec = u_vec + matmul_acc(v.T, is_ * y_b).astype(_acc_dtype())
        lds = lds + jnp.sum(mask_b * jnp.log(s)).astype(_acc_dtype())
        yiy = yiy + jnp.sum(is_ * y_b * y_b).astype(_acc_dtype())
        isr = isr + jnp.sum(is_ * r).astype(_acc_dtype())
        cnt = cnt + jnp.sum(mask_b).astype(_acc_dtype())
        return (gram, u_vec, lds, yiy, isr, cnt), None

    if remat:
        if save_kernel:
            body = jax.checkpoint(
                body,
                policy=jax.checkpoint_policies.save_only_these_names("knm"),
            )
        else:
            body = jax.checkpoint(body)

    init = (
        jnp.zeros((m, m), _acc_dtype()),
        jnp.zeros((m,), _acc_dtype()),
        jnp.zeros((), _acc_dtype()),
        jnp.zeros((), _acc_dtype()),
        jnp.zeros((), _acc_dtype()),
        jnp.zeros((), _acc_dtype()),
    )
    xs = (xb, yb, maskb) if nzb is None else (xb, yb, maskb, nzb)
    (gram, u_vec, lds, yiy, isr, cnt), _ = jax.lax.scan(
        body, init, xs, unroll=unroll
    )
    return StreamStats(
        gram=gram, u_vec=u_vec, log_det_s=lds, y_is_y=yiy, is_r_sum=isr, n=cnt
    )


def _whitened_factor(inducing, stats):
    """Upper R~ with R~'R~ = I + G (G the whitened Gram).  Eigenvalues of the
    target are >= 1, so this Cholesky cannot fail — no extra jitter."""
    dt = inducing.km.dtype
    m = stats.gram.shape[0]
    bt = jnp.eye(m, dtype=_acc_dtype()) + stats.gram
    return cholesky_upper(bt.astype(dt), jitter=0.0)


def _whitened_solve(inducing, stats: StreamStats):
    """(r_tilde, t): the shared core of every whitened epilogue."""
    dt = inducing.km.dtype
    r_tilde = _whitened_factor(inducing, stats)
    t = solve_tri(r_tilde, stats.u_vec.astype(dt), trans=True)
    return r_tilde, t


def _evidence_terms(stats: StreamStats, r_tilde, t, *, variational):
    """(l1, l2) in the accumulator dtype; log|B| - log|Km| = log|I + G|."""
    l1 = -0.5 * (
        log_det_tri(r_tilde).astype(_acc_dtype())
        + stats.log_det_s
        + stats.n * LOG_2PI
    )
    if variational:
        l1 = l1 - 0.5 * stats.is_r_sum
    # quad = y' (S + V V')^-1 y = y_is_y - t't >= 0 mathematically (Woodbury
    # projection).  In f32 (and especially with bf16 accumulation inputs) a
    # near-singular I + G makes t't overshoot y_is_y by cancellation, which
    # INFLATES the evidence — measured: a broad-ell L-BFGS probe at the
    # bench shape read mean-NLL -1.55 where the perfect-fit floor of its
    # synthetic is +0.215, and multi-start selection then picked that basin
    # (BENCH_r04.json at commit b587de6, fit_restarts line, 4th probe
    # raw-f32 -1.5509 vs rescored_f64 1.1649).  Clamping at the mathematical bound
    # only ever alters values that were already wrong.
    l2 = -0.5 * jnp.maximum(
        stats.y_is_y - jnp.dot(t, t).astype(_acc_dtype()), 0.0
    )
    return l1, l2


def _dewhiten(inducing, r_tilde, t):
    """(coeffs, r_mat): R = R~ U, coeffs = U^-1 R~^-1 t."""
    coeffs = solve_tri(inducing.chol_km, solve_tri(r_tilde, t))
    r_mat = matmul(r_tilde, inducing.chol_km)
    return coeffs, r_mat


def evidence_from_stats(
    inducing, stats: StreamStats, *, variational: bool = False
) -> jnp.ndarray:
    """l = l1 + l2 from the reduced statistics — pure O(m^3) epilogue,
    identical math to fitc.calc_model/calc_trained via the whitened
    identity log|B| - log|Km + jitter I| = log|I + G|."""
    r_tilde, t = _whitened_solve(inducing, stats)
    l1, l2 = _evidence_terms(stats, r_tilde, t, variational=variational)
    return (l1 + l2).astype(inducing.km.dtype)


def streaming_log_evidence(
    family,
    params,
    z,
    sigma2,
    X,
    y,
    *,
    variational: bool = False,
    block_size: int = 8192,
    jitter: float | None = None,
    unroll: int = 1,
    remat_policy: str = "recompute_all",
    grad_impl: str = "custom",
    grad_precision=None,
    grad_variant: str = "base",
) -> jnp.ndarray:
    """Drop-in replacement for models.fitc.log_evidence at large n.

    Differentiable w.r.t. (params, z, sigma2): the backward pass re-forms
    each Knm tile (hand-fused VJP by default, jax.checkpoint for
    ``grad_impl="ad"``) so peak memory stays O(block m + m^2).
    """
    inducing = calc_inducing(family, params, z, jitter)
    stats = stream_stats(
        family, params, inducing, sigma2, X, y, block_size=block_size,
        unroll=unroll, remat_policy=remat_policy, grad_impl=grad_impl,
        grad_precision=grad_precision, grad_variant=grad_variant,
    )
    return evidence_from_stats(inducing, stats, variational=variational)


@pytree_dataclass
class StreamingModelLite:
    """The O(m^2) slice of ModelState a trained streaming model needs for
    reporting and persistence: no n-sized members (knm/v/r/is live only as
    tiles inside the scan)."""

    inducing: object  # InducingState
    sigma2: jnp.ndarray
    r_mat: jnp.ndarray  # (m, m) upper, de-whitened
    l1: jnp.ndarray


@pytree_dataclass
class StreamingTrained:
    """TrainedState analogue for the streaming path.  ``means`` is
    precomputed blockwise (models.fitc.calc_means returns it directly), so
    calc_stats and the CLI reporting work without ever materializing Knm."""

    model: StreamingModelLite
    y: jnp.ndarray
    coeffs: jnp.ndarray
    means: jnp.ndarray
    l: jnp.ndarray


def streaming_trained(
    family, params, z, sigma2, X, y, *, variational=False, block_size=8192,
    jitter=None,
) -> StreamingTrained:
    """Condition on targets with O(block m + m^2) memory: the large-n
    equivalent of calc_model + calc_trained (fitc_gp.ml:151-292)."""
    inducing = calc_inducing(family, params, z, jitter)
    stats = stream_stats(
        family, params, inducing, sigma2, X, y, block_size=block_size
    )
    dt = inducing.km.dtype
    r_tilde, t = _whitened_solve(inducing, stats)
    l1, l2 = _evidence_terms(stats, r_tilde, t, variational=variational)
    coeffs, r_mat = _dewhiten(inducing, r_tilde, t)
    means = predict_means_blocked(
        family, params, inducing.z, coeffs, X, block_size=block_size
    )
    return StreamingTrained(
        model=StreamingModelLite(
            inducing=inducing,
            sigma2=jnp.asarray(sigma2, dt),
            r_mat=r_mat,
            l1=l1.astype(dt),
        ),
        y=y,
        coeffs=coeffs,
        means=means,
        l=(l1 + l2).astype(dt),
    )


def streaming_coeffs(family, params, z, sigma2, X, y, *, block_size=8192,
                     jitter=None):
    """Posterior mean coefficients R^-1 R^-T Knm'(is y) without
    materializing Knm; returns (inducing, r_mat, coeffs)."""
    inducing = calc_inducing(family, params, z, jitter)
    stats = stream_stats(
        family, params, inducing, sigma2, X, y, block_size=block_size
    )
    r_tilde, t = _whitened_solve(inducing, stats)
    coeffs, r_mat = _dewhiten(inducing, r_tilde, t)
    return inducing, r_mat, coeffs


def predict_means_blocked(family, params, z, coeffs, X, *, block_size=8192):
    """Streaming batch mean prediction: lax.map over row blocks bounds the
    Ktm tile to (block, m) (prediction at matmul throughput)."""
    n = X.shape[0]
    nb = -(-n // block_size)
    pad = nb * block_size - n
    xp = jnp.concatenate([X, jnp.zeros((pad, X.shape[1]), X.dtype)]) if pad else X
    xb = xp.reshape(nb, block_size, X.shape[1])
    out = jax.lax.map(
        lambda x_b: matmul(family.k_cross(params, x_b, z), coeffs), xb
    )
    return out.reshape(-1)[:n]


def predict_variances_blocked(
    family, params, z, chol_km, r_mat, X, sigma2, *, predictive=True,
    block_size=8192
):
    """Streaming batch variances (kt_diag - rowsq(Ktm U^-1) + rowsq(Ktm R^-1))."""
    u_inv = inv_tri_upper(chol_km)
    r_inv = inv_tri_upper(r_mat)
    n = X.shape[0]
    nb = -(-n // block_size)
    pad = nb * block_size - n
    xp = jnp.concatenate([X, jnp.zeros((pad, X.shape[1]), X.dtype)]) if pad else X
    xb = xp.reshape(nb, block_size, X.shape[1])

    def blk(x_b):
        ktm = family.k_cross(params, x_b, z)
        kd = family.k_diag(params, x_b)
        out = kd - rows_sqr_norm(matmul(ktm, u_inv)) + rows_sqr_norm(
            matmul(ktm, r_inv)
        )
        return out + sigma2 if predictive else out

    return jax.lax.map(blk, xb).reshape(-1)[:n]

"""Ordinal GP regression: cumulative probit over ordered categories,
Laplace-FITC, with learnable cutpoints.

Completes the likelihood matrix (Bernoulli / binomial / softmax /
Poisson / negative binomial) with ordered-category targets
y in {0..K-1}: a latent GP f and ordered cutpoints
b_1 < ... < b_{K-1} (parameterized as first-plus-log-increments so the
ordering is unconditional),

  p(y = k | f) = Phi(b_{k+1} - f) - Phi(b_k - f),   b_0 = -inf, b_K = +inf.

The cumulative-probit likelihood is log-concave in f, so the family's
stabilized Newton core (design notes in models/classify.py) applies
unchanged.  Writing z0 = b_y - f, z1 = b_{y+1} - f, p the cell mass,
r_i = phi(z_i)/p:

  dl/df = r0 - r1,
  W     = -d2l/df2 = (r0 - r1)^2 + z1 r1 - z0 r0   (>= 0 by concavity),

with the boundary categories dropping the respective term (r = 0).
Every ratio is computed in log space — the cell mass via a
flip-to-the-smaller-tail log(Phi(b) - Phi(a)) so confident rows far past
either cutpoint stay finite — and masked branches are double-where-gated
(the repo-wide rule for masked nonlinearities under AD, CLAUDE.md).

Cutpoints ride the optimization vector through ``optim.pack.extend_pack``
(appended after the kernel/inducing coordinates), so ``fit_ordinal`` is
the standard packed-objective trainer and ``jax.grad`` differentiates
the evidence w.r.t. hypers, inducing coordinates, AND cutpoints through
the unrolled Newton mode.

Class probabilities at test inputs are exact Gaussian integrals of the
probit cells: p(y* = k) = Phi((b_{k+1} - mu)/sqrt(1 + var)) - ditto(b_k).

Validated against a dense textbook Laplace oracle over the same FITC
prior, finite differences (incl. cutpoints), and an ordered-structure
recovery fit (tests/test_ordinal.py).  No reference counterpart: the
reference is regression-only (gpr_manual.tex:82 lists classification as
future work; ordinal models are beyond even that).
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
from jax.scipy.special import log_ndtr

from ..numerics.linalg import (
    cholesky_upper,
    inv_tri_upper,
    matmul,
    rows_sqr_norm,
    solve_tri,
    solve_tri_right,
)
from .classify import _fitc_prior

_LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)


def cutpoints_from_raw(raw: jnp.ndarray) -> jnp.ndarray:
    """(K-1,) raw vector -> strictly increasing cutpoints: b_1 = raw_0,
    b_{j+1} = b_j + exp(raw_j)."""
    first = raw[:1]
    incs = jnp.exp(raw[1:])
    return jnp.concatenate([first, first + jnp.cumsum(incs)])


def default_cutpoint_raw(n_classes: int, dtype=jnp.float64) -> jnp.ndarray:
    """Evenly spaced cutpoints spanning ~[-1, 1] on the latent scale."""
    if n_classes < 2:
        raise ValueError("ordinal regression needs n_classes >= 2")
    k = n_classes - 1
    if k == 1:
        return jnp.zeros((1,), dtype)
    gap = 2.0 / (k - 1) if k > 1 else 1.0
    return jnp.concatenate(
        [jnp.full((1,), -1.0, dtype), jnp.full((k - 1,), math.log(gap), dtype)]
    )


def _log_phi(z):
    return -0.5 * z * z - _LOG_SQRT_2PI


def _log1mexp(r, eps):
    """log(1 - exp(r)) for r <= -eps, stable at BOTH ends and NaN-free in
    the unselected where-branches (every branch input is substituted with
    a safe value — the repo-wide double-where rule, CLAUDE.md): near 0
    log1p(-exp(r)) rounds exp(r) to 1 (f32 already at r = -1e-12) and
    emits -inf whose cotangent poisons the whole gradient."""
    r = jnp.minimum(r, -eps)
    near = r > -0.6931471805599453  # log 2: switch point (Maechler 2012)
    r_n = jnp.where(near, r, -1.0)
    r_f = jnp.where(near, -1.0, r)
    return jnp.where(
        near, jnp.log(-jnp.expm1(r_n)), jnp.log1p(-jnp.exp(r_f))
    )


def _log_cell(z0, z1, has_lo, has_hi):
    """log(Phi(z1) - Phi(z0)) with boundary masks, stable in both tails.

    Masked bounds must carry a *safe* finite z (the caller substitutes 0)
    AND the both-bounds branch must see safe inputs when a boundary mask
    deselects it — an f32 row with z0 == z1 == 0 in the dead branch
    otherwise produces -inf there and NaN gradients through the where.
    """
    eps = jnp.finfo(z1.dtype).eps
    both_sel = has_lo & has_hi
    # flip so the difference is between lower-tail CDFs (log_ndtr is
    # accurate there); Phi(z1)-Phi(z0) = Phi(-z0)-Phi(-z1)
    flip = (z0 + z1) > 0.0
    a = jnp.where(both_sel, jnp.where(flip, -z1, z0), -1.0)
    b = jnp.where(both_sel, jnp.where(flip, -z0, z1), 1.0)
    la = log_ndtr(a)
    lb = log_ndtr(b)
    both = lb + _log1mexp(la - lb, eps)
    only_hi = log_ndtr(z1)  # k = 0: cell is Phi(z1)
    only_lo = log_ndtr(-z0)  # k = K-1: cell is 1 - Phi(z0)
    return jnp.where(has_lo, jnp.where(has_hi, both, only_lo), only_hi)


def _bounds(f, y, cuts):
    """Per-row (z0, z1, has_lo, has_hi) with safe substitutes where
    masked.  ``y`` is int (n,), ``cuts`` (K-1,) increasing."""
    k1 = cuts.shape[0]  # K - 1
    has_lo = y > 0
    has_hi = y < k1
    lo_idx = jnp.clip(y - 1, 0, k1 - 1)
    hi_idx = jnp.clip(y, 0, k1 - 1)
    b_lo = cuts[lo_idx]
    b_hi = cuts[hi_idx]
    z0 = jnp.where(has_lo, b_lo - f, 0.0)
    z1 = jnp.where(has_hi, b_hi - f, 0.0)
    return z0, z1, has_lo, has_hi


def _ord_parts(f, y, cuts, mask):
    """(dl/df, W) of the cumulative-probit log likelihood, elementwise."""
    z0, z1, has_lo, has_hi = _bounds(f, y, cuts)
    logp = _log_cell(z0, z1, has_lo, has_hi)
    r0 = jnp.where(has_lo, jnp.exp(_log_phi(z0) - logp), 0.0)
    r1 = jnp.where(has_hi, jnp.exp(_log_phi(z1) - logp), 0.0)
    grad = mask * (r0 - r1)
    w = jnp.square(r0 - r1) + z1 * r1 - z0 * r0
    w = mask * jnp.maximum(w, 0.0)
    return grad, w


def _ord_loglik(f, y, cuts):
    z0, z1, has_lo, has_hi = _bounds(f, y, cuts)
    return _log_cell(z0, z1, has_lo, has_hi)


def ord_parts(f, lik, mask):
    """ift.py parts convention, lik = (y, cuts) — ``cuts`` is an inexact
    leaf, so the IFT backward gives the cutpoints their implicit
    gradient automatically (``y`` is integer -> float0)."""
    y, cuts = lik
    return _ord_parts(f, y, cuts, mask)


def ord_loglik(f, lik):
    y, cuts = lik
    return _ord_loglik(f, y, cuts)


def ordinal_newton_scan(
    v, d, y, cuts, mask, *, newton_iters: int = 20,
    allsum=lambda x: x,
):
    """Stabilized Newton mode-finding — the cumulative-probit instance of
    ift.newton_scan_generic.  Returns (f_hat, a)."""
    from .ift import newton_scan_generic

    return newton_scan_generic(
        ord_parts, v, d, (y, cuts), mask, newton_iters=newton_iters,
        allsum=allsum,
    )


def ordinal_laplace_mode(
    family, params, z, X, y, cut_raw, *, newton_iters: int = 20,
    jitter: float | None = None,
):
    """Returns (f_hat, a, inducing, v, d, cuts); ``y`` int (n,) in
    {0..K-1}, ``cut_raw`` (K-1,) the unconstrained cutpoint vector."""
    cuts = cutpoints_from_raw(cut_raw)
    inducing, v, d = _fitc_prior(family, params, z, X, jitter)
    f_hat, a = ordinal_newton_scan(
        v, d, y, cuts, jnp.ones(y.shape, dtype=v.dtype),
        newton_iters=newton_iters,
    )
    return f_hat, a, inducing, v, d, cuts


def ordinal_log_evidence(
    family, params, z, X, y, cut_raw, *, newton_iters: int = 20,
    jitter: float | None = None, block_size: int | None = None,
    grad_impl: str = "ift",
):
    """Laplace marginal likelihood, differentiable w.r.t.
    (params, z, cut_raw) — implicit (IFT) gradients by default, the
    cutpoints included (models/ift.py).  ``block_size`` streams through
    the generic Laplace core (models/classify_stream.py) — unbounded n;
    the cutpoints ride as a traced closure of the likelihood hooks."""
    if block_size is not None:
        from .classify_stream import stream_laplace_log_evidence

        cuts = cutpoints_from_raw(cut_raw)
        return stream_laplace_log_evidence(
            family, params, z, X, (y, cuts),
            parts=ord_parts, loglik=ord_loglik,
            lik_is_row=(True, False),
            block_size=block_size, newton_iters=newton_iters,
            jitter=jitter,
        )
    from .ift import laplace_evidence_core

    cuts = cutpoints_from_raw(cut_raw)
    inducing, v, d = _fitc_prior(family, params, z, X, jitter)
    return laplace_evidence_core(
        ord_parts, ord_loglik, v, d, (y, cuts),
        jnp.ones(y.shape, dtype=v.dtype),
        newton_iters=newton_iters, grad_impl=grad_impl,
    )


def ordinal_predict(
    family, params, z, X, y, cut_raw, Xstar, *, newton_iters: int = 20,
    jitter: float | None = None,
):
    """(probs (n*, K), latent_mean, latent_var) at Xstar.

    The class probabilities are the *exact* Gaussian integrals of the
    probit cells over the latent marginal: p(y*=k) =
    Phi((b_{k+1}-mu)/sqrt(1+var)) - Phi((b_k-mu)/sqrt(1+var)).
    """
    f_hat, a, inducing, v, d, cuts = ordinal_laplace_mode(
        family, params, z, X, y, cut_raw, newton_iters=newton_iters,
        jitter=jitter,
    )
    _, w = _ord_parts(f_hat, y, cuts, jnp.ones(y.shape, dtype=v.dtype))
    w = jnp.maximum(w, 1e-12)
    d2inv = w / (1.0 + w * d)
    vs = v * jnp.sqrt(d2inv)[:, None]
    rn = cholesky_upper(
        jnp.eye(v.shape[1], dtype=v.dtype) + matmul(vs.T, vs), jitter=0.0
    )
    u_inv = inv_tri_upper(inducing.chol_km)
    kstar = family.k_cross(params, Xstar, inducing.z)
    vstar = matmul(kstar, u_inv)
    mu = matmul(vstar, matmul(v.T, a))
    quad = rows_sqr_norm(vstar) - rows_sqr_norm(solve_tri_right(vstar, rn))
    var = jnp.maximum(family.k_diag(params, Xstar) - quad, 1e-10)

    scale = 1.0 / jnp.sqrt(1.0 + var)
    zc = (cuts[None, :] - mu[:, None]) * scale[:, None]  # (n*, K-1)
    cdf = jax.scipy.stats.norm.cdf(zc)
    ones = jnp.ones((mu.shape[0], 1), dtype=cdf.dtype)
    upper = jnp.concatenate([cdf, ones], axis=1)
    lower = jnp.concatenate([jnp.zeros_like(ones), cdf], axis=1)
    probs = jnp.maximum(upper - lower, 0.0)
    return probs, mu, var


def fit_ordinal(
    family, X, y, pack, cut_raw0, *, newton_iters: int = 20,
    jitter: float | None = None, normalize: bool = True, mesh=None,
    block_size: int | None = None,
    **fit_kwargs,
):
    """Joint hyper + inducing + cutpoint training on the ordinal-Laplace
    evidence.  ``pack`` must carry learn_sigma2=False (the latent scale is
    identified by the kernel amplitude against fixed unit probit noise);
    the cutpoint raws are appended via optim.pack.extend_pack.  ``mesh``
    switches to the 1-D data-parallel objective
    (parallel.classify_sharded.sharded_ordinal_log_evidence).  Returns
    (params, z, cut_raw, state)."""
    if pack.learn_sigma2:
        raise ValueError(
            "the ordinal likelihood has no sigma2: build the pack with "
            "make_pack(..., learn_sigma2=False)"
        )
    if mesh is not None and block_size is not None:
        raise ValueError(
            "fit_ordinal streams per shard via mesh=... alone; block_size "
            "composes with the single-device path only"
        )
    from ..optim.lbfgs_device import fit_packed_objective
    from ..optim.pack import extend_pack

    ext = extend_pack(pack, jnp.asarray(cut_raw0))
    scale = 1.0 / X.shape[0] if normalize else 1.0

    if mesh is not None:
        from ..parallel.classify_sharded import sharded_ordinal_log_evidence
        from ..parallel.sharded import shard_batch

        Xs, ys, mask = shard_batch(mesh, X, y)

        def fg(x, Xs, ys, mask):
            def f(x):
                params, z, _ = ext.unpack(x)
                return -scale * sharded_ordinal_log_evidence(
                    family, mesh, params, z, Xs, ys, ext.unpack_extra(x),
                    mask, newton_iters=newton_iters, jitter=jitter,
                )

            return jax.value_and_grad(f)(x)

        data = (Xs, ys, mask)
    else:

        def fg(x, X, y):
            def f(x):
                params, z, _ = ext.unpack(x)
                cut_raw = ext.unpack_extra(x)
                return -scale * ordinal_log_evidence(
                    family, params, z, X, y, cut_raw,
                    newton_iters=newton_iters, jitter=jitter,
                    block_size=block_size,
                )

            return jax.value_and_grad(f)(x)

        data = (X, y)

    st = fit_packed_objective(fg, ext, data, **fit_kwargs)
    params, z, _ = ext.unpack(st.x)
    return params, z, ext.unpack_extra(st.x), st

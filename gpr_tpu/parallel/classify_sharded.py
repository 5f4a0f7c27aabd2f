"""Data-parallel Laplace classification over the 1-D data mesh.

Same exactness argument as ``parallel.sharded`` for regression: every
cross-row quantity in a Newton step of ``models.classify.newton_scan``
is an m-vector, m x m matrix, or scalar sum over rows, so the iteration
runs unchanged on row shards with ``lax.psum`` as the reduction hook.
Collective volume per Newton step: one m x m Gram, four m-vectors, a
few scalars, plus one scalar psum per line-search bisection — latency-
bound on the interconnect; nothing n-sized ever crosses the interconnect.

The reference has neither classification nor any distributed code
(SURVEY.md sections 2.4, 7 non-goals); this is the rebuild's systems
axis applied to its own classification extension.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..models.classify import _fitc_prior, _log_sigmoid, newton_scan
from ..numerics.linalg import (
    cholesky_upper,
    inv_tri_upper,
    log_det_tri,
    matmul,
    rows_sqr_norm,
    solve_tri_right,
)
from .sharded import DATA_AXIS, pad_to_shards


def _allsum(x):
    return jax.lax.psum(x, DATA_AXIS)


def sharded_classify_log_evidence(
    family,
    mesh: Mesh,
    params,
    z,
    X,
    y,
    mask=None,
    *,
    newton_iters: int = 15,
    jitter: float | None = None,
    block_size: int | None = None,
):
    """Distributed Laplace evidence.  X (n, d) and y (n,) in {-1, +1} must
    be row-sharded (or row-shardable) over ``mesh``; params/z replicate;
    ``mask`` zeroes padded rows (see ``sharded.shard_batch``).

    ``block_size`` streams the per-shard Newton (models/classify_stream.py
    with psum as the reduction hook): per-device memory drops from the
    local (n/devices, m) V to O(block x m), so n is unbounded in BOTH
    axes — across the mesh and within each shard.

    Wrap in jax.jit(jax.value_and_grad(...)) for training — grad of a
    shard_map-calling function must run inside jit.
    """
    if mask is None:
        mask = jnp.ones((X.shape[0],), X.dtype)

    if block_size is not None:
        from ..models.classify_stream import stream_classify_log_evidence

        def shard_fn_stream(params, z, xs, ys, ms):
            return stream_classify_log_evidence(
                family, params, z, xs, ys, block_size=block_size,
                newton_iters=newton_iters, jitter=jitter, mask=ms,
                allsum=_allsum,
            )

        fn = jax.shard_map(
            shard_fn_stream,
            mesh=mesh,
            in_specs=(P(), P(), P(DATA_AXIS, None), P(DATA_AXIS),
                      P(DATA_AXIS)),
            out_specs=P(),
            check_vma=False,
        )
        return fn(params, z, X, y, mask)

    def shard_fn(params, z, xs, ys, ms):
        from ..models.classify import logit_loglik, logit_parts
        from ..models.ift import laplace_evidence_core

        _, v, d = _fitc_prior(family, params, z, xs, jitter)
        return laplace_evidence_core(
            logit_parts, logit_loglik, v, d, (ys,), ms,
            newton_iters=newton_iters, allsum=_allsum,
        )

    fn = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(), P(), P(DATA_AXIS, None), P(DATA_AXIS), P(DATA_AXIS)),
        out_specs=P(),
        check_vma=False,
    )
    return fn(params, z, X, y, mask)


def sharded_classify_predict(
    family,
    mesh: Mesh,
    params,
    z,
    X,
    y,
    Xstar,
    mask=None,
    *,
    newton_iters: int = 15,
    jitter: float | None = None,
):
    """Distributed (prob, latent_mean, latent_var) at Xstar.

    Train rows (sharded, with ``mask`` from ``shard_batch``) and test rows
    shard independently on the same data axis; the mode and the m-space
    posterior factors reduce over train shards, then each shard predicts
    its own Xstar rows.  Xstar is padded internally; outputs come back
    replicated at Xstar's length (the ``sharded_predict_means``
    convention).
    """
    if mask is None:
        mask = jnp.ones((X.shape[0],), X.dtype)
    n_star = Xstar.shape[0]
    Xstar, _, _ = pad_to_shards(mesh, Xstar, jnp.zeros((n_star,),
                                                       Xstar.dtype))

    def shard_fn(params, z, xs, ys, ms, xst):
        inducing, v, d = _fitc_prior(family, params, z, xs, jitter)
        f_hat, a = newton_scan(
            v, d, ys, ms, newton_iters=newton_iters, allsum=_allsum
        )
        pi = jax.nn.sigmoid(f_hat)
        w = ms * jnp.maximum(pi * (1.0 - pi), 1e-12)
        d2inv = w / (1.0 + w * d)  # = 1/(d + 1/w), 0 exactly on padding
        vs = v * (ms * jnp.sqrt(jnp.where(d2inv > 0.0, d2inv, 1.0)))[:, None]
        s_mat = _allsum(matmul(vs.T, vs))
        rn = cholesky_upper(
            jnp.eye(v.shape[1], dtype=v.dtype) + s_mat, jitter=0.0
        )
        beta = _allsum(matmul(v.T, a))

        u_inv = inv_tri_upper(inducing.chol_km)
        kstar = family.k_cross(params, xst, inducing.z)
        vstar = matmul(kstar, u_inv)
        mu = matmul(vstar, beta)
        quad = rows_sqr_norm(vstar) - rows_sqr_norm(
            solve_tri_right(vstar, rn)
        )
        var = jnp.maximum(family.k_diag(params, xst) - quad, 1e-10)
        prob = jax.nn.sigmoid(mu / jnp.sqrt(1.0 + jnp.pi * var / 8.0))
        return prob, mu, var

    fn = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(
            P(), P(), P(DATA_AXIS, None), P(DATA_AXIS), P(DATA_AXIS),
            P(DATA_AXIS, None),
        ),
        out_specs=(P(DATA_AXIS), P(DATA_AXIS), P(DATA_AXIS)),
        check_vma=False,
    )
    out = fn(params, z, X, y, mask, Xstar)
    rep = NamedSharding(mesh, P())
    return tuple(jax.device_put(o, rep)[:n_star] for o in out)


def sharded_ep_log_evidence(
    family,
    mesh: Mesh,
    params,
    z,
    X,
    y,
    mask=None,
    *,
    n_sweeps: int = 20,
    damping: float = 0.5,
    jitter: float | None = None,
):
    """Distributed EP evidence (models/classify_ep.py over the 1-D data
    mesh).  The parallel-EP sweep is embarrassingly data-parallel: site
    and cavity updates are elementwise per row, and the only cross-row
    objects are the m x m Woodbury Gram and a few m-vectors — one psum
    set per sweep.  Exact vs single-device at any shard count.

    Wrap in jax.jit(jax.value_and_grad(...)) for training.
    """
    from ..models.classify_ep import (
        ep_log_evidence_from_sites,
        ep_sweeps,
    )

    if mask is None:
        mask = jnp.ones((X.shape[0],), X.dtype)

    def shard_fn(params, z, xs, ys, ms):
        _, v, d = _fitc_prior(family, params, z, xs, jitter)
        ttau, tnu = ep_sweeps(v, d, ys, ms, n_sweeps=n_sweeps,
                              damping=damping, allsum=_allsum)
        # stationary-gradient route (classify_ep.ep_log_evidence docstring)
        ttau = jax.lax.stop_gradient(ttau)
        tnu = jax.lax.stop_gradient(tnu)
        return ep_log_evidence_from_sites(v, d, ys, ms, ttau, tnu,
                                          allsum=_allsum)

    fn = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(), P(), P(DATA_AXIS, None), P(DATA_AXIS), P(DATA_AXIS)),
        out_specs=P(),
        check_vma=False,
    )
    return fn(params, z, X, y, mask)


def sharded_poisson_log_evidence(
    family,
    mesh: Mesh,
    params,
    z,
    X,
    y,
    mask=None,
    *,
    log_exposure=None,
    newton_iters: int = 20,
    jitter: float | None = None,
):
    """Distributed Poisson-Laplace evidence (models/poisson.py over the
    1-D data mesh): counts/exposures shard with the rows, the Newton
    step's cross-row objects are the usual m-space psums.  Exact vs
    single-device.

    Wrap in jax.jit(jax.value_and_grad(...)) for training.
    """
    from ..models.ift import laplace_evidence_core
    from ..models.poisson import pois_loglik, pois_parts

    if mask is None:
        mask = jnp.ones((X.shape[0],), X.dtype)
    if log_exposure is None:
        log_exposure = jnp.zeros((X.shape[0],), X.dtype)

    def shard_fn(params, z, xs, ys, les, ms):
        _, v, d = _fitc_prior(family, params, z, xs, jitter)
        return laplace_evidence_core(
            pois_parts, pois_loglik, v, d, (ys, les), ms,
            newton_iters=newton_iters, allsum=_allsum,
        )

    fn = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(), P(), P(DATA_AXIS, None), P(DATA_AXIS),
                  P(DATA_AXIS), P(DATA_AXIS)),
        out_specs=P(),
        check_vma=False,
    )
    return fn(params, z, X, y, log_exposure, mask)


def sharded_binomial_log_evidence(
    family,
    mesh: Mesh,
    params,
    z,
    X,
    y,
    trials,
    mask=None,
    *,
    newton_iters: int = 15,
    jitter: float | None = None,
):
    """Distributed binomial-Laplace evidence (models/binomial.py over the
    1-D data mesh): successes/trials shard with the rows, the Newton
    step's cross-row objects are the usual m-space psums.  Exact vs
    single-device.

    Wrap in jax.jit(jax.value_and_grad(...)) for training.
    """
    from ..models.binomial import bin_loglik, bin_parts
    from ..models.ift import laplace_evidence_core

    if mask is None:
        mask = jnp.ones((X.shape[0],), X.dtype)

    def shard_fn(params, z, xs, ys, ts, ms):
        _, v, d = _fitc_prior(family, params, z, xs, jitter)
        return laplace_evidence_core(
            bin_parts, bin_loglik, v, d, (ys, ts), ms,
            newton_iters=newton_iters, allsum=_allsum,
        )

    fn = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(), P(), P(DATA_AXIS, None), P(DATA_AXIS),
                  P(DATA_AXIS), P(DATA_AXIS)),
        out_specs=P(),
        check_vma=False,
    )
    return fn(params, z, X, y, trials, mask)


def sharded_negbin_log_evidence(
    family,
    mesh: Mesh,
    params,
    z,
    X,
    y,
    r,
    mask=None,
    *,
    log_exposure=None,
    newton_iters: int = 20,
    jitter: float | None = None,
):
    """Distributed NB2-Laplace evidence (models/negbin.py over the 1-D data
    mesh): counts/exposures shard with the rows, the scalar dispersion ``r``
    replicates, and the Newton step's cross-row objects are the usual
    m-space psums.  Exact vs single-device; differentiable w.r.t.
    (params, z, r).

    Wrap in jax.jit(jax.value_and_grad(...)) for training.
    """
    from ..models.ift import laplace_evidence_core
    from ..models.negbin import nb_loglik, nb_parts

    if mask is None:
        mask = jnp.ones((X.shape[0],), X.dtype)
    if log_exposure is None:
        log_exposure = jnp.zeros((X.shape[0],), X.dtype)

    def shard_fn(params, z, r, xs, ys, les, ms):
        _, v, d = _fitc_prior(family, params, z, xs, jitter)
        return laplace_evidence_core(
            nb_parts, nb_loglik, v, d, (ys, jnp.asarray(r, v.dtype), les),
            ms, newton_iters=newton_iters, allsum=_allsum,
        )

    fn = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(), P(), P(), P(DATA_AXIS, None), P(DATA_AXIS),
                  P(DATA_AXIS), P(DATA_AXIS)),
        out_specs=P(),
        check_vma=False,
    )
    return fn(params, z, r, X, y, log_exposure, mask)


def sharded_multiclass_log_evidence(
    family,
    mesh: Mesh,
    params,
    z,
    X,
    labels,
    n_classes: int,
    mask=None,
    *,
    newton_iters: int = 15,
    jitter: float | None = None,
    block_size: int | None = None,
):
    """Distributed softmax-Laplace evidence (models/classify_multi.py over
    the 1-D data mesh).  ``labels`` (n,) ints shard with the rows; every
    cross-row object in the Newton step and the evidence epilogue is an
    m-vector / m x m / (Cm, Cm) matrix or scalar, so psum as the
    ``allsum`` hook is exact.  Collective volume per Newton step:
    C m x m Grams + C(C+1)/2 coupling blocks + a few (m, C) panels.

    ``block_size`` streams the per-shard Newton
    (models/classify_multi_stream.py with psum as the reduction hook):
    per-device memory drops from the local (n/devices, m) V to
    O(block x m), so n is unbounded across the mesh AND within each shard.

    Wrap in jax.jit(jax.value_and_grad(...)) for training.
    """
    from ..models.classify_multi import (
        evidence_from_mode,
        softmax_mode,
    )

    if mask is None:
        mask = jnp.ones((X.shape[0],), X.dtype)

    if block_size is not None:
        from ..models.classify_multi_stream import (
            stream_multiclass_log_evidence,
        )

        def shard_fn_stream(params, z, xs, lbl, ms):
            return stream_multiclass_log_evidence(
                family, params, z, xs, lbl, n_classes,
                block_size=block_size, newton_iters=newton_iters,
                jitter=jitter, mask=ms, allsum=_allsum,
            )

        fn = jax.shard_map(
            shard_fn_stream,
            mesh=mesh,
            in_specs=(P(), P(), P(DATA_AXIS, None), P(DATA_AXIS),
                      P(DATA_AXIS)),
            out_specs=P(),
            check_vma=False,
        )
        return fn(params, z, X, labels, mask)

    def shard_fn(params, z, xs, lbl, ms):
        inducing, v, d = _fitc_prior(family, params, z, xs, jitter)
        y1h = jax.nn.one_hot(lbl, n_classes, dtype=v.dtype) * ms[:, None]
        f_hat, a = softmax_mode(
            v, d, y1h, ms, newton_iters=newton_iters, allsum=_allsum
        )
        return evidence_from_mode(v, d, f_hat, a, y1h, ms, allsum=_allsum)

    fn = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(), P(), P(DATA_AXIS, None), P(DATA_AXIS), P(DATA_AXIS)),
        out_specs=P(),
        check_vma=False,
    )
    return fn(params, z, X, labels, mask)


def sharded_ordinal_log_evidence(
    family,
    mesh: Mesh,
    params,
    z,
    X,
    y,
    cut_raw,
    mask=None,
    *,
    newton_iters: int = 20,
    jitter: float | None = None,
):
    """Distributed cumulative-probit Laplace evidence (models/ordinal.py
    over the 1-D data mesh).  Labels shard with the rows; the cutpoint
    raws replicate (they are a (K-1,) traced vector, differentiable like
    every other hyper).  Exact vs single-device.

    Wrap in jax.jit(jax.value_and_grad(...)) for training.
    """
    from ..models.ift import laplace_evidence_core
    from ..models.ordinal import cutpoints_from_raw, ord_loglik, ord_parts

    if mask is None:
        mask = jnp.ones((X.shape[0],), X.dtype)

    def shard_fn(params, z, cut_raw, xs, ys, ms):
        cuts = cutpoints_from_raw(cut_raw)
        _, v, d = _fitc_prior(family, params, z, xs, jitter)
        return laplace_evidence_core(
            ord_parts, ord_loglik, v, d, (ys, cuts), ms,
            newton_iters=newton_iters, allsum=_allsum,
        )

    fn = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(), P(), P(), P(DATA_AXIS, None), P(DATA_AXIS),
                  P(DATA_AXIS)),
        out_specs=P(),
        check_vma=False,
    )
    return fn(params, z, cut_raw, X, y, mask)


def sharded_hetero_log_evidence(
    family,
    mesh: Mesh,
    params,
    z,
    noise,
    X,
    y,
    mask=None,
    *,
    jitter: float | None = None,
):
    """Distributed Gaussian evidence with a PER-ROW noise vector — the
    M-step objective of the Student-t robust family (models/robust.py):
    log N(y; 0, V V' + diag(kn_diag - rowsq(V)) + diag(noise)).  ``noise``
    shards with the rows; every cross-row object is m-space.  Exact vs
    single-device ``models.fitc.log_evidence`` with vector sigma2.

    Wrap in jax.jit(jax.value_and_grad(...)) for training.
    """
    import math as _math

    if mask is None:
        mask = jnp.ones((X.shape[0],), X.dtype)

    def shard_fn(params, z, xs, ys, ns, ms):
        inducing, v, d = _fitc_prior(family, params, z, xs, jitter)
        live = ms > 0.0
        s = jnp.where(live, d + ns, 1.0)
        is_ = jnp.where(live, 1.0 / s, 0.0)
        a = v * jnp.sqrt(is_)[:, None]
        m = v.shape[1]
        bt = jnp.eye(m, dtype=v.dtype) + _allsum(matmul(a.T, a))
        r_tilde = cholesky_upper(bt, jitter=0.0)
        # l1: log|B| - log|Km| telescopes to log|B~| in the whitened form
        log_det = log_det_tri(r_tilde) + _allsum(
            jnp.sum(jnp.where(live, jnp.log(s), 0.0))
        )
        n_live = _allsum(jnp.sum(ms))
        l1 = -0.5 * (log_det + n_live * _math.log(2.0 * _math.pi))
        # l2 via the whitened t = B~^-T V'(is y)
        isy = is_ * ys
        u = _allsum(matmul(v.T, isy))
        t = jax.scipy.linalg.solve_triangular(
            r_tilde.T, u, lower=True
        )
        # quad >= 0 mathematically; clamp the f32 cancellation overshoot
        # (see models/streaming._evidence_terms).
        l2 = -0.5 * jnp.maximum(_allsum(jnp.dot(ys, isy)) - jnp.dot(t, t), 0.0)
        return l1 + l2

    fn = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(), P(), P(DATA_AXIS, None), P(DATA_AXIS),
                  P(DATA_AXIS), P(DATA_AXIS)),
        out_specs=P(),
        check_vma=False,
    )
    return fn(params, z, X, y, noise, mask)


def sharded_t_moments(
    family,
    mesh: Mesh,
    params,
    z,
    sigma2,
    X,
    y,
    lam,
    mask=None,
    *,
    jitter: float | None = None,
):
    """Distributed E-step moments for the Student-t family
    (models/robust.py ``t_posterior_moments`` over the 1-D data mesh):
    the m-space factors (whitened B~, u) psum across shards, then every
    row's exact (mu_i, var_i) is local.  Outputs shard with the rows.
    """
    if mask is None:
        mask = jnp.ones((X.shape[0],), X.dtype)

    def shard_fn(params, z, s2, xs, ys, ls, ms):
        inducing, v, d = _fitc_prior(family, params, z, xs, jitter)
        live = ms > 0.0
        noise = s2 / jnp.where(live, ls, 1.0)
        s = jnp.where(live, d + noise, 1.0)
        is_ = jnp.where(live, 1.0 / s, 0.0)
        a = v * jnp.sqrt(is_)[:, None]
        m = v.shape[1]
        bt = jnp.eye(m, dtype=v.dtype) + _allsum(matmul(a.T, a))
        r_tilde = cholesky_upper(bt, jitter=0.0)
        u = _allsum(matmul(v.T, is_ * ys))
        # coeffs (whitened): B~^-1 u; mean_pred_i = v_i . coeffs
        t = jax.scipy.linalg.solve_triangular(r_tilde.T, u, lower=True)
        coeffs = jax.scipy.linalg.solve_triangular(r_tilde, t, lower=False)
        mean_pred = matmul(v, coeffs)
        alpha = is_ * (ys - mean_pred)
        mu = ys - noise * alpha
        w2 = rows_sqr_norm(solve_tri_right(v, r_tilde))
        s_inv_diag = is_ * (1.0 - is_ * w2)
        var = jnp.maximum(noise * (1.0 - noise * s_inv_diag), 1e-12)
        return mu, var

    fn = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(), P(), P(), P(DATA_AXIS, None), P(DATA_AXIS),
                  P(DATA_AXIS), P(DATA_AXIS)),
        out_specs=(P(DATA_AXIS), P(DATA_AXIS)),
        check_vma=False,
    )
    return fn(params, z, jnp.asarray(sigma2, X.dtype), X, y, lam, mask)

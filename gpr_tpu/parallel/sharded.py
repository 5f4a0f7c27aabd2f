"""Multi-chip evidence and training: shard the data axis over a device mesh.

The reference is strictly single-process (SURVEY.md section 2.4); this module
is the systems axis the rebuild adds.  The design follows directly from the
algebra of fitc.calc_model: every global quantity is either per-row (r, s,
is) or a sum over rows (the m x m Gram statistic, the m-vector Knm'(is y),
and the scalars of l1/l2), so data parallelism is *exact* — shard X and y on
a 1-D mesh, accumulate per-shard StreamStats, psum them over the interconnect, and run
the O(m^3) epilogue replicated on every device.  Gradients flow through shard_map
and psum transposes into the reverse collectives automatically, so one
jax.value_and_grad of the sharded evidence is the whole distributed training
step.

Collective volume per evidence+gradient evaluation: one psum of
(m^2 + m + 4) accumulators — at m = 300 that is ~0.7 MB, i.e. interconnect
latency, not bandwidth, bound.  Nothing n-sized ever crosses the interconnect.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..models.fitc import LOG_2PI, calc_inducing
from ..models.streaming import (
    evidence_from_stats,
    stream_stats,
)
from ..numerics.linalg import (
    inv_tri_upper,
    log_det_tri,
    matmul,
    qr_r_positive,
    rows_sqr_norm,
    solve_tri,
    solve_tri_right,
)

DATA_AXIS = "data"


def make_mesh(n_devices: int | None = None, axis: str = DATA_AXIS) -> Mesh:
    """1-D data-parallel mesh over the first n available devices."""
    devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    return jax.make_mesh((n_devices,), (axis,), devices=devices[:n_devices])


def pad_to_shards(mesh: Mesh, X, y):
    """Pad (X, y) to a row count divisible by the mesh size; returns
    (X, y, mask) with mask marking real rows."""
    n_dev = mesh.devices.size
    n = X.shape[0]
    pad = (-n) % n_dev
    mask = jnp.ones((n,), X.dtype)
    if pad:
        X = jnp.concatenate([X, jnp.zeros((pad, X.shape[1]), X.dtype)])
        y = jnp.concatenate([y, jnp.zeros((pad,), y.dtype)])
        mask = jnp.concatenate([mask, jnp.zeros((pad,), mask.dtype)])
    return X, y, mask


def shard_batch(mesh: Mesh, X, y):
    """Place (X, y, mask) row-sharded across the mesh."""
    X, y, mask = pad_to_shards(mesh, X, y)
    row = NamedSharding(mesh, P(DATA_AXIS))
    row2 = NamedSharding(mesh, P(DATA_AXIS, None))
    return (
        jax.device_put(X, row2),
        jax.device_put(y, row),
        jax.device_put(mask, row),
    )


def sharded_log_evidence(
    family,
    mesh: Mesh,
    params,
    z,
    sigma2,
    X,
    y,
    mask=None,
    *,
    variational: bool = False,
    block_size: int = 8192,
    jitter: float | None = None,
):
    """Exact distributed evidence.  X (n, d) and y (n,) must be row-sharded
    (or at least row-shardable) over ``mesh``; params/z/sigma2 replicate.

    Per shard: scan-accumulate StreamStats over local row blocks (the Knm
    tile stays a (block, m) working set); then one psum over the
    interconnect; then
    the replicated m^3 epilogue.  Wrap in jax.value_and_grad for training.
    """
    if mask is None:
        mask = jnp.ones((X.shape[0],), X.dtype)

    def shard_fn(params, z, sigma2, xs, ys, ms):
        inducing = calc_inducing(family, params, z, jitter)
        stats = stream_stats(
            family, params, inducing, sigma2, xs, ys,
            block_size=min(block_size, xs.shape[0]), mask=ms,
        )
        stats = jax.tree.map(lambda a: jax.lax.psum(a, DATA_AXIS), stats)
        return evidence_from_stats(inducing, stats, variational=variational)

    fn = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(), P(), P(), P(DATA_AXIS, None), P(DATA_AXIS), P(DATA_AXIS)),
        out_specs=P(),
        check_vma=False,
    )
    return fn(params, z, jnp.asarray(sigma2, X.dtype), X, y, mask)


def sharded_log_evidence_tsqr(
    family,
    mesh: Mesh,
    params,
    z,
    sigma2,
    X,
    y,
    mask=None,
    *,
    variational: bool = False,
    jitter: float | None = None,
):
    """Distributed evidence via tall-skinny QR — the maximally stable path.

    The single-device engine can keep the reference's Foster-2009 stacked QR
    (fitc.py factorization='qr'); a literal (n+m) x m QR does not shard.  The
    TSQR form does: each shard QR-factors its local block of
    A1 = diag(sqrt is) Knm, the m x m R factors are all-gathered (p m^2
    floats over the interconnect), and one small QR of the stacked [R_1; ...; R_p; U]
    yields the same R as the global stacked QR — normal equations are never
    formed, preserving the conditioning argument (SURVEY.md section 5, last
    bullet).  Costs one materialized (n/p, m) block per shard; use
    sharded_log_evidence (Gram/psum) when speed matters more than the last
    digits of conditioning.
    """
    if mask is None:
        mask = jnp.ones((X.shape[0],), X.dtype)

    def shard_fn(params, z, sigma2, xs, ys, ms):
        inducing = calc_inducing(family, params, z, jitter)
        knm = family.k_cross(params, xs, inducing.z)
        kn_diag = family.k_diag(params, xs)
        v = solve_tri_right(knm, inducing.chol_km)
        r = kn_diag - rows_sqr_norm(v)
        live = ms > 0
        s = jnp.where(live, r + sigma2, 1.0)
        is_ = ms / s
        sqrt_is = jnp.where(live, jnp.sqrt(jnp.where(live, is_, 1.0)), 0.0)
        a1 = knm * sqrt_is[:, None]

        r_local = jnp.linalg.qr(a1, mode="r")  # (m, m)
        r_all = jax.lax.all_gather(r_local, DATA_AXIS)  # (p, m, m)
        m = z.shape[0]
        stacked = jnp.concatenate(
            [r_all.reshape(-1, m), inducing.chol_km], axis=0
        )
        r_mat = qr_r_positive(stacked)

        log_det_s = jax.lax.psum(jnp.sum(jnp.where(live, jnp.log(s), 0.0)),
                                 DATA_AXIS)
        n_live = jax.lax.psum(jnp.sum(ms), DATA_AXIS)
        u_vec = jax.lax.psum(matmul(knm.T, is_ * ys), DATA_AXIS)
        y_is_y = jax.lax.psum(jnp.sum(is_ * ys * ys), DATA_AXIS)

        l1 = -0.5 * (
            log_det_tri(r_mat) - inducing.log_det_km + log_det_s
            + n_live * LOG_2PI
        )
        if variational:
            l1 = l1 - 0.5 * jax.lax.psum(jnp.sum(is_ * r), DATA_AXIS)
        t = solve_tri(r_mat, u_vec, trans=True)
        # quad >= 0 mathematically; clamp the f32 cancellation overshoot
        # (see models/streaming._evidence_terms).
        l2 = -0.5 * jnp.maximum(y_is_y - jnp.dot(t, t), 0.0)
        return l1 + l2

    fn = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(), P(), P(), P(DATA_AXIS, None), P(DATA_AXIS), P(DATA_AXIS)),
        out_specs=P(),
        check_vma=False,
    )
    return fn(params, z, jnp.asarray(sigma2, X.dtype), X, y, mask)


def sharded_warped_log_evidence(
    family,
    mesh: Mesh,
    params,
    warp_params,
    z,
    sigma2,
    X,
    y,
    mask=None,
    *,
    variational: bool = False,
    block_size: int = 8192,
    jitter: float | None = None,
):
    """Distributed warped evidence (models/warped.py over the mesh).

    The warp is elementwise in y and its Jacobian term a masked row sum,
    so the warped model inherits the regression path's exact data
    parallelism unchanged: warp the sharded targets in place (XLA keeps
    the sharding), run the sharded evidence, add the psum'd Jacobian.
    Differentiable w.r.t. (params, warp_params, z, sigma2) jointly.
    """
    from ..models.warped import warp, warp_deriv

    if mask is None:
        mask = jnp.ones((X.shape[0],), X.dtype)
    t = warp(warp_params, y)
    l = sharded_log_evidence(
        family, mesh, params, z, sigma2, X, t, mask,
        variational=variational, block_size=block_size, jitter=jitter,
    )
    # g' >= 1 so the log is finite on padded rows too; the mask just
    # removes their (positive) contribution
    return l + jnp.sum(mask * jnp.log(warp_deriv(warp_params, y)))


def sharded_pitc_log_evidence(
    family,
    mesh: Mesh,
    params,
    z,
    sigma2,
    X,
    y,
    mask=None,
    *,
    block_size: int = 256,
    jitter: float | None = None,
    block_jitter: float = 0.0,
):
    """Distributed PITC evidence (models/pitc.py over the mesh).

    PITC's sufficient statistics are sums of per-block whitened
    contributions, so sharding the rows is exact for the partition
    "each shard's local ``block_size`` blocks".  That partition equals
    the single-device one whenever the per-shard row count is a multiple
    of ``block_size`` (otherwise it is a different — equally valid —
    PITC partition: the block structure is a modeling choice).
    """
    from ..models.pitc import pitc_stream_stats

    if mask is None:
        mask = jnp.ones((X.shape[0],), X.dtype)

    def shard_fn(params, z, sigma2, xs, ys, ms):
        inducing = calc_inducing(family, params, z, jitter)
        stats = pitc_stream_stats(
            family, params, inducing, sigma2, xs, ys,
            block_size=min(block_size, xs.shape[0]), mask=ms,
            jitter=block_jitter,
        )
        stats = jax.tree.map(lambda a: jax.lax.psum(a, DATA_AXIS), stats)
        return evidence_from_stats(inducing, stats, variational=False)

    fn = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(), P(), P(), P(DATA_AXIS, None), P(DATA_AXIS), P(DATA_AXIS)),
        out_specs=P(),
        check_vma=False,
    )
    return fn(params, z, jnp.asarray(sigma2, X.dtype), X, y, mask)


def sharded_predict_means(family, mesh: Mesh, params, z, coeffs, X):
    """Batch mean prediction with the n-axis sharded: purely local GEMMs,
    zero collectives — serving scales linearly with chips."""
    n = X.shape[0]
    pad = (-n) % mesh.devices.size
    Xp = (
        jnp.concatenate([X, jnp.zeros((pad, X.shape[1]), X.dtype)])
        if pad else X
    )

    def shard_fn(params, z, coeffs, xs):
        return matmul(family.k_cross(params, xs, z), coeffs)

    fn = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(), P(), P(), P(DATA_AXIS, None)),
        out_specs=P(DATA_AXIS),
        check_vma=False,
    )
    out = fn(params, z, coeffs, Xp)
    # replicate before trimming the padding (slicing a row-sharded array to a
    # non-divisible length would need an ambiguous reshard)
    return jax.device_put(out, NamedSharding(mesh, P()))[:n]


def sharded_predict_variances(
    family, mesh: Mesh, params, z, chol_km, r_mat, X, sigma2, *,
    predictive=True
):
    """Sharded marginal variances; local solves against replicated factors."""
    n = X.shape[0]
    pad = (-n) % mesh.devices.size
    Xp = (
        jnp.concatenate([X, jnp.zeros((pad, X.shape[1]), X.dtype)])
        if pad else X
    )
    u_inv = inv_tri_upper(chol_km)
    r_inv = inv_tri_upper(r_mat)

    def shard_fn(params, z, u_inv, r_inv, xs):
        ktm = family.k_cross(params, xs, z)
        kd = family.k_diag(params, xs)
        out = (
            kd
            - rows_sqr_norm(matmul(ktm, u_inv))
            + rows_sqr_norm(matmul(ktm, r_inv))
        )
        return out + sigma2 if predictive else out

    fn = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(), P(), P(), P(), P(DATA_AXIS, None)),
        out_specs=P(DATA_AXIS),
        check_vma=False,
    )
    out = fn(params, z, u_inv, r_inv, Xp)
    return jax.device_put(out, NamedSharding(mesh, P()))[:n]


def make_sharded_objective(
    family,
    mesh: Mesh,
    X,
    y,
    pack,
    *,
    variational: bool = False,
    block_size: int = 8192,
):
    """Jitted value-and-grad of the NEGATIVE sharded evidence over a packed
    hyper vector (see optim.pack) — the distributed training step."""
    X, y, mask = pad_to_shards(mesh, X, y)
    row = NamedSharding(mesh, P(DATA_AXIS))
    row2 = NamedSharding(mesh, P(DATA_AXIS, None))
    X = jax.device_put(X, row2)
    y = jax.device_put(y, row)
    mask = jax.device_put(mask, row)

    # Data threads through as jit arguments (closure capture would embed the
    # shards as compiled-in constants).
    @jax.jit
    def _neg_l_and_grad(xvec, X, y, mask):
        def f(xvec):
            params, z, sigma2 = pack.unpack(xvec)
            return -sharded_log_evidence(
                family, mesh, params, z, sigma2, X, y, mask,
                variational=variational, block_size=block_size,
            )

        return jax.value_and_grad(f)(xvec)

    return lambda xvec: _neg_l_and_grad(xvec, X, y, mask)


def probe_starts_sharded(
    family,
    mesh: Mesh,
    X,
    y,
    pack,
    x0s,
    *,
    probe_iters: int = 15,
    variational: bool = False,
    streaming_block_size: int | None = None,
    normalize: bool = True,
    step: float = 0.1,
    tol: float = 0.1,
    epsabs: float = 0.1,
    history: int = 10,
    f_noise: float | None = None,
    dispatch_iters: int = 50,
    log_prior=None,
):
    """Run S independent L-BFGS probes CONCURRENTLY, one batch of starts per
    device: (X, y) replicate to every chip, the starts axis shards over the
    mesh, and each device vmaps its local starts through the device L-BFGS.
    S probes cost the wall-clock of ceil(S / n_devices) — multi-start
    training's probe phase is embarrassingly parallel (the reference has no
    multi-start at all; its single GSL loop is bin/ocaml_gpr.ml:301-349).

    Returns a stacked LBFGSDeviceState whose leaves have a leading (S,)
    axis (padding starts, added to fill the mesh, are trimmed).

    Probes are bounded by ``probe_iters`` so the chunk-level noise-floor
    stall detector of the sequential path is deliberately absent: a stalled
    probe grinds at most to the probe bound, and per-start early exit still
    happens through the optimizer's own stopping rule.
    """
    from ..optim.lbfgs_device import (
        _fresh_state,
        _make_fg,
        minimize_lbfgs_device,
    )

    scale = 1.0 / X.shape[0] if normalize else 1.0
    if f_noise is None:
        f_noise = 5e-7 if X.dtype == jnp.float32 else 0.0
    _fg_of = _make_fg(family, pack, variational, streaming_block_size,
                      scale, log_prior)

    x0s = jnp.stack([jnp.asarray(x, pack.x0.dtype) for x in x0s])
    n_starts = x0s.shape[0]
    # starts shard over the DATA axis; on a 2-D (data x model) mesh the
    # model axis just replicates the probes (idle TP during the probe
    # phase is the honest cost of probing a replicated-m objective)
    n_dev = mesh.shape[DATA_AXIS]
    pad = (-n_starts) % n_dev
    if pad:
        x0s = jnp.concatenate([x0s, jnp.tile(x0s[-1:], (pad, 1))])

    rep = NamedSharding(mesh, P())
    Xr = jax.device_put(X, rep)
    yr = jax.device_put(y, rep)
    chunk = min(dispatch_iters, probe_iters)

    @jax.jit
    def _init(x0s, X, y):
        def shard_fn(x0s_l, X, y):
            def one(x0):
                return _fresh_state(x0, *_fg_of(x0, X, y), history)

            return jax.vmap(one)(x0s_l)

        return jax.shard_map(
            shard_fn, mesh=mesh,
            in_specs=(P(DATA_AXIS), P(), P()), out_specs=P(DATA_AXIS),
            check_vma=False,
        )(x0s, X, y)

    @jax.jit
    def _chunk(sts, X, y):
        def shard_fn(sts_l, X, y):
            def one(st):
                return minimize_lbfgs_device(
                    lambda x: _fg_of(x, X, y), st.x, step=step, tol=tol,
                    epsabs=epsabs, max_iter=probe_iters, history=history,
                    f_noise=f_noise, init_state=st, dispatch_iters=chunk,
                )

            return jax.vmap(one)(sts_l)

        return jax.shard_map(
            shard_fn, mesh=mesh,
            in_specs=(P(DATA_AXIS), P(), P()), out_specs=P(DATA_AXIS),
            check_vma=False,
        )(sts, X, y)

    @jax.jit
    def _any_go(sts):
        go = (
            (jnp.linalg.norm(sts.g, axis=-1) >= epsabs)
            & (sts.n_iter < probe_iters)
            & (~sts.failed)
            & jnp.isfinite(sts.f)
        )
        return jnp.any(go)

    sts = _init(x0s, Xr, yr)
    while bool(_any_go(sts)):
        sts = _chunk(sts, Xr, yr)
    # replicate before trimming/indexing: host-side gathers on a
    # starts-sharded pytree are ambiguous under sharding-in-types
    sts = jax.device_put(sts, rep)
    if pad:
        sts = jax.tree.map(lambda a: a[:n_starts], sts)
    return sts


def fit_restarts_sharded(
    family,
    mesh: Mesh,
    X,
    y,
    pack,
    x0s,
    *,
    probe_iters: int = 15,
    variational: bool = False,
    block_size: int = 8192,
    normalize: bool = True,
    step: float = 0.1,
    tol: float = 0.1,
    epsabs: float = 0.1,
    max_iter: int = 100,
    history: int = 10,
    f_noise: float | None = None,
    dispatch_iters: int = 50,
    log_prior=None,
    probe_subsample: int | None = None,
    probe_seed: int = 0,
    state_callback=None,
):
    """Multi-chip multi-start training: probes run in parallel across the
    mesh (probe_starts_sharded — S starts in the wall-clock of
    ceil(S / n_devices)), then the best start continues via the n-sharded
    distributed L-BFGS (fit_sharded; on a 2-D data x model mesh the
    continuation is the tensor-parallel fit_sharded_2d).

    Semantics mirror optim.fit_restarts: probes rank by (healthy, f);
    with ``probe_subsample`` the probes score a seeded row subsample
    (replicated — each device holds n_sub rows) and the winner restarts on
    the full sharded data with fresh curvature history; without it the
    probes score the FULL data (replicated per device — mind host memory)
    and the winner's curvature history carries into the continuation.
    Returns (params, z, sigma2, final_state, ProbeReport).
    """
    import math

    from ..optim.lbfgs_device import ProbeReport

    if f_noise is None:
        f_noise = 5e-7 if X.dtype == jnp.float32 else 0.0
    subsampled = (
        probe_subsample is not None and probe_subsample < X.shape[0]
    )
    if subsampled:
        import numpy as _np

        idx = jnp.asarray(_np.random.default_rng(probe_seed).choice(
            X.shape[0], probe_subsample, replace=False))
        Xp_, yp_ = X[idx], y[idx]
    else:
        Xp_, yp_ = X, y
    # probes score the same streaming-stats evidence the sharded
    # continuation optimizes (just unsharded, on the replicated probe rows)
    sbs = min(block_size, int(Xp_.shape[0]))

    sts = probe_starts_sharded(
        family, mesh, Xp_, yp_, pack, x0s, probe_iters=probe_iters,
        variational=variational, streaming_block_size=sbs,
        normalize=normalize, step=step, tol=tol, epsabs=epsabs,
        history=history, f_noise=f_noise, dispatch_iters=dispatch_iters,
        log_prior=log_prior,
    )

    def _rank(i):
        f = float(sts.f[i])
        bad = 2 if not math.isfinite(f) else (1 if bool(sts.failed[i]) else 0)
        return (bad, f if math.isfinite(f) else math.inf)

    n_starts = sts.x.shape[0]
    winner = min(range(n_starts), key=_rank)
    best = jax.tree.map(lambda a: a[winner], sts)

    report = ProbeReport(float(f) for f in sts.f)
    report.probe_evals = int(jnp.sum(sts.n_evals))
    report.probe_iters = int(jnp.sum(sts.n_iter))

    import dataclasses as _dc

    if subsampled:
        cont_pack = _dc.replace(pack, x0=best.x)
        init_state = None
    else:
        cont_pack = pack
        init_state = best._replace(failed=jnp.asarray(False))
    if "model" in mesh.axis_names and mesh.shape["model"] > 1:
        from .mesh2d import fit_sharded_2d as _continue
    else:
        _continue = fit_sharded
    params, z, sigma2, st = _continue(
        family, mesh, X, y, cont_pack, variational=variational,
        block_size=block_size, normalize=normalize, step=step, tol=tol,
        epsabs=epsabs, max_iter=max_iter, history=history, f_noise=f_noise,
        dispatch_iters=dispatch_iters, log_prior=log_prior,
        init_state=init_state, state_callback=state_callback,
    )
    base_evals = 0 if subsampled else int(best.n_evals)
    base_iters = 0 if subsampled else int(best.n_iter)
    report.cont_evals = int(st.n_evals) - base_evals
    report.cont_iters = int(st.n_iter) - base_iters
    return params, z, sigma2, st, report


def fit_sharded(
    family,
    mesh: Mesh,
    X,
    y,
    pack,
    *,
    variational: bool = False,
    block_size: int = 8192,
    normalize: bool = True,
    step: float = 0.1,
    tol: float = 0.1,
    epsabs: float = 0.1,
    max_iter: int = 100,
    history: int = 10,
    f_noise: float | None = None,
    dispatch_iters: int = 50,
    log_prior=None,
    init_state=None,
    state_callback=None,
):
    """Multi-chip training without host round trips: the chunked device
    L-BFGS (optim.lbfgs_device) over the n-sharded evidence.  Every
    line-search probe runs the distributed evidence+gradient (one psum of
    ~m^2 accumulators over the interconnect) with the optimizer state resident on
    device; the host sees one scalar check per ``dispatch_iters``
    iterations.

    Semantics match optim.lbfgs_device.fit (normalize/log_prior/f_noise/
    chunking); the gradient of the shard_map-based objective is taken
    INSIDE jit, as required (CLAUDE.md).  Returns
    (params, z, sigma2, LBFGSDeviceState).
    """
    from ..optim.lbfgs_device import fit_packed_objective

    scale = 1.0 / X.shape[0] if normalize else 1.0
    if f_noise is None:
        f_noise = 5e-7 if X.dtype == jnp.float32 else 0.0
    Xp, yp, mask = pad_to_shards(mesh, X, y)
    row = NamedSharding(mesh, P(DATA_AXIS))
    Xp = jax.device_put(Xp, NamedSharding(mesh, P(DATA_AXIS, None)))
    yp = jax.device_put(yp, row)
    mask = jax.device_put(mask, row)

    def _fg_of(x, X, y, mask):
        def f(x):
            params, z, sigma2 = pack.unpack(x)
            l = sharded_log_evidence(
                family, mesh, params, z, sigma2, X, y, mask,
                variational=variational, block_size=block_size,
            )
            if log_prior is not None:
                l = l + log_prior(params, z, sigma2)
            return -l * scale

        return jax.value_and_grad(f)(x)

    st = fit_packed_objective(
        _fg_of, pack, (Xp, yp, mask), step=step, tol=tol, epsabs=epsabs,
        max_iter=max_iter, history=history, f_noise=f_noise,
        dispatch_iters=dispatch_iters, init_state=init_state,
        state_callback=state_callback,
    )
    params, z, sigma2 = pack.unpack(st.x)
    return params, z, sigma2, st

"""2-D (data x model) mesh evidence: tensor parallelism over the m axis.

The 1-D path (sharded.py) replicates all m-sized work; fine to m ~ a few
thousand.  Beyond that, the two O(n m^2) GEMMs per pass (V = Knm U^-1 and
the Gram) dominate — this module shards them over a second mesh axis while
staying *exact*:

  per (data_i, model_j) member, per row block:
    knm   = K(X_block, Z)                      duplicated over model
                                               (O(n m d): ~d/m of the GEMM
                                               flops — negligible)
    V_.j  = knm @ U^-1[:, cols_j]              GEMM #1, model-sharded
    rowsq = psum_model(rowsq(V_.j))            n_block floats over the axis
    r, s, 1/s                                  elementwise
    G_.j += knm' (1/s * knm[:, cols_j])        GEMM #2, model-sharded
    u    += knm' (y / s)                       GEMV, duplicated (cheap)

  epilogue (replicated): psum_data + all_gather_model the raw Gram column
  blocks, whiten G~ = U^-T G U^-1, factor I + G~, evidence as in
  models/streaming.py.

Precision: the raw-Gram sandwich amplifies accumulation rounding by
cond(Km); with f64 accumulators (x64 enabled) the identity margin holds,
but in pure f32 the whitened matrix can lose positive-definiteness by O(1)
(measured -3.2 on an ill-conditioned 1-D example).  When accumulators are
f32 this module therefore switches to accumulating the *whitened* Gram
directly (compute the full V row block — duplicating the V GEMM across the
model axis — and shard only the Gram GEMM): unconditionally stable, with a
reduced TP speedup ceiling of 2x.  With x64 both GEMMs shard.

The m x m factorizations stay replicated — the honest threshold for this
design is m where m^3 / device flops or m^2 memory binds (~10^4 - 10^5 on
one card); distributed block Cholesky (parallel/dist_chol.py) is the step
beyond.

Requires m divisible by the model-axis size.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from ..models.fitc import LOG_2PI, calc_inducing
from ..numerics.linalg import (
    cholesky_upper,
    inv_tri_upper,
    log_det_tri,
    matmul,
    solve_tri,
)

DATA_AXIS = "data"
MODEL_AXIS = "model"


def make_mesh_2d(n_data: int, n_model: int) -> Mesh:
    devices = jax.devices()
    if n_data * n_model > len(devices):
        raise ValueError(
            f"mesh {n_data}x{n_model} needs {n_data * n_model} devices, "
            f"have {len(devices)}"
        )
    return jax.make_mesh(
        (n_data, n_model), (DATA_AXIS, MODEL_AXIS),
        devices=devices[: n_data * n_model],
    )


def _acc_dtype():
    return jnp.float64 if jax.config.jax_enable_x64 else jnp.float32


def sharded_log_evidence_2d(
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
    epilogue: str = "replicated",
    inducing: str = "replicated",
    factorization: str | None = None,
):
    """Exact evidence over a (data, model) mesh.

    X (n, d) and y (n,) shard over the data axis (replicated over model);
    params/z/sigma2 replicate everywhere.  Differentiable; collectives
    transpose correctly under jax.grad.

    ``epilogue="distributed"`` keeps the Gram column-block sharded end to
    end: no all_gather, distributed block Cholesky of I + G~ and distributed
    forward substitution (parallel/dist_chol.py) — per-chip memory for the
    data Gram drops to O(m^2 / p_model).  (The inducing factor U stays
    replicated: a one-off O(m^3) independent of n.)  With f64 accumulators
    the raw Gram is accumulated (BOTH O(n m^2) GEMMs shard — full TP) and
    whitened in place by the distributed two-sided whitening
    (dist_chol.whiten_cols_replicated: two local triangular solves around a
    ppermute-ring block transpose, never materializing m x m); with f32
    accumulators the whitened Gram is accumulated directly (PSD by
    construction; the V GEMM duplicates, TP ceiling 2x, as in the
    replicated-epilogue f32 mode).

    ``inducing="distributed"`` removes the LAST replicated m-sized state:
    Km is built as column blocks (kernels.base.k_upper_cols), factored by
    the distributed block Cholesky, and the per-row FITC diagonal is
    computed via column blocks of P = Km^-1 (rowsq(V) = rowdot(Knm, Knm P),
    psum'd over the model axis) — NO member ever holds an m x m matrix.
    Implies the distributed epilogue.  This is the m >~ 3e4 regime where
    replicated O(m^2) no longer fits one chip.

    The raw Gram column blocks B = Km + Knm' diag(is) Knm are factored
    directly with f64 accumulators (``factorization="raw"``); with f32
    accumulators the default switches to ``"whitened"``: compensated
    (two-sum) f32 accumulation of the raw blocks, then the distributed
    two-sided whitening G~ = U^-T G U^-1 (dist_chol.dist_whiten_cols — two
    distributed forward substitutions around a ppermute-ring block
    transpose) and a factorization of I + G~, whose identity margin absorbs
    the f32 rounding that makes the raw sandwich lose definiteness.  Pass
    ``factorization=`` to override the dtype-based default.
    """
    if mask is None:
        mask = jnp.ones((X.shape[0],), X.dtype)
    n_model = mesh.shape[MODEL_AXIS]
    m = z.shape[0]

    if inducing == "distributed":
        # any m: the linear algebra is identity-padded to a block multiple
        # (virtual dimensions decouple exactly — zero cross-columns, unit
        # diagonal — so evidence and gradients are unchanged)
        m_pad = -(-m // n_model) * n_model
        z_pad = _pad_inducing_rows(z, m_pad - m)
        return _fully_distributed_evidence(
            family, mesh, params, z_pad, sigma2, X, y, mask,
            variational=variational, block_size=block_size, jitter=jitter,
            n_model=n_model, m_t=m_pad // n_model, m_real=m,
            factorization=factorization,
        )

    if m % n_model != 0:
        raise ValueError(
            f"m ({m}) must be divisible by the model axis ({n_model}) "
            "for the replicated-inducing modes (inducing='distributed' "
            "pads automatically)"
        )
    m_t = m // n_model

    # raw-Gram TP needs f64 accumulators to survive the whitening sandwich
    # (the f32 modes accumulate the whitened Gram directly instead)
    raw_gram = _acc_dtype() == jnp.float64

    def shard_fn(params, z, sigma2, xs, ys, ms):
        j = lax.axis_index(MODEL_AXIS)
        inducing = calc_inducing(family, params, z, jitter)
        u_inv = inv_tri_upper(inducing.chol_km)  # replicated (m, m)
        u_inv_j = lax.dynamic_slice_in_dim(u_inv, j * m_t, m_t, axis=1)

        n_local = xs.shape[0]
        bs = min(block_size, n_local)
        nb = -(-n_local // bs)
        pad = nb * bs - n_local
        if pad:
            xs = jnp.concatenate([xs, jnp.zeros((pad, xs.shape[1]), xs.dtype)])
            ys = jnp.concatenate([ys, jnp.zeros((pad,), ys.dtype)])
            ms = jnp.concatenate([ms, jnp.zeros((pad,), ms.dtype)])
        xb = xs.reshape(nb, bs, xs.shape[1])
        yb = ys.reshape(nb, bs)
        mb = ms.reshape(nb, bs)

        acc = _acc_dtype()

        def body(carry, blk):
            x_b, y_b, mask_b = blk
            knm = family.k_cross(params, x_b, z)  # (bs, m), dup over model
            kd = family.k_diag(params, x_b)
            live = mask_b > 0
            gram_j, u_vec, lds, yiy, isr, cnt = carry
            if raw_gram:
                v_j = matmul(knm, u_inv_j)  # (bs, m_t) model-sharded GEMM
                rq = lax.psum(jnp.sum(jnp.square(v_j), axis=-1), MODEL_AXIS)
                r = kd - rq
                s = jnp.where(live, r + sigma2, 1.0)
                is_ = mask_b / s
                knm_j = lax.dynamic_slice_in_dim(knm, j * m_t, m_t, axis=1)
                # raw-Gram column block; whitened in the epilogue (f64
                # accumulation preserves PSD through the sandwich)
                gram_j = gram_j + matmul(
                    knm.T, is_[:, None] * knm_j
                ).astype(acc)
                u_vec = u_vec + matmul(knm.T, is_ * y_b).astype(acc)
            else:
                # f32-stable mode: full V per member (duplicated GEMM), shard
                # only the whitened-Gram GEMM — PSD by construction
                v = matmul(knm, u_inv)  # (bs, m)
                r = kd - jnp.sum(jnp.square(v), axis=-1)
                s = jnp.where(live, r + sigma2, 1.0)
                is_ = mask_b / s
                sqrt_is = jnp.where(
                    live, jnp.sqrt(jnp.where(live, is_, 1.0)), 0.0
                )
                a = v * sqrt_is[:, None]
                a_j = lax.dynamic_slice_in_dim(a, j * m_t, m_t, axis=1)
                gram_j = gram_j + matmul(a.T, a_j).astype(acc)
                u_vec = u_vec + matmul(v.T, is_ * y_b).astype(acc)
            lds = lds + jnp.sum(jnp.where(live, jnp.log(s), 0.0)).astype(acc)
            yiy = yiy + jnp.sum(is_ * y_b * y_b).astype(acc)
            isr = isr + jnp.sum(is_ * r).astype(acc)
            cnt = cnt + jnp.sum(mask_b).astype(acc)
            return (gram_j, u_vec, lds, yiy, isr, cnt), None

        init = (
            jnp.zeros((m, m_t), acc),
            jnp.zeros((m,), acc),
            jnp.zeros((), acc),
            jnp.zeros((), acc),
            jnp.zeros((), acc),
            jnp.zeros((), acc),
        )
        (gram_j, u_vec, lds, yiy, isr, cnt), _ = lax.scan(
            jax.checkpoint(body), init, (xb, yb, mb)
        )

        # reduce: data-psum the column blocks; the scalar stats and u were
        # computed identically on every model member (duplicated work), so
        # they only reduce over data
        gram_j = lax.psum(gram_j, DATA_AXIS)
        u_vec = lax.psum(u_vec, DATA_AXIS)
        lds = lax.psum(lds, DATA_AXIS)
        yiy = lax.psum(yiy, DATA_AXIS)
        isr = lax.psum(isr, DATA_AXIS)
        cnt = lax.psum(cnt, DATA_AXIS)

        dt = inducing.km.dtype
        if epilogue == "distributed":
            # Gram column blocks stay sharded: distributed factorization.
            # raw_gram (f64): whiten the raw blocks in place first — two
            # local triangular solves around a ppermute-ring transpose.
            from .dist_chol import (
                dist_cholesky_upper,
                dist_log_det_tri,
                dist_solve_lower_t,
                whiten_cols_replicated,
            )

            if raw_gram:
                gw_j = whiten_cols_replicated(
                    inducing.chol_km.astype(acc), gram_j, MODEL_AXIS, n_model
                ).astype(dt)
                u_white = solve_tri(
                    inducing.chol_km, u_vec.astype(dt), trans=True
                )
            else:
                gw_j = gram_j.astype(dt)
                u_white = u_vec.astype(dt)  # accumulated as V'(is y) = U^-T u
            rows = jnp.arange(m)[:, None]
            cols = (j * m_t + jnp.arange(m_t))[None, :]
            eye_j = jnp.where(rows == cols, jnp.ones((), dt), 0.0)
            a_j = eye_j + gw_j
            r_j = dist_cholesky_upper(a_j, MODEL_AXIS, n_model)
            l1 = -0.5 * (
                dist_log_det_tri(r_j, MODEL_AXIS).astype(acc)
                + lds + cnt * LOG_2PI
            )
            if variational:
                l1 = l1 - 0.5 * isr
            t = dist_solve_lower_t(r_j, u_white, MODEL_AXIS, n_model)
            l2 = -0.5 * jnp.maximum(  # quad >= 0; see streaming
                yiy - jnp.dot(t, t).astype(acc), 0.0)
            return (l1 + l2).astype(dt)

        gram = lax.all_gather(gram_j, MODEL_AXIS, axis=1, tiled=True)  # (m, m)

        # whitened epilogue (replicated m^3)
        if raw_gram:
            g_white = matmul(
                u_inv.T.astype(acc), matmul(gram, u_inv.astype(acc))
            )
            g_white = 0.5 * (g_white + g_white.T)
        else:
            g_white = gram  # already whitened in the body
        r_tilde = cholesky_upper(
            (jnp.eye(m, dtype=acc) + g_white).astype(dt), jitter=0.0
        )
        l1 = -0.5 * (
            log_det_tri(r_tilde).astype(acc) + lds + cnt * LOG_2PI
        )
        if variational:
            l1 = l1 - 0.5 * isr
        if raw_gram:
            u_white = solve_tri(inducing.chol_km, u_vec.astype(dt), trans=True)
        else:
            u_white = u_vec.astype(dt)  # accumulated as V'(is y) = U^-T u
        t = solve_tri(r_tilde, u_white, trans=True)
        l2 = -0.5 * jnp.maximum(  # quad >= 0; see streaming
            yiy - jnp.dot(t, t).astype(acc), 0.0)
        return (l1 + l2).astype(dt)

    fn = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(
            P(), P(), P(),
            P(DATA_AXIS, None), P(DATA_AXIS), P(DATA_AXIS),
        ),
        out_specs=P(),
        check_vma=False,
    )
    return fn(params, z, jnp.asarray(sigma2, X.dtype), X, y, mask)


def _pad_inducing_rows(z, pad):
    """Append kernel-evaluable dummy rows (copies of row 0); their matrix
    entries are masked to the identity downstream."""
    if pad == 0:
        return z
    return jnp.concatenate([z, jnp.broadcast_to(z[:1], (pad,) + z.shape[1:])])


def _fully_distributed_evidence(
    family, mesh, params, z, sigma2, X, y, mask, *,
    variational, block_size, jitter, n_model, m_t, m_real,
    factorization=None,
):
    """No-replicated-m^2 evidence: see sharded_log_evidence_2d docstring
    (``inducing="distributed"``)."""
    from ..config import config
    from ..kernels.base import k_upper_cols
    from ..models.stream_grad import _two_sum
    from .dist_chol import (
        dist_cholesky_upper,
        dist_log_det_tri,
        dist_solve_lower_t,
        dist_spd_inverse_cols,
        dist_whiten_cols,
    )

    m = z.shape[0]
    jit = jitter if jitter is not None else config.cholesky_jitter
    if factorization is None:
        factorization = (
            "raw" if _acc_dtype() == jnp.float64 else "whitened"
        )
    if factorization not in ("raw", "whitened"):
        raise ValueError(f"unknown factorization {factorization!r}")

    def shard_fn(params, z, sigma2, xs, ys, ms):
        j = lax.axis_index(MODEL_AXIS)
        j0 = j * m_t
        dt = z.dtype
        acc = _acc_dtype()

        km_j = k_upper_cols(family, params, z, j0, m_t)  # (m, m_t)
        rows = jnp.arange(m)[:, None]
        cols = (j0 + jnp.arange(m_t))[None, :]
        on_diag = rows == cols
        # identity-pad virtual dimensions (m_real..m): unit diagonal, zero
        # couplings — they contribute exactly nothing to the evidence
        real = (rows < m_real) & (cols < m_real)
        km_j = jnp.where(real, km_j,
                         jnp.where(on_diag, jnp.ones((), dt), 0.0))
        real_diag = on_diag & (rows < m_real)
        jit_eff = jnp.asarray(jit, dt)
        if jitter is None and dt == jnp.float32:
            # same policy as numerics.linalg.cholesky_upper: in f32 the
            # default jitter scales with the diagonal magnitude
            diag_mean = lax.psum(
                jnp.sum(jnp.where(real_diag, jnp.abs(km_j), 0.0)), MODEL_AXIS
            ) / m_real
            jit_eff = jnp.maximum(jit_eff, 1e-5 * diag_mean)
        km_jit_j = km_j + jnp.where(real_diag, jit_eff, 0.0)
        u_j = dist_cholesky_upper(km_jit_j, MODEL_AXIS, n_model)
        log_det_km = dist_log_det_tri(u_j, MODEL_AXIS)
        p_j = dist_spd_inverse_cols(u_j, MODEL_AXIS, n_model)  # Km^-1 cols
        col_live = (jnp.arange(m) < m_real)[None, :]

        n_local = xs.shape[0]
        bs = min(block_size, n_local)
        nb = -(-n_local // bs)
        pad = nb * bs - n_local
        if pad:
            xs = jnp.concatenate([xs, jnp.zeros((pad, xs.shape[1]), xs.dtype)])
            ys = jnp.concatenate([ys, jnp.zeros((pad,), ys.dtype)])
            ms = jnp.concatenate([ms, jnp.zeros((pad,), ms.dtype)])
        xb = xs.reshape(nb, bs, xs.shape[1])
        yb = ys.reshape(nb, bs)
        mb = ms.reshape(nb, bs)

        comp = acc == jnp.float32  # compensate when f64 is unavailable

        def body(carry, blk):
            x_b, y_b, mask_b = blk
            knm = family.k_cross(params, x_b, z)  # (bs, m) dup over model
            knm = jnp.where(col_live, knm, 0.0)  # zero virtual columns
            kd = family.k_diag(params, x_b)
            knm_j = lax.dynamic_slice_in_dim(knm, j0, m_t, axis=1)
            # rowsq(V) = rowdot(Knm, Knm Km^-1): model-sharded GEMM + psum
            w_j = matmul(knm, p_j)  # (bs, m_t)
            rq = lax.psum(jnp.sum(knm_j * w_j, axis=-1), MODEL_AXIS)
            live = mask_b > 0
            r = kd - rq
            s = jnp.where(live, r + sigma2, 1.0)
            is_ = mask_b / s
            terms = (
                matmul(knm.T, is_[:, None] * knm_j).astype(acc),
                matmul(knm.T, is_ * y_b).astype(acc),
                jnp.sum(jnp.where(live, jnp.log(s), 0.0)).astype(acc),
                jnp.sum(is_ * y_b * y_b).astype(acc),
                jnp.sum(is_ * r).astype(acc),
                jnp.sum(mask_b).astype(acc),
            )
            if comp:
                # two-sum pairs: cross-tile f32 accumulation error on the
                # raw Gram is what the downstream whitening amplifies
                new = tuple(
                    _two_sum(hi, lo, t) for (hi, lo), t in zip(carry, terms)
                )
            else:
                new = tuple(
                    (hi + t, lo) for (hi, lo), t in zip(carry, terms)
                )
            return new, None

        shapes = [(m, m_t), (m,), (), (), (), ()]
        init = tuple((jnp.zeros(sh, acc), jnp.zeros(sh, acc)) for sh in shapes)
        out, _ = lax.scan(jax.checkpoint(body), init, (xb, yb, mb))
        # fold pairs, then reduce over data (p_data-1 extra roundings only)
        gram_j, u_vec, lds, yiy, isr, cnt = (
            lax.psum(hi + lo if comp else hi, DATA_AXIS) for hi, lo in out
        )

        if factorization == "raw":
            # fully distributed: R'R = B = Km~ + G
            b_j = km_jit_j.astype(acc) + gram_j
            r_j = dist_cholesky_upper(b_j.astype(dt), MODEL_AXIS, n_model)
            log_det_ratio = (
                dist_log_det_tri(r_j, MODEL_AXIS).astype(acc)
                - log_det_km.astype(acc)
            )
            t = dist_solve_lower_t(r_j, u_vec.astype(dt), MODEL_AXIS, n_model)
        else:
            # whitened: G~ = U^-T G U^-1 via the distributed two-sided
            # whitening; I + G~'s identity margin absorbs f32 rounding
            gw_j = dist_whiten_cols(u_j, gram_j.astype(dt), MODEL_AXIS,
                                    n_model)
            eye_j = jnp.where(on_diag, jnp.ones((), dt), 0.0)
            rt_j = dist_cholesky_upper(eye_j + gw_j, MODEL_AXIS, n_model)
            # log det B - log det Km = log det (I + G~)
            log_det_ratio = dist_log_det_tri(rt_j, MODEL_AXIS).astype(acc)
            # R = R~ U: R' t = u  =>  U' w = u, then R~' t = w
            w = dist_solve_lower_t(u_j, u_vec.astype(dt), MODEL_AXIS, n_model)
            t = dist_solve_lower_t(rt_j, w, MODEL_AXIS, n_model)
        l1 = -0.5 * (log_det_ratio + lds + cnt * LOG_2PI)
        if variational:
            l1 = l1 - 0.5 * isr
        l2 = -0.5 * jnp.maximum(  # quad >= 0; see streaming
            yiy - jnp.dot(t, t).astype(acc), 0.0)
        return (l1 + l2).astype(dt)

    fn = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(
            P(), P(), P(),
            P(DATA_AXIS, None), P(DATA_AXIS), P(DATA_AXIS),
        ),
        out_specs=P(),
        check_vma=False,
    )
    return fn(params, z, jnp.asarray(sigma2, X.dtype), X, y, mask)


def fully_distributed_predict(
    family, mesh, params, z, sigma2, X, y, Xstar, mask=None, *,
    variational: bool = False, block_size: int = 8192,
    jitter: float | None = None, predictive: bool = True,
):
    """Posterior means and variances at ``Xstar`` with NO replicated m x m
    state — the serving side of ``inducing="distributed"``.

    Trains nothing: conditions on (X, y) through the same fully distributed
    statistics, then predicts via
        mean  = Ktm coeffs                      (coeffs: m-vector, replicated)
        var   = kt_diag - rowdot(Ktm, Ktm Km^-1) + rowdot(Ktm, Ktm B^-1)
    where the two inverses live as column blocks (rowdots psum over the
    model axis).  Xstar shards over the data axis like X.
    """
    from ..config import config
    from ..kernels.base import k_upper_cols
    from .dist_chol import (
        dist_cholesky_upper,
        dist_solve_lower_t,
        dist_spd_inverse_cols,
    )

    if mask is None:
        mask = jnp.ones((X.shape[0],), X.dtype)
    n_model = mesh.shape[MODEL_AXIS]
    m_real = z.shape[0]
    m = -(-m_real // n_model) * n_model  # identity-padded block multiple
    z = _pad_inducing_rows(z, m - m_real)
    m_t = m // n_model
    jit = jitter if jitter is not None else config.cholesky_jitter

    def shard_fn(params, z, sigma2, xs, ys, ms, xstar):
        j = lax.axis_index(MODEL_AXIS)
        j0 = j * m_t
        dt = z.dtype
        acc = _acc_dtype()

        km_j = k_upper_cols(family, params, z, j0, m_t)
        rows = jnp.arange(m)[:, None]
        cols = (j0 + jnp.arange(m_t))[None, :]
        on_diag = rows == cols
        real = (rows < m_real) & (cols < m_real)
        km_j = jnp.where(real, km_j,
                         jnp.where(on_diag, jnp.ones((), dt), 0.0))
        real_diag = on_diag & (rows < m_real)
        jit_eff = jnp.asarray(jit, dt)
        if jitter is None and dt == jnp.float32:
            diag_mean = lax.psum(
                jnp.sum(jnp.where(real_diag, jnp.abs(km_j), 0.0)), MODEL_AXIS
            ) / m_real
            jit_eff = jnp.maximum(jit_eff, 1e-5 * diag_mean)
        km_jit_j = km_j + jnp.where(real_diag, jit_eff, 0.0)
        u_j = dist_cholesky_upper(km_jit_j, MODEL_AXIS, n_model)
        p_j = dist_spd_inverse_cols(u_j, MODEL_AXIS, n_model)
        col_live = (jnp.arange(m) < m_real)[None, :]

        # conditioning statistics (same scan as the evidence, minus scalars)
        n_local = xs.shape[0]
        bs = min(block_size, n_local)
        nb = -(-n_local // bs)
        pad = nb * bs - n_local
        if pad:
            xs = jnp.concatenate([xs, jnp.zeros((pad, xs.shape[1]), xs.dtype)])
            ys = jnp.concatenate([ys, jnp.zeros((pad,), ys.dtype)])
            ms = jnp.concatenate([ms, jnp.zeros((pad,), ms.dtype)])

        def body(carry, blk):
            x_b, y_b, mask_b = blk
            knm = family.k_cross(params, x_b, z)
            knm = jnp.where(col_live, knm, 0.0)
            kd = family.k_diag(params, x_b)
            knm_j = lax.dynamic_slice_in_dim(knm, j0, m_t, axis=1)
            w_j = matmul(knm, p_j)
            rq = lax.psum(jnp.sum(knm_j * w_j, axis=-1), MODEL_AXIS)
            live = mask_b > 0
            s = jnp.where(live, kd - rq + sigma2, 1.0)
            is_ = mask_b / s
            gram_j, u_vec = carry
            gram_j = gram_j + matmul(knm.T, is_[:, None] * knm_j).astype(acc)
            u_vec = u_vec + matmul(knm.T, is_ * y_b).astype(acc)
            return (gram_j, u_vec), None

        init = (jnp.zeros((m, m_t), acc), jnp.zeros((m,), acc))
        (gram_j, u_vec), _ = lax.scan(
            jax.checkpoint(body), init,
            (xs.reshape(nb, bs, -1), ys.reshape(nb, bs), ms.reshape(nb, bs)),
        )
        gram_j = lax.psum(gram_j, DATA_AXIS)
        u_vec = lax.psum(u_vec, DATA_AXIS)

        b_j = (km_jit_j.astype(acc) + gram_j).astype(dt)
        r_j = dist_cholesky_upper(b_j, MODEL_AXIS, n_model)
        binv_j = dist_spd_inverse_cols(r_j, MODEL_AXIS, n_model)
        t = dist_solve_lower_t(r_j, u_vec.astype(dt), MODEL_AXIS, n_model)
        # coeffs = B^-1 u — second (upper) solve on the m-vector
        from .dist_chol import dist_solve_upper_cols

        coeffs = dist_solve_upper_cols(
            r_j, jnp.broadcast_to(t[:, None], (m, 1)), MODEL_AXIS, n_model
        )[:, 0]

        # predict at xstar row blocks (local to each data member)
        ns = xstar.shape[0]
        bs2 = min(block_size, ns)
        nb2 = -(-ns // bs2)
        pad2 = nb2 * bs2 - ns
        xsp = (jnp.concatenate(
            [xstar, jnp.zeros((pad2, xstar.shape[1]), xstar.dtype)])
            if pad2 else xstar)

        def pblk(x_b):
            ktm = family.k_cross(params, x_b, z)
            ktm = jnp.where(col_live, ktm, 0.0)
            kd = family.k_diag(params, x_b)
            ktm_j = lax.dynamic_slice_in_dim(ktm, j0, m_t, axis=1)
            mu = matmul(ktm, coeffs)
            rq_prior = lax.psum(
                jnp.sum(ktm_j * matmul(ktm, p_j), axis=-1), MODEL_AXIS
            )
            rq_post = lax.psum(
                jnp.sum(ktm_j * matmul(ktm, binv_j), axis=-1), MODEL_AXIS
            )
            var = kd - rq_prior + rq_post
            return mu, var + sigma2 if predictive else var

        mus, vars_ = lax.map(pblk, xsp.reshape(nb2, bs2, -1))
        return mus.reshape(-1)[:ns], vars_.reshape(-1)[:ns]

    fn = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(), P(), P(), P(DATA_AXIS, None), P(DATA_AXIS),
                  P(DATA_AXIS), P(DATA_AXIS, None)),
        out_specs=(P(DATA_AXIS), P(DATA_AXIS)),
        check_vma=False,
    )
    n_star = Xstar.shape[0]
    pad = (-n_star) % mesh.shape[DATA_AXIS]
    Xsp = (jnp.concatenate([Xstar, jnp.zeros((pad, Xstar.shape[1]),
                                             Xstar.dtype)]) if pad else Xstar)
    mu, var = fn(params, z, jnp.asarray(sigma2, X.dtype), X, y, mask, Xsp)
    from jax.sharding import NamedSharding

    mu = jax.device_put(mu, NamedSharding(mesh, P()))[:n_star]
    var = jax.device_put(var, NamedSharding(mesh, P()))[:n_star]
    return mu, var


def fit_sharded_2d(
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
    epilogue: str = "replicated",
    inducing: str = "replicated",
    factorization: str | None = None,
    init_state=None,
    state_callback=None,
):
    """Device-resident training over the 2-D (data x model) mesh: the
    chunked device L-BFGS (optim.lbfgs_device) with the tensor-parallel
    evidence as its objective — every line-search probe runs the
    model-sharded V/Gram GEMMs and their collectives on the mesh, with the
    optimizer state replicated.  This is the m-too-big-for-one-chip
    training mode; semantics (normalize / f_noise / chunking / resume /
    epilogue / inducing) match fit_sharded and sharded_log_evidence_2d.
    Returns (params, z, sigma2, LBFGSDeviceState).
    """
    from jax.sharding import NamedSharding

    from ..optim.lbfgs_device import fit_packed_objective

    scale = 1.0 / X.shape[0] if normalize else 1.0
    if f_noise is None:
        f_noise = 5e-7 if X.dtype == jnp.float32 else 0.0

    n_data = mesh.shape[DATA_AXIS]
    n = X.shape[0]
    pad = (-n) % n_data
    mask = jnp.ones((n,), X.dtype)
    if pad:
        X = jnp.concatenate([X, jnp.zeros((pad, X.shape[1]), X.dtype)])
        y = jnp.concatenate([y, jnp.zeros((pad,), y.dtype)])
        mask = jnp.concatenate([mask, jnp.zeros((pad,), mask.dtype)])
    Xp = jax.device_put(X, NamedSharding(mesh, P(DATA_AXIS, None)))
    yp = jax.device_put(y, NamedSharding(mesh, P(DATA_AXIS)))
    mask = jax.device_put(mask, NamedSharding(mesh, P(DATA_AXIS)))

    def _fg_of(x, X, y, mask):
        def f(x):
            params, z, sigma2 = pack.unpack(x)
            l = sharded_log_evidence_2d(
                family, mesh, params, z, sigma2, X, y, mask,
                variational=variational, block_size=block_size,
                epilogue=epilogue, inducing=inducing,
                factorization=factorization,
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

"""Hand-written VJP for the streaming FITC statistics.

``jax.checkpoint`` AD over the streaming scan (models/streaming.py) pays, per
tile, a full forward recompute *plus* generic reverse GEMMs: the Gram
cotangent contraction ``a (G-bar) + a (G-bar)'`` lowers to two n x m x m
GEMMs, and the body recompute includes the Gram product itself.  The
dominant cost of evidence + gradient is these n x m x m contractions, the
role the reference's hand-derived gradient code plays against LAPACK
(lib/fitc_gp.ml:585-756 — ``calc_log_evidence_sigma2`` etc. reuse the
factored model state instead of redifferentiating).

This module is the JAX analogue: a ``jax.custom_vjp`` whose backward scan

* symmetrizes the Gram cotangent ONCE outside the scan — the statistic is a
  sum over tiles, so every tile sees the same (m, m) cotangent, and
  ``a_bar = a (G-bar + G-bar')`` is a single GEMM per tile;
* recomputes Knm/V per tile (same memory policy as jax.checkpoint: nothing
  n-sized is ever stored) and hand-chains the scalar/diagonal cotangents;
* leaves the kernel evaluation generic: ``jax.vjp`` of
  ``family.k_cross``/``k_diag`` per tile gives the exact pullback for every
  kernel family at O(n m d) cost.

Per-tile flop count: 4 large GEMMs (V recompute, a_bar, Knm-bar, U^-1-bar)
vs ~6 for checkpointed AD — a ~1/3 reduction of the backward, exact to
roundoff (tests/test_stream_grad.py asserts equality with AD at 1e-12 in
f64).

Reference counterpart: the ``calc_log_evidence`` derivative machinery of
lib/fitc_gp.ml:585-960 (dense, per-hyper); here one reverse pass produces
all hyper gradients at once.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..config import config
from ..numerics.linalg import matmul, matmul_acc, rows_sqr_norm

_CACHE: dict = {}


def _acc_dtype():
    return jnp.float64 if jax.config.jax_enable_x64 else jnp.float32


def _two_sum(hi, lo, x):
    """Error-free accumulation (Knuth two-sum): (hi, lo) += x with the
    rounding error of the add captured in lo.  In f32 this keeps a length-T
    reduction accurate to ~1 ulp instead of ~sqrt(T) ulps — the f32
    substitute for the f64 accumulators the x64 path gets.  XLA does not
    reassociate floating-point adds, so the cancellation survives
    compilation (chip_smoke.py's compensated-sum phase checks this on the
    GPU)."""
    s = hi + x
    bp = s - hi
    err = (hi - (s - bp)) + (x - bp)
    return s, lo + err


def _forward_scan(family, params, z, u_inv, sigma2, xb, yb, maskb, unroll):
    """Plain forward statistics scan (same math as streaming.stream_stats's
    body; no remat wrapper — custom_vjp detaches AD so nothing is stored).

    When accumulators are f32 (x64 off) every carry is a compensated
    (hi, lo) pair, folded to a single float at the end: per-tile GEMM
    rounding is unavoidable, but the cross-tile accumulation noise that set
    the f32 evidence/gradient noise floor (NEXT.md round-1, at commit
    b587de6) is eliminated.
    """
    m = z.shape[0]
    acc = _acc_dtype()
    comp = acc == jnp.float32  # compensate exactly when f64 is unavailable

    def body(carry, blk):
        x_b, y_b, mask_b = blk
        # bf16 storage mode: X/y may be stored at half width; compute in the
        # model dtype (tiles upcast on the device, so HBM holds the narrow
        # copy)
        x_b = x_b.astype(z.dtype)
        y_b = y_b.astype(z.dtype)
        mask_b = mask_b.astype(z.dtype)
        knm = family.k_cross(params, x_b, z)
        kd = family.k_diag(params, x_b)
        v = matmul(knm, u_inv)
        r = kd - rows_sqr_norm(v)
        live = mask_b > 0
        s = jnp.where(live, r + sigma2, 1.0)
        is_ = mask_b / s
        sqrt_is = jnp.where(live, jnp.sqrt(jnp.where(live, is_, 1.0)), 0.0)
        a = v * sqrt_is[:, None]
        terms = (
            matmul_acc(a.T, a).astype(acc),
            matmul_acc(v.T, is_ * y_b).astype(acc),
            jnp.sum(mask_b * jnp.log(s)).astype(acc),
            jnp.sum(is_ * y_b * y_b).astype(acc),
            jnp.sum(is_ * r).astype(acc),
            jnp.sum(mask_b).astype(acc),
        )
        if comp:
            new = tuple(
                _two_sum(hi, lo, t) for (hi, lo), t in zip(carry, terms)
            )
        else:
            new = tuple((hi + t, lo) for (hi, lo), t in zip(carry, terms))
        return new, None

    shapes = [(m, m), (m,), (), (), (), ()]
    init = tuple(
        (jnp.zeros(sh, acc), jnp.zeros(sh, acc)) for sh in shapes
    )
    out, _ = jax.lax.scan(body, init, (xb, yb, maskb), unroll=unroll)
    # fold: one final rounding instead of sqrt(n_tiles) accumulated ones
    return tuple(hi + lo if comp else hi for hi, lo in out)


def make_stream_stats_cv(family, unroll: int = 1, bwd_precision=None,
                         bwd_variant: str = "base"):
    """custom_vjp'd (params, z, u_inv, sigma2, xb, yb, maskb) -> 6 stats.

    Cached per (family, unroll, bwd_precision); xb/yb/maskb are pre-blocked
    (nb, B, ...) arrays (see streaming._pad_blocks).  The y cotangent is
    EXACT in the scan backward variants (it rides the V u-bar product the
    is-cotangent already needs — the warped-GP path differentiates the
    evidence w.r.t. the targets); X/mask cotangents are structural zeros
    in every custom variant, and the "nok" variant zeroes the y
    cotangent too — use grad_impl="ad" to differentiate w.r.t. X, and a
    scan variant (default) for d/dy.

    ``bwd_precision`` (a jax.lax.Precision or None) applies to the backward
    contraction GEMMs only: a lower precision than the forward's trades
    gradient accuracy for GEMM throughput, which a noise-tolerant line
    search absorbs (the evidence VALUE keeps full precision either way).
    What each precision name runs as on the GPU is printed by
    chip_smoke.py's precision-map phase.  None inherits the global matmul
    precision.

    ``bwd_variant`` restructures the backward tile (same math, different
    schedules; an explicit argument only — probes pass it through
    stream_stats(grad_variant=), nothing env-sensitive):
      * "base"  — v = knm U^-1 then vg = v (G-bar+G-bar') (chained GEMMs)
      * "ug"    — vg = knm (U^-1 (G-bar+G-bar')): both GEMMs read knm, no
                  serial dependency
      * "stack" — one (B, m) x (m, 2m) GEMM against [U^-1 | U^-1 gsym]:
                  fewer, larger GEMM calls and one shared knm read
      * "nok"   — TIMING PROBE ONLY: skips the kernel pullback (returns
                  zero params/z cotangents) to attribute its cost share
    """
    key = (family, unroll, bwd_precision, bwd_variant)
    if key in _CACHE:
        return _CACHE[key]

    def bmm(a, b):
        return jnp.matmul(a, b, precision=bwd_precision) \
            if bwd_precision is not None else matmul(a, b)

    def site_mm(site, a, b):
        # per-site demotion to DEFAULT precision (config.bwd_demote_sites,
        # read at trace time; probes/r4_bwd_demote.py at commit b587de6
        # measured each site).
        # A typo'd site name would otherwise be a silent no-op and any
        # speed/accuracy delta attributed to it would be noise.
        unknown = set(config.bwd_demote_sites) - {"ui_bar", "vg", "knm_bar"}
        if unknown:
            raise ValueError(
                f"unknown bwd_demote_sites {sorted(unknown)}; valid: "
                f"['knm_bar', 'ui_bar', 'vg'] (and 'vg' only fires under "
                f"grad_variant='ug')"
            )
        if site in config.bwd_demote_sites:
            return jnp.matmul(a, b, precision=jax.lax.Precision.DEFAULT)
        return bmm(a, b)

    @jax.custom_vjp
    def core(params, z, u_inv, sigma2, xb, yb, maskb):
        return _forward_scan(
            family, params, z, u_inv, sigma2, xb, yb, maskb, unroll
        )

    def fwd(params, z, u_inv, sigma2, xb, yb, maskb):
        out = _forward_scan(
            family, params, z, u_inv, sigma2, xb, yb, maskb, unroll
        )
        return out, (params, z, u_inv, sigma2, xb, yb, maskb)

    def bwd(res, cot):
        params, z, u_inv, sigma2, xb, yb, maskb = res
        gbar, ubar, lds_bar, yiy_bar, isr_bar, _nbar = cot
        # compute dtype — NOT xb.dtype: in bf16 storage mode the data is
        # narrower than the model, and truncating the m x m Gram cotangent
        # to bf16 would poison every hyper gradient
        dt = z.dtype
        acc = _acc_dtype()
        # The statistics are sums over tiles: each tile sees the SAME
        # cotangents.  Symmetrize the Gram cotangent once, outside the scan.
        gsym = (gbar + gbar.T).astype(dt)
        ubar_c = ubar.astype(dt)
        lds_c = lds_bar.astype(dt)
        yiy_c = yiy_bar.astype(dt)
        isr_c = isr_bar.astype(dt)
        u_inv_t = u_inv.T
        # variant precomputes (m x m, once per backward — amortized over all
        # tiles): U^-1 gsym lets vg contract straight from knm
        ug = bmm(u_inv, gsym) if bwd_variant in ("ug", "stack") else None
        u_stack = (
            jnp.concatenate([u_inv, ug], axis=1)
            if bwd_variant == "stack" else None
        )

        def body(carry, blk):
            x_b, y_b, mask_b = blk
            x_b = x_b.astype(z.dtype)
            y_b = y_b.astype(z.dtype)
            mask_b = mask_b.astype(z.dtype)

            def kfun(p, zz):
                return family.k_cross(p, x_b, zz), family.k_diag(p, x_b)

            hand_pull = getattr(family, "k_cross_vjp", None)
            if bwd_variant == "nok":
                knm = family.k_cross(params, x_b, z)
                kd = family.k_diag(params, x_b)
                pull = lambda cots: (  # noqa: E731 - probe-only stub
                    jax.tree.map(jnp.zeros_like, params),
                    jnp.zeros_like(z),
                )
            elif hand_pull is not None:
                # family supplies the fused pullback (one elementwise pass +
                # one (m, d) GEMM); knm is shared with the V GEMM below
                knm = family.k_cross(params, x_b, z)
                kd = family.k_diag(params, x_b)
                pull = lambda cots: hand_pull(  # noqa: E731
                    params, x_b, z, knm, cots[0], cots[1]
                )
            else:
                (knm, kd), pull = jax.vjp(kfun, params, z)
            # gram = sum (V sqrt(is))' (V sqrt(is)): with vg = V (G-bar +
            # G-bar'), the whitened-row cotangent collapses to
            #   V-bar += is * vg          (the two sqrt(is) scalings fuse)
            #   is-bar += 1/2 rowdot(vg, V)   (sqrt chain cancels exactly)
            # so the backward needs no sqrt and no whitened tile at all.
            if bwd_variant == "stack":
                m = z.shape[0]
                vw = bmm(knm, u_stack)
                v, vg = vw[:, :m], vw[:, m:]
            elif bwd_variant == "ug":
                v = matmul(knm, u_inv)
                vg = site_mm("vg", knm, ug)
            else:
                v = matmul(knm, u_inv)
            r = kd - rows_sqr_norm(v)
            live = mask_b > 0
            s = jnp.where(live, r + sigma2, 1.0)
            is_ = mask_b / s

            if bwd_variant not in ("ug", "stack"):
                vg = bmm(v, gsym)
            # u_vec = sum V'(is y): V-bar += outer(is y, u-bar),
            #                       is-bar += y * (V u-bar)
            isy = is_ * y_b
            vu = matmul(v, ubar_c)
            vbar = is_[:, None] * vg + isy[:, None] * ubar_c[None, :]
            is_bar = (
                y_b * vu
                + 0.5 * jnp.sum(vg * v, axis=1)
                + yiy_c * y_b * y_b
                + isr_c * r
            )
            # y enters u_vec (V'(is y)) and yiy (y' is y) only — its
            # cotangent reuses vu; makes d/dy of the streaming evidence
            # exact through the custom VJP (the warped-GP training path)
            y_bar_t = is_ * vu + 2.0 * yiy_c * isy
            # is = mask/s; lds = sum mask log s; s = live ? r+sigma2 : 1
            s_bar = (lds_c * mask_b - is_bar * is_) / s
            s_bar_live = jnp.where(live, s_bar, 0.0)
            r_bar = s_bar_live + isr_c * is_
            # r = kd - rowsq(V)
            kd_bar = r_bar
            vbar = vbar - 2.0 * v * r_bar[:, None]

            knm_bar = site_mm("knm_bar", vbar, u_inv_t)
            p_bar_t, z_bar_t = pull((knm_bar, kd_bar))

            ui_bar_t = site_mm("ui_bar", knm.T, vbar)
            s2_bar_t = jnp.sum(s_bar_live)

            # flat accumulation: params leaves are flattened explicitly so
            # the (hi, lo) pairs are positional, never pattern-matched —
            # a structural is_leaf heuristic misfired on any params PyTree
            # containing a 2-tuple of dataclasses (2-term combinators, ICM)
            flat_g = jax.tree.leaves(p_bar_t) + [z_bar_t, ui_bar_t, s2_bar_t]
            if comp:
                # compensated gradient accumulation: cross-tile rounding is
                # what set the f32 |grad| noise floor (NEXT.md round-1,
                # at commit b587de6)
                new = [
                    _two_sum(h, l, g.astype(acc))
                    for (h, l), g in zip(carry, flat_g)
                ]
            else:
                new = [
                    (h + g.astype(acc), l)
                    for (h, l), g in zip(carry, flat_g)
                ]
            return new, y_bar_t.astype(yb.dtype)

        comp = acc == jnp.float32

        def zero_pair(p):
            sh = jnp.shape(p)
            return (jnp.zeros(sh, acc), jnp.zeros(sh, acc))

        p_leaves = jax.tree.leaves(params)
        init = [
            zero_pair(p)
            for p in p_leaves + [z, u_inv, jnp.zeros(())]
        ]
        out, y_bar = jax.lax.scan(body, init, (xb, yb, maskb), unroll=unroll)

        def fold(hl):
            return hl[0] + hl[1] if comp else hl[0]

        flat = [fold(hl) for hl in out]
        p_bar = jax.tree.unflatten(
            jax.tree.structure(params), flat[: len(p_leaves)]
        )
        z_bar, ui_bar, s2_bar = flat[len(p_leaves):]
        p_bar = jax.tree.map(
            lambda g, p: g.astype(jnp.asarray(p).dtype), p_bar, params
        )
        return (
            p_bar,
            z_bar.astype(z.dtype),
            ui_bar.astype(u_inv.dtype),
            s2_bar.astype(jnp.asarray(sigma2).dtype),
            jnp.zeros_like(xb),
            y_bar,
            jnp.zeros_like(maskb),
        )

    core.defvjp(fwd, bwd)
    _CACHE[key] = core
    return core

"""Device-resident L-BFGS: the whole optimization loop under one jit.

The host-driven driver (optim/lbfgs.py) mirrors the reference's GSL loop —
fine when each objective evaluation dwarfs a host round trip, but at
accelerator speeds (one 1M x 8, m=300 evidence+gradient is ~52 ms on an
H100 at matmul_precision='highest', chip_smoke.py) the Python loop becomes
a tax on every line-search probe.  This variant keeps x, the curvature history, and the strong-Wolfe
line search in lax control flow: ``minimize_lbfgs_device`` is a single
device program; ``fit`` composes it with the packed evidence objective so
"train a sparse GP to convergence" is ONE dispatch.

No reference counterpart (the reference cannot fuse its optimizer with its
objective); semantics follow optim/lbfgs.py: minimize, stop on
|g| < epsabs or max_iter, strong Wolfe (c1=1e-4, c2=tol).
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
from jax import lax


class LBFGSDeviceState(NamedTuple):
    x: jnp.ndarray  # (k,)
    f: jnp.ndarray  # scalar
    g: jnp.ndarray  # (k,)
    s_hist: jnp.ndarray  # (h, k)
    y_hist: jnp.ndarray  # (h, k)
    rho: jnp.ndarray  # (h,)  0 marks an empty slot
    head: jnp.ndarray  # int32, next write position
    n_iter: jnp.ndarray  # int32
    failed: jnp.ndarray  # bool — line search gave up
    # int32 objective (value+grad) evaluations so far — line-search
    # efficiency is n_evals / n_iter, the dominant cost driver of a run
    n_evals: jnp.ndarray


def _two_loop(g, s_hist, y_hist, rho, head, history):
    """Two-loop recursion over a circular buffer; empty slots (rho == 0)
    pass through untouched."""
    q = g

    def bwd(j, carry):
        q, alphas = carry
        idx = (head - 1 - j) % history
        valid = rho[idx] > 0.0
        a = jnp.where(valid, rho[idx] * jnp.dot(s_hist[idx], q), 0.0)
        q = q - a * y_hist[idx]
        return q, alphas.at[idx].set(a)

    q, alphas = lax.fori_loop(
        0, history, bwd, (q, jnp.zeros((history,), g.dtype))
    )

    # gamma scaling from the most recent pair
    last = (head - 1) % history
    have = rho[last] > 0.0
    yy = jnp.dot(y_hist[last], y_hist[last])
    sy = jnp.dot(s_hist[last], y_hist[last])
    gamma = jnp.where(have & (yy > 0), sy / jnp.maximum(yy, 1e-30), 1.0)
    q = q * gamma

    def fwd(j, q):
        idx = (head + j) % history
        valid = rho[idx] > 0.0
        b = jnp.where(valid, rho[idx] * jnp.dot(y_hist[idx], q), 0.0)
        return q + jnp.where(valid, (alphas[idx] - b), 0.0) * s_hist[idx]

    q = lax.fori_loop(0, history, fwd, q)
    return -q


def _wolfe_zoom(fg, x, f0, g0, p, alpha0, c1, c2, max_evals, f_noise=0.0):
    """Strong-Wolfe line search in lax control flow.

    Phase 1 brackets by doubling; phase 2 zooms with a secant step on the
    line derivative (bisection safeguard) — interpolation reaches the
    strong-Wolfe window in far fewer evaluations than the pure bisection
    it replaced (which burned 19-29 objective evals/iter at the f32 bench
    config).  Acceptance is sufficient decrease (with ``f_noise`` slack —
    the Hager-Zhang approximate-Wolfe idea for objectives whose rounding
    jitter exceeds the true decrease near a solution) plus strong Wolfe
    |dphi(a)| <= -c2·dphi(0); looser curvature windows were measured to
    send the hyper trajectory into degenerate f32-conditioning basins
    (see inline note).  Returns (alpha, f, g, ok, n_evals); NaN objective
    values are treated as Armijo failures (step too long).
    """
    dphi0 = jnp.dot(g0, p)

    def phi(a):
        f, g = fg(x + a * p)
        return f, g, jnp.dot(g, p)

    # stage 0 = bracketing (doubling), 1 = zooming (secant/bisect).
    # Zoom invariant: a_lo passed Armijo with dphi_lo < c2*dphi0 (still
    # descending), a_hi failed Armijo or overshot — so the minimum stays
    # bracketed and the bracket never flips.
    def cond(c):
        return (~c["done"]) & (c["evals"] < max_evals)

    def body(c):
        a = c["a"]
        f_a, g_a, dphi_a = phi(a)
        bad = ~jnp.isfinite(f_a)
        armijo_fail = bad | (f_a > f0 + c1 * a * dphi0 + f_noise) | (
            (c["evals"] > 0) & (f_a >= c["phi_lo"] + f_noise)
            & (c["stage"] == 0)
        )
        # strong-Wolfe curvature window |dphi(a)| <= -c2 dphi(0), written
        # two-sided so the transitions fall out: below the window the step
        # is still descending (advance a_lo), above it the step lunged
        # past the line minimum (shrink a_hi).  Looser upper bounds were
        # measured (weak Wolfe, then <= -dphi0) to accept overshooting
        # steps that walk the trajectory into degenerate-hyper basins
        # whose f32 gradients are pure conditioning noise (|g| ~ 130 at
        # mean scale, never escaped) — near-exact line minima are what
        # keep sparse-GP hyper optimization on the well-conditioned path.
        curv_ok = (dphi_a >= c2 * dphi0) & (dphi_a <= -c2 * dphi0)
        overshoot = (~armijo_fail) & (dphi_a > -c2 * dphi0)
        accept = (~armijo_fail) & curv_ok

        bracketing = c["stage"] == 0
        zooming = c["stage"] == 1

        # bracketing: Armijo fail / overshoot -> zoom into [a_lo, a]; else
        # (still too steep) advance the low end and double
        too_far = armijo_fail | overshoot
        to_zoom = bracketing & too_far
        advance = (~too_far) & (~accept)  # both stages: a_lo <- a
        shrink = zooming & too_far  # a_hi <- a

        new_stage = jnp.where(to_zoom, 1, c["stage"])
        new_a_lo = jnp.where(advance, a, c["a_lo"])
        new_phi_lo = jnp.where(advance, f_a, c["phi_lo"])
        new_dphi_lo = jnp.where(advance, dphi_a, c["dphi_lo"])
        new_a_hi = jnp.where(to_zoom | shrink, a, c["a_hi"])
        new_dphi_hi = jnp.where(to_zoom | shrink, dphi_a, c["dphi_hi"])

        # next trial: double while bracketing; in the zoom, secant for the
        # root of dphi between (a_lo, dphi_lo) and (a_hi, dphi_hi),
        # safeguarded into the bracket interior (bisection fallback when
        # the secant is ill-posed — equal slopes, NaN endpoint slopes)
        w = new_a_hi - new_a_lo
        denom = new_dphi_hi - new_dphi_lo
        secant = new_a_lo - new_dphi_lo * w / denom
        mid = new_a_lo + 0.5 * w
        use_secant = (
            jnp.isfinite(secant)
            & (secant >= new_a_lo + 0.1 * w)
            & (secant <= new_a_hi - 0.1 * w)
        )
        next_a = jnp.where(
            new_stage == 0, 2.0 * a, jnp.where(use_secant, secant, mid)
        )

        # no zoom budget short of max_evals: in f32 trouble regions the
        # shrink ladder must reach the machine-floor step
        # (f(x + a p) == f(x)) whose sufficient-decrease fallback keeps
        # the outer loop alive through gradient-noise cliffs; budgets of
        # 8 and 20 were both measured to convert a recoverable rough
        # patch into a terminal line-search failure, while the common
        # case accepts in 1-3 evals regardless.
        done = accept
        return {
            "stage": new_stage,
            "a_lo": new_a_lo,
            "phi_lo": new_phi_lo,
            "dphi_lo": new_dphi_lo,
            "a_hi": new_a_hi,
            "dphi_hi": new_dphi_hi,
            "a": jnp.where(done, a, next_a),
            "f_a": f_a,
            "g_a": g_a,
            "dphi_a": dphi_a,
            "evals": c["evals"] + 1,
            "done": done,
            "ok": accept,
            "best_a": jnp.where(accept | (f_a < c["best_f"]), a, c["best_a"]),
            "best_f": jnp.minimum(
                c["best_f"], jnp.where(bad, jnp.inf, f_a)
            ),
        }

    dt = x.dtype
    init = {
        "stage": jnp.asarray(0, jnp.int32),
        "a_lo": jnp.asarray(0.0, dt),
        "phi_lo": f0,
        "dphi_lo": dphi0,
        "a_hi": jnp.asarray(0.0, dt),
        "dphi_hi": jnp.asarray(0.0, dt),
        "a": jnp.asarray(alpha0, dt),
        "f_a": f0,
        "g_a": g0,
        "dphi_a": dphi0,
        "evals": jnp.asarray(0, jnp.int32),
        "done": jnp.asarray(False),
        "ok": jnp.asarray(False),
        "best_a": jnp.asarray(alpha0, dt),
        "best_f": jnp.asarray(jnp.inf, dt),
    }
    out = lax.while_loop(cond, body, init)

    # If the loop stopped without Wolfe acceptance (evals exhausted), fall
    # back to the best finite point seen (sufficient-decrease-only), else
    # fail.
    fallback_ok = (out["best_f"] < f0 + f_noise) & jnp.isfinite(out["best_f"])
    a_final = jnp.where(out["ok"], out["a"], out["best_a"])
    use = out["ok"] | fallback_ok
    # On acceptance the carry already holds (f, g) AT the accepted step —
    # lax.cond skips the re-evaluation (one objective eval saved per outer
    # iteration); the fallback path must evaluate at best_a.
    f_f, g_f = lax.cond(
        out["ok"],
        lambda: (out["f_a"], out["g_a"]),
        lambda: phi(a_final)[:2],
    )
    n_evals = out["evals"] + jnp.where(out["ok"], 0, 1)
    return a_final, f_f, g_f, use, n_evals


@functools.partial(
    jax.jit,
    static_argnames=(
        "fg", "history", "max_iter", "max_ls_evals", "f_noise",
        "dispatch_iters",
    ),
)
def minimize_lbfgs_device(
    fg: Callable[[jnp.ndarray], tuple[jnp.ndarray, jnp.ndarray]],
    x0: jnp.ndarray,
    *,
    step: float = 0.1,
    tol: float = 0.1,
    epsabs: float = 0.1,
    max_iter: int = 100,
    history: int = 10,
    max_ls_evals: int = 30,
    f_noise: float = 0.0,
    init_state: LBFGSDeviceState | None = None,
    dispatch_iters: int | None = None,
) -> LBFGSDeviceState:
    """Minimize fg entirely on device.  fg must be a traced-compatible
    function returning (f, g).

    Set ``f_noise`` to the objective's evaluation-noise amplitude (e.g.
    ``4 * 6e-8 * |f|`` for an f32 objective) to keep line searches alive at
    the noise floor (approximate Wolfe).

    ``init_state`` resumes a previous run (x, gradients, AND curvature
    history); ``dispatch_iters`` caps the iterations of THIS dispatch —
    chunking keeps any one execution short and lets the host check for
    stalls between chunks (fit() does this automatically); the
    cumulative n_iter / max_iter bookkeeping still applies.  Per-iteration
    stopping stays strictly GSL-like; noise-floor stall detection lives in
    fit()'s chunk loop, where net progress over ~dispatch_iters iterations
    is a robust signal (a per-iteration counter proved too eager: L-BFGS
    plateaus for a few iterations while rebuilding history, then
    accelerates — measured on the bench trajectory)."""
    if init_state is None:
        init = _fresh_state(x0, *fg(x0), history)
    else:
        init = init_state
    start = init.n_iter

    def cond(st: LBFGSDeviceState):
        go = (
            (jnp.linalg.norm(st.g) >= epsabs)
            & (st.n_iter < max_iter)
            & (~st.failed)
            & jnp.isfinite(st.f)
        )  # outer stopping rule mirrors the GSL loop (fitc_gp.ml:1657-1671)
        if dispatch_iters is not None:
            go = go & (st.n_iter - start < dispatch_iters)
        return go

    def body(st: LBFGSDeviceState):
        p = _two_loop(st.g, st.s_hist, st.y_hist, st.rho, st.head, history)
        # safeguard: if not a descent direction, restart with steepest descent
        descent = jnp.dot(p, st.g) < 0
        p = jnp.where(descent, p, -st.g)

        gnorm = jnp.linalg.norm(st.g)
        first = st.rho[(st.head - 1) % history] == 0.0
        alpha0 = jnp.where(
            first, jnp.minimum(1.0, step / jnp.maximum(gnorm, 1e-30)), 1.0
        )
        a, f_new, g_new, ok, ls_evals = _wolfe_zoom(
            fg, st.x, st.f, st.g, p, alpha0, 1e-4, tol, max_ls_evals, f_noise
        )

        s = a * p
        yv = g_new - st.g
        sy = jnp.dot(s, yv)
        good_pair = ok & (
            sy > 1e-12 * jnp.linalg.norm(s) * jnp.linalg.norm(yv)
        )
        h = st.head % history
        s_hist = jnp.where(good_pair, st.s_hist.at[h].set(s), st.s_hist)
        y_hist = jnp.where(good_pair, st.y_hist.at[h].set(yv), st.y_hist)
        rho = jnp.where(
            good_pair, st.rho.at[h].set(1.0 / jnp.maximum(sy, 1e-30)), st.rho
        )
        head = jnp.where(good_pair, (st.head + 1) % history, st.head)

        # Line-search failure along a quasi-Newton direction: drop the
        # curvature history and retry from steepest descent (the host driver
        # does the same, optim/lbfgs.py); only a failure WITH empty history
        # is terminal.
        have_hist = jnp.any(st.rho > 0.0)
        clear = (~ok) & have_hist
        s_hist = jnp.where(clear, jnp.zeros_like(s_hist), s_hist)
        y_hist = jnp.where(clear, jnp.zeros_like(y_hist), y_hist)
        rho = jnp.where(clear, jnp.zeros_like(rho), rho)
        head = jnp.where(clear, 0, head)

        return LBFGSDeviceState(
            x=jnp.where(ok, st.x + s, st.x),
            f=jnp.where(ok, f_new, st.f),
            g=jnp.where(ok, g_new, st.g),
            s_hist=s_hist,
            y_hist=y_hist,
            rho=rho,
            head=head,
            n_iter=st.n_iter + 1,
            failed=(~ok) & (~have_hist),
            n_evals=st.n_evals + ls_evals,
        )

    return lax.while_loop(cond, body, init)


def fit(
    family,
    X,
    y,
    pack,
    *,
    variational: bool = False,
    step: float = 0.1,
    tol: float = 0.1,
    epsabs: float = 0.1,
    max_iter: int = 100,
    history: int = 10,
    normalize: bool = True,
    streaming_block_size: int | None = None,
    f_noise: float | None = None,
    dispatch_iters: int = 50,
    log_prior=None,
    objective: str = "evidence",
    init_state: "LBFGSDeviceState | None" = None,
    state_callback=None,
):
    """Train a sparse GP on device, in chunks of ``dispatch_iters``
    iterations per dispatch.

    Composes the packed negative-evidence objective with the device L-BFGS;
    returns (params, z, sigma2, LBFGSDeviceState).  Use optim.train for the
    callback/interrupt-rich host loop; use this for production throughput.

    ``normalize`` (default on) optimizes the mean NLL — mandatory for f32
    training at large n, where the total evidence overwhelms line-search
    resolution; ``epsabs`` then applies to mean-scale gradient norms.
    ``streaming_block_size`` switches the objective to the streaming
    evidence (models/streaming.py) for large n.  ``f_noise`` defaults to a
    few f32 ulps of a unit-scale objective when the data is f32 (None ->
    auto), 0 for f64.  ``dispatch_iters`` bounds one dispatch's work, so
    no single execution runs for minutes and the stall check below gets
    its chance; chunking costs only one scalar round trip per chunk — the
    full curvature history carries across chunks unchanged.

    ``log_prior(params, z, sigma2) -> scalar`` turns the objective into MAP
    estimation (same contract as optim.train; build with optim.priors).
    Strongly recommended for large-n f32 training: the unregularized
    landscape has a pure-noise basin (lengthscale -> infinity, kernel
    constant) whose f32 gradients are conditioning noise, and trajectories
    measurably fall into it from generic inits — a mild normal() prior on
    the lengthscale keeps the optimizer in the well-conditioned region.

    ``init_state`` resumes a previous run's FULL optimizer state
    (io.resume.load_device_checkpoint); ``max_iter`` then counts TOTAL
    iterations including the original run's.  ``state_callback(st)`` fires
    after every dispatched chunk — persist with
    io.resume.save_device_checkpoint for crash-safe training.
    """
    scale = 1.0 / X.shape[0] if normalize else 1.0
    if f_noise is None:
        f_noise = 5e-7 if X.dtype == jnp.float32 else 0.0
    _fg_of = _make_fg(family, pack, variational, streaming_block_size,
                      scale, log_prior, objective)
    st = fit_packed_objective(
        _fg_of, pack, (X, y), step=step, tol=tol, epsabs=epsabs,
        max_iter=max_iter, history=history, f_noise=f_noise,
        dispatch_iters=dispatch_iters, init_state=init_state,
        state_callback=state_callback,
    )
    params, z, sigma2 = pack.unpack(st.x)
    return params, z, sigma2, st


def fit_packed_objective(
    fg_of,
    pack,
    data,
    *,
    step: float = 0.1,
    tol: float = 0.1,
    epsabs: float = 0.1,
    max_iter: int = 100,
    history: int = 10,
    f_noise: float = 0.0,
    dispatch_iters: int = 50,
    init_state: "LBFGSDeviceState | None" = None,
    state_callback=None,
) -> LBFGSDeviceState:
    """Drive the chunked device L-BFGS over an arbitrary packed objective.

    ``fg_of(x, *data) -> (f, grad)`` is the (already scaled) objective;
    ``data`` threads through as jit arguments so device placement and
    shardings are preserved (closure capture would embed the arrays as
    compiled-in constants).  This is the engine under fit / fit_sharded /
    fit_sharded_2d; use it directly to train against a custom distributed
    objective.  Returns the final LBFGSDeviceState.
    """

    @jax.jit
    def _init(x0, *data):
        return fg_of(x0, *data)

    @jax.jit
    def _chunk(st, *data):
        return minimize_lbfgs_device(
            lambda x: fg_of(x, *data), st.x, step=step, tol=tol,
            epsabs=epsabs, max_iter=max_iter, history=history,
            f_noise=f_noise, init_state=st, dispatch_iters=dispatch_iters,
        )

    if init_state is not None:
        if int(init_state.s_hist.shape[0]) != history:
            raise ValueError(
                f"history={history} does not match the checkpointed "
                f"curvature buffers ({int(init_state.s_hist.shape[0])})"
            )
        st = init_state._replace(failed=jnp.asarray(False))
    else:
        st = _fresh_state(pack.x0, *_init(pack.x0, *data), history)
    return _chunk_loop(
        lambda s, _x, _y: _chunk(s, *data), st, None, None,
        max_iter, epsabs, f_noise, state_callback=state_callback,
    )


def _make_fg(family, pack, variational, streaming_block_size, scale,
             log_prior, objective="evidence"):
    """(x, X, y) -> (f, grad) of the packed scaled negative objective (+
    optional prior) — the one objective builder shared by fit and
    fit_restarts.  ``objective``: "evidence" (default) or "loo" (the
    closed-form LOO pseudo-likelihood, models/loo.py — needs the
    materialized Knm, so no streaming; variational does not apply)."""
    from ..models.fitc import calc_model, calc_trained
    from ..models.loo import loo_objective
    from ..models.streaming import streaming_log_evidence

    if objective not in ("evidence", "loo"):
        raise ValueError(f"unknown objective {objective!r}")
    if objective == "loo" and streaming_block_size is not None:
        raise ValueError(
            "objective='loo' needs the materialized n x m cross-covariance "
            "(models/loo.py); drop streaming_block_size"
        )

    def _fg_of(x, X, y):
        def f(x):
            params, z, sigma2 = pack.unpack(x)
            if objective == "loo":
                l = loo_objective(family, params, z, sigma2, X, y,
                                  factorization="chol")
            elif streaming_block_size is not None:
                l = streaming_log_evidence(
                    family, params, z, sigma2, X, y,
                    variational=variational,
                    block_size=streaming_block_size,
                )
            else:
                model = calc_model(
                    family, params, X, z, sigma2,
                    variational=variational, factorization="chol",
                )
                l = calc_trained(model, y).l
            if log_prior is not None:
                l = l + log_prior(params, z, sigma2)
            return -l * scale

        return jax.value_and_grad(f)(x)

    return _fg_of


def _fresh_state(x0, f0, g0, history):
    dt = x0.dtype
    k = x0.shape[0]
    return LBFGSDeviceState(
        x=x0, f=f0, g=g0,
        s_hist=jnp.zeros((history, k), dt),
        y_hist=jnp.zeros((history, k), dt),
        rho=jnp.zeros((history,), dt),
        head=jnp.asarray(0, jnp.int32),
        n_iter=jnp.asarray(0, jnp.int32),
        failed=jnp.asarray(False),
        n_evals=jnp.asarray(1, jnp.int32),
    )


def _chunk_loop(chunk, st, X, y, max_iter, epsabs, f_noise,
                state_callback=None):
    """Drive chunked dispatches with noise-floor stall detection: in f32 at
    degenerate-Km hyper regions the gradient is conditioning noise
    (|g| ~ eps cond(Km)) while f is flat — net chunk progress below a few
    noise amplitudes means further grinding cannot help (measured: such a
    run burns max_ls_evals objective calls per iteration to the max_iter
    ceiling).  Chunk-level detection is robust where a per-iteration
    counter is not: L-BFGS legitimately plateaus for a few iterations
    while rebuilding history, then accelerates."""
    f_prev = float(st.f)
    while True:
        st = chunk(st, X, y)
        if state_callback is not None:
            state_callback(st)
        if (
            int(st.n_iter) >= max_iter
            or bool(st.failed)
            or not bool(jnp.isfinite(st.f))
            or float(jnp.linalg.norm(st.g)) < epsabs
        ):
            break
        f_now = float(st.f)
        if f_prev - f_now <= 10.0 * f_noise:
            break  # noise-floor stall: no chunk-level progress
        f_prev = f_now
    return st


class ProbeReport(list):
    """Probe objectives (a plain list, for compatibility) plus per-phase
    line-search counters so the probe-vs-continuation cost split is visible
    (VERDICT.md round-2 #5 at commit b587de6): ``probe_evals``/``probe_iters`` sum over ALL
    starts, ``cont_evals``/``cont_iters`` cover the continuation alone —
    evals/iter per phase is the line-search efficiency figure."""

    def __init__(self, *a):
        super().__init__(*a)
        self.probe_evals = 0
        self.probe_iters = 0
        self.cont_evals = 0
        self.cont_iters = 0
        self.rescored_f64 = None  # set when fit_restarts(rescore_f64=...)


def fit_restarts(
    family,
    X,
    y,
    pack,
    x0s,
    *,
    probe_iters: int = 15,
    variational: bool = False,
    step: float = 0.1,
    tol: float = 0.1,
    epsabs: float = 0.1,
    max_iter: int = 100,
    history: int = 10,
    normalize: bool = True,
    streaming_block_size: int | None = None,
    f_noise: float | None = None,
    dispatch_iters: int = 50,
    log_prior=None,
    objective: str = "evidence",
    probe_subsample: int | None = None,
    probe_seed: int = 0,
    rescore_f64: int | None = None,
):
    """Multi-start device training: a short L-BFGS probe (``probe_iters``
    iterations) from each packed start in ``x0s``, then the best probe
    (lowest objective) continues to ``max_iter`` total iterations with its
    curvature history intact.

    This is the classical remedy for the measured init sensitivity of
    large-n f32 training: from a too-broad lengthscale the single-start
    trajectory lands in the pure-noise basin (kernel ~ constant, gradients
    = f32 conditioning noise) and never escapes — while a probe started
    near the right scale descends cleanly at ~3 objective evals/iteration.
    Probes share one compiled program, so S starts cost S short runs plus
    two compilations (probe + continuation), not S + 1.

    ``x0s``: iterable of packed vectors (build variants of ``pack.x0`` by
    packing different Params, e.g. a log-lengthscale ladder).  Returns
    (params, z, sigma2, final_state, probe_objectives).

    ``probe_subsample``: run the probes on a random row subsample of this
    size (seeded by ``probe_seed``) instead of the full data — with
    ``normalize`` on, the subsample mean-NLL estimates the full objective,
    so basin ranking transfers while each probe iteration costs n_sub/n of
    a full one.  The winner restarts on the full data from its probed x
    with FRESH curvature history (pairs measured against the subsample
    objective do not carry); ``max_iter`` then bounds the full-data
    iterations alone, and the returned probe objectives are subsample
    mean-NLLs.

    ``rescore_f64``: re-rank the finished probes by the f64 HOST objective
    on a shared row subsample of this size (optim.polish.evaluate_f64)
    instead of their raw device objectives.  The f32 device value can be
    INFLATED past its mathematical bounds in degenerate basins (quad-form
    cancellation; measured in f32, a broad-ell probe at the 1M bench shape
    read mean-NLL -1.55 where its synthetic's perfect-fit floor is +0.215)
    — raw-f32 selection then picks a fictitious winner.  Costs one child
    process + len(x0s) host evaluations; requires objective="evidence" and
    log_prior=None (the child evaluates the plain library objective).  The
    rescored values are returned in ``probe_report.rescored_f64``.
    """
    import math

    scale = 1.0 / X.shape[0] if normalize else 1.0
    if f_noise is None:
        f_noise = 5e-7 if X.dtype == jnp.float32 else 0.0
    _fg_of = _make_fg(family, pack, variational, streaming_block_size,
                      scale, log_prior, objective)

    subsampled = (
        probe_subsample is not None and probe_subsample < X.shape[0]
    )
    if subsampled:
        import numpy as _np

        idx = jnp.asarray(_np.random.default_rng(probe_seed).choice(
            X.shape[0], probe_subsample, replace=False))
        Xp_, yp_ = X[idx], y[idx]
        _fg_probe = _make_fg(
            family, pack, variational,
            None if streaming_block_size is None
            else min(streaming_block_size, probe_subsample),
            1.0 / probe_subsample if normalize else 1.0, log_prior,
            objective,
        )
    else:
        Xp_, yp_ = X, y
        _fg_probe = _fg_of

    @jax.jit
    def _init(x0, X, y):
        return _fg_of(x0, X, y)

    @jax.jit
    def _init_probe(x0, X, y):
        return _fg_probe(x0, X, y)

    @jax.jit
    def _probe_chunk(st, X, y):
        return minimize_lbfgs_device(
            lambda x: _fg_probe(x, X, y), st.x, step=step, tol=tol,
            epsabs=epsabs, max_iter=probe_iters, history=history,
            f_noise=f_noise, init_state=st,
            dispatch_iters=min(dispatch_iters, probe_iters),
        )

    @jax.jit
    def _chunk(st, X, y):
        return minimize_lbfgs_device(
            lambda x: _fg_of(x, X, y), st.x, step=step, tol=tol,
            epsabs=epsabs, max_iter=max_iter, history=history,
            f_noise=f_noise, init_state=st, dispatch_iters=dispatch_iters,
        )

    def _rank(st):
        # healthy (finite, line search alive) probes before failed ones
        # before diverged ones; NaN objectives must never win a "<" against
        # a finite probe, so the class is compared first
        f = float(st.f)
        bad = 2 if not math.isfinite(f) else (1 if bool(st.failed) else 0)
        return (bad, f if math.isfinite(f) else math.inf)

    if rescore_f64 is not None and (objective != "evidence"
                                    or log_prior is not None):
        raise ValueError(
            "rescore_f64 requires objective='evidence' and log_prior=None "
            "(the f64 child evaluates the plain library objective)"
        )

    states = []
    probe_fs = ProbeReport()
    for x0 in x0s:
        x0 = jnp.asarray(x0, pack.x0.dtype)
        st = _fresh_state(x0, *_init_probe(x0, Xp_, yp_), history)
        st = _chunk_loop(_probe_chunk, st, Xp_, yp_, probe_iters, epsabs,
                         f_noise)
        probe_fs.append(float(st.f))
        probe_fs.probe_evals += int(st.n_evals)
        probe_fs.probe_iters += int(st.n_iter)
        states.append(st)
    if not states:
        raise ValueError("x0s is empty")

    if rescore_f64 is not None:
        from .polish import evaluate_f64

        f64s = evaluate_f64(
            family, X, y, pack, [st.x for st in states],
            variational=variational, subsample=rescore_f64,
            seed=probe_seed, block_size=streaming_block_size,
            normalize=normalize,
        )
        probe_fs.rescored_f64 = list(f64s)

        def _rank_rescored(pair):
            st, f64 = pair
            bad = 2 if not math.isfinite(f64) else (1 if bool(st.failed)
                                                    else 0)
            return (bad, f64 if math.isfinite(f64) else math.inf)

        if all(not math.isfinite(f) for f in f64s):
            # every rescore failed (a config the f64 child cannot evaluate,
            # or all candidates genuinely dead): ranking by f64 would pick
            # states[0] arbitrarily — fall back to the raw-f32 ranking and
            # say so (ADVICE.md r4 at commit b587de6)
            import warnings

            warnings.warn(
                "rescore_f64: all candidates evaluated non-finite in f64; "
                "falling back to raw-f32 probe ranking",
                stacklevel=2,
            )
            best = min(states, key=_rank)
        else:
            best = min(zip(states, f64s), key=_rank_rescored)[0]
    else:
        best = min(states, key=_rank)
    if subsampled:
        # the subsample objective's curvature pairs and (f, g) do not carry
        # to the full objective: restart from the probed x
        best = _fresh_state(best.x, *_init(best.x, X, y), history)
    else:
        # a cleared failed flag lets a probe that ended in a line-search
        # failure retry from steepest descent in the continuation (same
        # reset resume_minimize applies)
        best = best._replace(failed=jnp.asarray(False))
    evals0, iters0 = int(best.n_evals), int(best.n_iter)
    st = _chunk_loop(_chunk, best, X, y, max_iter, epsabs, f_noise)
    probe_fs.cont_evals = int(st.n_evals) - evals0
    probe_fs.cont_iters = int(st.n_iter) - iters0
    params, z, sigma2 = pack.unpack(st.x)
    return params, z, sigma2, st, probe_fs

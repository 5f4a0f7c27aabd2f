"""Fully Bayesian hyperparameters: HMC over the (sparse-GP) evidence.

The reference is pure maximum likelihood — GSL BFGS2 finds one hyper point
(lib/fitc_gp.ml:1532-1671) and every prediction conditions on it.  This
module samples the hyper POSTERIOR instead: p(theta | X, y) ~ exp(L(theta))
p(theta), with L the same log evidence the optimizers use and p(theta) any
``optim.priors`` log density.  Predictions then mix over the samples
(:func:`predict_hmc_mixture`), which widens intervals exactly where the
evidence surface is flat — the bench synthetic's noise-model/broad-kernel
band (MANUAL section 7) is the textbook case for it.

Design:

- One transition = ``n_leapfrog`` evidence gradients; the whole sampler
  (three warmup/sampling scans, leapfrog inner scan, dual-averaging state)
  is a single jitted graph — no host round-trips between steps.
- Chains are VMAPPED: ``n_chains`` independent trajectories batch their
  (n, m) Gram GEMMs together, so chains are nearly free until
  memory binds.  Cross-chain split R-hat comes out of the same run.
- The potential is any ``x -> (U, dU)`` pair, so :func:`make_objective`
  output plugs in directly — dense, streaming (``block_size=``, unbounded
  n), or sharded objectives all work unchanged.

Adaptation follows Hoffman & Gelman (2014) dual averaging toward a target
acceptance rate, with a Stan-style regularized diagonal mass estimated from
first-phase warmup draws.  Nonfinite proposals are rejected (divergence
guard), never propagated.

f32 caution (measured, probes/r5_hmc_accept.py at commit b587de6): the MH accept step
compares total-evidence values, and at |L| >~ 1e5 the f32-HIGH GEMM
rounding roughness (~nats as x moves) dominates Delta-H — the accept rate
pins near 0.5 whatever the step size and dual averaging adapts to noise.
The fix is NOT smaller n or more warmup: pass ``energy_fn`` (see
:func:`make_accept_energy`) so the accept statistic alone is evaluated at
matmul HIGHEST while leapfrog forces stay at the session precision —
leapfrog is reversible and volume-preserving for any force field, so the
chain remains exactly invariant for the accurate potential.  Unlike
optimization there is no ``normalize=`` escape (scaling U tempers the
posterior).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Callable

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax


@dataclasses.dataclass(frozen=True)
class HMCResult:
    """Posterior draws plus the diagnostics needed to trust them."""

    samples: jnp.ndarray  # (n_chains, n_samples, d) post-warmup draws
    potential: jnp.ndarray  # (n_chains, n_samples) U = -log posterior
    accept_rate: jnp.ndarray  # (n_chains,) mean MH accept prob, sampling phase
    step_size: jnp.ndarray  # (n_chains,) adapted leapfrog step
    inv_mass: jnp.ndarray  # (n_chains, d) adapted diagonal inverse mass
    rhat: np.ndarray  # (d,) split-chain R-hat
    ess: np.ndarray  # (d,) bulk effective sample size

    @property
    def flat(self) -> jnp.ndarray:
        """All chains pooled: (n_chains * n_samples, d)."""
        return self.samples.reshape(-1, self.samples.shape[-1])


def _leapfrog(u_and_grad, x, p, grad, eps, inv_mass, n_steps):
    """n_steps of leapfrog; returns (x', p', U', dU')."""

    def body(carry, _):
        x, p, grad = carry
        p_half = p - 0.5 * eps * grad
        x_new = x + eps * inv_mass * p_half
        u_new, grad_new = u_and_grad(x_new)
        p_new = p_half - 0.5 * eps * grad_new
        return (x_new, p_new, grad_new), u_new

    (x, p, grad), us = lax.scan(body, (x, p, grad), None, length=n_steps)
    return x, p, us[-1], grad


def _transition(u_and_grad, state, key, log_eps, inv_mass, n_leapfrog,
                energy_fn=None):
    """One HMC proposal + MH accept.  state = (x, U, dU).

    Returns (state', accept_prob).  Nonfinite proposal energies get accept
    probability 0 (divergence guard) and the where-gated state update never
    touches them.

    ``energy_fn`` (x -> U), when given, re-evaluates the PROPOSAL's
    potential for the MH accept (and the carried state U is maintained at
    that precision).  Leapfrog is volume-preserving and reversible for ANY
    force field, so accepting with the accurate potential keeps the chain
    exactly invariant — this is the surrogate-gradient HMC construction
    that fixes the f32 accept-noise plateau (probes/r5_hmc_accept.py at commit
    b587de6: at
    matmul HIGH the accept rate pins near 0.5 regardless of step size
    because GEMM rounding roughness ~nats dominates Delta-H; forces can
    stay at HIGH since they only shape the proposal).
    """
    x, u, grad = state
    key_mom, key_acc = jax.random.split(key)
    eps = jnp.exp(log_eps)
    # Momentum ~ N(0, M) with M = 1/inv_mass: kinetic = 0.5 p' inv_mass p.
    p = jax.random.normal(key_mom, x.shape, x.dtype) / jnp.sqrt(inv_mass)
    h0 = u + 0.5 * jnp.sum(inv_mass * p * p)
    x_new, p_new, u_new, grad_new = _leapfrog(
        u_and_grad, x, p, grad, eps, inv_mass, n_leapfrog
    )
    if energy_fn is not None:
        u_new = energy_fn(x_new)
    h1 = u_new + 0.5 * jnp.sum(inv_mass * p_new * p_new)
    # Gate on the full energy DIFFERENCE: h0 nonfinite (a poisoned state
    # that slipped past the init guard) must yield alpha=0, not NaN, or the
    # dual-averaging state is NaN for the rest of the run.
    log_alpha = jnp.where(
        jnp.isfinite(h0 - h1), jnp.minimum(0.0, h0 - h1), -jnp.inf
    )
    alpha = jnp.exp(log_alpha)
    accept = jnp.log(jax.random.uniform(key_acc, (), x.dtype)) < log_alpha
    new_state = (
        jnp.where(accept, x_new, x),
        jnp.where(accept, u_new, u),
        jnp.where(accept, grad_new, grad),
    )
    return new_state, alpha


def _dual_avg_init(log_eps0):
    # (t, h_bar, log_eps, log_eps_bar, mu)
    return (
        jnp.asarray(0.0),
        jnp.asarray(0.0),
        log_eps0,
        jnp.asarray(0.0),
        log_eps0 + jnp.log(10.0),
    )


def _dual_avg_update(da, alpha, target):
    """Hoffman & Gelman (2014) eq. 6 constants."""
    t, h_bar, _, log_eps_bar, mu = da
    gamma, t0, kappa = 0.05, 10.0, 0.75
    t = t + 1.0
    h_bar = (1.0 - 1.0 / (t + t0)) * h_bar + (target - alpha) / (t + t0)
    log_eps = mu - jnp.sqrt(t) / gamma * h_bar
    w = t ** (-kappa)
    log_eps_bar = w * log_eps + (1.0 - w) * log_eps_bar
    return (t, h_bar, log_eps, log_eps_bar, mu)


def hmc(
    u_and_grad: Callable[..., tuple[Any, Any]],
    x0,
    key,
    *,
    data: tuple = (),
    n_samples: int = 500,
    n_warmup: int = 500,
    n_leapfrog: int = 24,
    n_chains: int = 4,
    init_step: float = 0.1,
    target_accept: float = 0.8,
    chain_jitter: float = 0.5,
    energy_fn: Callable | None = None,
) -> HMCResult:
    """Sample exp(-U) with adaptive HMC.  ``u_and_grad(x, *data) -> (U, dU)``
    is the negative log posterior over the packed vector and its gradient;
    ``make_objective``'s closure form works for small problems:

        neg_l_and_grad, _ = make_objective(family, X, y, pack, log_prior=lp)
        res = hmc(neg_l_and_grad, pack.x0, key)

    **Large data must go through ``data=``**, not a closure: the sampler is
    one jitted graph with ``u_and_grad`` static, so closure-captured arrays
    lower to embedded HLO constants, which bloat the program and its
    compile time at ~MB scale (CLAUDE.md invariant).  ``data`` is threaded through
    as jit operands and passed as trailing arguments to ``u_and_grad``
    (:func:`sample_posterior` does this automatically).

    ``energy_fn(x, *data) -> U``, when given, supplies the potential used
    for the MH accept statistic (and the recorded draws' potential), while
    ``u_and_grad`` keeps supplying the leapfrog forces.  Use it to evaluate
    the accept at higher GEMM precision than the trajectories: at f32-HIGH
    the total-evidence rounding roughness (~nats at n >= 1e5) pins the
    accept rate near 0.5 whatever the step size, so dual averaging adapts
    to noise (see _transition).

    Chains start at ``x0`` plus N(0, chain_jitter^2) offsets and run batched
    under vmap; a chain whose jittered start has nonfinite potential or
    gradient is shrunk toward ``x0`` (offset halved, up to 30 times) before
    sampling, so one poisoned init cannot freeze a chain.  The full sampler
    is one jitted graph; only the diagnostics (R-hat, ESS) are computed on
    host afterwards.
    """
    x0 = jnp.asarray(x0)
    if x0.ndim != 1:
        raise ValueError("hmc expects a flat (packed) vector x0")
    d = x0.shape[0]
    n_w1 = max(n_warmup // 2, 1)
    n_w2 = max(n_warmup - n_w1, 1)
    dtype = x0.dtype

    key_init, key_run = jax.random.split(jax.random.PRNGKey(key) if isinstance(key, int) else key)
    x_init = x0[None, :] + chain_jitter * jax.random.normal(
        key_init, (n_chains, d), dtype
    )
    chain_keys = jax.random.split(key_run, n_chains)
    log_eps0 = jnp.asarray(np.log(init_step), dtype)

    samples, potential, accept_rate, step_size, inv_mass = _run_chains(
        u_and_grad, tuple(data), x0, x_init, chain_keys, log_eps0,
        n_w1, n_w2, n_samples, n_leapfrog, float(target_accept),
        energy_fn,
    )
    samples_h = np.asarray(samples)
    return HMCResult(
        samples=samples,
        potential=potential,
        accept_rate=accept_rate,
        step_size=step_size,
        inv_mass=inv_mass,
        rhat=split_rhat(samples_h),
        ess=bulk_ess(samples_h),
    )


@partial(
    jax.jit,
    static_argnames=(
        "u_and_grad", "n_w1", "n_w2", "n_samples", "n_leapfrog",
        "target_accept", "energy_fn",
    ),
)
def _run_chains(
    u_and_grad, data, x0, x_init, chain_keys, log_eps0,
    n_w1, n_w2, n_samples, n_leapfrog, target_accept, energy_fn=None,
):
    """Vmapped chain runner.  ``u_and_grad`` and the phase lengths are
    static, so repeated calls with the same objective reuse the compiled
    executable — every retrace would be a fresh multi-second compile.  ``data`` is a pytree of
    jit OPERANDS forwarded as ``u_and_grad(x, *data)`` — large arrays must
    ride here, not inside the (static, hence trace-embedded) callable."""
    d = x_init.shape[-1]
    dtype = x_init.dtype

    def ug(x):
        return u_and_grad(x, *data)

    efn = None if energy_fn is None else (lambda x: energy_fn(x, *data))

    def one_chain(x0c, keyc):
        u0, g0 = ug(x0c)

        # A jittered start with nonfinite potential/gradient would freeze the
        # chain (alpha = 0 forever): halve its offset from x0 until finite.
        def shrink_cond(carry):
            _, u, g, i = carry
            bad = ~(jnp.isfinite(u) & jnp.all(jnp.isfinite(g)))
            return bad & (i < 30)

        def shrink_body(carry):
            x, _, _, i = carry
            x_new = x0 + 0.5 * (x - x0)
            u_new, g_new = ug(x_new)
            return (x_new, u_new, g_new, i + 1)

        x0c, u0, g0, _ = lax.while_loop(
            shrink_cond, shrink_body, (x0c, u0, g0, jnp.asarray(0))
        )
        if efn is not None:
            # the carried state potential lives at the accept precision
            u0 = efn(x0c)
        state0 = (x0c, u0, g0)
        unit_mass = jnp.ones((d,), dtype)

        # Warmup phase 1: adapt step size under unit mass; Welford-accumulate
        # position moments for the mass estimate.
        def w1_body(carry, k):
            state, da, cnt, mean, m2 = carry
            state, alpha = _transition(
                ug, state, k, da[2], unit_mass, n_leapfrog, efn
            )
            da = _dual_avg_update(da, alpha, target_accept)
            cnt = cnt + 1.0
            delta = state[0] - mean
            mean = mean + delta / cnt
            m2 = m2 + delta * (state[0] - mean)
            return (state, da, cnt, mean, m2), None

        keys1 = jax.random.split(keyc, n_w1 + n_w2 + n_samples + 1)[1:]
        carry = (
            state0,
            _dual_avg_init(log_eps0),
            jnp.asarray(0.0, dtype),
            jnp.zeros((d,), dtype),
            jnp.zeros((d,), dtype),
        )
        (state, da, cnt, _, m2), _ = lax.scan(w1_body, carry, keys1[:n_w1])

        # Stan-style regularized diagonal mass: shrink the sample variance
        # toward a small constant so short warmups cannot zero a scale.
        var = m2 / jnp.maximum(cnt - 1.0, 1.0)
        inv_mass = (cnt / (cnt + 5.0)) * var + (5.0 / (cnt + 5.0)) * 1e-3
        inv_mass = jnp.where(jnp.isfinite(inv_mass) & (inv_mass > 0), inv_mass, 1.0)

        # Warmup phase 2: re-adapt the step under the new metric (restart
        # dual averaging from the phase-1 smoothed step).
        def w2_body(carry, k):
            state, da = carry
            state, alpha = _transition(
                ug, state, k, da[2], inv_mass, n_leapfrog, efn
            )
            da = _dual_avg_update(da, alpha, target_accept)
            return (state, da), None

        da2 = _dual_avg_init(da[3])
        (state, da2), _ = lax.scan(
            w2_body, (state, da2), keys1[n_w1 : n_w1 + n_w2]
        )
        log_eps_final = da2[3]

        # Sampling: fixed kernel, collect draws.
        def s_body(state, k):
            state, alpha = _transition(
                ug, state, k, log_eps_final, inv_mass, n_leapfrog, efn
            )
            return state, (state[0], state[1], alpha)

        _, (xs, us, alphas) = lax.scan(s_body, state, keys1[n_w1 + n_w2 :])
        return xs, us, jnp.mean(alphas), jnp.exp(log_eps_final), inv_mass

    return jax.vmap(one_chain)(x_init, chain_keys)


def split_rhat(samples: np.ndarray) -> np.ndarray:
    """Split-chain potential scale reduction (Gelman et al., BDA3 eq. 11.4).
    samples: (n_chains, n_samples, d) -> (d,).  Values near 1 indicate the
    chains agree; > ~1.05 means run longer."""
    c, s, d = samples.shape
    half = s // 2
    if half < 2:
        return np.full((d,), np.nan)
    split = samples[:, : 2 * half].reshape(c * 2, half, d).astype(np.float64)
    means = split.mean(axis=1)  # (2c, d)
    w = split.var(axis=1, ddof=1).mean(axis=0)  # (d,)
    b = half * means.var(axis=0, ddof=1)  # (d,)
    var_plus = (half - 1) / half * w + b / half
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.sqrt(var_plus / w)


def bulk_ess(samples: np.ndarray) -> np.ndarray:
    """Effective sample size via Geyer's initial monotone positive sequence
    on the chain-averaged autocorrelation (the rank-normalization refinement
    is skipped; this is the classic estimator)."""
    c, s, d = samples.shape
    if s < 4:
        return np.full((d,), np.nan)
    x = samples.astype(np.float64)
    x = x - x.mean(axis=1, keepdims=True)
    # FFT autocovariance per chain/coordinate.
    nfft = int(2 ** np.ceil(np.log2(2 * s)))
    f = np.fft.rfft(x, n=nfft, axis=1)
    acov = np.fft.irfft(f * np.conj(f), n=nfft, axis=1)[:, :s].real / s
    var0 = acov[:, 0].mean(axis=0)  # (d,)
    rho = acov.mean(axis=0) / np.where(var0 > 0, var0, 1.0)  # (s, d)
    ess = np.empty(d)
    for j in range(d):
        # Sum paired autocorrelations while the pairs stay positive and
        # monotonically decreasing (Geyer 1992).
        pair_sum = rho[0:-1:2, j] + rho[1::2, j]
        pos = np.minimum.accumulate(np.maximum(pair_sum, 0.0))
        k = np.argmax(pos <= 0.0) if np.any(pos <= 0.0) else pos.shape[0]
        tau = max(2.0 * np.sum(pos[:k]) - 1.0, 1.0 / s)
        # Antithetic/noise-dominated chains can push tau below 1; cap the
        # estimate at the draw count so diagnostics never report more
        # effective samples than actual ones.
        ess[j] = min(c * s / tau, float(c * s))
    return ess


def make_accept_energy(
    family, X, targets, pack, *, precision: str = "highest",
    log_prior=None, variational: bool = False,
    block_size: int | None = None,
):
    """A value-only potential ``(x, X, targets) -> U`` whose GEMMs trace at
    ``precision``, for :func:`hmc`'s ``energy_fn``.

    ``config.matmul_precision`` is read at TRACE time by every
    ``numerics.linalg.matmul`` site, so temporarily overriding it while
    this (and only this) sub-graph traces gives the accept statistic its
    own GEMM precision inside the one jitted sampler — the leapfrog keeps
    the session precision.  Measured motivation (probes/r5_hmc_accept.py at
    commit b587de6): accept pinned at ~0.5 under HIGH whatever the warmup;
    clean under HIGHEST."""
    from ..config import config
    from .train import make_objective

    energy, _ = make_objective(
        family, X, targets, pack,
        variational=variational, block_size=block_size, log_prior=log_prior,
        return_raw=True, value_only=True,
    )

    def wrapped(x, X, targets):
        old = config.matmul_precision
        config.matmul_precision = precision
        try:
            return energy(x, X, targets)
        finally:
            config.matmul_precision = old

    return wrapped


def sample_posterior(
    family,
    X,
    targets,
    pack,
    key,
    *,
    log_prior=None,
    variational: bool = False,
    block_size: int | None = None,
    accept_precision: str | None = "highest",
    **hmc_kwargs,
) -> HMCResult:
    """HMC over the GP hyper posterior: builds the library objective
    (un-normalized — scaling the potential would temper the posterior) and
    samples it.  ``block_size=`` streams the evidence, so the posterior of a
    past-HBM dataset is samplable.

    ``accept_precision`` (default "highest") evaluates the MH accept
    statistic at that GEMM precision via :func:`make_accept_energy` while
    the leapfrog forces stay at the session precision — without it, f32
    evidence rounding roughness pins the accept rate near 0.5 at
    |L| >~ 1e5 and dual averaging adapts to noise (module docstring).  Pass ``None`` to disable
    (x64/CPU runs don't need the extra forward per transition)."""
    from .train import make_objective

    # return_raw + data= threads (X, targets) through as jit OPERANDS of the
    # sampler graph; a data-capturing closure would lower them to embedded
    # HLO constants, which bloat the program at ~MB scale (CLAUDE.md
    # invariant).
    neg_l_and_grad, _ = make_objective(
        family, X, targets, pack,
        variational=variational, block_size=block_size, log_prior=log_prior,
        return_raw=True,
    )
    energy_fn = None
    if accept_precision is not None:
        energy_fn = make_accept_energy(
            family, X, targets, pack, precision=accept_precision,
            log_prior=log_prior, variational=variational,
            block_size=block_size,
        )
    return hmc(
        neg_l_and_grad, pack.x0, key, data=(X, targets),
        energy_fn=energy_fn, **hmc_kwargs
    )


# Compiled-moments cache for predict_hmc_mixture, keyed by identity of the
# (unhashable: HyperPack holds arrays) family/pack plus the static flags.
# Caching the objects themselves keeps them alive so ids cannot be reused.
# Without this every predict call retraces, and each
# retrace is a fresh multi-second compile.  Bounded FIFO:
# a sweep that fits many models (fresh pack per fit) must not accumulate
# packs + compiled executables without limit.
_MIXTURE_CACHE: dict = {}
_MIXTURE_CACHE_MAX = 8


def _mixture_moments_fn(family, pack, variational, predictive):
    from ..models.fitc import calc_model, calc_trained
    from ..models.predict import (
        co_variance_predictor, mean_predictor, predict_means,
        predict_variances,
    )

    cache_key = (id(family), id(pack), bool(variational), bool(predictive))
    hit = _MIXTURE_CACHE.get(cache_key)
    if hit is not None and hit[0] is family and hit[1] is pack:
        return hit[2]

    @jax.jit
    def moments(xs, X, targets, x_test):
        def one(xvec):
            params, z, sigma2 = pack.unpack(xvec)
            model = calc_model(
                family, params, X, z, sigma2, variational=variational
            )
            trained = calc_trained(model, targets)
            mu = predict_means(family, params, mean_predictor(trained), x_test)
            var = predict_variances(
                family, params, co_variance_predictor(model), x_test, sigma2,
                predictive=predictive,
            )
            return mu, var

        mus, vars_ = lax.map(one, xs)
        mean = jnp.mean(mus, axis=0)
        var = jnp.mean(vars_ + mus * mus, axis=0) - mean * mean
        return mean, var

    while len(_MIXTURE_CACHE) >= _MIXTURE_CACHE_MAX:
        _MIXTURE_CACHE.pop(next(iter(_MIXTURE_CACHE)))
    _MIXTURE_CACHE[cache_key] = (family, pack, moments)
    return moments


def predict_hmc_mixture(
    family,
    pack,
    samples,
    X,
    targets,
    x_test,
    *,
    variational: bool = False,
    thin: int = 1,
    predictive: bool = True,
):
    """Posterior-predictive moments mixed over hyper draws.

    For each (thinned) draw theta_s, condition the model and read the
    predictive mean/variance; the mixture is exact in its first two moments
    (law of total variance):

        mean = E_s[mu_s]
        var  = E_s[var_s + mu_s^2] - mean^2

    Runs as ``lax.map`` over draws — sequential, so test-set memory stays
    one draw wide at any sample count.  Returns (mean, var), each (n_test,).
    The compiled moments graph is cached per (family, pack, flags), so
    repeated predictions reuse the executable (see ``_MIXTURE_CACHE``).
    """
    samples = jnp.asarray(samples)
    if samples.ndim == 3:
        samples = samples.reshape(-1, samples.shape[-1])
    samples = samples[::thin]

    moments = _mixture_moments_fn(family, pack, variational, predictive)
    return moments(samples, X, targets, x_test)

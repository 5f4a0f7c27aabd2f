"""Evidence-maximization training: the ``Optim.Gsl.train`` equivalent.

Rebuild of lib/fitc_gp.ml:1465-1671 with the same keyword surface and
defaults (interfaces.ml:1031-1079): sigma2 defaults to the target second
moment, n_inducing to min(n/10, 1000) with random selection, step/tol/epsabs
to 0.1; best-model-so-far tracking, throttle-friendly callbacks, and
interrupt-by-exception all behave like the reference (Bailout from a callback
returns the best trained model seen).

The objective (negative evidence) and its gradient are one jitted
value-and-grad over the packed hyper vector; the L-BFGS driver calls it once
per line-search point.
"""

from __future__ import annotations

from typing import Callable, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..models.fitc import (
    TrainedState,
    calc_model,
    calc_trained,
    choose_n_random_inputs,
)
from .lbfgs import minimize_lbfgs
from .pack import make_pack
from .sgd_smd import (
    run_ascent,
    sgd_create,
    sgd_step,
    smd_create,
    smd_step,
)


class Bailout(Exception):
    """Raise from a callback to stop training and keep the best model
    (bin/ocaml_gpr.ml:380 ``exception Bailout``)."""


class TrainResult:
    """Trained state plus the optimized hyperparameters.

    Attribute access falls through to the wrapped :class:`TrainedState`
    (``.l``, ``.coeffs``, ``.model`` ...), so it can be used wherever a
    trained state is expected while also exposing what the reference's
    ``Trained.get_model`` + ``Model.get_kernel`` chain provides
    (bin/ocaml_gpr.ml:205-212): the final kernel params, inducing
    representation, and noise level.
    """

    def __init__(self, trained: TrainedState, kernel_params, inducing, sigma2):
        self.trained = trained
        self.kernel_params = kernel_params
        self.inducing = inducing
        self.sigma2 = sigma2

    def __getattr__(self, name):
        return getattr(self.trained, name)


def default_sigma2(targets) -> float:
    """sigma2 default = uncentered target variance (fitc_gp.ml:1468-1472)."""
    y = np.asarray(targets)
    return float(np.dot(y, y) / y.shape[0])


def default_n_inducing(n_inputs: int) -> int:
    """min(n/10, 1000) (fitc_gp.ml:1477-1479)."""
    return max(1, min(n_inputs // 10, 1000))


def _prepare(
    family, X, targets, kernel_params, sigma2, inducing, n_rand_inducing, key
):
    n = X.shape[0]
    if sigma2 is None:
        sigma2 = default_sigma2(targets)
    elif sigma2 < 0:
        raise ValueError(f"sigma2 < 0: {sigma2}")
    if inducing is None:
        m = (
            default_n_inducing(n)
            if n_rand_inducing is None
            else int(n_rand_inducing)
        )
        if not 1 <= m <= n:
            raise ValueError(f"violating 1 <= n_inducing ({m}) <= n ({n})")
        if kernel_params is None:
            kernel_params = family.default_params(X, m, key)
        inducing = choose_n_random_inputs(key, family, kernel_params, X, m)
    elif kernel_params is None:
        kernel_params = family.default_params(X, inducing.shape[0], key)
    return kernel_params, sigma2, inducing


def make_objective(
    family, X, targets, pack, *, variational=False, factorization=None,
    normalize=False, block_size=None, log_prior=None, return_raw=False,
    value_only=False,
):
    """Jitted (value, grad) of the NEGATIVE evidence over the packed vector,
    plus a jitted trained-state reconstruction for reporting.

    The data is threaded through as jit *arguments*, never closure-captured:
    captured arrays lower to embedded constants, which bloats the compiled
    graph (and its compile time) at large n.

    ``normalize=True`` optimizes the mean NLL (-l/n): same optimum, but at
    n ~ 10^6 in f32 the total evidence (~1e6) exceeds line-search resolution
    while the mean stays O(1) — required for large-n f32 training.  Note
    epsabs thresholds then apply to mean-scale gradients.

    ``block_size`` switches to the streaming evidence (models/streaming.py):
    Knm is never materialized, so memory stays O(block m + m^2) at any n.

    ``log_prior(params, z, sigma2) -> scalar`` turns evidence maximization
    into MAP estimation: the prior is added to the log evidence (the
    reference has no prior mechanism; a steep prior doubles as a soft box
    bound).  Differentiated along with everything else.

    ``return_raw=True`` returns the underlying jitted ``f(x, X, targets)``
    forms instead of the data-bound ``f(x)`` closures — for callers (HMC)
    that embed the objective in a larger jitted graph and must thread the
    data through as operands rather than capture it.

    ``value_only=True`` skips the gradient: the first return is
    ``f(x[, X, targets]) -> value`` with no backward pass traced — for
    HMC's accept-energy evaluations, which need the potential alone.
    """
    scale = 1.0 / X.shape[0] if normalize else 1.0
    vag = (lambda f: f) if value_only else jax.value_and_grad

    def _prior(params, z, sigma2):
        if log_prior is None:
            return 0.0
        return log_prior(params, z, sigma2)

    if block_size is not None:
        from ..models.streaming import streaming_log_evidence, streaming_trained

        @jax.jit
        def _neg_l_and_grad(x, X, targets):
            def f(x):
                params, z, sigma2 = pack.unpack(x)
                l = streaming_log_evidence(
                    family, params, z, sigma2, X, targets,
                    variational=variational, block_size=block_size,
                )
                return -(l + _prior(params, z, sigma2)) * scale

            return vag(f)(x)

        @jax.jit
        def _trained_of(x, X, targets):
            params, z, sigma2 = pack.unpack(x)
            return streaming_trained(
                family, params, z, sigma2, X, targets,
                variational=variational, block_size=block_size,
            )

        if return_raw:
            return _neg_l_and_grad, _trained_of
        return (
            lambda x: _neg_l_and_grad(x, X, targets),
            lambda x: _trained_of(x, X, targets),
        )

    @jax.jit
    def _neg_l_and_grad(x, X, targets):
        def f(x):
            params, z, sigma2 = pack.unpack(x)
            model = calc_model(
                family, params, X, z, sigma2,
                variational=variational, factorization=factorization,
            )
            l = calc_trained(model, targets).l
            return -(l + _prior(params, z, sigma2)) * scale

        return vag(f)(x)

    @jax.jit
    def _trained_of(x, X, targets):
        params, z, sigma2 = pack.unpack(x)
        model = calc_model(
            family, params, X, z, sigma2,
            variational=variational, factorization=factorization,
        )
        return calc_trained(model, targets)

    if return_raw:
        return _neg_l_and_grad, _trained_of
    return (
        lambda x: _neg_l_and_grad(x, X, targets),
        lambda x: _trained_of(x, X, targets),
    )


def train(
    family,
    X,
    targets,
    *,
    kernel_params=None,
    sigma2: float | None = None,
    inducing=None,
    n_rand_inducing: int | None = None,
    learn_sigma2: bool = True,
    learn_inducing: bool | None = None,
    fixed: Sequence[str] = (),
    variational: bool = False,
    factorization: str | None = None,
    block_size: int | None = None,
    log_prior=None,
    step: float = 0.1,
    tol: float = 0.1,
    epsabs: float = 0.1,
    max_iter: int | None = None,
    report_trained_model: Callable[..., None] | None = None,
    report_gradient_norm: Callable[..., None] | None = None,
    key=None,
    checkpoint_path: str | None = None,
    checkpoint_every: int = 1,
    resume: bool = False,
) -> TrainResult:
    """L-BFGS evidence maximization; returns the best trained model seen
    (with its optimized kernel params, inducing points and noise level).

    Callbacks receive keyword arguments (iter=..., trained=... / norm=...)
    and may raise :class:`Bailout` (or anything else) to stop — matching the
    reference's report hooks and exception tunneling
    (fitc_gp.ml:1532-1671).

    ``checkpoint_path`` persists the full optimizer state (packed hypers +
    L-BFGS curvature history + best-so-far) every ``checkpoint_every``
    accepted iterations; ``resume=True`` continues from that file (same
    data/model configuration required) and reproduces the uninterrupted
    trajectory exactly.  The reference cannot do this — its model file holds
    only the predictor (bin/ocaml_gpr.ml:179-228).
    """
    if key is None:
        key = jax.random.PRNGKey(0)
    kernel_params, sigma2, inducing = _prepare(
        family, X, targets, kernel_params, sigma2, inducing, n_rand_inducing, key
    )
    pack = make_pack(
        family, kernel_params, inducing, sigma2,
        learn_sigma2=learn_sigma2, learn_inducing=learn_inducing, fixed=fixed,
    )
    neg_l_and_grad, trained_of = make_objective(
        family, X, targets, pack,
        variational=variational, factorization=factorization,
        block_size=block_size, log_prior=log_prior,
    )

    init_state = None
    best: dict = {"le": -np.inf, "x": pack.x0}
    if resume:
        if checkpoint_path is None:
            raise ValueError("resume=True requires checkpoint_path")
        import os

        if os.path.exists(checkpoint_path):
            from ..io.resume import load_train_checkpoint

            init_state, best_x, best_le = load_train_checkpoint(
                checkpoint_path
            )
            if init_state.x.shape != np.asarray(pack.x0).shape:
                raise ValueError(
                    f"checkpoint hyper vector has shape {init_state.x.shape} "
                    f"but this configuration packs {np.asarray(pack.x0).shape}"
                    " — resume requires the same model/data setup"
                )
            best = {"le": best_le, "x": best_x}
    n_evals = {"n": 0}

    def fg(x):
        xj = jnp.asarray(x)
        f, g = neg_l_and_grad(xj)
        f = float(f)
        n_evals["n"] += 1
        if np.isnan(f):
            if n_evals["n"] == 1:
                # NaN at the starting point is unrecoverable
                # (fitc_gp.ml:1523-1528)
                raise FloatingPointError("optimization function returned nan")
            # NaN at a line-search probe (sigma2 underflow, exp overflow at a
            # wild trial step) just means "step too far": report +inf so the
            # search backs off.
            return np.inf, np.zeros_like(np.asarray(g, dtype=np.float64))
        return f, np.asarray(g, dtype=np.float64)

    iter_box = {"i": 1}

    def callback(it, x, f, g):
        iter_box["i"] = it + 1
        le = -f
        if le > best["le"]:
            best["le"] = le
            best["x"] = np.asarray(x)
            if report_trained_model is not None:
                report_trained_model(iter=it + 1, trained=trained_of(jnp.asarray(x)))
        if report_gradient_norm is not None:
            report_gradient_norm(iter=it + 1, norm=float(np.linalg.norm(g)))

    state_callback = None
    if checkpoint_path is not None:
        from ..io.resume import save_train_checkpoint

        def state_callback(st):
            if st.n_iter % max(1, checkpoint_every) == 0:
                save_train_checkpoint(
                    checkpoint_path, st, best_x=best["x"], best_le=best["le"]
                )

    try:
        minimize_lbfgs(
            fg,
            np.asarray(pack.x0, dtype=np.float64),
            step=step, tol=tol, epsabs=epsabs, max_iter=max_iter,
            callback=callback, init_state=init_state,
            state_callback=state_callback,
        )
    except (Bailout, KeyboardInterrupt):
        pass  # return the best model so far (bin/ocaml_gpr.ml:337-345)

    x_best = jnp.asarray(best["x"])
    params_b, z_b, sigma2_b = pack.unpack(x_best)
    return TrainResult(trained_of(x_best), params_b, z_b, sigma2_b)


def _ascent_setup(
    family, X, targets, kernel_params, sigma2, inducing, n_rand_inducing,
    learn_sigma2, learn_inducing, fixed, variational, factorization, key,
):
    if key is None:
        key = jax.random.PRNGKey(0)
    kernel_params, sigma2, inducing = _prepare(
        family, X, targets, kernel_params, sigma2, inducing, n_rand_inducing, key
    )
    pack = make_pack(
        family, kernel_params, inducing, sigma2,
        learn_sigma2=learn_sigma2, learn_inducing=learn_inducing, fixed=fixed,
    )
    neg_l_and_grad, trained_of = make_objective(
        family, X, targets, pack,
        variational=variational, factorization=factorization,
    )

    def grad_fn(x):
        return -neg_l_and_grad(x)[1]  # ascent gradient

    def value_fn(x):
        return -float(neg_l_and_grad(x)[0])

    return pack, grad_fn, value_fn, trained_of


def train_sgd(
    family, X, targets, *, tau=100.0, eta0=1e-3, epsabs=0.1, max_iter=None,
    report=None, **kw
) -> TrainResult:
    """SGD evidence ascent (fitc_gp.ml:1724-1833)."""
    pack, grad_fn, value_fn, trained_of = _ascent_setup(
        family, X, targets,
        kw.pop("kernel_params", None), kw.pop("sigma2", None),
        kw.pop("inducing", None), kw.pop("n_rand_inducing", None),
        kw.pop("learn_sigma2", True), kw.pop("learn_inducing", None),
        kw.pop("fixed", ()), kw.pop("variational", False),
        kw.pop("factorization", None), kw.pop("key", None),
    )
    if kw:
        raise TypeError(f"unexpected keyword arguments: {sorted(kw)}")
    st = sgd_create(grad_fn, pack.x0, tau=tau, eta0=eta0)
    best = run_ascent(
        lambda s: sgd_step(grad_fn, s), value_fn, st,
        epsabs=epsabs, max_iter=max_iter, report=report,
    )
    params_b, z_b, sigma2_b = pack.unpack(best.x)
    return TrainResult(trained_of(best.x), params_b, z_b, sigma2_b)


def train_smd(
    family, X, targets, *, lambda_=0.1, mu=1e-3, eta0=1e-3, nu0=1e-3,
    epsabs=0.1, max_iter=None, report=None, **kw
) -> TrainResult:
    """SMD evidence ascent with exact HVPs (fitc_gp.ml:1835-2019)."""
    pack, grad_fn, value_fn, trained_of = _ascent_setup(
        family, X, targets,
        kw.pop("kernel_params", None), kw.pop("sigma2", None),
        kw.pop("inducing", None), kw.pop("n_rand_inducing", None),
        kw.pop("learn_sigma2", True), kw.pop("learn_inducing", None),
        kw.pop("fixed", ()), kw.pop("variational", False),
        kw.pop("factorization", None), kw.pop("key", None),
    )
    if kw:
        raise TypeError(f"unexpected keyword arguments: {sorted(kw)}")
    st = smd_create(grad_fn, pack.x0, lambda_=lambda_, mu=mu, eta0=eta0, nu0=nu0)
    best = run_ascent(
        lambda s: smd_step(grad_fn, s), value_fn, st,
        epsabs=epsabs, max_iter=max_iter, report=report,
    )
    params_b, z_b, sigma2_b = pack.unpack(best.x)
    return TrainResult(trained_of(best.x), params_b, z_b, sigma2_b)

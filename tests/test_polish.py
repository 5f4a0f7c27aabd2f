"""f64 finishing step (optim.polish): the two-phase f32 -> f64 workflow.

The polish must (a) run the SAME objective at f64 in a child process and
push the gradient norm below the f32 noise floor, and (b) round-trip the
hyper vector through the pack unchanged in structure.  VERDICT.md round-2 #4 at commit
b587de6.
"""

import numpy as np
import pytest


@pytest.fixture(scope="module")
def problem():
    import jax.numpy as jnp

    from gpr_tpu.kernels import SeIso
    from gpr_tpu.optim import make_pack

    rng = np.random.default_rng(7)
    X = jnp.asarray(rng.standard_normal((300, 2)), jnp.float32)
    y = jnp.asarray(
        np.sin(np.asarray(X).sum(1)) + 0.1 * rng.standard_normal(300),
        jnp.float32,
    )
    Z = X[:8]
    p = SeIso.Params(
        log_ell=jnp.asarray(0.2, jnp.float32),
        log_sf2=jnp.asarray(0.0, jnp.float32),
    )
    pack = make_pack(SeIso, p, Z, 0.5)
    return SeIso, X, y, pack


@pytest.mark.slow
def test_polish_reduces_gradient(problem):
    from gpr_tpu.optim.polish import polish

    family, X, y, pack = problem
    params, z, s2, x_f, rep = polish(
        family, X, y, pack, pack.x0, variational=True, subsample=None,
        max_iter=60, epsabs=1e-4, block_size=None,
    )
    assert rep.f < rep.f0
    assert rep.gnorm < 1e-4 or rep.n_iter == 60
    assert rep.gnorm < rep.gnorm0
    assert rep.n_rows == 300
    # unpacked arrays come back in the pack's working dtype
    assert x_f.dtype == pack.x0.dtype
    assert np.isfinite(float(s2)) and float(s2) > 0


@pytest.mark.slow
def test_polish_subsample_consistent(problem):
    """A row subsample optimizes the same mean-NLL quantity: the polished
    lengthscale from a 150-row subsample must land near the full-data one
    (loose tolerance — it is a statistical, not numerical, equivalence)."""
    from gpr_tpu.optim.polish import polish

    family, X, y, pack = problem
    p_full, _, _, _, _ = polish(
        family, X, y, pack, pack.x0, variational=True, subsample=None,
        max_iter=40, epsabs=1e-3, block_size=None,
    )
    p_sub, _, _, _, rep = polish(
        family, X, y, pack, pack.x0, variational=True, subsample=150,
        seed=3, max_iter=40, epsabs=1e-3, block_size=None,
    )
    assert rep.n_rows == 150
    assert abs(float(p_sub.log_ell) - float(p_full.log_ell)) < 0.5


def test_evaluate_f64_nondefault_pack(problem):
    """ADVICE.md r4 (medium, at commit b587de6): evaluate_f64 must rebuild the CHILD pack with the
    parent's layout options.  Before the fix, a pack built with
    learn_inducing=False (or fixed=...) hit a length mismatch in the child,
    the blanket except ranked every candidate inf, and
    fit_restarts(rescore_f64=...) silently selected states[0]."""
    import jax.numpy as jnp

    from gpr_tpu.kernels import SeIso
    from gpr_tpu.optim import make_pack
    from gpr_tpu.optim.polish import evaluate_f64

    family, X, y, _ = problem
    rng = np.random.default_rng(11)
    Z = X[:8]
    p = SeIso.Params(
        log_ell=jnp.asarray(0.2, jnp.float32),
        log_sf2=jnp.asarray(0.0, jnp.float32),
    )
    pack = make_pack(family, p, Z, 0.5, learn_inducing=False,
                     fixed=("log_sf2",))
    assert pack.learn_inducing is False and pack.fixed == ("log_sf2",)
    xs = [pack.x0, pack.x0 + 0.1]
    fs = evaluate_f64(family, X, y, pack, xs, subsample=None,
                      block_size=None)
    assert all(np.isfinite(f) for f in fs), fs
    assert fs[0] != fs[1]


def test_evaluate_f64_extended_pack_fails_loudly(problem):
    """An ExtendedPack cannot be rebuilt by the f64 child (extra likelihood
    coords are not in the manifest): the child must exit nonzero so the
    parent raises, instead of silently ranking everything inf."""
    import jax.numpy as jnp

    from gpr_tpu.optim.pack import extend_pack
    from gpr_tpu.optim.polish import evaluate_f64

    family, X, y, pack = problem
    epack = extend_pack(pack, {"extra": jnp.zeros(2, jnp.float32)})
    with pytest.raises(RuntimeError, match="n_hypers"):
        evaluate_f64(family, X, y, epack, [epack.x0], subsample=None,
                     block_size=None)

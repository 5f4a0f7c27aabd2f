"""Training resume round-trip and the individual stats accessors."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gpr_tpu.io import load_model, save_model
from gpr_tpu.io.checkpoint import ModelArtifact
from gpr_tpu.io.resume import (
    resume_minimize,
    training_state_arrays,
    training_state_from_arrays,
)
from gpr_tpu.kernels import SeIso
from gpr_tpu.models import calc_model, calc_trained
from gpr_tpu.models.stats import (
    calc_mad,
    calc_maxad,
    calc_mse,
    calc_msll,
    calc_rmse,
    calc_smse,
    calc_sse,
    calc_stats,
    calc_target_variance,
)
from gpr_tpu.optim import make_pack
from gpr_tpu.optim.lbfgs_device import minimize_lbfgs_device


def test_individual_stats_match_combined(rng):
    X = jnp.asarray(rng.standard_normal((60, 2)))
    y = jnp.asarray(rng.standard_normal(60))
    Z = jnp.asarray(rng.standard_normal((6, 2)))
    p = SeIso.Params(log_ell=jnp.asarray(0.1), log_sf2=jnp.asarray(0.0))
    trained = calc_trained(calc_model(SeIso, p, X, Z, 0.5), y)
    st = calc_stats(trained)
    for fn, field in [
        (calc_target_variance, "target_variance"), (calc_sse, "sse"),
        (calc_mse, "mse"), (calc_rmse, "rmse"), (calc_smse, "smse"),
        (calc_msll, "msll"), (calc_mad, "mad"), (calc_maxad, "maxad"),
    ]:
        np.testing.assert_allclose(
            float(fn(trained)), float(getattr(st, field)), rtol=1e-12
        )


@pytest.mark.slow
def test_resume_roundtrip(tmp_path, rng):
    """Interrupt a GP training run mid-way, checkpoint, restore, continue —
    the final objective must match an uninterrupted run."""
    X = jnp.asarray(rng.standard_normal((200, 2)))
    y = jnp.asarray(np.sin(np.asarray(X).sum(1)) + 0.1 * rng.standard_normal(200))
    p0 = SeIso.Params(log_ell=jnp.asarray(0.0), log_sf2=jnp.asarray(0.0))
    pack = make_pack(SeIso, p0, X[:6], 1.0)

    from gpr_tpu.models import log_evidence

    def fg(x):
        def f(x):
            params, z, s2 = pack.unpack(x)
            return -log_evidence(SeIso, params, z, s2, X, y,
                                 factorization="chol")
        return jax.value_and_grad(f)(x)

    half = minimize_lbfgs_device(fg, pack.x0, epsabs=0.5, max_iter=8)
    # checkpoint via the model-artifact extra arrays
    params_h, z_h, s2_h = pack.unpack(half.x)
    model = calc_model(SeIso, params_h, X, z_h, s2_h, factorization="chol")
    trained = calc_trained(model, y)
    art = ModelArtifact(
        family_name="se_iso", kernel_params=params_h,
        inducing=np.asarray(z_h), coeffs=np.asarray(trained.coeffs),
        chol_km=np.asarray(model.inducing.chol_km),
        r_mat=np.asarray(model.r_mat), sigma2=float(s2_h), target_mean=0.0,
        input_means=np.zeros(2), input_stddevs=np.ones(2),
    )
    path = str(tmp_path / "ckpt.npz")
    save_model(path, art, extra_arrays=training_state_arrays(half))

    _, extra = load_model(path)
    restored = training_state_from_arrays(extra)
    np.testing.assert_allclose(np.asarray(restored.x), np.asarray(half.x))
    np.testing.assert_allclose(np.asarray(restored.s_hist),
                               np.asarray(half.s_hist))
    resumed = resume_minimize(fg, restored, epsabs=0.5, max_iter=20)

    # full-state resume: the curvature history round-trips through the
    # checkpoint, so interrupt-at-8 + resume-to-20 reproduces the
    # UNINTERRUPTED 20-iteration trajectory (not merely "doesn't regress")
    full = minimize_lbfgs_device(fg, pack.x0, epsabs=0.5, max_iter=20)
    assert int(resumed.n_iter) == int(full.n_iter)
    np.testing.assert_allclose(float(resumed.f), float(full.f), rtol=1e-10)
    np.testing.assert_allclose(np.asarray(resumed.x), np.asarray(full.x),
                               rtol=1e-8, atol=1e-10)


def test_host_train_resume_reproduces_trajectory(tmp_path, rng):
    """Interrupt the host train() loop, resume from its checkpoint, and land
    on the SAME final hypers as the uninterrupted run (VERDICT.md round-1 item at commit b587de6:
    resumability for the callback-rich host path, not just device fit())."""
    from gpr_tpu.datasets import gen_data
    from gpr_tpu.optim.train import Bailout, train

    Xn, yn, _ = gen_data(3, n=200)
    X, y = jnp.asarray(Xn), jnp.asarray(yn)
    kw = dict(
        n_rand_inducing=6, variational=True, key=jax.random.PRNGKey(7),
        max_iter=12, epsabs=1e-6,
    )

    full = train(SeIso, X, y, **kw)

    ckpt = str(tmp_path / "train.ckpt.npz")

    def bail(iter, norm):
        if iter >= 5:
            raise Bailout

    partial = train(
        SeIso, X, y, checkpoint_path=ckpt, report_gradient_norm=bail, **kw
    )
    # the interrupted run must differ (it stopped early)
    assert float(partial.l) <= float(full.l) + 1e-9

    resumed = train(SeIso, X, y, checkpoint_path=ckpt, resume=True, **kw)
    np.testing.assert_allclose(float(resumed.l), float(full.l), rtol=1e-10)
    for a, b in zip(
        jax.tree.leaves((resumed.kernel_params, resumed.inducing,
                         resumed.sigma2)),
        jax.tree.leaves((full.kernel_params, full.inducing, full.sigma2)),
    ):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-10,
                                   atol=1e-12)


def test_host_train_resume_requires_matching_pack(tmp_path, rng):
    from gpr_tpu.datasets import gen_data
    from gpr_tpu.optim.train import train

    Xn, yn, _ = gen_data(3, n=120)
    X, y = jnp.asarray(Xn), jnp.asarray(yn)
    ckpt = str(tmp_path / "t.npz")
    train(SeIso, X, y, n_rand_inducing=5, max_iter=2, checkpoint_path=ckpt,
          key=jax.random.PRNGKey(0))
    import pytest

    with pytest.raises(ValueError, match="resume requires"):
        train(SeIso, X, y, n_rand_inducing=7, max_iter=2,
              checkpoint_path=ckpt, resume=True, key=jax.random.PRNGKey(0))

"""Guards against f32 evidence INFLATION in degenerate basins.

The quadratic form y'(S + VV')^-1 y = y_is_y - t't is >= 0 mathematically
(Woodbury projection), but in f32 a near-singular I + G lets t't overshoot
y_is_y by cancellation, INFLATING the evidence — measured in f32 at the 1M
bench shape: a broad-ell L-BFGS probe read mean-NLL -1.55 where its
synthetic's perfect-fit floor is +0.215, and multi-start selection then
picked that fictitious basin (BENCH_r04.json at commit b587de6, fit_restarts
line, 4th probe raw-f32 -1.5509 vs rescored_f64 1.1649).  Two layers of
defense are tested here:

1. every l2 epilogue clamps the quad form at its mathematical bound, and
2. fit_restarts(rescore_f64=...) re-ranks finished probes by the f64 HOST
   objective (optim.polish.evaluate_f64) on a shared subsample, which is
   immune to every f32 pathology.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from gpr_tpu.kernels import SeIso
from gpr_tpu.optim import make_pack


def test_evidence_terms_clamp_quad_at_zero():
    """A fabricated t't > y_is_y (the f32 cancellation overshoot) must not
    contribute POSITIVE l2."""
    from gpr_tpu.models.streaming import StreamStats, _evidence_terms

    m = 3
    stats = StreamStats(
        gram=jnp.eye(m), u_vec=jnp.zeros(m),
        log_det_s=jnp.asarray(0.0), y_is_y=jnp.asarray(5.0),
        is_r_sum=jnp.asarray(0.0), n=jnp.asarray(10.0),
    )
    r_tilde = jnp.eye(m)
    t_over = jnp.asarray([3.0, 0.0, 0.0])  # t't = 9 > y_is_y = 5
    _, l2 = _evidence_terms(stats, r_tilde, t_over, variational=False)
    assert float(l2) == 0.0
    t_ok = jnp.asarray([1.0, 0.0, 0.0])  # t't = 1 < 5: untouched
    _, l2 = _evidence_terms(stats, r_tilde, t_ok, variational=False)
    np.testing.assert_allclose(float(l2), -2.0, rtol=1e-12)


def test_calc_trained_l2_never_positive(rng):
    """End-to-end: l2 from the dense path is <= 0 for a stressed model
    (tiny sigma2, duplicated inducing inputs)."""
    from gpr_tpu.models import calc_model, calc_trained

    n, m = 60, 8
    X = jnp.asarray(rng.standard_normal((n, 2)))
    Z = jnp.concatenate([X[: m // 2], X[: m // 2]])  # duplicated rows
    y = jnp.asarray(rng.standard_normal(n))
    p = SeIso.Params(log_ell=jnp.asarray(2.0), log_sf2=jnp.asarray(0.0))
    model = calc_model(SeIso, p, X, Z, jnp.asarray(1e-8))
    tr = calc_trained(model, y)
    assert float(tr.l2) <= 0.0
    assert np.isfinite(float(tr.l))


def test_fit_restarts_rescore_f64(rng):
    """rescore_f64 ranks probes by the f64 host objective: on a healthy
    landscape it must agree with raw-f32 selection, report one f64 value
    per start, and those values must track the device objectives."""
    from gpr_tpu.optim.lbfgs_device import fit_restarts

    n, m = 200, 6
    X = jnp.asarray(rng.standard_normal((n, 2)))
    y = jnp.asarray(np.sin(3.0 * np.asarray(X).sum(1))
                    + 0.1 * rng.standard_normal(n))
    p0 = SeIso.Params(log_ell=jnp.asarray(0.0), log_sf2=jnp.asarray(0.0))
    pack = make_pack(SeIso, p0, X[:m], 1.0)
    x0s = [
        make_pack(
            SeIso,
            SeIso.Params(log_ell=jnp.asarray(le), log_sf2=jnp.asarray(0.0)),
            X[:m], 1.0,
        ).x0
        for le in (-1.5, 0.0, 1.5)
    ]

    kw = dict(probe_iters=10, epsabs=1e-3, max_iter=40, normalize=True)
    _, _, _, st_raw, fs_raw = fit_restarts(SeIso, X, y, pack, x0s, **kw)
    _, _, _, st_rs, fs_rs = fit_restarts(
        SeIso, X, y, pack, x0s, rescore_f64=150, **kw
    )
    assert fs_raw.rescored_f64 is None
    assert len(fs_rs.rescored_f64) == 3
    assert all(np.isfinite(fs_rs.rescored_f64))
    # healthy landscape: both selections land in the same basin
    np.testing.assert_allclose(float(st_rs.f), float(st_raw.f), rtol=1e-4)
    # the f64 host values track the device probe objectives (same
    # mean-NLL objective, different precision/subsample)
    np.testing.assert_allclose(
        np.asarray(fs_rs.rescored_f64), np.asarray(list(fs_rs)),
        rtol=0.05, atol=0.05,
    )


def test_fit_restarts_rescore_rejects_unsupported():
    from gpr_tpu.optim.lbfgs_device import fit_restarts

    X = jnp.zeros((10, 2))
    y = jnp.zeros(10)
    p0 = SeIso.Params(log_ell=jnp.asarray(0.0), log_sf2=jnp.asarray(0.0))
    pack = make_pack(SeIso, p0, X[:2], 1.0)
    with pytest.raises(ValueError, match="rescore_f64"):
        fit_restarts(SeIso, X, y, pack, [pack.x0], rescore_f64=100,
                     objective="loo")

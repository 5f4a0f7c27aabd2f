"""Kernel families vs direct scalar-loop transliterations of the reference.

Each numpy helper below re-implements the reference's scalar loops verbatim
(cited per function) so the vectorized/GEMM-ized JAX kernels are checked
against the exact original semantics, including se_fat's multiscale and
heteroskedastic special cases (SURVEY.md 'hard parts' (b)).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from gpr_tpu.kernels import Const, LinArd, LinOne, SeFat, SeIso


def se_fat_cross_ref(p_proj, Z, log_sf2, ms):
    """lib/cov_se_fat.ml:224-252 scalar loops."""
    n, d = p_proj.shape
    m = Z.shape[0]
    out = np.empty((n, m))
    for c in range(m):
        for r in range(n):
            acc = 0.0
            for i in range(d):
                diff = p_proj[r, i] - Z[c, i]
                if ms is None:
                    acc += diff * diff
                else:
                    u = ms[c, i]
                    acc += diff * diff / u + np.log(u)
            out[r, c] = np.exp(log_sf2 - 0.5 * acc)
    return out


def se_fat_upper_ref(Z, log_sf2, ms, hetero):
    """lib/cov_se_fat.ml:110-143 scalar loops."""
    m, d = Z.shape
    out = np.empty((m, m))
    for c in range(m):
        for r in range(m):
            acc = 0.0
            for i in range(d):
                diff = Z[r, i] - Z[c, i]
                if ms is None:
                    acc += diff * diff
                else:
                    scale = ms[r, i] + ms[c, i] - 1.0
                    acc += diff * diff / scale + np.log(scale)
            if ms is None and r == c:
                out[r, c] = np.exp(log_sf2)
            else:
                out[r, c] = np.exp(log_sf2 - 0.5 * acc)
    if hetero is not None:
        out[np.arange(m), np.arange(m)] += hetero
    return out


def test_const(rng):
    X = jnp.asarray(rng.standard_normal((6, 3)))
    p = Const.Params(log_theta=jnp.asarray(0.7))
    c = np.exp(-2 * 0.7)
    Z = Const.inducing_from_inputs(p, X[:4])
    assert Z.shape == (4, 0)
    np.testing.assert_allclose(np.asarray(Const.k_upper(p, Z)), np.full((4, 4), c))
    np.testing.assert_allclose(np.asarray(Const.k_diag(p, X)), np.full(6, c))
    np.testing.assert_allclose(np.asarray(Const.k_cross(p, X, Z)),
                               np.full((6, 4), c))
    np.testing.assert_allclose(float(Const.k_one(p, X[0])), c)


def test_lin_one(rng):
    X = rng.standard_normal((5, 3))
    Zr = rng.standard_normal((4, 3))
    p = LinOne.Params(log_theta=jnp.asarray(0.3))
    a = np.exp(-2 * 0.3)
    Z = LinOne.inducing_from_inputs(p, jnp.asarray(Zr))
    np.testing.assert_allclose(
        np.asarray(LinOne.k_upper(p, Z)), a * (Zr @ Zr.T + 1), rtol=1e-12
    )
    np.testing.assert_allclose(
        np.asarray(LinOne.k_cross(p, jnp.asarray(X), Z)), a * (X @ Zr.T + 1),
        rtol=1e-12
    )
    np.testing.assert_allclose(
        np.asarray(LinOne.k_diag(p, jnp.asarray(X))),
        a * (np.sum(X * X, 1) + 1), rtol=1e-12
    )
    # eval_one: const * (|x|^2 + 1) (lib/cov_lin_one.ml:54)
    np.testing.assert_allclose(
        float(LinOne.k_one(p, jnp.asarray(X[0]))), a * (X[0] @ X[0] + 1),
        rtol=1e-12
    )


def test_lin_ard(rng):
    d = 4
    X = rng.standard_normal((6, d))
    Zr = rng.standard_normal((3, d))
    log_ells = rng.standard_normal(d) * 0.3
    p = LinArd.Params(log_ells=jnp.asarray(log_ells))
    consts = np.exp(-log_ells)
    Xs, Zs = X * consts, Zr * consts
    # inducing representation is pre-scaled (lib/cov_lin_ard.ml:71)
    Z = LinArd.inducing_from_inputs(p, jnp.asarray(Zr))
    np.testing.assert_allclose(np.asarray(Z), Zs, rtol=1e-12)
    np.testing.assert_allclose(np.asarray(LinArd.k_upper(p, Z)), Zs @ Zs.T,
                               rtol=1e-12)
    np.testing.assert_allclose(
        np.asarray(LinArd.k_cross(p, jnp.asarray(X), Z)), Xs @ Zs.T, rtol=1e-12
    )
    np.testing.assert_allclose(
        np.asarray(LinArd.k_diag(p, jnp.asarray(X))), np.sum(Xs * Xs, 1),
        rtol=1e-12
    )


def test_se_iso(rng):
    X = rng.standard_normal((6, 3))
    Zr = rng.standard_normal((4, 3))
    le, ls = 0.4, -0.2
    p = SeIso.Params(log_ell=jnp.asarray(le), log_sf2=jnp.asarray(ls))
    inv_ell2 = np.exp(-2 * le)
    ref = np.array(
        [
            [
                np.exp(ls - 0.5 * inv_ell2 * np.sum((x - z) ** 2))
                for z in Zr
            ]
            for x in X
        ]
    )
    np.testing.assert_allclose(
        np.asarray(SeIso.k_cross(p, jnp.asarray(X), jnp.asarray(Zr))), ref,
        rtol=1e-10
    )
    ku = np.asarray(SeIso.k_upper(p, jnp.asarray(Zr)))
    np.testing.assert_allclose(np.diag(ku), np.full(4, np.exp(ls)), rtol=1e-12)
    np.testing.assert_allclose(ku, ku.T, rtol=1e-12)


@pytest.mark.parametrize("with_ms", [False, True])
@pytest.mark.parametrize("with_hetero", [False, True])
@pytest.mark.parametrize("with_tproj", [False, True])
def test_se_fat(rng, with_ms, with_hetero, with_tproj):
    n, big_d, d, m = 7, 5, 3, 4
    X = rng.standard_normal((n, big_d if with_tproj else d))
    tproj = rng.standard_normal((X.shape[1], d)) if with_tproj else None
    log_sf2 = 0.25
    log_ms = rng.standard_normal((m, d)) * 0.4 if with_ms else None
    log_het = rng.standard_normal(m) - 2.0 if with_hetero else None
    p = SeFat.Params(
        d=d,
        log_sf2=jnp.asarray(log_sf2),
        tproj=None if tproj is None else jnp.asarray(tproj),
        log_hetero_skedasticity=None if log_het is None else jnp.asarray(log_het),
        log_multiscales_m05=None if log_ms is None else jnp.asarray(log_ms),
    )
    proj = X @ tproj if with_tproj else X
    Zr = proj[:m] + 0.1 * rng.standard_normal((m, d))
    Z = jnp.asarray(Zr)
    ms = np.exp(log_ms) + 0.5 if with_ms else None
    hetero = np.exp(log_het) if with_hetero else None

    np.testing.assert_allclose(
        np.asarray(SeFat.k_cross(p, jnp.asarray(X), Z)),
        se_fat_cross_ref(proj, Zr, log_sf2, ms),
        rtol=1e-10,
    )
    np.testing.assert_allclose(
        np.asarray(SeFat.k_upper(p, Z)),
        se_fat_upper_ref(Zr, log_sf2, ms, hetero),
        rtol=1e-10,
    )
    np.testing.assert_allclose(
        np.asarray(SeFat.k_diag(p, jnp.asarray(X))),
        np.full(n, np.exp(log_sf2)), rtol=1e-12
    )
    # full gram at inputs is vanilla-on-projections regardless of options
    # (lib/cov_se_fat.ml:221)
    kup = np.asarray(SeFat.k_upper_inputs(p, jnp.asarray(X)))
    ref = se_fat_upper_ref(proj, log_sf2, None, None)
    np.testing.assert_allclose(kup, ref, rtol=1e-10)


def test_se_fat_default_params(rng):
    X = jnp.asarray(rng.standard_normal((20, 15)) + 2.0)
    p = SeFat.default_params(X, n_inducing=6)
    assert p.d == 10
    assert p.tproj.shape == (15, 10)
    assert p.log_hetero_skedasticity.shape == (6,)
    assert p.log_multiscales_m05.shape == (6, 10)
    np.testing.assert_allclose(np.asarray(p.log_hetero_skedasticity), -5.0)


def test_sqdist_direct_matches_gemm(rng):
    """config.sqdist_impl='direct' (the accurate-mode elementwise form,
    probes/r5_accurate_fix.py at commit b587de6) must agree with the GEMM expansion to f64
    roundoff, keep the zero diagonal exactly, and stay differentiable."""
    import jax

    from gpr_tpu.config import config
    from gpr_tpu.kernels.base import sqdist

    A = jnp.asarray(rng.standard_normal((40, 5)))
    B = jnp.asarray(rng.standard_normal((17, 5)))
    d_gemm = np.asarray(sqdist(A, B))
    try:
        config.sqdist_impl = "direct"
        d_dir = np.asarray(sqdist(A, B))
        self_d = np.asarray(sqdist(A, A))
        g = jax.grad(lambda a: jnp.sum(sqdist(a, B) ** 2))(A)
    finally:
        config.sqdist_impl = "gemm"
    np.testing.assert_allclose(d_dir, d_gemm, rtol=1e-12, atol=1e-12)
    assert np.all(np.diag(self_d) == 0.0)
    assert np.all(np.isfinite(np.asarray(g)))
    # evidence parity through a full kernel family
    p = SeIso.Params(log_ell=jnp.asarray(0.3), log_sf2=jnp.asarray(0.1))
    k_gemm = np.asarray(SeIso.k_cross(p, A, B))
    try:
        config.sqdist_impl = "direct"
        k_dir = np.asarray(SeIso.k_cross(p, A, B))
    finally:
        config.sqdist_impl = "gemm"
    np.testing.assert_allclose(k_dir, k_gemm, rtol=1e-12, atol=1e-12)

"""Numerics core vs scipy (SURVEY.md section 7, stage 1)."""

import jax.numpy as jnp
import numpy as np
import scipy.linalg as sla

from gpr_tpu.numerics import (
    block_diag,
    cholesky_upper,
    ichol,
    inv_tri_upper,
    log_det_tri,
    qr_r_positive,
    rows_sqr_norm,
    solve_tri,
    solve_tri_right,
    tsqr_r,
)


def spd(rng, n):
    a = rng.standard_normal((n, n))
    return a @ a.T + n * np.eye(n)


def test_cholesky_upper(rng):
    a = spd(rng, 8)
    u = np.asarray(cholesky_upper(jnp.asarray(a), jitter=0.0))
    np.testing.assert_allclose(u, sla.cholesky(a, lower=False), rtol=1e-10)
    np.testing.assert_allclose(u.T @ u, a, rtol=1e-10)


def test_cholesky_jitter_applied(rng):
    a = spd(rng, 5)
    u = np.asarray(cholesky_upper(jnp.asarray(a), jitter=10.0))
    np.testing.assert_allclose(u.T @ u, a + 10.0 * np.eye(5), rtol=1e-10)


def test_log_det(rng):
    a = spd(rng, 6)
    u = cholesky_upper(jnp.asarray(a), jitter=0.0)
    np.testing.assert_allclose(
        float(log_det_tri(u)), np.linalg.slogdet(a)[1], rtol=1e-10
    )


def test_solve_tri(rng):
    a = spd(rng, 7)
    u = sla.cholesky(a, lower=False)
    b = rng.standard_normal((7, 3))
    x = np.asarray(solve_tri(jnp.asarray(u), jnp.asarray(b)))
    np.testing.assert_allclose(u @ x, b, rtol=1e-9, atol=1e-12)
    xt = np.asarray(solve_tri(jnp.asarray(u), jnp.asarray(b), trans=True))
    np.testing.assert_allclose(u.T @ xt, b, rtol=1e-9, atol=1e-12)


def test_solve_tri_right(rng):
    a = spd(rng, 6)
    u = sla.cholesky(a, lower=False)
    b = rng.standard_normal((4, 6))
    x = np.asarray(solve_tri_right(jnp.asarray(b), jnp.asarray(u)))
    np.testing.assert_allclose(x @ u, b, rtol=1e-9, atol=1e-12)


def test_ichol(rng):
    a = spd(rng, 6)
    u = sla.cholesky(a, lower=False)
    np.testing.assert_allclose(
        np.asarray(ichol(jnp.asarray(u))), np.linalg.inv(a), rtol=1e-8,
        atol=1e-12
    )


def test_inv_tri_upper(rng):
    u = np.triu(rng.standard_normal((5, 5))) + 3 * np.eye(5)
    np.testing.assert_allclose(
        np.asarray(inv_tri_upper(jnp.asarray(u))), np.linalg.inv(u), rtol=1e-9
    )


def test_rows_sqr_norm(rng):
    a = rng.standard_normal((5, 4))
    np.testing.assert_allclose(
        np.asarray(rows_sqr_norm(jnp.asarray(a))), np.sum(a * a, 1), rtol=1e-12
    )


def test_qr_r_positive_is_cholesky_of_gram(rng):
    a = rng.standard_normal((40, 6))
    r = np.asarray(qr_r_positive(jnp.asarray(a)))
    assert np.all(np.diag(r) > 0)
    np.testing.assert_allclose(r.T @ r, a.T @ a, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(r, sla.cholesky(a.T @ a, lower=False), rtol=1e-7)


def test_tsqr_matches_qr(rng):
    a = rng.standard_normal((64, 5))
    r1 = np.asarray(qr_r_positive(jnp.asarray(a)))
    r2 = np.asarray(tsqr_r(jnp.asarray(a), n_blocks=8))
    np.testing.assert_allclose(r1, r2, rtol=1e-8, atol=1e-10)


def test_block_diag_potrf_potri(rng):
    blocks = np.stack([spd(rng, 4) for _ in range(3)])
    bd = block_diag.create(jnp.asarray(blocks))
    ch = block_diag.potrf(bd)
    for i in range(3):
        np.testing.assert_allclose(
            np.asarray(ch.data[i]), sla.cholesky(blocks[i], lower=False),
            rtol=1e-9
        )
    inv = block_diag.potri(ch)
    for i in range(3):
        np.testing.assert_allclose(
            np.asarray(inv.data[i]), np.linalg.inv(blocks[i]), rtol=1e-8,
            atol=1e-12
        )


def test_block_diag_padded(rng):
    b1, b2 = spd(rng, 3), spd(rng, 5)
    bd = block_diag.create_padded([jnp.asarray(b1), jnp.asarray(b2)])
    assert bd.data.shape == (2, 5, 5)
    np.testing.assert_allclose(np.asarray(bd.data[0][:3, :3]), b1)
    np.testing.assert_allclose(np.asarray(bd.data[1]), b2)


def test_matmul_acc_precision_wiring():
    """config.acc_precision drives ONLY matmul_acc; matmul keeps the global.

    The precision attribute is checked in the traced jaxpr (it is a no-op
    numerically on CPU), pinning the accumulation-GEMM knob introduced after
    an earlier per-site error split (a probe at commit b587de6)
    measured those GEMMs precision-insensitive.
    """
    import jax
    from gpr_tpu.config import config
    from gpr_tpu.numerics.linalg import matmul, matmul_acc

    def prec_of(fn):
        # fresh lambda per trace: make_jaxpr caches on function identity, so
        # re-tracing the same function after a config change returns the
        # stale jaxpr (the documented trace-time-config caveat, config.py)
        wrapped = lambda a, b: fn(a, b)  # noqa: E731
        jaxpr = jax.make_jaxpr(wrapped)(jnp.ones((4, 4)), jnp.ones((4, 4)))
        (eqn,) = [e for e in jaxpr.jaxpr.eqns if e.primitive.name == "dot_general"]
        return eqn.params["precision"]

    old_mp, old_ap = config.matmul_precision, config.acc_precision
    try:
        config.matmul_precision = "highest"
        config.acc_precision = "high"
        assert prec_of(matmul) == (jax.lax.Precision.HIGHEST,) * 2
        assert prec_of(matmul_acc) == (jax.lax.Precision.HIGH,) * 2
        config.acc_precision = None  # None = follow the global
        assert prec_of(matmul_acc) == (jax.lax.Precision.HIGHEST,) * 2
    finally:
        config.matmul_precision, config.acc_precision = old_mp, old_ap

"""IFT (implicit) vs unrolled gradients for every Laplace-family model.

The round-5 change (models/ift.py, VERDICT.md r4 #1 at commit b587de6): hyper gradients of the
non-Gaussian evidences come from a custom_vjp implicit-function-theorem
backward (one Woodbury solve + one kernel VJP) instead of jax.grad through
the remat'ed Newton sweeps.  At a converged mode the two routes are the
same derivative, so grad_impl="ift" and grad_impl="unroll" must agree to
tight f64 tolerance — values bit-identical (same forward), gradients to
the mode-convergence floor.  The independent-oracle and FD gates live in
the per-family test files; this file pins the two routes against each
other, including the likelihood-parameter legs (NB dispersion, ordinal
cutpoints) and the sharded mesh path.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import jax.tree_util as jtu

from gpr_tpu.kernels import SeIso


N, M = 160, 9


@pytest.fixture(scope="module")
def prior_inputs():
    rng = np.random.default_rng(3)
    X = jnp.asarray(rng.standard_normal((N, 2)))
    Z = X[:M]
    p = SeIso.Params(log_ell=jnp.asarray(0.25), log_sf2=jnp.asarray(0.1))
    return X, Z, p


def _compare(ev_fn, args):
    """value+grad of ev_fn(params, z, *extra) under both grad routes."""
    outs = {}
    for impl in ("unroll", "ift"):
        val, grads = jax.value_and_grad(
            lambda a: ev_fn(*a, impl), argnums=0
        )(args)
        outs[impl] = (float(val), grads)
    v_u, g_u = outs["unroll"]
    v_i, g_i = outs["ift"]
    assert v_u == pytest.approx(v_i, abs=1e-9)
    for lu, li in zip(jtu.tree_leaves(g_u), jtu.tree_leaves(g_i)):
        np.testing.assert_allclose(np.asarray(lu), np.asarray(li),
                                   rtol=1e-6, atol=1e-8)


def test_classify_ift_matches_unroll(prior_inputs):
    from gpr_tpu.models.classify import classify_log_evidence

    X, Z, p = prior_inputs
    y = jnp.asarray(np.sign(np.random.default_rng(0).standard_normal(N)))

    def ev(params, z, impl):
        return classify_log_evidence(SeIso, params, z, X, y,
                                     newton_iters=15, grad_impl=impl)

    _compare(ev, (p, Z))


def test_poisson_ift_matches_unroll(prior_inputs):
    from gpr_tpu.models.poisson import poisson_log_evidence

    X, Z, p = prior_inputs
    rng = np.random.default_rng(1)
    y = jnp.asarray(rng.poisson(2.0, N).astype(np.float64))
    le = jnp.asarray(0.2 * rng.standard_normal(N))

    def ev(params, z, impl):
        return poisson_log_evidence(SeIso, params, z, X, y,
                                    log_exposure=le, newton_iters=20,
                                    grad_impl=impl)

    _compare(ev, (p, Z))


def test_binomial_ift_matches_unroll(prior_inputs):
    from gpr_tpu.models.binomial import binomial_log_evidence

    X, Z, p = prior_inputs
    rng = np.random.default_rng(2)
    trials = jnp.asarray(rng.integers(1, 9, N).astype(np.float64))
    y = jnp.asarray(rng.binomial(np.asarray(trials, int), 0.4)
                    .astype(np.float64))

    def ev(params, z, impl):
        return binomial_log_evidence(SeIso, params, z, X, y, trials,
                                     newton_iters=15, grad_impl=impl)

    _compare(ev, (p, Z))


def test_negbin_ift_matches_unroll_incl_dispersion(prior_inputs):
    from gpr_tpu.models.negbin import negbin_log_evidence

    X, Z, p = prior_inputs
    rng = np.random.default_rng(4)
    y = jnp.asarray(rng.poisson(3.0, N).astype(np.float64))

    def ev(args, impl):
        params, z, log_r = args
        return negbin_log_evidence(SeIso, params, z, X, y,
                                   jnp.exp(log_r), newton_iters=20,
                                   grad_impl=impl)

    outs = {}
    args = (p, Z, jnp.asarray(0.7))
    for impl in ("unroll", "ift"):
        val, grads = jax.value_and_grad(lambda a: ev(a, impl))(args)
        outs[impl] = (float(val), grads)
    v_u, g_u = outs["unroll"]
    v_i, g_i = outs["ift"]
    assert v_u == pytest.approx(v_i, abs=1e-9)
    # the dispersion leg rides the IFT likelihood-parameter path
    for lu, li in zip(jtu.tree_leaves(g_u), jtu.tree_leaves(g_i)):
        np.testing.assert_allclose(np.asarray(lu), np.asarray(li),
                                   rtol=1e-6, atol=1e-8)


def test_ordinal_ift_matches_unroll_incl_cutpoints(prior_inputs):
    from gpr_tpu.models.ordinal import (
        default_cutpoint_raw,
        ordinal_log_evidence,
    )

    X, Z, p = prior_inputs
    rng = np.random.default_rng(5)
    y = jnp.asarray(rng.integers(0, 4, N))
    cut0 = default_cutpoint_raw(4)

    def ev(args, impl):
        params, z, cut_raw = args
        return ordinal_log_evidence(SeIso, params, z, X, y, cut_raw,
                                    newton_iters=20, grad_impl=impl)

    outs = {}
    args = (p, Z, cut0)
    for impl in ("unroll", "ift"):
        val, grads = jax.value_and_grad(lambda a: ev(a, impl))(args)
        outs[impl] = (float(val), grads)
    v_u, g_u = outs["unroll"]
    v_i, g_i = outs["ift"]
    assert v_u == pytest.approx(v_i, abs=1e-9)
    for lu, li in zip(jtu.tree_leaves(g_u), jtu.tree_leaves(g_i)):
        np.testing.assert_allclose(np.asarray(lu), np.asarray(li),
                                   rtol=1e-6, atol=1e-8)


def test_multiclass_ift_matches_unroll(prior_inputs):
    from gpr_tpu.models.classify_multi import multiclass_log_evidence

    X, Z, p = prior_inputs
    labels = jnp.asarray(np.random.default_rng(6).integers(0, 3, N))

    def ev(params, z, impl):
        return multiclass_log_evidence(SeIso, params, z, X, labels, 3,
                                       newton_iters=15, grad_impl=impl)

    _compare(ev, (p, Z))


@pytest.mark.slow
def test_sharded_classify_ift_grad_matches_single(prior_inputs):
    """The mesh objective (now IFT under shard_map) == single-device IFT."""
    from jax.sharding import Mesh

    from gpr_tpu.models.classify import classify_log_evidence
    from gpr_tpu.parallel import shard_batch
    from gpr_tpu.parallel.classify_sharded import (
        sharded_classify_log_evidence,
    )

    X, Z, p = prior_inputs
    y = jnp.asarray(np.sign(np.random.default_rng(0).standard_normal(N)))
    mesh = Mesh(np.array(jax.devices()[:8]), ("data",))
    Xs, ys, mask = shard_batch(mesh, X, y)

    def single(args):
        params, z = args
        return classify_log_evidence(SeIso, params, z, X, y,
                                     newton_iters=12)

    def sharded(args):
        params, z = args
        return sharded_classify_log_evidence(
            SeIso, mesh, params, z, Xs, ys, mask, newton_iters=12
        )

    v1, g1 = jax.jit(jax.value_and_grad(single))((p, Z))
    v2, g2 = jax.jit(jax.value_and_grad(sharded))((p, Z))
    assert float(v1) == pytest.approx(float(v2), rel=1e-10)
    for l1, l2 in zip(jtu.tree_leaves(g1), jtu.tree_leaves(g2)):
        np.testing.assert_allclose(np.asarray(l1), np.asarray(l2),
                                   rtol=1e-7, atol=1e-9)


def test_ep_stationary_matches_unroll(prior_inputs):
    """GPML 5.5.2: at a converged EP fixed point the stationary-gradient
    route (stop_gradient on sites) equals differentiating through the
    sweeps.  Run enough damped sweeps that the fixed point is tight."""
    from gpr_tpu.models.classify_ep import ep_log_evidence

    X, Z, p = prior_inputs
    y = jnp.asarray(np.sign(np.random.default_rng(7).standard_normal(N)))

    outs = {}
    for impl in ("unroll", "stationary"):
        val, grads = jax.value_and_grad(
            lambda a: ep_log_evidence(SeIso, a[0], a[1], X, y,
                                      n_sweeps=60, grad_impl=impl)
        )((p, Z))
        outs[impl] = (float(val), grads)
    v_u, g_u = outs["unroll"]
    v_s, g_s = outs["stationary"]
    assert v_u == pytest.approx(v_s, abs=1e-10)  # same forward
    for lu, ls in zip(jtu.tree_leaves(g_u), jtu.tree_leaves(g_s)):
        np.testing.assert_allclose(np.asarray(lu), np.asarray(ls),
                                   rtol=1e-5, atol=1e-7)


def test_streaming_ift_matches_unroll_and_materialized(prior_inputs):
    """The streaming fixed point (_stream_fixed_point) must reproduce the
    unrolled streaming gradient AND the materialized IFT gradient —
    including a likelihood-parameter leg (ordinal cutpoints ride lik with
    lik_is_row=(True, False))."""
    from gpr_tpu.models.ordinal import (
        default_cutpoint_raw,
        ordinal_log_evidence,
    )

    X, Z, p = prior_inputs
    rng = np.random.default_rng(8)
    y = jnp.asarray(rng.integers(0, 3, N))
    cut0 = default_cutpoint_raw(3)
    args = (p, Z, cut0)

    def ev(args, block, impl):
        params, z, cut_raw = args
        return ordinal_log_evidence(SeIso, params, z, X, y, cut_raw,
                                    newton_iters=20, block_size=block,
                                    grad_impl=impl)

    v_mat, g_mat = jax.value_and_grad(lambda a: ev(a, None, "ift"))(args)
    v_su, g_su = jax.value_and_grad(lambda a: ev(a, 48, "unroll"))(args)
    v_si, g_si = jax.value_and_grad(lambda a: ev(a, 48, "ift"))(args)
    assert float(v_su) == pytest.approx(float(v_si), abs=1e-9)
    assert float(v_mat) == pytest.approx(float(v_si), rel=1e-10)
    for lm, lu, li in zip(jtu.tree_leaves(g_mat), jtu.tree_leaves(g_su),
                          jtu.tree_leaves(g_si)):
        np.testing.assert_allclose(np.asarray(li), np.asarray(lu),
                                   rtol=1e-6, atol=1e-8)
        np.testing.assert_allclose(np.asarray(li), np.asarray(lm),
                                   rtol=1e-6, atol=1e-8)


def test_streaming_multiclass_ift_matches_unroll_and_materialized(
    prior_inputs,
):
    """The streaming softmax fixed point (_stream_softmax_fixed_point)
    must reproduce the unrolled streaming gradient AND the materialized
    softmax-IFT gradient — the last Laplace-family member to move off the
    unrolled backward (VERDICT.md r4 #1 / NEXT.md round-5 note, at commit
    b587de6)."""
    from gpr_tpu.models.classify_multi import multiclass_log_evidence
    from gpr_tpu.models.classify_multi_stream import (
        stream_multiclass_log_evidence,
    )

    X, Z, p = prior_inputs
    rng = np.random.default_rng(11)
    labels = jnp.asarray(rng.integers(0, 3, N))
    args = (p, Z)

    def ev_mat(args):
        return multiclass_log_evidence(SeIso, *args, X, labels, 3,
                                       newton_iters=25, grad_impl="ift")

    def ev_stream(args, impl):
        return stream_multiclass_log_evidence(
            SeIso, *args, X, labels, 3, block_size=48, newton_iters=25,
            grad_impl=impl,
        )

    v_mat, g_mat = jax.value_and_grad(ev_mat)(args)
    v_su, g_su = jax.value_and_grad(lambda a: ev_stream(a, "unroll"))(args)
    v_si, g_si = jax.value_and_grad(lambda a: ev_stream(a, "ift"))(args)
    # f_hat is recovered as K a by two extra sweeps in ift mode (the unroll
    # path reuses the scan's running blend) — same math, reordered f64
    # accumulation, so the values agree to ~1e-9 relative, not bitwise
    assert float(v_su) == pytest.approx(float(v_si), abs=1e-7)
    assert float(v_mat) == pytest.approx(float(v_si), rel=1e-9)
    for lm, lu, li in zip(jtu.tree_leaves(g_mat), jtu.tree_leaves(g_su),
                          jtu.tree_leaves(g_si)):
        np.testing.assert_allclose(np.asarray(li), np.asarray(lu),
                                   rtol=1e-6, atol=1e-8)
        np.testing.assert_allclose(np.asarray(li), np.asarray(lm),
                                   rtol=1e-6, atol=1e-8)

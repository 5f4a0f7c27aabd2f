"""Batched multi-task GPs: B independent sparse GPs in one jitted program.

No reference counterpart (the reference is strictly one model per process);
this is the accelerator-natural extension: because the whole engine is pure
functions over PyTrees, ``jax.vmap`` lifts evidence, gradients, training
steps, and prediction over a leading task axis — the per-task m x m
factorizations batch into single kernels (XLA batches Cholesky/triangular solves),
and one device dispatch trains B models.

Typical uses: per-output GPs of a multi-output problem, per-segment models,
hyperparameter multi-starts (same data, stacked initializations — see
``multi_start``).

Shapes: stacked leaves carry a leading task axis B — params (B, ...),
Z (B, m, dz), sigma2 (B,), X (B, n, d) or shared (n, d), y (B, n).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .fitc import log_evidence
from .streaming import streaming_log_evidence


def batched_log_evidence(
    family, params, z, sigma2, X, y, *, shared_inputs=None,
    variational=False, factorization="chol", block_size=None,
):
    """(B,) evidence vector.  Pass ``shared_inputs=X`` (n, d) instead of
    ``X`` when all tasks see the same inputs (multi-output regression):
    the kernel tile then broadcasts instead of duplicating."""

    def one(params, z, sigma2, X, y):
        if block_size is not None:
            return streaming_log_evidence(
                family, params, z, sigma2, X, y,
                variational=variational, block_size=block_size,
            )
        return log_evidence(
            family, params, z, sigma2, X, y,
            variational=variational, factorization=factorization,
        )

    if shared_inputs is not None:
        return jax.vmap(
            lambda p, zz, s2, yy: one(p, zz, s2, shared_inputs, yy)
        )(params, z, sigma2, y)
    return jax.vmap(one)(params, z, sigma2, X, y)


def batched_value_and_grad(family, **kw):
    """Jitted ((B,) neg-evidence, per-task grads) over stacked
    (params, z, sigma2, X, y).

    The per-task gradients are exact and independent (vmap of grad); sum-
    reduce externally if a single scalar objective is wanted.
    """

    @jax.jit
    def vg(params, z, sigma2, X, y):
        def per_task(p, zz, s2, xx, yy):
            def f(p, zz, s2):
                if kw.get("block_size") is not None:
                    return -streaming_log_evidence(
                        family, p, zz, s2, xx, yy,
                        variational=kw.get("variational", False),
                        block_size=kw["block_size"],
                    )
                return -log_evidence(
                    family, p, zz, s2, xx, yy,
                    variational=kw.get("variational", False),
                    factorization=kw.get("factorization", "chol"),
                )

            return jax.value_and_grad(f, argnums=(0, 1, 2))(p, zz, s2)

        return jax.vmap(per_task)(params, z, sigma2, X, y)

    return vg


def multi_start(family, X, y, packs_x0, unpack, *, variational=False,
                factorization="chol", steps=100, lr=1e-3):
    """Hyperparameter multi-start: gradient-ascend S stacked packed vectors
    on the SAME data in one jitted loop; returns (best_x, all_final_l).

    A pragmatic accelerator answer to restart loops: S optimizations cost one batched
    program, so restarts are nearly free up to memory.
    """

    @jax.jit
    def run(xs, X, y):
        def neg_l(x):
            params, z, sigma2 = unpack(x)
            return -log_evidence(
                family, params, z, sigma2, X, y,
                variational=variational, factorization=factorization,
            )

        def step(xs, _):
            ls, gs = jax.vmap(jax.value_and_grad(neg_l))(xs)
            return xs - lr * gs, ls

        xs, _ = jax.lax.scan(step, xs, None, length=steps)
        final = jax.vmap(neg_l)(xs)
        return xs, -final

    xs, ls = run(jnp.asarray(packs_x0), X, y)
    best = jnp.argmax(ls)
    return xs[best], ls

"""Data-parallel iterative exact GP (models/iterative.py over a 1-D mesh).

The exact-GP matvec ``(K + sigma2 I) v`` is the textbook thing to shard:
rows of X (and of every CG vector) live on their shard, and the product's
cross-shard coupling K(X_local, X_remote) v_remote is computed by an interconnect
ring — each of the P-1 hops ppermutes one (n/P, d) input block and one
(n/P, r) vector block to the neighbor and folds one local tile GEMM into
the accumulator (the same ring pattern as parallel/dist_chol.py).  Nothing
n x n ever exists anywhere; per-device transient memory is one
(block, n/P) tile, and the ring traffic per matvec is (P-1)(n/P)(d + r)
floats riding the interconnect.

The CG iteration itself is unchanged (models/iterative.pcg with its
column reductions psum'ed), and the Nystrom/FITC preconditioner shards by
rows with one m x m psum Gram — exactly the sparse engine's distribution
story, because the preconditioner IS the sparse model.

No reference counterpart (the reference is sparse-only and single-process,
lib/fitc_gp.ml); SURVEY.md section 2.4's data-parallel row applies.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from ..kernels.base import cross_inputs
from ..models.iterative import NystromPrecond, pcg
from ..numerics.linalg import (
    cholesky_upper,
    inv_tri_upper,
    matmul,
    rows_sqr_norm,
)
from .sharded import DATA_AXIS


def _allsum(x):
    return lax.psum(x, DATA_AXIS)


def _ring_matvec(family, params, xs, v, sigma2, mask, n_shards,
                 block_size):
    """(K + sigma2 I) v over row shards by a P-hop ppermute ring.

    ``xs`` (n_local, d), ``v`` (n_local, r) — masked rows of v must be 0
    (they then contribute nothing to any tile product); the output's
    masked rows are re-zeroed.  Each hop contracts the local rows against
    one remote shard's (inputs, vector) pair, then rotates that pair one
    neighbor down the ring.
    """
    perm = [(i, (i + 1) % n_shards) for i in range(n_shards)]
    nb = -(-xs.shape[0] // block_size)
    pad = nb * block_size - xs.shape[0]
    xs_b = (jnp.concatenate(
        [xs, jnp.zeros((pad, xs.shape[1]), xs.dtype)]) if pad else xs
    ).reshape(nb, block_size, xs.shape[1])

    def tile_product(x_rot, v_rot):
        def step(_, x_blk):
            tile = cross_inputs(family, params, x_blk, x_rot)
            return None, matmul(tile, v_rot)

        _, out = lax.scan(step, None, xs_b)
        return out.reshape(-1, v.shape[1])[: xs.shape[0]]

    def hop(carry, _):
        out, x_rot, v_rot = carry
        out = out + tile_product(x_rot, v_rot)
        x_rot = lax.ppermute(x_rot, DATA_AXIS, perm)
        v_rot = lax.ppermute(v_rot, DATA_AXIS, perm)
        return (out, x_rot, v_rot), None

    (out, _, _), _ = lax.scan(
        hop, (jnp.zeros_like(v), xs, v), None, length=n_shards
    )
    # diagonal correction to the model's own variances + noise (the ring
    # tiles put the cross form's self-value on the diagonal)
    cross_self = jax.vmap(
        lambda x: cross_inputs(family, params, x[None, :], x[None, :])[0, 0]
    )(xs)
    out = out + (family.k_diag(params, xs) - cross_self + sigma2
                 )[:, None] * v
    return out * mask[:, None]


def _sharded_precond(family, params, xs, sigma2, x_sub, mask):
    """Row-local Nystrom/FITC preconditioner; the m x m Gram is the one
    cross-shard object (psum).  Masked rows get d = 1, v = 0 — P acts as
    the identity there, and masked CG residuals are 0 anyway."""
    km = family.k_upper_inputs(params, x_sub)
    u_inv = inv_tri_upper(cholesky_upper(km, None))
    v = matmul(cross_inputs(family, params, xs, x_sub), u_inv)
    v = v * mask[:, None]
    lam = jnp.maximum(family.k_diag(params, xs) - rows_sqr_norm(v), 0.0)
    d = jnp.where(mask > 0, lam + sigma2, 1.0)
    vd = v / d[:, None]
    c = jnp.eye(v.shape[1], dtype=v.dtype) + _allsum(matmul(v.T, vd))
    pre = NystromPrecond(v=v, d=d, chol_c=cholesky_upper(c, 0.0))

    def apply(r):
        squeeze = r.ndim == 1
        rr = r[:, None] if squeeze else r
        rd = rr / pre.d[:, None]
        w = _allsum(matmul(pre.v.T, rd))
        from ..numerics.linalg import solve_tri

        w = solve_tri(pre.chol_c, solve_tri(pre.chol_c, w, trans=True))
        out = rd - matmul(pre.v, w) / pre.d[:, None]
        return out[:, 0] if squeeze else out

    return apply


def sharded_iter_solve(
    family,
    mesh: Mesh,
    params,
    X,
    B,
    sigma2,
    X_sub,
    mask=None,
    *,
    tol: float = 1e-6,
    max_iter: int = 200,
    block_size: int = 4096,
):
    """Solve (K + sigma2 I) x = B over the mesh: X and B row-sharded,
    ``X_sub`` (m, d) anchor rows replicated.  Returns (x, iters, relres)
    with x sharded like B.  Wrap in jax.jit.
    """
    if mask is None:
        mask = jnp.ones((X.shape[0],), X.dtype)
    squeeze = B.ndim == 1
    if squeeze:
        B = B[:, None]
    n_shards = mesh.devices.size

    def shard_fn(params, xs, bs, ms, x_sub):
        bs = bs * ms[:, None]
        pre = _sharded_precond(family, params, xs, sigma2, x_sub, ms)

        def mv(v):
            return _ring_matvec(family, params, xs, v, sigma2, ms,
                                n_shards, block_size)

        x, info = pcg(mv, bs, precond=pre, tol=tol, max_iter=max_iter,
                      colsum=lambda t: _allsum(jnp.sum(t, axis=0)))
        return x, info["iters"], info["relres"]

    fn = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(), P(DATA_AXIS, None), P(DATA_AXIS, None),
                  P(DATA_AXIS), P()),
        out_specs=(P(DATA_AXIS, None), P(), P()),
        check_vma=False,
    )
    x, iters, relres = fn(params, X, B, mask, X_sub)
    return (x[:, 0] if squeeze else x), iters, relres

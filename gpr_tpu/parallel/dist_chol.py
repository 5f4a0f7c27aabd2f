"""Distributed block Cholesky + triangular solve over a mesh axis.

For m beyond ~3x10^4 the replicated m x m epilogue of mesh2d stops fitting
per-chip memory.  Here the data Gram stays *column-block sharded* over the
model axis end to end:

  * :func:`dist_cholesky_upper` factors a symmetric PSD A (as column blocks
    A_j of shape (m, m_t)) into upper R with R'R = A, one block column per
    mesh member.  Right-looking over p = mesh-axis-size block steps; per
    step one psum-broadcast of the (m_t, m_t) diagonal factor and one
    all_gather of the (m_t, m) row block — peak per-chip memory O(m^2 / p),
    total traffic m^2 floats (what one all_gather of the Gram would move,
    without ever materializing it).
  * :func:`dist_solve_lower_t` forward-substitutes R' t = u blockwise,
    broadcasting each solved (m_t,) piece.
  * :func:`dist_log_det_tri` reduces the local diagonal blocks.

The uniform-SPMD trick: at step k every member solves
``R_kj = R_kk^-T S_kj`` on its own rows-k slab; for the owner (j == k) this
identity returns exactly R_kk (R_kk^-T A_kk = R_kk), and for j < k the
result is masked to zero — no control-flow divergence between members.

Reference contrast: the reference's factorizations are single-process LAPACK
potrf calls (lib/fitc_gp.ml:168-183); distribution has no counterpart there
(SURVEY.md section 2.4).
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

from ..numerics.linalg import cholesky_upper, log_det_tri, matmul, solve_tri


def dist_cholesky_upper(a_j: jnp.ndarray, axis: str, p: int) -> jnp.ndarray:
    """Column block R_j of upper R with R'R = A.

    ``a_j``: this member's (m, m_t) column block of symmetric PSD A;
    ``axis``: mesh axis name the blocks shard over; ``p``: axis size
    (static).  Requires m == p * m_t.
    """
    m, m_t = a_j.shape
    if m != p * m_t:
        raise ValueError(f"column block {a_j.shape} inconsistent with p={p}")
    j = lax.axis_index(axis)
    s_j = a_j
    r_j = jnp.zeros_like(a_j)
    for k in range(p):
        s_kj = lax.dynamic_slice_in_dim(s_j, k * m_t, m_t, axis=0)
        # broadcast the owner's diagonal block (psum of a one-hot selection)
        dkk = lax.psum(jnp.where(j == k, s_kj, 0.0), axis)
        r_kk = cholesky_upper(dkk, jitter=0.0)
        r_kj = solve_tri(r_kk, s_kj, trans=True)  # == r_kk when j == k
        r_kj = jnp.where(j >= k, r_kj, 0.0)
        r_j = lax.dynamic_update_slice_in_dim(r_j, r_kj, k * m_t, axis=0)
        if k + 1 < p:
            # gather row block R_k (masked pieces left of the diagonal are 0)
            r_k = lax.all_gather(r_kj, axis, axis=1, tiled=True)  # (m_t, m)
            s_j = s_j - matmul(r_k.T, r_kj)
    return r_j


def dist_log_det_tri(r_j: jnp.ndarray, axis: str) -> jnp.ndarray:
    """log det(R'R) = 2 sum log diag(R) from column blocks."""
    m, m_t = r_j.shape
    j = lax.axis_index(axis)
    diag_block = lax.dynamic_slice_in_dim(r_j, j * m_t, m_t, axis=0)
    return lax.psum(log_det_tri(diag_block), axis)


def dist_solve_lower_cols(r_j: jnp.ndarray, b_own: jnp.ndarray, axis: str,
                          p: int) -> jnp.ndarray:
    """Y with R' Y = B (forward substitution), R upper column-sharded
    (m, m_t); ``b_own`` (m, k) is THIS member's private right-hand-side
    columns (each member solves its own k).  Row block k of R' is member
    k's column block transposed, broadcast per step — total traffic m^2
    floats, peak memory O(m^2/p)."""
    m, m_t = r_j.shape
    jidx = lax.axis_index(axis)
    y = jnp.zeros_like(b_own)
    for k in range(p):
        rc_k = lax.psum(jnp.where(jidx == k, r_j, 0.0), axis)  # (m, m_t)
        r_kk = lax.dynamic_slice_in_dim(rc_k, k * m_t, m_t, axis=0)
        # partial = sum_{i<k} R_ik' Y_i: unsolved rows of y are zero, so one
        # fresh GEMM against the full column block gives exactly that sum
        partial = matmul(rc_k.T, y)  # (m_t, k)
        rhs = lax.dynamic_slice_in_dim(b_own, k * m_t, m_t, axis=0) - partial
        y_k = solve_tri(r_kk, rhs, trans=True)
        y = lax.dynamic_update_slice_in_dim(y, y_k, k * m_t, axis=0)
    return y


def dist_solve_upper_cols(r_j: jnp.ndarray, b_own: jnp.ndarray, axis: str,
                          p: int) -> jnp.ndarray:
    """X with R X = B (back substitution), same layout conventions as
    :func:`dist_solve_lower_cols`.  Row block k of R is gathered (each
    member contributes its (m_t, m_t) slice)."""
    m, m_t = r_j.shape
    x = jnp.zeros_like(b_own)
    for k in reversed(range(p)):
        r_k = lax.all_gather(
            lax.dynamic_slice_in_dim(r_j, k * m_t, m_t, axis=0),
            axis, axis=1, tiled=True,
        )  # (m_t, m)
        r_kk = lax.dynamic_slice_in_dim(r_k, k * m_t, m_t, axis=1)
        partial = matmul(r_k, x)  # only solved (higher) rows contribute
        rhs = lax.dynamic_slice_in_dim(b_own, k * m_t, m_t, axis=0) - partial
        x_k = solve_tri(r_kk, rhs)
        x = lax.dynamic_update_slice_in_dim(x, x_k, k * m_t, axis=0)
    return x


def dist_spd_inverse_cols(a_chol_j: jnp.ndarray, axis: str,
                          p: int) -> jnp.ndarray:
    """Column block of A^-1 from A's distributed Cholesky factor:
    P_j = U^-1 U^-T I_j via the two distributed solves.  The building block
    of the fully distributed inducing factorization (Km^-1 columns)."""
    m, m_t = a_chol_j.shape
    jidx = lax.axis_index(axis)
    rows = jnp.arange(m)[:, None]
    cols = (jidx * m_t + jnp.arange(m_t))[None, :]
    eye_j = jnp.where(rows == cols, jnp.ones((), a_chol_j.dtype), 0.0)
    y = dist_solve_lower_cols(a_chol_j, eye_j, axis, p)
    return dist_solve_upper_cols(a_chol_j, y, axis, p)


def dist_transpose_cols(w_j: jnp.ndarray, axis: str, p: int) -> jnp.ndarray:
    """Column blocks of W -> column blocks of W' via a p-step ppermute ring.

    Member j holds W[:, cols_j] (m, m_t) and needs W'[:, cols_j] = the row
    slab W[rows_j, :] transposed; chunk (rows_j, cols_k) lives on member k.
    Step t: member ``src`` sends its chunk ``rows_{(src+t) % p}`` to member
    ``(src+t) % p``, which files it under column block ``(j-t) % p`` — p-1
    shifts of one (m_t, m_t) tile each, m^2/p floats total per member (the
    same traffic as one all_to_all, which would do this in one collective —
    but ``lax.all_to_all``'s reverse mode mis-tags the cotangent's device
    variance under ``check_vma=False`` in current jax, while the ring's
    transpose is simply the inverted ring).
    """
    m, m_t = w_j.shape
    j = lax.axis_index(axis)
    zero = jnp.zeros((), j.dtype)
    slab = jnp.zeros((m_t, m), w_j.dtype)
    for t in range(p):
        send_row = ((j + t) % p) * m_t
        chunk = lax.dynamic_slice(w_j, (send_row, zero), (m_t, m_t))
        if t:
            perm = [(src, (src + t) % p) for src in range(p)]
            chunk = lax.ppermute(chunk, axis, perm)
        recv_col = ((j - t) % p) * m_t
        slab = lax.dynamic_update_slice(slab, chunk, (zero, recv_col))
    return slab.T


def dist_whiten_cols(u_j: jnp.ndarray, g_j: jnp.ndarray, axis: str,
                     p: int) -> jnp.ndarray:
    """Column blocks of the two-sided whitening U^-T G U^-1 (G symmetric,
    U upper with U'U = Km) from column blocks of U and G.

    Two distributed forward substitutions around one distributed transpose,
    exploiting symmetry: with W = U^-T G,

        U^-T W' = (W U^-1)' = (U^-T G U^-1)' = U^-T G U^-1.

    This is what makes the raw (unwhitened) Gram usable where no member may
    hold an m x m matrix: accumulate G as column blocks, whiten here, factor
    I + G~ with :func:`dist_cholesky_upper` — O(m^2/p) per-chip memory end
    to end (NEXT.md round-2 at commit b587de6: previously 'structurally
    blocked').
    """
    w_j = dist_solve_lower_cols(u_j, g_j, axis, p)
    t_j = dist_transpose_cols(w_j, axis, p)
    return dist_solve_lower_cols(u_j, t_j, axis, p)


def whiten_cols_replicated(chol_km: jnp.ndarray, g_j: jnp.ndarray, axis: str,
                           p: int) -> jnp.ndarray:
    """Column blocks of U^-T G U^-1 when the inducing factor U = chol_km is
    replicated (mesh2d's ``inducing="replicated"``): the two triangular
    solves are local; only the transpose moves data."""
    w_j = solve_tri(chol_km, g_j, trans=True)
    t_j = dist_transpose_cols(w_j, axis, p)
    return solve_tri(chol_km, t_j, trans=True)


def dist_solve_lower_t(r_j: jnp.ndarray, u: jnp.ndarray, axis: str,
                       p: int) -> jnp.ndarray:
    """t with R' t = u (forward substitution), R given as column blocks.

    ``u`` (m,) is replicated; returns t (m,) replicated.  Row block k of R'
    is this member's column block transposed, so member k solves its own
    diagonal system and the solved piece is psum-broadcast (m_t floats per
    step).
    """
    m, m_t = r_j.shape
    j = lax.axis_index(axis)
    eye = jnp.eye(m_t, dtype=r_j.dtype)
    t = jnp.zeros((m,), r_j.dtype)
    for k in range(p):
        u_k = lax.dynamic_slice_in_dim(u, k * m_t, m_t)
        # member k: acc = R[0:k rows, k col-block]' t[0:k] using its own block
        acc = matmul(r_j.T, t)  # (m_t,) = (R_col_j)' t; valid on member k
        rhs = u_k - acc
        r_kk = lax.dynamic_slice_in_dim(r_j, k * m_t, m_t, axis=0)
        # R_kk' t_k = rhs; only member k holds the true diagonal block.  The
        # others solve a gated identity system (their slab can have zero
        # diagonals, and a masked-but-NaN primal poisons reverse mode — the
        # double-where pattern, see models/streaming.py).
        owner = j == k
        t_k = solve_tri(
            jnp.where(owner, r_kk, eye), jnp.where(owner, rhs, 0.0),
            trans=True,
        )
        t_k = lax.psum(jnp.where(owner, t_k, 0.0), axis)
        t = lax.dynamic_update_slice_in_dim(t, t_k, k * m_t, axis=0)
    return t

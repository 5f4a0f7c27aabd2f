"""Dense numerics core: the JAX replacement of the reference's L0/L1.

The reference delegates to Lacaml/LAPACK (``potrf``, ``potri``, ``trtrs``,
``geqrf``/``orgqr``, ``trsm``, ``syrk``; see lib/utils.ml:95-113 and
lib/fitc_gp.ml) — here every op is an XLA primitive.

Conventions (differ deliberately from the reference's Fortran layout):
  * inputs are row-major: X has shape (n, d); the feature axis is minor.
  * Cholesky factors are UPPER triangular U with A = U^T U, matching LAPACK
    ``potrf uplo=U`` as used by the reference (so formulas in test/oct.m
    transliterate directly).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from ..config import config


_PRECISIONS = {
    "highest": lax.Precision.HIGHEST,
    "high": lax.Precision.HIGH,
    "default": lax.Precision.DEFAULT,
}


def _to_precision(name: str) -> lax.Precision:
    try:
        return _PRECISIONS[name]
    except KeyError:
        raise ValueError(
            f"unknown matmul precision {name!r}; valid: "
            f"{sorted(_PRECISIONS)}"
        ) from None


def _precision():
    return _to_precision(config.matmul_precision)


def matmul(a, b):
    """matmul at the configured precision (config.matmul_precision)."""
    return jnp.matmul(a, b, precision=_precision())


def matmul_acc(a, b):
    """matmul for whitened-accumulation GEMMs (config.acc_precision).

    The streaming evidence's ``gram += a'a`` / ``u_vec += v'(is*y)`` sites
    are measured insensitive to GEMM precision (see config.acc_precision);
    everything else should use :func:`matmul`.
    """
    return jnp.matmul(
        a, b,
        precision=_to_precision(config.acc_precision
                                or config.matmul_precision),
    )


def cholesky_upper(a: jnp.ndarray, jitter: float | None = None) -> jnp.ndarray:
    """Upper-triangular U with ``a + jitter*I = U^T U``.

    Reference: ``lacpy ~uplo:`U``; ``Mat.add_const_diag jitter``; ``potrf``
    (lib/fitc_gp.ml:53-57).  Jitter defaults to ``config.cholesky_jitter``.

    In f32 the default jitter additionally scales with the diagonal: the
    reference's absolute 1e-6 assumes f64 rounding (~1e-16); under f32
    accumulation (~6e-8 relative) a near-singular gram needs jitter at the
    f32 noise floor or the factorization NaNs.  The f64 parity path is
    unaffected.  Pass ``jitter`` explicitly to override.
    """
    n = a.shape[-1]
    if jitter is None:
        jitter = config.cholesky_jitter
        if a.dtype == jnp.float32:
            diag_scale = jnp.mean(
                jnp.abs(jnp.diagonal(a, axis1=-2, axis2=-1)), axis=-1
            )
            jitter = jnp.maximum(jitter, 1e-5 * diag_scale)
    a = a + jitter * jnp.eye(n, dtype=a.dtype)
    return jnp.linalg.cholesky(a, upper=True)


def log_det_tri(tri: jnp.ndarray) -> jnp.ndarray:
    """2 * sum(log diag) of a triangular Cholesky-like factor.

    Reference: ``Utils.log_det`` (lib/utils.ml:95-101).
    """
    d = jnp.diagonal(tri, axis1=-2, axis2=-1)
    return 2.0 * jnp.sum(jnp.log(d), axis=-1)


def solve_tri(tri: jnp.ndarray, b: jnp.ndarray, *, trans: bool = False,
              lower: bool = False) -> jnp.ndarray:
    """Solve ``op(tri) x = b`` for triangular ``tri`` (default upper).

    Reference: ``Utils.solve_tri`` / ``trtrs`` (lib/utils.ml:104-107).
    """
    return jax.scipy.linalg.solve_triangular(
        tri, b, trans=1 if trans else 0, lower=lower
    )


def solve_tri_right(b: jnp.ndarray, tri: jnp.ndarray, *, trans: bool = False,
                    lower: bool = False) -> jnp.ndarray:
    """Solve ``x op(tri) = b`` i.e. ``x = b op(tri)^-1`` (right-side trsm).

    Reference: ``trsm ~side:`R`` (lib/fitc_gp.ml:227,493,512-516).
    Implemented via the transposed left solve: ``x^T = op(tri)^-T b^T``.
    """
    return jax.scipy.linalg.solve_triangular(
        tri, b.T, trans=0 if trans else 1, lower=lower
    ).T


def ichol(chol_u: jnp.ndarray) -> jnp.ndarray:
    """Full inverse of A from its upper Cholesky factor U (A = U^T U).

    Reference: ``Utils.ichol`` via LAPACK ``potri`` (lib/utils.ml:110-113).
    A^-1 = U^-1 U^-T, computed with two triangular solves.
    """
    eye = jnp.eye(chol_u.shape[-1], dtype=chol_u.dtype)
    u_inv = jax.scipy.linalg.solve_triangular(chol_u, eye, lower=False)
    return matmul(u_inv, u_inv.T)


def inv_tri_upper(u: jnp.ndarray) -> jnp.ndarray:
    """Inverse of an upper-triangular matrix."""
    eye = jnp.eye(u.shape[-1], dtype=u.dtype)
    return jax.scipy.linalg.solve_triangular(u, eye, lower=False)


def rows_sqr_norm(a: jnp.ndarray) -> jnp.ndarray:
    """Per-row squared norms: diag(A A^T).

    Reference: ``Mat.syrk_diag`` (lib/fitc_gp.ml:222-223,493,513-516).
    """
    return jnp.sum(jnp.square(a), axis=-1)


def syrk(a: jnp.ndarray) -> jnp.ndarray:
    """A^T A — the Gram matrix."""
    return matmul(a.T, a)


def qr_r_positive(a: jnp.ndarray) -> jnp.ndarray:
    """R factor of a thin QR with the sign convention diag(R) > 0.

    With positive diagonal, R is the unique upper Cholesky factor of A^T A —
    which is what makes the reference's QR evidence path (lib/fitc_gp.ml:
    168-203, sign fix at :184-203) and the Cholesky-of-B path interchangeable:
    everything downstream depends only on R.
    """
    r = jnp.linalg.qr(a, mode="r")
    sign = jnp.sign(jnp.diagonal(r, axis1=-2, axis2=-1))
    sign = jnp.where(sign == 0, 1.0, sign)
    return r * sign[..., :, None]


def tsqr_r(a: jnp.ndarray, n_blocks: int) -> jnp.ndarray:
    """Tall-skinny QR: R factor of an (n, m) matrix via blockwise QR.

    Communication-avoiding structure (per-block QR -> stack the R's -> QR
    again); preserves the Foster-2009 stability argument of the reference's
    stacked QR while mapping onto parallel row blocks.  Used by the sharded
    evidence path (SURVEY.md section 5, last bullet).
    """
    n, m = a.shape
    if n % n_blocks != 0:
        return qr_r_positive(a)
    blocks = a.reshape(n_blocks, n // n_blocks, m)
    rs = jax.vmap(lambda blk: jnp.linalg.qr(blk, mode="r"))(blocks)
    return qr_r_positive(rs.reshape(n_blocks * m, m))

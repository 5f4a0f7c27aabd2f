"""Covariance-function protocol.

The reference defines what a kernel must provide as OCaml module signatures
(``Specs.Eval`` / ``Specs.Deriv``, lib/interfaces.ml:80-312).  Here a kernel
*family* is a plain class of pure static methods (never instantiated, hashable,
therefore usable as a static jit argument), and its parameters are a frozen
PyTree dataclass.  Derivatives need no spec at all: everything is differentiable
by ``jax.grad``, which subsumes the reference's sparse derivative
representations (``common_mat_deriv`` etc., lib/interfaces.ml:28-77) — reverse
mode computes the full inducing-point gradient in one O(n m d) pass instead of
per-coordinate sparse fast paths.

Shape conventions: inputs X are (n, d) row-major; the inducing representation Z
is kernel-specific (see ``inducing_from_inputs``), matching the reference where
e.g. cov_lin_ard stores inducing points pre-scaled (lib/cov_lin_ard.ml:71) and
cov_se_fat stores them projected (lib/cov_se_fat.ml:220).
"""

from __future__ import annotations

from typing import Any, Protocol

import jax.numpy as jnp


class KernelFamily(Protocol):
    """Structural protocol implemented by each kernel module's family class.

    Mirrors ``Specs.Eval`` (lib/interfaces.ml:106-204):

    ======================  ====================================================
    method                  reference counterpart
    ======================  ====================================================
    default_params          Inputs.create_default_kernel_params
    inducing_from_inputs    Inputs.create_inducing
    k_upper                 Inducing.calc_upper       (m, m) gram at inducing
    k_diag                  Inputs.calc_diag          (n,) prior variances
    k_cross                 Inputs.calc_cross         (n, m) cross-covariance
    k_upper_inputs          Inputs.calc_upper         (n, n) full gram at inputs
    k_one                   Input.eval_one            scalar prior variance
    ======================  ====================================================
    """

    name: str
    # Whether evidence optimization moves the inducing representation by
    # default.  True for the SE kernels whose Hyper.get_all includes
    # `Inducing_hyper (lib/cov_se_iso.ml:183-202, lib/cov_se_fat.ml:290-342);
    # False for const/lin_one/lin_ard whose hyper set excludes inducing points.
    learn_inducing_default: bool

    def default_params(self, X: jnp.ndarray, n_inducing: int, key: Any): ...
    def inducing_from_inputs(self, params, X: jnp.ndarray) -> jnp.ndarray: ...
    def k_upper(self, params, Z: jnp.ndarray) -> jnp.ndarray: ...
    def k_diag(self, params, X: jnp.ndarray) -> jnp.ndarray: ...
    def k_cross(self, params, X: jnp.ndarray, Z: jnp.ndarray) -> jnp.ndarray: ...
    def k_upper_inputs(self, params, X: jnp.ndarray) -> jnp.ndarray: ...
    def k_one(self, params, x: jnp.ndarray) -> jnp.ndarray: ...
    # Optional: k_cross_inputs(params, X1, X2) — the data-side cross block
    # K(X1, X2) consistent with k_upper_inputs' off-diagonal.  Only needed
    # where that differs from k_cross against inducing_from_inputs(X2)
    # (se_fat: multiscales are an inducing-point property, cov_se_fat.ml:221
    # evaluates the input gram as plain SE on projections).  Use the module
    # dispatcher ``cross_inputs`` instead of calling either form directly.


def sqdist(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Pairwise squared distances between rows of a (n,d) and b (m,d).

    The expansion |a|^2 - 2 a.b + |b|^2 puts the O(n m d) work in one
    GEMM instead of the reference's scalar triple loop
    (lib/cov_se_iso.ml:56-72,128-144).  Clamped at zero against rounding.

    ``config.sqdist_impl = "direct"`` switches to the elementwise
    sum_k (a_k - b_k)^2 form: all-positive summands, so d2 carries ~1-ulp
    relative error instead of a few ulps of the |a|^2 + |b|^2 term
    magnitude — the measured dominant accurate-mode kernel-entry error
    (config.py note).  Elementwise-bound; for the parity/accurate path.
    """
    from ..config import config
    from ..numerics.linalg import matmul

    if config.sqdist_impl == "direct":
        d2 = jnp.sum(
            jnp.square(a[:, None, :] - b[None, :, :]), axis=-1
        )
        return jnp.maximum(d2, 0.0)
    a2 = jnp.sum(jnp.square(a), axis=-1)
    b2 = jnp.sum(jnp.square(b), axis=-1)
    # configured precision, NOT the backend default: on the GPU the default
    # runs f32 dots in TF32 (chip_smoke.py's precision map), and d2 feeds
    # exp() — a reduced-precision d2 was the dominant term of the f32
    # evidence bias at n=1e6 (NEXT.md at commit b587de6)
    d2 = a2[:, None] - 2.0 * matmul(a, b.T) + b2[None, :]
    return jnp.maximum(d2, 0.0)


def sqdist_cotangent_reduce(c, X, Z):
    """(z_bar, c_dot_d2, c_sum) for a (bs, m) cotangent ``c`` of
    ``sqdist(X, Z)``.

    Every reduction rides ONE (m, bs) x (bs, d+2) GEMM against the augmented
    [X | 1 | xx] (xx = row square norms): cols :d give c'X, col d the column
    sums, col d+1 c'xx.  Then

        z_bar    = 2 (colsum(c)[:, None] * Z - c'X)
        c_dot_d2 = sum(c . d2) = sum(c'xx) + colsum(c).zz - 2 sum((c'X) . Z)

    Shared by the hand-fused kernel pullbacks (k_cross_vjp): one elementwise
    pass over the tile plus this GEMM replaces the several (bs, m)
    intermediates the AD pullback materializes (the saving is not measured
    on the H100).
    """
    from ..numerics.linalg import matmul

    xx = jnp.sum(X * X, axis=1)
    aug = jnp.concatenate(
        [X, jnp.ones_like(xx)[:, None], xx[:, None]], axis=1
    )
    caug = matmul(c.T, aug)  # (m, d + 2)
    d = X.shape[1]
    cX, cs, cxx = caug[:, :d], caug[:, d], caug[:, d + 1]
    zz = jnp.sum(Z * Z, axis=1)
    c_dot_d2 = jnp.sum(cxx) + jnp.dot(cs, zz) - 2.0 * jnp.sum(cX * Z)
    z_bar = 2.0 * (cs[:, None] * Z - cX)
    return z_bar, c_dot_d2, jnp.sum(cs)


def cross_inputs(family, params, X1, X2) -> jnp.ndarray:
    """Data-side cross-covariance block K(X1, X2) among INPUTS.

    Dispatches to the family's ``k_cross_inputs`` hook when present;
    otherwise ``k_cross`` against ``inducing_from_inputs(X2)``, which is
    exact for every family whose input gram is the cross form restricted to
    inputs (all but se_fat — verified numerically per family in
    tests/test_iterative.py).  Row blocks of ``k_upper_inputs`` without the
    O(n^2) materialization — the tile primitive of models/iterative.py."""
    hook = getattr(family, "k_cross_inputs", None)
    if hook is not None:
        return hook(params, X1, X2)
    return family.k_cross(params, X1, family.inducing_from_inputs(params, X2))


def weighted_eval(family, params, X, Z, coeffs) -> jnp.ndarray:
    """K(X, Z) @ coeffs — reference ``Inputs.weighted_eval``
    (lib/interfaces.ml:193-198)."""
    from ..numerics.linalg import matmul

    return matmul(family.k_cross(params, X, Z), coeffs)


def weighted_eval_one(family, params, x, Z, coeffs) -> jnp.ndarray:
    """k(x, Z) . coeffs — reference ``Input.weighted_eval``
    (lib/interfaces.ml:131-137)."""
    return jnp.dot(family.k_cross(params, x[None, :], Z)[0], coeffs)


def choose_subset(X: jnp.ndarray, indexes) -> jnp.ndarray:
    """Row subset — reference ``Inputs.choose_subset`` / ``Utils.choose_cols``
    (lib/utils.ml:60-75; column-major there, row-major here)."""
    return X[jnp.asarray(indexes)]


def k_upper_cols(family, params, Z, j0, m_t):
    """Columns [j0 : j0+m_t] of ``family.k_upper(params, Z)`` without
    forming the m x m gram — the building block of the fully distributed
    inducing factorization (parallel/mesh2d.py ``inducing="distributed"``),
    where every member may hold only O(m^2 / p) of any inducing-sized
    matrix.  ``j0`` may be traced (it is a mesh axis index).
    """
    own = getattr(family, "k_upper_cols", None)
    if own is not None:
        # combinator families compose their terms' column blocks
        return own(params, Z, j0, m_t)

    import jax.numpy as _jnp
    from jax import lax as _lax

    m = Z.shape[0]
    z_c = _lax.dynamic_slice_in_dim(Z, j0, m_t, axis=0)
    rows = _jnp.arange(m)[:, None]
    cols = (j0 + _jnp.arange(m_t))[None, :]
    on_diag = rows == cols

    name = getattr(family, "name", None)
    if name == "const":
        return family.k_cross(params, Z[:, :0] if Z.ndim == 2 else Z, z_c)
    if name in ("lin_one", "lin_ard"):
        # linear kernels: k_upper IS the (scaled) gram — k_cross of Z rows
        # against the column subset, but WITHOUT re-scaling the left side
        # (the inducing representation is already scaled for lin_ard)
        if name == "lin_ard":
            from ..numerics.linalg import matmul as _mm

            return _mm(Z, z_c.T)
        return family.k_cross(params, Z, z_c)
    if name in ("se_iso", "se_ard", "matern32", "matern52", "rq",
                "periodic"):
        k = family.k_cross(params, Z, z_c)
        sf2 = _jnp.exp(params.log_sf2)
        return _jnp.where(on_diag, sf2, k)
    if name == "cosine":
        # exact unit diagonal already; no correction needed
        return family.k_cross(params, Z, z_c)
    if name == "se_fat":
        log_sf2 = params.log_sf2
        if params.log_multiscales_m05 is None:
            k = _jnp.exp(log_sf2 - 0.5 * sqdist(Z, z_c))
            k = _jnp.where(on_diag, _jnp.exp(log_sf2), k)
        else:
            u = _jnp.exp(params.log_multiscales_m05) + 0.5  # (m, d)
            u_c = _lax.dynamic_slice_in_dim(u, j0, m_t, axis=0)
            scale = u[:, None, :] + u_c[None, :, :] - 1.0
            diff = Z[:, None, :] - z_c[None, :, :]
            quad = _jnp.sum(_jnp.square(diff) / scale + _jnp.log(scale), -1)
            k = _jnp.exp(log_sf2 - 0.5 * quad)
        if params.log_hetero_skedasticity is not None:
            het = _jnp.exp(params.log_hetero_skedasticity)
            het_c = _lax.dynamic_slice_in_dim(het, j0, m_t)
            k = k + _jnp.where(on_diag, het_c[None, :], 0.0)
        return k
    raise NotImplementedError(f"k_upper_cols for family {name!r}")

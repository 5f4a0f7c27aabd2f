"""Derivative self-test harness — the rebuild of ``Sigs.Deriv.Test``.

The reference ships finite-difference validators as part of the library
(``check_deriv_hyper`` and ``self_test``, lib/fitc_gp.ml:1212-1462, spec
lib/interfaces.ml:987-1026) and its derivative executable drives them over
every hyper of the fat kernel (test/test_derivatives.ml).  Here the analytic
side is jax AD instead of hand-derived sparse representations, so these
checks validate (a) each kernel family's smoothness/correctness under jvp
and (b) the full evidence gradient — including through the jittered Cholesky
and both factorizations.

Central differences with f64 give ~1e-9 accuracy; defaults are tighter than
the reference's (eps=1e-8, tol=1e-2 at fitc_gp.ml:1223,1398) accordingly.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .models.fitc import log_evidence
from .optim.pack import make_pack


class DerivMismatch(AssertionError):
    """Raised with the offending quantity, mirroring the reference's loud
    per-element failure reports."""


def _fd_dir(f, x, v, eps):
    plus, minus = f(x + eps * v), f(x - eps * v)
    return jax.tree.map(lambda a, b: (a - b) / (2.0 * eps), plus, minus)


def check_deriv_hyper(
    family, params, z, X, *, eps: float = 1e-6, tol: float = 1e-6
) -> int:
    """Check d(Km)/dh, d(Knm)/dh, d(kn_diag)/dh along every optimizable
    hyper direction: jax.jvp vs central finite differences.

    Returns the number of directions checked.  Raises :class:`DerivMismatch`
    naming the worst element on failure.
    """
    pack = make_pack(family, params, z, 1.0, learn_sigma2=False)
    x0 = pack.x0

    def mats(x):
        p, zz, _ = pack.unpack(x)
        return (
            family.k_upper(p, zz),
            family.k_cross(p, X, zz),
            family.k_diag(p, X),
        )

    names = ("dKm", "dKnm", "dkn_diag")
    n = int(x0.shape[0])
    for i in range(n):
        v = jnp.zeros_like(x0).at[i].set(1.0)
        analytic = jax.jvp(mats, (x0,), (v,))[1]
        fd = _fd_dir(mats, x0, v, eps)
        for name, a, f in zip(names, analytic, fd):
            a, f = np.asarray(a), np.asarray(f)
            err = np.abs(a - f)
            scale = np.maximum(1.0, np.abs(f))
            rel = err / scale
            if rel.max() > tol:
                idx = np.unravel_index(rel.argmax(), rel.shape)
                raise DerivMismatch(
                    f"{family.name}: {name} mismatch for hyper coordinate "
                    f"{i} at element {idx}: analytic {a[idx]:.10g} vs FD "
                    f"{f[idx]:.10g} (tol {tol})"
                )
    return n


def self_test(
    family,
    params,
    z,
    X,
    y,
    sigma2,
    *,
    variational: bool = False,
    factorization: str | None = None,
    eps: float = 1e-6,
    tol: float = 1e-5,
) -> int:
    """Check the full evidence gradient (log sigma2, every kernel hyper,
    every inducing coordinate) against central finite differences — the
    analogue of Test.self_test looping `Sigma2 and each `Hyper
    (fitc_gp.ml:1398-1462).  Returns the number of coordinates checked."""
    pack = make_pack(family, params, z, sigma2, learn_sigma2=True)
    x0 = pack.x0

    def f(x):
        p, zz, s2 = pack.unpack(x)
        return log_evidence(
            family, p, zz, s2, X, y,
            variational=variational, factorization=factorization,
        )

    g = np.asarray(jax.grad(f)(x0))
    n = int(x0.shape[0])
    for i in range(n):
        v = jnp.zeros_like(x0).at[i].set(1.0)
        fd = float(_fd_dir(f, x0, v, eps))
        err = abs(g[i] - fd) / max(1.0, abs(fd))
        if err > tol:
            which = "log_sigma2" if (pack.learn_sigma2 and i == 0) else f"hyper {i}"
            raise DerivMismatch(
                f"{family.name}: evidence gradient mismatch for {which}: "
                f"analytic {g[i]:.10g} vs FD {fd:.10g} (rel err {err:.2e}, "
                f"tol {tol})"
            )
    return n


# -- the headline configuration ---------------------------------------------
#
# SeIso, n=1e6 rows, d=8, m=300 inducing points, log_ell=0.5, log_sf2=0,
# sigma2=0.1: the shape the benchmark and chip_smoke.py time.  Its f64
# evidence (absolute jitter 1e-6) depends only on the seeded data; it was
# computed three times on the host in numpy by the blocked recipe of
# :func:`reference_evidence_se_iso`.

HEADLINE_F64_EVIDENCE = -2123659.4


def headline_data(n=1_000_000, d=8, m=300, seed=0):
    """(X, y, Z) as float32 numpy arrays, drawn in this order from
    ``np.random.default_rng(seed)``: standard-normal inputs, targets and
    inducing points.  At the default sizes and seed the f64 evidence of
    these (f32-rounded) values is :data:`HEADLINE_F64_EVIDENCE`."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d)).astype(np.float32)
    y = rng.standard_normal(n).astype(np.float32)
    Z = rng.standard_normal((m, d)).astype(np.float32)
    return X, y, Z


def reference_evidence_se_iso(X, y, Z, log_ell, log_sf2, sigma2, *,
                              jitter=1e-6, block_size=65536):
    """Plain FITC log evidence for the isotropic SE kernel, in the dtype of
    the inputs (pass f64 with x64 enabled for a reference).

    Independent of the library's kernels and engine: the textbook
    whitened-statistics recipe (V = Knm U^-1, Gram of V sqrt(1/s),
    log|I + G|), summed over row blocks with plain f64-capable jnp.
    Jittable; every dot runs at HIGHEST precision."""
    hp = jax.lax.Precision.HIGHEST
    dt = X.dtype
    ell2 = jnp.exp(2.0 * jnp.asarray(log_ell, dt))
    sf2 = jnp.exp(jnp.asarray(log_sf2, dt))
    s2 = jnp.asarray(sigma2, dt)
    m = Z.shape[0]

    def cross(A, B):
        d2 = (jnp.sum(A * A, 1)[:, None] - 2.0 * jnp.dot(A, B.T, precision=hp)
              + jnp.sum(B * B, 1)[None, :])
        return sf2 * jnp.exp(-0.5 * jnp.maximum(d2, 0.0) / ell2)

    eye = jnp.eye(m, dtype=dt)
    km = cross(Z, Z) * (1.0 - eye) + sf2 * eye
    u = jnp.linalg.cholesky(km + jitter * eye, upper=True)
    u_inv = jax.scipy.linalg.solve_triangular(u, eye, lower=False)
    n = X.shape[0]
    nb = -(-n // block_size)
    pad = nb * block_size - n
    mask = jnp.concatenate([jnp.ones((n,), dt), jnp.zeros((pad,), dt)])
    Xb = jnp.concatenate([X, jnp.zeros((pad, X.shape[1]), dt)]).reshape(
        nb, block_size, -1)
    yb = jnp.concatenate([y, jnp.zeros((pad,), dt)]).reshape(nb, block_size)

    def body(carry, blk):
        gram, uvec, lds, yiy = carry
        xb, y_b, mb = blk
        v = jnp.dot(cross(xb, Z), u_inv, precision=hp)
        s = jnp.where(mb > 0, sf2 - jnp.sum(v * v, 1) + s2, 1.0)
        is_ = mb / s
        a = v * jnp.sqrt(is_)[:, None]
        return (gram + jnp.dot(a.T, a, precision=hp),
                uvec + jnp.dot(v.T, is_ * y_b, precision=hp),
                lds + jnp.sum(jnp.log(s)),
                yiy + jnp.sum(is_ * y_b * y_b)), None

    zero = jnp.zeros((), dt)
    (gram, uvec, lds, yiy), _ = jax.lax.scan(
        body, (jnp.zeros((m, m), dt), jnp.zeros((m,), dt), zero, zero),
        (Xb, yb, mask.reshape(nb, block_size)))
    rt = jnp.linalg.cholesky(eye + gram, upper=True)
    t = jax.scipy.linalg.solve_triangular(rt, uvec, trans=1, lower=False)
    l1 = -0.5 * (2.0 * jnp.sum(jnp.log(jnp.diagonal(rt))) + lds
                 + n * jnp.log(2.0 * jnp.pi))
    return l1 - 0.5 * (yiy - jnp.dot(t, t, precision=hp))

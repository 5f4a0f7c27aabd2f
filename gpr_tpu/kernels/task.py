"""Coregionalization ("task") kernel — multi-output GPs via ICM.

k(t, t') = B[t, t'],   B = W W' + diag(exp(log_kappa))   (T x T, PSD)

over ONE input column holding task indices 0..T-1.  Multi-output models
stack every task's rows into one dataset ``[features..., task_id]`` and
compose this family with a data kernel over the feature columns through
the column-restriction combinator (kernels/combinators.py):

    icm = product_family(cols_family(task_family(T, R), d, d + 1),
                         cols_family(SeIso, 0, d))

which is the intrinsic coregionalization model k((x,t),(x',t')) =
B[t,t'] * k_data(x,x') (Bonilla et al., "Multi-task Gaussian Process
Prediction", NeurIPS 2008).  Everything downstream — FITC/variational
evidence, streaming blocks, the 1-D/2-D mesh objectives, all the
Laplace/EP likelihood families, the CLI — works unchanged because the
composition is just another kernel family.

The reference has no multi-output support (one ``Spec`` per engine,
lib/interfaces.ml); this is an extension, inventoried in COMPONENTS.md.

Design details:

* The (n, m) cross block is two GEMMs against one-hot task selectors
  (K = O1 B O2') — no gathers anywhere, because a gather's BACKWARD is
  a scatter-add over n rows (see ``_cross_ids``).  The hot path is GEMM
  work.
* Task indices are recovered by round+clip, so the task coordinate of
  the shared inducing set Z receives ZERO gradient (integer gather
  indices carry no tangent) and inducing points keep the task they were
  initialized with — the standard ICM treatment of inducing outputs.
* B = W W' + diag(exp(log_kappa)) is PSD by construction for any real
  W, so no constraint handling is needed in the optimizer; ``rank`` R
  dials expressiveness (R = T is a full PSD B).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..tree import pytree_dataclass


@pytree_dataclass
class TaskParams:
    W: jnp.ndarray  # (T, R) coregionalization factors
    log_kappa: jnp.ndarray  # (T,) log of the per-task independent variance


class _Task:
    """Family object for ``task(T, R)``.  Instances are immutable,
    hashable, and interned (``task_family``), so they are jit-static
    exactly like the base family classes."""

    Params = TaskParams
    learn_inducing_default = False  # integer ids have no useful gradient

    def __init__(self, n_tasks: int, rank: int):
        if n_tasks < 1 or rank < 1:
            raise ValueError("task_family needs n_tasks >= 1 and rank >= 1")
        self.n_tasks = int(n_tasks)
        self.rank = int(rank)
        self.name = f"task({self.n_tasks},{self.rank})"

    def __repr__(self):
        return f"<kernel family {self.name}>"

    def __eq__(self, other):
        return (
            isinstance(other, _Task)
            and self.n_tasks == other.n_tasks
            and self.rank == other.rank
        )

    def __hash__(self):
        return hash(("task", self.n_tasks, self.rank))

    # -- protocol ------------------------------------------------------

    def default_params(self, X, n_inducing, key=None) -> TaskParams:
        """W init must not be 0 — dK/dW vanishes there (a stationary
        point); keyless callers get a deterministic non-degenerate W."""
        dt = X.dtype
        T, R = self.n_tasks, self.rank
        if key is not None:
            W = 0.3 * jax.random.normal(key, (T, R), dt)
        else:
            base = jnp.arange(T * R, dtype=dt).reshape(T, R)
            W = 0.3 * jnp.cos(base + 0.7)
        return TaskParams(W=W, log_kappa=jnp.full((T,), -1.0, dt))

    def inducing_from_inputs(self, params, X):
        return X

    def _ids(self, x):
        ids = jnp.clip(jnp.round(x[..., 0]), 0, self.n_tasks - 1)
        return ids.astype(jnp.int32)

    def _cross_ids(self, params, t1, t2):
        """K = O1 B O2' with one-hot task selectors — two GEMMs.  The
        obvious alternative (gather W rows, equality-mask the
        kappa term) is numerically identical but its BACKWARD is a
        scatter-add over n rows, which serializes on some accelerators (not
        measured on the H100, where XLA lowers scatters to atomics).
        One-hot keeps forward and backward as dense (n, T)-shaped GEMM
        work for the realistic small-T regime.
        """
        import jax

        from ..numerics.linalg import matmul

        B = self.coregionalization(params)
        o1 = jax.nn.one_hot(t1, self.n_tasks, dtype=B.dtype)  # (n, T)
        o2 = jax.nn.one_hot(t2, self.n_tasks, dtype=B.dtype)  # (m, T)
        return matmul(matmul(o1, B), o2.T)

    def k_cross(self, params, X, Z):
        return self._cross_ids(params, self._ids(X), self._ids(Z))

    def k_upper(self, params, Z):
        t = self._ids(Z)
        return self._cross_ids(params, t, t)

    def k_upper_inputs(self, params, X):
        t = self._ids(X)
        return self._cross_ids(params, t, t)

    def k_diag(self, params, X):
        import jax

        from ..numerics.linalg import matmul

        t = self._ids(X)
        diag_b = jnp.sum(jnp.square(params.W), axis=-1) + jnp.exp(
            params.log_kappa
        )
        # one-hot GEMV, not a gather: the gather's backward scatter-adds
        # over n rows (see _cross_ids)
        o = jax.nn.one_hot(t, self.n_tasks, dtype=diag_b.dtype)
        return matmul(o, diag_b[:, None])[:, 0]

    def k_one(self, params, x):
        t = self._ids(x[None, :])[0]
        w = params.W[t]
        return jnp.dot(w, w) + jnp.exp(params.log_kappa)[t]

    def k_upper_cols(self, params, Z, j0, m_t):
        """Column block of k_upper without the (m, m) gram — the kernel
        has no index-diagonal correction, so this IS k_cross against the
        row slice (kernels/base.py ``k_upper_cols`` contract)."""
        from jax import lax

        z_c = lax.dynamic_slice_in_dim(Z, j0, m_t, axis=0)
        return self.k_cross(params, Z, z_c)

    def coregionalization(self, params) -> jnp.ndarray:
        """The learned (T, T) task-covariance matrix B — the object a
        user inspects to read off inter-task correlations."""
        from ..numerics.linalg import matmul

        return matmul(params.W, params.W.T) + jnp.diag(
            jnp.exp(params.log_kappa)
        )


_INTERNED: dict = {}


def task_family(n_tasks: int, rank: int) -> _Task:
    """The coregionalization family over ``n_tasks`` outputs with a
    rank-``rank`` shared component (B = W W' + diag, W of shape
    (n_tasks, rank)).  Interned so equal (T, R) gives the identical
    jit-static family object."""
    key = (int(n_tasks), int(rank))
    fam = _INTERNED.get(key)
    if fam is None:
        fam = _INTERNED[key] = _Task(*key)
    return fam

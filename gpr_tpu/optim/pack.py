"""Hyperparameter packing: typed PyTrees <-> flat optimization vectors.

The reference exposes hypers as an array of polymorphic variants with
get/set-by-index (``Spec.Hyper``, lib/interfaces.ml:213-244; packing into a
GSL vector at lib/fitc_gp.ml:1541-1576).  Here the same contract is one
ravel: the optimizer sees a flat vector x, the engine sees
(kernel params, inducing Z, sigma2).

Vector layout matches the reference's convention: coordinate 0 is
log(sigma2) when ``learn_sigma2`` (fitc_gp.ml:1549,1565 — the noise is
optimized in log space), followed by the selected kernel-param leaves, then
the inducing coordinates when ``learn_inducing``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

import jax.numpy as jnp
from jax.flatten_util import ravel_pytree


@dataclasses.dataclass(frozen=True)
class HyperPack:
    x0: jnp.ndarray
    unpack: Callable[[jnp.ndarray], tuple[Any, jnp.ndarray, jnp.ndarray]]
    n_hypers: int
    learn_sigma2: bool
    # pack-layout options, recorded so a child process (optim/polish.py)
    # can rebuild an identical layout — a mismatch there silently ranked
    # every rescore candidate as inf (ADVICE.md r4 at commit b587de6)
    learn_inducing: bool = True
    fixed: tuple = ()


@dataclasses.dataclass(frozen=True)
class ExtendedPack:
    """A base pack plus extra (likelihood) parameters appended to the
    optimization vector — e.g. ordinal cutpoints, which are neither kernel
    hypers nor sigma2.  ``unpack`` sees only the base coordinates, so the
    extended pack drops into every base-pack code path;
    ``unpack_extra`` recovers the appended PyTree."""

    x0: jnp.ndarray
    unpack: Callable[[jnp.ndarray], tuple[Any, jnp.ndarray, jnp.ndarray]]
    n_hypers: int
    learn_sigma2: bool
    base: HyperPack
    n_extra: int
    unpack_extra: Callable[[jnp.ndarray], Any]


def extend_pack(pack: HyperPack, extra0) -> ExtendedPack:
    """Append the leaves of ``extra0`` (any PyTree) after the base pack's
    coordinates.  Layout: [base coords | extra leaves]."""
    extra_vec, unravel_extra = ravel_pytree(extra0)
    n_base = int(pack.x0.shape[0])
    x0 = jnp.concatenate([pack.x0, extra_vec.astype(pack.x0.dtype)])
    return ExtendedPack(
        x0=x0,
        unpack=lambda x: pack.unpack(x[:n_base]),
        n_hypers=int(x0.shape[0]),
        learn_sigma2=pack.learn_sigma2,
        base=pack,
        n_extra=int(extra_vec.shape[0]),
        unpack_extra=lambda x: unravel_extra(x[n_base:]),
    )


def make_pack(
    family,
    params0,
    z0,
    sigma2_0,
    *,
    learn_sigma2: bool = True,
    learn_inducing: bool | None = None,
    fixed: Sequence[str] = (),
) -> HyperPack:
    """Build the pack for (params0, z0, sigma2_0).

    ``learn_inducing`` defaults per family (SE kernels optimize inducing
    coordinates, linear/const kernels do not — matching which families emit
    `Inducing_hyper from Hyper.get_all).  ``fixed`` names kernel-param fields
    to exclude, the analogue of passing an explicit ``hypers`` subset to the
    reference's train (lib/interfaces.ml:1056).
    """
    if learn_inducing is None:
        learn_inducing = family.learn_inducing_default
    fixed = set(fixed)

    sel: dict[str, Any] = {}
    param_fields = {
        f.name: getattr(params0, f.name)
        for f in dataclasses.fields(params0)
        if f.name not in fixed
    }
    # Static metadata fields (e.g. se_fat's d) and disabled options (None)
    # are not optimizable leaves.
    param_fields = {
        n: v
        for n, v in param_fields.items()
        if v is not None and not isinstance(v, int)
    }
    if param_fields:
        sel["params"] = param_fields
    if learn_inducing:
        sel["z"] = z0

    vec, unravel_sel = ravel_pytree(sel)
    dtype = vec.dtype if vec.size else jnp.asarray(sigma2_0).dtype

    if learn_sigma2:
        head = jnp.log(jnp.asarray(sigma2_0, dtype=dtype))[None]
        x0 = jnp.concatenate([head, vec])
    else:
        x0 = vec

    def unpack(x):
        if learn_sigma2:
            sigma2 = jnp.exp(x[0])
            rest = x[1:]
        else:
            sigma2 = jnp.asarray(sigma2_0, dtype=dtype)
            rest = x
        d = unravel_sel(rest)
        params = (
            dataclasses.replace(params0, **d["params"])
            if "params" in d
            else params0
        )
        z = d["z"] if learn_inducing else z0
        return params, z, sigma2

    return HyperPack(
        x0=x0, unpack=unpack, n_hypers=int(x0.shape[0]),
        learn_sigma2=learn_sigma2, learn_inducing=bool(learn_inducing),
        fixed=tuple(sorted(fixed)),
    )

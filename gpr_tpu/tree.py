"""PyTree dataclass helpers.

The reference library (mmottl/gpr) organises its engine as OCaml functors over
covariance-spec modules (``lib/interfaces.ml``).  The JAX equivalent is
parameter PyTrees flowing through pure, jit-compiled functions.  This module
provides the small amount of machinery for that: a frozen-dataclass decorator
that registers with JAX, and utilities to ravel a *selected subset* of a
PyTree's leaves into a flat optimization vector (the analogue of the
reference's ``Spec.Hyper.{get_all,get_value,set_values}`` protocol,
``lib/interfaces.ml:213-244``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

import jax
import jax.numpy as jnp
from jax.flatten_util import ravel_pytree


def pytree_dataclass(cls=None, *, meta_fields: Sequence[str] = ()):
    """Frozen dataclass registered as a JAX PyTree.

    ``meta_fields`` are static (hashable) fields excluded from tracing,
    e.g. integer dimensions.
    """

    def wrap(c):
        c = dataclasses.dataclass(frozen=True)(c)
        data_fields = tuple(
            f.name for f in dataclasses.fields(c) if f.name not in meta_fields
        )
        return jax.tree_util.register_dataclass(
            c, data_fields=data_fields, meta_fields=tuple(meta_fields)
        )

    return wrap(cls) if cls is not None else wrap


def replace(obj, **kwargs):
    """dataclasses.replace that works through the frozen wrapper."""
    return dataclasses.replace(obj, **kwargs)


def select_ravel(
    tree: Any, select: Callable[[str], bool], field_names: Sequence[str]
) -> tuple[jnp.ndarray, Callable[[jnp.ndarray], Any]]:
    """Ravel the selected top-level dataclass fields of ``tree`` into a vector.

    Returns ``(vec, unravel)`` where ``unravel(vec2)`` rebuilds a full tree with
    unselected fields taken from the original.  This is the PyTree analogue of
    the reference's hyper get/set protocol: the optimizer sees one flat vector,
    the kernel sees a typed params object.
    """
    selected = {n: getattr(tree, n) for n in field_names if select(n)}
    # Drop fields that are None (disabled options, e.g. tproj=None).
    selected = {n: v for n, v in selected.items() if v is not None}
    vec, unravel_sel = ravel_pytree(selected)

    def unravel(v):
        return dataclasses.replace(tree, **unravel_sel(v))

    return vec, unravel

"""Block-diagonal matrices with blockwise Cholesky / inverse.

JAX equivalent of the reference's ``Block_diag`` module
(lib/block_diag.ml:22-47): where the reference loops LAPACK ``potrf``/``potri``
over an array of unequal-sized blocks, here equal-sized blocks are stacked on a
leading axis and factored with one batched (vmapped) Cholesky — the idiomatic
accelerator layout.  Unequal block sizes are supported by padding with identity.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..tree import pytree_dataclass
from .linalg import ichol as _ichol


@pytree_dataclass
class BlockDiag:
    """Stack of square blocks: ``data`` has shape (n_blocks, k, k)."""

    data: jnp.ndarray

    @property
    def n_blocks(self) -> int:
        return self.data.shape[0]

    @property
    def block_size(self) -> int:
        return self.data.shape[-1]


def create(blocks) -> BlockDiag:
    """Build from a sequence of equal-size square blocks (or a stacked array).

    Reference: ``Block_diag.create`` validates squareness
    (lib/block_diag.ml:24-34).
    """
    data = jnp.stack([jnp.asarray(b) for b in blocks]) if isinstance(
        blocks, (list, tuple)
    ) else jnp.asarray(blocks)
    if data.ndim != 3 or data.shape[-1] != data.shape[-2]:
        raise ValueError(f"blocks must be square, got shape {data.shape}")
    return BlockDiag(data=data)


def create_padded(blocks) -> BlockDiag:
    """Build from unequal square blocks by identity-padding to the max size."""
    k = max(b.shape[-1] for b in blocks)
    padded = []
    for b in blocks:
        bk = b.shape[-1]
        p = jnp.eye(k, dtype=b.dtype).at[:bk, :bk].set(b)
        padded.append(p)
    return BlockDiag(data=jnp.stack(padded))


def copy(bd: BlockDiag) -> BlockDiag:
    """Functional arrays are immutable; kept for API parity
    (lib/block_diag.mli:30)."""
    return BlockDiag(data=bd.data)


def potrf(bd: BlockDiag, jitter: float = 0.0) -> BlockDiag:
    """Blockwise upper Cholesky (batched over the leading axis).

    Reference: ``Block_diag.potrf`` (lib/block_diag.ml:41-43).
    """
    k = bd.block_size
    a = bd.data + jitter * jnp.eye(k, dtype=bd.data.dtype)
    return BlockDiag(data=jax.vmap(lambda m: jnp.linalg.cholesky(m, upper=True))(a))


def potri(bd: BlockDiag) -> BlockDiag:
    """Blockwise inverse from the blockwise Cholesky factors.

    Reference: ``Block_diag.potri`` (lib/block_diag.ml:45-47).
    """
    return BlockDiag(data=jax.vmap(_ichol)(bd.data))


def to_dense(bd: BlockDiag) -> jnp.ndarray:
    """Materialize the full block-diagonal matrix (testing/debug only)."""
    nb, k, _ = bd.data.shape
    out = jnp.zeros((nb * k, nb * k), dtype=bd.data.dtype)
    for i in range(nb):
        out = out.at[i * k : (i + 1) * k, i * k : (i + 1) * k].set(bd.data[i])
    return out

"""Global configuration.

Mirrors the reference's two mutable library globals ``cholesky_jitter`` and
``debug`` (``lib/utils.ml:34-35``) plus accelerator knobs the reference has no
analogue for (dtype policy, matmul precision).

All engine functions take explicit keyword overrides; these globals are only
defaults read at trace time.
"""

from __future__ import annotations

import dataclasses

import jax


@dataclasses.dataclass
class Config:
    # Jitter added to every Cholesky factorization of Km / posterior
    # covariances (reference: lib/utils.ml:35, lib/fitc_gp.ml:55,669).
    cholesky_jitter: float = 1e-6
    # Debug-gated invariant checks (reference: lib/utils.ml:34,118-192).
    debug: bool = False
    # Matmul precision for f32 inputs.  On an H100 (chip_smoke.py's precision
    # map) HIGHEST runs true f32 products (~1e-6 relative on a 4096^2 GEMM);
    # HIGH and DEFAULT both run TF32 (~3e-4).  Matters for the 1e-6 parity
    # bar at large n.
    # NOTE: read at trace time — changing it does not invalidate already-
    # compiled jit caches; set it before building jitted objectives.
    matmul_precision: str = "highest"
    # Precision for the whitened ACCUMULATION GEMMs in the streaming
    # evidence (gram += a'a, u_vec += v'(is*y)).  None (default) = follow
    # matmul_precision, so a user who asks for HIGHEST gets it everywhere.
    # An opt-in: the whitened products are O(1) and well-conditioned at
    # the 1M x 8, m=300 SeIso benchmark shape, where a lower precision here
    # moved the evidence by 0.0 nats in an earlier measurement, while the
    # kernel sqdist and whitening GEMMs carry nearly all of the reduced-
    # precision error.  Not measured on the H100.  A low-noise problem
    # (tiny sigma2) scales the whitened rows by 1/sqrt(s), so this stays
    # an explicit dial rather than the library default.
    acc_precision: str | None = None
    # Streaming-backward GEMM sites to demote to single-pass (DEFAULT)
    # precision, from {"ui_bar", "vg", "knm_bar"} (stream_grad.py).  Default
    # () = no demotion.  Like
    # every precision knob this is read at trace time.  Applies to the
    # streaming custom-VJP backward only (grad_impl='cv', the default path);
    # the 'vg' site exists only under grad_variant='ug' — other variants
    # fuse that GEMM, leaving the entry inert.  Unknown names raise at
    # trace time (stream_grad.site_mm).
    bwd_demote_sites: tuple = ()
    # 'gemm' | 'direct': pairwise squared-distance assembly
    # (kernels/base.py:sqdist).  'gemm' is |a|^2 - 2ab + |b|^2 as one GEMM —
    # the fast path, but the f32 assembly of ~|terms|-magnitude pieces
    # leaves d2 errors of a few ulp(|a|^2+|b|^2), i.e. up to ~40 f32 ulps
    # on near-pair kernel ENTRIES; measured as the largest accurate-mode
    # evidence error term at 1M x 8 m=300 (+2.1 of the +2.9-nat sum-log-s
    # stage total, in an earlier tile-by-tile comparison).  'direct'
    # computes sum_k (a_k - b_k)^2 elementwise — no cancellation,
    # ~1-ulp entries — for the accurate/parity path.  Read at trace time.
    sqdist_impl: str = "gemm"
    # 'qr' | 'chol' | 'auto': how to factor B = Km + Knm' D^-1 Knm.
    # 'qr' reproduces the reference's Foster-2009 stacked QR
    # (lib/fitc_gp.ml:168-183); 'chol' is the cheap, shardable normal-equations
    # path.  'auto' picks QR below the size where QR cost is negligible.
    factorization: str = "auto"


config = Config()


def default_dtype():
    """Highest-precision float dtype currently enabled in JAX."""
    return jax.numpy.float64 if jax.config.jax_enable_x64 else jax.numpy.float32

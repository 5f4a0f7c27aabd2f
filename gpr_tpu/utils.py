"""Auxiliary subsystems: timing, debug checks, structured logging.

Rebuilds of the reference's aux layer (SURVEY.md section 5):
  * ``timing`` — wall/CPU-time printf (lib/utils.ml:50-55), here also a
    jax.profiler trace hook;
  * debug-gated invariant checks (lib/utils.ml:34,118-192) — cheap assertions
    toggled by ``config.debug``, plus NaN debugging via jax's debug_nans;
  * structured (jsonl) iteration logs for the training callbacks — the
    observability upgrade over the CLI's throttled stderr lines.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from .config import config

CHECKOUT_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def use_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache; returns its directory.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is left to JAX (which reads it
    at start-up) and nothing else is set.  Otherwise the cache goes to the
    fixed ``<checkout>/.jax_cache``: the directory is part of the cache's
    key, so one that moved between runs would never hit.  Call it from an
    entry point before the first compile; importing the package does not.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = os.path.join(CHECKOUT_ROOT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path


@contextlib.contextmanager
def timing(label: str, stream=sys.stderr):
    """Wall-clock timing context (reference Utils.timing, lib/utils.ml:50-55)."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        print(f"{label}: {time.perf_counter() - t0:.3f}s", file=stream)


@contextlib.contextmanager
def profile_trace(logdir: str):
    """jax.profiler trace around a region — the device-trace replacement
    for ad-hoc printf profiling; view in TensorBoard/XProf."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    """Raise on NaN production anywhere under jit (SURVEY.md section 5's
    analogue of sanitizers)."""
    old = jax.config.jax_debug_nans
    jax.config.update("jax_debug_nans", enable)
    try:
        yield
    finally:
        jax.config.update("jax_debug_nans", old)


def check_finite(name: str, *arrays):
    """Debug-gated invariant check (host-side; use outside jit).  No-op
    unless config.debug, mirroring the reference's ``debug``-guarded sparse
    sanity checks (lib/utils.ml:118-192)."""
    if not config.debug:
        return
    for i, a in enumerate(arrays):
        a = np.asarray(a)
        if not np.all(np.isfinite(a)):
            bad = np.argwhere(~np.isfinite(a))[:5]
            raise FloatingPointError(
                f"check_finite({name}): array {i} has non-finite entries at "
                f"{bad.tolist()}"
            )


def check_symmetric(name: str, a, tol=1e-8):
    """Debug-gated symmetry check for covariance matrices."""
    if not config.debug:
        return
    a = np.asarray(a)
    err = np.abs(a - a.T).max()
    if err > tol * max(1.0, np.abs(a).max()):
        raise AssertionError(f"check_symmetric({name}): asymmetry {err:.3e}")


class JsonlLogger:
    """Structured training log: one json object per event.

    Plug into train() callbacks::

        log = JsonlLogger(path)
        train(..., report_trained_model=lambda iter, trained:
                  log.write(iter=iter, l=float(trained.l)))
    """

    def __init__(self, path_or_stream):
        if hasattr(path_or_stream, "write"):
            self._fh = path_or_stream
            self._own = False
        else:
            self._fh = open(path_or_stream, "a")
            self._own = True

    def write(self, **event):
        event.setdefault("ts", time.time())
        event = {
            k: (float(v) if isinstance(v, (jnp.ndarray, np.floating)) else v)
            for k, v in event.items()
        }
        self._fh.write(json.dumps(event) + "\n")
        self._fh.flush()

    def close(self):
        if self._own:
            self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def to_bf16_stochastic(key, x):
    """Stochastically rounded bfloat16 quantization of an f32 array.

    For bf16 *storage* of very large inputs (models/streaming upcasts tiles
    back to the compute dtype on the device — HBM holds half the bytes).
    Stochastic rounding keeps the quantization unbiased: E[q(x)] = x, so
    data-sum statistics see noise, not bias, unlike round-to-nearest.

    Standard bit-level construction: bf16 is f32 with the low 16 mantissa
    bits dropped, so adding uniform random low bits before truncation
    rounds up with probability equal to the truncated fraction.
    """
    import jax
    import jax.numpy as jnp

    x = jnp.asarray(x, jnp.float32)
    bits = jax.lax.bitcast_convert_type(x, jnp.uint32)
    noise = jax.random.randint(
        key, x.shape, 0, 1 << 16, dtype=jnp.uint32
    )
    rounded = (bits + noise) & jnp.uint32(0xFFFF0000)
    return jax.lax.bitcast_convert_type(rounded, jnp.float32).astype(
        jnp.bfloat16
    )

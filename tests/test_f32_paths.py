"""f32 coverage for the accelerator performance paths (VERDICT.md round-1
weak #4, at commit b587de6).

The suite's conftest forces x64, so the f32-only branches — streaming's f32
accumulators, mesh2d's whitened-direct mode (raw_gram=False), and the f32
diag-scaled jitter — were previously validated only by ad-hoc accelerator runs.
These tests run the f32 computation in a SUBPROCESS with x64 disabled (the
accelerator's default configuration) on the 8-device CPU mesh, and compare its
outputs against f64 references computed here.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

F32_SCRIPT = r"""
import os, json, sys
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
import jax
jax.config.update("jax_platforms", "cpu")
assert not jax.config.jax_enable_x64
import jax.numpy as jnp
import numpy as np

from gpr_tpu.kernels import SeIso
from gpr_tpu.models.streaming import streaming_log_evidence
from gpr_tpu.numerics.linalg import cholesky_upper
from gpr_tpu.parallel import make_mesh, shard_batch
from gpr_tpu.parallel.sharded import sharded_log_evidence
from gpr_tpu.parallel.mesh2d import make_mesh_2d, sharded_log_evidence_2d

rng = np.random.default_rng(42)
n, d, m = 500, 3, 8
X = jnp.asarray(rng.standard_normal((n, d)), jnp.float32)
y = jnp.asarray(np.sin(rng.standard_normal(n)), jnp.float32)
Z = jnp.asarray(rng.standard_normal((m, d)), jnp.float32)
p = SeIso.Params(log_ell=jnp.asarray(0.3, jnp.float32),
                 log_sf2=jnp.asarray(0.1, jnp.float32))
s2 = jnp.asarray(0.4, jnp.float32)
out = {}

# 1. streaming evidence + grads, f32 accumulators, custom VJP vs AD
def obj(impl):
    def f(p, Z, s2):
        return streaming_log_evidence(SeIso, p, Z, s2, X, y, variational=True,
                                      block_size=64, grad_impl=impl)
    return f
v_cv, g_cv = jax.value_and_grad(obj("custom"), argnums=(0, 1, 2))(p, Z, s2)
v_ad, g_ad = jax.value_and_grad(obj("ad"), argnums=(0, 1, 2))(p, Z, s2)
out["stream_f32"] = float(v_cv)
out["stream_f32_ad"] = float(v_ad)
out["grad_z_f32"] = np.asarray(g_cv[1]).tolist()
out["grad_z_f32_ad"] = np.asarray(g_ad[1]).tolist()

# 2. 1-D sharded == local in f32
mesh = make_mesh(8)
Xs, ys, mask = shard_batch(mesh, X, y)
out["sharded_f32"] = float(sharded_log_evidence(
    SeIso, mesh, p, Z, s2, Xs, ys, mask, variational=True, block_size=32))

# 3. mesh2d whitened-direct branch (raw_gram=False in f32)
mesh2 = make_mesh_2d(4, 2)
out["mesh2d_f32"] = float(sharded_log_evidence_2d(
    SeIso, mesh2, p, Z, s2, X, y, variational=True, block_size=64))

# 3b. distributed epilogue (f32: whitened column-block accumulation) and the
# fully distributed mode (f32 default: compensated raw-Gram accumulation +
# distributed two-sided whitening — the route that was "structurally
# blocked" before dist_chol.dist_whiten_cols)
out["mesh2d_dist_epi_f32"] = float(sharded_log_evidence_2d(
    SeIso, mesh2, p, Z, s2, X, y, variational=True, block_size=64,
    epilogue="distributed"))
out["fulldist_f32"] = float(sharded_log_evidence_2d(
    SeIso, mesh2, p, Z, s2, X, y, variational=True, block_size=64,
    inducing="distributed"))

# 4. online add-then-remove round trip in f32: a dominant batch (100x the
# target scale, 40x the rows) is added and removed; compensated (two-sum)
# downdates make the round trip error-free on the running statistics, so
# the surviving 50 rows' evidence must match a direct f32 computation.
# Without compensation the subtraction loses ~ulp(big)/small relative
# accuracy (~1e-2 here) — this asserts 5e-4.
from gpr_tpu.models import log_evidence
from gpr_tpu.models.online import (
    online_downdate, online_init, online_log_evidence, online_update,
)
st = online_init(SeIso, p, Z, s2)
Xa, ya = X[:50], y[:50]
Xb = jnp.asarray(rng.standard_normal((2000, d)), jnp.float32)
yb = jnp.asarray(100.0 * rng.standard_normal(2000), jnp.float32)
st = online_update(SeIso, p, st, Xa, ya)
st = online_update(SeIso, p, st, Xb, yb, block_size=256)
st = online_downdate(SeIso, p, st, Xb, yb, block_size=256)
out["online_rt_f32"] = float(online_log_evidence(st))
out["online_rt_n"] = float(st.stats.n + st.stats_lo.n)
out["online_direct_f32"] = float(
    log_evidence(SeIso, p, Z, s2, Xa, ya, factorization="chol"))

# 6. round-3 model families in f32: PITC, warped, classification
from gpr_tpu.models.pitc import pitc_log_evidence
out["pitc_f32"] = float(pitc_log_evidence(SeIso, p, Z, s2, X, y,
                                          block_size=50))
from gpr_tpu.models.warped import default_warp_params, warped_log_evidence
wp = default_warp_params(2, jnp.float32)
out["warped_f32"] = float(warped_log_evidence(
    SeIso, p, wp, Z, s2, X, y, block_size=64, variational=True))
wg = jax.grad(lambda wp: warped_log_evidence(
    SeIso, p, wp, Z, s2, X, y, block_size=64, variational=True))(wp)
out["warped_grad_finite"] = bool(all(
    jnp.all(jnp.isfinite(l)) for l in jax.tree.leaves(wg)))
from gpr_tpu.models.classify import classify_log_evidence, classify_predict
ycls = jnp.sign(y)
out["classify_f32"] = float(classify_log_evidence(SeIso, p, Z, X, ycls))
prob, mu, var = classify_predict(SeIso, p, Z, X, ycls, X[:20])
out["classify_prob_ok"] = bool(jnp.all((prob > 0) & (prob < 1))
                               and jnp.all(var > 0))

# 5. f32 diag-scaled jitter keeps a degenerate gram factorizable
z_dup = jnp.concatenate([Z[:4], Z[:4]])  # duplicated inducing points
km = SeIso.k_upper(p, z_dup)
u = cholesky_upper(km)  # default jitter policy: diag-scaled in f32
out["jitter_finite"] = bool(jnp.all(jnp.isfinite(u)))

print(json.dumps(out))
"""


def _run_f32():
    env = dict(os.environ)
    env.pop("JAX_ENABLE_X64", None)
    res = subprocess.run(
        [sys.executable, "-c", F32_SCRIPT], capture_output=True, text=True,
        env=env, cwd=REPO, timeout=600,
    )
    assert res.returncode == 0, f"f32 subprocess failed:\n{res.stderr[-3000:]}"
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.mark.slow
def test_f32_paths_match_f64(rng):
    out = _run_f32()

    # f64 references (x64 is on in this process)
    from gpr_tpu.kernels import SeIso
    from gpr_tpu.models.streaming import streaming_log_evidence

    n, d, m = 500, 3, 8
    r = np.random.default_rng(42)
    X = jnp.asarray(r.standard_normal((n, d)))
    y = jnp.asarray(np.sin(r.standard_normal(n)))
    Z = jnp.asarray(r.standard_normal((m, d)))
    p = SeIso.Params(log_ell=jnp.asarray(0.3), log_sf2=jnp.asarray(0.1))
    s2 = jnp.asarray(0.4)

    def f(p, Z, s2):
        return streaming_log_evidence(SeIso, p, Z, s2, X, y, variational=True,
                                      block_size=64)

    v64, g64 = jax.value_and_grad(f, argnums=(0, 1, 2))(p, Z, s2)
    v64 = float(v64)

    # documented tolerances: evidence to f32 relative scale, grads looser
    # (n-fold accumulation in f32)
    assert abs(out["stream_f32"] - v64) < 5e-5 * abs(v64)
    assert abs(out["sharded_f32"] - v64) < 5e-5 * abs(v64)
    assert abs(out["mesh2d_f32"] - v64) < 5e-5 * abs(v64)
    assert abs(out["mesh2d_dist_epi_f32"] - v64) < 5e-5 * abs(v64)
    assert abs(out["fulldist_f32"] - v64) < 5e-5 * abs(v64)
    gz64 = np.asarray(g64[1])
    gz32 = np.asarray(out["grad_z_f32"])
    scale = np.abs(gz64).max()
    np.testing.assert_allclose(gz32, gz64, atol=5e-3 * scale, rtol=1e-2)

    # custom VJP and AD agree with each other at f32 resolution
    assert abs(out["stream_f32"] - out["stream_f32_ad"]) < 2e-5 * abs(v64)
    np.testing.assert_allclose(
        np.asarray(out["grad_z_f32"]), np.asarray(out["grad_z_f32_ad"]),
        atol=5e-3 * scale, rtol=1e-2,
    )

    assert out["jitter_finite"] is True

    # compensated online downdate: add-then-remove of a dominant batch
    # leaves the survivors' evidence at direct-f32 accuracy
    direct = out["online_direct_f32"]
    assert abs(out["online_rt_f32"] - direct) < 5e-4 * abs(direct)
    assert out["online_rt_n"] == 50.0

    # round-3 families: f32 evidence at f32 relative scale vs f64 refs
    from gpr_tpu.models.classify import classify_log_evidence
    from gpr_tpu.models.pitc import pitc_log_evidence
    from gpr_tpu.models.warped import default_warp_params, warped_log_evidence

    pitc64 = float(pitc_log_evidence(SeIso, p, Z, s2, X, y, block_size=50))
    assert abs(out["pitc_f32"] - pitc64) < 1e-4 * abs(pitc64)
    wp64 = default_warp_params(2)
    warped64 = float(warped_log_evidence(SeIso, p, wp64, Z, s2, X, y,
                                         block_size=64, variational=True))
    assert abs(out["warped_f32"] - warped64) < 5e-5 * abs(warped64)
    assert out["warped_grad_finite"] is True
    cls64 = float(classify_log_evidence(SeIso, p, Z, X, jnp.sign(y)))
    assert abs(out["classify_f32"] - cls64) < 2e-4 * abs(cls64)
    assert out["classify_prob_ok"] is True

"""Multi-chip sparse GP training demo.

Runs the exact data-parallel training step over a device mesh — on real
chips if several are attached, else on 8 virtual CPU devices (set before
importing jax):

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python examples/demo_multichip.py
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

if "xla_force_host_platform_device_count" not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

# Select the backend BEFORE any device query initializes it.  Default to the
# CPU mesh; set GPR_TPU_PLATFORM=gpu to run on the machine's GPUs.
jax.config.update("jax_platforms", os.environ.get("GPR_TPU_PLATFORM", "cpu"))

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from gpr_tpu.datasets import gen_data  # noqa: E402
from gpr_tpu.kernels import SeIso  # noqa: E402
from gpr_tpu.optim import make_pack  # noqa: E402
from gpr_tpu.parallel import (  # noqa: E402
    make_mesh,
    make_sharded_objective,
    sharded_predict_means,
)


def main():
    n_dev = jax.device_count()
    mesh = make_mesh(n_dev)
    print(f"mesh: {n_dev} x {jax.devices()[0].platform} devices")

    X_np, y_np, _ = gen_data(seed=0, n=8_000)
    X, y = jnp.asarray(X_np), jnp.asarray(y_np)

    params = SeIso.default_params(X, 20)
    Z = jnp.asarray(X_np[:: len(X_np) // 20][:20])
    pack = make_pack(SeIso, params, Z, float(np.var(y_np)))

    step_fn = make_sharded_objective(
        SeIso, mesh, X, y, pack, variational=True, block_size=2048
    )

    # simple gradient ascent on the packed vector, every step one sharded
    # value-and-grad with a single m^2 psum over the interconnect
    x = pack.x0
    f0 = None
    for i in range(30):
        f, g = step_fn(x)
        if f0 is None:
            f0 = float(f)
        x = x - 1e-4 * g
    print(f"evidence: {-f0:.1f} -> {-float(f):.1f} over {i + 1} sharded steps")

    params_t, z_t, sigma2_t = pack.unpack(x)
    from gpr_tpu.models.streaming import streaming_coeffs

    _, _, coeffs = streaming_coeffs(SeIso, params_t, z_t, sigma2_t, X, y)
    mu = sharded_predict_means(SeIso, mesh, params_t, z_t, coeffs, X)
    rmse = float(jnp.sqrt(jnp.mean((mu - y) ** 2)))
    print(f"sharded predict: rmse={rmse:.3f} (noise sigma 0.7)")

    # 2-D mesh (data x model): tensor parallelism over the inducing axis
    if n_dev >= 4 and n_dev % 2 == 0:
        from gpr_tpu.parallel import make_mesh_2d, sharded_log_evidence_2d

        mesh2 = make_mesh_2d(n_dev // 2, 2)
        l_2d = sharded_log_evidence_2d(
            SeIso, mesh2, params_t, z_t, sigma2_t, X, y, variational=True,
            block_size=2048,
        )
        print(f"2-D mesh ({n_dev // 2} data x 2 model) evidence: "
              f"{float(l_2d):.1f} (matches 1-D: {-float(f):.1f})")


if __name__ == "__main__":
    main()

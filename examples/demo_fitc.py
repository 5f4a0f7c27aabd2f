"""End-to-end demo — the rebuild of test/save_data.ml + test/display.R.

Trains FITC (se_iso) on the reference's synthetic benchmark, dumps the same
artifact set save_data.ml writes for its Octave/R oracles (inputs, targets,
inducing points, sigma2, hypers, means, variances, posterior samples for both
FITC and FIC flavors), and renders an ASCII fit plot instead of R.

Run: python examples/demo_fitc.py [outdir]
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

# demos run on CPU: f64 parity numerics, instant compiles
# (GPR_TPU_PLATFORM=gpu runs them on the GPU)
jax.config.update("jax_platforms", os.environ.get("GPR_TPU_PLATFORM", "cpu"))
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from gpr_tpu.datasets import gen_data, gen_data_fn  # noqa: E402
from gpr_tpu.kernels import SeIso  # noqa: E402
from gpr_tpu.models import (  # noqa: E402
    calc_stats,
    co_variance_predictor,
    cov_sample,
    cov_sampler,
    covariances_fic,
    covariances_fitc,
    mean_predictor,
    predict_means,
    predict_variances,
)
from gpr_tpu.optim import train_smd  # noqa: E402


def ascii_plot(x, y, mu, sd, f, width=90, height=22):
    lo, hi = float(np.min(y)), float(np.max(y))
    grid = [[" "] * width for _ in range(height)]

    def put(xv, yv, ch):
        c = int((xv - x.min()) / (x.max() - x.min() + 1e-12) * (width - 1))
        r = int((hi - yv) / (hi - lo + 1e-12) * (height - 1))
        if 0 <= r < height and 0 <= c < width:
            grid[r][c] = ch

    for xi, yi in zip(x[:: max(1, len(x) // 300)], y[:: max(1, len(x) // 300)]):
        put(xi, yi, ".")
    for xi, m, s in zip(x, mu, sd):
        put(xi, m - 2 * s, "-")
        put(xi, m + 2 * s, "-")
    for xi, fv in zip(x, f):
        put(xi, fv, "*")
    for xi, m in zip(x, mu):
        put(xi, m, "#")
    return "\n".join("".join(row) for row in grid)


def main(outdir="/tmp/gpr_tpu_demo"):
    os.makedirs(outdir, exist_ok=True)
    # save_data.ml config: n=1000, m=10, SMD, epsabs=3, <=1000 iters
    X_np, y_np, f_np = gen_data(seed=0, n=1000)
    X, y = jnp.asarray(X_np), jnp.asarray(y_np)

    result = train_smd(
        SeIso, X, y, n_rand_inducing=10, epsabs=3.0, max_iter=1000,
    )
    params, Z, sigma2 = result.kernel_params, result.inducing, result.sigma2
    stats = calc_stats(result.trained)
    print(
        f"trained: l={float(result.l):.2f} smse={float(stats.smse):.4f} "
        f"msll={float(stats.msll):.4f} sigma2={float(sigma2):.4f}"
    )

    mp = mean_predictor(result.trained)
    cvp = co_variance_predictor(result.model)
    means = predict_means(SeIso, params, mp, X)
    variances = predict_variances(SeIso, params, cvp, X, sigma2,
                                  predictive=False)

    key = jax.random.PRNGKey(42)
    cov_fitc = covariances_fitc(SeIso, params, cvp, X, sigma2,
                                predictive=False)
    cov_fic = covariances_fic(SeIso, params, cvp, X, sigma2, predictive=False)
    samples_fitc = cov_sample(
        key, cov_sampler(means, cov_fitc, sigma2, predictive=False), n=5
    )
    samples_fic = cov_sample(
        key, cov_sampler(means, cov_fic, sigma2, predictive=False), n=5
    )

    # the save_data.ml artifact set (test/save_data.ml:34-146), including
    # the inducing-point predictions and the single-point (one_*) queries
    from gpr_tpu.models import predict_mean_one, predict_variance_one

    inducing_means = predict_means(SeIso, params, mp, Z)
    inducing_variances = predict_variances(SeIso, params, cvp, Z, sigma2,
                                           predictive=False)
    one_inducing = Z[0]
    one_mean = predict_mean_one(SeIso, params, mp, one_inducing)
    one_variance = predict_variance_one(SeIso, params, cvp, one_inducing,
                                        sigma2, predictive=False)

    arts = {
        "inputs": X_np,
        "targets": y_np,
        "inducing_points": np.asarray(Z),
        "sigma2": np.asarray(sigma2),
        "noise_sigma2": np.asarray(sigma2),
        "log_ell": np.asarray(params.log_ell),
        "log_sf2": np.asarray(params.log_sf2),
        "means": np.asarray(means),
        "variances": np.asarray(variances),
        "inducing_means": np.asarray(inducing_means),
        "inducing_variances": np.asarray(inducing_variances),
        "one_inducing": np.asarray(one_inducing),
        "one_mean": np.asarray(one_mean),
        "one_variance": np.asarray(one_variance),
        "fitc_samples": np.asarray(samples_fitc),
        "fic_samples": np.asarray(samples_fic),
    }
    for name, arr in arts.items():
        np.savetxt(os.path.join(outdir, name), np.atleast_1d(arr))
    print(f"artifacts written to {outdir}")

    sd = np.sqrt(np.asarray(variances))
    print(ascii_plot(X_np[:, 0], y_np, np.asarray(means), sd,
                     gen_data_fn(X_np[:, 0])))
    print("legend: . data   # posterior mean   - 2sd band   * true fn")

    # graphical render (the display.R counterpart) when matplotlib exists
    try:
        import matplotlib

        matplotlib.use("Agg")
        from gpr_tpu.viz import plot_artifacts

        png = os.path.join(outdir, "fit.png")
        plot_artifacts(outdir, png)
        print(f"plot written to {png}")
    except ImportError:
        pass


if __name__ == "__main__":
    main(*sys.argv[1:])

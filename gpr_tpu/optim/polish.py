"""f64 finishing step for f32 large-n training (the "polish").

Large-n training on the accelerator runs in f32, where the gradient carries a
conditioning-noise floor (per-tile GEMM rounding; see MANUAL section 7) —
the driver-recorded round-2 run stopped at |grad| ~ 1.4e-1 on the mean-NLL
scale.  CLAUDE.md's "full convergence of hyper optimization is an x64 job"
becomes a workflow here: after the f32 phase (fit / fit_restarts) picks a
basin, :func:`polish` drives the SAME objective to a defensible stationary
point in f64.

The polish runs on the HOST CPU in a child process: x64 must be set before
backend init, the parent's JAX already holds the accelerator, and the child
gets ``JAX_PLATFORMS=cpu`` so it never opens the card (a second JAX process
on a GPU fails for want of the memory the first one reserved).  Cost is bounded two ways: ``subsample`` rows
(a uniform row subsample keeps the mean-NLL objective consistent — it is an
unbiased estimate of the same per-point quantity the f32 phase optimized)
and ``max_iter``.  The child reuses the exact library objective
(optim.train.make_objective over models/*) — no reimplementation, so the
f64 math IS the f32 math at wider precision.

Reference counterpart: none — GSL BFGS2 runs entirely in f64
(lib/fitc_gp.ml:1652-1671), so the reference never faces the two-phase
problem; this module is what restores its convergence semantics for f32
accelerator training.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


@dataclasses.dataclass
class PolishReport:
    """What the f64 phase did: objective/gradient before and after (on the
    polish objective, mean-NLL scale), iteration/eval counts, wall time."""

    f0: float
    f: float
    gnorm0: float
    gnorm: float
    n_iter: int
    n_evals: int
    n_rows: int
    wall_s: float
    converged: bool


def polish(
    family,
    X,
    y,
    pack,
    x,
    *,
    variational: bool = False,
    subsample: int | None = 100_000,
    seed: int = 0,
    max_iter: int = 40,
    epsabs: float = 1e-2,
    step: float = 0.1,
    tol: float = 0.1,
    block_size: int | None = 8192,
    timeout_s: float = 900.0,
):
    """Polish a trained hyper vector ``x`` in f64 on the host CPU.

    Returns ``(params, z, sigma2, x_polished, PolishReport)`` with arrays in
    the pack's (f32) dtype, ready for predictors or further device work.
    ``epsabs`` applies to the mean-NLL gradient norm (normalize=True, the
    f32 trainers' convention).  ``subsample`` bounds host cost; None uses
    every row.  Raises ``RuntimeError`` if the child fails or times out.
    """
    X = np.asarray(X)
    y = np.asarray(y)
    if subsample is not None and subsample < X.shape[0]:
        idx = np.random.default_rng(seed).choice(
            X.shape[0], subsample, replace=False
        )
        X, y = X[idx], y[idx]

    from ..io.checkpoint import _params_to_arrays

    params, z, sigma2 = pack.unpack(np.asarray(x, np.float64))
    arrays = {"X": X.astype(np.float64), "y": y.astype(np.float64),
              "z": np.asarray(z, np.float64)}
    params_arrays, params_static = _params_to_arrays(params)
    for k, v in params_arrays.items():
        arrays[f"param__{k}"] = np.asarray(v, np.float64)
    manifest = {
        "family": family.name,
        "params_static": params_static,
        "sigma2": float(sigma2),
        "learn_sigma2": bool(pack.learn_sigma2),
        "learn_inducing": bool(getattr(pack, "learn_inducing", True)),
        "fixed": list(getattr(pack, "fixed", ())),
        "n_hypers": int(pack.n_hypers),
        "variational": bool(variational),
        "max_iter": int(max_iter),
        "epsabs": float(epsabs),
        "step": float(step),
        "tol": float(tol),
        "block_size": block_size,
    }

    with tempfile.TemporaryDirectory(prefix="gpr_polish_") as tmp:
        in_path = os.path.join(tmp, "in.npz")
        out_path = os.path.join(tmp, "out.npz")
        with open(in_path, "wb") as fh:
            np.savez(fh, manifest=np.frombuffer(
                json.dumps(manifest).encode(), np.uint8), **arrays)
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        # keep the caller's PYTHONPATH entries AND the repo
        extra = f"{env.get('PYTHONPATH', '')}"
        env["PYTHONPATH"] = ":".join(
            p for p in (extra, REPO_ROOT) if p
        )
        proc = subprocess.run(
            [sys.executable, "-m", "gpr_tpu.optim.polish", in_path, out_path],
            env=env, capture_output=True, text=True, timeout=timeout_s,
        )
        if proc.returncode != 0 or not os.path.exists(out_path):
            raise RuntimeError(
                f"f64 polish child failed (rc={proc.returncode}):\n"
                f"{proc.stderr[-2000:]}"
            )
        with np.load(out_path) as zf:
            x_out = zf["x"]
            rep = PolishReport(
                f0=float(zf["f0"]), f=float(zf["f"]),
                gnorm0=float(zf["gnorm0"]), gnorm=float(zf["gnorm"]),
                n_iter=int(zf["n_iter"]), n_evals=int(zf["n_evals"]),
                n_rows=int(X.shape[0]), wall_s=float(zf["wall_s"]),
                converged=bool(zf["converged"]),
            )

    import jax.numpy as jnp

    x_f = jnp.asarray(x_out, jnp.asarray(pack.x0).dtype)
    params_f, z_f, sigma2_f = pack.unpack(x_f)
    return params_f, z_f, sigma2_f, x_f, rep


def evaluate_f64(
    family,
    X,
    y,
    pack,
    xs,
    *,
    variational: bool = False,
    subsample: int | None = 20_000,
    seed: int = 0,
    block_size: int | None = 8192,
    timeout_s: float = 600.0,
    normalize: bool = True,
):
    """Evaluate the library objective at each packed vector in ``xs`` on
    the host CPU in f64 — one child process, len(xs) evaluations.
    ``normalize`` selects the mean-NLL scale (the f32 trainers' default);
    pass the caller's flag so reported values are on the caller's scale.

    Why this exists: the f32 device objective can be INFLATED past its
    mathematical bounds by cancellation in degenerate basins (see
    models/streaming._evidence_terms) — a multi-start selection that trusts
    raw f32 values can pick a numerically-fictitious winner.  Ranking the
    candidates by this function is immune to every f32 pathology; a SHARED
    row subsample keeps the ranking consistent across candidates.

    Returns a list of floats (``inf`` where an evaluation failed), same
    order as ``xs``.
    """
    X = np.asarray(X)
    y = np.asarray(y)
    if subsample is not None and subsample < X.shape[0]:
        idx = np.random.default_rng(seed).choice(
            X.shape[0], subsample, replace=False
        )
        X, y = X[idx], y[idx]

    from ..io.checkpoint import _params_to_arrays

    xs_arr = np.stack([np.asarray(x, np.float64) for x in xs])
    params, z, sigma2 = pack.unpack(xs_arr[0])
    arrays = {"X": X.astype(np.float64), "y": y.astype(np.float64),
              "z": np.asarray(z, np.float64), "xs": xs_arr}
    params_arrays, params_static = _params_to_arrays(params)
    for k, v in params_arrays.items():
        arrays[f"param__{k}"] = np.asarray(v, np.float64)
    manifest = {
        "family": family.name,
        "params_static": params_static,
        "sigma2": float(sigma2),
        "learn_sigma2": bool(pack.learn_sigma2),
        "learn_inducing": bool(getattr(pack, "learn_inducing", True)),
        "fixed": list(getattr(pack, "fixed", ())),
        "n_hypers": int(xs_arr.shape[1]),
        "variational": bool(variational),
        "normalize": bool(normalize),
        "block_size": block_size,
        "eval_only": True,
    }

    with tempfile.TemporaryDirectory(prefix="gpr_eval64_") as tmp:
        in_path = os.path.join(tmp, "in.npz")
        out_path = os.path.join(tmp, "out.npz")
        with open(in_path, "wb") as fh:
            np.savez(fh, manifest=np.frombuffer(
                json.dumps(manifest).encode(), np.uint8), **arrays)
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        extra = f"{env.get('PYTHONPATH', '')}"
        env["PYTHONPATH"] = ":".join(
            p for p in (extra, REPO_ROOT) if p
        )
        proc = subprocess.run(
            [sys.executable, "-m", "gpr_tpu.optim.polish", in_path, out_path],
            env=env, capture_output=True, text=True, timeout=timeout_s,
        )
        if proc.returncode != 0 or not os.path.exists(out_path):
            raise RuntimeError(
                f"f64 eval child failed (rc={proc.returncode}):\n"
                f"{proc.stderr[-2000:]}"
            )
        with np.load(out_path) as zf:
            return [float(v) for v in zf["fs"]]


def _child(in_path: str, out_path: str) -> int:
    """Runs in a fresh process: CPU backend, x64 on, host L-BFGS on the
    library objective."""
    import time

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

    with np.load(in_path) as zf:
        manifest = json.loads(bytes(zf["manifest"].tobytes()).decode())
        data = {k: zf[k] for k in zf.files if k != "manifest"}

    from ..io.checkpoint import _params_from_arrays
    from ..kernels import resolve_family
    from .lbfgs import minimize_lbfgs
    from .pack import make_pack
    from .train import make_objective

    family = resolve_family(manifest["family"])
    params = _params_from_arrays(
        family,
        manifest["params_static"],
        {
            k[len("param__"):]: v
            for k, v in data.items()
            if k.startswith("param__")
        },
    )
    pack = make_pack(family, params, data["z"], manifest["sigma2"],
                     learn_sigma2=manifest["learn_sigma2"],
                     learn_inducing=manifest.get("learn_inducing", True),
                     fixed=tuple(manifest.get("fixed", ())))
    expected = manifest.get("n_hypers")
    if expected is not None and int(pack.n_hypers) != int(expected):
        # a silent layout mismatch here would unpack garbage hypers and
        # rank every candidate as inf (ADVICE.md r4 at commit b587de6) —
        # fail loudly instead
        print(
            f"polish child: rebuilt pack has n_hypers={pack.n_hypers}, "
            f"parent sent {expected} (ExtendedPack or non-default layout?)",
            file=sys.stderr,
        )
        return 3
    n = data["X"].shape[0]
    block = manifest["block_size"]
    if block is not None and n <= block:
        block = None  # single tile: the dense path is the same math, cheaper
    fg, _ = make_objective(
        family, data["X"], data["y"], pack,
        variational=manifest["variational"],
        normalize=manifest.get("normalize", True),
        block_size=block,
    )
    if manifest.get("eval_only"):
        fs = []
        for xv in data["xs"]:
            try:
                f, _ = fg(np.asarray(xv, np.float64))
                fs.append(float(f) if np.isfinite(f) else np.inf)
            except Exception:  # noqa: BLE001 — rank a dead point last
                fs.append(np.inf)
        tmp = f"{out_path}.tmp"
        with open(tmp, "wb") as fh:
            np.savez(fh, fs=np.asarray(fs, np.float64))
        os.replace(tmp, out_path)
        return 0
    evals = [0]

    def counted(xv):
        evals[0] += 1
        f, g = fg(xv)
        return float(f), np.asarray(g, np.float64)

    f0, g0 = counted(pack.x0)
    t0 = time.perf_counter()
    res = minimize_lbfgs(
        counted, np.asarray(pack.x0, np.float64),
        step=manifest["step"], tol=manifest["tol"],
        epsabs=manifest["epsabs"], max_iter=manifest["max_iter"],
    )
    wall = time.perf_counter() - t0
    tmp = f"{out_path}.tmp"
    with open(tmp, "wb") as fh:
        np.savez(fh, x=np.asarray(res.x, np.float64), f=res.f,
                 g=np.asarray(res.g), f0=f0, gnorm0=np.linalg.norm(g0),
                 gnorm=np.linalg.norm(res.g), n_iter=res.n_iter,
                 n_evals=evals[0], wall_s=wall, converged=res.converged)
    os.replace(tmp, out_path)
    return 0


if __name__ == "__main__":
    sys.exit(_child(sys.argv[1], sys.argv[2]))

"""Smoke test: drive the sparse-GP main path once on an NVIDIA GPU.

    python chip_smoke.py                # one GPU: phases 1-8 below
    python chip_smoke.py --four-cards   # four GPUs: the sharded paths only

Everything runs in this one process (the CLI is called in-process through
``gpr_tpu.cli.main``), at the headline shape: SeIso, n=1,000,000, d=8,
m=300, row blocks of 16384, data from ``gpr_tpu.testing.headline_data``
(seed 0).  Phases, each printing its numbers on lines of its own:

  1. device: require a GPU, print its kind, count, versions, power limit;
  2. precision map: what each matmul precision name runs as on this card;
  3. headline step: jit(value_and_grad(streaming_log_evidence)) in f64
     (against the cached f64 truth and a plain reference), f32 at the
     library default precision, and f32 at the benchmark's fast setting;
  4. flagship: SeFat variational evidence+gradient, f32 against f64;
  5. training: optim.train (host L-BFGS) and optim.fit (device L-BFGS);
  6. predict: blocked means and variances on 1M points, f32 against f64;
  7. CLI: -cmd train / -cmd test on a seeded 50k-row CSV;
  8. compensated sums: the f32 two-sum carries against f64.

A failed check raises and the script exits nonzero.  The last line of
standard output is one JSON object naming the device.  Files (the CLI's
CSV and model) go to ``--out``.  Exits nonzero on a machine without a GPU.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
N, D, M, BLOCK = 1_000_000, 8, 300, 16384
# Gates, relative to the f64 result of the same quantity.
PARITY_RTOL = 1e-6  # f64 evidence vs the cached truth / a plain reference
F32_EVIDENCE_RTOL = 1e-5  # f32 evidence at matmul_precision="highest"
F32_GRAD_RTOL = 1e-3  # ||g32 - g64|| / ||g64||
F32_PREDICT_RTOL = 1e-3  # ||p32 - p64|| / ||p64|| for means and variances


class SmokeFailure(AssertionError):
    """A phase's check failed."""


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg):
    print(msg, flush=True)


def rel(a, b):
    """|a - b| / |b| for scalars, ||a - b|| / ||b|| for arrays/pytrees."""
    fa = np.concatenate([np.ravel(np.asarray(x, np.float64))
                         for x in _leaves(a)])
    fb = np.concatenate([np.ravel(np.asarray(x, np.float64))
                         for x in _leaves(b)])
    return float(np.linalg.norm(fa - fb) / np.linalg.norm(fb))


def _leaves(t):
    import jax

    return jax.tree.leaves(t)


@contextlib.contextmanager
def x64(enabled: bool):
    import jax

    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", enabled)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", old)


@contextlib.contextmanager
def precision(matmul: str, acc: str | None = None):
    """Library matmul precision (read when a function is traced)."""
    from gpr_tpu.config import config

    old = (config.matmul_precision, config.acc_precision)
    config.matmul_precision, config.acc_precision = matmul, acc
    try:
        yield
    finally:
        config.matmul_precision, config.acc_precision = old


def timed_compile(fn, *args):
    """(compiled, seconds): lower + compile outside any timing window."""
    import jax

    t0 = time.perf_counter()
    # a fresh function each time: jit caches traces by function, and the
    # library reads its precision config only when tracing
    compiled = jax.jit(lambda *a: fn(*a)).lower(*args).compile()
    return compiled, time.perf_counter() - t0


def steady_ms(compiled, *args, iters=10):
    """(median, min) ms per call over ``iters`` calls after one warm call,
    each call waited on with block_until_ready."""
    import jax

    jax.block_until_ready(compiled(*args))
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(compiled(*args))
        ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ts)), float(np.min(ts))


def memory_line(compiled):
    """compiled.memory_analysis() and the device's peak bytes in use."""
    import jax

    ma = compiled.memory_analysis()
    fields = ("argument_size_in_bytes", "output_size_in_bytes",
              "temp_size_in_bytes", "generated_code_size_in_bytes")
    parts = [f"{f.replace('_size_in_bytes', '')}={getattr(ma, f)}"
             for f in fields if ma is not None and hasattr(ma, f)]
    stats = jax.devices()[0].memory_stats() or {}
    parts.append(f"peak_bytes_in_use={stats.get('peak_bytes_in_use', 'n/a')}")
    return " ".join(parts)


# -- phase 1 -----------------------------------------------------------------


def require_gpu():
    """The first device, which must be a GPU: no CPU fallback."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(
            f"chip_smoke: no GPU found (JAX's first device is "
            f"{dev.platform!r}); this script measures nothing elsewhere"
        )
    return dev


def nvidia_smi():
    """The card's name and power limit as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def phase_device(dev):
    import jax
    import jaxlib

    log(f"phase 1 device: platform={dev.platform} kind={dev.device_kind} "
        f"count={len(jax.devices())} jax={jax.__version__} "
        f"jaxlib={jaxlib.__version__}")
    log(f"phase 1 nvidia-smi: {nvidia_smi()}")


def contract_line(dev, count):
    """The last line: what device the run used."""
    return json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": count}})


# -- phase 2 -----------------------------------------------------------------

_HLO_PATTERNS = (
    r'custom_call_target="([^"]+)"',
    r'"algorithm":"([A-Z0-9_]+)"',
    r'operand_precision=\{([^}]*)\}',
    r'"operand_precision":\[([^\]]*)\]',
    r'"kind":"(__triton[a-z_]*)"',
)


def gemm_lowering(hlo_text):
    """What XLA chose for the dots in compiled HLO text: custom-call
    targets, algorithms and operand precisions, de-duplicated."""
    found = []
    for pat in _HLO_PATTERNS:
        for hit in re.findall(pat, hlo_text):
            if hit not in found:
                found.append(hit)
    return ", ".join(found) if found else "plain dot"


def phase_precision(size=4096, seed=0):
    """Relative error of an f32 (size, size) product at each precision,
    against the f64 product of the same f32 values on the device."""
    import jax
    import jax.numpy as jnp

    lax = jax.lax
    rng = np.random.default_rng(seed)
    a32 = rng.standard_normal((size, size)).astype(np.float32)
    b32 = rng.standard_normal((size, size)).astype(np.float32)
    with x64(True):
        ref = np.asarray(jnp.matmul(jnp.asarray(a32, jnp.float64),
                                    jnp.asarray(b32, jnp.float64),
                                    precision=lax.Precision.HIGHEST))
    out = {}
    with x64(False):
        a, b = jnp.asarray(a32), jnp.asarray(b32)
        cases = {
            "DEFAULT": lambda x, y: jnp.matmul(
                x, y, precision=lax.Precision.DEFAULT),
            "HIGH": lambda x, y: jnp.matmul(
                x, y, precision=lax.Precision.HIGH),
            "HIGHEST": lambda x, y: jnp.matmul(
                x, y, precision=lax.Precision.HIGHEST),
            "bare jnp.matmul": jnp.matmul,
        }
        for name, f in cases.items():
            compiled, _ = timed_compile(f, a, b)
            c = np.asarray(compiled(a, b), np.float64)
            err = rel(c, ref)
            ms, _ = steady_ms(compiled, a, b, iters=5)
            how = gemm_lowering(compiled.as_text())
            out[name] = err
            log(f"phase 2 precision {name}: rel_err={err:.3e} "
                f"ms={ms:.3f} lowering=[{how}]")
    check(np.isfinite(list(out.values())).all(), "non-finite product")
    check(out["HIGHEST"] <= 1e-5,
          f"HIGHEST f32 product error {out['HIGHEST']:.3e} is not f32-class")
    names = {"highest": "HIGHEST", "high": "HIGH", "default": "DEFAULT"}
    log("phase 2 config names: " + ", ".join(
        f"matmul_precision={k!r} -> {v} ({out[v]:.1e})"
        for k, v in names.items()))
    return out


# -- phase 3 -----------------------------------------------------------------


def _se_iso_params(dtype):
    import jax.numpy as jnp

    from gpr_tpu.kernels import SeIso

    return SeIso.Params(log_ell=jnp.asarray(0.5, dtype),
                        log_sf2=jnp.asarray(0.0, dtype))


def _vg_run(label, f, args, iters):
    """Compile and time jit(f); returns (value, grads, ms)."""
    compiled, compile_s = timed_compile(f, *args)
    val, grads = compiled(*args)
    med, best = steady_ms(compiled, *args, iters=iters)
    log(f"{label}: compile_s={compile_s:.1f} ms_per_iter={med:.2f} "
        f"(min {best:.2f}, {iters} calls)")
    log(f"{label} memory: {memory_line(compiled)}")
    return float(val), grads, med


def phase_headline(n=N, d=D, m=M, block=BLOCK, iters=10, truth=None):
    """Evidence + gradient of the headline step in f64, f32 "highest" and
    f32 fast ("high", acc "default").  ``truth`` is the cached f64
    evidence of this data (checked with the plain reference too)."""
    import jax
    import jax.numpy as jnp

    from gpr_tpu.kernels import SeIso
    from gpr_tpu.models.streaming import streaming_log_evidence
    from gpr_tpu.testing import headline_data, reference_evidence_se_iso

    Xn, yn, Zn = headline_data(n, d, m)

    def f(params, z, sigma2, X, y):
        return streaming_log_evidence(SeIso, params, z, sigma2, X, y,
                                      block_size=block, jitter=1e-6)

    vg = jax.value_and_grad(f, argnums=(0, 1, 2))
    res = {}
    with x64(True):
        dt = jnp.float64
        X, y, Z = (jnp.asarray(a, dt) for a in (Xn, yn, Zn))
        args = (_se_iso_params(dt), Z, jnp.asarray(0.1, dt), X, y)
        ref = float(jax.jit(
            lambda X, y, Z: reference_evidence_se_iso(X, y, Z, 0.5, 0.0, 0.1)
        )(X, y, Z))
        ev64, g64, res["ms_f64"] = _vg_run("phase 3 f64", vg, args,
                                           max(3, iters // 3))
    if truth is None:
        truth = ref
    log(f"phase 3 f64: evidence={ev64:.4f} reference={ref:.4f} "
        f"truth={truth:.1f} err_vs_truth={ev64 - truth:+.4f} "
        f"rel={abs(ev64 - truth) / abs(truth):.2e}")
    check(abs(ref - truth) <= PARITY_RTOL * abs(truth),
          f"plain f64 reference {ref} misses the truth {truth}")
    check(abs(ev64 - truth) <= PARITY_RTOL * abs(truth),
          f"f64 evidence {ev64} misses the truth {truth} by more than "
          f"{PARITY_RTOL:g} relative")
    with x64(False):
        dt = jnp.float32
        X, y, Z = (jnp.asarray(a, dt) for a in (Xn, yn, Zn))
        args = (_se_iso_params(dt), Z, jnp.asarray(0.1, dt), X, y)
        for label, mm, acc in (("highest", "highest", None),
                               ("fast", "high", "default")):
            with precision(mm, acc):
                ev, g, ms = _vg_run(f"phase 3 f32 {label}", vg, args, iters)
            e_rel, g_rel = abs(ev - ev64) / abs(ev64), rel(g, g64)
            log(f"phase 3 f32 {label} (matmul={mm}, acc={acc}): "
                f"evidence={ev:.4f} err={ev - ev64:+.4f} rel={e_rel:.2e} "
                f"grad_rel={g_rel:.2e}")
            res[label] = (e_rel, g_rel)
            res[f"ms_{label}"] = ms
            check(np.isfinite(ev) and all(
                np.isfinite(np.asarray(x)).all() for x in _leaves(g)),
                f"f32 {label}: non-finite evidence or gradient")
    check(res["highest"][0] <= F32_EVIDENCE_RTOL,
          f"f32 highest evidence off by {res['highest'][0]:.2e} relative")
    check(res["highest"][1] <= F32_GRAD_RTOL,
          f"f32 highest gradient off by {res['highest'][1]:.2e} relative")
    return res


# -- phase 4 -----------------------------------------------------------------


def phase_flagship(n=N, d=D, m=M, block=BLOCK, iters=10):
    """SeFat variational evidence + gradient: f64 streaming against the
    dense f64 path, f32 "highest" against f64 streaming."""
    import jax
    import jax.numpy as jnp

    from gpr_tpu.kernels import SeFat
    from gpr_tpu.models.fitc import log_evidence
    from gpr_tpu.models.streaming import streaming_log_evidence
    from gpr_tpu.testing import headline_data

    Xn, yn, _ = headline_data(n, d, m)
    tproj = (np.random.default_rng(1).standard_normal((d, d)) / d)

    def data(dt):
        params = SeFat.Params(
            d=d, log_sf2=jnp.asarray(0.1, dt),
            tproj=jnp.asarray(tproj, dt),
            log_hetero_skedasticity=jnp.full((m,), -5.0, dt),
            log_multiscales_m05=jnp.zeros((m, d), dt),
        )
        X, y = jnp.asarray(Xn, dt), jnp.asarray(yn, dt)
        Z = SeFat.inducing_from_inputs(params, X[:m])
        return params, Z, jnp.asarray(0.1, dt), X, y

    def f(p, z, s2, X, y):
        return streaming_log_evidence(SeFat, p, z, s2, X, y, variational=True,
                                      block_size=block, jitter=1e-6)

    vg = jax.value_and_grad(f, argnums=(0, 1, 2))
    with x64(True):
        args = data(jnp.float64)
        dense = float(jax.jit(lambda p, z, s2, X, y: log_evidence(
            SeFat, p, z, s2, X, y, variational=True, factorization="chol",
            jitter=1e-6))(*args))
        ev64, g64, _ = _vg_run("phase 4 f64", vg, args, max(3, iters // 3))
    d_rel = abs(ev64 - dense) / abs(dense)
    log(f"phase 4 f64: streaming={ev64:.4f} dense={dense:.4f} rel={d_rel:.2e}")
    check(d_rel <= PARITY_RTOL,
          f"se_fat f64 streaming {ev64} vs dense {dense}: {d_rel:.2e}")
    with x64(False), precision("highest"):
        ev, g, _ = _vg_run("phase 4 f32 highest", vg, data(jnp.float32),
                           iters)
    e_rel, g_rel = abs(ev - ev64) / abs(ev64), rel(g, g64)
    log(f"phase 4 f32 highest: evidence={ev:.4f} err={ev - ev64:+.4f} "
        f"rel={e_rel:.2e} grad_rel={g_rel:.2e}")
    check(e_rel <= F32_EVIDENCE_RTOL,
          f"se_fat f32 evidence off by {e_rel:.2e}")
    check(g_rel <= F32_GRAD_RTOL, f"se_fat f32 gradient off by {g_rel:.2e}")
    return e_rel, g_rel


# -- phase 5 -----------------------------------------------------------------


def structured_target(X, seed=2):
    """sin(X w) + 0.3 noise with w = 0.2 + 0.3 k: the benchmark's
    training target."""
    d = X.shape[1]
    noise = np.random.default_rng(seed).standard_normal(X.shape[0])
    return (np.sin(X @ (np.arange(d) * 0.3 + 0.2)) + 0.3 * noise).astype(
        np.float32)


def phase_training(n=N, d=D, m=M, block=BLOCK, train_iters=3, fit_iters=20):
    """optim.train (README quick start) for a few iterations, then
    optim.fit (device L-BFGS) for ``fit_iters``: the objective must fall
    and the line search must not fail."""
    import jax.numpy as jnp

    from gpr_tpu.kernels import SeIso
    from gpr_tpu.optim import fit, make_objective, make_pack, train
    from gpr_tpu.testing import headline_data

    Xn, _, Zn = headline_data(n, d, m)
    yn = structured_target(Xn)
    with x64(False), precision("highest"):
        X, y, Z = jnp.asarray(Xn), jnp.asarray(yn), jnp.asarray(Zn)
        params = _se_iso_params(jnp.float32)
        norms = []
        t0 = time.perf_counter()
        res = train(SeIso, X, y, kernel_params=params, inducing=Z,
                    sigma2=1.0, block_size=block, max_iter=train_iters,
                    report_gradient_norm=lambda iter, norm: norms.append(
                        norm))
        l_train = float(res.trained.l)
        log(f"phase 5 train: {len(norms)} iterations, evidence={l_train:.2f}"
            f" |grad|={norms[-1] if norms else float('nan'):.3e} "
            f"wall_s={time.perf_counter() - t0:.1f}")
        check(norms and np.isfinite(l_train),
              "optim.train ran no iteration or ended non-finite")

        pack = make_pack(SeIso, params, Z, 1.0)
        f0 = float(make_objective(SeIso, X, y, pack, variational=True,
                                  normalize=True, block_size=block)[0](
                                      pack.x0)[0])
        t0 = time.perf_counter()
        *_, st = fit(SeIso, X, y, pack, variational=True,
                     streaming_block_size=block, max_iter=fit_iters,
                     epsabs=1e-6, dispatch_iters=fit_iters)
        f1 = float(st.f)
        log(f"phase 5 fit: mean-NLL {f0:.5f} -> {f1:.5f} in "
            f"{int(st.n_iter)} iterations / {int(st.n_evals)} evaluations, "
            f"failed={bool(st.failed)} wall_s={time.perf_counter() - t0:.1f}")
    check(not bool(st.failed), "device L-BFGS line search failed")
    check(f1 < f0, f"objective did not fall: {f0} -> {f1}")
    return f0, f1


# -- phase 6 -----------------------------------------------------------------


def phase_predict(n=N, d=D, m=M, block=BLOCK, iters=10):
    """Blocked predictive means and variances on n points, f32 against the
    same code in f64; prints points per second."""
    import jax
    import jax.numpy as jnp

    from gpr_tpu.kernels import SeIso
    from gpr_tpu.models.streaming import (
        predict_means_blocked,
        predict_variances_blocked,
        streaming_coeffs,
    )
    from gpr_tpu.testing import headline_data

    Xn, yn, Zn = headline_data(n, d, m)

    def predict(p, z, s2, X, y):
        inducing, r_mat, coeffs = streaming_coeffs(
            SeIso, p, z, s2, X, y, block_size=block)
        return inducing.chol_km, r_mat, coeffs

    def means(p, z, coeffs, X):
        return predict_means_blocked(SeIso, p, z, coeffs, X,
                                     block_size=block)

    def variances(p, z, chol_km, r_mat, X, s2):
        return predict_variances_blocked(SeIso, p, z, chol_km, r_mat, X, s2,
                                         block_size=block)

    outs = {}
    for label, enabled, dt in (("f64", True, jnp.float64),
                               ("f32", False, jnp.float32)):
        with x64(enabled), precision("highest"):
            p = _se_iso_params(dt)
            X, y, Z = (jnp.asarray(a, dt) for a in (Xn, yn, Zn))
            s2 = jnp.asarray(0.1, dt)
            chol_km, r_mat, coeffs = jax.jit(predict)(p, Z, s2, X, y)
            cm, _ = timed_compile(means, p, Z, coeffs, X)
            cv, _ = timed_compile(variances, p, Z, chol_km, r_mat, X, s2)
            mu = np.asarray(cm(p, Z, coeffs, X))
            var = np.asarray(cv(p, Z, chol_km, r_mat, X, s2))
            ms_m, _ = steady_ms(cm, p, Z, coeffs, X, iters=iters)
            ms_v, _ = steady_ms(cv, p, Z, chol_km, r_mat, X, s2, iters=iters)
            log(f"phase 6 {label}: means {n / ms_m / 1e3:.1f} M points/s "
                f"({ms_m:.2f} ms), variances {n / ms_v / 1e3:.1f} M points/s"
                f" ({ms_v:.2f} ms)")
            outs[label] = (mu, var)
    m_rel = rel(outs["f32"][0], outs["f64"][0])
    v_rel = rel(outs["f32"][1], outs["f64"][1])
    log(f"phase 6 f32 vs f64: means rel={m_rel:.2e} variances rel={v_rel:.2e}")
    check(np.isfinite(outs["f32"][0]).all() and np.isfinite(
        outs["f32"][1]).all(), "non-finite predictions")
    check(m_rel <= F32_PREDICT_RTOL, f"f32 means off by {m_rel:.2e}")
    check(v_rel <= F32_PREDICT_RTOL, f"f32 variances off by {v_rel:.2e}")
    return m_rel, v_rel


# -- phase 7 -----------------------------------------------------------------


def _run_cli(argv, stdin_path):
    """gpr_tpu.cli.main in-process; returns its standard output."""
    from gpr_tpu import cli

    out = io.StringIO()
    with open(stdin_path) as fh:
        old = sys.stdin
        sys.stdin = fh
        try:
            with contextlib.redirect_stdout(out):
                rc = cli.main(argv)
        finally:
            sys.stdin = old
    check(rc == 0, f"cli {argv} returned {rc}")
    return out.getvalue()


def phase_cli(out_dir, n=50_000, d=8, n_test=5_000, n_inducing=100,
              max_iter=30):
    """``-cmd train`` then ``-cmd test`` on a seeded CSV; SMSE < 0.5."""
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(3)
    X = rng.standard_normal((n + n_test, d))
    f = np.sin(0.5 * X.sum(axis=1))
    y = f + 0.1 * rng.standard_normal(n + n_test)
    train_csv = os.path.join(out_dir, "train.csv")
    test_csv = os.path.join(out_dir, "test.csv")
    model = os.path.join(out_dir, "model.npz")
    np.savetxt(train_csv, np.column_stack([X[:n], y[:n]]), fmt="%.8f",
               delimiter=",")
    np.savetxt(test_csv, X[n:], fmt="%.8f", delimiter=",")
    t0 = time.perf_counter()
    _run_cli(["-cmd", "train", "-model", model, "-kernel", "se_iso",
              "-n-inducing", str(n_inducing), "-max-iter", str(max_iter),
              "-seed", "0"], train_csv)
    t_train = time.perf_counter() - t0
    pred = np.array([float(v) for v in _run_cli(
        ["-cmd", "test", "-model", model], test_csv).split()])
    check(pred.shape == (n_test,), f"expected {n_test} predictions, got "
          f"{pred.shape}")
    truth = y[n:]
    smse = float(np.mean((pred - truth) ** 2) / np.var(truth))
    log(f"phase 7 cli: {n} rows train_s={t_train:.1f} "
        f"{n_test} predictions SMSE={smse:.4f}")
    check(smse < 0.5, f"CLI predictions SMSE {smse:.3f} >= 0.5")
    return smse


# -- phase 8 -----------------------------------------------------------------


def phase_two_sum(length=65536, lanes=256, seed=0):
    """f32 sums of ``length`` uniform terms per lane: plain carries and
    the compensated two-sum carries of models/stream_grad, in ulps of the
    f64 sum."""
    import jax
    import jax.numpy as jnp

    from gpr_tpu.models.stream_grad import _two_sum

    with x64(False):
        x = jax.random.uniform(jax.random.PRNGKey(seed), (length, lanes),
                               jnp.float32)

        @jax.jit
        def sums(x):
            def body(c, xt):
                plain, hi, lo = c
                hi, lo = _two_sum(hi, lo, xt)
                return (plain + xt, hi, lo), None

            z = jnp.zeros((lanes,), jnp.float32)
            (plain, hi, lo), _ = jax.lax.scan(body, (z, z, z), x)
            return plain, hi + lo

        plain, comp = (np.asarray(a, np.float64) for a in sums(x))
    exact = np.asarray(x, np.float64).sum(axis=0)
    ulp = np.spacing(exact.astype(np.float32)).astype(np.float64)
    e_plain = np.abs(plain - exact) / ulp
    e_comp = np.abs(comp - exact) / ulp
    log(f"phase 8 two-sum: T={length} lanes={lanes} plain ulps "
        f"median={np.median(e_plain):.2f} max={e_plain.max():.2f} "
        f"(sqrt T={np.sqrt(length):.0f}); compensated ulps "
        f"median={np.median(e_comp):.2f} max={e_comp.max():.2f}")
    check(e_comp.max() <= 1.0,
          f"compensated sum off by {e_comp.max():.2f} ulps")
    check(np.median(e_plain) > 4 * max(np.median(e_comp), 0.25),
          "plain sums are as accurate as compensated ones: the check "
          "cannot tell them apart")
    return float(np.median(e_plain)), float(e_comp.max())


# -- four cards --------------------------------------------------------------


def phase_four_cards(n=N, d=D, m=M, block=BLOCK, n_dev=4, fit_iters=5):
    """The sharded paths on an n_dev-device 1-D mesh and a 2 x (n_dev/2)
    mesh, each against the single-device result."""
    import jax
    import jax.numpy as jnp

    from gpr_tpu.kernels import SeIso
    from gpr_tpu.models.streaming import streaming_log_evidence
    from gpr_tpu.optim import make_objective, make_pack
    from gpr_tpu.parallel import (
        fit_sharded,
        make_mesh,
        make_sharded_objective,
        shard_batch,
    )
    from gpr_tpu.parallel.mesh2d import make_mesh_2d, sharded_log_evidence_2d
    from gpr_tpu.testing import headline_data

    check(len(jax.devices()) >= n_dev,
          f"need {n_dev} devices, have {len(jax.devices())}")
    Xn, _, Zn = headline_data(n, d, m)
    yn = structured_target(Xn)
    with x64(False), precision("highest"):
        X, y, Z = jnp.asarray(Xn), jnp.asarray(yn), jnp.asarray(Zn)
        params = _se_iso_params(jnp.float32)
        s2 = jnp.asarray(0.1, jnp.float32)
        pack = make_pack(SeIso, params, Z, 0.1)
        mesh = make_mesh(n_dev)
        Xs, ys, _ = shard_batch(mesh, X, y)
        for sh in Xs.addressable_shards:
            log(f"four-cards shard: device={sh.device} rows={sh.index[0]} "
                f"shape={sh.data.shape}")
        check(len({sh.device for sh in Xs.addressable_shards}) == n_dev,
              "data did not land on every device")

        f1, g1 = make_objective(SeIso, X, y, pack, block_size=block)[0](
            pack.x0)
        fs, gs = make_sharded_objective(SeIso, mesh, Xs, ys, pack,
                                        block_size=block)(pack.x0)
        v_rel, g_rel = rel(fs, f1), rel(gs, g1)
        log(f"four-cards 1-D mesh: value={float(fs):.4f} single="
            f"{float(f1):.4f} rel={v_rel:.2e} grad_rel={g_rel:.2e}")
        check(v_rel <= F32_EVIDENCE_RTOL and g_rel <= F32_GRAD_RTOL,
              "sharded objective disagrees with the single-device one")

        t0 = time.perf_counter()
        *_, st = fit_sharded(SeIso, mesh, Xs, ys, pack, block_size=block,
                             max_iter=fit_iters, dispatch_iters=fit_iters,
                             epsabs=1e-6)
        log(f"four-cards fit_sharded: mean-NLL {float(fs) / n:.5f} -> "
            f"{float(st.f):.5f} in {int(st.n_iter)} iterations, "
            f"failed={bool(st.failed)} wall_s={time.perf_counter() - t0:.1f}")
        check(not bool(st.failed) and float(st.f) < float(fs) / n,
              "fit_sharded did not lower the objective")

        def ev1(p, z, s2):
            return streaming_log_evidence(SeIso, p, z, s2, X, y,
                                          block_size=block)

        l1, gl1 = jax.jit(jax.value_and_grad(ev1, argnums=(0, 1, 2)))(
            params, Z, s2)
        mesh2 = make_mesh_2d(2, n_dev // 2)
        for epi in ("replicated", "distributed"):
            def ev2(p, z, s2, epi=epi):
                return sharded_log_evidence_2d(
                    SeIso, mesh2, p, z, s2, X, y, block_size=block,
                    epilogue=epi)

            l2, gl2 = jax.jit(jax.value_and_grad(ev2, argnums=(0, 1, 2)))(
                params, Z, s2)
            v_rel, g_rel = rel(l2, l1), rel(gl2, gl1)
            log(f"four-cards 2x{n_dev // 2} mesh {epi}: evidence="
                f"{float(l2):.4f} single={float(l1):.4f} rel={v_rel:.2e} "
                f"grad_rel={g_rel:.2e}")
            check(v_rel <= F32_EVIDENCE_RTOL and g_rel <= F32_GRAD_RTOL,
                  f"2-D mesh ({epi}) disagrees with the single device")


# -- main --------------------------------------------------------------------


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded paths, on four GPUs")
    ap.add_argument("--out", default=os.path.join(HERE, ".smoke_out"),
                    help="directory for the CLI phase's files")
    args = ap.parse_args(argv)

    import jax

    dev = require_gpu()
    from gpr_tpu.testing import HEADLINE_F64_EVIDENCE
    from gpr_tpu.utils import use_compile_cache

    log(f"compile cache: {use_compile_cache()}")
    phase_device(dev)
    t_all = time.perf_counter()
    if args.four_cards:
        phases = [("four cards", phase_four_cards, {})]
    else:
        phases = [
            ("precision map", phase_precision, {}),
            ("headline step", phase_headline,
             {"truth": HEADLINE_F64_EVIDENCE}),
            ("flagship", phase_flagship, {}),
            ("training", phase_training, {}),
            ("predict", phase_predict, {}),
            ("cli", phase_cli, {"out_dir": args.out}),
            ("compensated sums", phase_two_sum, {}),
        ]
    for name, fn, kw in phases:
        t0 = time.perf_counter()
        fn(**kw)
        log(f"{name}: passed in {time.perf_counter() - t0:.1f}s")
    log(f"all phases passed in {time.perf_counter() - t_all:.1f}s")
    print(contract_line(dev, len(jax.devices())), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""CLI train/test round-trip (CSV over stdin — the reference's protocol,
bin/ocaml_gpr.ml) and checkpoint save/load.

CLI invocations run IN-PROCESS by default (``gpr_tpu.cli.main(argv)`` with
redirected stdio): one real-subprocess smoke test
(test_cli_train_test_roundtrip) covers the actual process boundary, and
skipping ~12 further interpreter+jax startups keeps the suite's wall clock
sane (VERDICT.md round-2 #8 at commit b587de6).  The in-process environment matches the
subprocess one: the CLI itself forces x64, and the conftest backend is
already cpu."""

import contextlib
import io
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gpr_tpu.io import ModelArtifact, load_model, save_model
from gpr_tpu.kernels import SeFat, SeIso
from gpr_tpu.models import calc_model, calc_trained

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_cli_subprocess(args, stdin_text, timeout=300):
    """The real process boundary — used by the smoke test only."""
    env = dict(os.environ)
    env["GPR_TPU_PLATFORM"] = "cpu"
    return subprocess.run(
        [sys.executable, "-m", "gpr_tpu.cli", *args],
        input=stdin_text, capture_output=True, text=True, cwd=REPO, env=env,
        timeout=timeout,
    )


def run_cli(args, stdin_text, timeout=None):
    """In-process CLI call with the subprocess interface (returncode/
    stdout/stderr).  SystemExit carrying a message lands in stderr with
    rc=1, matching how the interpreter reports it."""
    import gpr_tpu.cli as cli

    out, err = io.StringIO(), io.StringIO()
    old_stdin = sys.stdin
    try:
        sys.stdin = io.StringIO(stdin_text)
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            try:
                code = cli.main(list(args)) or 0
            except SystemExit as e:
                if e.code is None:
                    code = 0
                elif isinstance(e.code, int):
                    code = e.code
                else:
                    err.write(f"{e.code}\n")
                    code = 1
    finally:
        sys.stdin = old_stdin
    return subprocess.CompletedProcess(
        list(args), code, out.getvalue(), err.getvalue()
    )


def make_csv(rng, n=120, d=2, with_target=True):
    X = rng.standard_normal((n, d))
    y = np.sin(X.sum(axis=1)) + 0.1 * rng.standard_normal(n)
    rows = []
    for i in range(n):
        cols = list(X[i]) + ([y[i]] if with_target else [])
        rows.append(",".join(f"{v:.8f}" for v in cols))
    return "\n".join(rows) + "\n", X, y


@pytest.mark.slow
def test_cli_train_test_roundtrip(tmp_path, rng):
    model_file = str(tmp_path / "model.npz")
    csv, X, y = make_csv(rng)
    res = run_cli_subprocess(
        ["-cmd", "train", "-model", model_file, "-n-inducing", "8",
         "-max-iter", "20", "-seed", "7", "-verbose"],
        csv,
    )
    assert res.returncode == 0, res.stderr
    assert os.path.exists(model_file)
    assert "target variance" in res.stderr

    test_csv, Xt, _ = make_csv(rng, n=30, with_target=False)
    res = run_cli_subprocess(["-cmd", "test", "-model", model_file], test_csv)
    assert res.returncode == 0, res.stderr
    means = [float(line) for line in res.stdout.strip().splitlines()]
    assert len(means) == 30
    assert all(np.isfinite(means))
    # predictions should be in a sane range around the target scale
    assert max(abs(m) for m in means) < 10.0

    res = run_cli(
        ["-cmd", "test", "-model", model_file, "-with-stddev", "-predictive"],
        test_csv,
    )
    assert res.returncode == 0, res.stderr
    for line in res.stdout.strip().splitlines():
        mean, sd = map(float, line.split(","))
        assert np.isfinite(mean) and sd > 0


@pytest.mark.slow
def test_cli_all_kernel_options(tmp_path, rng):
    model_file = str(tmp_path / "model.npz")
    csv, _, _ = make_csv(rng, n=80, d=5)
    res = run_cli(
        ["-cmd", "train", "-model", model_file, "-n-inducing", "5",
         "-max-iter", "8", "-dim-red", "3", "-log-het-sked", "-3.0",
         "-multiscale", "-seed", "3"],
        csv,
    )
    assert res.returncode == 0, res.stderr
    test_csv, _, _ = make_csv(rng, n=10, d=5, with_target=False)
    res = run_cli(["-cmd", "test", "-model", model_file, "-with-stddev"],
                  test_csv)
    assert res.returncode == 0, res.stderr
    assert len(res.stdout.strip().splitlines()) == 10


def test_cli_bad_input(tmp_path):
    res = run_cli(["-cmd", "train", "-model", str(tmp_path / "m.npz")],
                  "1.0,2.0\n1.0\n")
    assert res.returncode != 0
    assert "incompatible dimension" in res.stderr


def test_checkpoint_roundtrip(tmp_path, rng):
    X = jnp.asarray(rng.standard_normal((40, 3)))
    y = jnp.asarray(rng.standard_normal(40))
    Z = jnp.asarray(rng.standard_normal((6, 3)))
    p = SeIso.Params(log_ell=jnp.asarray(0.2), log_sf2=jnp.asarray(-0.1))
    model = calc_model(SeIso, p, X, Z, 0.4)
    trained = calc_trained(model, y)
    art = ModelArtifact(
        family_name="se_iso",
        kernel_params=p,
        inducing=np.asarray(Z),
        coeffs=np.asarray(trained.coeffs),
        chol_km=np.asarray(model.inducing.chol_km),
        r_mat=np.asarray(model.r_mat),
        sigma2=0.4,
        target_mean=1.5,
        input_means=np.zeros(3),
        input_stddevs=np.ones(3),
    )
    path = str(tmp_path / "m.npz")
    save_model(path, art, extra_arrays={"opt_state": np.arange(5.0)})
    art2, extra = load_model(path)
    assert art2.family is SeIso
    np.testing.assert_allclose(art2.coeffs, art.coeffs)
    np.testing.assert_allclose(
        float(art2.kernel_params.log_ell), 0.2, rtol=1e-12
    )
    np.testing.assert_allclose(extra["opt_state"], np.arange(5.0))
    assert art2.target_mean == 1.5


def test_checkpoint_se_fat_optional_none(tmp_path, rng):
    X = jnp.asarray(rng.standard_normal((30, 4)))
    p = SeFat.Params(
        d=4, log_sf2=jnp.asarray(0.1), tproj=None,
        log_hetero_skedasticity=None, log_multiscales_m05=None,
    )
    Z = SeFat.inducing_from_inputs(p, X[:5])
    model = calc_model(SeFat, p, X, Z, 0.5)
    trained = calc_trained(model, jnp.asarray(rng.standard_normal(30)))
    art = ModelArtifact(
        family_name="se_fat", kernel_params=p, inducing=np.asarray(Z),
        coeffs=np.asarray(trained.coeffs),
        chol_km=np.asarray(model.inducing.chol_km),
        r_mat=np.asarray(model.r_mat), sigma2=0.5, target_mean=0.0,
        input_means=np.zeros(4), input_stddevs=np.ones(4),
    )
    path = str(tmp_path / "m.npz")
    save_model(path, art)
    art2, _ = load_model(path)
    assert art2.kernel_params.tproj is None
    assert art2.kernel_params.d == 4


def test_cli_checkpoint_resume(tmp_path):
    """-checkpoint/-resume: an interrupted CLI run continues to the same
    model as an uninterrupted one (fixed seed => same data pipeline)."""
    import subprocess
    import sys

    import numpy as np

    from gpr_tpu.datasets import gen_data

    X, y, _ = gen_data(5, n=120)
    csv = "\n".join(
        ",".join(str(v) for v in list(row) + [t]) for row, t in zip(X, y)
    )

    def run(extra, model):
        res = run_cli(
            ["-cmd", "train", "-model", str(model), "-n-inducing", "5",
             "-dim-red", "1", "-seed", "7", *extra],
            csv, timeout=600,
        )
        assert res.returncode == 0, res.stderr[-2000:]

    full = tmp_path / "full.npz"
    run(["-max-iter", "12"], full)

    ckpt = str(tmp_path / "train.ckpt.npz")
    part = tmp_path / "part.npz"
    run(["-max-iter", "5", "-checkpoint", ckpt], part)
    resumed = tmp_path / "resumed.npz"
    run(["-max-iter", "12", "-checkpoint", ckpt, "-resume"], resumed)

    from gpr_tpu.io import load_model

    a_full, _ = load_model(str(full))
    a_res, _ = load_model(str(resumed))
    np.testing.assert_allclose(a_res.coeffs, a_full.coeffs, rtol=1e-8,
                               atol=1e-10)
    np.testing.assert_allclose(a_res.inducing, a_full.inducing, rtol=1e-8,
                               atol=1e-10)


@pytest.mark.slow
def test_cli_trainer_paths(tmp_path, rng):
    """-trainer device|sharded: the accelerator training paths at the CLI
    surface round-trip through the SAME artifact schema as the host loop
    (VERDICT.md round-2 #3 at commit b587de6).  Sharded runs on the suite's 8-virtual-device CPU
    mesh (conftest XLA_FLAGS); the device path also exercises -checkpoint
    followed by -resume."""
    import numpy as np

    csv, _, _ = make_csv(rng, n=96, d=2)
    test_csv, _, _ = make_csv(rng, n=8, d=2, with_target=False)
    ckpt = str(tmp_path / "dev.ckpt.npz")
    models = {}

    common = ["-cmd", "train", "-n-inducing", "6", "-max-iter", "8",
              "-dim-red", "1", "-seed", "5"]
    res = run_cli(common + ["-model", str(tmp_path / "dev.npz"),
                            "-trainer", "device", "-checkpoint", ckpt], csv)
    assert res.returncode == 0, res.stderr[-2000:]
    assert os.path.exists(ckpt)
    models["device"] = tmp_path / "dev.npz"

    res = run_cli(common + ["-model", str(tmp_path / "dev2.npz"),
                            "-trainer", "device", "-checkpoint", ckpt,
                            "-resume", "-max-iter", "12"], csv)
    # -max-iter appears twice; argparse keeps the last (12 > the 8 in common)
    assert res.returncode == 0, res.stderr[-2000:]

    res = run_cli(common + ["-model", str(tmp_path / "sh.npz"),
                            "-trainer", "sharded", "-devices", "8"], csv)
    assert res.returncode == 0, res.stderr[-2000:]
    models["sharded"] = tmp_path / "sh.npz"

    from gpr_tpu.io import load_model
    from gpr_tpu.kernels import SeFat

    keysets = {}
    for name, path in models.items():
        art, _ = load_model(str(path))
        assert art.family is SeFat
        assert np.isfinite(art.coeffs).all() and np.isfinite(art.r_mat).all()
        with np.load(str(path)) as z:
            keysets[name] = set(z.files)
        res = run_cli(["-cmd", "test", "-model", str(path), "-with-stddev"],
                      test_csv)
        assert res.returncode == 0, res.stderr[-2000:]
        lines = res.stdout.strip().splitlines()
        assert len(lines) == 8
        for line in lines:
            mean, sd = map(float, line.split(","))
            assert np.isfinite(mean) and sd >= 0
    # identical artifact schema across trainers
    assert keysets["device"] == keysets["sharded"]


@pytest.mark.slow
def test_cli_restarts(tmp_path, rng):
    """-restarts N trains N times from varied seeds and keeps the best
    final evidence; incompatible with -checkpoint."""
    model_file = str(tmp_path / "model.npz")
    csv, _, _ = make_csv(rng)
    res = run_cli(
        ["-cmd", "train", "-model", model_file, "-n-inducing", "6",
         "-max-iter", "8", "-seed", "3", "-restarts", "2", "-verbose"],
        csv,
    )
    assert res.returncode == 0, res.stderr
    assert "restart 1: log evidence" in res.stderr
    assert os.path.exists(model_file)

    res = run_cli(
        ["-cmd", "train", "-model", model_file, "-restarts", "2",
         "-checkpoint", str(tmp_path / "c.npz")],
        csv,
    )
    assert res.returncode != 0
    assert "incompatible" in res.stderr


@pytest.mark.slow
def test_cli_polish(tmp_path, rng):
    """-polish N runs the f64 finishing step after training and writes a
    model whose predictions still parse; verbose reports the polish line."""
    model_file = str(tmp_path / "model.npz")
    csv, _, _ = make_csv(rng, n=90, d=2)
    res = run_cli(
        ["-cmd", "train", "-model", model_file, "-n-inducing", "6",
         "-max-iter", "6", "-dim-red", "1", "-seed", "11",
         "-polish", "60", "-verbose"],
        csv,
    )
    assert res.returncode == 0, res.stderr[-2000:]
    assert "polish (f64, 60 rows)" in res.stderr
    test_csv, _, _ = make_csv(rng, n=5, d=2, with_target=False)
    res = run_cli(["-cmd", "test", "-model", model_file], test_csv)
    assert res.returncode == 0, res.stderr
    assert len(res.stdout.strip().splitlines()) == 5


@pytest.mark.slow
def test_cli_sharded_restarts(tmp_path, rng):
    """-trainer sharded -restarts N: the probes run in parallel across the
    mesh (fit_restarts_sharded) and the winner's model round-trips."""
    model_file = str(tmp_path / "model.npz")
    csv, _, _ = make_csv(rng, n=96, d=2)
    res = run_cli(
        ["-cmd", "train", "-model", model_file, "-n-inducing", "6",
         "-max-iter", "8", "-seed", "3", "-restarts", "2",
         "-trainer", "sharded", "-devices", "4", "-verbose"],
        csv,
    )
    assert res.returncode == 0, res.stderr[-2000:]
    assert "restart probes (parallel over 4 devices)" in res.stderr
    assert os.path.exists(model_file)
    test_csv, _, _ = make_csv(rng, n=5, d=2, with_target=False)
    res = run_cli(["-cmd", "test", "-model", model_file], test_csv)
    assert res.returncode == 0, res.stderr
    assert len(res.stdout.strip().splitlines()) == 5


@pytest.mark.slow
def test_cli_pitc(tmp_path, rng):
    """-pitc-block B trains with the PITC evidence; artifact serves via
    the standard predictors (schema-identical to the regression path)."""
    model_file = str(tmp_path / "model.npz")
    csv, _, _ = make_csv(rng, n=96, d=2)
    res = run_cli(
        ["-cmd", "train", "-model", model_file, "-n-inducing", "6",
         "-max-iter", "6", "-seed", "5", "-trainer", "device",
         "-pitc-block", "16", "-verbose"],
        csv,
    )
    assert res.returncode == 0, res.stderr[-2000:]
    from gpr_tpu.io import load_model

    art, extra = load_model(model_file)
    assert int(extra["pitc_block"]) == 16
    assert np.isfinite(art.coeffs).all() and np.isfinite(art.r_mat).all()

    test_csv, _, _ = make_csv(rng, n=6, d=2, with_target=False)
    res = run_cli(["-cmd", "test", "-model", model_file, "-with-stddev"],
                  test_csv)
    assert res.returncode == 0, res.stderr
    for line in res.stdout.strip().splitlines():
        mean, sd = map(float, line.split(","))
        assert np.isfinite(mean) and sd > 0

    # host trainer must reject the extension flags
    res = run_cli(
        ["-cmd", "train", "-model", model_file, "-pitc-block", "16"], csv
    )
    assert res.returncode != 0
    assert "require -trainer device|sharded" in res.stderr


@pytest.mark.slow
def test_cli_warp(tmp_path, rng):
    """-warp K learns the tanh-sum warp jointly; test output integrates the
    inverse warp (finite means/stddevs on skewed targets)."""
    model_file = str(tmp_path / "model.npz")
    X = rng.standard_normal((90, 2))
    latent = np.sin(X.sum(axis=1)) + 0.05 * rng.standard_normal(90)
    y = np.cbrt(latent)  # skewed observation
    csv = "\n".join(
        ",".join(f"{v:.8f}" for v in list(row) + [t])
        for row, t in zip(X, y)
    ) + "\n"
    res = run_cli(
        ["-cmd", "train", "-model", model_file, "-n-inducing", "6",
         "-max-iter", "8", "-seed", "5", "-trainer", "device",
         "-warp", "2"],
        csv,
    )
    assert res.returncode == 0, res.stderr[-2000:]
    from gpr_tpu.io import load_model

    art, extra = load_model(model_file)
    assert extra["warp_log_a"].shape == (2,)

    test_csv, _, _ = make_csv(rng, n=6, d=2, with_target=False)
    res = run_cli(["-cmd", "test", "-model", model_file, "-with-stddev"],
                  test_csv)
    assert res.returncode == 0, res.stderr
    lines = res.stdout.strip().splitlines()
    assert len(lines) == 6
    for line in lines:
        mean, sd = map(float, line.split(","))
        assert np.isfinite(mean) and sd > 0
        assert abs(mean) < 5.0  # in the target range, not latent space


@pytest.mark.slow
def test_cli_classify(tmp_path, rng):
    """-classify trains the Laplace classifier; test output is a class
    probability that actually separates the two blobs.  Also covers the
    sharded trainer and 0/1-label mapping."""
    n = 120
    X = rng.standard_normal((n, 2))
    y01 = (X[:, 0] + X[:, 1] > 0).astype(float)  # separable blobs, 0/1
    csv = "\n".join(
        ",".join(f"{v:.8f}" for v in list(row) + [t])
        for row, t in zip(X, y01)
    ) + "\n"

    # device also takes -block-size: streaming Newton + streaming artifact
    # epilogue (classify_stream.py) — the n-unbounded path end to end;
    # the ep case covers -approx ep (EP training + exact probit squash)
    for trainer, extra_args in [("device", ["-block-size", "32"]),
                                ("device", ["-approx", "ep"]),
                                ("sharded", ["-devices", "4"])]:
        model_file = str(tmp_path / f"model_{trainer}.npz")
        res = run_cli(
            ["-cmd", "train", "-model", model_file, "-n-inducing", "8",
             "-max-iter", "10", "-seed", "5", "-trainer", trainer,
             "-classify", "-verbose", *extra_args],
            csv,
        )
        assert res.returncode == 0, res.stderr[-2000:]
        assert "classes: " in res.stderr

        # probe far into each blob: probabilities must separate
        test_csv = "2.0,2.0\n-2.0,-2.0\n"
        res = run_cli(["-cmd", "test", "-model", model_file], test_csv)
        assert res.returncode == 0, res.stderr
        p_pos, p_neg = [float(v) for v in res.stdout.strip().splitlines()]
        assert p_pos > 0.8 and p_neg < 0.2

        res = run_cli(["-cmd", "test", "-model", model_file, "-with-stddev"],
                      test_csv)
        assert res.returncode == 0, res.stderr
        for line in res.stdout.strip().splitlines():
            prob, sd = map(float, line.split(","))
            assert 0.0 <= prob <= 1.0 and sd >= 0

    # bad labels are rejected
    res = run_cli(
        ["-cmd", "train", "-model", str(tmp_path / "bad.npz"), "-classify",
         "-trainer", "device"],
        "1.0,2.0,0.5\n2.0,1.0,1.0\n",
    )
    assert res.returncode != 0
    assert "-classify needs 0/1" in res.stderr


@pytest.mark.slow
@pytest.mark.parametrize("stream_flags", [
    pytest.param([], id="materialized"),
    pytest.param(["-block-size", "32"], id="streaming",
                 marks=pytest.mark.slow),
])
def test_cli_classify_multiclass(tmp_path, rng, stream_flags):
    """Integer 0..C-1 targets route to the softmax Laplace: the artifact
    carries the m-space multi-class state and -cmd test prints one
    probability per class that picks the right blob.  The streaming
    variant trains AND persists through classify_multi_stream.py (V
    never materializes) into the identical artifact schema."""
    C, n_per = 3, 30
    centers = np.array([[2.5, 0.0], [-1.5, 2.5], [-1.5, -2.5]])
    Xn = np.concatenate([
        centers[c] + 0.5 * rng.standard_normal((n_per, 2)) for c in range(C)
    ])
    yn = np.repeat(np.arange(C), n_per).astype(float)
    perm = rng.permutation(len(yn))
    Xn, yn = Xn[perm], yn[perm]
    csv = "\n".join(
        ",".join(f"{v:.8f}" for v in list(row) + [t])
        for row, t in zip(Xn, yn)
    ) + "\n"

    model_file = str(tmp_path / "model_mc.npz")
    res = run_cli(
        ["-cmd", "train", "-model", model_file, "-n-inducing", "9",
         "-max-iter", "10", "-seed", "7", "-trainer", "device",
         "-classify", "-verbose"] + stream_flags,
        csv,
    )
    assert res.returncode == 0, res.stderr[-2000:]
    assert "classes: 3" in res.stderr

    from gpr_tpu.io import load_model

    art, extra = load_model(model_file)
    assert int(extra["classify"]) == C
    assert art.coeffs.shape[1] == C
    assert extra["mc_b_tilde"].shape[:2] == (C, C)

    # probe the three blob centers: each row is C probabilities summing
    # to 1, and the argmax recovers the class
    test_csv = "\n".join(",".join(f"{v}" for v in c) for c in centers) + "\n"
    res = run_cli(["-cmd", "test", "-model", model_file], test_csv)
    assert res.returncode == 0, res.stderr
    lines = res.stdout.strip().splitlines()
    assert len(lines) == C
    for c, line in enumerate(lines):
        probs = [float(v) for v in line.split(",")]
        assert len(probs) == C
        np.testing.assert_allclose(sum(probs), 1.0, atol=1e-3)
        assert int(np.argmax(probs)) == c and max(probs) > 0.5

    # -with-stddev appends one latent stddev per class
    res = run_cli(["-cmd", "test", "-model", model_file, "-with-stddev"],
                  test_csv)
    assert res.returncode == 0, res.stderr
    for line in res.stdout.strip().splitlines():
        vals = [float(v) for v in line.split(",")]
        assert len(vals) == 2 * C
        assert all(v >= 0 for v in vals)


@pytest.mark.slow
def test_cli_sharded_2d_mesh(tmp_path, rng):
    """-devices DxM trains over the 2-D (data x model) mesh
    (fit_sharded_2d) and the artifact round-trips."""
    model_file = str(tmp_path / "model.npz")
    csv, _, _ = make_csv(rng, n=96, d=2)
    res = run_cli(
        ["-cmd", "train", "-model", model_file, "-n-inducing", "6",
         "-max-iter", "6", "-seed", "3", "-trainer", "sharded",
         "-devices", "2x2", "-dim-red", "2"],
        csv,
    )
    assert res.returncode == 0, res.stderr[-2000:]
    assert os.path.exists(model_file)
    test_csv, _, _ = make_csv(rng, n=4, d=2, with_target=False)
    res = run_cli(["-cmd", "test", "-model", model_file], test_csv)
    assert res.returncode == 0, res.stderr
    assert len(res.stdout.strip().splitlines()) == 4


@pytest.mark.slow
def test_cli_kernel_selection(tmp_path, rng):
    """-kernel NAME trains/serves any registered family through the same
    artifact schema; se_fat-only flags are rejected for other families."""
    csv, _, _ = make_csv(rng, n=80, d=2)
    test_csv, _, _ = make_csv(rng, n=5, d=2, with_target=False)

    for kern in ["se_iso", "matern52", "rq", "periodic"]:
        model_file = str(tmp_path / f"model_{kern}.npz")
        res = run_cli(
            ["-cmd", "train", "-model", model_file, "-kernel", kern,
             "-n-inducing", "6", "-max-iter", "5", "-seed", "3",
             "-amplitude", "1.5"],
            csv,
        )
        assert res.returncode == 0, (kern, res.stderr[-2000:])
        from gpr_tpu.io import load_model

        art, _ = load_model(model_file)
        assert art.family.name == kern
        res = run_cli(["-cmd", "test", "-model", model_file,
                       "-with-stddev"], test_csv)
        assert res.returncode == 0, (kern, res.stderr)
        for line in res.stdout.strip().splitlines():
            mean, sd = map(float, line.split(","))
            assert np.isfinite(mean) and sd > 0

    # device trainer + a classification extension on a non-default kernel
    model_file = str(tmp_path / "model_cls_kern.npz")
    Xc = rng.standard_normal((60, 2))
    yc = (Xc[:, 0] > 0).astype(float)
    csv_c = "\n".join(
        ",".join(f"{v:.8f}" for v in list(row) + [t])
        for row, t in zip(Xc, yc)
    ) + "\n"
    res = run_cli(
        ["-cmd", "train", "-model", model_file, "-kernel", "se_iso",
         "-trainer", "device", "-classify", "-n-inducing", "6",
         "-max-iter", "5", "-seed", "3"],
        csv_c,
    )
    assert res.returncode == 0, res.stderr[-2000:]
    res = run_cli(["-cmd", "test", "-model", model_file], "1.5,0.0\n-1.5,0.0\n")
    assert res.returncode == 0, res.stderr
    p_pos, p_neg = [float(v) for v in res.stdout.strip().splitlines()]
    assert p_pos > 0.6 > p_neg

    # se_fat-only flags rejected
    res = run_cli(
        ["-cmd", "train", "-model", str(tmp_path / "bad.npz"),
         "-kernel", "se_iso", "-multiscale"],
        csv,
    )
    assert res.returncode != 0
    assert "se_fat" in res.stderr
    # -amplitude rejected for families without a signal-variance hyper
    res = run_cli(
        ["-cmd", "train", "-model", str(tmp_path / "bad2.npz"),
         "-kernel", "lin_one", "-amplitude", "2.0"],
        csv,
    )
    assert res.returncode != 0
    assert "signal-variance" in res.stderr


@pytest.mark.slow
def test_cli_poisson(tmp_path, rng):
    """-poisson trains the count model; test output is the posterior rate
    (device and sharded trainers; bad targets rejected)."""
    n = 100
    X = rng.uniform(-2.0, 2.0, (n, 1))
    f_true = 1.2 * np.sin(X[:, 0] * 1.5)
    y = rng.poisson(np.exp(f_true)).astype(float)
    csv = "\n".join(
        ",".join(f"{v:.8f}" for v in list(row) + [t])
        for row, t in zip(X, y)
    ) + "\n"

    for trainer, extra_args in [("device", []), ("sharded", ["-devices", "4"]),
                                ("device", ["-block-size", "32"])]:
        model_file = str(
            tmp_path / f"model_pois_{trainer}_{len(extra_args)}.npz"
        )
        res = run_cli(
            ["-cmd", "train", "-model", model_file, "-n-inducing", "7",
             "-max-iter", "10", "-seed", "5", "-trainer", trainer,
             "-poisson", "-verbose", *extra_args],
            csv,
        )
        assert res.returncode == 0, (trainer, res.stderr[-2000:])
        assert "counts: mean" in res.stderr

        # rates at a high-rate and a low-rate location must order correctly
        test_csv = "1.0\n-1.0\n"
        res = run_cli(["-cmd", "test", "-model", model_file,
                       "-with-stddev"], test_csv)
        assert res.returncode == 0, res.stderr
        rows = [list(map(float, line.split(",")))
                for line in res.stdout.strip().splitlines()]
        assert len(rows) == 2
        (r_hi, s_hi), (r_lo, s_lo) = rows
        assert r_hi > r_lo > 0 and s_hi > 0 and s_lo > 0

    # non-count targets rejected
    res = run_cli(
        ["-cmd", "train", "-model", str(tmp_path / "bad.npz"), "-poisson",
         "-trainer", "device"],
        "1.0,0.5\n2.0,1.0\n",
    )
    assert res.returncode != 0
    assert "nonnegative integer counts" in res.stderr


@pytest.mark.slow
def test_cli_negbin(tmp_path, rng):
    """-negbin trains the overdispersed count model, learns and reports the
    dispersion, and serves NB count moments (device and sharded trainers;
    bad targets and bad R0 rejected)."""
    n = 120
    X = rng.uniform(-2.0, 2.0, (n, 1))
    f_true = 1.2 * np.sin(X[:, 0] * 1.5)
    mu = np.exp(f_true)
    r_true = 1.5
    y = rng.poisson(rng.gamma(r_true, mu / r_true)).astype(float)
    csv = "\n".join(
        ",".join(f"{v:.8f}" for v in list(row) + [t])
        for row, t in zip(X, y)
    ) + "\n"

    for trainer, extra_args in [("device", []), ("sharded", ["-devices", "4"]),
                                ("device", ["-block-size", "32"])]:
        model_file = str(
            tmp_path / f"model_nb_{trainer}_{len(extra_args)}.npz"
        )
        res = run_cli(
            ["-cmd", "train", "-model", model_file, "-n-inducing", "7",
             "-max-iter", "15", "-seed", "5", "-trainer", trainer,
             "-negbin", "8.0", "-verbose", *extra_args],
            csv,
        )
        assert res.returncode == 0, (trainer, res.stderr[-2000:])
        assert "counts: mean" in res.stderr
        disp_lines = [ln for ln in res.stderr.splitlines()
                      if "learned dispersion" in ln]
        assert disp_lines, res.stderr
        r_learned = float(disp_lines[0].split("r = ")[1].split(" ")[0])
        assert r_learned > 0.0

        # count means order with the true rate; NB stddev is overdispersed
        # (var > mean per unit exposure)
        res = run_cli(["-cmd", "test", "-model", model_file,
                       "-with-stddev"], "1.0\n-1.0\n")
        assert res.returncode == 0, res.stderr
        rows = [list(map(float, line.split(",")))
                for line in res.stdout.strip().splitlines()]
        assert len(rows) == 2
        (m_hi, s_hi), (m_lo, s_lo) = rows
        assert m_hi > m_lo > 0
        assert s_hi * s_hi > m_hi and s_lo * s_lo > m_lo

    # non-count targets rejected
    res = run_cli(
        ["-cmd", "train", "-model", str(tmp_path / "bad.npz"),
         "-negbin", "2.0", "-trainer", "device"],
        "1.0,0.5\n2.0,1.0\n",
    )
    assert res.returncode != 0
    assert "nonnegative integer counts" in res.stderr
    # nonpositive initial dispersion rejected
    res = run_cli(
        ["-cmd", "train", "-model", str(tmp_path / "bad2.npz"),
         "-negbin", "-1.0", "-trainer", "device"],
        "1.0,2\n2.0,1\n",
    )
    assert res.returncode != 0
    assert "R0 > 0" in res.stderr

@pytest.mark.slow
def test_cli_binomial(tmp_path, rng):
    """-binomial trains on x...,trials,successes rows and serves success
    probabilities (device, sharded, and streaming trainers; bad targets
    rejected)."""
    n = 120
    X = rng.uniform(-2.0, 2.0, (n, 1))
    p_true = 1.0 / (1.0 + np.exp(-2.0 * np.sin(X[:, 0] * 1.5)))
    trials = rng.integers(1, 20, n)
    y = rng.binomial(trials, p_true).astype(float)
    csv = "\n".join(
        f"{x:.8f},{t:.0f},{s:.0f}"
        for x, t, s in zip(X[:, 0], trials, y)
    ) + "\n"

    for trainer, extra_args in [("device", []), ("sharded", ["-devices", "4"]),
                                ("device", ["-block-size", "32"])]:
        model_file = str(
            tmp_path / f"model_bin_{trainer}_{len(extra_args)}.npz"
        )
        res = run_cli(
            ["-cmd", "train", "-model", model_file, "-n-inducing", "7",
             "-max-iter", "12", "-seed", "5", "-trainer", trainer,
             "-binomial", "-verbose", *extra_args],
            csv,
        )
        assert res.returncode == 0, (trainer, res.stderr[-2000:])
        assert "proportions: mean" in res.stderr

        # success probability orders with the truth; probabilities in (0,1)
        res = run_cli(["-cmd", "test", "-model", model_file,
                       "-with-stddev"], "1.0\n-1.0\n")
        assert res.returncode == 0, res.stderr
        rows = [list(map(float, line.split(",")))
                for line in res.stdout.strip().splitlines()]
        assert len(rows) == 2
        (p_hi, s_hi), (p_lo, s_lo) = rows
        assert 1.0 > p_hi > 0.5 > p_lo > 0.0
        assert s_hi > 0 and s_lo > 0

    # successes > trials rejected
    res = run_cli(
        ["-cmd", "train", "-model", str(tmp_path / "bad.npz"),
         "-binomial", "-trainer", "device"],
        "1.0,2,3\n2.0,2,1\n",
    )
    assert res.returncode != 0
    assert "successes <= trials" in res.stderr
    # too few columns rejected
    res = run_cli(
        ["-cmd", "train", "-model", str(tmp_path / "bad2.npz"),
         "-binomial", "-trainer", "device"],
        "1.0,1\n2.0,0\n",
    )
    assert res.returncode != 0
    assert "3 columns" in res.stderr

@pytest.mark.slow
def test_cli_ordinal(tmp_path, rng):
    """-ordinal trains the cumulative-probit model; test output is one
    probability per category (+ latent stddev with -with-stddev); device
    and sharded trainers; bad targets rejected."""
    n = 120
    X = np.sort(rng.uniform(-3.0, 3.0, (n, 1)), axis=0)
    f_true = 2.0 * np.sin(1.3 * X[:, 0])
    y = np.digitize(f_true + 0.2 * rng.standard_normal(n), [-1.0, 1.0])
    csv = "\n".join(
        f"{x:.8f},{t:d}" for x, t in zip(X[:, 0], y)
    ) + "\n"

    for trainer, extra_args in [("device", []),
                                ("sharded", ["-devices", "4"])]:
        model_file = str(tmp_path / f"model_ord_{trainer}.npz")
        res = run_cli(
            ["-cmd", "train", "-model", model_file, "-n-inducing", "8",
             "-max-iter", "12", "-seed", "5", "-trainer", trainer,
             "-kernel", "se_iso", "-ordinal", "-verbose", *extra_args],
            csv,
        )
        assert res.returncode == 0, (trainer, res.stderr[-2000:])
        assert "categories: 3" in res.stderr

        # probe the sine extremes (f ~ -2 / 0 / +2), well inside each cell
        res = run_cli(["-cmd", "test", "-model", model_file,
                       "-with-stddev"], "0.0\n-1.2\n1.2\n")
        assert res.returncode == 0, res.stderr
        rows = [list(map(float, line.split(",")))
                for line in res.stdout.strip().splitlines()]
        assert len(rows) == 3 and all(len(r) == 4 for r in rows)
        for r in rows:
            assert abs(sum(r[:3]) - 1.0) < 1e-6 and r[3] > 0
        assert np.argmax(rows[0][:3]) == 1
        assert np.argmax(rows[1][:3]) == 0
        assert np.argmax(rows[2][:3]) == 2

    res = run_cli(
        ["-cmd", "train", "-model", str(tmp_path / "bad.npz"), "-ordinal",
         "-trainer", "device"],
        "1.0,0.5\n2.0,1.0\n",
    )
    assert res.returncode != 0
    assert "integer category targets" in res.stderr


@pytest.mark.slow
def test_cli_student_t(tmp_path, rng):
    """-student-t NU downweights gross outliers; the served mean tracks
    the clean function; NU <= 2 and -checkpoint are rejected."""
    n = 150
    X = np.sort(rng.uniform(-3.0, 3.0, (n, 1)), axis=0)
    f_true = 2.0 * np.sin(1.3 * X[:, 0])
    y = f_true + 0.1 * rng.standard_normal(n)
    bad = rng.choice(n, 8, replace=False)
    y[bad] += rng.choice([-1, 1], 8) * 6.0
    csv = "\n".join(
        f"{x:.8f},{t:.8f}" for x, t in zip(X[:, 0], y)
    ) + "\n"

    model_file = str(tmp_path / "model_t.npz")
    res = run_cli(
        ["-cmd", "train", "-model", model_file, "-n-inducing", "8",
         "-max-iter", "40", "-seed", "5", "-trainer", "device",
         "-kernel", "se_iso", "-student-t", "4", "-verbose"],
        csv,
    )
    assert res.returncode == 0, res.stderr[-2000:]
    assert "downweighted" in res.stderr

    xs = np.linspace(-3, 3, 13)
    res = run_cli(["-cmd", "test", "-model", model_file],
                  "\n".join(str(v) for v in xs) + "\n")
    assert res.returncode == 0, res.stderr
    mu = np.array([float(l) for l in res.stdout.strip().splitlines()])
    rmse = float(np.sqrt(np.mean((mu - 2.0 * np.sin(1.3 * xs)) ** 2)))
    assert rmse < 0.25, rmse

    res = run_cli(
        ["-cmd", "train", "-model", model_file, "-student-t", "1.5",
         "-trainer", "device"], csv)
    assert res.returncode != 0 and "NU > 2" in res.stderr
    res = run_cli(
        ["-cmd", "train", "-model", model_file, "-student-t", "4",
         "-trainer", "device", "-checkpoint", str(tmp_path / "c.npz")],
        csv)
    assert res.returncode != 0 and "not supported" in res.stderr


@pytest.mark.slow
def test_cli_ordinal_streaming(tmp_path, rng):
    """-ordinal -block-size B: trains AND writes the artifact through the
    generic streaming Laplace core (V never materializes); served
    probabilities still sum to 1."""
    n = 90
    X = np.sort(rng.uniform(-3.0, 3.0, (n, 1)), axis=0)
    y = np.digitize(2.0 * np.sin(1.3 * X[:, 0]), [-1.0, 1.0])
    csv = "\n".join(f"{x:.8f},{t:d}" for x, t in zip(X[:, 0], y)) + "\n"
    model_file = str(tmp_path / "model_ord_stream.npz")
    res = run_cli(
        ["-cmd", "train", "-model", model_file, "-n-inducing", "6",
         "-max-iter", "6", "-seed", "5", "-trainer", "device",
         "-kernel", "se_iso", "-ordinal", "-block-size", "32"],
        csv,
    )
    assert res.returncode == 0, res.stderr[-2000:]
    res = run_cli(["-cmd", "test", "-model", model_file], "0.0\n1.2\n")
    assert res.returncode == 0, res.stderr
    rows = [list(map(float, line.split(",")))
            for line in res.stdout.strip().splitlines()]
    assert len(rows) == 2 and all(abs(sum(r) - 1.0) < 1e-6 for r in rows)


def test_cli_multioutput(tmp_path, rng):
    """-tasks T: multi-output ICM at the CLI — trains a coregionalized
    model on stacked [x, task_id, y] rows, reports the learned B with
    -verbose, persists/reloads the structural family, and the sparse
    task's predictions transfer from the dense one (the point of ICM)."""
    f = lambda x: np.sin(1.5 * x)
    x0 = np.sort(rng.uniform(-3.0, 3.0, 150))
    x1 = np.sort(rng.uniform(-3.0, 0.0, 50))  # task 1 left half only
    y0 = f(x0) + 0.05 * rng.standard_normal(150)
    y1 = 0.8 * f(x1) + 0.05 * rng.standard_normal(50)
    rows = np.r_[
        np.c_[x0, np.zeros_like(x0), y0], np.c_[x1, np.ones_like(x1), y1]
    ]
    csv = "\n".join(",".join(f"{v:.8f}" for v in r) for r in rows) + "\n"
    model_file = str(tmp_path / "model_mt.npz")
    res = run_cli(
        ["-cmd", "train", "-model", model_file, "-kernel", "se_iso",
         "-tasks", "2", "-n-inducing", "25", "-max-iter", "100",
         "-seed", "7", "-trainer", "device", "-verbose"],
        csv,
    )
    assert res.returncode == 0, res.stderr[-2000:]
    assert "coregionalization B" in res.stderr
    assert "inter-task correlations" in res.stderr

    art, _ = load_model(model_file)
    assert art.family_name.startswith("prod(cols(task(2,1),1,2)")
    assert art.family is not None  # structural name resolves

    # task-1 predictions on x > 0 (no task-1 data there) must transfer
    grid = np.linspace(0.5, 3.0, 10)
    test_csv = "\n".join(f"{x:.8f},1" for x in grid) + "\n"
    res = run_cli(["-cmd", "test", "-model", model_file, "-with-stddev"],
                  test_csv)
    assert res.returncode == 0, res.stderr
    pred = np.array([list(map(float, line.split(",")))
                     for line in res.stdout.strip().splitlines()])
    rmse = float(np.sqrt(np.mean((pred[:, 0] - 0.8 * f(grid)) ** 2)))
    assert rmse < 0.15, rmse

    # validation: bad ids, T < 2, rank out of range
    bad = run_cli(["-cmd", "train", "-model", model_file, "-tasks", "2",
                   "-kernel", "se_iso", "-trainer", "device"],
                  "0.1,5,1.0\n0.2,0,0.5\n")
    assert bad.returncode != 0 and "task ids" in bad.stderr
    bad = run_cli(["-cmd", "train", "-model", model_file, "-tasks", "1",
                   "-kernel", "se_iso", "-trainer", "device"], csv)
    assert bad.returncode != 0 and "T >= 2" in bad.stderr
    bad = run_cli(["-cmd", "train", "-model", model_file, "-tasks", "2",
                   "-coreg-rank", "3", "-kernel", "se_iso",
                   "-trainer", "device"], csv)
    assert bad.returncode != 0 and "-coreg-rank" in bad.stderr


def test_cli_inducing_init(tmp_path, rng):
    """-inducing-init kmeans/first round-trip on device and host trainers;
    kmeans rejected with -tasks."""
    n = 100
    X = np.sort(rng.uniform(0.1, 6.0, n))
    y = np.sin(3 * X) / X + np.abs(X - 3) / (X**2 + 1)
    csv = "\n".join(f"{a:.8f},{b:.8f}" for a, b in zip(X, y)) + "\n"
    for extra in (["-trainer", "device"], []):
        model_file = str(tmp_path / f"model_km_{len(extra)}.npz")
        res = run_cli(
            ["-cmd", "train", "-model", model_file, "-kernel", "se_iso",
             "-inducing-init", "kmeans", "-n-inducing", "8",
             "-max-iter", "10", "-seed", "3", *extra],
            csv,
        )
        assert res.returncode == 0, res.stderr[-2000:]
        res = run_cli(["-cmd", "test", "-model", model_file], "1.0\n2.0\n")
        assert res.returncode == 0, res.stderr
        assert len(res.stdout.strip().splitlines()) == 2

    res = run_cli(
        ["-cmd", "train", "-model", str(tmp_path / "x.npz"),
         "-kernel", "se_iso", "-inducing-init", "first",
         "-n-inducing", "8", "-max-iter", "5", "-trainer", "device"],
        csv,
    )
    assert res.returncode == 0, res.stderr[-2000:]

    bad = run_cli(
        ["-cmd", "train", "-model", str(tmp_path / "x.npz"),
         "-tasks", "2", "-inducing-init", "kmeans", "-kernel", "se_iso",
         "-trainer", "device"],
        "0.1,0,1.0\n0.2,1,0.5\n",
    )
    assert bad.returncode != 0 and "incompatible with -tasks" in bad.stderr


def test_cli_exact(tmp_path, rng):
    """-exact: dense-GP training end to end, -loo objective, flag guards."""
    model_file = str(tmp_path / "exact.npz")
    csv, X, y = make_csv(rng, n=100)
    res = run_cli(
        ["-cmd", "train", "-model", model_file, "-exact", "-kernel",
         "se_iso", "-max-iter", "80", "-seed", "5", "-verbose"],
        csv,
    )
    assert res.returncode == 0, res.stderr
    assert "LOO" in res.stderr  # verbose reports LOO stats
    test_csv, Xt, _ = make_csv(rng, n=20, with_target=False)
    res = run_cli(
        ["-cmd", "test", "-model", model_file, "-with-stddev", "-predictive"],
        test_csv,
    )
    assert res.returncode == 0, res.stderr
    lines = res.stdout.strip().splitlines()
    assert len(lines) == 20
    for line in lines:
        mean, sd = map(float, line.split(","))
        assert np.isfinite(mean) and sd > 0
    # predictions track the true function reasonably at interpolation range
    means = np.array([float(l.split(",")[0]) for l in lines])
    truth = np.sin(Xt.sum(axis=1))
    assert float(np.mean((means - truth) ** 2)) < 0.5

    # -loo objective trains too
    res = run_cli(
        ["-cmd", "train", "-model", model_file, "-exact", "-loo",
         "-kernel", "se_iso", "-max-iter", "40", "-seed", "5"],
        csv,
    )
    assert res.returncode == 0, res.stderr

    # guards
    res = run_cli(["-cmd", "train", "-model", model_file, "-loo"], csv)
    assert res.returncode != 0
    res = run_cli(["-cmd", "train", "-model", model_file, "-exact",
                   "-block-size", "32"], csv)
    assert res.returncode != 0
    res = run_cli(["-cmd", "train", "-model", model_file, "-exact",
                   "-classify"], csv)
    assert res.returncode != 0


def test_cli_exact_cg(tmp_path, rng):
    """-exact -cg: iterative exact GP end to end — SGD training on
    stochastic exact-evidence gradients, artifact round trip, CG-served
    exact variances (-with-stddev re-solves per test batch), flag guards.
    Accuracy bar: the CG predictor must track truth at least as well as
    the dense-exact CLI test's 0.5-MSE bar on the same generator."""
    model_file = str(tmp_path / "exact_cg.npz")
    csv, X, y = make_csv(rng, n=150)
    res = run_cli(
        ["-cmd", "train", "-model", model_file, "-exact", "-cg",
         "-kernel", "se_iso", "-n-inducing", "40", "-max-iter", "40",
         "-seed", "5", "-verbose"],
        csv,
    )
    assert res.returncode == 0, res.stderr
    assert "cg iters" in res.stderr  # verbose reports the CG inner solves
    test_csv, Xt, _ = make_csv(rng, n=20, with_target=False)
    res = run_cli(
        ["-cmd", "test", "-model", model_file, "-with-stddev",
         "-predictive"],
        test_csv,
    )
    assert res.returncode == 0, res.stderr
    lines = res.stdout.strip().splitlines()
    assert len(lines) == 20
    means = np.array([float(l.split(",")[0]) for l in lines])
    sds = np.array([float(l.split(",")[1]) for l in lines])
    assert np.all(np.isfinite(means)) and np.all(sds > 0)
    truth = np.sin(Xt.sum(axis=1))
    assert float(np.mean((means - truth) ** 2)) < 0.5

    # guards: -cg without -exact; -cg with -loo; -cg with -restarts
    res = run_cli(["-cmd", "train", "-model", model_file, "-cg"], csv)
    assert res.returncode != 0 and "-exact" in res.stderr
    res = run_cli(["-cmd", "train", "-model", model_file, "-exact",
                   "-cg", "-loo"], csv)
    assert res.returncode != 0
    res = run_cli(["-cmd", "train", "-model", model_file, "-exact",
                   "-cg", "-restarts", "3"], csv)
    assert res.returncode != 0


def test_cli_exact_restarts_diversify(tmp_path, rng):
    """-exact -restarts must actually move the start: se_iso's defaults are
    deterministic (cov_se_iso.ml:122-123) and -exact has no inducing subset
    to redraw, so without the log-unit jitter every restart was identical.
    The probes must report at least two distinct evidence values."""
    model_file = str(tmp_path / "exact_rs.npz")
    csv, X, y = make_csv(rng, n=80)
    res = run_cli(
        ["-cmd", "train", "-model", model_file, "-exact", "-kernel",
         "se_iso", "-max-iter", "30", "-restarts", "3", "-seed", "5",
         "-verbose"],
        csv,
    )
    assert res.returncode == 0, res.stderr
    import re

    probes = [
        float(m.group(1))
        for m in re.finditer(r"restart \d+: evidence (\S+)", res.stderr)
    ]
    assert len(probes) == 3, res.stderr
    assert len({round(p, 3) for p in probes}) >= 2, probes


@pytest.mark.slow
def test_cli_sm_shorthand(tmp_path, rng):
    """-kernel smQ: spectral mixture with the empirical-spectrum init —
    must recover a two-tone signal and keep oscillating OUTSIDE the
    training window (the capability plain kernels lack)."""
    f1, f2 = 0.35, 1.2
    x = np.sort(rng.uniform(0, 20, 300))
    y = (np.cos(2 * np.pi * f1 * x) + 0.6 * np.cos(2 * np.pi * f2 * x)
         + 0.05 * rng.standard_normal(x.size))
    csv = "\n".join(f"{a},{b}" for a, b in zip(x, y)) + "\n"
    model_file = str(tmp_path / "sm.npz")
    res = run_cli(
        ["-cmd", "train", "-model", model_file, "-kernel", "sm3",
         "-n-inducing", "30", "-sigma2", "0.1", "-trainer", "device",
         "-max-iter", "120", "-seed", "1"],
        csv,
    )
    assert res.returncode == 0, res.stderr
    grid = np.linspace(20.5, 23.5, 40)  # extrapolation window
    res = run_cli(["-cmd", "test", "-model", model_file],
                  "\n".join(f"{g}" for g in grid) + "\n")
    assert res.returncode == 0, res.stderr
    pred = np.array([float(l) for l in res.stdout.strip().splitlines()])
    truth = np.cos(2 * np.pi * f1 * grid) + 0.6 * np.cos(2 * np.pi * f2 * grid)
    corr = float(np.corrcoef(pred, truth)[0, 1])
    assert corr > 0.8, corr
    assert pred.std() > 0.3  # still oscillating out there

    # bad Q rejected
    res = run_cli(["-cmd", "train", "-model", model_file, "-kernel", "sm0"],
                  csv)
    assert res.returncode != 0


def test_cli_sparse_loo(tmp_path, rng):
    """-loo without -exact: sparse FITC LOO objective on the device
    trainer; guards for the unsupported combinations."""
    model_file = str(tmp_path / "loo.npz")
    csv, X, y = make_csv(rng, n=100)
    res = run_cli(
        ["-cmd", "train", "-model", model_file, "-loo", "-trainer",
         "device", "-kernel", "se_iso", "-n-inducing", "10",
         "-max-iter", "40", "-seed", "2"],
        csv,
    )
    assert res.returncode == 0, res.stderr
    test_csv, _, _ = make_csv(rng, n=10, with_target=False)
    res = run_cli(["-cmd", "test", "-model", model_file, "-with-stddev"],
                  test_csv)
    assert res.returncode == 0, res.stderr
    assert len(res.stdout.strip().splitlines()) == 10

    # host trainer, streaming, sharded: rejected
    res = run_cli(["-cmd", "train", "-model", model_file, "-loo"], csv)
    assert res.returncode != 0
    res = run_cli(["-cmd", "train", "-model", model_file, "-loo",
                   "-trainer", "device", "-block-size", "32"], csv)
    assert res.returncode != 0

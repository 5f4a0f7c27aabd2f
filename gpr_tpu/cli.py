"""Command-line trainer/predictor — the rebuild of bin/ocaml_gpr.ml.

Same flag set, same CSV-over-stdin protocol, same model pipeline: the
variational FIC flavor with the se_fat kernel (bin/ocaml_gpr.ml:176-177),
target centering and per-dimension input standardization (:249-269), L-BFGS
evidence maximization with 1 Hz throttled verbose reports and SIGINT-safe
best-model bailout (:301-349), model save/load, and test-time mean
(+ optional stddev) prediction with de-standardization (:373-413).

Deliberate deviations, documented:
  * the model file is a versioned npz (io/checkpoint.py), not Marshal;
  * the reference scales each input dimension by sqrt(sum((x - mean)^2))
    — an n-fold larger "stddev" than the usual estimator
    (bin/ocaml_gpr.ml:262 ``Vec.ssqr``); replicated here for parity.
"""

from __future__ import annotations

import argparse
import math
import signal
import sys
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="gpr_tpu", description=__doc__.splitlines()[0]
    )
    p.add_argument("-cmd", choices=["train", "test"], default="train",
                   help="train (default) or test model")
    p.add_argument("-model", required=True, help="model file to use")
    p.add_argument("-with-stddev", dest="with_stddev", action="store_true",
                   help="make predictions with both mean and standard deviation")
    p.add_argument("-predictive", action="store_true",
                   help="standard deviation includes noise level (predictive)")
    p.add_argument("-max-iter", dest="max_iter", type=int, default=None,
                   help="maximum number of optimization steps (default: limitless)")
    p.add_argument("-n-inducing", dest="n_inducing", type=int, default=10,
                   help="number of randomly initialized inducing inputs (default: 10)")
    p.add_argument("-sigma2", type=float, default=1.0,
                   help="initial noise level (default: 1.0)")
    p.add_argument("-amplitude", type=float, default=1.0,
                   help="initial amplitude level (default: 1.0)")
    p.add_argument("-kernel", default="se_fat",
                   help="covariance family: se_fat (default, the "
                        "reference CLI's choice), se_iso, se_ard, "
                        "matern32, matern52, rq, periodic, cosine, "
                        "lin_one, lin_ard, const, or a combinator like "
                        "'sum(se_iso,lin_ard)' / 'prod(periodic,se_iso)' "
                        "/ 'sum(prod(se_ard,cosine),...)' (nested ok), or "
                        "smQ (e.g. sm3): a Q-component spectral mixture "
                        "initialized from the data's empirical spectrum "
                        "(kernels/sm_init.py; restarts draw power-weighted "
                        "frequencies).  Non-se_fat families use their "
                        "default hyper init (-amplitude still sets the "
                        "signal variance where the family has one); "
                        "-dim-red/-log-het-sked/-multiscale are "
                        "se_fat-only")
    p.add_argument("-inducing-init", dest="inducing_init",
                   choices=["random", "kmeans", "first"], default="random",
                   help="inducing-point initialization: random subset "
                        "(the reference's behavior), k-means centroids "
                        "(better input-density coverage when m << n and "
                        "the data clusters; models.fitc."
                        "choose_kmeans_inputs), or the first n rows.  "
                        "kmeans is rejected with -tasks (centroids "
                        "would average the integer task ids)")
    p.add_argument("-tasks", type=int, default=None, metavar="T",
                   help="multi-output (ICM) modelling: the LAST input "
                        "column is an integer task id 0..T-1 and the "
                        "kernel becomes B[t,t'] * k(features) with a "
                        "LEARNED T x T coregionalization "
                        "B = WW' + diag (kernels/task.py; rank of W "
                        "from -coreg-rank).  The task column is "
                        "excluded from input standardization.  "
                        "Composes with any -kernel and with the "
                        "likelihood flags")
    p.add_argument("-coreg-rank", dest="coreg_rank", type=int, default=1,
                   metavar="R",
                   help="rank of the shared coregionalization factor W "
                        "(default 1; R = T allows any PSD B)")
    p.add_argument("-dim-red", dest="dim_red", type=int, default=None,
                   help="dimensionality reduction (default: none)")
    p.add_argument("-log-het-sked", dest="log_het_sked", type=float,
                   default=None,
                   help="turns on / sets log-heteroskedastic noise")
    p.add_argument("-multiscale", action="store_true",
                   help="turns on multiscale approximation")
    p.add_argument("-tol", type=float, default=0.1,
                   help="tolerance for gradient descent (default: 0.1)")
    p.add_argument("-step", type=float, default=0.1,
                   help="step size for gradient descent (default: 0.1)")
    p.add_argument("-eps", type=float, default=0.1,
                   help="epsilon for gradient descent (default: 0.1)")
    p.add_argument("-block-size", dest="block_size", type=int, default=None,
                   help="train with the streaming evidence in row blocks of "
                        "this size: memory stays O(block x m) at any n "
                        "(default: dense n x m cross-covariance)")
    p.add_argument("-trainer", choices=["host", "device", "sharded"],
                   default="host",
                   help="host (default): callback-rich host L-BFGS loop; "
                        "device: device-resident chunked L-BFGS "
                        "(optim.lbfgs_device.fit — production throughput, "
                        "mean-NLL objective so -eps applies per point); "
                        "sharded: multi-chip data-parallel training over "
                        "a device mesh (parallel.fit_sharded)")
    p.add_argument("-devices", default=None,
                   help="mesh for -trainer sharded: N (1-D data-parallel "
                        "mesh) or DxM (2-D data x model mesh — tensor "
                        "parallelism over the inducing axis, "
                        "parallel.fit_sharded_2d; M must divide "
                        "-n-inducing).  Default: all visible devices, 1-D")
    p.add_argument("-exact", action="store_true",
                   help="train an EXACT dense GP instead of the sparse "
                        "approximation (models/exact.py): no inducing "
                        "points, O(n^3) chol — for small n (capped at "
                        "20000 rows) and as the gold standard the sparse "
                        "paths approach.  -n-inducing and the inducing/"
                        "streaming/mesh flags do not apply")
    p.add_argument("-cg", action="store_true",
                   help="with -exact: ITERATIVE exact GP "
                        "(models/iterative.py) — K is never materialized "
                        "(blocked GEMM matvecs) and the solves run "
                        "Nystrom/FITC-preconditioned CG, lifting the dense "
                        "20000-row cap.  Hypers train by SGD on unbiased "
                        "stochastic exact-evidence gradients "
                        "(evidence_grads_iter); -n-inducing sets the "
                        "preconditioner anchor count, -max-iter the SGD "
                        "steps.  -cmd test serves exact CG variances with "
                        "-with-stddev.")
    p.add_argument("-loo", action="store_true",
                   help="optimize the leave-one-out predictive "
                        "pseudo-likelihood instead of the evidence (GPML "
                        "sec. 5.4.2 — more robust to model "
                        "misspecification).  With -exact: dense closed "
                        "form (one triangular inverse per step).  Without: "
                        "the sparse FITC LOO (models/loo.py, O(nm) on top "
                        "of the evidence pieces) — requires -trainer "
                        "device, no -block-size")
    p.add_argument("-pitc-block", dest="pitc_block", type=int, default=None,
                   metavar="B",
                   help="train with the PITC evidence instead of FITC: the "
                        "exact covariance is kept within blocks of B "
                        "training rows (an accuracy dial between FITC and "
                        "the exact GP; models/pitc.py).  Requires -trainer "
                        "device|sharded")
    p.add_argument("-warp", type=int, default=0, metavar="K",
                   help="warped GP: learn a K-term monotone tanh-sum "
                        "observation warp jointly with the hypers "
                        "(models/warped.py; for skewed/heavy-tailed "
                        "targets).  Test-time means/stddevs integrate the "
                        "inverse warp by quadrature.  Requires -trainer "
                        "device|sharded")
    p.add_argument("-classify", action="store_true",
                   help="GP classification (Laplace over the FITC prior): "
                        "0/1 or -1/+1 targets select the binary classifier "
                        "(models/classify.py; test output is the class "
                        "probability, with -with-stddev: "
                        "prob,latent-stddev); integer targets 0..C-1 "
                        "select the C-class softmax Laplace "
                        "(models/classify_multi.py; test output is one "
                        "probability per class).  Requires -trainer "
                        "device|sharded")
    p.add_argument("-poisson", action="store_true",
                   help="Poisson count regression (Laplace with exp link "
                        "over the FITC prior, models/poisson.py): targets "
                        "must be nonnegative counts; test output is the "
                        "posterior rate mean (with -with-stddev: "
                        "rate,rate-stddev; unit exposure — use the library "
                        "API for exposure offsets).  Requires -trainer "
                        "device|sharded")
    p.add_argument("-binomial", action="store_true",
                   help="binomial proportion regression (logit Laplace, "
                        "models/binomial.py): the training CSV's last TWO "
                        "columns are trials,successes (so x...,N,y; at "
                        "N = 1 this is the binary classifier).  Test rows "
                        "carry only the x columns; output is the success "
                        "probability per row (with -with-stddev: "
                        "prob,latent-stddev) — multiply by N* for expected "
                        "successes.  Requires -trainer device|sharded")
    p.add_argument("-negbin", dest="negbin", type=float, default=None,
                   metavar="R0",
                   help="negative-binomial (overdispersed count) regression "
                        "(NB2-Laplace with exp link, models/negbin.py): "
                        "targets must be nonnegative counts; the dispersion "
                        "r starts at R0 (> 0) and is LEARNED by evidence "
                        "ascent (reported on stderr and stored in the "
                        "model file; r -> inf recovers -poisson).  Test "
                        "output is the posterior count mean per unit "
                        "exposure (with -with-stddev: mean,count-stddev "
                        "via the law of total variance).  Requires "
                        "-trainer device|sharded")
    p.add_argument("-ordinal", action="store_true",
                   help="ordinal regression (cumulative probit Laplace "
                        "with learnable cutpoints, models/ordinal.py): "
                        "targets must be ordered integer categories "
                        "0..K-1; test output is one probability per "
                        "category (with -with-stddev: plus the latent "
                        "stddev).  Requires -trainer device|sharded")
    p.add_argument("-student-t", dest="student_t", type=float, default=None,
                   metavar="NU",
                   help="robust regression with Student-t noise of NU "
                        "degrees of freedom (NU > 2; variational EM over "
                        "the scale mixture, models/robust.py): outlier "
                        "rows are downweighted automatically; test output "
                        "is the usual mean (with -with-stddev: the "
                        "moment-matched predictive stddev).  Requires "
                        "-trainer device|sharded")
    p.add_argument("-approx", choices=["laplace", "ep"], default="laplace",
                   help="Gaussian approximation for -classify (binary): "
                        "laplace (default; logit likelihood, MacKay probit "
                        "squash) or ep (expectation propagation, probit "
                        "likelihood, exact predictive — "
                        "models/classify_ep.py)")
    p.add_argument("-polish", type=int, default=0, metavar="N",
                   help="f64 finishing step after training: re-optimize the "
                        "hypers on a host-CPU f64 objective over N "
                        "subsampled rows (0 = off; restores the reference's "
                        "f64 convergence semantics after an f32 device run)")
    p.add_argument("-restarts", type=int, default=1,
                   help="random restarts: retrain from fresh random "
                        "inducing/projection draws (seed+r) and keep the "
                        "best final log evidence — the hyper landscape is "
                        "multi-modal (docs/MANUAL.md section 7)")
    p.add_argument("-checkpoint", default=None,
                   help="persist optimizer state to this file every "
                        "accepted iteration (enables -resume)")
    p.add_argument("-resume", action="store_true",
                   help="continue an interrupted -checkpoint run (requires "
                        "the same data and flags; reproduces the "
                        "uninterrupted trajectory)")
    p.add_argument("-verbose", action="store_true",
                   help="prints information while training")
    p.add_argument("-seed", type=int, default=None,
                   help="RNG seed (default: nondeterministic, like the "
                        "reference's Random.self_init)")
    return p


def _sm_q(kernel: str) -> int | None:
    """Q for the '-kernel smQ' spectral-mixture shorthand, else None."""
    import re

    m = re.fullmatch(r"sm([0-9]+)", kernel)
    if m is None:
        return None
    q = int(m.group(1))
    if q < 1:
        raise SystemExit("-kernel smQ needs Q >= 1")
    return q


def _family(args):
    """The selected kernel family (CLI -kernel; default se_fat, the
    reference CLI's hardwired choice, bin/ocaml_gpr.ml:176-177)."""
    from .kernels import resolve_family, sm_family

    q = _sm_q(args.kernel)
    if q is not None:
        return sm_family(q)
    return resolve_family(args.kernel)


def read_samples(stream) -> np.ndarray:
    # Native fast path: hand the whole input to the C++ parser
    # (gpr_tpu/io/native.py); falls back to the line-by-line Python reader
    # when no toolchain/library is available.
    try:
        from .io.native import CsvError, parse_csv_bytes

        data = stream.buffer.read() if hasattr(stream, "buffer") else None
        if data is not None:
            try:
                arr = parse_csv_bytes(data)
            except CsvError as e:
                raise SystemExit(str(e))
            if arr is not None:
                return arr
            stream = data.decode().splitlines()  # native lib unavailable
    except AttributeError:
        pass

    rows = []
    d = None
    for i, line in enumerate(stream):
        line = line.strip()
        if not line:
            continue
        try:
            vals = [float(tok) for tok in line.split(",")]
        except ValueError as e:
            raise SystemExit(f"failure '{line}' converting sample: {e}")
        if d is None:
            d = len(vals)
        elif len(vals) != d:
            raise SystemExit(
                f"incompatible dimension of sample in line {i + 1}: {line}"
            )
        rows.append(vals)
    if not rows:
        raise SystemExit("no data")
    return np.asarray(rows, dtype=np.float64)


def cmd_train(args) -> int:
    import jax
    import jax.numpy as jnp

    fam = _family(args)
    from .models import calc_stats
    from .optim import Bailout, train

    if args.resume and args.checkpoint is None:
        raise SystemExit("-resume requires -checkpoint FILE")
    data = read_samples(sys.stdin)
    if args.binomial:
        # binomial rows are x..., trials, successes (flag help): split off
        # the trials column before the generic x/y handling below
        if data.shape[1] < 3:
            raise SystemExit(
                "-binomial training data needs at least 3 columns "
                "(x..., trials, successes)"
            )
        trials = data[:, -2]
        data = np.delete(data, -2, axis=1)
    else:
        trials = None
    if data.shape[1] < 2:
        raise SystemExit("training data needs at least 2 columns (x..., y)")
    inputs, targets = data[:, :-1], data[:, -1]
    n, big_dim = inputs.shape

    if args.tasks is not None:
        if args.tasks < 2:
            raise SystemExit("-tasks T needs T >= 2")
        if big_dim < 2:
            raise SystemExit(
                "-tasks needs feature columns before the task-id column "
                "(got a single input column)"
            )
        if not 1 <= args.coreg_rank <= args.tasks:
            raise SystemExit("-coreg-rank R needs 1 <= R <= T")
        tcol = inputs[:, -1]
        if (not np.all(tcol == np.round(tcol)) or tcol.min() < 0
                or tcol.max() >= args.tasks):
            raise SystemExit(
                f"-tasks {args.tasks}: the last input column must hold "
                f"integer task ids in 0..{args.tasks - 1}"
            )
        if args.inducing_init == "kmeans":
            raise SystemExit(
                "-inducing-init kmeans is incompatible with -tasks "
                "(centroids would average the integer task-id column); "
                "use random or first"
            )
        from .kernels import icm_family

        fam = icm_family(fam, big_dim - 1, args.tasks, args.coreg_rank)
        # downstream helpers re-resolve the family from the flag; the
        # structural name round-trips through resolve_family
        args.kernel = fam.name

    n_extensions = sum(
        [args.pitc_block is not None, args.warp > 0, bool(args.classify),
         bool(args.poisson), bool(args.binomial), args.negbin is not None,
         bool(args.ordinal), args.student_t is not None]
    )
    _EXT_FLAGS = ("-pitc-block/-warp/-classify/-poisson/-binomial/-negbin/"
                  "-ordinal/-student-t")
    if n_extensions > 1:
        raise SystemExit(
            f"choose at most one of {_EXT_FLAGS.replace('/', ' / ')}"
        )
    if args.loo and not args.exact:
        # sparse LOO (models/loo.py) trains through the device L-BFGS
        if args.trainer != "device":
            raise SystemExit(
                "-loo needs -exact (dense) or -trainer device (sparse "
                "FITC LOO, models/loo.py)"
            )
        if args.block_size is not None:
            raise SystemExit(
                "-loo needs the materialized cross-covariance; drop "
                "-block-size"
            )
        if n_extensions:
            raise SystemExit(
                f"-loo is regression-only; drop {_EXT_FLAGS}"
            )
        if args.polish:
            raise SystemExit(
                "-polish re-optimizes the evidence and would undo a "
                "-loo fit"
            )
    if args.exact:
        if n_extensions:
            raise SystemExit(f"-exact is regression-only; drop {_EXT_FLAGS}")
        if args.block_size is not None:
            raise SystemExit("-exact is dense by definition; drop "
                             "-block-size (use the sparse engine to stream)")
        if args.trainer == "sharded" or args.devices is not None:
            raise SystemExit("-exact trains on one device (dense chol); "
                             "drop -trainer sharded/-devices")
        if args.checkpoint or args.resume:
            raise SystemExit("-exact training is seconds-scale; "
                             "-checkpoint/-resume are not supported")
        if args.polish:
            raise SystemExit("-polish re-optimizes the sparse objective "
                             "and would undo an -exact fit")
        if args.log_het_sked is not None or args.multiscale:
            raise SystemExit("-log-het-sked/-multiscale are per-inducing-"
                             "point se_fat options; -exact has no inducing "
                             "points")
        if args.cg:
            if args.loo:
                raise SystemExit("-loo's closed form needs the dense "
                                 "factor; drop -cg (or drop -loo)")
            if args.restarts > 1:
                raise SystemExit(
                    "-cg has no cheap exact-evidence VALUE to rank "
                    "restarts by (models/iterative.py scope note); run "
                    "separate -seed fits instead"
                )
        elif n > 20000:
            raise SystemExit(
                f"-exact is O(n^3): {n} rows is past the 20000-row cap; "
                "use the sparse engine (-n-inducing/-block-size) or "
                "-exact -cg (iterative exact)"
            )
    elif args.cg:
        raise SystemExit("-cg modifies -exact; add -exact (the sparse "
                         "engine has no CG path)")
    if n_extensions and args.trainer == "host":
        raise SystemExit(
            f"{_EXT_FLAGS} require -trainer "
            "device|sharded (they train via the device-resident packed "
            "objective)"
        )
    if n_extensions and args.polish:
        raise SystemExit(
            "-polish re-optimizes the FITC regression objective and would "
            f"undo a {_EXT_FLAGS} fit — not "
            "supported together"
        )
    if n_extensions and args.devices is not None and "x" in str(args.devices):
        raise SystemExit(
            f"{_EXT_FLAGS} support 1-D "
            "data-parallel meshes only (-devices N)"
        )
    if args.student_t is not None:
        if args.student_t <= 2.0:
            raise SystemExit(
                "-student-t NU needs NU > 2 (finite noise variance for "
                "the moment-matched predictive; the library API accepts "
                "any NU > 0)"
            )
        if args.checkpoint or args.resume:
            raise SystemExit(
                "-student-t alternates EM rounds whose scale weights are "
                "not in the device checkpoint — -checkpoint/-resume are "
                "not supported (re-run the fit)"
            )

    n_classes = 2
    if args.classify:
        # class labels, not regression targets: no centering of targets.
        # 0/1 or -1/+1 selects the binary Laplace (models/classify.py);
        # integer labels 0..C-1 with C >= 3 select the softmax Laplace
        # (models/classify_multi.py)
        uniq_arr = np.unique(targets)
        uniq = set(uniq_arr.tolist())
        if uniq <= {0.0, 1.0}:
            targets = 2.0 * targets - 1.0
        elif uniq <= {-1.0, 1.0}:
            pass
        elif (np.all(uniq_arr == np.round(uniq_arr))
              and uniq_arr.min() >= 0 and uniq_arr.max() >= 2
              and uniq_arr.max() < 1024):
            n_classes = int(uniq_arr.max()) + 1
        else:
            raise SystemExit(
                "-classify needs 0/1, -1/+1, or integer 0..C-1 targets, "
                f"got values {sorted(uniq)[:5]}"
            )
        if args.approx == "ep" and n_classes > 2:
            raise SystemExit(
                "-approx ep supports binary -classify only (multi-class "
                "uses the softmax Laplace)"
            )
        if args.approx == "ep" and args.block_size:
            raise SystemExit(
                "-approx ep has no streaming variant; drop -block-size "
                "(the mesh trainer already unbounds n across devices)"
            )
        target_mean = 0.0
        if args.verbose:
            if n_classes == 2:
                pos = int((targets > 0).sum())
                print(f"classes: {pos} positive / {n - pos} negative",
                      file=sys.stderr)
            else:
                counts = np.bincount(targets.astype(int),
                                     minlength=n_classes)
                print(f"classes: {n_classes} "
                      f"(counts {counts.tolist()})", file=sys.stderr)
    elif args.poisson:
        # counts, not regression targets: no centering
        if targets.min() < 0 or not np.all(targets == np.round(targets)):
            raise SystemExit(
                "-poisson needs nonnegative integer counts as targets"
            )
        target_mean = 0.0
        if args.verbose:
            print(f"counts: mean {targets.mean():.3f}, "
                  f"max {int(targets.max())}", file=sys.stderr)
    elif args.binomial:
        # successes of trials, not regression targets: no centering
        if (trials.min() < 1 or not np.all(trials == np.round(trials))
                or targets.min() < 0
                or not np.all(targets == np.round(targets))
                or np.any(targets > trials)):
            raise SystemExit(
                "-binomial needs positive integer trials and integer "
                "successes with 0 <= successes <= trials"
            )
        target_mean = 0.0
        if args.verbose:
            print(f"proportions: mean {float((targets / trials).mean()):.3f},"
                  f" trials max {int(trials.max())}", file=sys.stderr)
    elif args.negbin is not None:
        # counts, not regression targets: no centering
        if args.negbin <= 0:
            raise SystemExit("-negbin needs an initial dispersion R0 > 0")
        if targets.min() < 0 or not np.all(targets == np.round(targets)):
            raise SystemExit(
                "-negbin needs nonnegative integer counts as targets"
            )
        target_mean = 0.0
        if args.verbose:
            print(f"counts: mean {targets.mean():.3f}, "
                  f"var {targets.var():.3f}, max {int(targets.max())}",
                  file=sys.stderr)
    elif args.ordinal:
        # ordered categories, not regression targets: no centering
        uniq_arr = np.unique(targets)
        if (not np.all(uniq_arr == np.round(uniq_arr))
                or uniq_arr.min() < 0 or uniq_arr.max() < 1
                or uniq_arr.max() >= 1024):
            raise SystemExit(
                "-ordinal needs integer category targets 0..K-1 (K >= 2), "
                f"got values {uniq_arr[:5].tolist()}"
            )
        n_classes = int(uniq_arr.max()) + 1
        target_mean = 0.0
        if args.verbose:
            counts = np.bincount(targets.astype(int), minlength=n_classes)
            print(f"categories: {n_classes} (counts {counts.tolist()})",
                  file=sys.stderr)
    else:
        target_mean = float(targets.mean())
        targets = targets - target_mean
        target_variance = float(targets @ targets / n)
        if args.verbose:
            print(f"target variance: {target_variance:.5f}", file=sys.stderr)

    input_means = inputs.mean(axis=0)
    # reference parity: "stddev" = sqrt(sum of squared deviations)
    # (bin/ocaml_gpr.ml:262)
    input_stddevs = np.sqrt(((inputs - input_means) ** 2).sum(axis=0))
    input_stddevs = np.where(input_stddevs == 0.0, 1.0, input_stddevs)
    if args.tasks is not None:
        # task ids are categorical: identity transform, stored as such so
        # -cmd test leaves the ids intact for the round+gather lookup
        input_means[-1] = 0.0
        input_stddevs[-1] = 1.0
    inputs = (inputs - input_means) / input_stddevs

    n_inducing = min(args.n_inducing, n)
    seed = args.seed if args.seed is not None else int(time.time_ns() % (2**31))
    if args.restarts > 1 and (args.checkpoint or args.resume):
        raise SystemExit("-restarts > 1 is incompatible with "
                         "-checkpoint/-resume (single-trajectory state)")
    if args.resume and args.trainer == "sharded":
        raise SystemExit("-resume is not supported with -trainer sharded "
                         "(device-sharded state is mesh-layout dependent)")
    if args.devices is not None and args.trainer != "sharded":
        raise SystemExit("-devices requires -trainer sharded")

    log_sf2 = 2.0 * math.log(args.amplitude)

    if fam.name == "se_fat":
        def build_params(rng):
            """Per-restart kernel params: the projection draw is the random
            part (reference init, bin/ocaml_gpr.ml:272-300)."""
            if args.dim_red is not None:
                d = min(big_dim, args.dim_red)
                tproj = jnp.asarray(
                    rng.uniform(-1.0, 1.0, (big_dim, d)) / big_dim
                )
            else:
                d = big_dim
                tproj = None
            return fam.Params(
                d=d,
                log_sf2=jnp.asarray(log_sf2),
                tproj=tproj,
                log_hetero_skedasticity=(
                    jnp.full((n_inducing,), args.log_het_sked)
                    if args.log_het_sked is not None
                    else None
                ),
                log_multiscales_m05=(
                    jnp.zeros((n_inducing, d)) if args.multiscale else None
                ),
            )
    else:
        # -kernel NAME: the family's default hyper init; -amplitude maps
        # onto log_sf2 where the family has a signal-variance hyper
        if (args.dim_red is not None or args.log_het_sked is not None
                or args.multiscale):
            raise SystemExit(
                "-dim-red/-log-het-sked/-multiscale apply to the se_fat "
                f"kernel only (got -kernel {fam.name})"
            )
        import dataclasses as _dc

        has_sf2 = "log_sf2" in {f.name for f in _dc.fields(fam.Params)}
        if args.amplitude != 1.0 and not has_sf2:
            raise SystemExit(
                f"-amplitude needs a signal-variance hyper; -kernel "
                f"{fam.name} has none"
            )

        sm_q = _sm_q(args.kernel)

        def build_params(rng):
            if sm_q is not None:
                # -kernel smQ: empirical-spectrum init (kernels/sm_init.py)
                # — deterministic top peaks first, power-weighted draws
                # for the later restarts
                from .kernels import sm_init_from_data

                return sm_init_from_data(
                    sm_q, inputs, targets,
                    key=None if args.restarts == 1
                    else int(rng.integers(2**31)),
                )
            key = jax.random.PRNGKey(int(rng.integers(2**31)))
            p = fam.default_params(jnp.asarray(inputs), n_inducing, key)
            if has_sf2 and args.amplitude != 1.0:
                p = _dc.replace(p, log_sf2=jnp.asarray(log_sf2))
            return p

    X = jnp.asarray(inputs)
    if (args.classify and n_classes > 2) or args.ordinal:
        y = jnp.asarray(targets.astype(np.int32))
    else:
        y = jnp.asarray(targets)
    trials_j = jnp.asarray(trials) if trials is not None else None

    got_signal = {"flag": False}

    def on_sigint(signum, frame):
        got_signal["flag"] = True

    old_handler = signal.signal(signal.SIGINT, on_sigint)

    last_report = {"eval": 0.0, "grad": 0.0}

    def stats_line(trained):
        st = calc_stats(trained)
        return (
            f"MSLL={float(st.msll):7.7f} SMSE={float(st.smse):7.7f} "
            f"MAD={float(st.mad):7.7f} MAXAD={float(st.maxad):7.7f}"
        )

    def bailout(iter):
        if got_signal["flag"]:
            raise Bailout
        if args.max_iter is not None and iter > args.max_iter:
            raise Bailout

    def report_trained_model(iter, trained):
        bailout(iter)
        if args.verbose and time.time() - last_report["eval"] > 1.0:
            last_report["eval"] = time.time()
            print(f"iter {iter:4d}: {stats_line(trained)}", file=sys.stderr,
                  flush=True)

    def report_gradient_norm(iter, norm):
        bailout(iter)
        if args.verbose and time.time() - last_report["grad"] > 1.0:
            last_report["grad"] = time.time()
            print(f"iter {iter:4d}: |gradient|={norm:.5f}", file=sys.stderr,
                  flush=True)

    if n_extensions:
        return _train_extension(args, X, y, n_inducing, seed, build_params,
                                got_signal, old_handler, target_mean,
                                input_means, input_stddevs, n_classes,
                                trials_j)

    if args.exact:
        signal.signal(signal.SIGINT, old_handler)
        if args.cg:
            return _train_exact_cg(args, X, y, seed, build_params,
                                   target_mean, input_means, input_stddevs)
        return _train_exact(args, X, y, seed, build_params, target_mean,
                            input_means, input_stddevs)

    if args.trainer != "host":
        trained = _train_on_device(args, X, y, n_inducing, seed,
                                   build_params, got_signal, old_handler)
        trained = _apply_polish(args, X, y, trained)
        if args.verbose:
            print(f"result: {stats_line(trained)}", file=sys.stderr)
        _write_artifact(args, trained, target_mean, input_means,
                        input_stddevs)
        return 0

    try:
        trained = None
        for r in range(max(1, args.restarts)):
            seed_r = seed + r
            params_r = build_params(np.random.default_rng(seed_r))
            z_r = (
                None if args.inducing_init == "random"
                else _choose_inducing(args, jax.random.PRNGKey(seed_r),
                                      fam, params_r, X, n_inducing)
            )
            cand = train(
                fam, X, y,
                kernel_params=params_r,
                sigma2=args.sigma2,
                inducing=z_r,
                n_rand_inducing=n_inducing,
                variational=True,  # Variational_FIC, like the CLI
                block_size=args.block_size,
                step=args.step, tol=args.tol, epsabs=args.eps,
                max_iter=args.max_iter,
                report_trained_model=report_trained_model,
                report_gradient_norm=report_gradient_norm,
                key=jax.random.PRNGKey(seed_r),
                checkpoint_path=args.checkpoint,
                resume=args.resume,
            )
            # NaN-safe best: a diverged draw (NaN evidence) must never beat
            # a finite one — every float comparison against NaN is False
            def _key(t):
                l = float(t.l)
                return (math.isfinite(l), l if math.isfinite(l) else 0.0)

            if trained is None or _key(cand) > _key(trained):
                trained = cand
            if args.verbose and args.restarts > 1:
                print(f"restart {r}: log evidence {float(cand.l):.3f}"
                      f" (best {float(trained.l):.3f})", file=sys.stderr)
            if got_signal["flag"]:
                break  # SIGINT: keep the best model found so far
    finally:
        signal.signal(signal.SIGINT, old_handler)

    trained = _apply_polish(args, X, y, trained)
    if args.verbose:
        print(f"result: {stats_line(trained)}", file=sys.stderr)

    _write_artifact(args, trained, target_mean, input_means, input_stddevs)
    return 0


def _apply_polish(args, X, y, trained):
    """-polish N: f64 finishing step (optim.polish) after any trainer.

    Reruns the same mean-NLL objective at f64 on the host CPU from the
    trained hypers (row subsample of N bounds the cost; N >= n uses all
    rows) and rebuilds the predictor state from the polished hypers.  The
    reference never needs this — GSL BFGS2 is f64 end to end; this restores
    its convergence semantics after an f32 device run (MANUAL section 7).
    """
    if not args.polish:
        return trained
    fam = _family(args)
    from .models.streaming import streaming_trained
    from .optim import make_pack
    from .optim.polish import polish
    from .optim.train import TrainResult

    pack = make_pack(fam, trained.kernel_params, trained.inducing,
                     float(trained.model.sigma2))
    p_f, z_f, s2_f, _, rep = polish(
        fam, X, y, pack, pack.x0, variational=True,
        subsample=min(args.polish, X.shape[0]),
        max_iter=args.max_iter if args.max_iter is not None else 40,
        epsabs=args.eps / max(1, min(args.polish, X.shape[0])),
    )
    if args.verbose:
        print(f"polish (f64, {rep.n_rows} rows): mean-NLL {rep.f0:.6f} -> "
              f"{rep.f:.6f}, |grad| {rep.gnorm0:.2e} -> {rep.gnorm:.2e} "
              f"({rep.n_iter} iters, {rep.wall_s:.0f}s)", file=sys.stderr)
    new = streaming_trained(
        fam, p_f, z_f, s2_f, X, y, variational=True,
        block_size=args.block_size or 8192,
    )
    return TrainResult(new, p_f, z_f, s2_f)


def _train_exact(args, X, y, seed, build_params, target_mean, input_means,
                 input_stddevs):
    """-exact: dense GP hyper training (models/exact.py).

    Runs the packed device L-BFGS over the exact evidence (or, with -loo,
    the LOO pseudo-likelihood); -restarts draws fresh kernel inits and keeps
    the best objective.  The artifact reuses the standard schema with the
    training set as the "inducing" set, alpha in the coeffs slot, and
    chol(K + sigma2 I) in the chol_km slot, tagged exact=1 in the extras.
    """
    import jax
    import jax.numpy as jnp
    import numpy as _np

    from .io.checkpoint import ModelArtifact, save_model
    from .models.exact import (
        fit_exact,
        loo_log_likelihood,
        loo_posterior,
    )

    fam = _family(args)
    objective = "loo" if args.loo else "evidence"
    best = None
    for r in range(max(1, args.restarts)):
        params0 = build_params(np.random.default_rng(seed + r))
        if r > 0:
            # The sparse trainers' restarts diversify through fresh random
            # inducing subsets; -exact has none, and deterministic-default
            # families (se_iso: log_ell = log_sf2 = 0, cov_se_iso.ml:122-123)
            # make plain re-draws identical.  Jitter every hyper by ~1 log
            # unit so restarts actually explore the evidence landscape.
            jrng = _np.random.default_rng(10_000 + seed + r)
            params0 = jax.tree.map(
                lambda a: a + jnp.asarray(
                    jrng.normal(0.0, 1.0, _np.shape(a)), a.dtype
                ),
                params0,
            )
        trained, params, sigma2 = fit_exact(
            fam, params0, X, y, args.sigma2, objective=objective,
            max_iter=args.max_iter if args.max_iter is not None else 100,
            # the packed objective is mean-scaled, so -eps applies per
            # point — same convention as -trainer device (line above)
            step=args.step, tol=args.tol, epsabs=args.eps / X.shape[0],
        )
        score = float(loo_log_likelihood(trained)) if args.loo \
            else float(trained.l)
        if not math.isfinite(score):
            continue
        if best is None or score > best[0]:
            best = (score, trained, params, sigma2)
        if args.verbose and args.restarts > 1:
            print(f"restart {r}: {objective} {score:.3f} "
                  f"(best {best[0]:.3f})", file=sys.stderr)
    if best is None:
        raise SystemExit("-exact training diverged (non-finite objective); "
                         "try a different -sigma2 / -seed")
    _, trained, params, sigma2 = best

    if args.verbose:
        mu, var = loo_posterior(trained)
        resid = _np.asarray(trained.y) - _np.asarray(mu)
        smse = float((resid ** 2).mean() / _np.var(_np.asarray(trained.y)))
        print(f"result: log evidence {float(trained.l):.3f}, "
              f"LOO log p {float(loo_log_likelihood(trained)):.3f}, "
              f"LOO SMSE {smse:.5f}, sigma2 {float(sigma2):.6f}",
              file=sys.stderr)

    art = ModelArtifact(
        family_name=fam.name,
        kernel_params=params,
        inducing=_np.asarray(trained.model.z),
        coeffs=_np.asarray(trained.alpha),
        chol_km=_np.asarray(trained.model.chol_a),
        r_mat=_np.asarray(trained.model.chol_a),
        sigma2=float(sigma2),
        target_mean=target_mean,
        input_means=input_means,
        input_stddevs=input_stddevs,
    )
    save_model(args.model, art, extra_arrays={"exact": _np.float64(1.0)})
    return 0


def _train_exact_cg(args, X, y, seed, build_params, target_mean,
                    input_means, input_stddevs):
    """-exact -cg: iterative exact GP (models/iterative.py).

    Hypers train by SGD on unbiased stochastic exact-evidence gradients
    (Hutchinson probes with the Nystrom preconditioner as control variate,
    evidence_grads_iter); the final posterior coefficients come from one
    tight Nystrom-preconditioned CG solve.  The artifact reuses the
    standard schema (training inputs in the inducing slot, alpha in
    coeffs) tagged exact_cg=1 plus the RAW training inputs — ``-cmd test
    -with-stddev`` re-runs CG per test batch for exact variances.
    """
    import jax
    import jax.numpy as jnp
    import numpy as _np

    from .io.checkpoint import ModelArtifact, save_model
    from .models.iterative import fit_iter, iter_trained

    import dataclasses as _dc

    fam = _family(args)
    n = X.shape[0]
    anchors = min(max(args.n_inducing, 1), n)
    n_steps = args.max_iter if args.max_iter is not None else 60
    params0 = build_params(np.random.default_rng(seed))
    key = jax.random.PRNGKey(seed)

    # SGD needs a scale-aware init that L-BFGS does not: the reference's
    # ssqr input standardization (PARITY_NOTES #8) leaves inputs spanning
    # ~n^-1/2, so a log_ell = 0 start makes the kernel constant and the
    # clipped SGD loses the race to the all-noise basin (measured on the
    # bundled synthetic: sigma2 ratchets to the target variance at the
    # clip rate).  Median-pairwise-distance ell + target-variance sf2 fix
    # it; flags (-amplitude / -sigma2) override when set away from their
    # defaults.
    tv = float(jnp.dot(y, y) / n)
    fields = {f.name for f in _dc.fields(params0)}
    upd = {}
    if "log_ell" in fields:
        sub = np.asarray(X)[np.random.default_rng(seed).choice(
            n, min(256, n), replace=False)]
        d2 = ((sub[:, None, :] - sub[None, :, :]) ** 2).sum(-1)
        ell0 = float(np.sqrt(np.median(d2[d2 > 0])) / 2.0)
        upd["log_ell"] = jnp.asarray(np.log(ell0), X.dtype)
    if "log_sf2" in fields and args.amplitude == 1.0:
        upd["log_sf2"] = jnp.asarray(np.log(max(tv, 1e-8)), X.dtype)
    if upd:
        params0 = _dc.replace(params0, **upd)
    sigma2_0 = args.sigma2 if args.sigma2 != 1.0 else max(tv / 4.0, 1e-8)

    def cb(step, params, sigma2, info):
        if args.verbose and (step % 10 == 0 or step == n_steps - 1):
            print(f"sgd step {step:4d}: sigma2 {float(sigma2):.5f} "
                  f"cg iters {int(info['iters'])} relres "
                  f"{float(jnp.max(info['relres'])):.2e}",
                  file=sys.stderr, flush=True)

    params, sigma2 = fit_iter(
        fam, params0, X, y, sigma2_0, key=key, n_steps=n_steps,
        eta0=args.step, n_inducing=anchors,
        callback=cb if args.verbose else None,
    )
    trained = iter_trained(
        fam, params, X, y, sigma2, n_inducing=anchors,
        key=jax.random.fold_in(key, 999), tol=1e-6, max_iter=400,
    )
    if args.verbose:
        print(f"final solve: {int(trained.iters)} CG iters, relres "
              f"{float(trained.relres):.2e}, sigma2 {float(sigma2):.6f}",
              file=sys.stderr)

    eye1 = _np.eye(1, dtype=_np.float64)
    art = ModelArtifact(
        family_name=fam.name,
        kernel_params=params,
        inducing=_np.asarray(trained.z),
        coeffs=_np.asarray(trained.alpha),
        chol_km=eye1,  # no dense factor exists; variances re-solve by CG
        r_mat=eye1,
        sigma2=float(sigma2),
        target_mean=target_mean,
        input_means=input_means,
        input_stddevs=input_stddevs,
    )
    save_model(args.model, art, extra_arrays={
        "exact_cg": _np.float64(1.0),
        "cg_x": _np.asarray(X, _np.float64),
        "cg_anchors": _np.float64(anchors),
    })
    return 0


def _choose_inducing(args, key, fam, params, X, n_inducing):
    """-inducing-init dispatch shared by every trainer path."""
    from .models.fitc import (
        choose_kmeans_inputs,
        choose_n_first_inputs,
        choose_n_random_inputs,
    )

    if args.inducing_init == "kmeans":
        return choose_kmeans_inputs(key, fam, params, X, n_inducing)
    if args.inducing_init == "first":
        return choose_n_first_inputs(fam, params, X, n_inducing)
    return choose_n_random_inputs(key, fam, params, X, n_inducing)


def _report_coregionalization(args, params):
    """-tasks -verbose: print the learned task-covariance matrix B and the
    inter-task correlations — the quantities a multi-output user reads off
    the fit (kernels/task.py ``coregionalization``)."""
    if args.tasks is None or not args.verbose:
        return
    from .kernels.task import task_family

    tk = task_family(args.tasks, args.coreg_rank)
    B = np.asarray(tk.coregionalization(params.terms[0].terms[0]))
    d = np.sqrt(np.maximum(np.diag(B), 1e-30))
    C = B / np.outer(d, d)
    print("coregionalization B (task covariances):", file=sys.stderr)
    for row in B:
        print("  " + " ".join(f"{v:9.4f}" for v in row), file=sys.stderr)
    print("inter-task correlations:", file=sys.stderr)
    for row in C:
        print("  " + " ".join(f"{v:6.3f}" for v in row), file=sys.stderr)


def _write_artifact(args, trained, target_mean, input_means, input_stddevs):
    from .io.checkpoint import ModelArtifact, save_model
    fam = _family(args)
    _report_coregionalization(args, trained.kernel_params)

    art = ModelArtifact(
        family_name=fam.name,
        kernel_params=trained.kernel_params,
        inducing=np.asarray(trained.model.inducing.z),
        coeffs=np.asarray(trained.coeffs),
        chol_km=np.asarray(trained.model.inducing.chol_km),
        r_mat=np.asarray(trained.model.r_mat),
        sigma2=float(trained.model.sigma2),
        target_mean=target_mean,
        input_means=input_means,
        input_stddevs=input_stddevs,
    )
    save_model(args.model, art)


def _train_on_device(args, X, y, n_inducing, seed, build_params, got_signal,
                     old_handler):
    """-trainer device|sharded: the accelerator training paths at the CLI
    surface (VERDICT.md round-2 #3 at commit b587de6).  Same model (se_fat variational FIC),
    same artifact schema as the host loop; the optimizer runs device-
    resident (optim.lbfgs_device.fit / parallel.fit_sharded) with the
    mean-NLL objective.  -eps keeps the host trainer's TOTAL-gradient
    meaning: mean |g| < eps/n  <=>  total |g| < eps, so the same flag value
    stops both trainers at the same point.
    SIGINT stops after the in-flight chunk and keeps the incumbent (the
    device L-BFGS is monotone, so the incumbent IS the best model so far).
    """
    import jax
    import jax.numpy as jnp

    fam = _family(args)
    from .models.fitc import (
        calc_model,
        calc_trained,
        choose_n_random_inputs,
    )
    from .optim import Bailout, make_pack
    from .optim.lbfgs_device import fit, fit_restarts
    from .optim.train import TrainResult

    max_iter = args.max_iter if args.max_iter is not None else 100

    def start(r):
        rng = np.random.default_rng(seed + r)
        params = build_params(rng)
        key = jax.random.PRNGKey(seed + r)
        z = _choose_inducing(args, key, fam, params, X, n_inducing)
        return params, z

    params0, z0 = start(0)
    pack = make_pack(fam, params0, z0, args.sigma2)

    common = dict(
        variational=True, step=args.step, tol=args.tol,
        epsabs=args.eps / X.shape[0], max_iter=max_iter,
    )
    # -loo (sparse): validated upstream to the device trainer only
    loo_kw = {"objective": "loo"} if getattr(args, "loo", False) else {}

    last_state = {"st": None}

    def on_chunk(st):
        last_state["st"] = st
        if args.checkpoint is not None:
            from .io.resume import save_device_checkpoint

            save_device_checkpoint(args.checkpoint, st)
        if args.verbose:
            print(
                f"iter {int(st.n_iter):4d}: f={float(st.f):.6f} "
                f"|gradient|={float(jnp.linalg.norm(st.g)):.5f} "
                f"evals={int(st.n_evals)}", file=sys.stderr, flush=True,
            )
        if got_signal["flag"]:
            raise Bailout

    try:
        if args.trainer == "device":
            if args.restarts > 1:
                x0s = [pack.x0] + [
                    make_pack(fam, *start(r), args.sigma2).x0
                    for r in range(1, args.restarts)
                ]
                p_f, z_f, s2_f, st, probe_fs = fit_restarts(
                    fam, X, y, pack, x0s,
                    streaming_block_size=args.block_size, **common, **loo_kw,
                )
                if args.verbose:
                    print(f"restart probes: "
                          f"{[round(float(f), 4) for f in probe_fs]}",
                          file=sys.stderr)
            else:
                init_state = None
                if args.resume:
                    import os

                    if os.path.exists(args.checkpoint):
                        from .io.resume import load_device_checkpoint

                        init_state = load_device_checkpoint(args.checkpoint)
                        if init_state.x.shape != pack.x0.shape:
                            raise SystemExit(
                                "checkpoint hyper vector does not match this "
                                "configuration — resume requires the same "
                                "model/data setup"
                            )
                try:
                    p_f, z_f, s2_f, st = fit(
                        fam, X, y, pack,
                        streaming_block_size=args.block_size,
                        init_state=init_state, state_callback=on_chunk,
                        **common, **loo_kw,
                    )
                except Bailout:
                    st = last_state["st"]
                    p_f, z_f, s2_f = pack.unpack(st.x)
        else:  # sharded
            from .parallel import make_mesh, make_mesh_2d
            from .parallel.mesh2d import fit_sharded_2d
            from .parallel.sharded import fit_restarts_sharded, fit_sharded

            if args.devices is not None and "x" in str(args.devices):
                n_d, n_m = map(int, str(args.devices).split("x"))
                mesh = make_mesh_2d(n_d, n_m)
                fit_one = fit_sharded_2d
            else:
                mesh = make_mesh(
                    int(args.devices) if args.devices is not None else None
                )
                fit_one = fit_sharded
            if args.restarts > 1:
                # probes run CONCURRENTLY, one batch of starts per device
                # (starts axis sharded over the mesh); the winner continues
                # n-sharded — same probe-then-continue scheme as the device
                # trainer's fit_restarts
                x0s = [pack.x0] + [
                    make_pack(fam, *start(r), args.sigma2).x0
                    for r in range(1, args.restarts)
                ]
                p_f, z_f, s2_f, st, probe_fs = fit_restarts_sharded(
                    fam, mesh, X, y, pack, x0s,
                    block_size=args.block_size or 8192, **common,
                )
                if args.verbose:
                    print(f"restart probes (parallel over "
                          f"{mesh.devices.size} devices): "
                          f"{[round(float(f), 4) for f in probe_fs]}",
                          file=sys.stderr)
            else:
                try:
                    cand = fit_one(
                        fam, mesh, X, y, pack,
                        block_size=args.block_size or 8192,
                        state_callback=on_chunk, **common,
                    )
                except Bailout:
                    st_b = last_state["st"]
                    cand = (*pack.unpack(st_b.x), st_b)
                p_f, z_f, s2_f, st = cand
    finally:
        signal.signal(signal.SIGINT, old_handler)

    if args.block_size is not None or args.trainer == "sharded":
        from .models.streaming import streaming_trained

        trained = streaming_trained(
            fam, p_f, z_f, s2_f, X, y, variational=True,
            block_size=args.block_size or 8192,
        )
    else:
        model = calc_model(fam, p_f, X, z_f, s2_f, variational=True,
                           factorization="chol")
        trained = calc_trained(model, y)
    return TrainResult(trained, p_f, z_f, s2_f)


def _train_extension(args, X, y, n_inducing, seed, build_params, got_signal,
                     old_handler, target_mean, input_means, input_stddevs,
                     n_classes, trials_j=None):
    """-pitc-block/-warp/-classify: the extension model families at the CLI
    surface.  The reference CLI has no counterpart flags (these families are
    its manual's unshipped future work, doc/manual/gpr_manual.tex:532-559),
    so the design is ours: each mode trains the se_fat model through the
    generic packed-objective device L-BFGS (optim.fit_packed_objective) —
    single-device or 1-D data-parallel mesh — and writes the SAME artifact
    schema as the regression path, with mode state in the npz extras:

      * -pitc-block B: PITC evidence (pred state via models.pitc.pitc_coeffs;
        the artifact serves through the standard predictors unchanged);
      * -warp K: joint warp training; extras carry the warp parameters and
        cmd_test integrates the inverse warp by Gauss-Hermite quadrature;
      * -classify: Laplace classifier; coeffs := U^-1 V'a and
        r_mat := Rn U collapse the posterior onto the standard predictor
        algebra (mean/var as FITC), cmd_test applies the probit squash.
        Integer labels 0..C-1 (C >= 3) select the softmax Laplace
        (models/classify_multi.py); the m-space predictor state (a_tilde,
        b_tilde) rides in the extras and cmd_test prints one probability
        per class.

    -restarts N runs N sequential fits and keeps the lowest final objective
    (all modes train the mean-NLL-scaled objective, so f is comparable
    across starts); -checkpoint/-resume follow the device-trainer rules.
    """
    import jax
    import jax.numpy as jnp

    fam = _family(args)
    from .models.fitc import choose_n_random_inputs
    from .optim import Bailout, make_pack
    from .optim.lbfgs_device import fit_packed_objective

    n = X.shape[0]
    max_iter = args.max_iter if args.max_iter is not None else 100
    block_size = args.block_size or 8192

    mesh = None
    if args.trainer == "sharded":
        from .parallel import make_mesh

        mesh = make_mesh(
            int(args.devices) if args.devices is not None else None
        )

    def start(r):
        rng = np.random.default_rng(seed + r)
        params = build_params(rng)
        key = jax.random.PRNGKey(seed + r)
        z = _choose_inducing(args, key, fam, params, X, n_inducing)
        return params, z

    last_state = {"st": None}

    def on_chunk(st):
        last_state["st"] = st
        if args.checkpoint is not None:
            from .io.resume import save_device_checkpoint

            save_device_checkpoint(args.checkpoint, st)
        if args.verbose:
            print(
                f"iter {int(st.n_iter):4d}: f={float(st.f):.6f} "
                f"|gradient|={float(jnp.linalg.norm(st.g)):.5f} "
                f"evals={int(st.n_evals)}", file=sys.stderr, flush=True,
            )
        if got_signal["flag"]:
            raise Bailout

    def load_resume_state(pack_x0):
        if not args.resume:
            return None
        import os

        if not os.path.exists(args.checkpoint):
            return None
        from .io.resume import load_device_checkpoint

        init_state = load_device_checkpoint(args.checkpoint)
        if init_state.x.shape != pack_x0.shape:
            raise SystemExit(
                "checkpoint hyper vector does not match this configuration "
                "— resume requires the same model/data setup"
            )
        return init_state

    common = dict(step=args.step, tol=args.tol, epsabs=args.eps / n,
                  max_iter=max_iter, state_callback=on_chunk)

    def run_one(r):
        """One fit from start r; returns (mode-specific result, st)."""
        params0, z0 = start(r)
        if args.classify:
            pack = make_pack(fam, params0, z0, 1.0, learn_sigma2=False)
            if n_classes > 2:
                from .models.classify_multi import fit_classify_multi

                p, z, st = fit_classify_multi(
                    fam, X, y, pack, n_classes, mesh=mesh,
                    block_size=args.block_size,  # None = materialized V
                    init_state=load_resume_state(pack.x0), **common,
                )
            elif args.approx == "ep":
                from .models.classify_ep import fit_classify_ep

                p, z, st = fit_classify_ep(
                    fam, X, y, pack, mesh=mesh,
                    init_state=load_resume_state(pack.x0), **common,
                )
            else:
                from .models.classify import fit_classify

                p, z, st = fit_classify(
                    fam, X, y, pack, mesh=mesh,
                    block_size=args.block_size,  # None = materialized V
                    init_state=load_resume_state(pack.x0), **common,
                )
            return (p, z, None, None), st, pack
        if args.ordinal:
            from .models.ordinal import default_cutpoint_raw, fit_ordinal

            pack = make_pack(fam, params0, z0, 1.0, learn_sigma2=False)
            cut0 = default_cutpoint_raw(n_classes, dtype=X.dtype)
            ext_x0 = jnp.concatenate([pack.x0, cut0])
            p, z, cut_raw, st = fit_ordinal(
                fam, X, y, pack, cut0, mesh=mesh,
                block_size=args.block_size,  # None = materialized V
                init_state=load_resume_state(ext_x0), **common,
            )
            return (p, z, None, cut_raw), st, pack
        if args.student_t is not None:
            from .models.robust import fit_t

            pack = make_pack(fam, params0, z0, args.sigma2)
            n_em = 5
            p, z, s2, lam, st = fit_t(
                fam, X, y, pack, nu=args.student_t, n_em=n_em, mesh=mesh,
                m_step_iters=max(5, max_iter // n_em),
                **{k: v for k, v in common.items() if k != "max_iter"},
            )
            if args.verbose:
                lam_np = np.asarray(lam)
                print(
                    f"student-t: {int((lam_np < 0.1).sum())} rows "
                    f"downweighted below 0.1 (min lam "
                    f"{float(lam_np.min()):.4f})", file=sys.stderr,
                )
            return (p, z, s2, None), st, pack
        if args.poisson:
            pack = make_pack(fam, params0, z0, 1.0, learn_sigma2=False)
            if mesh is None:
                from .models.poisson import fit_poisson

                p, z, st = fit_poisson(
                    fam, X, y, pack,
                    block_size=args.block_size,  # None = materialized V
                    init_state=load_resume_state(pack.x0), **common,
                )
            else:
                from .parallel import shard_batch
                from .parallel.classify_sharded import (
                    sharded_poisson_log_evidence,
                )

                Xs, ys, mask = shard_batch(mesh, X, y)

                def fg(x, Xs, ys, mask):
                    def f(x):
                        params, z, _ = pack.unpack(x)
                        return -(1.0 / n) * sharded_poisson_log_evidence(
                            fam, mesh, params, z, Xs, ys, mask,
                        )

                    return jax.value_and_grad(f)(x)

                st = fit_packed_objective(
                    fg, pack, (Xs, ys, mask),
                    init_state=load_resume_state(pack.x0), **common,
                )
                p, z, _ = pack.unpack(st.x)
            return (p, z, None, None), st, pack
        if args.negbin is not None:
            # the pack's positive sigma2 slot carries the NB dispersion r
            # (models/negbin.py docstring); it is learned like every other
            # hyper and reported below
            pack = make_pack(fam, params0, z0, args.negbin)
            if mesh is None:
                from .models.negbin import fit_negbin

                p, z, r_disp, st = fit_negbin(
                    fam, X, y, pack,
                    block_size=args.block_size,  # None = materialized V
                    init_state=load_resume_state(pack.x0), **common,
                )
            else:
                from .parallel import shard_batch
                from .parallel.classify_sharded import (
                    sharded_negbin_log_evidence,
                )

                Xs, ys, mask = shard_batch(mesh, X, y)

                def fg(x, Xs, ys, mask):
                    def f(x):
                        params, z, r = pack.unpack(x)
                        return -(1.0 / n) * sharded_negbin_log_evidence(
                            fam, mesh, params, z, Xs, ys, r, mask,
                        )

                    return jax.value_and_grad(f)(x)

                st = fit_packed_objective(
                    fg, pack, (Xs, ys, mask),
                    init_state=load_resume_state(pack.x0), **common,
                )
                p, z, r_disp = pack.unpack(st.x)
            if args.verbose:
                print(f"negbin: learned dispersion r = {float(r_disp):.4f} "
                      f"(started at {args.negbin:g}; larger = closer to "
                      f"Poisson)", file=sys.stderr)
            return (p, z, r_disp, None), st, pack
        if args.binomial:
            pack = make_pack(fam, params0, z0, 1.0, learn_sigma2=False)
            if mesh is None:
                from .models.binomial import fit_binomial

                p, z, st = fit_binomial(
                    fam, X, y, trials_j, pack,
                    block_size=args.block_size,  # None = materialized V
                    init_state=load_resume_state(pack.x0), **common,
                )
            else:
                from .parallel import shard_batch
                from .parallel.classify_sharded import (
                    sharded_binomial_log_evidence,
                )

                Xs, ys, mask = shard_batch(mesh, X, y)
                _, ts, _ = shard_batch(mesh, X, trials_j)

                def fg(x, Xs, ys, ts, mask):
                    def f(x):
                        params, z, _ = pack.unpack(x)
                        return -(1.0 / n) * sharded_binomial_log_evidence(
                            fam, mesh, params, z, Xs, ys, ts, mask,
                        )

                    return jax.value_and_grad(f)(x)

                st = fit_packed_objective(
                    fg, pack, (Xs, ys, ts, mask),
                    init_state=load_resume_state(pack.x0), **common,
                )
                p, z, _ = pack.unpack(st.x)
            return (p, z, None, None), st, pack
        if args.warp:
            from .models.warped import default_warp_params, fit_warped

            pack = make_pack(fam, params0, z0, args.sigma2)
            wp0 = default_warp_params(args.warp, dtype=X.dtype)
            if mesh is None:
                p, z, s2, wp, st = fit_warped(
                    fam, X, y, pack, wp0, variational=True,
                    block_size=block_size,
                    init_state=load_resume_state(
                        jnp.concatenate([
                            pack.x0,
                            jnp.zeros(3 * args.warp, pack.x0.dtype),
                        ])
                    ),
                    **common,
                )
            else:
                from .models.warped import make_warped_pack
                from .parallel import shard_batch
                from .parallel.sharded import sharded_warped_log_evidence

                pack_w, unpack_w = make_warped_pack(pack, wp0)
                Xs, ys, mask = shard_batch(mesh, X, y)

                def fg(x, Xs, ys, mask):
                    def f(x):
                        params, z, sigma2, wp = unpack_w(x)
                        return -(1.0 / n) * sharded_warped_log_evidence(
                            fam, mesh, params, wp, z, sigma2, Xs, ys,
                            mask, variational=True, block_size=block_size,
                        )

                    return jax.value_and_grad(f)(x)

                st = fit_packed_objective(
                    fg, pack_w, (Xs, ys, mask),
                    init_state=load_resume_state(pack_w.x0), **common,
                )
                p, z, s2, wp = unpack_w(st.x)
            return (p, z, s2, wp), st, pack
        # PITC
        pack = make_pack(fam, params0, z0, args.sigma2)
        if mesh is None:
            from .models.pitc import pitc_log_evidence

            def fg(x, X, y):
                def f(x):
                    params, z, sigma2 = pack.unpack(x)
                    return -(1.0 / n) * pitc_log_evidence(
                        fam, params, z, sigma2, X, y,
                        block_size=args.pitc_block,
                    )

                return jax.value_and_grad(f)(x)

            data = (X, y)
        else:
            from .parallel import shard_batch
            from .parallel.sharded import sharded_pitc_log_evidence

            Xs, ys, mask = shard_batch(mesh, X, y)

            def fg(x, Xs, ys, mask):
                def f(x):
                    params, z, sigma2 = pack.unpack(x)
                    return -(1.0 / n) * sharded_pitc_log_evidence(
                        fam, mesh, params, z, sigma2, Xs, ys, mask,
                        block_size=args.pitc_block,
                    )

                return jax.value_and_grad(f)(x)

            data = (Xs, ys, mask)
        st = fit_packed_objective(
            fg, pack, data, init_state=load_resume_state(pack.x0), **common,
        )
        p, z, s2 = pack.unpack(st.x)
        return (p, z, s2, None), st, pack

    best = None
    try:
        for r in range(max(1, args.restarts)):
            try:
                result, st, pack = run_one(r)
            except Bailout:
                st = last_state["st"]
                if st is None:
                    raise SystemExit("interrupted before the first iteration")
                result, pack = _unpack_extension_state(args, st, r, X, start)
            # NaN-safe best (lower mean NLL wins; NaN never beats finite)
            f = float(st.f)
            key_ = (not math.isfinite(f), f if math.isfinite(f) else 0.0)
            if best is None or key_ < best[0]:
                best = (key_, result, st)
            if args.verbose and args.restarts > 1:
                print(f"restart {r}: objective {f:.6f} "
                      f"(best {float(best[2].f):.6f})", file=sys.stderr)
            if got_signal["flag"]:
                break
    finally:
        signal.signal(signal.SIGINT, old_handler)

    _, result, st = best
    if args.verbose:
        print(f"result: objective={float(st.f):.6f} "
              f"|gradient|={float(np.linalg.norm(np.asarray(st.g))):.2e}",
              file=sys.stderr)
    _write_extension_artifact(args, result, X, y, target_mean, input_means,
                              input_stddevs, block_size, n_classes,
                              trials=trials_j)
    return 0


def _unpack_extension_state(args, st, r, X, start):
    """Rebuild (result, pack) from a bailed-out optimizer state."""
    import jax.numpy as jnp

    fam = _family(args)
    from .optim import make_pack

    params0, z0 = start(r)
    if args.classify or args.poisson or args.binomial:
        pack = make_pack(fam, params0, z0, 1.0, learn_sigma2=False)
        p, z, _ = pack.unpack(st.x)
        return (p, z, None, None), pack
    if args.negbin is not None:
        pack = make_pack(fam, params0, z0, args.negbin)
        p, z, r_disp = pack.unpack(st.x)
        return (p, z, r_disp, None), pack
    if args.ordinal:
        from .optim.pack import extend_pack

        pack = make_pack(fam, params0, z0, 1.0, learn_sigma2=False)
        # K-1 cutpoint raws ride after the base coordinates
        k1 = int(st.x.shape[0]) - int(pack.x0.shape[0])
        ext = extend_pack(pack, jnp.zeros((k1,), pack.x0.dtype))
        p, z, _ = ext.unpack(st.x)
        return (p, z, None, ext.unpack_extra(st.x)), pack
    if args.student_t is not None:
        pack = make_pack(fam, params0, z0, args.sigma2)
        p, z, s2 = pack.unpack(st.x)
        return (p, z, s2, None), pack
    if args.warp:
        from .models.warped import default_warp_params, make_warped_pack

        pack = make_pack(fam, params0, z0, args.sigma2)
        wp0 = default_warp_params(args.warp, dtype=X.dtype)
        _, unpack_w = make_warped_pack(pack, wp0)
        return unpack_w(st.x), pack
    pack = make_pack(fam, params0, z0, args.sigma2)
    p, z, s2 = pack.unpack(st.x)
    return (p, z, s2, None), pack


def _write_extension_artifact(args, result, X, y, target_mean, input_means,
                              input_stddevs, block_size, n_classes=2,
                              trials=None):
    """Build and save the predictor artifact for the extension modes —
    always the standard schema (inducing/coeffs/chol_km/r_mat) so cmd_test
    and downstream tooling serve every mode through the same algebra."""
    import jax
    import jax.numpy as jnp

    from .io.checkpoint import ModelArtifact, save_model
    fam = _family(args)
    from .numerics.linalg import (
        cholesky_upper,
        matmul,
        solve_tri,
    )

    p, z, s2, wp = result
    extra = {}
    if args.ordinal:
        # same collapse as the classifier: coeffs = U^-1 V'a and
        # r_mat = Rn U serve the latent posterior through the standard
        # predictors; cmd_test integrates the probit cells exactly
        from .models.ordinal import (
            _ord_parts,
            cutpoints_from_raw,
            ordinal_laplace_mode,
        )

        cut_raw = wp  # 4th result slot carries the mode state
        wp = None
        if args.block_size:
            # streaming state: V never materializes (the generic Laplace
            # core); vta = V'a and Rn come out of the epilogue sweep
            from .models.classify_stream import stream_laplace_parts
            from .models.ordinal import _ord_loglik

            cuts = cutpoints_from_raw(cut_raw)
            inducing, _, _, _, vta, rn, *_ = stream_laplace_parts(
                fam, p, z, X, (y,),
                parts=lambda f, lik, mb: _ord_parts(f, lik[0], cuts, mb),
                loglik=lambda f, lik: _ord_loglik(f, lik[0], cuts),
                block_size=args.block_size,
            )
            coeffs = solve_tri(inducing.chol_km, vta)
        else:
            f_hat, a, inducing, v, d, cuts = ordinal_laplace_mode(
                fam, p, z, X, y, cut_raw,
            )
            _, w = _ord_parts(
                f_hat, y, cuts, jnp.ones(y.shape, dtype=v.dtype)
            )
            w = jnp.maximum(w, 1e-12)
            d2inv = w / (1.0 + w * d)
            vs = v * jnp.sqrt(d2inv)[:, None]
            rn = cholesky_upper(
                jnp.eye(v.shape[1], dtype=v.dtype) + matmul(vs.T, vs),
                jitter=0.0,
            )
            coeffs = solve_tri(inducing.chol_km, matmul(v.T, a))
        r_mat = matmul(rn, inducing.chol_km)
        chol_km = inducing.chol_km
        sigma2 = 0.0
        extra["ordinal"] = np.asarray(n_classes)
        extra["cutpoints"] = np.asarray(cuts)
    elif args.student_t is not None:
        # the converged robust posterior IS a heteroskedastic-noise FITC
        # posterior: the standard (coeffs, chol_km, r_mat) serve it
        # exactly; artifact sigma2 carries the moment-matched t noise
        # variance so the default test path needs no special casing
        from .models.fitc import calc_model, calc_trained
        from .models.robust import t_em_sweeps

        nu = float(args.student_t)
        lam, _ = t_em_sweeps(fam, p, z, s2, X, y, nu=nu, sweeps=10)
        model = calc_model(fam, p, X, z, s2 / lam)
        trained = calc_trained(model, y)
        coeffs = trained.coeffs
        chol_km = model.inducing.chol_km
        r_mat = model.r_mat
        z = model.inducing.z
        sigma2 = float(s2) * nu / (nu - 2.0)
        extra["student_t"] = np.asarray(nu)
        extra["t_scale"] = np.asarray(float(s2))
    elif args.poisson:
        # same collapse as the classifier: coeffs = U^-1 V'a and
        # r_mat = Rn U serve the latent log-rate posterior through the
        # standard predictors; cmd_test applies the lognormal moments
        from .models.poisson import _pois_loglik, _rate_w, poisson_laplace_mode

        if args.block_size:
            # streaming state: V never materializes (the generic Laplace
            # core); vta = V'a and Rn come out of the epilogue sweep
            from .models.classify_stream import stream_laplace_parts

            le = jnp.zeros_like(y)

            def _pois_parts(f, lik, mb):
                w = _rate_w(f, lik[1], mb)
                return mb * (lik[0] - w), w

            inducing, _, _, _, vta, rn, *_ = stream_laplace_parts(
                fam, p, z, X, (y, le),
                parts=_pois_parts,
                loglik=lambda f, lik: _pois_loglik(f, lik[0], lik[1]),
                block_size=args.block_size,
            )
            coeffs = solve_tri(inducing.chol_km, vta)
        else:
            f_hat, a, inducing, v, d = poisson_laplace_mode(fam, p, z, X, y)
            w = jnp.maximum(
                _rate_w(f_hat, jnp.zeros_like(y), jnp.ones_like(y)), 1e-12
            )
            d2inv = w / (1.0 + w * d)
            vs = v * jnp.sqrt(d2inv)[:, None]
            rn = cholesky_upper(
                jnp.eye(v.shape[1], dtype=v.dtype) + matmul(vs.T, vs),
                jitter=0.0,
            )
            coeffs = solve_tri(inducing.chol_km, matmul(v.T, a))
        r_mat = matmul(rn, inducing.chol_km)
        chol_km = inducing.chol_km
        sigma2 = 0.0
        extra["poisson"] = np.asarray(1)
    elif args.binomial:
        # same collapse as the binary classifier, with the binomial W at the
        # mode; the served class-probability squash is identical (MacKay
        # probit on the latent moments), so the artifact is a classify
        # artifact with a provenance marker
        from .models.binomial import (
            _bin_loglik,
            _bin_parts,
            binomial_laplace_mode,
        )

        if args.block_size:
            # streaming state: V never materializes (the generic Laplace
            # core); vta = V'a and Rn come out of the epilogue sweep
            from .models.classify_stream import stream_laplace_parts

            inducing, _, _, _, vta, rn, *_ = stream_laplace_parts(
                fam, p, z, X, (y, trials),
                parts=lambda f, lik, mb: _bin_parts(f, lik[0], lik[1], mb),
                loglik=lambda f, lik: _bin_loglik(f, lik[0], lik[1]),
                block_size=args.block_size,
            )
            coeffs = solve_tri(inducing.chol_km, vta)
        else:
            f_hat, a, inducing, v, d = binomial_laplace_mode(
                fam, p, z, X, y, trials,
            )
            _, w = _bin_parts(f_hat, y, trials, jnp.ones_like(y))
            w = jnp.maximum(w, 1e-12)
            d2inv = w / (1.0 + w * d)
            vs = v * jnp.sqrt(d2inv)[:, None]
            rn = cholesky_upper(
                jnp.eye(v.shape[1], dtype=v.dtype) + matmul(vs.T, vs),
                jitter=0.0,
            )
            coeffs = solve_tri(inducing.chol_km, matmul(v.T, a))
        r_mat = matmul(rn, inducing.chol_km)
        chol_km = inducing.chol_km
        sigma2 = 0.0
        extra["classify"] = np.asarray(2)  # served by the MacKay squash
        extra["binomial"] = np.asarray(1)
    elif args.negbin is not None:
        # same collapse as the Poisson artifact, with the NB W at the mode;
        # the learned dispersion rides in the extras so cmd_test can apply
        # the NB law of total variance (models/negbin.py docstring)
        from .models.negbin import _nb_loglik, _nb_parts, negbin_laplace_mode

        r_disp = jnp.asarray(s2)  # 3rd result slot carries the dispersion
        if args.block_size:
            # streaming state: V never materializes (the generic Laplace
            # core); vta = V'a and Rn come out of the epilogue sweep
            from .models.classify_stream import stream_laplace_parts

            le = jnp.zeros_like(y)
            inducing, _, _, _, vta, rn, *_ = stream_laplace_parts(
                fam, p, z, X, (y, le),
                parts=lambda f, lik, mb: _nb_parts(f, lik[0], r_disp,
                                                   lik[1], mb),
                loglik=lambda f, lik: _nb_loglik(f, lik[0], r_disp, lik[1]),
                block_size=args.block_size,
            )
            coeffs = solve_tri(inducing.chol_km, vta)
        else:
            f_hat, a, inducing, v, d = negbin_laplace_mode(
                fam, p, z, X, y, r_disp,
            )
            _, w = _nb_parts(f_hat, y, r_disp, jnp.zeros_like(y),
                             jnp.ones_like(y))
            w = jnp.maximum(w, 1e-12)
            d2inv = w / (1.0 + w * d)
            vs = v * jnp.sqrt(d2inv)[:, None]
            rn = cholesky_upper(
                jnp.eye(v.shape[1], dtype=v.dtype) + matmul(vs.T, vs),
                jitter=0.0,
            )
            coeffs = solve_tri(inducing.chol_km, matmul(v.T, a))
        r_mat = matmul(rn, inducing.chol_km)
        chol_km = inducing.chol_km
        sigma2 = 0.0
        extra["negbin"] = np.asarray(float(r_disp))
    elif args.classify and n_classes > 2:
        # softmax Laplace: the persistable m-space state (coeffs (m, C) in
        # the standard slot; per-class quadratic forms in the extras) —
        # every n-sized object is reduced away before saving
        if args.block_size:
            # streaming state: V never materializes (the Grams-only
            # F_c = diag(q_c) V M_c route, classify_multi_stream.py)
            from .models.classify_multi_stream import (
                stream_multiclass_state as multiclass_posterior_state,
            )

            inducing, coeffs, a_tilde, b_tilde = multiclass_posterior_state(
                fam, p, z, X, y, n_classes, block_size=args.block_size,
            )
        else:
            from .models.classify_multi import multiclass_posterior_state

            inducing, coeffs, a_tilde, b_tilde = multiclass_posterior_state(
                fam, p, z, X, y, n_classes,
            )
        chol_km = inducing.chol_km
        r_mat = chol_km  # unused by the multi-class test path
        z = inducing.z
        sigma2 = 0.0
        extra["classify"] = np.asarray(n_classes)
        extra["mc_a_tilde"] = np.asarray(a_tilde)
        extra["mc_b_tilde"] = np.asarray(b_tilde)
    elif args.classify and args.approx == "ep":
        # EP posterior collapses onto the standard predictor algebra
        # exactly like Laplace (k*'Pk* = v*(I - (I+W)^-1)v*'); only the
        # test-time squash differs — the "ep" extra selects the exact
        # probit predictive in cmd_test
        from .models.classify_ep import ep_posterior_state

        inducing, coeffs, rn = ep_posterior_state(fam, p, z, X, y)
        r_mat = matmul(rn, inducing.chol_km)
        chol_km = inducing.chol_km
        z = inducing.z
        sigma2 = 0.0
        extra["classify"] = np.asarray(2)
        extra["ep"] = np.asarray(1)
    elif args.classify and args.block_size:
        # streaming state: V never materializes (classify_stream.py);
        # vta = V'a and Rn come out of the epilogue sweep directly
        from .models.classify_stream import stream_classify_parts

        inducing, _, _, _, vta, rn, *_ = stream_classify_parts(
            fam, p, z, X, y, block_size=args.block_size,
        )
        coeffs = solve_tri(inducing.chol_km, vta)
        r_mat = matmul(rn, inducing.chol_km)
        chol_km = inducing.chol_km
        sigma2 = 0.0
        extra["classify"] = np.asarray(2)
    elif args.classify:
        from .models.classify import laplace_mode

        f_hat, a, inducing, v, d = laplace_mode(fam, p, z, X, y)
        pi = jax.nn.sigmoid(f_hat)
        w = jnp.maximum(pi * (1.0 - pi), 1e-12)
        d2inv = w / (1.0 + w * d)
        vs = v * jnp.sqrt(d2inv)[:, None]
        rn = cholesky_upper(
            jnp.eye(v.shape[1], dtype=v.dtype) + matmul(vs.T, vs),
            jitter=0.0,
        )
        # mu* = K*m [U^-1 V'a]; var* = k** - rowsq(K*m U^-1)
        #       + rowsq(K*m (Rn U)^-1): the standard predictor shapes
        coeffs = solve_tri(inducing.chol_km, matmul(v.T, a))
        r_mat = matmul(rn, inducing.chol_km)
        chol_km = inducing.chol_km
        sigma2 = 0.0
        extra["classify"] = np.asarray(2)  # the number of classes
    elif wp is not None:  # warped
        from .models.streaming import streaming_trained
        from .models.warped import warp

        t = warp(wp, y)
        trained = streaming_trained(
            fam, p, z, s2, X, t, variational=True, block_size=block_size,
        )
        coeffs = trained.coeffs
        chol_km = trained.model.inducing.chol_km
        r_mat = trained.model.r_mat
        z = trained.model.inducing.z
        sigma2 = float(s2)
        extra.update(
            warp_log_a=np.asarray(wp.log_a),
            warp_log_b=np.asarray(wp.log_b),
            warp_c=np.asarray(wp.c),
        )
    else:  # PITC
        from .models.pitc import pitc_coeffs

        inducing, r_mat, coeffs = pitc_coeffs(
            fam, p, z, s2, X, y, block_size=args.pitc_block,
        )
        chol_km = inducing.chol_km
        z = inducing.z
        sigma2 = float(s2)
        extra["pitc_block"] = np.asarray(args.pitc_block)

    _report_coregionalization(args, p)
    art = ModelArtifact(
        family_name=fam.name,
        kernel_params=p,
        inducing=np.asarray(z),
        coeffs=np.asarray(coeffs),
        chol_km=np.asarray(chol_km),
        r_mat=np.asarray(r_mat),
        sigma2=sigma2,
        target_mean=target_mean,
        input_means=input_means,
        input_stddevs=input_stddevs,
    )
    save_model(args.model, art, extra_arrays=extra)


def cmd_test(args) -> int:
    import jax.numpy as jnp

    from .io.checkpoint import load_model
    from .models.predict import (
        CoVariancePredictor,
        MeanPredictor,
        predict_means,
        predict_variances,
    )

    art, extra = load_model(args.model)
    family = art.family
    data = read_samples(sys.stdin)
    big_dim = art.input_means.shape[0]
    if data.shape[1] != big_dim:
        raise SystemExit(
            f"incompatible dimension of inputs ({data.shape[1]}), expected "
            f"{big_dim}"
        )
    inputs = (data - art.input_means) / art.input_stddevs
    X = jnp.asarray(inputs)
    params = art.kernel_params

    mp = MeanPredictor(z=jnp.asarray(art.inducing), coeffs=jnp.asarray(art.coeffs))

    if "poisson" in extra:
        # Poisson artifact: latent log-rate moments through the standard
        # predictors, lognormal rate moments at test points
        cvp = CoVariancePredictor(
            z=jnp.asarray(art.inducing),
            chol_km=jnp.asarray(art.chol_km),
            r_mat=jnp.asarray(art.r_mat),
        )
        mu = np.asarray(predict_means(family, params, mp, X))
        var = np.maximum(np.asarray(
            predict_variances(family, params, cvp, X, 0.0, predictive=False)
        ), 0.0)
        rate = np.exp(mu + 0.5 * var)
        rate_sd = np.sqrt(np.maximum(
            (np.exp(var) - 1.0) * np.exp(2.0 * mu + var), 0.0
        ))
        for r_i, s_i in zip(rate, rate_sd):
            if args.with_stddev:
                print(f"{r_i:f},{s_i:f}")
            else:
                print(f"{r_i:f}")
        return 0

    if "negbin" in extra:
        # NB artifact: latent log-mean moments through the standard
        # predictors, then the NB law of total variance with the LEARNED
        # dispersion (models/negbin.py docstring): E[y*] = m1,
        # Var[y*] = m1 + (1 + 1/r) m2 - m1^2 at unit exposure
        r_disp = float(extra["negbin"])
        cvp = CoVariancePredictor(
            z=jnp.asarray(art.inducing),
            chol_km=jnp.asarray(art.chol_km),
            r_mat=jnp.asarray(art.r_mat),
        )
        mu = np.asarray(predict_means(family, params, mp, X))
        var = np.maximum(np.asarray(
            predict_variances(family, params, cvp, X, 0.0, predictive=False)
        ), 0.0)
        m1 = np.exp(mu + 0.5 * var)
        m2 = np.exp(2.0 * mu + 2.0 * var)
        count_sd = np.sqrt(np.maximum(
            m1 + (1.0 + 1.0 / r_disp) * m2 - m1 * m1, 0.0
        ))
        for m_i, s_i in zip(m1, count_sd):
            if args.with_stddev:
                print(f"{m_i:f},{s_i:f}")
            else:
                print(f"{m_i:f}")
        return 0

    if "ordinal" in extra:
        # ordinal artifact: latent (mu, var) through the standard
        # predictors, then the EXACT Gaussian integral of each probit
        # cell (models/ordinal.py ordinal_predict's formula); one
        # probability column per category, -with-stddev appends the
        # latent stddev
        from scipy.stats import norm as _norm

        cvp = CoVariancePredictor(
            z=jnp.asarray(art.inducing),
            chol_km=jnp.asarray(art.chol_km),
            r_mat=jnp.asarray(art.r_mat),
        )
        mu = np.asarray(predict_means(family, params, mp, X))
        var = np.maximum(np.asarray(
            predict_variances(family, params, cvp, X, 0.0, predictive=False)
        ), 1e-12)
        cuts = np.asarray(extra["cutpoints"])
        scale = 1.0 / np.sqrt(1.0 + var)
        cdf = _norm.cdf((cuts[None, :] - mu[:, None]) * scale[:, None])
        upper = np.concatenate([cdf, np.ones((len(mu), 1))], axis=1)
        lower = np.concatenate([np.zeros((len(mu), 1)), cdf], axis=1)
        probs = np.maximum(upper - lower, 0.0)
        for p_row, v_i in zip(probs, var):
            cols = [f"{v:f}" for v in p_row]
            if args.with_stddev:
                cols.append(f"{math.sqrt(v_i):f}")
            print(",".join(cols))
        return 0

    if "classify" in extra and int(extra["classify"]) > 2:
        # softmax Laplace artifact: joint C-variate latent Gaussian per
        # point from the persisted m-space state, MC-softmax class
        # probabilities (one column per class; -with-stddev appends the
        # per-class latent stddevs).
        from .models.classify_multi import multiclass_predict_from_state

        probs, _, sigma = multiclass_predict_from_state(
            family, params, jnp.asarray(art.inducing),
            jnp.asarray(art.coeffs),
            jnp.asarray(extra["mc_a_tilde"]),
            jnp.asarray(extra["mc_b_tilde"]),
            X, n_samples=2048,
        )
        probs = np.asarray(probs)
        sd = np.sqrt(np.maximum(
            np.diagonal(np.asarray(sigma), axis1=1, axis2=2), 0.0
        ))
        for p_row, s_row in zip(probs, sd):
            cols = [f"{v:f}" for v in p_row]
            if args.with_stddev:
                cols += [f"{v:f}" for v in s_row]
            print(",".join(cols))
        return 0

    if "classify" in extra:
        # classifier artifact: latent mean/var through the standard
        # predictors (r_mat = Rn U collapses the posterior onto them),
        # then the class-probability squash — MacKay's probit
        # approximation for the logit/Laplace model, the EXACT probit
        # predictive Phi(mu/sqrt(1+var)) for EP
        cvp = CoVariancePredictor(
            z=jnp.asarray(art.inducing),
            chol_km=jnp.asarray(art.chol_km),
            r_mat=jnp.asarray(art.r_mat),
        )
        mu = np.asarray(predict_means(family, params, mp, X))
        var = np.asarray(
            predict_variances(family, params, cvp, X, 0.0, predictive=False)
        )
        var = np.maximum(var, 0.0)
        if "ep" in extra:
            from scipy.stats import norm as _norm

            prob = _norm.cdf(mu / np.sqrt(1.0 + var))
        else:
            prob = 1.0 / (1.0 + np.exp(-mu / np.sqrt(1.0 + np.pi * var / 8.0)))
        for p_i, v_i in zip(prob, var):
            if args.with_stddev:
                print(f"{p_i:f},{math.sqrt(v_i):f}")
            else:
                print(f"{p_i:f}")
        return 0

    if "exact_cg" in extra:
        # Iterative exact artifact (models/iterative.py): the training set
        # is the "inducing" set, coeffs = alpha; there is NO dense factor —
        # -with-stddev re-solves k*-columns by Nystrom-preconditioned CG
        # against the stored raw inputs (exact variances, not the FITC
        # approximation; tol 1e-4 on the residual).
        import jax

        from .models.iterative import (
            IterTrained,
            nystrom_precond,
            predict_variances_iter,
        )

        means = np.asarray(predict_means(family, params, mp, X)) \
            + art.target_mean
        if args.with_stddev:
            x_train = jnp.asarray(extra["cg_x"])
            anchors = int(extra["cg_anchors"])
            tr = IterTrained(
                z=jnp.asarray(art.inducing),
                sigma2=jnp.asarray(art.sigma2),
                alpha=jnp.asarray(art.coeffs),
                iters=jnp.asarray(0),
                relres=jnp.asarray(0.0),
            )
            idx = jax.random.choice(
                jax.random.PRNGKey(0), x_train.shape[0],
                (min(anchors, x_train.shape[0]),), replace=False,
            )
            pre = nystrom_precond(family, params, x_train, art.sigma2,
                                  x_train[idx])
            variances, _ = predict_variances_iter(
                family, params, tr, x_train, X,
                predictive=args.predictive, precond=pre,
            )
            variances = np.asarray(variances)
            for mean, var in zip(means, variances):
                print(f"{mean:f},{math.sqrt(max(var, 0.0)):f}")
        else:
            for mean in means:
                print(f"{mean:f}")
        return 0

    if "exact" in extra:
        # Exact dense-GP artifact (models/exact.py): the training set IS
        # the "inducing" set, coeffs = alpha = A^-1 y, chol_km slot holds
        # chol(K + sigma2 I)
        from .models.exact import (
            ExactModel,
            ExactTrained,
            predict_variances_exact,
        )

        means = np.asarray(predict_means(family, params, mp, X)) \
            + art.target_mean
        if args.with_stddev:
            tr = ExactTrained(
                model=ExactModel(
                    z=jnp.asarray(art.inducing),
                    sigma2=jnp.asarray(art.sigma2),
                    chol_a=jnp.asarray(art.chol_km),
                ),
                y=jnp.zeros(art.inducing.shape[0]),
                alpha=jnp.asarray(art.coeffs),
                l=jnp.asarray(0.0),
            )
            variances = np.asarray(predict_variances_exact(
                family, params, tr, X, predictive=args.predictive
            ))
            for mean, var in zip(means, variances):
                print(f"{mean:f},{math.sqrt(max(var, 0.0)):f}")
        else:
            for mean in means:
                print(f"{mean:f}")
        return 0

    if "warp_log_a" in extra:
        # Warped artifact: the latent posterior is Gaussian in t-space;
        # observation-space moments integrate the inverse warp by
        # Gauss-Hermite quadrature (predictive t-variance — the observed
        # y carries the noise through the warp).
        from .models.warped import WarpParams, warped_predict_moments

        wp = WarpParams(
            log_a=jnp.asarray(extra["warp_log_a"]),
            log_b=jnp.asarray(extra["warp_log_b"]),
            c=jnp.asarray(extra["warp_c"]),
        )
        cvp = CoVariancePredictor(
            z=jnp.asarray(art.inducing),
            chol_km=jnp.asarray(art.chol_km),
            r_mat=jnp.asarray(art.r_mat),
        )
        mu = predict_means(family, params, mp, X)
        var = predict_variances(
            family, params, cvp, X, art.sigma2, predictive=True
        )
        mean_y, var_y = warped_predict_moments(wp, mu, jnp.maximum(var, 0.0))
        mean_y = np.asarray(mean_y) + art.target_mean
        var_y = np.asarray(var_y)
        for m_i, v_i in zip(mean_y, var_y):
            if args.with_stddev:
                print(f"{m_i:f},{math.sqrt(max(v_i, 0.0)):f}")
            else:
                print(f"{m_i:f}")
        return 0

    means = np.asarray(predict_means(family, params, mp, X)) + art.target_mean

    if args.with_stddev:
        cvp = CoVariancePredictor(
            z=jnp.asarray(art.inducing),
            chol_km=jnp.asarray(art.chol_km),
            r_mat=jnp.asarray(art.r_mat),
        )
        variances = np.asarray(
            predict_variances(
                family, params, cvp, X, art.sigma2, predictive=args.predictive
            )
        )
        for mean, var in zip(means, variances):
            print(f"{mean:f},{math.sqrt(max(var, 0.0)):f}")
    else:
        for mean in means:
            print(f"{mean:f}")
    return 0


def _configure_jax():
    """The CLI reproduces the reference's numerics, which are f64 LAPACK —
    run in f64 (native on the CPU and the GPU).  GPR_TPU_PLATFORM overrides
    the backend (e.g. ``cpu`` keeps a run off the GPU); the persistent
    compile cache is turned on (utils.use_compile_cache)."""
    import os

    import jax

    from .utils import use_compile_cache

    platform = os.environ.get("GPR_TPU_PLATFORM")
    if platform:
        jax.config.update("jax_platforms", platform)
    jax.config.update("jax_enable_x64", True)
    use_compile_cache()


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    _configure_jax()
    try:
        if args.cmd == "train":
            return cmd_train(args)
        return cmd_test(args)
    except FileNotFoundError as e:
        raise SystemExit(f"cannot open model file: {e.filename}")
    except FloatingPointError as e:
        raise SystemExit(
            f"training failed: {e} (check inputs for NaN/inf values)"
        )
    except BrokenPipeError:
        # downstream closed the pipe (e.g. | head) — exit quietly, the
        # POSIX-tool convention
        import os

        try:
            sys.stdout.close()
        except Exception:  # noqa: BLE001
            pass
        os._exit(0)


if __name__ == "__main__":
    raise SystemExit(main())

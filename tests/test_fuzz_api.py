"""Seeded API fuzz in CI (VERDICT.md round-2 #6 at commit b587de6).

A bounded version of probes/fuzz_api.py: each case drives one random
(family, options, shapes, factorization, trainer, predictor, sampler)
workflow end to end through the public API — the same
executables-as-tests strategy the reference uses (test/dune:1-4), but
randomized.  Seeded, one case per kernel family plus extra random draws,
small n so the whole set stays well under a minute of compute.

The full 40-case sweep stays in probes/ for manual runs.
"""

import importlib.util
import os

import numpy as np
import pytest

# whole-module slow mark: each case compiles a full random workflow —
# keep for CI/full runs, skip in the quick inner loop
# (python -m pytest tests/ -m 'not slow')
pytestmark = pytest.mark.slow


_PROBE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "probes", "fuzz_api.py",
)
_spec = importlib.util.spec_from_file_location("fuzz_api_probe", _PROBE)
fuzz = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(fuzz)


@pytest.mark.parametrize("fam", fuzz.FAMILIES, ids=lambda f: f.name)
def test_fuzz_each_family(fam):
    """One randomized end-to-end workflow per kernel family."""
    rng = np.random.default_rng(20260817)
    desc = fuzz.one(rng, 0, fam=fam, n_max=80)
    assert desc[0] == fam.name


@pytest.mark.parametrize("seed", [1, 2, 3, 4])
def test_fuzz_random_draws(seed):
    """Fully random draws (family included) at distinct seeds."""
    rng = np.random.default_rng(1000 + seed)
    fuzz.one(rng, seed, n_max=80)


@pytest.mark.parametrize(
    "variant",
    [1, 2, 3, 4, 5, 6, 7, 8, 9, 10],
    ids=["pitc", "warped", "classify", "classify-ep", "multiclass",
         "poisson", "negbin", "binomial", "ordinal", "student-t"],
)
def test_fuzz_model_variants(variant):
    """Each round-3 model family forced, on a random kernel-family draw."""
    rng = np.random.default_rng(77 + variant)
    desc = fuzz.one(rng, 0, n_max=60, variant=variant)
    assert desc[-1] == variant

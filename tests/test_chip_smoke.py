"""chip_smoke.py rehearsed on the CPU at tiny sizes, plus its helpers.

Each phase function runs here with its own reference and tolerance, the
same checks it applies on the GPU at the headline shape.  The ``gpu``
test runs the whole script and skips where JAX finds no GPU (decided in
a fixture, never at import).
"""

import importlib.util
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


smoke = _load("chip_smoke")
SMALL = dict(n=4096, d=8, m=24, block=1024)


@pytest.mark.parametrize("phase, kwargs", [
    ("phase_precision", dict(size=128)),
    ("phase_headline", dict(SMALL, iters=2)),
    ("phase_flagship", dict(SMALL, iters=2)),
    ("phase_training", dict(SMALL, train_iters=2, fit_iters=4)),
    ("phase_predict", dict(SMALL, iters=2)),
    ("phase_cli", dict(n=1500, d=2, n_test=200, n_inducing=12,
                       max_iter=30)),
    ("phase_two_sum", dict(length=4096, lanes=32)),
], ids=lambda v: v if isinstance(v, str) else "")
def test_phase_rehearsal(phase, kwargs, tmp_path):
    """Every single-card phase passes its own checks at a tiny size."""
    if phase == "phase_cli":
        kwargs = dict(kwargs, out_dir=str(tmp_path))
    x64_before = jax.config.jax_enable_x64
    getattr(smoke, phase)(**kwargs)
    if phase != "phase_cli":  # the CLI sets x64 for its own f64 numerics
        assert jax.config.jax_enable_x64 == x64_before


def test_phase_four_cards_on_virtual_devices():
    """The --four-cards path on four of conftest's virtual CPU devices."""
    smoke.phase_four_cards(n=4096, d=8, m=24, block=512, n_dev=4,
                           fit_iters=2)


def test_main_without_gpu_exits_nonzero(capsys):
    with pytest.raises(SystemExit) as exc:
        smoke.main([])
    assert "no GPU" in str(exc.value.code)
    assert '"ok"' not in capsys.readouterr().out


def test_contract_line_names_the_device():
    dev = types.SimpleNamespace(platform="gpu", device_kind="NVIDIA H100")
    line = smoke.contract_line(dev, 4)
    assert line == ('{"ok": true, "device": {"platform": "gpu", '
                    '"kind": "NVIDIA H100", "count": 4}}')


def test_gemm_lowering_reads_gpu_hlo():
    text = ('custom-call(%a, %b), custom_call_target="__cublas$gemm", '
            'backend_config={"gemm_backend_config":{"precision_config":'
            '{"operand_precision":["DEFAULT","DEFAULT"],'
            '"algorithm":"ALG_DOT_TF32_TF32_F32"}}}')
    assert smoke.gemm_lowering(text) == (
        '__cublas$gemm, ALG_DOT_TF32_TF32_F32, "DEFAULT","DEFAULT"')
    assert smoke.gemm_lowering("%d = f32[2,2] dot(%a, %b)") == "plain dot"


def test_rel_is_norm_relative_over_pytrees():
    a = {"x": np.array([3.0, 0.0]), "y": 4.0}
    b = {"x": np.array([3.0, 0.0]), "y": 5.0}
    assert smoke.rel(a, b) == pytest.approx(1.0 / np.sqrt(34.0))


@pytest.mark.parametrize("env_set", [True, False], ids=["env", "default"])
def test_use_compile_cache(env_set, monkeypatch, tmp_path):
    from gpr_tpu.utils import CHECKOUT_ROOT, use_compile_cache

    before = jax.config.jax_compilation_cache_dir
    try:
        if env_set:
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
            jax.config.update("jax_compilation_cache_dir", "untouched")
            assert use_compile_cache() == str(tmp_path)
            assert jax.config.jax_compilation_cache_dir == "untouched"
        else:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
            want = os.path.join(CHECKOUT_ROOT, ".jax_cache")
            assert CHECKOUT_ROOT == REPO
            assert use_compile_cache() == want
            assert jax.config.jax_compilation_cache_dir == want
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_two_sum_is_error_free_in_f32():
    """(hi, lo) += x keeps the add's rounding error in lo exactly."""
    from gpr_tpu.models.stream_grad import _two_sum

    rng = np.random.default_rng(0)
    hi = jnp.asarray(rng.uniform(1e3, 1e4, 64), jnp.float32)
    x = jnp.asarray(rng.uniform(0.0, 1e-3, 64), jnp.float32)
    s, err = jax.jit(_two_sum)(hi, jnp.zeros_like(hi), x)
    exact = np.asarray(hi, np.float64) + np.asarray(x, np.float64)
    assert s.dtype == jnp.float32
    np.testing.assert_array_equal(
        np.asarray(s, np.float64) + np.asarray(err, np.float64), exact)
    assert np.any(np.asarray(err) != 0.0)


@pytest.fixture
def gpu():
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX's first device is {dev.platform!r}")
    return dev


@pytest.mark.gpu
def test_chip_smoke_on_gpu(gpu, capsys, tmp_path):
    """The whole script on the card: every phase at the headline shape."""
    assert smoke.main(["--out", str(tmp_path)]) == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert '"platform": "gpu"' in last

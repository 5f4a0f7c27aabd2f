"""bench.py's device handling, on the CPU: it refuses to measure here, and
its peak table knows only the devices it names."""

import importlib.util
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "bench", os.path.join(REPO, "bench.py"))
bench = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(bench)


def test_main_without_gpu_exits_nonzero(capsys):
    with pytest.raises(SystemExit) as exc:
        bench.main()
    assert "no GPU" in str(exc.value.code)
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("kind", ["Tesla V100-SXM2-16GB",
                                  "NVIDIA A100-SXM4-80GB", "cpu"])
def test_unknown_device_kind_raises(kind):
    with pytest.raises(KeyError, match="no published peaks"):
        bench.peaks_for(kind)


def test_gemm_share_is_against_the_tf32_peak():
    peaks = bench.peaks_for("NVIDIA H100 80GB HBM3")
    # 6 GEMMs of 2 n m^2 flops in 1 s at n=1e6, m=300: 1.08 TF/s useful
    line = bench.gemm_share(1.0, 1_000_000, 300, peaks, "H100, 700.00 W")
    assert "useful 1.1 TF/s = 0.2% of the 495 TF/s TF32 peak" in line
    assert "H100, 700.00 W" in line


def test_failed_leg_is_recorded_and_the_run_goes_on(capsys):
    failed = []
    with bench.leg("broken", failed):
        raise RuntimeError("boom")
    with bench.leg("fine", failed):
        pass
    assert failed == ["broken"]
    err = capsys.readouterr().err
    assert "broken: FAILED RuntimeError: boom" in err
    assert "Traceback" in err

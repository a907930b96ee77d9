"""The harness on the card, at the reduced twin's size (skipped without
one)."""
import pytest
import torch

from hbm_bench import run as R
from hbm_bench.tests.twins import yi_mix, yi_twin


@pytest.mark.cuda
def test_twin_run_on_the_card_is_correct_and_launches_k4():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and the CUDA toolkit")
    from repro_torch.kernels import _build
    before = _build.launch_counts()["paged_decode"]
    cfg = yi_twin()
    out = R.run_cell(cfg, yi_mix(), seed=2**31 + 99, seconds=3.0,
                     trace=True, device="cuda",
                     metric_names=["k4_roofline", "device_idle_share"],
                     checks=cfg["checks"])
    assert out["correct"], out["checks"]
    assert _build.launch_counts()["paged_decode"] > before
    assert out["busy_s"] > 0 and "device_idle_share" in out["metrics"]
    ctl = R.run_cell(cfg, yi_mix(), seed=2**31 + 99, seconds=3.0,
                     trace=False, device="cuda", metric_names=[],
                     checks=cfg["checks"], control=True)
    assert not ctl["correct"], ctl["checks"]

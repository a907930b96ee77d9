"""PyTorch/CUDA port of the HBM undervolting fault-injection system.

Mirrors :mod:`repro` module for module.  Plain tensor code is PyTorch;
the injection and decode-attention hot paths are hand-written CUDA
kernels for Hopper (``sm_90a``) under :mod:`repro_torch.kernels`, each
with a plain PyTorch version that CPU tensors take.
"""
import torch


def resolve_device(device) -> torch.device:
    """``torch.device`` for an entry point's ``device=`` argument.

    Entry points default to ``"cuda"``; without a card they raise rather
    than fall back to the CPU, so a measurement can never silently run
    on the host.  Callers pass ``device="cpu"`` to run the plain path.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch entry point asked for device='cuda' but no CUDA "
            "device is available; pass device='cpu' to run the plain "
            "PyTorch path on the host")
    return dev

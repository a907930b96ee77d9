"""Public wrapper of the RG-LRU scan kernel K8: dispatch (port of
:mod:`repro.kernels.rglru.ops`)."""
from __future__ import annotations

from repro_torch.kernels.rglru.ref import rglru_scan_ref
from repro_torch.kernels.rglru.rglru import rglru_scan_fwd


def rglru_scan(a, b, h0, *, use_ref: bool = False):
    """Seeded linear recurrence h_t = a_t h_{t-1} + b_t over axis 1.

    a, b: (B, S, R); h0: (B, R).  Returns (h_seq f32, h_last f32).  CPU
    tensors (and ``use_ref``) take the plain version; CUDA tensors launch
    K8 once."""
    if use_ref or a.device.type == "cpu":
        return rglru_scan_ref(a, b, h0)
    return rglru_scan_fwd(a, b, h0)

"""Public wrappers of the RG-LRU scan kernel K8: dispatch (port of
:mod:`repro.kernels.rglru.ops`)."""
from __future__ import annotations

from repro_torch.kernels.rglru.ref import (rglru_gated_scan_ref,
                                           rglru_scan_ref)
from repro_torch.kernels.rglru.rglru import (rglru_gated_scan_fwd,
                                             rglru_scan_fwd)


def rglru_scan(a, b, h0, *, use_ref: bool = False):
    """Seeded linear recurrence h_t = a_t h_{t-1} + b_t over axis 1.

    a, b: (B, S, R); h0: (B, R).  Returns (h_seq f32, h_last f32).  CPU
    tensors (and ``use_ref``) take the plain version; CUDA tensors launch
    K8 once."""
    if use_ref or a.device.type == "cpu":
        return rglru_scan_ref(a, b, h0)
    return rglru_scan_fwd(a, b, h0)


def rglru_gated_scan(r_g, i_g, y, lam, h0, *, h_last=None):
    """The RG-LRU over a sequence: a = exp(-8 softplus(lam) r_g),
    b = sqrt(max(1 - a^2, 1e-12)) (i_g y), then the scan from h0.

    r_g, i_g: (B, S, R) float32; y: (B, S, R); lam: (R,); h0: (B, R)
    float32.  Returns (h_seq f32, h_last f32); a given ``h_last`` (a
    contiguous (B, R) float32 tensor, h0 itself allowed) receives the last
    state.  CPU tensors take the gate math in plain torch, op by op, and
    the plain scan; CUDA tensors launch K8's gated variant once."""
    if r_g.device.type != "cpu":
        return rglru_gated_scan_fwd(r_g, i_g, y, lam, h0, h_last=h_last)
    h, last = rglru_gated_scan_ref(r_g, i_g, y, lam, h0)
    return (h, last) if h_last is None else (h, h_last.copy_(last))

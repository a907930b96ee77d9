"""K8: the RG-LRU linear-recurrence scan -- the CUDA kernel's wrapper.

Port of :mod:`repro.kernels.rglru.rglru`; the kernel
``csrc/rglru_scan.cu`` replaces ``rglru_pallas``.  Its source says what
bounds it on the H100 and how the design answers that.  One thread walks
one (batch, channel) in order, so the kernel needs none of the TPU
kernel's padding to whole chunks and batch tiles.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build


def rglru_scan_fwd(a, b, h0):
    """a, b: (B, S, R); h0: (B, R), on one CUDA device (cast to float32).
    Returns (h_seq (B, S, R), h_last (B, R)) float32.  One K8 launch."""
    if a.device.type != "cuda":
        raise ValueError(f"rglru_scan_fwd: K8 runs on a CUDA device, got "
                         f"{a.device}")
    bsz, s, r = a.shape
    if tuple(b.shape) != (bsz, s, r) or tuple(h0.shape) != (bsz, r):
        raise ValueError(f"K8 operands a {tuple(a.shape)}, b "
                         f"{tuple(b.shape)}, h0 {tuple(h0.shape)} do not "
                         "match (B, S, R) / (B, R)")
    a, b, h0 = (t.float().contiguous() for t in (a, b, h0))
    if b.device != a.device or h0.device != a.device:
        raise ValueError("K8 operands must share one device")
    out = torch.empty((bsz, s, r), dtype=torch.float32, device=a.device)
    h_last = torch.empty((bsz, r), dtype=torch.float32, device=a.device)
    fn = _build.kernel("rglru_scan")
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = fn(a.data_ptr(), b.data_ptr(), h0.data_ptr(), out.data_ptr(),
             h_last.data_ptr(), bsz, s, r, stream)
    _build.check("rglru_scan", err)
    return out, h_last

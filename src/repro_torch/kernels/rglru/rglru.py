"""K8: the RG-LRU linear-recurrence scan -- the CUDA kernel's wrapper.

Port of :mod:`repro.kernels.rglru.rglru`; the kernel
``csrc/rglru_scan.cu`` replaces ``rglru_pallas``.  Its source says what
bounds it on the H100 and how the design answers that.  It has two
variants behind one entry point, both counted under ``rglru_scan``:
``"scan"`` (the TPU kernel's counterpart, a and b given) and ``"gated"``
(the model's RG-LRU, its gate math fused in).  A block walks its channels
in rounds that :func:`scan_chunks` plans from the sequence length alone,
so the kernel needs none of the TPU kernel's padding to whole chunks and
batch tiles.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build

# The chunked walk's plan (mirrored in csrc/rglru_scan.cu): warps per
# block and steps per warp in a round; up to SERIAL_MAX_S steps one thread
# walks each channel.
CHUNK_WARPS, CHUNK_STEPS = 8, 8
SERIAL_MAX_S = 8
_VARIANT_IDS = {"scan": 0, "gated": 1}
_Y_BYTES = {torch.float32: 4, torch.bfloat16: 2}


def scan_chunks(s: int) -> Tuple[int, int]:
    """How K8 walks ``s`` steps: ``(warps, steps)``.  A block's round
    covers ``warps * steps`` consecutive steps, ``steps`` per warp: each
    warp walks its steps from zero, the block folds the warps' partials
    into the previous round's carry in warp order, and each warp walks its
    steps again from its carry.  ``(1, 1)`` (up to SERIAL_MAX_S steps) is
    the direct walk.  A function of ``s`` alone -- never of the batch, the
    width or the card -- so a row's bits do not depend on the batch it is
    launched in."""
    if s <= 0:
        raise ValueError(f"K8 needs at least one step, got {s}")
    return (1, 1) if s <= SERIAL_MAX_S else (CHUNK_WARPS, CHUNK_STEPS)


def _f32(t):
    return t if t.dtype == torch.float32 and t.is_contiguous() else (
        t.float().contiguous())


def _launch(variant, x0, x1, y, lam, h0, h_last):
    if x0.device.type != "cuda":
        raise ValueError(f"K8 runs on a CUDA device, got {x0.device}")
    bsz, s, r = x0.shape
    if tuple(x1.shape) != (bsz, s, r) or tuple(h0.shape) != (bsz, r):
        raise ValueError(f"K8 operands {tuple(x0.shape)}, "
                         f"{tuple(x1.shape)}, h0 {tuple(h0.shape)} do not "
                         "match (B, S, R) / (B, R)")
    x0, x1, h0 = _f32(x0), _f32(x1), _f32(h0)
    y_ptr = lam_ptr = y_bytes = 0
    if variant == "gated":
        if tuple(y.shape) != (bsz, s, r) or tuple(lam.shape) != (r,):
            raise ValueError(f"K8 gated: y {tuple(y.shape)}, lam "
                             f"{tuple(lam.shape)} do not match (B, S, R) / "
                             "(R,)")
        if y.dtype not in _Y_BYTES:
            raise TypeError(f"K8 gated takes bf16 or f32 y, got {y.dtype}")
        y, lam = y.contiguous(), _f32(lam)
        y_ptr, lam_ptr, y_bytes = y.data_ptr(), lam.data_ptr(), _Y_BYTES[
            y.dtype]
    dev = x0.device
    for t in (x1, h0) + ((y, lam) if variant == "gated" else ()):
        if t.device != dev:
            raise ValueError("K8 operands must share one device")
    out = torch.empty((bsz, s, r), dtype=torch.float32, device=dev)
    if h_last is None:
        h_last = torch.empty((bsz, r), dtype=torch.float32, device=dev)
    elif (tuple(h_last.shape) != (bsz, r) or h_last.dtype != torch.float32
          or h_last.device != dev or not h_last.is_contiguous()):
        raise ValueError("K8's h_last must be a contiguous (B, R) float32 "
                         "tensor on the operands' device")
    warps, steps = scan_chunks(s)
    fn = _build.kernel("rglru_scan")
    err = fn(x0.data_ptr(), x1.data_ptr(), y_ptr, lam_ptr, h0.data_ptr(),
             out.data_ptr(), h_last.data_ptr(), bsz, s, r, y_bytes,
             warps, steps, _VARIANT_IDS[variant],
             torch.cuda.current_stream(dev).cuda_stream)
    _build.check("rglru_scan", err, variant)
    return out, h_last


def rglru_scan_fwd(a, b, h0):
    """a, b: (B, S, R); h0: (B, R), on one CUDA device (cast to float32).
    Returns (h_seq (B, S, R), h_last (B, R)) float32.  One K8 launch of
    its "scan" variant."""
    return _launch("scan", a, b, None, None, h0, None)


def rglru_gated_scan_fwd(r_g, i_g, y, lam, h0, *, h_last=None):
    """The RG-LRU in one K8 launch of its "gated" variant: a = exp(-8
    softplus(lam) r_g), b = sqrt(max(1 - a^2, 1e-12)) (i_g y), then the
    scan from h0.  r_g, i_g: (B, S, R) float32; y: (B, S, R) bf16 or
    float32; lam: (R,); h0: (B, R) float32, all on one CUDA device.
    Returns (h_seq (B, S, R), h_last (B, R)) float32; ``h_last``, if given
    (a contiguous (B, R) float32 tensor, h0 itself allowed), is written in
    place and returned."""
    return _launch("gated", r_g, i_g, y, lam, h0, h_last)

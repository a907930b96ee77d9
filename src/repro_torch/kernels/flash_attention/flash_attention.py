"""K7: forward flash attention for prefill -- the CUDA kernel's wrapper.

Port of :mod:`repro.kernels.flash_attention.flash_attention`; the kernel
``csrc/flash_prefill.cu`` replaces ``flash_attention_pallas``.  Its
source says what bounds it on the H100 and how the design answers that.
The plain version is :func:`repro_torch.kernels.flash_attention.ref.
attention_ref`; :func:`repro_torch.kernels.flash_attention.ops.
flash_attention` pads the operands and picks between the two.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

# Query rows and keys per tile (the operands' sequence lengths must be
# multiples of these), and the widest head the kernel's registers hold.
BQ = 64
BKV = 64
MAX_HEAD_DIM = 256
_KERNEL_DTYPES = {torch.bfloat16: 2, torch.float32: 4}


def flash_attention_fwd(q, k, v, *, sk: int, causal: bool, window: int,
                        scale: float):
    """q: (B, H, SQ, D); k, v: (B, KH, SK, D), contiguous, on one CUDA
    device, of one dtype (bf16 or f32), SQ % BQ == SK % BKV == 0; keys at
    or past ``sk`` are masked.  Returns (B, H, SQ, D) in v's dtype.  One
    K7 launch."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_fwd: K7 runs on a CUDA device, "
                         f"got {q.device}")
    b, h, sq, d = q.shape
    bk, kh, skp, dk = k.shape
    if (bk, dk) != (b, d) or tuple(v.shape) != tuple(k.shape) or h % kh:
        raise ValueError(f"K7 operands q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not "
                         "match (B, H, SQ, D) / (B, KH, SK, D)")
    if sq % BQ or skp % BKV or not 0 < sk <= skp:
        raise ValueError(f"K7 needs SQ % {BQ} == SK % {BKV} == 0 and "
                         f"0 < sk <= SK, got SQ={sq}, SK={skp}, sk={sk}")
    if not 0 < d <= MAX_HEAD_DIM:
        raise ValueError(f"K7 takes head_dim up to {MAX_HEAD_DIM}, got {d}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"K7 takes bf16 or f32 q/k/v of one dtype, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    for t in (q, k, v):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError("K7 operands must be contiguous on one device")
        if t.data_ptr() % 16:
            raise ValueError("K7 operands must be 16-byte aligned")
    out = torch.empty((b, h, sq, d), dtype=v.dtype, device=q.device)
    fn = _build.kernel("flash_prefill")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h,
             kh, sq, skp, int(sk), d, int(causal), int(window), float(scale),
             _KERNEL_DTYPES[q.dtype], stream)
    _build.check("flash_prefill", err)
    return out

"""K7: forward flash attention for prefill -- the CUDA kernel's wrapper.

Port of :mod:`repro.kernels.flash_attention.flash_attention`; the kernel
``csrc/flash_prefill.cu`` replaces ``flash_attention_pallas``.  It has three
variants, picked here by :func:`pick_variant` and passed to the kernel's
entry point: ``"wgmma"`` (``csrc/flash_wgmma.cuh``, bf16 on the tensor
cores), ``"tf32x3"`` (``csrc/flash_tf32x3.cuh``, float32 on the TF32 tensor
cores, each product split in three) and ``"simt"`` (float32 CUDA cores,
every other shape).  The sources say what bounds each on the H100 and how
the design answers that.  The
plain version is :func:`repro_torch.kernels.flash_attention.ref.
attention_ref`; :func:`repro_torch.kernels.flash_attention.ops.
flash_attention` pads the operands to the variant's tiles and picks between
kernel and plain version.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import _build


class Tiles(NamedTuple):
    """A variant's tiles: query rows per block (SQ must be a multiple),
    keys per tile (SK must be a multiple), and query rows that share one
    band of key tiles (one warpgroup of the wgmma variant)."""
    bq: int
    bkv: int
    group_rows: int


TILES = {"simt": Tiles(64, 64, 64), "wgmma": Tiles(128, 64, 64),
         "tf32x3": Tiles(64, 32, 64)}
# the entry point's variant argument
_VARIANT_IDS = {"simt": 0, "wgmma": 1, "tf32x3": 2}
MAX_HEAD_DIM = 256
_KERNEL_DTYPES = {torch.bfloat16: 2, torch.float32: 4}


def pick_variant(dtype, d: int) -> str:
    """The K7 variant for operands of ``dtype`` and head_dim ``d``: the
    bf16 tensor-core variant for bf16 with d a multiple of 16 up to 256,
    the 3xTF32 tensor-core variant for float32 with d up to 256, the SIMT
    variant otherwise."""
    if dtype == torch.bfloat16 and d % 16 == 0 and 0 < d <= MAX_HEAD_DIM:
        return "wgmma"
    if dtype == torch.float32 and 0 < d <= MAX_HEAD_DIM:
        return "tf32x3"
    return "simt"


def key_band(r0: int, rows: int, sk: int, causal: bool, window: int,
             bkv: int):
    """Key tiles [lo, hi) that query rows [r0, r0 + rows) visit: none past
    sk, none after the last row under causal, none wholly before the first
    row's window (the kernels' ``key_band`` / band loop)."""
    hi = -(-sk // bkv)
    if causal:
        hi = min(hi, (r0 + rows - 1) // bkv + 1)
    lo = max(0, r0 - window + 1) // bkv if window > 0 else 0
    return lo, max(lo, hi)


def tile_needs_mask(r0: int, rows: int, k0: int, sk: int, causal: bool,
                    window: int, bkv: int) -> bool:
    """Whether some (row, key) of rows [r0, r0 + rows) x keys [k0, k0 +
    bkv) is masked; the wgmma variant masks only such tiles (the kernel's
    ``tile_needs_mask``)."""
    return ((causal and k0 + bkv - 1 > r0)
            or (window > 0 and r0 + rows - 1 - k0 >= window)
            or k0 + bkv > sk)


def band_pairs(sq: int, sk: int, causal: bool, window: int) -> int:
    """(query, key) pairs a masked attention of one head attends to:
    query i sees keys j < sk, j <= i (causal) with i - j < window
    (window > 0)."""
    total = 0
    for i in range(sq):
        hi = min(i, sk - 1) if causal else sk - 1
        lo = max(0, i - window + 1) if window > 0 else 0
        total += max(0, hi - lo + 1)
    return total


def flash_attention_fwd(q, k, v, *, sk: int, causal: bool, window: int,
                        scale: float, variant: str):
    """q: (B, H, SQ, D); k, v: (B, KH, SK, D), contiguous, on one CUDA
    device, of one dtype; SQ and SK multiples of the variant's tiles; keys
    at or past ``sk`` are masked.  ``variant``: "wgmma" or "tf32x3" (only
    where :func:`pick_variant` names it) or "simt" (any shape).  Returns
    (B, H, SQ, D) in v's dtype.  One K7 launch of ``variant``, counted
    under it."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_fwd: K7 runs on a CUDA device, "
                         f"got {q.device}")
    if variant not in TILES or (variant != "simt" and pick_variant(
            q.dtype, q.shape[-1]) != variant):
        raise ValueError(f"K7 variant {variant!r} does not take "
                         f"{q.dtype} at head_dim {q.shape[-1]}")
    b, h, sq, d = q.shape
    bk, kh, skp, dk = k.shape
    if (bk, dk) != (b, d) or tuple(v.shape) != tuple(k.shape) or h % kh:
        raise ValueError(f"K7 operands q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not "
                         "match (B, H, SQ, D) / (B, KH, SK, D)")
    tiles = TILES[variant]
    if sq % tiles.bq or skp % tiles.bkv or not 0 < sk <= skp:
        raise ValueError(f"K7 {variant} needs SQ % {tiles.bq} == SK % "
                         f"{tiles.bkv} == 0 and 0 < sk <= SK, got SQ={sq}, "
                         f"SK={skp}, sk={sk}")
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
             _KERNEL_DTYPES[q.dtype], _VARIANT_IDS[variant], stream)
    _build.check("flash_prefill", err, variant)
    return out

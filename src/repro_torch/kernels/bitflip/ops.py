"""dtype <-> uint32 word views and method dispatch (port of
:mod:`repro.kernels.bitflip.ops`).

Words are ``torch.int32`` bit patterns.  ``tensor.view(torch.int32)``
pairs bf16/fp16 elements (element 2i in the low half) and packs int8
elements exactly as the reference's ``to_u32`` does.
"""
from __future__ import annotations

import torch

from repro_torch.core.faultmap import KernelThresholds

# Above this per-bit rate the one-stuck-bit-per-word approximation is off
# by more than ~1.6% and the exact bitwise path is used.
WORD_PATH_MAX_RATE = 1e-3


def pick_method(thresholds: KernelThresholds) -> str:
    worst = max(thresholds.p01_weak, thresholds.p10_weak,
                thresholds.p01_strong, thresholds.p10_strong)
    return "word" if worst <= WORD_PATH_MAX_RATE else "bitwise"


def to_u32(x: torch.Tensor):
    """Flatten any-dtype tensor to an int32 word view + recovery metadata
    (a view when no padding is needed, else a padded copy)."""
    flat = x.reshape(-1)
    itemsize = x.element_size()
    if itemsize not in (1, 2, 4):
        raise NotImplementedError(f"itemsize {itemsize} for dtype {x.dtype}")
    packing = 4 // itemsize
    n = flat.shape[0]
    pad = (-n) % packing
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.contiguous().view(torch.int32), (tuple(x.shape), x.dtype, n,
                                                 packing)


def from_u32(u32: torch.Tensor, meta):
    """Inverse of :func:`to_u32`: int32 words -> original shape/dtype."""
    shape, dtype, n, packing = meta
    flat = u32.contiguous().view(dtype)
    if packing != 1:
        flat = flat[:n]
    return flat.reshape(shape)

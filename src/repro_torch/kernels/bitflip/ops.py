"""dtype <-> uint32 word views, method dispatch and the per-segment
injection entry points (port of :mod:`repro.kernels.bitflip.ops`).

Words are ``torch.int32`` bit patterns.  ``tensor.view(torch.int32)``
pairs bf16/fp16 elements (element 2i in the low half) and packs int8
elements exactly as the reference's ``to_u32`` does.
"""
from __future__ import annotations

import torch

from repro_torch.core.faultmap import KernelThresholds
from repro_torch.kernels.bitflip import ref as _ref
from repro_torch.kernels.bitflip.bitflip import bitflip

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


def inject_u32(data_u32: torch.Tensor, *, thresholds: KernelThresholds,
               seed: int, base_word: int = 0, method: str = "auto",
               use_ref: bool = False) -> torch.Tensor:
    """Apply stuck-at faults to a flat int32 run of physical words
    ``[base_word, base_word + n)``: one K5 launch (the plain version for
    CPU tensors), or the oracle :func:`~repro_torch.kernels.bitflip.ref.
    inject_u32_ref` with ``use_ref``.  The reference pads the run to whole
    4096-word blocks and slices the padding off again; K5 guards its tail
    instead, which gives the same words without the copy."""
    if method == "auto":
        method = pick_method(thresholds)
    if use_ref:
        return _ref.inject_u32_ref(data_u32, thresholds=thresholds,
                                   seed=int(seed), base_word=int(base_word),
                                   method=method)
    return bitflip(data_u32, thresholds=thresholds, seed=int(seed),
                   base_word=int(base_word), method=method)


def inject(x: torch.Tensor, *, thresholds: KernelThresholds, seed: int,
           base_word: int = 0, method: str = "auto",
           use_ref: bool = False) -> torch.Tensor:
    """Apply stuck-at faults to a tensor of any dtype in place of its
    physical words; returns a new tensor of the same shape and dtype."""
    u32, meta = to_u32(x)
    out = inject_u32(u32, thresholds=thresholds, seed=seed,
                     base_word=base_word, method=method, use_ref=use_ref)
    return from_u32(out, meta)

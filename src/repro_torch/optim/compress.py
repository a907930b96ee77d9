"""Gradient compression: per-tensor int8 quantization with error
feedback (port of :mod:`repro.optim.compress`).

Applied as a quantize-dequantize transform with a persistent
error-feedback buffer -- numerically what a compressed data-parallel
all-reduce on dequantized values computes.  Float32 throughout, like the
reference.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.core import pytree


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization: (int8 codes, scale)."""
    scale = torch.clamp(x.abs().amax(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def ef_quantize_grads(grads: Any, ef: Any) -> Tuple[Any, Any]:
    """Quantize each gradient leaf with error feedback.

    Returns (dequantized grads for the optimizer, new EF buffers)."""
    dq = pytree.tree_map(lambda t: t, grads)
    new_ef = pytree.tree_map(lambda t: t, ef)
    for (path, g), e in zip(pytree.flatten_with_path(grads),
                            pytree.leaves(ef)):
        g = g.to(torch.float32) + e
        d = dequantize_int8(*quantize_int8(g))
        pytree.set_path(dq, path, d)
        pytree.set_path(new_ef, path, g - d)
    return dq, new_ef


def init_ef(params: Any) -> Any:
    return pytree.tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        params)

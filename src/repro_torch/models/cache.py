"""Ring-buffer cache helpers (port of :mod:`repro.models.cache`).

A cache is a dict with a ``pos`` int32 (B, L) leaf recording the absolute
position stored in each slot (-1 = empty) plus value leaves with the slot
axis at dim 1.  The slot of position p is p % L.  Unlike the reference's
functional updates, the writes here go **in place** into the given
tensors (which may be one layer's view of a period-stacked leaf).
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.core import pytree
from repro_torch.models.base import ParamSpec


def init_cache(specs, device) -> Dict:
    def mk(s: ParamSpec):
        if s.dtype == torch.int32:
            return torch.full(s.shape, -1, dtype=torch.int32, device=device)
        return torch.zeros(s.shape, dtype=s.dtype, device=device)
    return pytree.tree_map(mk, specs, is_leaf=lambda x: isinstance(x, ParamSpec))


def ring_fill(cache: Dict[str, torch.Tensor], new: Dict[str, torch.Tensor],
              positions: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Prefill: write a full sequence, keeping the last L entries."""
    ln = cache["pos"].shape[1]
    s = positions.shape[1]
    if s >= ln:
        slots = torch.arange(s - ln, s) % ln
        inv = torch.argsort(slots)
        for k, arr in new.items():
            cache[k].copy_(arr[:, -ln:][:, inv.to(arr.device)])
        cache["pos"].copy_(positions[:, -ln:][:, inv.to(positions.device)])
    else:
        for k, arr in new.items():
            cache[k][:, :s].copy_(arr)
        cache["pos"][:, :s].copy_(positions)
    return cache


def ring_update(cache: Dict[str, torch.Tensor], new: Dict[str, torch.Tensor],
                pos: int) -> Dict[str, torch.Tensor]:
    """Decode: write one token at slot pos % L (an indexed write into the
    cache leaves, in place)."""
    ln = cache["pos"].shape[1]
    slot = int(pos) % ln
    for k, arr in new.items():
        cache[k][:, slot].copy_(arr[:, 0])
    cache["pos"][:, slot] = int(pos)
    return cache


def ring_write(cache, new, pos):
    """Decode ring write at a scalar position (every row at one step)."""
    return ring_update(cache, new, pos)


def decode_positions(pos: int, b: int, c: int, device) -> torch.Tensor:
    """(B, C) query-position grid for a decode step at scalar ``pos``."""
    return torch.full((b, c), int(pos), dtype=torch.int32, device=device)

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
    if s > ln:
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


def ring_update_rows(cache: Dict[str, torch.Tensor],
                     new: Dict[str, torch.Tensor],
                     pos: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Decode: write one token per row, row b at its own slot
    ``pos[b] % L`` of the cache leaves (``pos`` a (B,) int32 tensor), in
    place.  Rows with a negative position keep their stored values."""
    ln = cache["pos"].shape[1]
    qp = pos.reshape(-1).to(torch.int32)
    valid = qp >= 0
    slot = torch.where(valid, qp, 0).long() % ln
    b = torch.arange(qp.shape[0], device=qp.device)
    for k, arr in new.items():
        row = arr[:, 0]
        keep = cache[k][b, slot]
        vmask = valid.reshape((-1,) + (1,) * (row.dim() - 1))
        cache[k][b, slot] = torch.where(vmask, row.to(keep.dtype), keep)
    cache["pos"][b, slot] = torch.where(valid, qp, cache["pos"][b, slot])
    return cache


def ring_write(cache, new, pos):
    """Decode ring write at a Python int position (every row at one step)
    or at a position tensor on the cache's device, 0-dim or (B,) per row,
    which the write reads there (no host sync)."""
    b = cache["pos"].shape[0]
    if not isinstance(pos, torch.Tensor):
        return ring_update_rows(cache, new, torch.full(
            (b,), int(pos), dtype=torch.int32, device=cache["pos"].device))
    return ring_update_rows(cache, new, pos.reshape(-1).expand(b))


def decode_positions(pos, b: int, c: int, device) -> torch.Tensor:
    """(B, C) query-position grid for a decode step from a scalar, a (B,)
    per-row position or a (B, C) per-token position tensor."""
    if not isinstance(pos, torch.Tensor) or pos.dim() == 0:
        return torch.full((b, c), int(pos), dtype=torch.int32, device=device)
    qp = pos.to(device=device, dtype=torch.int32)
    if qp.dim() == 1:
        return qp.reshape(b, 1).expand(b, c)
    return qp


def paged_update(cache: Dict[str, torch.Tensor], new: Dict[str, torch.Tensor],
                 pos: torch.Tensor, page_table: torch.Tensor, length: int,
                 page_slots: int, wstart: torch.Tensor = None,
                 scratch_id: int = None) -> Dict[str, torch.Tensor]:
    """Paged twin of :func:`ring_update_rows`: a chunk of tokens per serving
    slot, scattered in place into one layer's page pool.

    ``cache`` holds pool buffers with the page axis at dim 0 and the
    within-page slot axis at dim 1; ``new`` entries are (S, C, ...)
    per-slot chunks; ``pos`` the (S,) or (S, C) absolute position of each
    token; ``page_table`` (S, length // page_slots) maps each slot's
    logical ring page to its pool page.  Position p lands in ring slot
    p % length.  Tokens at a negative position, or below the slot's write
    floor ``wstart`` (rows of copy-on-write shared pages), go to the
    ``scratch_id`` sink page instead."""
    qp = pos.to(torch.int32)
    if qp.dim() == 1:
        qp = qp[:, None]
    valid = qp >= 0
    if wstart is not None:
        valid &= qp >= wstart.reshape(-1, 1).to(torch.int32)
    slot = torch.where(valid, qp, 0).long() % length
    lp = slot // page_slots
    row = torch.where(valid, slot % page_slots, 0)
    pid = torch.gather(page_table.long(), 1, lp)
    if scratch_id is not None:
        pid = torch.where(valid, pid, scratch_id)
    c = qp.shape[1]
    for k, arr in new.items():
        cache[k][pid, row] = arr[:, :c].to(cache[k].dtype)
    cache["pos"][pid, row] = qp
    return cache

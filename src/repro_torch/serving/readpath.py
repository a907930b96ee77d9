"""Read-path injection context (port of :mod:`repro.serving.readpath`).

A :class:`ReadPathCtx` is built once per KV voltage from the serving
placement: for every K/V cache leaf it carries the arena block tables
(physical base words, threshold rows at the voltage) on the cache's
device.  The model's decode attention calls :meth:`ReadPathCtx.attend`,
which routes the stored cache through the K3 kernel
(:func:`repro_torch.kernels.flash_attention.faulty.faulty_decode_attention`)
-- faults are applied to the K/V tile as it is loaded.  With
``inject=False`` the same kernel runs without the mask math, so every
serving mode shares one set of attention numerics.

A placement may be arena-backed (block tables) or page-granular (a paged
scheduler request's :class:`~repro_torch.serving.paged.RequestPlacement`).
A page-granular placement pins the kernel's tile to one page, so the
online softmax folds the same tiles as the paged kernel K4 and a replay
gives the scheduler's bits.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core import engine as arena
from repro_torch.core import pytree
from repro_torch.core.domains import GroupPlacement
from repro_torch.core.faultmap import FaultMap
from repro_torch.kernels.flash_attention import faulty
from repro_torch.models.base import cache_layouts
from repro_torch.models.cache import ring_write

_KV_LEAF_RE = re.compile(
    r"^\['(prefix|periods|rest)'\]\['([^']+)'\]\['([kv])'\]$")


def supports(module) -> bool:
    """Whether a family module's decode step accepts a read-path ctx."""
    return bool(getattr(module, "SUPPORTS_READ_PATH", False))


def state_leaf_paths(specs, max_len: int) -> Tuple[str, ...]:
    """Keystr paths of a family's carried-``state`` cache leaves.

    The read path never covers them: recurrent state (RG-LRU h and conv
    tail) is rewritten whole every decode step, so write-path injection
    re-applies the domain's stuck-at masks to each new value -- a fault
    acquired on write persists for the life of the request, unlike ring
    rows, which are written once and only re-masked idempotently."""
    return tuple(pytree.keystr(p) for p, lay in pytree.flatten_with_path(
        cache_layouts(specs, max_len)) if lay == "state")


@dataclasses.dataclass(frozen=True)
class _LeafEntry:
    base: torch.Tensor        # (num_blocks,) int32 physical block bases
    thr: torch.Tensor         # (num_blocks, NUM_THR_COLS) int32 at voltage
    layer_words: int          # words per period index (0 = unstacked leaf)
    words_log2: int           # table granularity


@dataclasses.dataclass(frozen=True)
class _SlotEntry:
    k: _LeafEntry
    v: _LeafEntry


def _avals_by_path(cache_avals):
    return {pytree.keystr(p): a
            for p, a in pytree.flatten_with_path(cache_avals)}


def _kv_shape(aval, stacked: bool):
    return tuple(aval.shape[1:] if stacked else aval.shape)


def cache_supported(placement: GroupPlacement, cache_avals) -> bool:
    """Whether every K/V leaf can ride the read path: word-aligned slots
    and (for ECC domains) codeword-aligned head rows."""
    by_path = _avals_by_path(cache_avals)
    matched = False
    for lp in placement.leaves:
        m = _KV_LEAF_RE.match(lp.path)
        if not m:
            continue
        matched = True
        shape = _kv_shape(by_path[lp.path], m.group(1) == "periods")
        if len(shape) != 4:
            return False
        _, _, kh, d = shape
        dtype = by_path[lp.path].dtype
        try:
            wps = faulty.kv_words_per_slot(kh, d, dtype)
        except ValueError:
            return False
        if placement.domain.ecc and wps % 2:
            return False
    return matched


def kv_paths(placement: GroupPlacement) -> Tuple[str, ...]:
    """keystr paths of the leaves the read path corrupts."""
    return tuple(lp.path for lp in placement.leaves
                 if _KV_LEAF_RE.match(lp.path))


@dataclasses.dataclass
class ReadPathCtx:
    entries: Dict[str, _SlotEntry]
    seed: int
    words_per_row_log2: int
    method: str
    ecc: bool
    inject: bool
    # K/V tile in slots (None: the kernel's default); a page-granular
    # placement sets it to one page
    bkv: Optional[int] = None

    def covers(self, slot_key: str) -> bool:
        return slot_key in self.entries

    def update(self, slot_key: str, cache, new, pos):
        """Decode cache write for this layout: the contiguous ring update
        at a scalar or a (B,) per-row position tensor, an indexed write
        into the stacked leaf, in place."""
        return ring_write(cache, new, pos)

    def attend(self, slot_key: str, layer_idx, q, cache, *, q_pos,
               causal: bool, window: int, scale=None):
        """Fused decode attention over one layer's ring cache.

        ``layer_idx``: period index for stacked slots (None otherwise);
        ``q_pos``: the decode position, a scalar or a (B,) int32 tensor on
        the cache's device, which K3 reads there; each row's slot of
        ``q_pos`` is exempt from corruption (the value still sits in the
        store buffer)."""
        e = self.entries[slot_key]
        k, v, pos = cache["k"], cache["v"], cache["pos"]
        idx = 0 if layer_idx is None else int(layer_idx)
        return faulty.faulty_decode_attention(
            q, k, v, pos, q_pos=q_pos,
            k_tables=(e.k.base, e.k.thr), v_tables=(e.v.base, e.v.thr),
            k_word0=idx * e.k.layer_words, v_word0=idx * e.v.layer_words,
            causal=causal, window=window, scale=scale, seed=self.seed,
            method=self.method, words_per_row_log2=self.words_per_row_log2,
            ecc=self.ecc, inject=self.inject, bkv=self.bkv,
            words_log2=e.k.words_log2)


def build_ctx(placement: GroupPlacement, faultmap: FaultMap, cache_avals,
              *, voltage: float, method: str, inject: bool,
              device) -> ReadPathCtx:
    """Build the per-voltage context with tables on ``device``.  A
    page-granular placement must come from a pool on this fault map (its
    stamped ``map_seed``) and pins the tile to one page."""
    ms = getattr(placement, "map_seed", None)
    if ms is not None and ms != faultmap.seed:
        raise ValueError(
            f"kv_placement was exported from a pool whose fault map has "
            f"seed {ms}, but the replay plan's fault map has seed "
            f"{faultmap.seed}: replay a request against the plan it was "
            "served on, or the tokens would silently diverge")
    tabs = arena.device_tables(placement, faultmap, float(voltage),
                               torch.device(device))[2]
    by_path = _avals_by_path(cache_avals)
    halves: Dict[str, Dict[str, _LeafEntry]] = {}
    bkv = set()
    for lp in placement.leaves:
        m = _KV_LEAF_RE.match(lp.path)
        if not m:
            continue
        slot_key, which = m.group(2), m.group(3)
        stacked = m.group(1) == "periods"
        aval = by_path[lp.path]
        base, thr, lg2 = tabs[lp.path]
        _, length, kh, d = _kv_shape(aval, stacked)
        wps = faulty.kv_words_per_slot(kh, d, aval.dtype)
        layer_words = aval.shape[1] * length * wps if stacked else 0
        if hasattr(lp, "page_words"):
            if lp.page_words % wps:
                raise ValueError(f"{lp.path}: page of {lp.page_words} "
                                 f"words is not whole slots of {wps}")
            bkv.add(lp.page_words // wps)
        halves.setdefault(slot_key, {})[which] = _LeafEntry(
            base=base, thr=thr, layer_words=int(layer_words),
            words_log2=lg2)
    entries = {key: _SlotEntry(k=h["k"], v=h["v"])
               for key, h in halves.items() if "k" in h and "v" in h}
    if len(bkv) > 1:
        raise ValueError(f"inconsistent page slot counts {sorted(bkv)}")
    return ReadPathCtx(entries=entries, seed=faultmap.seed,
                       words_per_row_log2=faultmap.words_per_row_log2,
                       method=method, ecc=placement.domain.ecc,
                       inject=inject, bkv=(bkv.pop() if bkv else None))


def build_clean_ctx(cache_avals, *, bkv: int, device) -> ReadPathCtx:
    """A context that routes every K/V slot of the cache through K3 with
    injection off and a tile of ``bkv`` slots: the clean route that
    computes what the paged kernel K4 computes on a clean pool of
    ``bkv``-slot pages."""
    dev = torch.device(device)
    base = torch.zeros((1,), dtype=torch.int32, device=dev)
    thr = torch.zeros((1, 11), dtype=torch.int32, device=dev)
    halves: Dict[str, Dict[str, _LeafEntry]] = {}
    for path, aval in _avals_by_path(cache_avals).items():
        m = _KV_LEAF_RE.match(path)
        if not m:
            continue
        shape = _kv_shape(aval, m.group(1) == "periods")
        wps = faulty.kv_words_per_slot(shape[2], shape[3], aval.dtype)
        layer_words = (aval.shape[1] * shape[1] * wps
                       if m.group(1) == "periods" else 0)
        halves.setdefault(m.group(2), {})[m.group(3)] = _LeafEntry(
            base=base, thr=thr, layer_words=int(layer_words),
            words_log2=faulty.BLOCK_WORDS_LOG2)
    entries = {key: _SlotEntry(k=h["k"], v=h["v"])
               for key, h in halves.items() if "k" in h and "v" in h}
    return ReadPathCtx(entries=entries, seed=0, words_per_row_log2=0,
                       method="word", ecc=False, inject=False, bkv=int(bkv))

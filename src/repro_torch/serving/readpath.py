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
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, Tuple

import torch

from repro_torch.core import engine as arena
from repro_torch.core import pytree
from repro_torch.core.domains import GroupPlacement
from repro_torch.core.faultmap import FaultMap
from repro_torch.kernels.flash_attention import faulty

_KV_LEAF_RE = re.compile(
    r"^\['(prefix|periods|rest)'\]\['([^']+)'\]\['([kv])'\]$")


def supports(module) -> bool:
    """Whether a family module's decode step accepts a read-path ctx."""
    return bool(getattr(module, "SUPPORTS_READ_PATH", False))


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

    def covers(self, slot_key: str) -> bool:
        return slot_key in self.entries

    def update(self, slot_key: str, cache, new, pos: int):
        """Decode cache write for this layout: the contiguous ring update,
        an indexed write into the stacked leaf, in place."""
        from repro_torch.models.cache import ring_update
        return ring_update(cache, new, pos)

    def attend(self, slot_key: str, layer_idx, q, cache, *, q_pos: int,
               causal: bool, window: int, scale=None):
        """Fused decode attention over one layer's ring cache.

        ``layer_idx``: period index for stacked slots (None otherwise);
        the slot of ``q_pos`` is exempt from corruption (the value still
        sits in the store buffer)."""
        e = self.entries[slot_key]
        k, v, pos = cache["k"], cache["v"], cache["pos"]
        idx = 0 if layer_idx is None else int(layer_idx)
        return faulty.faulty_decode_attention(
            q, k, v, pos, q_pos=int(q_pos),
            k_tables=(e.k.base, e.k.thr), v_tables=(e.v.base, e.v.thr),
            k_word0=idx * e.k.layer_words, v_word0=idx * e.v.layer_words,
            causal=causal, window=window, scale=scale, seed=self.seed,
            method=self.method, words_per_row_log2=self.words_per_row_log2,
            ecc=self.ecc, inject=self.inject,
            clean_slot=int(q_pos) % k.shape[1],
            words_log2=e.k.words_log2)


def build_ctx(placement: GroupPlacement, faultmap: FaultMap, cache_avals,
              *, voltage: float, method: str, inject: bool,
              device) -> ReadPathCtx:
    """Build the per-voltage context with tables on ``device``."""
    tabs = arena.device_tables(placement, faultmap, float(voltage),
                               torch.device(device))[2]
    by_path = _avals_by_path(cache_avals)
    halves: Dict[str, Dict[str, _LeafEntry]] = {}
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
        halves.setdefault(slot_key, {})[which] = _LeafEntry(
            base=base, thr=thr, layer_words=int(layer_words),
            words_log2=lg2)
    entries = {key: _SlotEntry(k=h["k"], v=h["v"])
               for key, h in halves.items() if "k" in h and "v" in h}
    return ReadPathCtx(entries=entries, seed=faultmap.seed,
                       words_per_row_log2=faultmap.words_per_row_log2,
                       method=method, ecc=placement.domain.ecc,
                       inject=inject)

"""Arena-based fault-injection engine: one fused pass per memory domain.

Port of :mod:`repro.core.engine`.  Every leaf of a group is packed
(block-aligned, in placement order) into one flat int32 *arena*, the
fault map's threshold rows are gathered per arena block, and one kernel
launch -- K1 (``arena_bitflip``) or, on an ECC domain, K2
(``arena_ecc``) -- injects the whole domain.  ``use_ref`` runs the plain
PyTorch versions on the same operands instead.

The incremental write path (:func:`inject_placement_slice`) is plain
PyTorch on every device, as the reference's is plain jnp: it corrupts
only the ring slot a decode step wrote, **in place** in the cache leaf.
Its position may be a tensor on the cache's device, read there, so the
write path can run inside a captured decode step.

:data:`repro_torch.kernels._build.LAUNCHES` counts kernel launches and
stands in for the reference's ``count_pallas_calls``.
"""
from __future__ import annotations

import functools
from typing import Dict

import numpy as np
import torch

from repro_torch.core import hashing as H
from repro_torch.core import pytree
from repro_torch.core.domains import ALIGN_WORDS, GroupPlacement
from repro_torch.core.faultmap import FaultMap
from repro_torch.core.faultmodel import V_MIN
from repro_torch.kernels.bitflip import ops as bitflip_ops
from repro_torch.kernels.bitflip.bitflip import (BLOCK_WORDS,
                                                 BLOCK_WORDS_LOG2, apply_masks,
                                                 arena_bitflip,
                                                 arena_bitflip_ref,
                                                 select_block_tables)
from repro_torch.kernels.ecc.ecc import (arena_ecc, arena_ecc_codewords,
                                         arena_ecc_events, arena_ecc_ref)

assert BLOCK_WORDS == ALIGN_WORDS, "arena blocks must match allocation slots"


@functools.lru_cache(maxsize=256)
def _block_arrays(placement: GroupPlacement):
    """(block_pc int64, block_base int32 bit patterns) CPU tensors."""
    table = placement.block_table()
    return (torch.tensor(table.block_pc, dtype=torch.int64),
            H.as_i32(torch.tensor(table.block_base, dtype=torch.int64)))


def block_thresholds(faultmap: FaultMap, voltage: float, block_pc,
                     device) -> torch.Tensor:
    """(n, NUM_THR_COLS) int32 threshold rows of the given PCs, gathered
    from the one CPU table and copied to ``device``."""
    return faultmap.threshold_table(voltage)[block_pc].to(device)


@functools.lru_cache(maxsize=64)
def device_tables(placement: GroupPlacement, faultmap: FaultMap,
                  voltage: float, device: torch.device):
    """``(block_base, block_thr, {leaf path: (base, thr, words_log2)})``:
    the placement's arena tables and per-leaf tables on ``device`` at one
    voltage, copied once.  A copy from pageable host memory can wait for
    the stream to drain, so the decode loop must not make one per step."""
    leaves = {lp.path: (bb.to(device),
                        block_thresholds(faultmap, voltage, bp, device), lg2)
              for lp, (bb, bp, lg2) in zip(placement.leaves,
                                           leaf_addr_tables(placement))}
    if _is_paged(placement):
        return None, None, leaves       # page tables only: no arena
    block_pc, block_base = _block_arrays(placement)
    return (block_base.to(device),
            block_thresholds(faultmap, voltage, block_pc, device), leaves)


def resolve_method(faultmap: FaultMap, placement: GroupPlacement,
                   voltage=None) -> str:
    """Word/bitwise dispatch for a whole domain: the word path only if
    every PC of the domain is inside its validity regime."""
    v = placement.domain.voltage if voltage is None else float(voltage)
    if any(bitflip_ops.pick_method(faultmap.thresholds(v, pc)) == "bitwise"
           for pc in placement.domain.pc_ids):
        return "bitwise"
    return "word"


def pack_arena(tree, placement: GroupPlacement):
    """Pack a group's leaves into one flat int32 arena.

    Returns (arena, pack_meta); ``pack_meta`` records, in the tree's
    flatten order, each leaf's path, arena slot and dtype metadata."""
    table = placement.block_table()
    flat = pytree.flatten_with_path(tree)
    leaf_by_path = {pytree.keystr(p): leaf for p, leaf in flat}
    pieces = []
    slot_by_path = {}
    for lp, (start, n_blocks, n_words) in zip(placement.leaves,
                                              table.leaf_blocks):
        u32, meta = bitflip_ops.to_u32(leaf_by_path[lp.path])
        assert u32.shape[0] == n_words == lp.n_words, (lp.path, n_words)
        pad = n_blocks * BLOCK_WORDS - n_words
        if pad:
            u32 = torch.cat([u32, u32.new_zeros(pad)])
        pieces.append(u32)
        slot_by_path[lp.path] = (meta, start, n_words)
    arena = torch.cat(pieces) if len(pieces) > 1 else pieces[0]
    slots = tuple((p, slot_by_path[pytree.keystr(p)]) for p, _ in flat)
    return arena, (tree, slots)


def unpack_arena(arena, pack_meta):
    """Inverse of :func:`pack_arena`; the leaves are views of ``arena``."""
    tree, slots = pack_meta
    out = pytree.tree_map(lambda x: x, tree)
    for path, (meta, start, n_words) in slots:
        s = start * BLOCK_WORDS
        pytree.set_path(out, path,
                        bitflip_ops.from_u32(arena[s:s + n_words], meta))
    return out


def inject_placement(tree, placement: GroupPlacement, faultmap: FaultMap,
                     *, voltage=None, method: str = "auto",
                     use_ref: bool = False, with_corrected: bool = False):
    """Inject a whole group through one fused arena pass.

    A no-op (the input tree, zero counts) when the voltage sits in the
    guardband.  Returns (faulted tree, uncorrectable count) -- with
    ``with_corrected`` also the corrected-codeword count; counts are 0-d
    int64 tensors on the tree's device (no host sync)."""
    domain = placement.domain
    leaves = pytree.leaves(tree)
    dev = leaves[0].device if leaves else torch.device("cpu")
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    v = domain.voltage if voltage is None else float(voltage)
    if not placement.leaves or v >= V_MIN - 1e-9:
        return (tree, zero, zero) if with_corrected else (tree, zero)
    if method == "auto":
        method = "word" if domain.ecc else resolve_method(
            faultmap, placement, v)
    block_base, block_thr, _ = device_tables(placement, faultmap, v, dev)
    arena, pack_meta = pack_arena(tree, placement)
    kw = dict(seed=faultmap.seed,
              words_per_row_log2=faultmap.words_per_row_log2)
    if domain.ecc:
        fn = arena_ecc_ref if use_ref else arena_ecc
        out, bad_blocks, corr_blocks = fn(arena, block_base, block_thr, **kw)
        bad = bad_blocks.sum(dtype=torch.int64)
        corr = corr_blocks.sum(dtype=torch.int64)
    else:
        fn = arena_bitflip_ref if use_ref else arena_bitflip
        out = fn(arena, block_base, block_thr, method=method, **kw)
        bad = corr = zero
    faulted = unpack_arena(out, pack_meta)
    return (faulted, bad, corr) if with_corrected else (faulted, bad)


@functools.lru_cache(maxsize=256)
def leaf_block_tables(placement: GroupPlacement):
    """Per-leaf ``(block_base int32, block_pc int64)`` CPU tensors in
    placement (keystr-sorted) order."""
    table = placement.block_table()
    bp, bb = _block_arrays(placement)
    return tuple((bb[s:s + n], bp[s:s + n]) for s, n, _ in table.leaf_blocks)


def refine_tables(block_base, block_pc, page_words: int):
    """Refine one leaf's arena block tables to page granularity.

    ``page_words`` must divide BLOCK_WORDS, so every page sits inside one
    arena block and inherits its pseudo-channel; its physical base is the
    block's base plus the page's offset inside the block.  Returns
    ``(page_base uint32, page_pc int32)`` numpy arrays with
    ``BLOCK_WORDS // page_words`` entries per block."""
    if page_words <= 0 or BLOCK_WORDS % page_words:
        raise ValueError(
            f"page_words={page_words} must positively divide the arena "
            f"block size ({BLOCK_WORDS} words)")
    per = BLOCK_WORDS // page_words
    bb = np.asarray(block_base, np.int64) & 0xFFFFFFFF
    base = (np.repeat(bb, per)
            + np.tile(np.arange(per, dtype=np.int64) * page_words, len(bb)))
    return (base.astype(np.uint32),
            np.repeat(np.asarray(block_pc, np.int32), per))


def _is_paged(placement) -> bool:
    """Placements whose leaves carry their own page tables (the paged
    pool's per-request placements, duck-typed on ``page_base``)."""
    return bool(placement.leaves) and hasattr(placement.leaves[0],
                                              "page_base")


@functools.lru_cache(maxsize=256)
def leaf_addr_tables(placement):
    """Per-leaf ``(base int32, pc int64, words_log2)`` physical
    addressing tables: the block tables at BLOCK_WORDS granularity for an
    arena-backed placement, each leaf's own page tables at page
    granularity for a page-granular one."""
    if _is_paged(placement):
        out = []
        for lp in placement.leaves:
            lg2 = int(lp.page_words).bit_length() - 1
            if (1 << lg2) != lp.page_words:
                raise ValueError(f"page of {lp.page_words} words is not a "
                                 "power of two")
            out.append((H.as_i32(torch.from_numpy(
                np.asarray(lp.page_base, np.int64))),
                torch.from_numpy(np.asarray(lp.page_pc, np.int64)), lg2))
        return tuple(out)
    return tuple((bb, bp, BLOCK_WORDS_LOG2)
                 for bb, bp in leaf_block_tables(placement))


def corrupt_words(u32, off, block_base, block_thr, *, seed: int,
                  method: str, words_per_row_log2: int, ecc: bool,
                  words_log2: int = BLOCK_WORDS_LOG2, live=None):
    """Corrupt arbitrary leaf words through their block tables.

    ``u32``: int32 words; ``off``: int64 leaf word offsets of the same
    shape; tables as int32 tensors on the same device.  For ECC the last
    axis holds leaf-adjacent words in even count (codeword pairs).
    ``live``: an optional bool tensor of the leading shape with a last
    axis of 1 (or 0-dim); words of rows that are not live keep their value
    and count nothing.  Returns (corrupted int32 words, uncorrectable
    count)."""
    wid, thr = select_block_tables(off, block_base, block_thr,
                                   words_log2=words_log2)
    x = H.as_u64(u32)
    if ecc:
        out, bad = arena_ecc_codewords(x, wid, thr, seed=seed,
                                       words_per_row_log2=words_per_row_log2)
        if live is not None:
            bad = bad & live
        bad = bad.sum(dtype=torch.int64)
    else:
        out = apply_masks(x, wid, thr, seed=seed, method=method,
                          words_per_row_log2=words_per_row_log2)
        bad = torch.zeros((), dtype=torch.int64, device=u32.device)
    out = H.as_i32(out)
    if live is not None:
        out = torch.where(live, out, u32)
    return out, bad


def ecc_event_counts(u32, off, block_base, block_thr, *, seed: int,
                     words_per_row_log2: int,
                     words_log2: int = BLOCK_WORDS_LOG2):
    """Per-codeword SECDED event flags for arbitrary leaf words: the
    telemetry twin of :func:`corrupt_words` (same table-driven addressing
    and mask math), returning ``(corrected_bool, uncorrectable_bool)``
    with the last axis of ``u32`` halved instead of mutating data.  The
    masks are deterministic in the physical word id, so on clean stored
    words this gives exactly the events the read path saw loading them."""
    wid, thr = select_block_tables(off, block_base, block_thr,
                                   words_log2=words_log2)
    _, corrected, uncorrectable = arena_ecc_events(
        H.as_u64(u32), wid, thr, seed=seed,
        words_per_row_log2=words_per_row_log2)
    return corrected, uncorrectable


# Words a whole-leaf write-path corruption handles per pass: the plain
# mask math holds ~100 bytes of temporaries per word, so a leaf of
# hundreds of millions of words (whisper's cross K/V at full width) runs
# in passes of this many words.  A word's masks depend on its own id
# alone, so the passes give the whole-leaf bits.
FULL_LEAF_WORDS = 1 << 22


def _corrupt_full_leaf(leaf, block_base, block_thr, *, seed, method, wprl2,
                       ecc, words_log2=BLOCK_WORDS_LOG2, live=None):
    """Corrupt a whole leaf in place, FULL_LEAF_WORDS words per pass; a
    0-dim bool tensor ``live`` that is false keeps its words (and counts
    nothing)."""
    u32, meta = bitflip_ops.to_u32(leaf)
    n = u32.shape[0]
    pad = (-n) % 2 if ecc else 0
    if pad:
        u32 = torch.cat([u32, u32.new_zeros(pad)])
    kw = dict(seed=seed, method=method, words_per_row_log2=wprl2, ecc=ecc,
              words_log2=words_log2, live=live)
    total = n + pad
    if total <= FULL_LEAF_WORDS:
        off = torch.arange(total, dtype=torch.int64, device=leaf.device)
        out, bad = corrupt_words(u32, off, block_base, block_thr, **kw)
    else:
        out = torch.empty_like(u32)
        bad = torch.zeros((), dtype=torch.int64, device=leaf.device)
        for w0 in range(0, total, FULL_LEAF_WORDS):
            w1 = min(w0 + FULL_LEAF_WORDS, total)
            off = torch.arange(w0, w1, dtype=torch.int64, device=leaf.device)
            out[w0:w1], b = corrupt_words(u32[w0:w1], off, block_base,
                                          block_thr, **kw)
            bad = bad + b
    leaf.copy_(bitflip_ops.from_u32(out[:n], meta))
    return bad


def _corrupt_leaf_slice(leaf, slot_axis, pos, block_base, block_thr, *,
                        seed, method, wprl2, ecc, words_log2=BLOCK_WORDS_LOG2):
    """Corrupt only the ring slot written at absolute position ``pos``, in
    place.  ``pos``: a tensor read on the leaf's device, 0-dim (every
    row) or (B,) per row, B the axis just before the slot axis.
    Rows at a negative position keep their words.  Gathers each outer
    row's slot ``pos % L`` with an index tensor and scatters the corrupted
    words back."""
    shape = leaf.shape
    ln = shape[slot_axis]
    outer_shape = tuple(shape[:slot_axis])
    outer = int(np.prod(outer_shape, dtype=np.int64))
    inner = int(np.prod(shape[slot_axis + 1:], dtype=np.int64))
    wpi = inner * leaf.element_size() // 4
    dev = leaf.device
    qp = pos.to(device=dev, dtype=torch.int64)
    if qp.dim() == 1:
        # row b of every leading (layer) index: tile the (B,) positions
        qp = qp.reshape((1,) * (slot_axis - 1) + (-1,)).expand(outer_shape)
    qp = qp.expand(outer_shape).reshape(outer)
    live = qp >= 0
    slot = torch.where(live, qp, 0) % ln
    idx = tuple(torch.arange(n, device=dev).reshape(
        (1,) * i + (n,) + (1,) * (len(outer_shape) - i - 1))
        for i, n in enumerate(outer_shape))
    index = idx + (slot.reshape(outer_shape),)
    vals = leaf[index]                               # outer_shape + inner
    u32, meta = bitflip_ops.to_u32(vals.reshape(outer, inner))
    u32 = u32.reshape(outer, wpi)
    off = (torch.arange(outer, dtype=torch.int64, device=dev)[:, None]
           * (ln * wpi) + slot[:, None] * wpi
           + torch.arange(wpi, dtype=torch.int64, device=dev)[None, :])
    out, bad = corrupt_words(u32, off, block_base, block_thr, seed=seed,
                             method=method, words_per_row_log2=wprl2,
                             ecc=ecc, words_log2=words_log2,
                             live=live[:, None])
    leaf[index] = bitflip_ops.from_u32(out.reshape(-1), meta).reshape(
        vals.shape)
    return bad


def _sliceable(leaf, slot_axis, ecc) -> bool:
    if slot_axis is None or slot_axis < 0:
        return False
    inner_bytes = (int(np.prod(leaf.shape[slot_axis + 1:], dtype=np.int64))
                   * leaf.element_size())
    if inner_bytes % 4:
        return False                   # slot not word-aligned
    if ecc and (inner_bytes // 4) % 2:
        return False                   # slot splits an ECC codeword
    return True


def inject_placement_slice(tree, placement: GroupPlacement,
                           faultmap: FaultMap, *, slot_axes=None, pos=None,
                           voltage=None, method: str = "auto",
                           skip_paths=()):
    """Incremental write-path injection, in place, O(touched words).

    With ``pos`` an absolute position, only ring slot ``pos % L`` of each
    sliceable leaf is corrupted -- bit-identical to re-injecting the whole
    cache (stuck-at masks are deterministic per physical word and
    idempotent).  Leaves without a slot axis, with non-word-aligned slots,
    or whose slots split ECC codewords are corrupted whole, as is every
    leaf when ``pos`` is None.  ``skip_paths``: keystr paths handled
    elsewhere (K/V leaves on the read path).

    ``pos`` is an int or a tensor on the tree's device, read there (no
    host sync, so the call can be captured in a CUDA graph): 0-dim, or
    (B,) per row with B the axis before each leaf's slot axis.  A row at
    a negative position is not live and keeps its words; a leaf corrupted
    whole is kept when no position is live.

    The leaves of ``tree`` are updated in place; returns (tree,
    uncorrectable count)."""
    domain = placement.domain
    leaves = pytree.flatten_with_path(tree)
    dev = leaves[0][1].device if leaves else torch.device("cpu")
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    v = domain.voltage if voltage is None else float(voltage)
    if not placement.leaves or v >= V_MIN - 1e-9:
        return tree, zero
    if method == "auto":
        method = "word" if domain.ecc else resolve_method(
            faultmap, placement, v)
    tables = device_tables(placement, faultmap, v, dev)[2]
    if slot_axes is None:
        ax_leaves = [-1] * len(leaves)
    else:
        ax_leaves = pytree.leaves(slot_axes)
        assert len(ax_leaves) == len(leaves), "slot_axes must match the tree"
    total_bad = zero
    skip = set(skip_paths)
    if pos is not None and not isinstance(pos, torch.Tensor):
        pos = torch.full((), int(pos), dtype=torch.int64, device=dev)
    live = None if pos is None else (pos.to(dev) >= 0).any()
    for (path, leaf), axis in zip(leaves, ax_leaves):
        key = pytree.keystr(path)
        if key in skip:
            continue
        bb, bt, lg2 = tables[key]
        kw = dict(seed=faultmap.seed, method=method,
                  wprl2=faultmap.words_per_row_log2, ecc=domain.ecc,
                  words_log2=lg2)
        if pos is not None and _sliceable(leaf, axis, domain.ecc):
            bad = _corrupt_leaf_slice(leaf, axis, pos, bb, bt, **kw)
        else:
            bad = _corrupt_full_leaf(leaf, bb, bt, live=live, **kw)
        total_bad = total_bad + bad
    return tree, total_bad


def inject_groups(groups: Dict[str, object],
                  placements: Dict[str, GroupPlacement],
                  faultmap: FaultMap, *, voltage=None, method: str = "auto",
                  use_ref: bool = False, with_corrected: bool = False):
    """Arena-inject every group: one fused pass per domain.

    A scalar ``voltage`` overrides only domains configured below the
    guardband; a ``{domain name: voltage}`` dict targets domains
    explicitly.  Returns (faulted groups, total uncorrectable count) and,
    with ``with_corrected``, the total corrected count."""
    if isinstance(voltage, dict):
        known = {p.domain.name for p in placements.values()}
        unknown = set(voltage) - known
        if unknown:
            raise ValueError(
                f"voltage override names unknown domains {sorted(unknown)}; "
                f"placements cover {sorted(known)}")
    out: Dict[str, object] = {}
    total_bad = total_corr = 0
    for name, tree in groups.items():
        placement = placements[name]
        if isinstance(voltage, dict):
            v = voltage.get(placement.domain.name)
        elif voltage is not None and placement.domain.voltage < V_MIN - 1e-9:
            v = voltage
        else:
            v = None
        faulted, bad, corr = inject_placement(
            tree, placement, faultmap, voltage=v, method=method,
            use_ref=use_ref, with_corrected=True)
        out[name] = faulted
        total_bad = total_bad + bad
        total_corr = total_corr + corr
    if with_corrected:
        return out, total_bad, total_corr
    return out, total_bad


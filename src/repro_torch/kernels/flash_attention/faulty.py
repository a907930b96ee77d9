"""K3 and K4: decode attention with read-path fault injection -- CUDA
kernel wrappers, plain versions and tile helpers.

Port of :mod:`repro.kernels.flash_attention.faulty`.  The CUDA kernels
replace the TPU kernels of that module: ``csrc/faulty_decode.cu`` (K3)
``faulty_decode_attention`` over a contiguous ring cache, and
``csrc/paged_decode.cu`` (K4) ``paged_decode_attention`` over a page
pool.  Both include ``csrc/decode_tile.cuh``, the one split body, and
split the ring across CUDA blocks the way :func:`decode_splits` says
(flash-decoding: one launch, the splits merged in a fixed order by the
last block of each row); their source comments say what bounds them on
the H100 and how the design answers that.

K/V words are corrupted as they are loaded, addressed through the leaf's
arena block tables, with the mask math of the arena engine -- so
read-path corruption equals corrupt-then-attend on the same operands.
The slot written this step (ring slot ``q_pos % L`` of each row) keeps
its stored value.  Decode positions are int32 tensors on the cache's
device, one per row, read by the kernels themselves, so a decode step
captured in a CUDA graph follows its position buffer.
With ``inject=False`` this is plain decode flash attention; the
write-path serving modes use it so every mode shares one set of
attention numerics.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.core import hashing as H
from repro_torch.kernels import _build
from repro_torch.kernels.bitflip.bitflip import (BLOCK_WORDS,
                                                 BLOCK_WORDS_LOG2, METHODS,
                                                 apply_masks,
                                                 select_block_tables)
from repro_torch.kernels.ecc.ecc import arena_ecc_codewords, arena_ecc_events

NEG_INF = -1e30

# Per-tile word cap (the reference's tile-size rule).
TILE_WORD_CAP = 16 * BLOCK_WORDS
# Ring slots one split of K3 / K4 covers (in whole tiles, at least one).
# At 128 the paged scheduler's K4 launch (4 slots x 8 KV heads, pages of 8
# slots over a 1024-slot ring) has 8 splits of 16 pages, 256 blocks, and
# K3 at generate()'s 128-slot tile one tile per split, also 256 blocks:
# two blocks on nearly every one of the H100's 132 SMs, one wave.  On the
# card 128 beat 64 (two waves of 512 blocks) for K4; see PERF.md.
SPLIT_SLOTS = 128
# Shared memory one CUDA block may use on Hopper.
_SMEM_LIMIT = 227 * 1024
_KERNEL_DTYPES = {torch.bfloat16: 2, torch.float32: 4}


@functools.lru_cache(maxsize=None)
def packing(dtype) -> int:
    """Elements per uint32 word for a cache dtype."""
    itemsize = dtype.itemsize
    if itemsize > 4:
        raise NotImplementedError(f"itemsize {itemsize} for {dtype}")
    return 4 // itemsize


def kv_words_per_slot(kh: int, d: int, dtype) -> int:
    """uint32 words one cache slot (all KV heads) occupies."""
    p = packing(dtype)
    if (kh * d) % p:
        raise ValueError(
            f"KV slot of {kh}x{d} {dtype} elements is not word-aligned; "
            "the read path needs whole uint32 words per slot")
    return kh * d // p


@functools.lru_cache(maxsize=None)
def pick_bkv(length: int, words_per_slot: int,
             cap: int = TILE_WORD_CAP) -> int:
    """Largest divisor of the cache length whose tile fits the word cap."""
    best = 1
    for c in range(1, length + 1):
        if length % c == 0 and c * words_per_slot <= cap:
            best = c
    return best


def decode_splits(length: int, tile: int):
    """How K3 and K4 split a ring of ``length`` slots, folded in tiles of
    ``tile`` slots, across CUDA blocks: ``(tiles_per_split, n_splits)``.

    Split ``i`` covers tiles ``[i * tiles_per_split, min((i + 1) *
    tiles_per_split, length // tile))``; the last split may be shorter.
    It reads the ring length and the tile only -- never the batch, the
    slot count or the card -- so a row's bits do not depend on how many
    rows share a launch, and K4 over pages of PS slots splits its ring
    exactly as K3 with a tile of PS slots splits the same ring."""
    if tile <= 0 or length <= 0 or length % tile:
        raise ValueError(f"tile {tile} does not divide ring length {length}")
    tiles_per_split = max(1, SPLIT_SLOTS // tile)
    return tiles_per_split, -(-(length // tile) // tiles_per_split)


def partial_floats(g: int, d: int) -> int:
    """Floats of one split's (m, l, acc) partial, padded to 16 bytes (see
    decode_tile.cuh)."""
    return (g * (d + 2) + 3) // 4 * 4


_WORKSPACE: dict = {}


def _workspace(device, stream: int, rows: int, kh: int, n_splits: int,
               g: int, d: int):
    """Scratch of one K3 / K4 launch on ``stream``: zeroed int32 tickets,
    one per (row, KV head), with which the last block of a row's splits
    finds itself (each launch leaves them zero), and float32 room for every
    split's (m, l, acc) partial.  Kept per device and stream and grown as
    needed: launches on one stream run one after another, and launches that
    may overlap never share a buffer."""
    key = (device.index, stream)
    tickets, part = _WORKSPACE.get(key, (None, None))
    n_t, n_p = rows * kh, rows * kh * n_splits * partial_floats(g, d)
    if tickets is None or tickets.numel() < n_t:
        tickets = torch.zeros(max(n_t, 1024), dtype=torch.int32, device=device)
    if part is None or part.numel() < n_p:
        part = torch.empty(max(n_p, 1 << 18), dtype=torch.float32,
                           device=device)
    _WORKSPACE[key] = (tickets, part)
    return tickets, part


def stream_workspace(device, stream: int) -> tuple:
    """The scratch tensors that K3 / K4 launches on ``stream`` (a
    ``cuda_stream`` handle) of ``device`` use now; empty before the first
    launch there.  A CUDA graph captured on that stream holds their
    addresses, so the graph's owner keeps them alive: a later launch on
    the stream may grow the scratch and drop these from the cache."""
    index = device.index if device.index is not None else (
        torch.cuda.current_device())
    return _WORKSPACE.get((index, stream), ())


def _tile_to_u32(x):
    """(rows, elems) tile -> (rows, words) int32 view, word pairing as
    ``bitflip.ops.to_u32`` on the flattened leaf."""
    return x.contiguous().view(torch.int32)


def _tile_from_u32(u32, dtype, shape):
    return u32.contiguous().view(dtype).reshape(shape)


def corrupt_kv_tile(x, word0: int, block_base, block_thr, *, seed: int,
                    method: str, words_per_row_log2: int, ecc: bool,
                    slot_ids=None, clean_slot=None,
                    words_log2: int = BLOCK_WORDS_LOG2):
    """Read-path corruption of one (rows, elems) K/V tile whose rows are
    leaf-contiguous starting at leaf word ``word0``; rows whose
    ``slot_ids`` equal ``clean_slot`` keep their stored value."""
    u = _tile_to_u32(x)
    rows, words = u.shape
    dev = u.device
    off = (int(word0)
           + torch.arange(rows, dtype=torch.int64, device=dev)[:, None] * words
           + torch.arange(words, dtype=torch.int64, device=dev)[None, :])
    wid, thr = select_block_tables(off, block_base, block_thr,
                                   words_log2=words_log2)
    uv = H.as_u64(u)
    if ecc:
        if words % 2:
            raise ValueError("ECC tiles need an even word count")
        out, _ = arena_ecc_codewords(uv, wid, thr, seed=seed,
                                     words_per_row_log2=words_per_row_log2)
    else:
        out = apply_masks(uv, wid, thr, seed=seed, method=method,
                          words_per_row_log2=words_per_row_log2)
    out = H.as_i32(out)
    if clean_slot is not None:
        keep = (slot_ids == clean_slot)[:, None]
        out = torch.where(keep, u, out)
    return _tile_from_u32(out, x.dtype, x.shape)


def corrupt_page_tile(x, base, thr_row, *, seed: int, method: str,
                      words_per_row_log2: int, ecc: bool, slot_ids=None,
                      clean_slot=None, with_counts: bool = False):
    """Read-path corruption of (..., rows, elems) K/V tiles that are each
    one physical page: the words of a page share one threshold row and
    their physical ids are the page's ``base`` plus the word's offset in
    the page.  ``base`` has the tiles' leading shape; ``thr_row`` is a
    NUM_THR_COLS sequence of such tensors (int64 values).  Rows whose
    ``slot_ids`` equal ``clean_slot`` (both broadcast against
    ``(..., rows)``) keep their stored value.  ``with_counts`` (ECC only)
    also returns the corrected-codeword count per tile, the clean rows'
    codewords excluded."""
    u = _tile_to_u32(x)
    words = u.shape[-1]
    dev = u.device
    off = (torch.arange(u.shape[-2], dtype=torch.int64, device=dev)[:, None]
           * words + torch.arange(words, dtype=torch.int64, device=dev))
    lead = (...,) + (None,) * 2
    wid = H.as_u64(base)[lead] + off
    thr = tuple(H.as_u64(t)[lead] for t in thr_row)
    uv = H.as_u64(u)
    keep = None
    if clean_slot is not None:
        keep = (slot_ids == clean_slot)[..., None]
    counts = None
    if ecc:
        if words % 2:
            raise ValueError("ECC tiles need an even word count")
        out, corr, _ = arena_ecc_events(
            uv, wid, thr, seed=seed, words_per_row_log2=words_per_row_log2)
        if with_counts:
            corr = corr.to(torch.int32)
            if keep is not None:
                corr = torch.where(keep, 0, corr)
            counts = corr.sum(dim=(-2, -1), dtype=torch.int32)
    else:
        if with_counts:
            raise ValueError("telemetry counts require ECC")
        out = apply_masks(uv, wid, thr, seed=seed, method=method,
                          words_per_row_log2=words_per_row_log2)
    out = H.as_i32(out)
    if keep is not None:
        out = torch.where(keep, u, out)
    tile = _tile_from_u32(out, x.dtype, x.shape)
    return (tile, counts) if with_counts else tile


def _flash_tile_update(qr, k_t, v_t, pos_t, q_pos, acc, m, l, *,
                       causal: bool, window: int):
    """One flash-decode accumulator update over a (B, bkv, KH, D) tile.

    ``qr``: (B, KH, G, D) scaled f32 queries; ``q_pos`` an int or a (B,)
    int32 tensor; ``acc`` (B, KH, G, D), ``m`` and ``l`` (B, KH, G)
    running state.  Returns the new (acc, m, l).  The dot products are
    written as a product and a sum over the last axis, so each batch row's
    bits do not depend on the batch size."""
    kf = k_t.float().permute(0, 2, 1, 3)            # (B, KH, bkv, D)
    s = (qr[:, :, :, None, :] * kf[:, :, None]).sum(-1)
    if isinstance(q_pos, torch.Tensor):
        q_pos = q_pos.to(torch.int32).reshape(-1, 1)
    delta = q_pos - pos_t                           # int32, wraps like jnp
    mask = torch.zeros(pos_t.shape, dtype=torch.float32, device=pos_t.device)
    if causal:
        mask = mask.masked_fill(delta < 0, NEG_INF)
    if window > 0:
        mask = mask.masked_fill(delta >= window, NEG_INF)
    mask = mask.masked_fill(pos_t < 0, NEG_INF)     # empty ring slots
    s = s + mask[:, None, None, :]
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    vf = v_t.float().permute(0, 2, 3, 1)            # (B, KH, D, bkv)
    pv = (p[:, :, :, None, :] * vf[:, :, None]).sum(-1)
    acc = acc * corr[..., None] + pv
    l = l * corr + p.sum(dim=-1)
    return acc, m_new, l


def _geometry(q, k, v, bkv):
    b, sq, h, d = q.shape
    _, length, kh, _ = k.shape
    if sq != 1:
        raise ValueError("read-path kernel is decode-specialized (S == 1)")
    if h % kh:
        raise ValueError(f"{h} query heads do not group over {kh} KV heads")
    k_wps = kv_words_per_slot(kh, d, k.dtype)
    v_wps = kv_words_per_slot(kh, d, v.dtype)
    if bkv is None:
        bkv = pick_bkv(length, max(k_wps, v_wps))
    if length % bkv:
        raise ValueError(f"tile {bkv} does not divide cache length {length}")
    return b, h, d, length, kh, h // kh, k_wps, v_wps, bkv


def _row_positions(q_pos, b: int, device) -> torch.Tensor:
    """(B,) int32 decode positions on ``device`` from a (B,) tensor or one
    position for every row."""
    return torch.as_tensor(q_pos, device=device).to(torch.int32).reshape(
        -1).expand(b).contiguous()


def faulty_decode_attention_ref(q, k, v, pos, *, q_pos, k_tables,
                                v_tables, k_word0: int, v_word0: int,
                                causal: bool = True, window: int = 0,
                                scale=None, seed: int, method: str,
                                words_per_row_log2: int, ecc: bool,
                                inject: bool, bkv=None,
                                words_log2: int = BLOCK_WORDS_LOG2):
    """Plain PyTorch version of :func:`faulty_decode_attention`, tile by
    tile with the reference's tile semantics."""
    b, h, d, length, kh, g, k_wps, v_wps, bkv = _geometry(q, k, v, bkv)
    scale = float(d ** -0.5 if scale is None else scale)
    dev = q.device
    qp = _row_positions(q_pos, b, dev)
    clean = torch.remainder(qp, length)
    qr = (q[:, 0].float() * scale).reshape(b, kh, g, d)
    acc = torch.zeros((b, kh, g, d), dtype=torch.float32, device=dev)
    m = torch.full((b, kh, g), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, kh, g), dtype=torch.float32, device=dev)
    for t0 in range(0, length, bkv):
        k_t = k[:, t0:t0 + bkv]
        v_t = v[:, t0:t0 + bkv]
        if inject:
            slot_ids = t0 + torch.arange(bkv, device=dev)
            kw = dict(seed=seed, method=method,
                      words_per_row_log2=words_per_row_log2, ecc=ecc,
                      slot_ids=slot_ids, words_log2=words_log2)
            k_t = torch.stack([corrupt_kv_tile(
                k_t[i].reshape(bkv, kh * d),
                k_word0 + (i * length + t0) * k_wps, *k_tables,
                clean_slot=clean[i], **kw)
                for i in range(b)]).reshape(k_t.shape)
            v_t = torch.stack([corrupt_kv_tile(
                v_t[i].reshape(bkv, kh * d),
                v_word0 + (i * length + t0) * v_wps, *v_tables,
                clean_slot=clean[i], **kw)
                for i in range(b)]).reshape(v_t.shape)
        acc, m, l = _flash_tile_update(qr, k_t, v_t, pos[:, t0:t0 + bkv],
                                       qp, acc, m, l, causal=causal,
                                       window=window)
    out = acc / torch.clamp_min(l[..., None], 1e-30)
    return out.reshape(b, 1, h, d).to(v.dtype)


def smem_bytes(g: int, d: int, tile: int, tiles_per_split: int,
               dtype) -> int:
    """Dynamic shared memory of one K3 or K4 block, whose split holds up
    to ``tiles_per_split`` tiles of ``tile`` slots (see decode_tile.cuh)."""
    dw, ns = d // packing(dtype), tile * tiles_per_split
    return 4 * (2 * ns * dw + g * dw + g * ns + 2 * g + 3 * g * tiles_per_split
                + ns + 2 * tiles_per_split)


def faulty_decode_attention(q, k, v, pos, *, q_pos, k_tables,
                            v_tables, k_word0: int, v_word0: int,
                            causal: bool = True, window: int = 0,
                            scale=None, seed: int, method: str,
                            words_per_row_log2: int, ecc: bool,
                            inject: bool, bkv=None,
                            words_log2: int = BLOCK_WORDS_LOG2):
    """Decode attention over a ring cache with read-path injection.

    q: (B, 1, H, D); k, v: (B, L, KH, D) in their stored layout (one
    layer's slice of a stacked leaf is read in place); pos: (B, L) int32
    (-1 = empty); q_pos: (B,) int32 decode positions on the device (an int
    or a one-element tensor serves every row).  k_tables / v_tables:
    ``(block_base, block_thr)`` int32 tables of the leaf at ``words_log2``
    granularity, thresholds at the current voltage.  k_word0 / v_word0:
    word offset of this slice within its leaf.  Ring slot ``q_pos % L`` of
    each row, the slot written this step, is exempt from corruption.
    Returns (B, 1, H, D) in v.dtype.

    CPU tensors take :func:`faulty_decode_attention_ref`; CUDA tensors
    launch the K3 kernel (one launch, the ring split across blocks by
    :func:`decode_splits`) or raise.
    """
    kw = dict(q_pos=q_pos, k_tables=k_tables, v_tables=v_tables,
              k_word0=k_word0, v_word0=v_word0, causal=causal,
              window=window, scale=scale, seed=seed, method=method,
              words_per_row_log2=words_per_row_log2, ecc=ecc,
              inject=inject, bkv=bkv, words_log2=words_log2)
    if q.device.type == "cpu":
        return faulty_decode_attention_ref(q, k, v, pos, **kw)
    if q.device.type != "cuda":
        raise ValueError(f"faulty_decode_attention: unsupported device "
                         f"{q.device}")
    b, h, d, length, kh, g, k_wps, v_wps, bkv = _geometry(q, k, v, bkv)
    if not (q.dtype == k.dtype == v.dtype) or k.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"K3 takes bf16 or f32 q/k/v of one dtype, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if pos.dtype != torch.int32 or tuple(pos.shape) != (b, length):
        raise TypeError(f"pos must be int32 (B, L), got {pos.dtype} "
                        f"{tuple(pos.shape)}")
    qp = _row_positions(q_pos, b, q.device)
    tabs = [t for pair in (k_tables, v_tables) for t in pair]
    for t in (q, k, v, pos, qp, *tabs):
        if t.device != q.device:
            raise ValueError("K3 operands must share one device")
        if not t.is_contiguous():
            raise ValueError("K3 operands must be contiguous")
    if any(t.dtype != torch.int32 for t in tabs):
        raise TypeError("block tables must be int32 bit patterns")
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("K/V slices must be 16-byte aligned")
    if (d // packing(k.dtype)) % 4:
        raise ValueError("K3 reads head rows as 16-byte groups: head_dim "
                         "must fill a multiple of 4 words")
    tps, n_splits = decode_splits(length, bkv)
    smem = smem_bytes(g, d, bkv, tps, k.dtype)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"K3 split of {tps} tiles of {bkv} slots needs "
                         f"{smem} B of shared memory; pass a smaller bkv")
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}")
    scale = float(d ** -0.5 if scale is None else scale)
    out = torch.empty((b, 1, h, d), dtype=v.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    tickets, part = _workspace(q.device, stream, b, kh, n_splits, g, d)
    fn = _build.kernel("faulty_decode")
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
             qp.data_ptr(), out.data_ptr(), part.data_ptr(),
             tickets.data_ptr(), k_tables[0].data_ptr(),
             k_tables[1].data_ptr(), k_tables[0].shape[0],
             v_tables[0].data_ptr(), v_tables[1].data_ptr(),
             v_tables[0].shape[0], int(k_word0) & H.MASK,
             int(v_word0) & H.MASK, b, length, kh, g, d, bkv, tps, n_splits,
             int(causal), int(window), scale, int(seed) & H.MASK,
             int(words_per_row_log2), int(words_log2),
             2 if ecc else METHODS[method], int(inject),
             _KERNEL_DTYPES[k.dtype], stream)
    _build.check("faulty_decode", err)
    return out


# ---------------------------------------------------------------------------
# K4: batched decode over a page-pool cache
# ---------------------------------------------------------------------------


def _paged_geometry(q, k_pool, v_pool, pos_pool, page_table):
    s, sq, h, d = q.shape
    n, ps, kh, _ = k_pool.shape
    if sq != 1:
        raise ValueError("paged kernel is decode-specialized (S == 1)")
    if h % kh:
        raise ValueError(f"{h} query heads do not group over {kh} KV heads")
    if tuple(v_pool.shape) != tuple(k_pool.shape):
        raise ValueError(f"k/v pools differ: {tuple(k_pool.shape)} vs "
                         f"{tuple(v_pool.shape)}")
    if tuple(pos_pool.shape) != (n, ps):
        raise ValueError(f"pos pool {tuple(pos_pool.shape)} != {(n, ps)}")
    if page_table.dim() != 2 or page_table.shape[0] != s:
        raise ValueError(f"page table {tuple(page_table.shape)} for {s} "
                         "slots")
    return s, h, d, n, ps, kh, h // kh, page_table.shape[1]


def paged_decode_attention_ref(q, k_pool, v_pool, pos_pool, page_table, *,
                               q_pos, k_tables, v_tables,
                               causal: bool = True, window: int = 0,
                               scale=None, seed: int, method: str,
                               words_per_row_log2: int, ecc: bool,
                               inject: bool, telemetry: bool = False):
    """Plain PyTorch version of :func:`paged_decode_attention`: page by
    page, each page one tile of the online softmax, with the tile update
    of :func:`faulty_decode_attention_ref`."""
    if telemetry and not (ecc and inject):
        raise ValueError("telemetry output requires ecc=True, inject=True")
    s, h, d, _, ps, kh, g, n_lp = _paged_geometry(q, k_pool, v_pool,
                                                  pos_pool, page_table)
    length = n_lp * ps
    scale = float(d ** -0.5 if scale is None else scale)
    dev = q.device
    qp = _row_positions(q_pos, s, dev)
    clean = torch.remainder(qp, length)[:, None]
    qr = (q[:, 0].float() * scale).reshape(s, kh, g, d)
    acc = torch.zeros((s, kh, g, d), dtype=torch.float32, device=dev)
    m = torch.full((s, kh, g), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((s, kh, g), dtype=torch.float32, device=dev)
    counts = (torch.zeros((s, n_lp), dtype=torch.int32, device=dev)
              if telemetry else None)
    ptab = page_table.long()
    for lp in range(n_lp):
        pid = ptab[:, lp]
        k_t, v_t, pos_t = k_pool[pid], v_pool[pid], pos_pool[pid]
        if inject:
            slot_ids = (lp * ps + torch.arange(ps, device=dev))[None, :]
            kw = dict(seed=seed, method=method,
                      words_per_row_log2=words_per_row_log2, ecc=ecc,
                      slot_ids=slot_ids, clean_slot=clean,
                      with_counts=telemetry)
            tiles = []
            for t, (base, thr) in ((k_t, k_tables), (v_t, v_tables)):
                rows = thr[pid]
                out = corrupt_page_tile(
                    t.reshape(s, ps, kh * d), base[pid],
                    tuple(rows[:, c] for c in range(rows.shape[1])), **kw)
                tiles.append(out)
            if telemetry:
                (k_t, k_corr), (v_t, v_corr) = tiles
                counts[:, lp] = k_corr + v_corr
            else:
                k_t, v_t = tiles
            k_t = k_t.reshape(s, ps, kh, d)
            v_t = v_t.reshape(s, ps, kh, d)
        acc, m, l = _flash_tile_update(qr, k_t, v_t, pos_t, qp, acc, m, l,
                                       causal=causal, window=window)
    out = (acc / torch.clamp_min(l[..., None], 1e-30)).reshape(s, 1, h, d)
    out = out.to(v_pool.dtype)
    return (out, counts) if telemetry else out


def paged_decode_attention(q, k_pool, v_pool, pos_pool, page_table, *,
                           q_pos, k_tables, v_tables, causal: bool = True,
                           window: int = 0, scale=None, seed: int,
                           method: str, words_per_row_log2: int, ecc: bool,
                           inject: bool, telemetry: bool = False):
    """Batched decode attention of every serving slot over its own ring
    cache stored in pool pages.

    q: (S, 1, H, D), one decode query per slot; k_pool, v_pool: (N, PS,
    KH, D), this layer's page pool; pos_pool: (N, PS) int32; page_table:
    (S, n_lp) int32 physical page of each slot's logical page (the ring
    length is ``n_lp * PS``, so a narrower table gives a window ring);
    q_pos: (S,) int32 decode positions.  k_tables / v_tables:
    ``(page_base, page_thr)`` int32 tables of this layer's leaf slice,
    thresholds at the current voltage.  ``telemetry`` (ECC read path)
    also returns (S, n_lp) int32 corrected-codeword counts.  Returns
    (S, 1, H, D) in v.dtype (and the counts).

    CPU tensors take :func:`paged_decode_attention_ref`; CUDA tensors
    launch the K4 kernel (one launch, the ring split across blocks by
    :func:`decode_splits` with a tile of one page) or raise.
    """
    kw = dict(q_pos=q_pos, k_tables=k_tables, v_tables=v_tables,
              causal=causal, window=window, scale=scale, seed=seed,
              method=method, words_per_row_log2=words_per_row_log2, ecc=ecc,
              inject=inject, telemetry=telemetry)
    if q.device.type == "cpu":
        return paged_decode_attention_ref(q, k_pool, v_pool, pos_pool,
                                          page_table, **kw)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention: unsupported device "
                         f"{q.device}")
    if telemetry and not (ecc and inject):
        raise ValueError("telemetry output requires ecc=True, inject=True")
    s, h, d, n, ps, kh, g, n_lp = _paged_geometry(q, k_pool, v_pool,
                                                  pos_pool, page_table)
    if not (q.dtype == k_pool.dtype == v_pool.dtype) or (
            k_pool.dtype not in _KERNEL_DTYPES):
        raise TypeError(f"K4 takes bf16 or f32 q/k/v of one dtype, got "
                        f"{q.dtype}/{k_pool.dtype}/{v_pool.dtype}")
    ptab = page_table.to(torch.int32).contiguous()
    qp = _row_positions(q_pos, s, q.device)
    tabs = [t for pair in (k_tables, v_tables) for t in pair]
    for t in (q, k_pool, v_pool, pos_pool, ptab, qp, *tabs):
        if t.device != q.device:
            raise ValueError("K4 operands must share one device")
        if not t.is_contiguous():
            raise ValueError("K4 operands must be contiguous")
    if pos_pool.dtype != torch.int32 or any(t.dtype != torch.int32
                                            for t in tabs):
        raise TypeError("pos pool and page tables must be int32")
    if any(t.shape[0] < n for t in tabs):
        raise ValueError(f"page tables shorter than the {n}-page pool")
    if k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise ValueError("K/V pools must be 16-byte aligned")
    if (d // packing(k_pool.dtype)) % 4:
        raise ValueError("K4 reads head rows as 16-byte groups: head_dim "
                         "must fill a multiple of 4 words")
    tps, n_splits = decode_splits(n_lp * ps, ps)
    smem = smem_bytes(g, d, ps, tps, k_pool.dtype)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"K4 split of {tps} pages of {ps} slots needs "
                         f"{smem} B of shared memory")
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}")
    scale = float(d ** -0.5 if scale is None else scale)
    out = torch.empty((s, 1, h, d), dtype=v_pool.dtype, device=q.device)
    counts = (torch.zeros((s, n_lp), dtype=torch.int32, device=q.device)
              if telemetry else None)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    tickets, part = _workspace(q.device, stream, s, kh, n_splits, g, d)
    fn = _build.kernel("paged_decode")
    err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
             pos_pool.data_ptr(), ptab.data_ptr(), qp.data_ptr(),
             out.data_ptr(), counts.data_ptr() if telemetry else None,
             part.data_ptr(), tickets.data_ptr(),
             k_tables[0].data_ptr(), k_tables[1].data_ptr(),
             v_tables[0].data_ptr(), v_tables[1].data_ptr(), s, n_lp, ps,
             kh, g, d, tps, n_splits, int(causal), int(window), scale,
             int(seed) & H.MASK,
             int(words_per_row_log2), 2 if ecc else METHODS[method],
             int(inject), int(telemetry), _KERNEL_DTYPES[k_pool.dtype],
             stream)
    _build.check("paged_decode", err)
    return (out, counts) if telemetry else out

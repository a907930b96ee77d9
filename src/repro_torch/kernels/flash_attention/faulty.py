"""K3: decode attention with read-path fault injection -- CUDA kernel
wrapper, plain version and tile helpers.

Port of the contiguous half of
:mod:`repro.kernels.flash_attention.faulty`.  The CUDA kernel
(``csrc/faulty_decode.cu``) replaces the TPU kernel
``repro/kernels/flash_attention/faulty.py::faulty_decode_attention``; its
source comment says what bounds it on the H100 and how its design
answers that.

K/V words are corrupted as they are loaded, addressed through the leaf's
arena block tables, with the mask math of the arena engine -- so
read-path corruption equals corrupt-then-attend on the same operands.
The slot written this step (``clean_slot``) keeps its stored value.
With ``inject=False`` this is plain decode flash attention; the
write-path serving modes use it so every mode shares one set of
attention numerics.
"""
from __future__ import annotations

import torch

from repro_torch.core import hashing as H
from repro_torch.kernels import _build
from repro_torch.kernels.bitflip.bitflip import (BLOCK_WORDS,
                                                 BLOCK_WORDS_LOG2, METHODS,
                                                 apply_masks,
                                                 select_block_tables)
from repro_torch.kernels.ecc.ecc import arena_ecc_codewords

NEG_INF = -1e30

# Per-tile word cap (the reference's tile-size rule).
TILE_WORD_CAP = 16 * BLOCK_WORDS
# Shared memory one CUDA block may use on Hopper.
_SMEM_LIMIT = 227 * 1024
_KERNEL_DTYPES = {torch.bfloat16: 2, torch.float32: 4}


def packing(dtype) -> int:
    """Elements per uint32 word for a cache dtype."""
    itemsize = torch.empty((), dtype=dtype).element_size()
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


def pick_bkv(length: int, words_per_slot: int,
             cap: int = TILE_WORD_CAP) -> int:
    """Largest divisor of the cache length whose tile fits the word cap."""
    best = 1
    for c in range(1, length + 1):
        if length % c == 0 and c * words_per_slot <= cap:
            best = c
    return best


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


def _flash_tile_update(qr, k_t, v_t, pos_t, q_pos: int, acc, m, l, *,
                       causal: bool, window: int):
    """One flash-decode accumulator update over a (B, bkv, KH, D) tile.

    ``qr``: (B, KH, G, D) scaled f32 queries; ``acc`` (B, KH, G, D), ``m``
    and ``l`` (B, KH, G) running state.  Returns the new (acc, m, l)."""
    s = torch.einsum("bkgd,bnkd->bkgn", qr, k_t.float())
    delta = int(q_pos) - pos_t                      # int32, wraps like jnp
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
    acc = acc * corr[..., None] + torch.einsum("bkgn,bnkd->bkgd", p,
                                                v_t.float())
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


def faulty_decode_attention_ref(q, k, v, pos, *, q_pos: int, k_tables,
                                v_tables, k_word0: int, v_word0: int,
                                causal: bool = True, window: int = 0,
                                scale=None, seed: int, method: str,
                                words_per_row_log2: int, ecc: bool,
                                inject: bool, clean_slot=None, bkv=None,
                                words_log2: int = BLOCK_WORDS_LOG2):
    """Plain PyTorch version of :func:`faulty_decode_attention`, tile by
    tile with the reference's tile semantics."""
    b, h, d, length, kh, g, k_wps, v_wps, bkv = _geometry(q, k, v, bkv)
    scale = float(d ** -0.5 if scale is None else scale)
    dev = q.device
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
                      slot_ids=slot_ids, clean_slot=clean_slot,
                      words_log2=words_log2)
            k_t = torch.stack([corrupt_kv_tile(
                k_t[i].reshape(bkv, kh * d),
                k_word0 + (i * length + t0) * k_wps, *k_tables, **kw)
                for i in range(b)]).reshape(k_t.shape)
            v_t = torch.stack([corrupt_kv_tile(
                v_t[i].reshape(bkv, kh * d),
                v_word0 + (i * length + t0) * v_wps, *v_tables, **kw)
                for i in range(b)]).reshape(v_t.shape)
        acc, m, l = _flash_tile_update(qr, k_t, v_t, pos[:, t0:t0 + bkv],
                                       q_pos, acc, m, l, causal=causal,
                                       window=window)
    out = acc / torch.clamp_min(l[..., None], 1e-30)
    return out.reshape(b, 1, h, d).to(v.dtype)


def smem_bytes(g: int, d: int, bkv: int, dtype) -> int:
    """Dynamic shared memory of one K3 block (see faulty_decode.cu)."""
    dw = d // packing(dtype)
    return 4 * (2 * g * d + g * bkv + 3 * g + bkv + 2 * bkv * (dw + 1))


def faulty_decode_attention(q, k, v, pos, *, q_pos: int, k_tables,
                            v_tables, k_word0: int, v_word0: int,
                            causal: bool = True, window: int = 0,
                            scale=None, seed: int, method: str,
                            words_per_row_log2: int, ecc: bool,
                            inject: bool, clean_slot=None, bkv=None,
                            words_log2: int = BLOCK_WORDS_LOG2):
    """Decode attention over a ring cache with read-path injection.

    q: (B, 1, H, D); k, v: (B, L, KH, D) in their stored layout (one
    layer's slice of a stacked leaf is read in place); pos: (B, L) int32
    (-1 = empty).  k_tables / v_tables: ``(block_base, block_thr)`` int32
    tables of the leaf at ``words_log2`` granularity, thresholds at the
    current voltage.  k_word0 / v_word0: word offset of this slice within
    its leaf.  clean_slot: slot exempt from corruption, or None.
    Returns (B, 1, H, D) in v.dtype.

    CPU tensors take :func:`faulty_decode_attention_ref`; CUDA tensors
    launch the K3 kernel (one launch) or raise.
    """
    kw = dict(q_pos=q_pos, k_tables=k_tables, v_tables=v_tables,
              k_word0=k_word0, v_word0=v_word0, causal=causal,
              window=window, scale=scale, seed=seed, method=method,
              words_per_row_log2=words_per_row_log2, ecc=ecc,
              inject=inject, clean_slot=clean_slot, bkv=bkv,
              words_log2=words_log2)
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
    tabs = [t for pair in (k_tables, v_tables) for t in pair]
    for t in (q, k, v, pos, *tabs):
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
    if smem_bytes(g, d, bkv, k.dtype) > _SMEM_LIMIT:
        raise ValueError(f"K3 tile of {bkv} slots needs "
                         f"{smem_bytes(g, d, bkv, k.dtype)} B of shared "
                         "memory; pass a smaller bkv")
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}")
    scale = float(d ** -0.5 if scale is None else scale)
    out = torch.empty((b, 1, h, d), dtype=v.dtype, device=q.device)
    fn = _build.kernel("faulty_decode")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
             out.data_ptr(), k_tables[0].data_ptr(), k_tables[1].data_ptr(),
             k_tables[0].shape[0], v_tables[0].data_ptr(),
             v_tables[1].data_ptr(), v_tables[0].shape[0],
             int(k_word0) & H.MASK, int(v_word0) & H.MASK, b, length, kh, g,
             d, bkv, int(q_pos), -1 if clean_slot is None else int(clean_slot),
             int(causal), int(window), scale, int(seed) & H.MASK,
             int(words_per_row_log2), int(words_log2),
             2 if ecc else METHODS[method], int(inject),
             _KERNEL_DTYPES[k.dtype], stream)
    _build.check("faulty_decode", err)
    return out

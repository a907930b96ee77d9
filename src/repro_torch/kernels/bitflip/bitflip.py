"""K1 and K5: stuck-at injection -- CUDA kernel wrappers and plain versions.

Port of :mod:`repro.kernels.bitflip.bitflip`.  Two CUDA kernels replace
its two TPU kernels; each source comment says what bounds it on the H100
and how its design answers that:

  * K1 (``csrc/arena_bitflip.cu``, :func:`arena_bitflip`) replaces
    ``arena_bitflip_pallas``: a whole domain arena in one pass.
  * K5 (``csrc/segment_bitflip.cu``, :func:`bitflip`) replaces
    ``bitflip_pallas``: one contiguous physical run of words from one
    threshold row (the legacy per-segment path and Algorithm 1).  The
    reference bakes thresholds, seed and base word into its trace; here
    they are runtime arguments, so one build serves every (voltage, PC).

The arena is a flat ``(num_blocks * BLOCK_WORDS,)`` int32 tensor (the
reference's ``(num_blocks * 8, 512)`` uint32 arena, flattened).  Block
``i`` starts at physical word ``block_base[i]`` and takes its thresholds
from row ``i`` of ``block_thr`` ``(num_blocks, NUM_THR_COLS)``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import faultmap as fm
from repro_torch.core import hashing as H
from repro_torch.kernels import _build
from repro_torch.kernels.bitflip import ref as _ref

BLOCK_WORDS = 4096
BLOCK_WORDS_LOG2 = BLOCK_WORDS.bit_length() - 1
METHODS = {"word": 0, "bitwise": 1}
# Arena blocks per step of the plain versions (bounds their int64
# temporaries).
_REF_CHUNK_BLOCKS = 1024
_REF_CHUNK_WORDS = _REF_CHUNK_BLOCKS * BLOCK_WORDS


def block_word_ids(base, n_words: int = BLOCK_WORDS):
    """Physical word id of every word of the blocks starting at ``base``
    (int64 values, shape ``base.shape + (n_words,)``)."""
    lane = torch.arange(n_words, dtype=torch.int64, device=base.device)
    return base[..., None] + lane


def arena_masks(wid, thr_row, *, seed: int, method: str,
                words_per_row_log2: int):
    """Stuck-at masks from one threshold-table row: ``thr_row`` indexes
    like a (NUM_THR_COLS,) sequence of int64 values or per-word tensors."""
    if method == "word":
        return _ref.word_masks(
            wid, seed,
            q01_weak=thr_row[fm.COL_Q01_WEAK],
            q01_strong=thr_row[fm.COL_Q01_STRONG],
            q10_weak=thr_row[fm.COL_Q10_WEAK],
            q10_strong=thr_row[fm.COL_Q10_STRONG],
            weak_row_q=thr_row[fm.COL_WEAK_ROW_Q],
            words_per_row_log2=words_per_row_log2)
    if method == "bitwise":
        return _ref.bitwise_masks(
            wid, seed,
            t01_weak=thr_row[fm.COL_T01_WEAK],
            t01_strong=thr_row[fm.COL_T01_STRONG],
            t10_weak=thr_row[fm.COL_T10_WEAK],
            t10_strong=thr_row[fm.COL_T10_STRONG],
            weak_row_q=thr_row[fm.COL_WEAK_ROW_Q],
            words_per_row_log2=words_per_row_log2)
    raise ValueError(f"unknown method {method!r}")


def apply_masks(x, wid, thr_row, *, seed: int, method: str,
                words_per_row_log2: int):
    """Corrupt words (int64 uint32 values) in place of their physical ids:
    ``(x | m01) & ~(m10 & ~m01)``."""
    mask01, mask10 = arena_masks(wid, thr_row, seed=seed, method=method,
                                 words_per_row_log2=words_per_row_log2)
    mask10 = mask10 & (mask01 ^ H.MASK)
    return (x | mask01) & (mask10 ^ H.MASK)


def select_block_tables(off, block_base, block_thr, *,
                        words_log2: int = BLOCK_WORDS_LOG2):
    """Physical word ids + per-word threshold columns for leaf word
    offsets ``off`` (int64): a direct gather ``block_base[off >> lg2]``.

    The reference needs candidate selects here because a TPU cannot
    gather scalar memory with a vector index; a gather is legal on the
    GPU.  Offsets past the table get base 0 and zero thresholds, as the
    reference's selects give them.  Returns ``(wid, thr_cols)``: int64
    values and a NUM_THR_COLS tuple of int64 tensors shaped like ``off``.
    """
    j = off >> words_log2
    nb = block_base.shape[0]
    valid = j < nb
    jc = torch.clamp(j, max=nb - 1)
    zero = torch.zeros((), dtype=torch.int64, device=off.device)
    base = torch.where(valid, H.as_u64(block_base)[jc], zero)
    rows = torch.where(valid[..., None], H.as_u64(block_thr)[jc], zero)
    wid = base + (off & ((1 << words_log2) - 1))
    return wid, tuple(rows[..., c] for c in range(fm.NUM_THR_COLS))


def _check_arena(arena, block_base, block_thr):
    nb = block_base.shape[0]
    if arena.dtype != torch.int32 or arena.dim() != 1:
        raise TypeError(f"arena must be a flat int32 tensor, got "
                        f"{arena.dtype} {tuple(arena.shape)}")
    if arena.shape[0] != nb * BLOCK_WORDS:
        raise ValueError(f"arena holds {arena.shape[0]} words, tables "
                         f"describe {nb} blocks of {BLOCK_WORDS}")
    if block_base.dtype != torch.int32 or block_thr.dtype != torch.int32:
        raise TypeError("block tables must be int32 bit patterns")
    if tuple(block_thr.shape) != (nb, fm.NUM_THR_COLS):
        raise ValueError(f"block_thr shape {tuple(block_thr.shape)}")
    devs = {arena.device, block_base.device, block_thr.device}
    if len(devs) != 1:
        raise ValueError(f"arena and tables on different devices {devs}")


def arena_bitflip_ref(arena, block_base, block_thr, *, seed: int,
                      method: str, words_per_row_log2: int):
    """Plain PyTorch version of :func:`arena_bitflip`: same operands, same
    bits (blocks processed in chunks to bound the int64 temporaries)."""
    _check_arena(arena, block_base, block_thr)
    nb = block_base.shape[0]
    x = arena.view(nb, BLOCK_WORDS)
    out = torch.empty_like(x)
    base = H.as_u64(block_base)
    thr = H.as_u64(block_thr)
    for s in range(0, nb, _REF_CHUNK_BLOCKS):
        e = min(nb, s + _REF_CHUNK_BLOCKS)
        wid = block_word_ids(base[s:e])
        row = tuple(thr[s:e, c][:, None] for c in range(fm.NUM_THR_COLS))
        out[s:e] = H.as_i32(apply_masks(
            H.as_u64(x[s:e]), wid, row, seed=seed, method=method,
            words_per_row_log2=words_per_row_log2))
    return out.view(-1)


def arena_bitflip(arena, block_base, block_thr, *, seed: int, method: str,
                  words_per_row_log2: int):
    """Inject a whole domain arena in one pass; returns a new arena.

    CPU tensors take :func:`arena_bitflip_ref`; CUDA tensors launch the
    K1 kernel (one launch) or raise."""
    if arena.device.type == "cpu":
        return arena_bitflip_ref(arena, block_base, block_thr, seed=seed,
                                 method=method,
                                 words_per_row_log2=words_per_row_log2)
    if arena.device.type != "cuda":
        raise ValueError(f"arena_bitflip: unsupported device {arena.device}")
    _check_arena(arena, block_base, block_thr)
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}")
    arena = arena.contiguous()
    block_base = block_base.contiguous()
    block_thr = block_thr.contiguous()
    out = torch.empty_like(arena)
    fn = _build.kernel("arena_bitflip")
    stream = torch.cuda.current_stream(arena.device).cuda_stream
    err = fn(arena.data_ptr(), out.data_ptr(), block_base.data_ptr(),
             block_thr.data_ptr(), block_base.shape[0], int(seed) & H.MASK,
             METHODS[method], int(words_per_row_log2), stream)
    _build.check("arena_bitflip", err)
    return out


# KernelThresholds fields in threshold-table column order.
_ROW_FIELDS = ("q01_weak", "q01_strong", "q10_weak", "q10_strong",
               "weak_row_q", "t01_weak", "t01_strong", "t10_weak",
               "t10_strong", "par_q_weak", "par_q_strong")
assert all(getattr(fm, "COL_" + f.upper()) == i
           for i, f in enumerate(_ROW_FIELDS))


def threshold_row(thr) -> tuple:
    """A :class:`~repro_torch.core.faultmap.KernelThresholds` as its
    NUM_THR_COLS threshold-table row (Python ints, column order)."""
    return tuple(int(getattr(thr, f)) & H.MASK for f in _ROW_FIELDS)


def check_segment(data):
    if data.dtype != torch.int32 or data.dim() != 1:
        raise TypeError(f"segment must be a flat int32 tensor, got "
                        f"{data.dtype} {tuple(data.shape)}")


def bitflip_ref(data, *, thresholds, seed: int, base_word: int,
                method: str):
    """Plain PyTorch version of :func:`bitflip`: same operands, same bits
    (words processed in chunks to bound the int64 temporaries)."""
    check_segment(data)
    out = torch.empty_like(data)
    for s in range(0, data.shape[0], _REF_CHUNK_WORDS):
        e = min(data.shape[0], s + _REF_CHUNK_WORDS)
        out[s:e] = _ref.inject_u32_ref(data[s:e], thresholds=thresholds,
                                       seed=seed, base_word=base_word + s,
                                       method=method)
    return out


def bitflip(data, *, thresholds, seed: int, base_word: int, method: str):
    """Inject one contiguous physical run: word i of the flat int32
    ``data`` sits at physical id ``base_word + i`` (mod 2**32) and every
    word takes ``thresholds`` (one PC at one voltage).  Any length; the
    kernel guards the tail, which equals the reference's zero padding to
    whole blocks followed by slicing.  Returns a new tensor.

    CPU tensors take :func:`bitflip_ref`; CUDA tensors launch the K5
    kernel (one launch) or raise."""
    if data.device.type == "cpu":
        return bitflip_ref(data, thresholds=thresholds, seed=seed,
                           base_word=base_word, method=method)
    if data.device.type != "cuda":
        raise ValueError(f"bitflip: unsupported device {data.device}")
    check_segment(data)
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}")
    data = data.contiguous()
    out = torch.empty_like(data)
    if data.shape[0] == 0:
        return out
    row = (ctypes.c_uint * fm.NUM_THR_COLS)(*threshold_row(thresholds))
    fn = _build.kernel("segment_bitflip")
    stream = torch.cuda.current_stream(data.device).cuda_stream
    err = fn(data.data_ptr(), out.data_ptr(), data.shape[0],
             int(base_word) & H.MASK, row, int(seed) & H.MASK,
             METHODS[method], int(thresholds.words_per_row_log2), stream)
    _build.check("segment_bitflip", err)
    return out

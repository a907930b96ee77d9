"""K2 and K6: fused injection + SECDED -- CUDA kernel wrappers and plain
versions.

Port of :mod:`repro.kernels.ecc.ecc`.  Two CUDA kernels replace its two
TPU kernels; each source comment says what bounds it on the H100 and how
its design answers that:

  * K2 (``csrc/arena_ecc.cu``, :func:`arena_ecc`) replaces
    ``arena_ecc_pallas``.  Operands as
    :func:`repro_torch.kernels.bitflip.bitflip.arena_bitflip`, plus
    per-block uncorrectable and corrected codeword counts.
  * K2's count-only entry (``launch_arena_ecc_events`` in the same
    source, :func:`ecc_page_events`): per-page SECDED event counts over a
    K/V pool leaf, writing nothing -- the self-healing scheduler's
    telemetry scrub, which the reference runs in plain jnp.
  * K6 (``csrc/segment_ecc.cu``, :func:`segment_ecc`) replaces
    ``ecc_pallas``: one contiguous physical run from one threshold row,
    with per-block uncorrectable counts over the run zero-padded to whole
    blocks.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import faultmap as fm
from repro_torch.core import hashing as H
from repro_torch.kernels import _build
from repro_torch.kernels.bitflip.bitflip import (BLOCK_WORDS, _REF_CHUNK_BLOCKS,
                                                 _REF_CHUNK_WORDS, _check_arena,
                                                 block_word_ids, check_segment,
                                                 threshold_row)
from repro_torch.kernels.bitflip.ref import segment_word_ids
from repro_torch.kernels.ecc import ref as _ref


def arena_ecc_events(x, wid, thr_row, *, seed: int,
                     words_per_row_log2: int):
    """Fused inject+correct+telemetry from one threshold row: returns
    (out, corrected_bool, uncorrectable_bool) per codeword."""
    return _ref.ecc_codeword_events(
        x, wid, seed,
        q01_weak=thr_row[fm.COL_Q01_WEAK],
        q01_strong=thr_row[fm.COL_Q01_STRONG],
        q10_weak=thr_row[fm.COL_Q10_WEAK],
        q10_strong=thr_row[fm.COL_Q10_STRONG],
        weak_row_q=thr_row[fm.COL_WEAK_ROW_Q],
        par_q_weak=thr_row[fm.COL_PAR_Q_WEAK],
        par_q_strong=thr_row[fm.COL_PAR_Q_STRONG],
        words_per_row_log2=words_per_row_log2)


def arena_ecc_codewords(x, wid, thr_row, *, seed: int,
                        words_per_row_log2: int):
    """Fused inject+correct: (out, uncorrectable_bool per codeword)."""
    out, _, uncorrectable = arena_ecc_events(
        x, wid, thr_row, seed=seed, words_per_row_log2=words_per_row_log2)
    return out, uncorrectable


def arena_ecc_ref(arena, block_base, block_thr, *, seed: int,
                  words_per_row_log2: int):
    """Plain PyTorch version of :func:`arena_ecc`: (out, bad, corr) with
    per-block int32 counts."""
    _check_arena(arena, block_base, block_thr)
    nb = block_base.shape[0]
    x = arena.view(nb, BLOCK_WORDS)
    out = torch.empty_like(x)
    bad = torch.empty(nb, dtype=torch.int32, device=arena.device)
    corr = torch.empty(nb, dtype=torch.int32, device=arena.device)
    base = H.as_u64(block_base)
    thr = H.as_u64(block_thr)
    for s in range(0, nb, _REF_CHUNK_BLOCKS):
        e = min(nb, s + _REF_CHUNK_BLOCKS)
        row = tuple(thr[s:e, c][:, None] for c in range(fm.NUM_THR_COLS))
        o, c, u = arena_ecc_events(H.as_u64(x[s:e]), block_word_ids(base[s:e]),
                                   row, seed=seed,
                                   words_per_row_log2=words_per_row_log2)
        out[s:e] = H.as_i32(o)
        bad[s:e] = u.sum(-1).to(torch.int32)
        corr[s:e] = c.sum(-1).to(torch.int32)
    return out.view(-1), bad, corr


def arena_ecc(arena, block_base, block_thr, *, seed: int,
              words_per_row_log2: int):
    """Fused inject+SECDED over a whole domain arena in one pass.

    Returns (new arena, per-block uncorrectable counts, per-block
    corrected counts).  CPU tensors take :func:`arena_ecc_ref`; CUDA
    tensors launch the K2 kernel (one launch) or raise."""
    if arena.device.type == "cpu":
        return arena_ecc_ref(arena, block_base, block_thr, seed=seed,
                             words_per_row_log2=words_per_row_log2)
    if arena.device.type != "cuda":
        raise ValueError(f"arena_ecc: unsupported device {arena.device}")
    _check_arena(arena, block_base, block_thr)
    arena = arena.contiguous()
    block_base = block_base.contiguous()
    block_thr = block_thr.contiguous()
    nb = block_base.shape[0]
    out = torch.empty_like(arena)
    bad = torch.empty(nb, dtype=torch.int32, device=arena.device)
    corr = torch.empty(nb, dtype=torch.int32, device=arena.device)
    fn = _build.kernel("arena_ecc")
    stream = torch.cuda.current_stream(arena.device).cuda_stream
    err = fn(arena.data_ptr(), out.data_ptr(), block_base.data_ptr(),
             block_thr.data_ptr(), bad.data_ptr(), corr.data_ptr(), nb,
             int(seed) & H.MASK, int(words_per_row_log2), stream)
    _build.check("arena_ecc", err)
    return out, bad, corr


def _check_pages(words, page_base, page_thr, referenced):
    if words.dtype != torch.int32 or words.dim() != 3:
        raise TypeError(f"words must be (n_layers, total_pages, page_words) "
                        f"int32, got {words.dtype} {tuple(words.shape)}")
    nl, tp, pw = words.shape
    if pw % 2 or pw & (pw - 1):
        raise ValueError(f"page_words={pw} must be an even power of two "
                         "(whole codewords, a divisor of the arena block)")
    if (tuple(page_base.shape) != (nl, tp)
            or tuple(page_thr.shape) != (nl, tp, fm.NUM_THR_COLS)
            or page_base.dtype != torch.int32
            or page_thr.dtype != torch.int32):
        raise ValueError(
            f"page tables {tuple(page_base.shape)} {page_base.dtype} / "
            f"{tuple(page_thr.shape)} {page_thr.dtype} do not describe "
            f"{nl} x {tp} int32 pages")
    if tuple(referenced.shape) != (tp,) or referenced.dtype != torch.bool:
        raise ValueError(f"referenced must be ({tp},) bool, got "
                         f"{referenced.dtype} {tuple(referenced.shape)}")


def ecc_page_events_ref(words, page_base, page_thr, referenced, *,
                        seed: int, words_per_row_log2: int):
    """Plain PyTorch version of :func:`ecc_page_events`, on
    :func:`repro_torch.core.engine.ecc_event_counts` one layer at a time."""
    from repro_torch.core.engine import ecc_event_counts
    _check_pages(words, page_base, page_thr, referenced)
    nl, tp, pw = words.shape
    dev = words.device
    off = torch.arange(tp * pw, dtype=torch.int64, device=dev).view(tp, pw)
    corr = torch.zeros(tp, dtype=torch.int64, device=dev)
    bad = torch.zeros(tp, dtype=torch.int64, device=dev)
    for l in range(nl):
        c, u = ecc_event_counts(words[l], off, page_base[l], page_thr[l],
                                seed=seed,
                                words_per_row_log2=words_per_row_log2,
                                words_log2=pw.bit_length() - 1)
        corr += c.sum(-1)
        bad += u.sum(-1)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    return (torch.where(referenced, corr, zero).to(torch.int32),
            torch.where(referenced, bad, zero).to(torch.int32))


def ecc_page_events(words, page_base, page_thr, referenced, *, seed: int,
                    words_per_row_log2: int):
    """Per-page SECDED event counts over one K/V pool leaf, read-only.

    ``words``: the leaf as (n_layers, total_pages, page_words) int32;
    ``page_base`` / ``page_thr``: each (layer, page) slice's physical base
    word and threshold row; ``referenced``: (total_pages,) bool.  Returns
    (corrected, uncorrectable) codewords per page over every layer,
    (total_pages,) int32, 0 for pages not referenced.  CPU tensors take
    :func:`ecc_page_events_ref`; CUDA tensors launch K2's count-only entry
    (one launch) or raise."""
    if words.device.type == "cpu":
        return ecc_page_events_ref(words, page_base, page_thr, referenced,
                                   seed=seed,
                                   words_per_row_log2=words_per_row_log2)
    if words.device.type != "cuda":
        raise ValueError(f"ecc_page_events: unsupported device "
                         f"{words.device}")
    _check_pages(words, page_base, page_thr, referenced)
    nl, tp, pw = words.shape
    words = words.contiguous()
    page_base = page_base.contiguous()
    page_thr = page_thr.contiguous()
    referenced = referenced.contiguous()
    corr = torch.zeros(tp, dtype=torch.int32, device=words.device)
    bad = torch.zeros(tp, dtype=torch.int32, device=words.device)
    fn = _build.kernel("arena_ecc_events")
    stream = torch.cuda.current_stream(words.device).cuda_stream
    err = fn(words.data_ptr(), page_base.data_ptr(), page_thr.data_ptr(),
             referenced.data_ptr(), corr.data_ptr(), bad.data_ptr(), nl, tp,
             pw, int(seed) & H.MASK, int(words_per_row_log2), stream)
    _build.check("arena_ecc_events", err)
    return corr, bad


def segment_ecc_ref(data, *, thresholds, seed: int, base_word: int):
    """Plain PyTorch version of :func:`segment_ecc`: the run zero-padded to
    whole blocks, as the reference's kernel route pads it."""
    check_segment(data)
    n = data.shape[0]
    padded = -(-n // BLOCK_WORDS) * BLOCK_WORDS
    out = torch.empty_like(data)
    bad = torch.empty(padded // BLOCK_WORDS, dtype=torch.int32,
                      device=data.device)
    for s in range(0, padded, _REF_CHUNK_WORDS):
        e = min(padded, s + _REF_CHUNK_WORDS)
        live = min(e, n) - s
        x = torch.zeros(e - s, dtype=torch.int64, device=data.device)
        x[:live] = H.as_u64(data[s:s + live])
        wid = segment_word_ids(e - s, base_word + s, data.device)
        o, u = _ref.ecc_codewords(x.view(-1, BLOCK_WORDS),
                                  wid.view(-1, BLOCK_WORDS), seed, thresholds)
        out[s:s + live] = H.as_i32(o.reshape(-1)[:live])
        bad[s // BLOCK_WORDS:e // BLOCK_WORDS] = u.sum(-1).to(torch.int32)
    return out, bad


def segment_ecc(data, *, thresholds, seed: int, base_word: int):
    """Fused inject+SECDED over one contiguous physical run: word i of the
    flat int32 ``data`` sits at physical id ``base_word + i`` (mod 2**32).

    Returns (new words, per-block uncorrectable counts, int32, one per
    4096-word block of the run zero-padded to whole blocks -- the
    reference's kernel route counts the padding's codewords too).  CPU
    tensors take :func:`segment_ecc_ref`; CUDA tensors launch the K6
    kernel (one launch) or raise."""
    if data.device.type == "cpu":
        return segment_ecc_ref(data, thresholds=thresholds, seed=seed,
                               base_word=base_word)
    if data.device.type != "cuda":
        raise ValueError(f"segment_ecc: unsupported device {data.device}")
    check_segment(data)
    data = data.contiguous()
    n = data.shape[0]
    out = torch.empty_like(data)
    bad = torch.empty(-(-n // BLOCK_WORDS), dtype=torch.int32,
                      device=data.device)
    if n == 0:
        return out, bad
    row = (ctypes.c_uint * fm.NUM_THR_COLS)(*threshold_row(thresholds))
    fn = _build.kernel("segment_ecc")
    stream = torch.cuda.current_stream(data.device).cuda_stream
    err = fn(data.data_ptr(), out.data_ptr(), bad.data_ptr(), n,
             int(base_word) & H.MASK, row, int(seed) & H.MASK,
             int(thresholds.words_per_row_log2), stream)
    _build.check("segment_ecc", err)
    return out, bad

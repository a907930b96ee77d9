"""Plain PyTorch SECDED(72,64) behavioural model (port of
:mod:`repro.kernels.ecc.ref`).

Each 64-bit codeword (two consecutive words) carries 8 parity bits that
fault like data bits, drawn once per codeword.  0 faults: unchanged; 1
fault: corrected (data restored); >= 2: uncorrectable, faulted data
passes through.  Word-path injection only.  Values are int64 tensors
holding uint32 words, as in :mod:`repro_torch.kernels.bitflip.ref`.
"""
from __future__ import annotations

import torch

from repro_torch.core import hashing as H
from repro_torch.kernels.bitflip.ref import (_weak_rows, segment_word_ids,
                                             word_masks)

STREAM_PARITY = 0x94D049BB


def popcount32(v):
    """SWAR popcount on int64 tensors holding uint32 values."""
    v = (v - ((v >> 1) & 0x55555555)) & H.MASK
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & H.MASK) >> 24


def _cw_vals(v, pair_shape):
    """Per-word threshold operand -> per-codeword (first word of each
    pair); scalars pass through."""
    if not torch.is_tensor(v) or v.dim() == 0:
        return v
    full = torch.broadcast_to(v, pair_shape[:-2] + (pair_shape[-2] * 2,))
    return full.reshape(pair_shape)[..., 0]


def ecc_codeword_events(data, wid, seed: int, *, q01_weak, q01_strong,
                        q10_weak, q10_strong, weak_row_q,
                        par_q_weak, par_q_strong, words_per_row_log2: int):
    """Returns (corrected data, corrected_bool, uncorrectable_bool) with
    one flag per codeword (the last axis must hold an even word count)."""
    mask01, mask10 = word_masks(
        wid, seed, q01_weak=q01_weak, q01_strong=q01_strong,
        q10_weak=q10_weak, q10_strong=q10_strong, weak_row_q=weak_row_q,
        words_per_row_log2=words_per_row_log2)
    mask10 = mask10 & (mask01 ^ H.MASK)
    faulted = (data | mask01) & (mask10 ^ H.MASK)
    fault_bits = faulted ^ data

    shape = tuple(data.shape)
    pair = shape[:-1] + (shape[-1] // 2, 2)
    fb = fault_bits.reshape(pair)
    counts = popcount32(fb[..., 0]) + popcount32(fb[..., 1])

    cw_wid = torch.broadcast_to(wid, shape).reshape(pair)[..., 0]
    weak = _weak_rows(cw_wid, seed, _cw_vals(weak_row_q, pair),
                      words_per_row_log2)
    q = torch.where(weak, _cw_vals(par_q_weak, pair),
                    _cw_vals(par_q_strong, pair))
    par_hit = H.hash_stream(seed, STREAM_PARITY, cw_wid >> 1) < q
    counts = counts + par_hit.to(torch.int64)

    corrected = counts == 1
    uncorrectable = counts >= 2
    keep_faulty = uncorrectable[..., None].expand(pair).reshape(shape)
    out = torch.where(keep_faulty, faulted, data)
    return out, corrected, uncorrectable


def ecc_codewords_vals(data, wid, seed: int, *, q01_weak, q01_strong,
                       q10_weak, q10_strong, weak_row_q, par_q_weak,
                       par_q_strong, words_per_row_log2: int):
    """Returns (corrected data, uncorrectable_bool per codeword)."""
    out, _, uncorrectable = ecc_codeword_events(
        data, wid, seed, q01_weak=q01_weak, q01_strong=q01_strong,
        q10_weak=q10_weak, q10_strong=q10_strong, weak_row_q=weak_row_q,
        par_q_weak=par_q_weak, par_q_strong=par_q_strong,
        words_per_row_log2=words_per_row_log2)
    return out, uncorrectable


def ecc_codewords(data, wid, seed: int, thr):
    """KernelThresholds wrapper (the legacy per-segment path) around
    :func:`ecc_codewords_vals`."""
    return ecc_codewords_vals(
        data, wid, seed, q01_weak=thr.q01_weak, q01_strong=thr.q01_strong,
        q10_weak=thr.q10_weak, q10_strong=thr.q10_strong,
        weak_row_q=thr.weak_row_q, par_q_weak=thr.par_q_weak,
        par_q_strong=thr.par_q_strong,
        words_per_row_log2=thr.words_per_row_log2)


def inject_and_correct_u32_ref(data_u32, *, thresholds, seed: int,
                               base_word: int):
    """Oracle for one run of an even number of int32 words at physical
    ids ``base_word + i``: (corrected int32 words, uncorrectable codeword
    count as a 0-d int64 tensor)."""
    n = data_u32.shape[0]
    if n % 2:
        raise ValueError("ECC reference needs an even word count")
    wid = segment_word_ids(n, base_word, data_u32.device)
    out, bad = ecc_codewords(H.as_u64(data_u32), wid, seed, thresholds)
    return H.as_i32(out), bad.sum(dtype=torch.int64)

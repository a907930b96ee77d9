"""Plain PyTorch stuck-at mask math (port of :mod:`repro.kernels.bitflip.ref`).

Integer-only, bit-exact with the reference and with the CUDA kernels'
``csrc/fault_masks.cuh``.  Word ids, data and thresholds are int64
tensors (or Python ints) holding uint32 values; see
:mod:`repro_torch.core.hashing` for why.

  * ``word``: a word is "hit" with probability min(1, 32 p) and a hit word
    gets one stuck bit at a hashed position (exact to O((32 p)^2)).
  * ``bitwise``: exact per-bit Bernoulli via 20 bit-sliced hashed planes.
"""
from __future__ import annotations

import torch

from repro_torch.core import hashing as H

PLANES = H.PLANES
_FULL = H.MASK


def _weak_rows(wid, seed: int, weak_row_q, words_per_row_log2: int):
    row = wid >> words_per_row_log2
    return H.hash_stream(seed, H.STREAM_ROW, row) < weak_row_q


def word_masks(wid, seed: int, *, q01_weak, q01_strong, q10_weak,
               q10_strong, weak_row_q, words_per_row_log2: int):
    """Stuck-at masks for the word-hit fast path (int64 uint32 values)."""
    weak = _weak_rows(wid, seed, weak_row_q, words_per_row_log2)
    q01 = torch.where(weak, q01_weak, q01_strong)
    q10 = torch.where(weak, q10_weak, q10_strong)
    hit01 = H.hash_stream(seed, H.STREAM_WORD_01, wid) < q01
    hit10 = H.hash_stream(seed, H.STREAM_WORD_10, wid) < q10
    pos01 = H.hash_stream(seed, H.STREAM_BITPOS_01, wid) & 31
    pos10 = H.hash_stream(seed, H.STREAM_BITPOS_10, wid) & 31
    zero = torch.zeros((), dtype=torch.int64, device=wid.device)
    mask01 = torch.where(hit01, torch.ones_like(pos01) << pos01, zero)
    mask10 = torch.where(hit10, torch.ones_like(pos10) << pos10, zero)
    return mask01, mask10


def _plane(seed: int, j: int, direction: int, wid):
    """Random 32-lane bit plane j for one flip direction."""
    plane_seed = H.mix32_int(int(seed) ^ (2 * j + direction + 1))
    return H.hash_stream(plane_seed, H.STREAM_BITPLANE, wid)


def _bitwise_lt(plane, t):
    """Bit-sliced per-lane compare: lane's PLANES-bit uniform < t.

    ``plane(j)`` returns bit-plane j (every lane's bit j); ``t`` holds a
    PLANES-bit threshold per word.  Planes are drawn one at a time, so the
    plain version never holds all twenty at once."""
    lt = torch.zeros_like(t)
    eq = torch.full_like(t, _FULL)
    for j in range(PLANES - 1, -1, -1):
        tmask = (0 - ((t >> j) & 1)) & _FULL    # all-ones if bit set
        b = plane(j)
        lt = lt | (eq & (b ^ _FULL) & tmask)
        eq = eq & (b ^ tmask ^ _FULL)
    return lt


def bitwise_masks(wid, seed: int, *, t01_weak, t01_strong, t10_weak,
                  t10_strong, weak_row_q, words_per_row_log2: int):
    """Exact per-bit stuck-at masks (PLANES-bit probability resolution)."""
    weak = _weak_rows(wid, seed, weak_row_q, words_per_row_log2)
    t01 = torch.where(weak, t01_weak, t01_strong)
    t10 = torch.where(weak, t10_weak, t10_strong)
    if not torch.is_tensor(t01) or t01.shape != wid.shape:
        t01 = torch.broadcast_to(torch.as_tensor(t01), wid.shape)
        t10 = torch.broadcast_to(torch.as_tensor(t10), wid.shape)
    mask01 = _bitwise_lt(lambda j: _plane(seed, j, 0, wid), t01)
    mask10 = _bitwise_lt(lambda j: _plane(seed, j, 1, wid), t10)
    return mask01, mask10


def _word_masks(wid, seed: int, thr):
    """KernelThresholds wrapper around :func:`word_masks`: the legacy
    per-segment path folds the same integers as the arena path."""
    return word_masks(
        wid, seed, q01_weak=thr.q01_weak, q01_strong=thr.q01_strong,
        q10_weak=thr.q10_weak, q10_strong=thr.q10_strong,
        weak_row_q=thr.weak_row_q,
        words_per_row_log2=thr.words_per_row_log2)


def _bitwise_masks(wid, seed: int, thr):
    """KernelThresholds wrapper around :func:`bitwise_masks`."""
    return bitwise_masks(
        wid, seed, t01_weak=thr.t01_weak, t01_strong=thr.t01_strong,
        t10_weak=thr.t10_weak, t10_strong=thr.t10_strong,
        weak_row_q=thr.weak_row_q,
        words_per_row_log2=thr.words_per_row_log2)


def segment_word_ids(n: int, base_word: int, device) -> torch.Tensor:
    """Physical ids ``base_word + i`` of a run of ``n`` words, wrapping
    mod 2**32 as uint32 does (int64 values)."""
    return (torch.arange(n, dtype=torch.int64, device=device)
            + (int(base_word) & _FULL)) & _FULL


def inject_u32_ref(data_u32, *, thresholds, seed: int, base_word: int,
                   method: str = "word"):
    """Apply stuck-at faults to a flat run of int32 words (reference):
    word i sits at physical id ``base_word + i``.  Returns int32 words."""
    x = H.as_u64(data_u32)
    wid = segment_word_ids(x.shape[0], base_word, x.device)
    if method == "word":
        mask01, mask10 = _word_masks(wid, seed, thresholds)
    elif method == "bitwise":
        mask01, mask10 = _bitwise_masks(wid, seed, thresholds)
    else:
        raise ValueError(f"unknown method {method!r}")
    mask10 = mask10 & (mask01 ^ _FULL)  # a doubly-selected bit sticks at 1
    return H.as_i32((x | mask01) & (mask10 ^ _FULL))

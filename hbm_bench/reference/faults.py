"""Stuck-at faults of an undervolted HBM domain, worked out from scratch.

A frozen copy of the fault arithmetic that the measured program
implements (its fault model, fault map, threshold table, word masks,
SECDED round and bump placement), written here so that the yardstick
does not move when the program does.  Nothing here imports the program:
the reference recomputes every table the program derives.

Words are uint32 values held in int64 tensors (PyTorch has no uint32
shifts or compares on every device), masked with ``& MASK``.

Model, in short:
  * a fault map draws a rate multiplier per pseudo-channel (PC) from a
    numpy seed; each PC's per-bit stuck-at-1 / stuck-at-0 rates at a
    voltage follow an exponential regime plus a saturation term, 5% of
    DRAM rows (hashed) are weak and carry 90% of the exponential mass;
  * a word at physical id ``w`` is hit by a stuck-at-1 (stuck-at-0)
    fault when ``hash(seed, stream, w) < q``, with ``q = 32 p`` as a
    uint32 threshold; a hit sticks one hashed bit;
  * SECDED(72, 64): a codeword is two consecutive words plus 8 parity
    bits that fault once per codeword; one faulted bit is corrected,
    two or more pass the faulted data through;
  * a domain places a tree's leaves, sorted by path, one after another
    in 4096-word blocks over its PCs in the order it lists them.
"""
from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

MASK = 0xFFFFFFFF

# ---- hashing ---------------------------------------------------------------
STREAM_WORD_01 = 0x9E3779B1
STREAM_WORD_10 = 0x85EBCA77
STREAM_BITPOS_01 = 0xC2B2AE3D
STREAM_BITPOS_10 = 0x27D4EB2F
STREAM_ROW = 0x165667B1
STREAM_PARITY = 0x94D049BB
_M1 = 0x7FEB352D
_M2 = 0x846CA68B


def _mul32(x: torch.Tensor, m: int) -> torch.Tensor:
    lo = x * (m & 0xFFFF)
    hi = (x * (m >> 16)) & 0xFFFF
    return (lo + (hi << 16)) & MASK


def mix32(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = _mul32(x, _M1)
    x = x ^ (x >> 15)
    x = _mul32(x, _M2)
    return x ^ (x >> 16)


def mix32_int(x: int) -> int:
    x &= MASK
    x ^= x >> 16
    x = (x * _M1) & MASK
    x ^= x >> 15
    x = (x * _M2) & MASK
    return x ^ (x >> 16)


def hash_stream(seed: int, stream: int, counter: torch.Tensor):
    return mix32(counter ^ mix32_int(int(seed) ^ int(stream)))


def u32_threshold(rate: float) -> int:
    rate = min(1.0, max(0.0, float(rate)))
    return min(MASK, int(math.floor(rate * 4294967296.0)))


def u32_threshold_f32(rate: torch.Tensor) -> torch.Tensor:
    t = torch.floor(torch.clamp(rate.float(), 0.0, 1.0)
                    * torch.tensor(4294967296.0, dtype=torch.float32))
    return torch.where(t >= 4294967296.0, torch.tensor(MASK),
                       t.to(torch.int64))


# ---- fault model (section III of the paper) --------------------------------
V_MIN = 0.98
V_ONSET_10 = 0.97
V_ONSET_01 = 0.96
STEP = 0.01
F0 = 1.2e-10
DECADES_PER_STEP = 0.52
ASYMMETRY = 1.21
SAT_CENTER = 0.858
SAT_WIDTH = 0.002
W01 = ASYMMETRY / (1.0 + ASYMMETRY)
W10 = 1.0 / (1.0 + ASYMMETRY)
WEAK_ROW_FRAC = 0.05
WEAK_ROW_SHARE = 0.90
STACK_SKEW = 1.13
PC_SIGMA_DECADES = 0.80
PAPER_HOT_PCS = {4: 8.0, 5: 6.0, 18: 9.0, 19: 7.0, 20: 6.0}


def _components_f64(v: float, m: float):
    """(exp01, exp10, sat01, sat10) per-bit rates, float64."""
    if not v < V_MIN - 1e-9:
        return 0.0, 0.0, 0.0, 0.0
    rate = F0 * 10.0 ** (DECADES_PER_STEP * ((V_ONSET_10 - v) / STEP))
    e01 = ASYMMETRY * rate * m if v <= V_ONSET_01 + 1e-9 else 0.0
    e10 = rate * m if v <= V_ONSET_10 + 1e-9 else 0.0
    sat = 1.0 / (1.0 + math.exp((v - SAT_CENTER) / SAT_WIDTH))
    return e01, e10, W01 * sat, W10 * sat


def pc_total_rate(v: float, mult: Sequence[float]) -> np.ndarray:
    out = []
    for m in mult:
        e01, e10, s01, s10 = _components_f64(v, m)
        r01 = min(max(e01 + s01, 0.0), 1.0)
        r10 = min(max(e10 + s10, 0.0), 1.0)
        tot = r01 + r10
        scale = 1.0 / max(tot, 1e-30) if tot > 1.0 else 1.0
        out.append(min(max(r01 * scale + r10 * scale, 0.0), 1.0))
    return np.asarray(out)


def _f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def _fma32(a, b, c) -> torch.Tensor:
    return (torch.as_tensor(a).double() * torch.as_tensor(b).double()
            + torch.as_tensor(c).double()).float()


def _exp_f32(x: torch.Tensor) -> torch.Tensor:
    """float32 exp as a Cephes polynomial in fused multiply-adds (the
    thresholds are defined by it, not by a correctly rounded exp)."""
    poly = (1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3,
            4.1665795894e-2, 1.6666665459e-1, 5.0000001201e-1)
    x = torch.clamp(x.float(), -88.3762626647949, 88.3762626647949)
    n = torch.floor(_fma32(x, _f32(1.44269504088896341), _f32(0.5)))
    r = _fma32(-n, _f32(0.693359375), x)
    r = _fma32(-n, _f32(-2.12194440e-4), r)
    z = r * r
    y = _fma32(r, _f32(poly[0]), _f32(poly[1]))
    for c in poly[2:]:
        y = _fma32(y, r, _f32(c))
    y = _fma32(y, z, r) + _f32(1.0)
    return torch.ldexp(y, n.to(torch.int32)).float()


class FaultMap:
    """One HBM part's fault map: 32 PCs of 256 MiB (the paper's VCU128),
    rows of 1 KiB, per-PC multipliers drawn from ``seed``."""

    num_pcs = 32
    words_per_pc = (256 << 20) // 4
    words_per_row_log2 = 8

    def __init__(self, seed: int):
        self.seed = int(seed)
        rng = np.random.RandomState(self.seed)
        mult = 10.0 ** rng.normal(0.0, PC_SIGMA_DECADES, self.num_pcs)
        skew = np.sqrt(STACK_SKEW)
        for pc in range(self.num_pcs):
            mult[pc] *= skew if pc // 16 == 1 else 1.0 / skew
        for pc, boost in PAPER_HOT_PCS.items():
            mult[pc] *= boost
        self.mult = tuple(float(m) for m in mult)

    def usable_pcs(self, v: float, n: int) -> Tuple[int, ...]:
        """The ``n`` most reliable PCs at ``v`` (rate <= 1), in order."""
        total = pc_total_rate(v, self.mult)
        order = np.argsort(total, kind="stable")
        return tuple(int(p) for p in order[total[order] <= 1.0][:n])

    def thresholds(self, v: float) -> Dict[str, torch.Tensor]:
        """Per-PC uint32 thresholds (int64 CPU tensors) at ``v``: word
        hits of either direction in weak and strong rows, the weak-row
        draw and the parity hit of a codeword."""
        m = torch.tensor(np.asarray(self.mult, np.float32))
        vt = _f32(v)
        gate = vt < _f32(V_MIN - 1e-9)
        y = (_f32(V_ONSET_10) - vt) * (_f32(DECADES_PER_STEP) / _f32(STEP))
        pw = torch.pow(torch.tensor(10.0, dtype=torch.float64),
                       y.double()).float()
        zero = torch.zeros_like(m)
        e01 = torch.where(vt <= _f32(V_ONSET_01 + 1e-9),
                          pw * (_f32(F0) * _f32(ASYMMETRY)), _f32(0.0)) * m
        e10 = torch.where(vt <= _f32(V_ONSET_10 + 1e-9), pw * _f32(F0),
                          _f32(0.0)) * m
        a = (vt - _f32(SAT_CENTER)) * (_f32(1.0) / _f32(SAT_WIDTH))
        sat = _f32(1.0) / (_f32(1.0) + _exp_f32(a))
        s01 = (_f32(W01) * sat).expand(m.shape)
        s10 = (_f32(W10) * sat).expand(m.shape)
        e01, e10 = torch.where(gate, e01, zero), torch.where(gate, e10, zero)
        s01, s10 = torch.where(gate, s01, zero), torch.where(gate, s10, zero)
        wm = _f32(WEAK_ROW_SHARE / WEAK_ROW_FRAC)
        sm = _f32((1.0 - WEAK_ROW_SHARE) / (1.0 - WEAK_ROW_FRAC))

        def clip(x):
            return torch.clamp(x, 0.0, 1.0)

        p01w, p01s = clip(_fma32(e01, wm, s01)), clip(_fma32(e01, sm, s01))
        p10w, p10s = clip(_fma32(e10, wm, s10)), clip(_fma32(e10, sm, s10))
        word = lambda p: u32_threshold_f32(_f32(32.0) * p)   # noqa: E731
        par = lambda a, b: u32_threshold_f32(_f32(8.0) * (a + b))  # noqa
        return {"q01_weak": word(p01w), "q01_strong": word(p01s),
                "q10_weak": word(p10w), "q10_strong": word(p10s),
                "weak_row_q": torch.full(m.shape,
                                         u32_threshold(WEAK_ROW_FRAC),
                                         dtype=torch.int64),
                "par_weak": par(p01w, p10w), "par_strong": par(p01s, p10s)}


# ---- masks and the SECDED round --------------------------------------------
def _popcount(v):
    v = (v - ((v >> 1) & 0x55555555)) & MASK
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & MASK) >> 24


def _masks(wid, thr, pc, seed, words_per_row_log2):
    """(stuck-at-1 mask, stuck-at-0 mask, weak-row flag) of each word."""
    weak = hash_stream(seed, STREAM_ROW, wid >> words_per_row_log2) < \
        thr["weak_row_q"][pc]
    q01 = torch.where(weak, thr["q01_weak"][pc], thr["q01_strong"][pc])
    q10 = torch.where(weak, thr["q10_weak"][pc], thr["q10_strong"][pc])
    one = torch.ones((), dtype=torch.int64, device=wid.device)
    zero = torch.zeros((), dtype=torch.int64, device=wid.device)
    m01 = torch.where(hash_stream(seed, STREAM_WORD_01, wid) < q01,
                      one << (hash_stream(seed, STREAM_BITPOS_01, wid) & 31),
                      zero)
    m10 = torch.where(hash_stream(seed, STREAM_WORD_10, wid) < q10,
                      one << (hash_stream(seed, STREAM_BITPOS_10, wid) & 31),
                      zero)
    return m01, m10 & (m01 ^ MASK), weak


def _parity_hits(wid, weak, thr, pc, seed):
    """One flag per codeword (pairs along the last axis of ``wid``)."""
    pair = wid.shape[:-1] + (wid.shape[-1] // 2, 2)
    cw = wid.reshape(pair)[..., 0]
    cw_pc = torch.broadcast_to(torch.as_tensor(pc, device=wid.device),
                               wid.shape).reshape(pair)[..., 0]
    par_q = torch.where(weak.reshape(pair)[..., 0], thr["par_weak"][cw_pc],
                        thr["par_strong"][cw_pc])
    return (hash_stream(seed, STREAM_PARITY, cw >> 1) < par_q).to(torch.int64)


def ecc_round(data, wid, thr: Dict[str, torch.Tensor], pc, seed: int,
              words_per_row_log2: int = FaultMap.words_per_row_log2):
    """What a SECDED-protected read of ``data`` returns.

    ``data``: int64 uint32 values, last axis of even length, consecutive
    pairs forming codewords; ``wid``: their physical word ids (same
    shape); ``pc``: each word's PC (same shape); ``thr``:
    :meth:`FaultMap.thresholds` on ``data``'s device.  Returns ``(words
    read, uncorrectable codeword count)``."""
    m01, m10, weak = _masks(wid, thr, pc, seed, words_per_row_log2)
    faulted = (data | m01) & (m10 ^ MASK)
    pair = data.shape[:-1] + (data.shape[-1] // 2, 2)
    fb = (faulted ^ data).reshape(pair)
    count = (_popcount(fb[..., 0]) + _popcount(fb[..., 1])
             + _parity_hits(wid, weak, thr, pc, seed))
    bad = count >= 2
    out = torch.where(bad[..., None].expand(pair).reshape(data.shape),
                      faulted, data)
    return out, int(bad.sum())


def weak_codewords(wid, thr: Dict[str, torch.Tensor], pc, seed: int,
                   words_per_row_log2: int = FaultMap.words_per_row_log2):
    """Codewords (consecutive word pairs of ``wid``) holding two or more
    stuck cells, data bits and parity together: the only ones a SECDED
    read can return faulted, whatever data they hold."""
    m01, m10, weak = _masks(wid, thr, pc, seed, words_per_row_log2)
    pair = wid.shape[:-1] + (wid.shape[-1] // 2, 2)
    stuck = _popcount(m01 | m10).reshape(pair)
    count = stuck[..., 0] + stuck[..., 1] + _parity_hits(wid, weak, thr,
                                                         pc, seed)
    return int((count >= 2).sum())


# ---- placement -------------------------------------------------------------
BLOCK_WORDS = 4096


def bump_placement(leaf_words: Sequence[Tuple[str, int]],
                   pcs: Sequence[int]) -> Dict[str, int]:
    """First block of each leaf: leaves sorted by path, each rounded up to
    whole blocks, laid one after another over ``pcs`` in order."""
    out, block = {}, 0
    for path, words in sorted(leaf_words):
        out[path] = block
        block += -(-int(words) // BLOCK_WORDS)
    if block > len(pcs) * FaultMap.words_per_pc // BLOCK_WORDS:
        raise ValueError(f"{block} blocks exceed the {len(pcs)}-PC domain")
    return out


def physical_words(first_block: int, offset: torch.Tensor, pcs):
    """(physical word id, PC) of leaf word ``offset`` (int64 tensor) of a
    leaf whose first block is ``first_block``."""
    per_pc = FaultMap.words_per_pc // BLOCK_WORDS
    block = first_block + (offset >> 12)
    pc_tab = torch.as_tensor(list(pcs), dtype=torch.int64,
                             device=offset.device)
    pc = pc_tab[block // per_pc]
    wid = pc * FaultMap.words_per_pc + (block % per_pc) * BLOCK_WORDS + (
        offset & (BLOCK_WORDS - 1))
    return wid, pc

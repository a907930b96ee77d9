"""Fault-map synthesis: process variation + spatial clustering.

Port of :mod:`repro.core.faultmap`.  A FaultMap is deterministic in
(geometry, seed); :meth:`FaultMap.from_seed` draws the per-PC
multipliers with the same numpy RNG calls as the reference, so both
packages hold the same map for the same seed.

The (num_pcs, NUM_THR_COLS) kernel-threshold table is computed once per
voltage on the CPU in float32 and memoized; device runs copy that one
table to the card, so a CPU run and a GPU run inject the same bits.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import hashing
from repro_torch.core.faultmodel import DEFAULT_FAULT_MODEL, FaultModel, fma32
from repro_torch.core.hbm import HBMGeometry, VCU128

PAPER_HOT_PCS: Dict[int, float] = {4: 8.0, 5: 6.0, 18: 9.0, 19: 7.0, 20: 6.0}
STACK_SKEW = 1.13
PC_SIGMA_DECADES = 0.80
PAPER_MAP_SEED = 469
WEAK_ROW_FRAC = 0.05
WEAK_ROW_SHARE = 0.90
WEAK_RUN_ROWS = 8

# Threshold-table column layout: one uint32 row per pseudo-channel.
COL_Q01_WEAK = 0
COL_Q01_STRONG = 1
COL_Q10_WEAK = 2
COL_Q10_STRONG = 3
COL_WEAK_ROW_Q = 4
COL_T01_WEAK = 5
COL_T01_STRONG = 6
COL_T10_WEAK = 7
COL_T10_STRONG = 8
COL_PAR_Q_WEAK = 9
COL_PAR_Q_STRONG = 10
NUM_THR_COLS = 11


@dataclasses.dataclass(frozen=True)
class KernelThresholds:
    """Integer thresholds of one PC at one voltage (a table row)."""

    q01_weak: int
    q01_strong: int
    q10_weak: int
    q10_strong: int
    weak_row_q: int
    words_per_row_log2: int
    p01_weak: float
    p01_strong: float
    p10_weak: float
    p10_strong: float
    t01_weak: int
    t01_strong: int
    t10_weak: int
    t10_strong: int
    par_q_weak: int
    par_q_strong: int


@dataclasses.dataclass(frozen=True)
class FaultMap:
    geometry: HBMGeometry
    seed: int
    model: FaultModel
    pc_multiplier: Tuple[float, ...]
    weak_row_frac: float = WEAK_ROW_FRAC
    weak_row_share: float = WEAK_ROW_SHARE
    weak_run_rows: int = WEAK_RUN_ROWS

    @classmethod
    def from_seed(
        cls,
        geometry: HBMGeometry = VCU128,
        seed: int = 0,
        model: FaultModel = DEFAULT_FAULT_MODEL,
        stack_skew: float = STACK_SKEW,
        sigma_decades: float = PC_SIGMA_DECADES,
        hot_pcs: Optional[Dict[int, float]] = None,
    ) -> "FaultMap":
        rng = np.random.RandomState(seed)
        mult = 10.0 ** rng.normal(0.0, sigma_decades, geometry.num_pcs)
        skew = np.sqrt(stack_skew)
        for pc in range(geometry.num_pcs):
            mult[pc] *= skew if geometry.stack_of_pc(pc) == 1 else 1.0 / skew
        if hot_pcs is None:
            hot_pcs = PAPER_HOT_PCS if geometry.num_pcs == 32 else {}
        for pc, boost in hot_pcs.items():
            if pc < geometry.num_pcs:
                mult[pc] *= boost
        return cls(geometry=geometry, seed=seed, model=model,
                   pc_multiplier=tuple(float(m) for m in mult))

    # ---- analytic rates -------------------------------------------------
    def pc_rates(self, v: float) -> Tuple[np.ndarray, np.ndarray]:
        """(stuck-at-1, stuck-at-0) per-bit fractions for every PC."""
        r01 = np.empty(self.geometry.num_pcs)
        r10 = np.empty(self.geometry.num_pcs)
        for pc, m in enumerate(self.pc_multiplier):
            a, b = self.model.rates(v, m)
            r01[pc], r10[pc] = float(a), float(b)
        return r01, r10

    def pc_total_rate(self, v: float) -> np.ndarray:
        r01, r10 = self.pc_rates(v)
        return np.clip(r01 + r10, 0.0, 1.0)

    def stack_mean_rate(self, v: float, stack: int) -> float:
        """Mean stuck-cell rate of one stack's PCs (Fig. 4)."""
        pcs = self.geometry.pcs_of_stack(stack)
        return float(self.pc_total_rate(v)[list(pcs)].mean())

    def expected_faults(self, v: float, pc: int,
                        pattern: str = "both") -> float:
        """Expected faulty bits in one PC under a test pattern: 'zeros'
        observes only 0->1 flips, 'ones' only 1->0, 'both' any stuck
        cell (capacity planning)."""
        r01, r10 = self.pc_rates(v)
        bits = self.geometry.bits_per_pc
        if pattern == "zeros":
            return bits * r01[pc]
        if pattern == "ones":
            return bits * r10[pc]
        return bits * min(1.0, r01[pc] + r10[pc])

    def fault_free_prob(self, v: float, pc: int) -> float:
        """Poisson probability that a PC shows no faulty cell at ``v``."""
        lam = self.expected_faults(v, pc, "both")
        return float(np.exp(-min(lam, 700.0)))

    def row_multipliers(self) -> Tuple[float, float]:
        """(weak, strong) within-PC rate multipliers; mass-preserving."""
        weak = self.weak_row_share / self.weak_row_frac
        strong = (1.0 - self.weak_row_share) / (1.0 - self.weak_row_frac)
        return weak, strong

    def reliability_order(self, v: float) -> np.ndarray:
        """PC indices most-reliable-first at ``v`` (stable tie-break)."""
        return np.argsort(self.pc_total_rate(v), kind="stable")

    def usable_pcs(self, v: float, tolerable_rate: float) -> np.ndarray:
        """PC indices whose total stuck-cell rate is <= tolerable_rate,
        most reliable first (0 means < 1 expected faulty bit per PC)."""
        total = self.pc_total_rate(v)
        order = np.argsort(total, kind="stable")
        if tolerable_rate <= 0.0:
            keep = total[order] * self.geometry.bits_per_pc < 1.0
        else:
            keep = total[order] <= tolerable_rate
        return order[keep]

    def num_usable_pcs(self, v: float, tolerable_rate: float) -> int:
        return int(len(self.usable_pcs(v, tolerable_rate)))

    def row_rates(self, v: float) -> Tuple[np.ndarray, np.ndarray]:
        """Per-PC (weak-row, strong-row) total stuck-cell rates at ``v``:
        clustering modulates the exponential regime only."""
        wm, sm = self.row_multipliers()
        weak = np.empty(self.geometry.num_pcs)
        strong = np.empty(self.geometry.num_pcs)
        for pc, m in enumerate(self.pc_multiplier):
            e01, e10, s01, s10 = self.model.components(v, m)
            p01w = np.clip(e01 * wm + s01, 0.0, 1.0)
            p10w = np.clip(e10 * wm + s10, 0.0, 1.0)
            p01s = np.clip(e01 * sm + s01, 0.0, 1.0)
            p10s = np.clip(e10 * sm + s10, 0.0, 1.0)
            weak[pc] = min(float(p01w + p10w), 1.0)
            strong[pc] = min(float(p01s + p10s), 1.0)
        return weak, strong

    def predicted_rates(self, v: float,
                        avoid_weak_rows: bool = False) -> np.ndarray:
        """Per-PC predicted total stuck-cell rate of an extent at ``v``:
        the strong-row rate when the extent avoids weak rows, else the
        blended per-PC rate."""
        if avoid_weak_rows:
            return self.row_rates(v)[1]
        return self.pc_total_rate(v)

    @property
    def rows_per_pc(self) -> int:
        return self.geometry.bytes_per_pc // self.geometry.row_bytes

    def weak_row_mask(self, pc: int) -> np.ndarray:
        """(rows_per_pc,) bool: which DRAM rows of ``pc`` are weak -- the
        kernels' draw ``hash(seed, STREAM_ROW, global_row) <
        q(weak_row_frac)``, so it matches injection bit for bit."""
        return _weak_row_mask(self, int(pc))

    def weak_block_mask(self, pc: int, block_words: int) -> np.ndarray:
        """(blocks_per_pc,) bool: blocks of ``block_words`` words in
        ``pc`` that hold at least one weak row."""
        words_per_row = self.geometry.row_bytes // 4
        assert block_words % words_per_row == 0, (block_words, words_per_row)
        mask = self.weak_row_mask(pc)
        return mask.reshape(-1, block_words // words_per_row).any(axis=1)

    # ---- kernel thresholds ----------------------------------------------
    @property
    def words_per_row_log2(self) -> int:
        words_per_row = self.geometry.row_bytes // 4
        assert words_per_row & (words_per_row - 1) == 0, "row must be pow2"
        return int(words_per_row.bit_length() - 1)

    def threshold_table(self, v: float) -> torch.Tensor:
        """(num_pcs, NUM_THR_COLS) CPU int32 tensor of uint32 bit
        patterns at voltage ``v`` (memoized; treat it as read-only)."""
        return _threshold_table(self, float(v))

    def thresholds(self, v: float, pc: int) -> KernelThresholds:
        """One table row, materialized as Python ints."""
        row = hashing.as_u64(self.threshold_table(v)[pc]).tolist()
        inv = 1.0 / float(2 ** hashing.PLANES)
        return KernelThresholds(
            q01_weak=row[COL_Q01_WEAK], q01_strong=row[COL_Q01_STRONG],
            q10_weak=row[COL_Q10_WEAK], q10_strong=row[COL_Q10_STRONG],
            weak_row_q=row[COL_WEAK_ROW_Q],
            words_per_row_log2=self.words_per_row_log2,
            p01_weak=row[COL_T01_WEAK] * inv,
            p01_strong=row[COL_T01_STRONG] * inv,
            p10_weak=row[COL_T10_WEAK] * inv,
            p10_strong=row[COL_T10_STRONG] * inv,
            t01_weak=row[COL_T01_WEAK], t01_strong=row[COL_T01_STRONG],
            t10_weak=row[COL_T10_WEAK], t10_strong=row[COL_T10_STRONG],
            par_q_weak=row[COL_PAR_Q_WEAK],
            par_q_strong=row[COL_PAR_Q_STRONG],
        )


@functools.lru_cache(maxsize=128)
def _weak_row_mask(fmap: FaultMap, pc: int) -> np.ndarray:
    """Memoized weak-row draw of one PC; rows are indexed by *global*
    physical word id >> words_per_row_log2."""
    n = fmap.rows_per_pc
    rows = pc * n + torch.arange(n, dtype=torch.int64)
    q = hashing.rate_to_u32_threshold(fmap.weak_row_frac)
    u = hashing.hash_stream(fmap.seed, hashing.STREAM_ROW, rows)
    return (u < q).numpy()


@functools.lru_cache(maxsize=512)
def _threshold_table(fmap: FaultMap, v: float) -> torch.Tensor:
    mult = torch.tensor(np.asarray(fmap.pc_multiplier, np.float32))
    e01, e10, s01, s10 = fmap.model.components_t(v, mult)
    wm, sm = (torch.tensor(x, dtype=torch.float32)
              for x in fmap.row_multipliers())

    def clip(x):
        return torch.clamp(x, 0.0, 1.0)

    p01w, p01s = clip(fma32(e01, wm, s01)), clip(fma32(e01, sm, s01))
    p10w, p10s = clip(fma32(e10, wm, s10)), clip(fma32(e10, sm, s10))

    def word_q(p):
        # one stuck bit per hit word; exact to O((32p)^2) for small p
        return hashing.rate_to_u32_threshold_t(
            torch.tensor(32.0, dtype=torch.float32) * p)

    def par_q(p01, p10):
        # 8 parity bits per SECDED(72,64) codeword, either direction
        return hashing.rate_to_u32_threshold_t(
            torch.tensor(8.0, dtype=torch.float32) * (p01 + p10))

    weak_row_q = torch.full(
        mult.shape, hashing.rate_to_u32_threshold(fmap.weak_row_frac),
        dtype=torch.int64)
    cols = [word_q(p01w), word_q(p01s), word_q(p10w), word_q(p10s),
            weak_row_q,
            hashing.rate_to_plane_threshold_t(p01w),
            hashing.rate_to_plane_threshold_t(p01s),
            hashing.rate_to_plane_threshold_t(p10w),
            hashing.rate_to_plane_threshold_t(p10s),
            par_q(p01w, p10w), par_q(p01s, p10s)]
    return hashing.as_i32(torch.stack(cols, dim=1))

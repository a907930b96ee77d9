"""The paper's three-factor trade-off: power x capacity x fault rate.

Port of :mod:`repro.core.tradeoff` (section III-C): because
pseudo-channels are independently controllable, an application that
tolerates fault rate T and needs capacity C can pick the deepest voltage
at which enough sufficiently reliable PCs remain.

:meth:`TradeoffSolver.frontier` evaluates the whole (voltage, PC) grid at
once into a :class:`Frontier` of float32 CPU tensors.  The reference
computes it in float32 through XLA, and the governor's choices turn on
its comparisons, so the port follows XLA's arithmetic: the components
come from :meth:`~repro_torch.core.faultmodel.FaultModel.components_t`
at unit multiplier, and each PC's ``e * m + s`` is one fused
multiply-add, as XLA's CPU backend contracts it; the mean rate sums in
XLA's reduction order.  :func:`oracle_point` is the reference's float64
numpy search, kept as an independent implementation.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.faultmap import FaultMap
from repro_torch.core.faultmodel import (ALPHA_DROP_MAX, V_CRITICAL, V_NOM,
                                         fma32)
from repro_torch.core.voltage import DEFAULT_POWER_MODEL, PowerModel


def voltage_grid(v_hi: float = V_NOM, v_lo: float = V_CRITICAL,
                 step: float = 0.01) -> np.ndarray:
    """The paper's sweep: V_nom down to V_critical in 10 mV steps."""
    n = int(round((v_hi - v_lo) / step))
    return np.round(v_hi - step * np.arange(n + 1), 4)


@dataclasses.dataclass(frozen=True)
class TradeoffPoint:
    voltage: float
    savings: float                 # power factor vs nominal, same util
    pc_ids: Tuple[int, ...]        # PCs kept powered/used
    capacity_bytes: int
    worst_pc_rate: float           # max stuck-cell rate among kept PCs
    mean_pc_rate: float


@dataclasses.dataclass(frozen=True)
class Frontier:
    """Stacked per-voltage solution of the three-factor trade-off.

    All tensors share leading axis V = len(voltages); ``pc_rate``,
    ``pc_order`` and ``usable`` have a trailing PC axis.  The best PC
    subset at voltage i is ``pc_order[i, :num_usable[i]]`` -- the usable
    PCs most reliable first; truncate it to meet a capacity requirement.
    """

    voltages: torch.Tensor     # (V,) float32
    savings: torch.Tensor      # (V,) power-saving factor vs nominal
    power: torch.Tensor        # (V,) normalized power factor (util=1)
    pc_rate: torch.Tensor      # (V, P) per-PC total stuck-cell rate
    pc_order: torch.Tensor     # (V, P) int32, PCs by ascending rate (stable)
    usable: torch.Tensor       # (V, P) bool, rate meets the tolerance
    num_usable: torch.Tensor   # (V,) int32
    worst_rate: torch.Tensor   # (V,) max rate among usable PCs (0 if none)
    mean_rate: torch.Tensor    # (V,) mean rate among usable PCs (0 if none)
    bytes_per_pc: int

    @property
    def capacity_bytes(self) -> torch.Tensor:
        """(V,) usable capacity (float32: PC sizes are powers of two)."""
        return self.num_usable.to(torch.float32) * float(self.bytes_per_pc)


def _f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def pc_rates_t(model, v: float, mult: torch.Tensor) -> torch.Tensor:
    """float32 total stuck-cell rate per multiplier at voltage ``v``:
    ``min(clip(e01 m + s01) + clip(e10 m + s10), 1)`` with each ``e m + s``
    a fused multiply-add."""
    e01, e10, s01, s10 = model.components_t(v, torch.ones_like(mult))
    r01 = torch.clamp(fma32(e01, mult, s01), 0.0, 1.0)
    r10 = torch.clamp(fma32(e10, mult, s10), 0.0, 1.0)
    return torch.minimum(r01 + r10, _f32(1.0))


def _xla_row_sum(x: torch.Tensor) -> torch.Tensor:
    """float32 sum over the last axis in the order of XLA's CPU reduction:
    eight lane accumulators (element i into lane i % 8), then a halving
    tree over the lanes."""
    pad = (-x.shape[-1]) % 8
    if pad:
        x = torch.cat([x, x.new_zeros(x.shape[:-1] + (pad,))], dim=-1)
    acc = x[..., :8]
    for j in range(8, x.shape[-1], 8):
        acc = acc + x[..., j:j + 8]
    while acc.shape[-1] > 1:
        h = acc.shape[-1] // 2
        acc = acc[..., :h] + acc[..., h:]
    return acc[..., 0]


def _frontier(fmap: FaultMap, pm: PowerModel, v_grid,
              tol: float) -> Frontier:
    """Whole-grid frontier in float32, as the reference's traced one."""
    grid = torch.as_tensor(np.asarray(v_grid, np.float32))
    mult = torch.tensor(np.asarray(fmap.pc_multiplier, np.float32))
    pc_rate = torch.stack([pc_rates_t(fmap.model, float(v), mult)
                           for v in grid])                        # (V, P)
    order = torch.sort(pc_rate, dim=1, stable=True).indices
    tol = _f32(tol)
    bits = _f32(float(fmap.geometry.bits_per_pc))
    # tol <= 0 means "provably fault-free in expectation": < 1 expected
    # faulty bit per PC (the rule of FaultMap.usable_pcs).
    usable = (pc_rate <= tol) if bool(tol > 0.0) else (pc_rate * bits < 1.0)
    num_usable = usable.sum(dim=1).to(torch.int32)
    kept = torch.where(usable, pc_rate, _f32(0.0))
    worst = kept.max(dim=1).values
    mean = _xla_row_sum(kept) / torch.clamp(num_usable, min=1).to(
        torch.float32)
    one = torch.ones(1, dtype=torch.float32)
    stuck = torch.cat([pc_rates_t(pm.fault_model, float(v), one)
                       for v in grid])
    alpha = _f32(1.0) - _f32(ALPHA_DROP_MAX) * stuck
    x = grid * (_f32(1.0) / _f32(V_NOM))
    power = (x * x) * alpha
    return Frontier(voltages=grid, savings=_f32(1.0) / power, power=power,
                    pc_rate=pc_rate, pc_order=order.to(torch.int32),
                    usable=usable, num_usable=num_usable, worst_rate=worst,
                    mean_rate=mean,
                    bytes_per_pc=int(fmap.geometry.bytes_per_pc))


def oracle_point(faultmap: FaultMap, v: float, tolerable_rate: float,
                 required_bytes: int,
                 power_model: PowerModel = DEFAULT_POWER_MODEL,
                 ) -> Optional[TradeoffPoint]:
    """Float64 numpy oracle: the reference's scalar best-subset search."""
    geometry = faultmap.geometry
    usable = faultmap.usable_pcs(v, tolerable_rate)
    need = -(-required_bytes // geometry.bytes_per_pc)
    if len(usable) < max(need, 1):
        return None
    keep = usable[:max(need, 1)] if required_bytes > 0 else usable
    rates = faultmap.pc_total_rate(v)[keep]
    return TradeoffPoint(
        voltage=float(v),
        savings=float(power_model.savings(v)),
        pc_ids=tuple(int(p) for p in keep),
        capacity_bytes=int(len(keep) * geometry.bytes_per_pc),
        worst_pc_rate=float(rates.max()),
        mean_pc_rate=float(rates.mean()),
    )


class TradeoffSolver:
    """Searches the (voltage, PC-subset) space for maximum power savings
    subject to capacity and tolerable-fault-rate constraints."""

    def __init__(self, faultmap: FaultMap,
                 power_model: PowerModel = DEFAULT_POWER_MODEL):
        self.faultmap = faultmap
        self.power = power_model
        self.geometry = faultmap.geometry

    def frontier(self, v_grid: Optional[Sequence[float]] = None,
                 tolerable_rate: float = 0.0) -> Frontier:
        """Solve every voltage of ``v_grid`` (default: the paper's 10 mV
        sweep) at once; see :class:`Frontier`."""
        grid = voltage_grid() if v_grid is None else v_grid
        return _frontier(self.faultmap, self.power, grid,
                         float(np.float32(tolerable_rate)))

    def point(self, v: float, tolerable_rate: float,
              required_bytes: int) -> Optional[TradeoffPoint]:
        """Best PC subset at a fixed voltage, or None if infeasible."""
        f = self.frontier(np.asarray([v], np.float32), tolerable_rate)
        return self._point_from_row(f, 0, float(v), required_bytes)

    def _point_from_row(self, f: Frontier, i: int, v: float,
                        required_bytes: int) -> Optional[TradeoffPoint]:
        n_usable = int(f.num_usable[i])
        need = -(-required_bytes // self.geometry.bytes_per_pc)
        if n_usable < max(need, 1):
            return None
        keep_count = max(need, 1) if required_bytes > 0 else n_usable
        keep = f.pc_order[i].numpy()[:keep_count]
        kept_rates = f.pc_rate[i].numpy()[keep]
        return TradeoffPoint(
            voltage=float(v),
            savings=float(f.savings[i]),
            pc_ids=tuple(int(p) for p in keep),
            capacity_bytes=int(keep_count * self.geometry.bytes_per_pc),
            worst_pc_rate=float(kept_rates.max()),
            mean_pc_rate=float(kept_rates.mean()),
        )

    def solve(self, required_bytes: int, tolerable_rate: float,
              v_grid: Optional[Sequence[float]] = None) -> TradeoffPoint:
        """Deepest feasible voltage == maximum power savings (power is
        monotone in V)."""
        grid = np.sort(np.asarray(
            v_grid if v_grid is not None else voltage_grid()))
        f = self.frontier(grid, tolerable_rate)
        need = max(-(-required_bytes // self.geometry.bytes_per_pc), 1)
        feasible = f.num_usable.numpy() >= need
        for i in np.flatnonzero(feasible):   # lowest voltage first
            p = self._point_from_row(f, int(i), float(grid[i]),
                                     required_bytes)
            if p is not None:
                return p
        raise ValueError(
            f"no feasible operating point: capacity {required_bytes} B, "
            f"tolerable rate {tolerable_rate}")

    def fig6_matrix(self, tolerable_rates: Sequence[float],
                    v_grid: Optional[Sequence[float]] = None,
                    ) -> Dict[float, List[int]]:
        """Fig. 6: usable PC count per (tolerable rate, voltage)."""
        grid = np.asarray(v_grid if v_grid is not None else voltage_grid())
        return {float(t): [int(n) for n in
                           self.frontier(grid, float(t)).num_usable]
                for t in tolerable_rates}

    def pareto(self, tolerable_rate: float,
               v_grid: Optional[Sequence[float]] = None,
               ) -> List[TradeoffPoint]:
        """Capacity-vs-power frontier at one tolerable rate."""
        grid = np.sort(np.asarray(
            v_grid if v_grid is not None else voltage_grid()))[::-1]
        f = self.frontier(grid, tolerable_rate)
        num = f.num_usable.numpy()
        pts = []
        for i in range(len(grid)):           # nominal first
            if num[i] == 0:
                continue
            p = self._point_from_row(f, i, float(grid[i]), 0)
            if p is not None:
                pts.append(p)
        return pts

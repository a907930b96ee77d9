"""Runtime voltage governor: the paper's Fig. 6 trade-off as a control
loop (port of :mod:`repro.training.governor`).

The profile is the trade-off frontier (:meth:`~repro_torch.core.tradeoff.
TradeoffSolver.frontier`), computed once per plan; a setpoint then picks
a point on it:

  * ``mode='power'``: the highest voltage (most reliable point) whose
    normalized power factor fits the budget;
  * ``mode='rate'``: the deepest voltage (maximum savings) whose worst
    governed-PC stuck-cell rate meets the setpoint;
  * ``mode='efficiency'``: the tokens-per-joule argmax under a fault-rate
    SLO, ``(1 - rate)^read_words_per_token / power(v)``.

:meth:`VoltageGovernor.admit` is the serving entry point: the deepest
voltage at which the governed domain keeps a request's bytes on usable
PCs.  The walks are numpy over the frontier's float32 arrays, as the
reference's are, so a setpoint on a grid boundary resolves to the same
voltage in both packages.

``mode='adaptive'`` walks the rate frontier of ``mode='rate'``, which
:meth:`VoltageGovernor.replan` refreshes from the live fault-map
posterior (:mod:`repro_torch.core.faultmap_posterior`) that the
self-healing scheduler keeps.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from repro_torch.core.domains import CapacityError
from repro_torch.core.faultmodel import V_MIN
from repro_torch.core.tradeoff import TradeoffSolver, voltage_grid
from repro_torch.core.voltage import DEFAULT_POWER_MODEL, PowerModel

@dataclasses.dataclass(frozen=True)
class GovernorConfig:
    """Static policy of a :class:`VoltageGovernor`.

    ``tolerable_rate`` defines which PCs count as usable for the capacity
    constraint; ``required_bytes`` is the capacity the governed domain
    must keep usable at any chosen voltage.  ``setpoint`` is the default
    walk target: a normalized power factor in ``mode='power'``, a worst-PC
    stuck-cell rate in ``mode='rate'`` / ``'efficiency'`` (for efficiency
    the fault-rate SLO).  ``read_words_per_token`` (``'efficiency'``
    only) converts a per-word stuck rate into a per-token retry
    probability."""

    domain: str
    mode: str = "power"    # 'power' | 'rate' | 'adaptive' | 'efficiency'
    tolerable_rate: float = 1e-6
    required_bytes: int = 0
    setpoint: float = 1.0
    v_hi: float = V_MIN
    v_lo: float = 0.86
    step: float = 0.01
    read_words_per_token: int = 4096


class VoltageGovernor:
    """Walks one domain's voltage along the precomputed frontier."""

    def __init__(self, plan, config: GovernorConfig,
                 power_model: PowerModel = DEFAULT_POWER_MODEL):
        if config.mode not in ("power", "rate", "adaptive", "efficiency"):
            raise ValueError(f"unknown governor mode {config.mode!r}")
        if config.read_words_per_token < 1:
            raise ValueError(
                f"read_words_per_token={config.read_words_per_token} "
                "must be >= 1 (the per-token fault exposure scale)")
        if config.domain not in plan.domains:
            raise ValueError(
                f"governor domain {config.domain!r} not in plan domains "
                f"{sorted(plan.domains)}")
        self.config = config
        self.plan = plan
        domain = plan.domains[config.domain]
        fmap = plan.fault_map()
        solver = TradeoffSolver(fmap, power_model)
        grid = np.sort(voltage_grid(config.v_hi, config.v_lo, config.step))
        f = solver.frontier(grid, config.tolerable_rate)

        dom_pcs = np.asarray(domain.pc_ids, np.int64)
        usable = f.usable.numpy()[:, dom_pcs]                # (V, |dom|)
        cap = usable.sum(axis=1) * fmap.geometry.bytes_per_pc  # (V,)
        worst = f.pc_rate.numpy()[:, dom_pcs].max(axis=1)
        power = f.power.numpy()

        self._v_np = np.asarray(grid, np.float32)
        self._cap_np = cap
        self._power_np = power
        self._rate_np = worst
        feasible = cap >= config.required_bytes
        if not feasible.any():
            raise CapacityError(
                config.domain, config.required_bytes, int(cap.max()),
                f"no voltage in [{config.v_lo}, {config.v_hi}] keeps "
                f"enough usable capacity at tolerable rate "
                f"{config.tolerable_rate:g}")
        # Feasible sub-frontier, ascending voltage.  Power rises and the
        # worst rate falls with voltage, so both walks are one
        # searchsorted.
        self._v = self._v_np[feasible]
        self._power = power[feasible]
        self._rate_rev = worst[feasible][::-1]
        self._rate_asc = worst[feasible]
        self._n = int(feasible.sum())
        # Tokens-per-joule score for mode='efficiency': the expected
        # fraction of tokens needing no retry over the power factor
        # (relative units: only the argmax and ratios matter).
        self._tpj_np = self._tpj_from(self._rate_np)
        self._tpj = self._tpj_np[feasible]
        self._feasible = feasible
        self._dom_pcs = dom_pcs
        self.replans = 0

    def _tpj_from(self, worst: np.ndarray) -> np.ndarray:
        k = float(self.config.read_words_per_token)
        p_clean = np.exp(k * np.log1p(-np.minimum(worst, 0.5)))
        return p_clean / self._power_np

    def replan(self, posterior) -> None:
        """Refresh the rate frontier from a live fault-map posterior
        (``mode='adaptive'`` only): worst governed-PC rates are recomputed
        from ``posterior.predicted_rates(v)`` over the voltage grid, so a
        channel whose rows drifted weak shows a higher rate and the same
        setpoint resolves to a shallower voltage.  The capacity arrays stay
        prior-based (the usable-PC census is a placement-time property)."""
        if self.config.mode != "adaptive":
            raise ValueError(
                f"replan() requires mode='adaptive', got "
                f"{self.config.mode!r}")
        worst = np.asarray(
            [posterior.predicted_rates(float(v))[self._dom_pcs].max()
             for v in self._v_np])
        # rates must stay non-increasing in voltage for the walk (the
        # posterior's deltas keep this analytically; clamp float dust)
        worst = np.maximum.accumulate(worst[::-1])[::-1]
        self._rate_np = worst
        self._rate_rev = worst[self._feasible][::-1].astype(np.float32)
        self.replans += 1

    def voltage_at(self, setpoint=None) -> float:
        """Frontier voltage for ``setpoint`` (default: the configured
        one), compared in float32.

        ``mode='power'``: highest feasible voltage with power factor <=
        setpoint (clamped to the deepest feasible one).  ``mode='rate'``:
        deepest feasible voltage with worst-PC rate <= setpoint (clamped
        to the highest feasible one).  ``mode='efficiency'``: among
        feasible points meeting the rate SLO, the tokens-per-joule argmax
        (the highest feasible voltage when none meets it)."""
        if setpoint is None:
            setpoint = self.config.setpoint
        s = np.float32(setpoint)
        if self.config.mode == "power":
            idx = int(np.searchsorted(self._power, s, side="right")) - 1
        elif self.config.mode == "efficiency":
            ok = self._rate_asc <= s
            idx = (int(np.argmax(np.where(ok, self._tpj, np.float32(-1.0))))
                   if ok.any() else self._n - 1)
        else:
            idx = self._n - int(np.searchsorted(self._rate_rev, s,
                                                side="right"))
        return float(self._v[min(max(idx, 0), self._n - 1)])

    def override(self, setpoint=None) -> Dict[str, float]:
        """Voltage-override dict for ``UndervoltPlan.apply`` /
        ``inject_groups`` targeting the governed domain."""
        return {self.config.domain: self.voltage_at(setpoint)}

    # ---- host-side frontier lookups (fleet reporting) -------------------
    def power_at(self, voltage: float) -> float:
        """Normalized power factor of the governed domain at ``voltage``
        (interpolated on the frontier grid)."""
        return float(np.interp(float(voltage), self._v_np, self._power_np))

    def rate_at(self, voltage: float) -> float:
        """Worst governed-PC stuck-cell rate at ``voltage`` (log-domain
        interpolation on the frontier grid)."""
        with np.errstate(divide="ignore"):
            lr = np.log10(np.maximum(self._rate_np, 1e-300))
        return float(10.0 ** np.interp(float(voltage), self._v_np, lr))

    def efficiency_at(self, voltage: float) -> float:
        """Relative tokens-per-joule score at ``voltage`` (comparable
        across voltages of the same governor only)."""
        return float(np.interp(float(voltage), self._v_np, self._tpj_np))

    def admit(self, required_bytes: int,
              setpoint: Optional[float] = None) -> float:
        """Deepest voltage keeping ``required_bytes`` of usable capacity.

        In ``mode='rate'`` (and ``'adaptive'``) a ``setpoint`` also caps
        the worst-PC rate; in ``mode='power'`` it caps the power factor.  ``mode='efficiency'``
        always applies its fault-rate SLO (the passed setpoint, else the
        configured one) and picks the tokens-per-joule argmax among the
        surviving points instead of the deepest."""
        if setpoint is None and self.config.mode == "efficiency":
            setpoint = self.config.setpoint
        ok = self._cap_np >= max(int(required_bytes), 0)
        if setpoint is not None:
            if self.config.mode in ("rate", "adaptive", "efficiency"):
                ok &= self._rate_np <= float(setpoint)
            else:
                ok &= self._power_np <= float(setpoint)
        hits = np.flatnonzero(ok)
        if hits.size == 0:
            raise CapacityError(
                self.config.domain, int(required_bytes),
                int(self._cap_np.max()),
                f"admission infeasible on [{self.config.v_lo}, "
                f"{self.config.v_hi}] at tolerable rate "
                f"{self.config.tolerable_rate:g}")
        if self.config.mode == "efficiency":
            return float(self._v_np[hits[np.argmax(self._tpj_np[hits])]])
        return float(self._v_np[hits[0]])       # ascending grid: deepest


def fleet_report(governors, voltages, setpoints=None,
                 energy=None) -> Dict[str, object]:
    """Aggregate per-shard operating points into one fleet summary: the
    mean and max power factor, the worst shard's worst-PC rate, and
    absolute watts and pJ/byte per shard from ``energy`` (default the
    shared :class:`repro_torch.obs.energy.EnergyModel`).  ``None``
    governors are priced at their raw voltage and left out of the rate."""
    if energy is None:
        from repro_torch.obs.energy import DEFAULT_ENERGY_MODEL
        energy = DEFAULT_ENERGY_MODEL
    per_shard = []
    powers, rates, watts = [], [], []
    for k, (gov, v) in enumerate(zip(governors, voltages)):
        entry = {"shard": k, "voltage": float(v)}
        if setpoints is not None and setpoints[k] is not None:
            entry["setpoint"] = float(setpoints[k])
        if gov is not None:
            entry["power_factor"] = gov.power_at(v)
            entry["worst_rate"] = gov.rate_at(v)
            rates.append(entry["worst_rate"])
        else:
            entry["power_factor"] = float(
                DEFAULT_POWER_MODEL.power(float(v)))
        entry["watts"] = energy.watts(float(v), 1.0)
        entry["pj_per_byte"] = energy.pj_per_byte(float(v))
        powers.append(entry["power_factor"])
        watts.append(entry["watts"])
        per_shard.append(entry)
    out: Dict[str, object] = {
        "shards": per_shard,
        "power_factor_mean": float(np.mean(powers)),
        "power_factor_max": float(np.max(powers)),
        "watts_total": float(np.sum(watts)),
    }
    if rates:
        out["worst_rate"] = float(np.max(rates))
    return out

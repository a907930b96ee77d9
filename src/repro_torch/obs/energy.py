"""Energy accounting: joules/token and $/1M-tokens at a rail voltage
(port of :mod:`repro.obs.energy`).

Joins the calibrated power curve (:class:`repro_torch.core.voltage.
PowerModel`) with the byte counters the scheduler accumulates
(:mod:`repro_torch.obs.metrics`): dynamic energy per byte moved plus the
static (idle) watts for the wall time.  Pricing the same workload at two
voltages reproduces the paper's power ratios, whatever the utilization.

The absolute scale is the reference's: the HBM of its modelled part at
20 W nominal and 819 GB/s (``HBM_BW`` of the reference's
``launch/roofline.py``), kept as constants so that joules per token equal
the reference's.  They describe that modelled HBM, not the H100's.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.core.faultmodel import V_NOM
from repro_torch.core.voltage import (DEFAULT_POWER_MODEL, W_HBM_NOMINAL,
                                     PowerModel)

# The reference's modelled HBM's peak bandwidth (bytes/s); its nominal
# watts are core.voltage.W_HBM_NOMINAL.
HBM_BW = 819e9
# Joules per kWh, and the round $/kWh of the $/1M-token reports.
_J_PER_KWH = 3.6e6
COST_PER_KWH = 0.10


@dataclasses.dataclass(frozen=True)
class EnergyModel:
    """Prices (bytes moved, wall seconds, tokens) at a rail voltage; all
    voltage dependence comes from ``power_model``."""

    power_model: PowerModel = DEFAULT_POWER_MODEL
    nominal_watts: float = W_HBM_NOMINAL
    bandwidth_bytes: float = HBM_BW
    cost_per_kwh: float = COST_PER_KWH

    def watts(self, v: float, util: float = 1.0) -> float:
        """Absolute HBM watts at voltage ``v`` and utilization."""
        return float(self.nominal_watts * self.power_model.power(v, util))

    def static_watts(self, v: float) -> float:
        """Idle (zero-traffic) watts at voltage ``v``."""
        return self.watts(v, 0.0)

    def pj_per_byte(self, v: float = V_NOM) -> float:
        """Dynamic energy per byte moved at ``v`` (picojoules)."""
        dyn_watts = self.watts(v, 1.0) - self.watts(v, 0.0)
        return dyn_watts / self.bandwidth_bytes * 1e12

    def savings(self, v: float, util: float = 1.0) -> float:
        """Energy-per-token improvement factor vs. nominal voltage."""
        return float(self.power_model.savings(v, util))

    def step_joules(self, *, seconds: float, bytes_moved: float,
                    v: float) -> float:
        """Energy of a measured serving interval at voltage ``v``."""
        if seconds < 0 or bytes_moved < 0:
            raise ValueError(f"negative workload: seconds={seconds}, "
                             f"bytes_moved={bytes_moved}")
        return (bytes_moved * self.pj_per_byte(v) * 1e-12
                + self.static_watts(v) * seconds)

    def joules_per_token(self, *, seconds: float, bytes_moved: float,
                         tokens: int, v: float) -> float:
        if tokens <= 0:
            raise ValueError(f"tokens={tokens} must be positive")
        return self.step_joules(seconds=seconds, bytes_moved=bytes_moved,
                                v=v) / tokens

    def usd_per_mtok(self, joules_per_token: float) -> float:
        """Dollars per 1M tokens at the configured energy price."""
        return joules_per_token * 1e6 / _J_PER_KWH * self.cost_per_kwh

    def report(self, *, seconds: float, bytes_moved: float, tokens: int,
               v: float) -> Dict[str, float]:
        """Full pricing of one measured workload at ``v``."""
        joules = self.step_joules(seconds=seconds, bytes_moved=bytes_moved,
                                  v=v)
        jpt = joules / max(tokens, 1)
        util = (bytes_moved / (self.bandwidth_bytes * seconds)
                if seconds > 0 else 0.0)
        return {
            "voltage": float(v),
            "joules": joules,
            "joules_per_token": jpt,
            "usd_per_mtok": self.usd_per_mtok(jpt),
            "tokens_per_joule": (tokens / joules if joules > 0 else 0.0),
            "watts_avg": (joules / seconds if seconds > 0 else 0.0),
            "pj_per_byte": self.pj_per_byte(v),
            "hbm_util": min(util, 1.0),
            "savings_x": self.savings(v),
        }


DEFAULT_ENERGY_MODEL = EnergyModel()

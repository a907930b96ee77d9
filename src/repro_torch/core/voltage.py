"""Calibrated HBM power model under voltage underscaling.

Port of :mod:`repro.core.voltage`: P = alpha * C_L * f * V^2 normalized
to P(V_nom, util=1) = 1, with the active-capacitance drop of stuck bits
(Fig. 3) and idle power at 1/3 of full load (C10).  Model identities,
not measurements.  ``watts()`` and ``energy_joules()`` scale the
normalized power by a nominal HBM power for absolute reports.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.faultmodel import DEFAULT_FAULT_MODEL, FaultModel, V_NOM

P_IDLE_FRAC = 1.0 / 3.0

# Nominal HBM power (watts) at full streaming load of the reference's
# modelled part: an assumption of the reference, used only for absolute
# reports and never for the paper's ratios.  Not a measurement of any
# card, and not the H100's.
W_HBM_NOMINAL = 20.0


@dataclasses.dataclass(frozen=True)
class PowerModel:
    fault_model: FaultModel = DEFAULT_FAULT_MODEL
    p_idle_frac: float = P_IDLE_FRAC

    def power(self, v, util=1.0):
        """Normalized total HBM power at voltage ``v`` and bandwidth
        utilization ``util`` in [0, 1].  P(V_nom, 1.0) == 1."""
        v = np.asarray(v, dtype=np.float64)
        util = np.asarray(util, dtype=np.float64)
        v_sq = (v / V_NOM) ** 2
        alpha = self.fault_model.alpha_factor(v)
        load = self.p_idle_frac + (1.0 - self.p_idle_frac) * util
        return v_sq * load * alpha

    def savings(self, v, util=1.0):
        """Power-saving factor vs. nominal voltage at the same utilization."""
        return self.power(V_NOM, util) / self.power(v, util)

    def alpha_clf(self, v, util=1.0):
        """Measured-style alpha*C_L*f: power divided by V^2, normalized to
        its own value at V_nom for the same utilization (Fig. 3)."""
        p = self.power(v, util) / (np.asarray(v) / V_NOM) ** 2
        return p / self.power(V_NOM, util)

    def watts(self, v, util=1.0, nominal_watts: float = W_HBM_NOMINAL):
        return nominal_watts * self.power(v, util)

    def energy_joules(self, step_seconds, v, util=1.0,
                      nominal_watts: float = W_HBM_NOMINAL):
        """HBM energy of one step.  Undervolting keeps f (and so
        step_seconds) constant: energy scales exactly like power."""
        return step_seconds * self.watts(v, util, nominal_watts)


DEFAULT_POWER_MODEL = PowerModel()

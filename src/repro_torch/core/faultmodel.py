"""Calibrated voltage -> fault-rate model for undervolted HBM.

Port of :mod:`repro.core.faultmodel`: the same paper-anchored constants
(section III) and the same numpy regime model.  :meth:`FaultModel.
components_t` is the float32 counterpart of the reference's traced
``components_jnp``; it is written in the order of operations XLA's CPU
compiler gives that graph (see the method), so the threshold table the
port derives from it equals the reference's cell for cell.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

V_NOM = 1.20
V_MIN = 0.98          # bottom of the guardband: last fault-free voltage
V_ONSET_10 = 0.97     # first 1->0 bit flips
V_ONSET_01 = 0.96     # first 0->1 bit flips
V_ALL_FAULTY = 0.84   # essentially every bit faulty at/below this
V_CRITICAL = 0.81     # lowest voltage at which the part still responds
STEP = 0.01           # the paper sweeps in 10 mV steps

F0 = 1.2e-10
DECADES_PER_STEP = 0.52
ASYMMETRY_01_OVER_10 = 1.21
SAT_CENTER = 0.858
SAT_WIDTH = 0.002
_W01 = ASYMMETRY_01_OVER_10 / (1.0 + ASYMMETRY_01_OVER_10)
_W10 = 1.0 / (1.0 + ASYMMETRY_01_OVER_10)
ALPHA_DROP_MAX = 0.1425


def _exp_rate(v, onset, f0=F0, decades_per_step=DECADES_PER_STEP):
    v = np.asarray(v, dtype=np.float64)
    steps_below = (V_ONSET_10 - v) / STEP
    rate = f0 * np.power(10.0, decades_per_step * steps_below)
    return np.where(v <= onset + 1e-9, rate, 0.0)


def _saturation(v):
    v = np.asarray(v, dtype=np.float64)
    return 1.0 / (1.0 + np.exp((v - SAT_CENTER) / SAT_WIDTH))


def _f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def fma32(a, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` with a single rounding, as XLA's CPU backend
    contracts a multiply-add.  The float32 product is exact in float64."""
    return (torch.as_tensor(a).double() * torch.as_tensor(b).double()
            + torch.as_tensor(c).double()).float()


# XLA's CPU backend computes float32 exp with the Cephes polynomial below,
# not correctly rounded (about 9% of inputs differ from the correctly
# rounded value by an ulp, and torch.exp differs from both).
_EXP_CLAMP = 88.3762626647949
_LOG2E = 1.44269504088896341
_EXP_C1 = 0.693359375
_EXP_C2 = -2.12194440e-4
_EXP_POLY = (1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3,
             4.1665795894e-2, 1.6666665459e-1, 5.0000001201e-1)


def xla_exp_f32(x: torch.Tensor) -> torch.Tensor:
    """float32 exp bit for bit as XLA's CPU backend computes it: clamp,
    n = floor(x log2(e) + 1/2), r = x - n ln(2) in two fused steps, a
    degree-5 polynomial in fused multiply-adds, then r-poly * 2**n."""
    x = torch.clamp(x.to(torch.float32), -_EXP_CLAMP, _EXP_CLAMP)
    n = torch.floor(fma32(x, _f32(_LOG2E), _f32(0.5)))
    r = fma32(-n, _f32(_EXP_C1), x)
    r = fma32(-n, _f32(_EXP_C2), r)
    z = r * r
    y = fma32(r, _f32(_EXP_POLY[0]), _f32(_EXP_POLY[1]))
    for c in _EXP_POLY[2:]:
        y = fma32(y, r, _f32(c))
    y = fma32(y, z, r) + _f32(1.0)
    return torch.ldexp(y, n.to(torch.int32)).to(torch.float32)


@dataclasses.dataclass(frozen=True)
class FaultModel:
    """Voltage -> per-bit stuck-at fault probabilities."""

    f0: float = F0
    decades_per_step: float = DECADES_PER_STEP
    asymmetry: float = ASYMMETRY_01_OVER_10

    def components(self, v, multiplier=1.0):
        """(exp01, exp10, sat01, sat10) regime breakdown (float64 numpy)."""
        gate = np.asarray(v) < V_MIN - 1e-9
        exp01 = (self.asymmetry
                 * _exp_rate(v, V_ONSET_01, self.f0, self.decades_per_step)
                 * multiplier)
        exp10 = (_exp_rate(v, V_ONSET_10, self.f0, self.decades_per_step)
                 * multiplier)
        sat = _saturation(v)
        z = np.zeros_like(sat)
        return (np.where(gate, exp01, z), np.where(gate, exp10, z),
                np.where(gate, _W01 * sat, z), np.where(gate, _W10 * sat, z))

    def components_t(self, v: float, multiplier: torch.Tensor):
        """float32 CPU tensor port of the reference's ``components_jnp``.

        The reference evaluates this graph through XLA, which folds
        ``decades * (onset - v) / step`` into ``(onset - v) * (decades /
        step)``, folds ``f0 * asymmetry`` into one constant, and turns the
        division by the saturation width into a multiply by its float32
        reciprocal.  ``10 ** y`` is correctly rounded there, which the
        float64 power rounded to float32 reproduces; ``exp`` is XLA's own
        polynomial (:func:`xla_exp_f32`).
        """
        v = _f32(v)
        m = multiplier.to(torch.float32)
        gate = v < _f32(V_MIN - 1e-9)
        y = (_f32(V_ONSET_10) - v) * (_f32(self.decades_per_step)
                                      / _f32(STEP))
        pw = torch.pow(torch.tensor(10.0, dtype=torch.float64),
                       y.double()).float()
        z = torch.zeros_like(m)
        e01 = torch.where(v <= _f32(V_ONSET_01 + 1e-9),
                          pw * (_f32(self.f0) * _f32(self.asymmetry)),
                          _f32(0.0)) * m
        e10 = torch.where(v <= _f32(V_ONSET_10 + 1e-9), pw * _f32(self.f0),
                          _f32(0.0)) * m
        a = (v - _f32(SAT_CENTER)) * (_f32(1.0) / _f32(SAT_WIDTH))
        sat = _f32(1.0) / (_f32(1.0) + xla_exp_f32(a))
        s01 = (_f32(_W01) * sat).expand(m.shape)
        s10 = (_f32(_W10) * sat).expand(m.shape)
        return (torch.where(gate, e01, z), torch.where(gate, e10, z),
                torch.where(gate, s01, z), torch.where(gate, s10, z))

    def rate_01(self, v, multiplier=1.0):
        e01, _, s01, _ = self.components(v, multiplier)
        return np.clip(e01 + s01, 0.0, 1.0)

    def rate_10(self, v, multiplier=1.0):
        _, e10, _, s10 = self.components(v, multiplier)
        return np.clip(e10 + s10, 0.0, 1.0)

    def rates(self, v, multiplier=1.0):
        """(stuck-at-1, stuck-at-0) fractions, jointly clipped to sum <= 1."""
        r01 = self.rate_01(v, multiplier)
        r10 = self.rate_10(v, multiplier)
        total = r01 + r10
        scale = np.where(total > 1.0, 1.0 / np.maximum(total, 1e-30), 1.0)
        return r01 * scale, r10 * scale

    def stuck_fraction(self, v, multiplier=1.0):
        r01, r10 = self.rates(v, multiplier)
        return np.clip(r01 + r10, 0.0, 1.0)

    def alpha_factor(self, v):
        """Relative active capacitance alpha(v)/alpha0 (C3, Fig. 3)."""
        return 1.0 - ALPHA_DROP_MAX * self.stuck_fraction(v)

    # ---- region classification (C1, C5) -------------------------------
    @staticmethod
    def region(v: float) -> str:
        if v > V_NOM + 1e-9:
            return "overvolted"
        if v >= V_MIN - 1e-9:
            return "guardband"      # zero faults, 1.5x savings at the bottom
        if v >= V_ALL_FAULTY - 1e-9:
            return "unsafe"         # exponential fault growth
        if v >= V_CRITICAL - 1e-9:
            return "all_faulty"     # every bit stuck
        return "crash"              # the part stops responding

    @staticmethod
    def guardband_fraction() -> float:
        """The paper's 19% guardband: the voltage shed before the first
        faults appear, (V_NOM - V_ONSET_10) / V_NOM = 19.2%."""
        return (V_NOM - V_ONSET_10) / V_NOM


DEFAULT_FAULT_MODEL = FaultModel()

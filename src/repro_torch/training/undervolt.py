"""Undervolt plan (port of :mod:`repro.training.undervolt`).

A plan assigns each tensor group (params / optimizer moments / KV cache)
to a MemoryDomain (voltage + PC subset + ECC).  Placement is computed
once from shapes; groups in unsafe domains pass through the stuck-at
injection engine after being written; :meth:`UndervoltPlan.make_governor`
builds the frontier-walking voltage governor.  A plan may route groups by
criticality tier instead of a fixed policy (:func:`tiered_plan`).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional

from repro_torch.core.domains import (GroupPlacement, MemoryDomain,
                                      place_groups, place_groups_tiered)
from repro_torch.core.engine import inject_groups
from repro_torch.core.faultmap import PAPER_MAP_SEED, FaultMap
from repro_torch.core.faultmodel import V_MIN, V_NOM
from repro_torch.core.hbm import TPU_V5E, HBMGeometry
from repro_torch.core.injection import clamp_nonfinite
from repro_torch.core.voltage import DEFAULT_POWER_MODEL


@functools.lru_cache(maxsize=None)
def _fault_map(geometry: HBMGeometry, map_seed: int) -> FaultMap:
    return FaultMap.from_seed(geometry, map_seed)


@dataclasses.dataclass(frozen=True)
class UndervoltPlan:
    domains: Dict[str, MemoryDomain]
    policy: Optional[Dict[str, str]] = None  # tensor group -> domain name
    geometry: HBMGeometry = TPU_V5E
    map_seed: int = PAPER_MAP_SEED
    mitigation: str = "none"                # none | clamp
    enabled: bool = True
    # Criticality-aware alternative to ``policy``: tensor group -> tier
    # (a name in repro_torch.core.domains.TIERS or a CriticalityTier),
    # placed by place_groups_tiered.
    tiers: Optional[Dict[str, Any]] = None

    def fault_map(self) -> FaultMap:
        return _fault_map(self.geometry, self.map_seed)

    def place(self, groups: Dict[str, Any]) -> Dict[str, GroupPlacement]:
        if self.tiers is not None:
            tiers = {g: self.tiers[g] for g in groups}
            return place_groups_tiered(groups, tiers, self.domains,
                                       self.geometry, self.fault_map())
        if self.policy is None:
            raise ValueError("UndervoltPlan needs a policy or tiers")
        return place_groups(groups, self.policy, self.domains, self.geometry)

    def covers(self, group: str) -> bool:
        """Whether this plan places ``group`` (policy- or tier-driven)."""
        mapping = self.tiers if self.tiers is not None else self.policy
        return mapping is not None and group in mapping

    def make_governor(self, domain: str, **config_kw):
        """Frontier-walking runtime governor for one of this plan's
        domains (see :mod:`repro_torch.training.governor`)."""
        from repro_torch.training.governor import (GovernorConfig,
                                                   VoltageGovernor)
        return VoltageGovernor(self, GovernorConfig(domain=domain,
                                                    **config_kw))

    def apply(self, groups: Dict[str, Any],
              placements: Dict[str, GroupPlacement], *, voltage=None,
              method: str = "auto"):
        """Inject each group's domain faults; returns (groups, metrics)."""
        if isinstance(voltage, dict):
            unknown = set(voltage) - set(self.domains)
            if unknown:
                raise ValueError(
                    f"voltage override names unknown domains "
                    f"{sorted(unknown)}; plan has {sorted(self.domains)}")
            present = {placements[name].domain.name for name in groups}
            voltage = {k: v for k, v in voltage.items() if k in present}
        out, total_bad, total_corr = inject_groups(
            groups, placements, self.fault_map(), voltage=voltage,
            method=method, with_corrected=True)
        if self.mitigation == "clamp":
            out = {name: clamp_nonfinite(tree) for name, tree in out.items()}
        return out, {"uncorrectable_faults": total_bad,
                     "corrected_faults": total_corr}

    def power_report(self, utilization: float = 1.0) -> Dict[str, Any]:
        """Per-domain and blended power factors vs. nominal (model
        identities of the paper's power model)."""
        pm = DEFAULT_POWER_MODEL
        per = {}
        total_pcs = 0
        blended = 0.0
        for name, d in self.domains.items():
            s = float(pm.savings(d.voltage, utilization))
            per[name] = {"voltage": d.voltage, "savings_x": s,
                         "pcs": len(d.pc_ids), "ecc": d.ecc,
                         "region": ("guardband" if d.voltage >= V_MIN
                                    else "unsafe")}
            total_pcs += len(d.pc_ids)
            blended += len(d.pc_ids) * float(
                pm.power(d.voltage, utilization))
        unused = self.geometry.num_pcs - total_pcs
        blended = blended / max(total_pcs, 1)
        nominal = float(pm.power(V_NOM, utilization))
        return {"domains": per,
                "pcs_powered": total_pcs,
                "pcs_off": unused,
                "blended_savings_x": nominal / max(blended, 1e-9)}


def aggressive_plan(v_unsafe: float = 0.91, mitigation: str = "clamp",
                    ecc: bool = False, geometry: HBMGeometry = TPU_V5E,
                    map_seed: int = PAPER_MAP_SEED) -> UndervoltPlan:
    """Optimizer moments stay in a guardband-safe domain on the 16 most
    reliable PCs; parameters and the KV cache ride the unsafe domain on
    the rest."""
    fmap = _fault_map(geometry, map_seed)
    order = list(fmap.usable_pcs(v_unsafe, 1.0))  # most reliable first
    order += [p for p in range(geometry.num_pcs) if p not in order]
    safe_pcs = tuple(int(p) for p in order[:16])
    cheap_pcs = tuple(int(p) for p in order[16:])
    return UndervoltPlan(
        domains={
            "safe": MemoryDomain("safe", V_MIN, safe_pcs),
            "cheap": MemoryDomain("cheap", v_unsafe, cheap_pcs, ecc=ecc),
        },
        policy={"params": "cheap", "mu": "safe", "nu": "safe",
                "kv_cache": "cheap"},
        geometry=geometry, map_seed=map_seed, mitigation=mitigation)


def tiered_plan(v_unsafe: float = 0.91, mitigation: str = "clamp",
                ecc: bool = False, geometry: HBMGeometry = TPU_V5E,
                map_seed: int = PAPER_MAP_SEED,
                tiers: Optional[Dict[str, Any]] = None) -> UndervoltPlan:
    """The safe/cheap split of :func:`aggressive_plan`, but groups declare
    criticality tiers and the planner routes them: each to the deepest
    domain its tolerance admits, on the most reliable PCs still free."""
    fmap = _fault_map(geometry, map_seed)
    order = list(fmap.reliability_order(v_unsafe))
    safe_pcs = tuple(int(p) for p in order[:16])
    cheap_pcs = tuple(int(p) for p in order[16:])
    if tiers is None:
        tiers = {"params": "cheap", "mu": "safe", "nu": "safe",
                 "kv_cache": "cheap"}
    return UndervoltPlan(
        domains={
            "safe": MemoryDomain("safe", V_MIN, safe_pcs),
            "cheap": MemoryDomain("cheap", v_unsafe, cheap_pcs, ecc=ecc),
        },
        tiers=dict(tiers),
        geometry=geometry, map_seed=map_seed, mitigation=mitigation)

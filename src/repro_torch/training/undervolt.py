"""Undervolt plan (port of :mod:`repro.training.undervolt`).

A plan assigns each tensor group (params / optimizer moments / KV cache)
to a MemoryDomain (voltage + PC subset + ECC).  Placement is computed
once from shapes; groups in unsafe domains pass through the stuck-at
injection engine after being written.  Criticality tiers and the
runtime governor arrive with later slices of the port.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional

from repro_torch.core.domains import GroupPlacement, MemoryDomain, place_groups
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
    tiers: Optional[Dict[str, Any]] = None

    def __post_init__(self):
        if self.tiers is not None:
            raise NotImplementedError(
                "tiered placement (place_groups_tiered) arrives with the "
                "state-arena / model-zoo slice of the port (ROADMAP slice "
                "12); the paged scheduler routes tiers through its page "
                "pool instead")

    def fault_map(self) -> FaultMap:
        return _fault_map(self.geometry, self.map_seed)

    def place(self, groups: Dict[str, Any]) -> Dict[str, GroupPlacement]:
        if self.policy is None:
            raise ValueError("UndervoltPlan needs a policy")
        return place_groups(groups, self.policy, self.domains, self.geometry)

    def covers(self, group: str) -> bool:
        """Whether this plan places ``group``."""
        return self.policy is not None and group in self.policy

    def make_governor(self, domain: str, **config_kw):
        raise NotImplementedError(
            "the voltage governor is ported with the frontier/governor "
            "slice (ROADMAP slice 6)")

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

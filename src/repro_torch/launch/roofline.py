"""Roofline model: compute / memory / collective terms per cell (port of
:mod:`repro.launch.roofline`).

    compute term    = FLOPs      / (peak FLOP/s)          [per chip]
    memory term     = bytes      / (HBM bandwidth)        [per chip]
    collective term = coll_bytes / (link bandwidth)       [per chip]

The quantities come from :mod:`repro_torch.launch.hlo_analysis` (per
device).  MODEL_FLOPS is the analytic useful compute (6*N*D dense /
6*N_active*D MoE for training; 2*N*D for inference) -- the ratio
MODEL_FLOPS / FLOPs exposes remat and replication waste.

Two hardware rows: the reference's TPU v5e constants (kept for parity
with its rows; the module-level ``PEAK_FLOPS`` / ``HBM_BW`` / ``ICI_BW``
are theirs) and the H100 SXM the port runs on.  A row built with either
is a reckoning from constants, not a measurement.

The paper's power model is integrated here: the memory term over the
step time gives HBM bandwidth utilization, which feeds P(v, util) -- so
every roofline row also reports the undervolting energy savings this
cell would see.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Union

from repro_torch.core.voltage import DEFAULT_POWER_MODEL
from repro_torch.models.base import SHAPES, ShapeCell, count_params, get_arch


@dataclasses.dataclass(frozen=True)
class Hardware:
    name: str
    peak_flops: float            # bf16 dense FLOP/s per chip
    hbm_bw: float                # bytes/s per chip
    link_bw: float               # bytes/s per chip for collectives


HARDWARE: Dict[str, Hardware] = {
    # the reference's constants: TPU v5e, ~50 GB/s per ICI link
    "TPU_V5E": Hardware("TPU_V5E", 197e12, 819e9, 50e9),
    # H100 SXM5: HBM3 3.35 TB/s and 989 TFLOP/s bf16 dense (the figures
    # chip_smoke.py's bounds use); NVLink 4 at 900 GB/s per GPU in both
    # directions together (NVIDIA H100 Tensor Core GPU data sheet), i.e.
    # 450 GB/s each way
    "H100_SXM": Hardware("H100_SXM", 989e12, 3.35e12, 450e9),
}

PEAK_FLOPS = HARDWARE["TPU_V5E"].peak_flops
HBM_BW = HARDWARE["TPU_V5E"].hbm_bw
ICI_BW = HARDWARE["TPU_V5E"].link_bw

KNOWN_PARAMS: Dict[str, float] = {}


def _shape(shape: Union[str, ShapeCell]) -> ShapeCell:
    return SHAPES[shape] if isinstance(shape, str) else shape


def _total_params(arch_id: str, cfg=None) -> float:
    """Parameters of ``arch_id``'s full config (or of ``cfg``)."""
    if cfg is not None:
        b = get_arch(arch_id)
        return float(count_params(b.module.param_specs(cfg)))
    if arch_id not in KNOWN_PARAMS:
        b = get_arch(arch_id)
        KNOWN_PARAMS[arch_id] = float(count_params(
            b.module.param_specs(b.cfg)))
    return KNOWN_PARAMS[arch_id]


def _active_params(arch_id: str, cfg=None) -> float:
    """Active (per-token) parameters: MoE counts top_k + shared experts."""
    total = _total_params(arch_id, cfg)
    cfg = get_arch(arch_id).cfg if cfg is None else cfg
    if cfg.n_experts == 0:
        return total
    expert_block = 3 * cfg.d_model * cfg.d_ff        # gate/up/down
    routed_all = cfg.n_layers * cfg.n_experts * expert_block
    routed_active = cfg.n_layers * cfg.top_k * expert_block
    return total - routed_all + routed_active


def model_flops(arch_id: str, shape_name, cfg=None) -> float:
    """Analytic useful FLOPs per step (global, all chips)."""
    shape = _shape(shape_name)
    n_act = _active_params(arch_id, cfg)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_act * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_act * tokens
    # decode: one token per sequence
    return 2.0 * n_act * shape.global_batch


@dataclasses.dataclass
class RooflineRow:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops_per_chip: float
    hlo_bytes_per_chip: float
    collective_bytes_per_chip: float
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops_global: float
    useful_ratio: float
    step_s: float
    hbm_util: float
    memory_gb: Dict[str, float]
    energy_savings: Dict[str, float]
    collective_breakdown: Optional[Dict[str, float]] = None

    def to_json(self) -> Dict:
        return dataclasses.asdict(self)


def build_row(arch: str, shape, mesh_name: str, chips: int, costs,
              memory_gb: Dict[str, float], hw: str = "TPU_V5E",
              cfg=None) -> RooflineRow:
    h = HARDWARE[hw]
    compute_s = costs.flops / h.peak_flops
    memory_s = costs.bytes_accessed / h.hbm_bw
    collective_s = costs.collective_bytes / h.link_bw
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    bottleneck = max(terms, key=terms.get)
    step_s = max(compute_s, memory_s, collective_s)
    mf = model_flops(arch, shape, cfg)
    useful = mf / max(costs.flops * chips, 1.0)
    hbm_util = min(1.0, memory_s / max(step_s, 1e-12))

    pm = DEFAULT_POWER_MODEL
    energy = {
        "guardband_0.98V_x": round(float(pm.savings(0.98, hbm_util)), 3),
        "tradeoff_0.91V_x": round(float(pm.savings(0.91, hbm_util)), 3),
        "deep_0.85V_x": round(float(pm.savings(0.85, hbm_util)), 3),
    }
    return RooflineRow(
        arch=arch, shape=_shape(shape).name, mesh=mesh_name, chips=chips,
        hlo_flops_per_chip=costs.flops,
        hlo_bytes_per_chip=costs.bytes_accessed,
        collective_bytes_per_chip=costs.collective_bytes,
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        bottleneck=bottleneck, model_flops_global=mf,
        useful_ratio=useful, step_s=step_s, hbm_util=hbm_util,
        memory_gb=memory_gb, energy_savings=energy,
        collective_breakdown={k: round(v, 1) for k, v in
                              costs.collective_breakdown.items()})

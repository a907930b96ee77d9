"""Tree-level fault injection driven by a placement + fault map.

Port of :mod:`repro.core.injection` on its arena route: each tensor
group in an unsafe domain is injected in one fused pass per domain
(:mod:`repro_torch.core.engine`); ECC domains take the fused
inject+correct kernel.
"""
from __future__ import annotations

import torch

from repro_torch.core import engine as arena_engine
from repro_torch.core import pytree
from repro_torch.core.domains import GroupPlacement
from repro_torch.core.faultmap import FaultMap


def inject_group(tree, placement: GroupPlacement, faultmap: FaultMap,
                 *, voltage=None, method: str = "auto",
                 use_ref: bool = False, engine: str = "arena"):
    """Apply the domain's faults to a whole tensor group.

    Returns (faulted tree, total uncorrectable count); an identity when
    the effective voltage sits in the guardband.  The reference's
    ``engine='segments'`` path needs the per-segment kernel K5, which a
    later slice of the port brings."""
    if engine == "segments":
        raise NotImplementedError(
            "engine='segments' needs the per-segment injection kernel K5 "
            "(bitflip_pallas), ported with the Algorithm 1 tester slice "
            "(ROADMAP slice 11)")
    if engine != "arena":
        raise ValueError(f"unknown engine {engine!r}")
    return arena_engine.inject_placement(
        tree, placement, faultmap, voltage=voltage, method=method,
        use_ref=use_ref)


def clamp_nonfinite(tree, replacement: float = 0.0):
    """Optional mitigation: stuck exponent bits create Inf/NaN; fault-
    tolerant consumers can clamp them (EDEN-style preprocessing)."""
    def fix(x):
        if not torch.is_floating_point(x):
            return x
        return torch.where(torch.isfinite(x), x,
                           torch.tensor(replacement, dtype=x.dtype,
                                        device=x.device))
    return pytree.tree_map(fix, tree)

"""Tree-level fault injection driven by a placement + fault map.

Port of :mod:`repro.core.injection`.  The default route is the arena
engine (:mod:`repro_torch.core.engine`): each tensor group in an unsafe
domain is injected in one fused pass per domain; ECC domains take the
fused inject+correct kernel.

The legacy per-segment route (``engine='segments'`` / :func:`inject_leaf`)
launches one kernel per segment per leaf -- K5, or K6 on an ECC domain --
from static thresholds.  It is the independent implementation the tests
hold the arena engine bit-exact against.
"""
from __future__ import annotations

import torch

from repro_torch.core import engine as arena_engine
from repro_torch.core import pytree
from repro_torch.core.domains import GroupPlacement
from repro_torch.core.faultmap import FaultMap
from repro_torch.core.faultmodel import V_MIN
from repro_torch.kernels.bitflip import ops as bitflip_ops
from repro_torch.kernels.ecc import ops as ecc_ops


def inject_leaf(x: torch.Tensor, placement, faultmap: FaultMap,
                voltage: float, *, ecc: bool = False, method: str = "auto",
                use_ref: bool = False):
    """Legacy route: apply the domain's stuck-at faults to one tensor,
    segment by segment (one K5 or K6 launch per segment, thresholds from
    ``faultmap.thresholds(voltage, seg.pc)``).

    Returns (faulted tensor, uncorrectable count as a 0-d int64 tensor);
    the count is zero unless ``ecc`` is set."""
    u32, meta = bitflip_ops.to_u32(x)
    pieces = []
    uncorrectable = torch.zeros((), dtype=torch.int64, device=x.device)
    for seg in placement.segments:
        chunk = u32[seg.leaf_start_word:seg.leaf_start_word + seg.n_words]
        thr = faultmap.thresholds(voltage, seg.pc)
        if ecc:
            out, bad = ecc_ops.inject_and_correct_u32(
                chunk, thresholds=thr, seed=faultmap.seed,
                base_word=seg.phys_base_word, use_ref=use_ref)
            uncorrectable = uncorrectable + bad
        else:
            out = bitflip_ops.inject_u32(
                chunk, thresholds=thr, seed=faultmap.seed,
                base_word=seg.phys_base_word, method=method,
                use_ref=use_ref)
        pieces.append(out)
    faulted = pieces[0] if len(pieces) == 1 else torch.cat(pieces)
    return bitflip_ops.from_u32(faulted, meta), uncorrectable


def _inject_group_segments(tree, placement: GroupPlacement,
                           faultmap: FaultMap, *, method: str = "auto",
                           use_ref: bool = False):
    by_path = {lp.path: lp for lp in placement.leaves}
    flat = pytree.flatten_with_path(tree)
    dev = flat[0][1].device if flat else torch.device("cpu")
    out = pytree.tree_map(lambda t: t, tree)
    total_bad = torch.zeros((), dtype=torch.int64, device=dev)
    domain = placement.domain
    for path, leaf in flat:
        faulted, bad = inject_leaf(
            leaf, by_path[pytree.keystr(path)], faultmap, domain.voltage,
            ecc=domain.ecc, method=method, use_ref=use_ref)
        pytree.set_path(out, path, faulted)
        total_bad = total_bad + bad
    return out, total_bad


def inject_group(tree, placement: GroupPlacement, faultmap: FaultMap,
                 *, voltage=None, method: str = "auto",
                 use_ref: bool = False, engine: str = "arena"):
    """Apply the domain's faults to a whole tensor group.

    ``engine='arena'`` (default): one fused pass for the whole domain;
    ``voltage`` optionally overrides the domain voltage.
    ``engine='segments'``: the legacy per-segment route (no voltage
    override -- its thresholds are static by design).

    Returns (faulted tree, total uncorrectable count); an identity with a
    zero count when the effective voltage sits in the guardband."""
    if engine == "arena":
        return arena_engine.inject_placement(
            tree, placement, faultmap, voltage=voltage, method=method,
            use_ref=use_ref)
    if engine != "segments":
        raise ValueError(f"unknown engine {engine!r}")
    if voltage is not None:
        raise ValueError("the segments engine has no voltage override")
    if placement.domain.voltage >= V_MIN - 1e-9:
        leaves = pytree.leaves(tree)
        dev = leaves[0].device if leaves else torch.device("cpu")
        return tree, torch.zeros((), dtype=torch.int64, device=dev)
    return _inject_group_segments(tree, placement, faultmap, method=method,
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

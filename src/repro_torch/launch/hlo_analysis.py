"""Cost analysis of a step for the roofline report (the port's
counterpart of :mod:`repro.launch.hlo_analysis`, which parses XLA's
compiled HLO text; the name is kept so a reader finds the counterpart).

The port has no compiled program to parse.  :func:`trace` runs the step
once under a ``TorchDispatchMode`` -- on the ``meta`` device, so nothing
is computed or allocated -- and sees every ATen operation it dispatches,
the backward pass and recomputation included, each once per execution
(loops are unrolled in Python, so no trip-count weighting is needed):

  * FLOPs: ``2 * prod(out) * contracted`` for every ``mm``, ``bmm``,
    ``addmm``, ``baddbmm``, ``mv`` and ``dot``;
  * bytes: operand bytes plus output bytes of every operation that is
    not a view;
  * live bytes: the storages the step allocates, alive until their last
    reference goes; the peak beyond the arguments is the step's ``temp``.

Collectives are not operations on one device; :func:`collective_costs`
derives the ones the layout implies, with the reference's ring factors
(all-reduce 2x, all-gather / reduce-scatter 1x of the result): the MoE's
``psum`` over the model axis (recorded by
:func:`repro_torch.models.dist.psum_model` as it runs, forward and
backward), the gradient all-reduce over the batch axes of every leaf the
rules do not shard over them, and for every leaf they shard over the
batch axes (FSDP) an all-gather per microbatch for the forward and one
for the backward, and a reduce-scatter of its gradient per step.
"""
from __future__ import annotations

import dataclasses
import gc
import math
from typing import Dict, List, Tuple

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.core import pytree
from repro_torch.models import dist as dist_mod

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")
# effective bytes moved per device, as a fraction of the op result size
COLLECTIVE_FACTOR = {"all-reduce": 2.0, "all-gather": 1.0,
                     "reduce-scatter": 1.0, "all-to-all": 1.0,
                     "collective-permute": 1.0}

_aten = torch.ops.aten
# (lhs argument index) of each matrix-product overload
_MATMULS = {
    _aten.mm.default: 0, _aten.bmm.default: 0, _aten.mv.default: 0,
    _aten.dot.default: 0, _aten.addmm.default: 1, _aten.baddbmm.default: 1,
}


@dataclasses.dataclass
class HloCosts:
    flops: float
    bytes_accessed: float
    collective_bytes: float
    collective_breakdown: Dict[str, float]
    per_collective_count: Dict[str, int]


@dataclasses.dataclass
class StepTrace:
    """What one traced step did on its device."""

    flops: float
    bytes_accessed: float
    peak_temp_bytes: int
    out_bytes: int
    ops: int
    collectives: List[Tuple[str, str, int, int]]


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in pytree.leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def matmul_flops(func, args, out) -> float:
    lhs = args[_MATMULS[func]]
    return 2.0 * out.numel() * lhs.shape[-1]


class _Counter(TorchDispatchMode):
    def __init__(self, args_storages):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.ops = 0
        self.live: Dict[int, Tuple[StorageWeakRef, int]] = {}
        self.skip = set(args_storages)
        self.live_bytes = 0
        self.peak = 0

    def _sweep(self):
        dead = [k for k, (ref, _) in self.live.items() if ref.expired()]
        for k in dead:
            self.live_bytes -= self.live.pop(k)[1]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.ops += 1
        outs = _tensors(out)
        if func in _MATMULS:
            self.flops += matmul_flops(func, args, outs[0])
        if not func.is_view:
            ins = _tensors((args, kwargs))
            self.bytes += sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
            for t in outs:
                st = t.untyped_storage()
                key = st._cdata
                if key in self.skip or key in self.live:
                    continue
                self.live[key] = (StorageWeakRef(st), st.nbytes())
                self.live_bytes += st.nbytes()
            self._sweep()
            self.peak = max(self.peak, self.live_bytes)
        return out


def trace(fn, *args) -> Tuple[object, StepTrace]:
    """Run ``fn(*args)`` once under the counting mode; returns (its
    result, :class:`StepTrace`).  Storages of ``args`` are the arguments:
    neither temporaries nor outputs."""
    arg_storages = {t.untyped_storage()._cdata for t in _tensors(args)}
    counter = _Counter(arg_storages)
    with dist_mod.collecting() as coll, counter:
        result = fn(*args)
    gc.collect()
    counter._sweep()
    out_bytes = sum(v[1] for v in counter.live.values())
    return result, StepTrace(flops=counter.flops,
                             bytes_accessed=counter.bytes,
                             peak_temp_bytes=counter.peak,
                             out_bytes=out_bytes, ops=counter.ops,
                             collectives=list(coll))


def collective_costs(step: StepTrace, *, layout=(), microbatches: int = 1,
                     batch_axes_size: int = 1
                     ) -> Tuple[Dict[str, float], Dict[str, int]]:
    """Per-device collective bytes and counts by kind.  ``step``'s
    recorded collectives are one device's already (the trace runs one
    data shard, and each model shard's partial result is whole);
    ``layout`` holds, per parameter leaf, ``(per-device bytes of the leaf
    as the compute uses it, per-device bytes of its stored shard, sharded
    over the batch axes)``."""
    coll = {c: 0.0 for c in COLLECTIVES}
    count = {c: 0 for c in COLLECTIVES}

    def add(kind, nbytes, n=1):
        coll[kind] += COLLECTIVE_FACTOR[kind] * nbytes * n
        count[kind] += n

    for kind, _, size, nbytes in step.collectives:
        if size > 1:
            add(kind, nbytes)
    if batch_axes_size > 1:
        for used, stored, fsdp in layout:
            if fsdp:
                add("all-gather", used, 2 * microbatches)
                add("reduce-scatter", stored)
            else:
                add("all-reduce", used)
    return coll, count


def analyze(step: StepTrace, *, layout=(), microbatches: int = 1,
            batch_axes_size: int = 1, scale: float = 1.0) -> HloCosts:
    """:class:`HloCosts` of one device from a traced step: its FLOPs and
    bytes times ``scale``, and the collectives the layout implies (see
    :func:`collective_costs`)."""
    coll, count = collective_costs(
        step, layout=layout, microbatches=microbatches,
        batch_axes_size=batch_axes_size)
    return HloCosts(flops=step.flops * scale,
                    bytes_accessed=step.bytes_accessed * scale,
                    collective_bytes=math.fsum(coll.values()),
                    collective_breakdown=coll,
                    per_collective_count=count)

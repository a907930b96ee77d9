"""Distribution context (port of :mod:`repro.models.dist`), threaded into
model families that use explicit collectives (expert parallelism in
:func:`repro_torch.models.moe.moe_ffn`) and, through a context variable,
into code that asks for an activation's layout.

The port's meshes are logical (:mod:`repro_torch.launch.mesh`): every
position names the same device, and the step computes each shard's part
one after another there, in the order the reference's collectives fix.
Only the routed MoE FFN's values depend on the mesh (capacity per data
shard, one dispatch per model shard, the partial outputs summed in
model-shard order); the reference's other uses of the mesh change
placement, not values, and have no counterpart on one device.

:func:`collecting` records the collectives a step implies (the MoE's
``psum`` over the model axis) for the dry run's analysis
(:mod:`repro_torch.launch.hlo_analysis`).
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import functools
import math
from typing import Any, List, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class DistContext:
    mesh: Any                    # launch.mesh.TrainMesh
    batch_axes: Tuple[str, ...] = ("data",)
    model_axis: str = "model"
    rules: Any = None            # launch.sharding.ShardingRules | None

    @property
    def model_size(self) -> int:
        return self.mesh.shape[self.model_axis]

    @property
    def data_size(self) -> int:
        """Positions along the batch axes: the number of data shards."""
        return math.prod(self.mesh.shape[a] for a in self.batch_axes)

    def activation_sharding(self, shape, leading_batch: bool = True):
        """The resolved PartitionSpec of an activation tensor
        (batch-leading).  Rank-4 tensors are attention activations (B, S,
        H, D): the 'attn_act_heads' rule (default: replicate) can shard
        the head dim over the model axis when divisible."""
        from repro_torch.launch.sharding import ShardingRules, resolve_spec
        from repro_torch.models.base import ParamSpec
        rules = self.rules if self.rules is not None \
            else ShardingRules.default()
        lead = ("batch",) if leading_batch else (None,)
        if len(shape) == 4:
            axes = lead + (None, "attn_act_heads", None)
        else:
            axes = lead + (None,) * (len(shape) - 1)
        return resolve_spec(
            ParamSpec(shape=tuple(shape), axes=axes, dtype=torch.int32),
            rules, self.mesh)


_CURRENT: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_dist", default=None)
_COLLECTIVES: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_collectives", default=None)


@contextlib.contextmanager
def use(dist: Optional["DistContext"]):
    """Make ``dist`` visible to layer internals for the call's duration."""
    token = _CURRENT.set(dist)
    try:
        yield
    finally:
        _CURRENT.reset(token)


def current() -> Optional["DistContext"]:
    return _CURRENT.get()


@functools.lru_cache(maxsize=None)
def local_dist(device="cuda") -> DistContext:
    """1-position mesh (data 1 x model 1) on ``device``."""
    from repro_torch.launch.mesh import make_mesh_auto  # no models->launch
    mesh = make_mesh_auto((1, 1), ("data", "model"), device=device)
    return DistContext(mesh=mesh, batch_axes=("data",), model_axis="model")


def ensure(dist: Optional[DistContext]) -> DistContext:
    return dist if dist is not None else local_dist()


@contextlib.contextmanager
def collecting():
    """Record every collective the code inside implies: yields a list
    that gains one ``(kind, axis, axis_size, nbytes)`` per collective
    (``nbytes`` the per-device result)."""
    log: List[Tuple[str, str, int, int]] = []
    token = _COLLECTIVES.set(log)
    try:
        yield log
    finally:
        _COLLECTIVES.reset(token)


def record_collective(kind: str, axis: str, axis_size: int,
                      nbytes: int) -> None:
    log = _COLLECTIVES.get()
    if log is not None:
        log.append((kind, axis, int(axis_size), int(nbytes)))


class _ModelPsum(torch.autograd.Function):
    """The reference's ``psum`` of the model shards' partial outputs on
    one device: summed in model-shard order; its transpose hands the
    cotangent to every shard.  Both directions record one all-reduce
    over the model axis."""

    @staticmethod
    def forward(ctx, axis, *parts):
        ctx.axis, ctx.n = axis, len(parts)
        y = parts[0]
        for part in parts[1:]:
            y = y + part
        record_collective("all-reduce", axis, len(parts),
                          parts[0].numel() * parts[0].element_size())
        return y

    @staticmethod
    def backward(ctx, g):
        record_collective("all-reduce", ctx.axis, ctx.n,
                          g.numel() * g.element_size())
        return (None,) + (g,) * ctx.n


def psum_model(parts, axis: str = "model"):
    """Sum the model shards' partial outputs ``parts`` in shard order (one
    part: itself, no collective)."""
    if len(parts) == 1:
        return parts[0]
    return _ModelPsum.apply(axis, *parts)

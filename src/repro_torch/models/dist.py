"""Distribution context (port of :mod:`repro.models.dist`), threaded into
model families that use explicit collectives (expert parallelism in
:func:`repro_torch.models.moe.moe_ffn`) and, through a context variable,
into code that asks for an activation's layout.

A logical mesh (:mod:`repro_torch.launch.mesh`) names one device for
every position, and the step computes each shard's part one after
another there, in the order the reference's collectives fix.  Only the
routed MoE FFN's values depend on the mesh (capacity per data shard, one
dispatch per model shard, the partial outputs summed in model-shard
order); the reference's other uses of the mesh change placement, not
values.

A rank mesh (``make_rank_mesh``) puts each position in a process of its
own: this rank computes only its data shard's rows and its model
shard's experts, and the collectives are real (:mod:`repro_torch.launch.
ranks`' data plane): :func:`psum_model` all-gathers the model ranks'
partial outputs and sums them in model-rank order (the logical mesh's
bits), :func:`model_grad_sum` sums the cotangent of a model-replicated
input over the model ranks, and :func:`data_mean` averages the router's
load statistics over the data ranks.

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

    @property
    def group(self):
        """The rank mesh's :class:`~repro_torch.launch.ranks.RankGroup`
        (None on a logical mesh)."""
        return getattr(self.mesh, "group", None)

    @property
    def on_ranks(self) -> bool:
        return self.group is not None

    def _coord(self, axis: str) -> int:
        return self.mesh.coords(self.group.rank)[axis]

    @property
    def model_index(self) -> int:
        """This rank's model shard (0 on a logical mesh)."""
        return self._coord(self.model_axis) if self.on_ranks else 0

    @property
    def data_index(self) -> int:
        """This rank's data shard (0 on a logical mesh)."""
        if not self.on_ranks:
            return 0
        out = 0
        for a in self.batch_axes:
            out = out * self.mesh.shape[a] + self._coord(a)
        return out

    def axis_group(self, axis: str):
        """The process group of the ranks that differ from this one only
        along ``axis``."""
        return self.mesh.axis_groups[axis]

    @property
    def data_group(self):
        axes = [a for a in self.batch_axes if self.mesh.shape[a] > 1]
        if len(axes) > 1:
            raise ValueError(f"a rank mesh shards data over one axis, not "
                             f"{axes}")
        return self.axis_group(axes[0] if axes else self.batch_axes[0])

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


class _RankModelPsum(torch.autograd.Function):
    """The ``psum`` over model ranks: all-gather the ranks' partial
    outputs and sum them in model-rank order (the logical mesh's bits).
    Downstream every model rank computes the same replicated values, so
    the cotangent is already equal on every rank: the backward hands it
    to the local part with no collective."""

    @staticmethod
    def forward(ctx, part, dist):
        from repro_torch.launch import ranks
        ctx.axis, ctx.n = dist.model_axis, dist.model_size
        record_collective("all-reduce", ctx.axis, ctx.n,
                          part.numel() * part.element_size())
        return ranks.ordered_sum(dist.group, part,
                                 dist.axis_group(dist.model_axis),
                                 kind="psum_model")

    @staticmethod
    def backward(ctx, g):
        record_collective("all-reduce", ctx.axis, ctx.n,
                          g.numel() * g.element_size())
        return g, None


def psum_model(parts, axis: str = "model", dist=None):
    """Sum the model shards' partial outputs ``parts`` in shard order (one
    part: itself, no collective).  On a rank mesh ``parts`` is this
    rank's one part, summed with the other model ranks' over the data
    plane."""
    if dist is not None and dist.on_ranks and dist.model_size > 1:
        (part,) = parts
        return _RankModelPsum.apply(part, dist)
    if len(parts) == 1:
        return parts[0]
    return _ModelPsum.apply(axis, *parts)


class _ModelGradSum(torch.autograd.Function):
    """Identity forward; the backward sums the cotangent over the model
    ranks in rank order.  Marks an input every model rank holds whole but
    feeds only its own experts: on a logical mesh autograd sums the
    shards' cotangents there."""

    @staticmethod
    def forward(ctx, x, dist):
        ctx.dist = dist
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        from repro_torch.launch import ranks
        d = ctx.dist
        record_collective("all-reduce", d.model_axis, d.model_size,
                          g.numel() * g.element_size())
        return ranks.ordered_sum(d.group, g, d.axis_group(d.model_axis),
                                 kind="model_grad_sum"), None


def model_grad_sum(x, dist=None):
    """``x``, whose cotangent is summed over the model ranks (itself
    off a rank mesh, or with one model rank)."""
    if dist is None or not dist.on_ranks or dist.model_size == 1:
        return x
    return _ModelGradSum.apply(x, dist)


class _DataMean(torch.autograd.Function):
    """Mean over the data ranks (their values summed in rank order, then
    divided); the backward hands the cotangent to the local term."""

    @staticmethod
    def forward(ctx, x, dist):
        from repro_torch.launch import ranks
        return ranks.ordered_sum(dist.group, x, dist.data_group,
                                 kind="data_mean") / dist.data_size

    @staticmethod
    def backward(ctx, g):
        return g, None


def data_mean(x, dist=None):
    """``x`` averaged over the data ranks (itself off a rank mesh, or with
    one data rank).  With equal rows a rank, the mean of the ranks' means
    is the global batch's mean."""
    if dist is None or not dist.on_ranks or dist.data_size == 1:
        return x
    return _DataMean.apply(x, dist)

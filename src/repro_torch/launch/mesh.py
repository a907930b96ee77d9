"""Meshes (port of :mod:`repro.launch.mesh`).

Training: :class:`TrainMesh`, named axes over one ``torch.device`` per
position.  Single pod: 16 x 16 = 256 positions (data x model); multi-pod:
2 x 16 x 16 = 512 (pod x data x model), the ``pod`` axis carrying only
data parallelism.  A mesh is *logical* by default: every position names
the same device, and a step computes each shard's part one after another
on it (:class:`repro_torch.models.dist.DistContext`, the routed MoE
FFN's expert parallelism).  :func:`make_production_mesh` places its
positions on the ``meta`` device, so the dry run allocates nothing.  A
*rank* mesh (:func:`make_rank_mesh`) puts position ``p`` on rank ``p``
of a process group (:mod:`repro_torch.launch.ranks`), row-major over
``("data", "model")``, built on
``torch.distributed.device_mesh.init_device_mesh``; its ``axis_groups``
are the per-axis process groups.  Positions naming distinct devices
without a process group spanning them raise :class:`ShardLayoutError`.

Serving: the reference lays a 1-D ``serve`` mesh over devices; each
device along it owns one scheduler shard.  The port's :class:`ServeMesh`
names one ``torch.device`` per shard.  Several shards may name the same
card: *logical* shards, each with its own slot range, page pool, fault
map and governor setpoint, served by one step on that card.  With a
process group (``make_serve_mesh(n, group=...)``) each rank owns
``n / world`` consecutive shards (``owners``) on its own device; the
scheduler then runs only its own shards' device work.  Shards on
another device than the scheduler's, with no group spanning them, are
refused there.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

SERVE_AXIS = "serve"


class ShardLayoutError(ValueError):
    """A shard layout that cannot partition the scheduler cleanly:
    capacity or page pool not divisible by the shard count, a mesh
    without the serve axis, colliding per-shard fault-map seeds, shards
    on another device than the scheduler's -- or any mesh on the
    single-shard state-arena route.  Also a mesh whose positions name
    distinct devices with no process group spanning them."""


@dataclasses.dataclass(frozen=True)
class TrainMesh:
    """A named-axis mesh: ``axis_names``, ``sizes`` (one per axis) and
    ``devices``, one per position in row-major order -- all the same
    device (logical shards), or, with ``group`` (a
    :class:`repro_torch.launch.ranks.RankGroup`), one per rank: position
    ``p`` is rank ``p``, and ``axis_groups`` holds each axis's process
    group."""

    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    devices: Tuple[torch.device, ...]
    group: Any = dataclasses.field(default=None, compare=False)
    axis_groups: Any = dataclasses.field(default=None, compare=False)

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes) or any(
                n < 1 for n in self.sizes):
            raise ValueError(f"mesh axes {self.axis_names} with sizes "
                             f"{self.sizes}")
        if len(self.devices) != math.prod(self.sizes):
            raise ValueError(f"mesh {dict(zip(self.axis_names, self.sizes))}"
                             f" needs {math.prod(self.sizes)} devices, got "
                             f"{len(self.devices)}")
        distinct = sorted({str(d) for d in self.devices})
        if self.group is None and len(distinct) > 1:
            raise ShardLayoutError(
                f"mesh positions name distinct devices {distinct} and no "
                "process group spans them: a logical mesh is shards on one "
                "device; a mesh over devices needs a rank group "
                "(launch.mesh.make_rank_mesh)")
        if self.group is not None and tuple(self.devices) != tuple(
                self.group.devices):
            raise ShardLayoutError(
                f"rank mesh devices {[str(d) for d in self.devices]} are "
                f"not the group's {[str(d) for d in self.group.devices]} "
                "(position p is rank p)")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def device(self) -> torch.device:
        """The device this process computes on: the one device every
        position names, or this rank's."""
        return self.devices[0 if self.group is None else self.group.rank]

    def coords(self, position: int) -> Dict[str, int]:
        """Each axis's index of ``position`` (row-major)."""
        out, rest = {}, int(position)
        for name, n in reversed(list(zip(self.axis_names, self.sizes))):
            rest, out[name] = divmod(rest, n)
        return {a: out[a] for a in self.axis_names}


def make_mesh_auto(shape, axes, device="cuda",
                   devices: Optional[Sequence] = None) -> TrainMesh:
    """A :class:`TrainMesh` of ``shape`` over ``axes``: every position on
    ``device`` (logical shards), or on ``devices`` (one per position,
    row-major; distinct devices raise :class:`ShardLayoutError`)."""
    shape = tuple(int(n) for n in shape)
    if devices is None:
        devices = [device] * math.prod(shape)
    return TrainMesh(axis_names=tuple(axes), sizes=shape,
                     devices=tuple(torch.device(d) for d in devices))


def make_rank_mesh(group, shape, axes=("data", "model")) -> TrainMesh:
    """A :class:`TrainMesh` of ``shape`` over ``axes`` whose positions are
    the ranks of ``group`` (row-major), on
    ``torch.distributed.device_mesh.init_device_mesh``: its per-axis
    process groups run the data plane (nccl or gloo, as the group's)."""
    from torch.distributed.device_mesh import init_device_mesh
    shape = tuple(int(n) for n in shape)
    if math.prod(shape) != group.world:
        raise ShardLayoutError(f"mesh {dict(zip(axes, shape))} needs "
                               f"{math.prod(shape)} ranks, the group has "
                               f"{group.world}")
    dm = init_device_mesh("cuda" if group.backend == "nccl" else "cpu",
                          shape, mesh_dim_names=tuple(axes))
    return TrainMesh(axis_names=tuple(axes), sizes=shape,
                     devices=tuple(group.devices), group=group,
                     axis_groups={a: dm.get_group(a) for a in axes})


def make_production_mesh(*, multi_pod: bool = False,
                         device="meta") -> TrainMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh_auto(shape, axes, device=device)


def batch_axes(mesh) -> Tuple[str, ...]:
    """Mesh axes that carry data parallelism."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def make_smoke_mesh(device="cuda") -> TrainMesh:
    """1-position mesh with production axis names."""
    return make_mesh_auto((1, 1), ("data", "model"), device=device)


@dataclasses.dataclass(frozen=True)
class ServeMesh:
    """A 1-D mesh: ``axis_names`` (one name), ``shape`` (name -> shard
    count) and ``devices``, one per shard; over a process group,
    ``owners`` names each shard's rank and ``group`` is the
    :class:`repro_torch.launch.ranks.RankGroup`."""

    axis_names: Tuple[str, ...]
    devices: Tuple[torch.device, ...]
    owners: Optional[Tuple[int, ...]] = None
    group: Any = dataclasses.field(default=None, compare=False)

    @property
    def shape(self) -> Dict[str, int]:
        return {self.axis_names[0]: len(self.devices)}


def make_serve_mesh(num_shards: Optional[int] = None,
                    axis: str = SERVE_AXIS,
                    devices: Optional[Sequence] = None,
                    group=None) -> ServeMesh:
    """1-D mesh for the sharded serving scheduler.

    ``devices`` names each shard's device (``["cpu"] * n`` on the host);
    by default every shard is a logical shard on the current card, and
    ``num_shards`` defaults to one per visible card.  With ``group`` (a
    :class:`repro_torch.launch.ranks.RankGroup`) the shards spread over
    its ranks, ``num_shards / world`` consecutive shards a rank (one per
    rank by default), each on its rank's device."""
    if group is not None:
        if devices is not None:
            raise ValueError("make_serve_mesh(): pass devices or a group, "
                             "not both (a group's ranks name the devices)")
        n = group.world if num_shards is None else int(num_shards)
        if n < 1 or n % group.world:
            raise ShardLayoutError(
                f"make_serve_mesh({n}) over {group.world} ranks: every rank "
                "owns the same number of shards")
        per = n // group.world
        owners = tuple(k // per for k in range(n))
        return ServeMesh(axis_names=(axis,),
                         devices=tuple(group.devices[r] for r in owners),
                         owners=owners, group=group)
    if devices is None:
        n_cards = torch.cuda.device_count()
        if num_shards is None:
            if n_cards < 1:
                raise ValueError(
                    "make_serve_mesh(): no CUDA device is visible; pass "
                    "num_shards and devices (e.g. devices=['cpu'] * n)")
            devices = [torch.device("cuda", i) for i in range(n_cards)]
        else:
            devices = [torch.device("cuda", 0)] * int(num_shards)
    devices = tuple(torch.device(d) for d in devices)
    if num_shards is None:
        num_shards = len(devices)
    if not 1 <= num_shards == len(devices):
        raise ValueError(
            f"make_serve_mesh(num_shards={num_shards}): need num_shards "
            f">= 1 and one device per shard (got {len(devices)})")
    return ServeMesh(axis_names=(axis,), devices=devices)

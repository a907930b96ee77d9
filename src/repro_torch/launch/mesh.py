"""Meshes (port of :mod:`repro.launch.mesh`).

Training: :class:`TrainMesh`, named axes over one ``torch.device`` per
position.  Single pod: 16 x 16 = 256 positions (data x model); multi-pod:
2 x 16 x 16 = 512 (pod x data x model), the ``pod`` axis carrying only
data parallelism.  The port's meshes are *logical*: every position names
the same device, and a step computes each shard's part one after another
on it (:class:`repro_torch.models.dist.DistContext`, the routed MoE
FFN's expert parallelism).  :func:`make_production_mesh` places its
positions on the ``meta`` device, so the dry run allocates nothing.  A
mesh whose positions name distinct devices raises
:class:`ShardLayoutError`: meshes over distinct cards are not ported yet.

Serving: the reference lays a 1-D ``serve`` mesh over devices; each
device along it owns one scheduler shard.  The port's :class:`ServeMesh`
names one ``torch.device`` per shard.  Several shards may name the same
card: *logical* shards, each with its own slot range, page pool, fault
map and governor setpoint, served by one step on that card.  The
scheduler serves every shard of a mesh on its own device, so a mesh of
distinct cards is refused there.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import torch

SERVE_AXIS = "serve"


class ShardLayoutError(ValueError):
    """A shard layout that cannot partition the scheduler cleanly:
    capacity or page pool not divisible by the shard count, a mesh
    without the serve axis, colliding per-shard fault-map seeds, shards
    on another device than the scheduler's -- or any mesh on the
    single-shard state-arena route.  Also a training mesh whose positions
    name distinct devices."""


@dataclasses.dataclass(frozen=True)
class TrainMesh:
    """A named-axis mesh: ``axis_names``, ``sizes`` (one per axis) and
    ``devices``, one per position in row-major order -- all the same
    device (logical shards)."""

    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    devices: Tuple[torch.device, ...]

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
        if len(distinct) > 1:
            raise ShardLayoutError(
                f"mesh positions name distinct devices {distinct}: a "
                "training mesh is logical shards on one device (meshes "
                "over distinct cards are not ported)")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def device(self) -> torch.device:
        """The one device every position names."""
        return self.devices[0]


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
    count) and ``devices``, one per shard."""

    axis_names: Tuple[str, ...]
    devices: Tuple[torch.device, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return {self.axis_names[0]: len(self.devices)}


def make_serve_mesh(num_shards: Optional[int] = None,
                    axis: str = SERVE_AXIS,
                    devices: Optional[Sequence] = None) -> ServeMesh:
    """1-D mesh for the sharded serving scheduler.

    ``devices`` names each shard's device (``["cpu"] * n`` on the host);
    by default every shard is a logical shard on the current card, and
    ``num_shards`` defaults to one per visible card."""
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

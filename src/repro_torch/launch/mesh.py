"""The serving mesh (port of :mod:`repro.launch.mesh`, its serving half).

The reference lays a 1-D ``serve`` mesh over devices; each device along
it owns one scheduler shard.  The port's :class:`ServeMesh` names one
``torch.device`` per shard.  Several shards may name the same card:
*logical* shards, each with its own slot range, page pool, fault map and
governor setpoint, served by one step on that card.  The scheduler
serves every shard of a mesh on its own device, so a mesh of distinct
cards is refused there.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch

SERVE_AXIS = "serve"


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

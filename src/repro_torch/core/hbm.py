"""HBM geometry model (port of :mod:`repro.core.hbm`).

The paper's testbench (Xilinx VCU128) exposes 2 HBM2 stacks x 8
channels x 2 pseudo-channels (PC) = 32 independently controllable PCs of
256 MB each.  Every higher layer is geometry-parametric.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class HBMGeometry:
    """Physical organization of the HBM attached to one device."""

    name: str
    num_stacks: int
    channels_per_stack: int
    pcs_per_channel: int
    bytes_per_pc: int
    row_bytes: int = 1024  # DRAM row granularity used by the cluster model

    @property
    def num_pcs(self) -> int:
        return self.num_stacks * self.channels_per_stack * self.pcs_per_channel

    @property
    def total_bytes(self) -> int:
        return self.num_pcs * self.bytes_per_pc

    @property
    def bits_per_pc(self) -> int:
        return self.bytes_per_pc * 8

    def stack_of_pc(self, pc: int) -> int:
        """Stack index owning pseudo-channel ``pc`` (PCs numbered stack-major)."""
        if not 0 <= pc < self.num_pcs:
            raise ValueError(f"pc {pc} out of range [0, {self.num_pcs})")
        return pc // (self.channels_per_stack * self.pcs_per_channel)

    def pcs_of_stack(self, stack: int) -> Tuple[int, ...]:
        per = self.channels_per_stack * self.pcs_per_channel
        return tuple(range(stack * per, (stack + 1) * per))


_FLEET_SEED_STRIDE = 0x9E3779B9  # golden-ratio increment (splitmix-style)


def fleet_map_seeds(base_seed: int, num_shards: int) -> Tuple[int, ...]:
    """Per-shard fault-map seeds for a fleet of ``num_shards`` devices.

    Each device of a sharded serving fleet carries its own HBM stacks, so
    each shard's fault map is an independent draw (the per-part margin
    variation of real parts).  Seeds step from ``base_seed`` by a
    golden-ratio stride, reduced mod 2**32 (the ``RandomState`` domain):
    shard 0 keeps ``base_seed``, so a 1-shard fleet reproduces the
    single-device map bit for bit."""
    if num_shards < 1:
        raise ValueError(f"num_shards={num_shards} must be >= 1")
    return tuple((int(base_seed) + k * _FLEET_SEED_STRIDE) & 0xFFFFFFFF
                 for k in range(num_shards))


# The paper's platform: 2 x 4 GB stacks, 32 x 256 MB PCs.
VCU128 = HBMGeometry(
    name="vcu128",
    num_stacks=2,
    channels_per_stack=8,
    pcs_per_channel=2,
    bytes_per_pc=256 * 1024 * 1024,
)

# The reference's TPU v5e model: 16 GB HBM2e per chip as 32 x 512 MB PCs.
TPU_V5E = HBMGeometry(
    name="tpu_v5e",
    num_stacks=2,
    channels_per_stack=8,
    pcs_per_channel=2,
    bytes_per_pc=512 * 1024 * 1024,
)

GEOMETRIES = {g.name: g for g in (VCU128, TPU_V5E)}
